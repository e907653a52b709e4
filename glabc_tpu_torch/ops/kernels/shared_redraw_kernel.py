"""The shared AGLMCMC epoch's redraw of a chunk of chains (K10): the CUDA
kernel's wrapper and its plain torch version.

The kernel is ``csrc/shared_redraw.cu``; it replaces no kernel of the JAX
package (there XLA fuses the same sequence, ``glabc_tpu/samplers/
aglmcmc.py`` ``_redraw`` and ``_pool_from_proposals``).  For a problem of
the ``|theta| + sigma N(0, I)`` family under its N(0, I) prior
(``models/problems._GaussianAbsProblem``) and the shared, unbatched KDE, a
chunk's rows are, per chain, from the chunk's ``u (C, M)``, ``z (C, M, d)``
and ``noise (C, P, d)`` (``M = oversample P``, all drawn by torch):

* the KDE draws ``cand = X[clip(searchsorted(cdf, u cdf[-1], right), 0,
  n-1)] + z bw`` (``KernelDensity.sample``);
* the first ``P`` of them in the stable valid-first order of ``prior >
  cutoff`` (``ops/resampling.stable_partition_take``), ``theta``;
* ``x = |theta_safe| + sigma noise`` (``theta_safe``: a row holding a NaN
  as 0), ``dis = |x - y_obs|`` (``nan_dis`` on a NaN row or distance) and
  ``plk = prior(theta) + log K(dis)``.

``theta`` is returned as drawn: K4's pool epilogue
(``kde_logprob_kernel.py``, ``log_w=``) takes the density at it, writes
``log_w = plk - log q`` and then zeroes its NaN rows.  Layouts are the
pool's: ``theta``, ``x`` ``(C, P, d)``, ``dis``, ``plk`` ``(C, P)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..resampling import blocked_searchsorted_take, stable_partition_take

__all__ = ["RedrawInputs", "SharedRedraw"]


class RedrawInputs(NamedTuple):
    """An epoch's constants of K10: the shared KDE's float32 CDF ``(n,)``,
    support ``X (n, d)`` and bandwidth ``(d,)``; the problem's ``y_obs
    (d,)`` and its epsilon-kernel's log-density at 0 ``logk0 ()`` (both on
    the KDE's device); its prior's log-density at 0 ``prior0``, the prior
    cutoff, the simulator's noise scale ``sigma``, ``epsilon`` and the
    discrepancy given to NaN rows."""

    cdf: torch.Tensor
    X: torch.Tensor
    bw: torch.Tensor
    y_obs: torch.Tensor
    logk0: torch.Tensor
    prior0: float
    cutoff: float
    sigma: float
    epsilon: float
    nan_dis: float


class SharedRedraw:
    """``run(u, z, noise, inputs, *, out=None) -> (theta, x, dis, plk)``,
    into the four tensors of ``out`` where given.  ``launches`` counts
    launches of the CUDA kernel (class-wide) and rises for nothing else."""

    launches = 0

    @staticmethod
    def _check(u, z, noise, inputs, out):
        tensors = [("u", u), ("z", z), ("noise", noise),
                   *((f, getattr(inputs, f)) for f in
                     ("cdf", "X", "bw", "y_obs", "logk0"))]
        if out is not None:
            tensors += list(zip(("theta", "x", "dis", "plk"), out))
        for name, t in tensors:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != u.device:
                raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if u.dim() != 2 or noise.dim() != 3:
            raise ValueError(f"u must be (C, M) and noise (C, P, d), got "
                             f"{tuple(u.shape)}, {tuple(noise.shape)}")
        (C, M), (P, d) = u.shape, noise.shape[1:]
        n = inputs.cdf.shape[0] if inputs.cdf.dim() == 1 else 0
        want = {"z": (C, M, d), "noise": (C, P, d), "cdf": (n,),
                "X": (n, d), "bw": (d,), "y_obs": (d,), "logk0": (),
                "theta": (C, P, d), "x": (C, P, d), "dis": (C, P),
                "plk": (C, P)}
        for name, t in tensors[1:]:
            if tuple(t.shape) != want[name] or n < 1:
                raise ValueError(f"{name} must be {want[name]} with n >= 1, "
                                 f"got {tuple(t.shape)}")
        if M < P:
            raise ValueError(f"{M} candidates a chain cannot fill {P} rows")
        return C, M, P, n, d

    def run(self, u, z, noise, inputs: RedrawInputs, *, out=None):
        self._check(u, z, noise, inputs, out)
        if u.device.type == "cuda":
            return self._launch(u, z, noise, inputs, out)
        if u.device.type == "cpu":
            return self.plain(u, z, noise, inputs, out=out)
        raise ValueError(f"no kernel for device {u.device}")

    def plain(self, u, z, noise, inputs: RedrawInputs, *, out=None):
        """The plain torch version of :meth:`run`, on any device: the
        shared epoch's redraw and pool sequence as torch ran it before the
        kernel (KDE draws, prior check, stable partition, simulation,
        discrepancy, epsilon-kernel), each operation rounded on its own."""
        C, M, P, n, d = self._check(u, z, noise, inputs, out)
        cdf, X, bw, y_obs, logk0 = inputs[:5]
        picked, _ = blocked_searchsorted_take(cdf, u * cdf[..., -1:], X)
        cand = picked + z * bw
        prior = inputs.prior0 - 0.5 * torch.sum(cand * cand, dim=-1)
        theta = stable_partition_take(cand, prior > inputs.cutoff, P)
        prior = inputs.prior0 - 0.5 * torch.sum(theta * theta, dim=-1)
        nan_row = torch.isnan(theta).any(dim=-1)
        safe = torch.where(nan_row[..., None], torch.zeros_like(theta),
                           theta)
        x = torch.abs(safe) + inputs.sigma * noise
        diff = x - y_obs
        dis = torch.sqrt(torch.sum(diff * diff, dim=-1))
        dis = torch.where(torch.isnan(dis) | nan_row,
                          torch.full_like(dis, inputs.nan_dis), dis)
        r = dis / torch.as_tensor(inputs.epsilon, dtype=torch.float32,
                                  device=dis.device)
        plk = prior + (logk0 - 0.5 * (r * r))
        if out is None:
            return theta, x, dis, plk
        for dst, src in zip(out, (theta, x, dis, plk)):
            dst.copy_(src)
        return tuple(out)

    def _launch(self, u, z, noise, inputs: RedrawInputs, out):
        from ._build import load_library

        (C, M), (P, d) = u.shape, noise.shape[1:]
        if out is None:
            out = tuple(torch.empty(s, dtype=torch.float32, device=u.device)
                        for s in ((C, P, d), (C, P, d), (C, P), (C, P)))
        if C * P == 0:
            return tuple(out)
        lib = load_library("shared_redraw")
        ptrs = [t.data_ptr() for t in (u, z, noise, *inputs[:5], *out)]
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            rc = lib.glabc_shared_redraw(
                *ptrs, C, M, P, inputs.cdf.shape[0], d, inputs.prior0,
                inputs.cutoff, inputs.sigma, inputs.epsilon, inputs.nan_dis,
                stream)
        if rc != 0:
            raise RuntimeError(f"shared_redraw launch failed: CUDA error {rc}")
        type(self).launches += 1
        return tuple(out)
