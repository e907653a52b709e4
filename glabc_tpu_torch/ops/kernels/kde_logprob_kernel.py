"""Per-chain weighted-KDE log-density, batched over chains: the CUDA
kernel's wrapper and its plain torch version.

Port of ``glabc_tpu/ops/pallas/kde_logprob_kernel.py``
(``BatchedMixtureLogProb``, K4, and ``batched_kde_log_prob``); the kernel is
``csrc/kde_logprob.cu``.  The AGLMCMC adaptation epoch evaluates each
chain's redrawn pool (N points) under that chain's own KDE (P components),
and the shared epoch its redrawn pools under the shared KDE as one chain
(C = 1, N = a redraw chunk's chains x pool rows, P = the support) up to
d = 128, there with the pool's epilogue (``log_w=``: the rows' log-weights
from their prior + log K, written in place, and the NaN rows of ``x`` set to
0; the rows as K10, ``shared_redraw_kernel.py``, drew them):

    log q_c(x) = logsumexp_i(pre[c,i] + sum_f ms[c,i,f] x_f)
                 - 0.5 sum_f x_f^2 inv_h2[c,f]

with ``ms = mu / h^2`` and ``pre = log(w + 1e-10) - 0.5 sum_f mu_f^2 / h_f^2
- sum_f log h_f - (d/2) log 2 pi``.  This differs from
:meth:`KernelDensity.log_prob` (``|x'|^2 - 2 x'.X' + |X'|^2`` with a clamp)
by float rounding, ~1e-5..1e-4.  Layouts are torch's own: points
``(C, N, d)``, ``ms (C, P, d)``, ``pre (C, P)``, ``inv_h2 (C, d)``, result
``(C, N)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["BatchedMixtureLogProb", "batched_kde_log_prob",
           "kde_logprob_inputs"]

_LOG_2PI = math.log(2.0 * math.pi)
# the plain version works this many elements of (chains, N, P) at a time
_PLAIN_CHUNK = 1 << 27
_MAX_D = 128         # csrc/kde_logprob.cu: d up to this
_WIDE_D = 32         # above this the runtime-d variant


def kde_logprob_inputs(kdes):
    """``(ms (C, P, d), pre (C, P), inv_h2 (C, d))`` of a chain-batched
    :class:`~glabc_tpu_torch.models.kde.KernelDensity`."""
    d = kdes.dim
    bw = kdes.bandwidth.to(torch.float32)                       # (C, d)
    inv_h2 = 1.0 / (bw * bw)
    const = -torch.sum(torch.log(bw), dim=1) - 0.5 * d * _LOG_2PI
    mu = kdes.X.to(torch.float32)
    pre = (torch.log(kdes.weights + 1e-10) + const[:, None]
           - 0.5 * torch.sum(mu * mu * inv_h2[:, None, :], dim=-1))
    ms = mu * inv_h2[:, None, :]
    return ms.contiguous(), pre.contiguous(), inv_h2.contiguous()


class BatchedMixtureLogProb:
    """``run(x, ms, pre, inv_h2, *, out=None, log_w=None) -> (C, N)``, into
    ``out`` where given.  ``log_w`` (C, N), where given, holds each point's
    prior + log K and gets the pool epilogue in place: ``log_w - log q``, a
    NaN as -inf; then every row of ``x`` that holds a NaN is set to 0 (the
    shared epoch's pool rows: the density is taken at the rows as drawn,
    the pool keeps them with NaN rows zeroed).  ``launches`` counts
    launches of the CUDA kernel at d up to 32 and ``wide_launches`` those
    of its runtime-d variant above, up to 128, without the epilogue, and
    ``pool_launches`` those with it at any d (class-wide); each rises for
    nothing else.  The plain
    version works ``_PLAIN_CHUNK`` elements of ``(chains, N, P)`` at a
    time, in blocks of chains and of points, so it runs at any chain and
    point count."""

    launches = 0
    wide_launches = 0
    pool_launches = 0

    @staticmethod
    def _check(x, ms, pre, inv_h2, out=None, log_w=None):
        dev = x.device
        for name, t in (("x", x), ("ms", ms), ("pre", pre),
                        ("inv_h2", inv_h2), ("out", out), ("log_w", log_w)):
            if t is None and name in ("out", "log_w"):
                continue
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if x.dim() != 3:
            raise ValueError(f"x must be (C, N, d), got {tuple(x.shape)}")
        C, N, d = x.shape
        P = ms.shape[1] if ms.dim() == 3 else -1
        want = {"ms": (C, P, d), "pre": (C, P), "inv_h2": (C, d)}
        for name, t in (("ms", ms), ("pre", pre), ("inv_h2", inv_h2)):
            if tuple(t.shape) != want[name] or P < 1:
                raise ValueError(f"{name} must be {want[name]} with P >= 1, "
                                 f"got {tuple(t.shape)}")
        for name, t in (("out", out), ("log_w", log_w)):
            if t is not None and tuple(t.shape) != (C, N):
                raise ValueError(f"{name} must be {(C, N)}, got "
                                 f"{tuple(t.shape)}")
        return C, N, P, d

    def run(self, x, ms, pre, inv_h2, *, out=None,
            log_w=None) -> torch.Tensor:
        self._check(x, ms, pre, inv_h2, out, log_w)
        if x.device.type == "cuda":
            return self._launch(x, ms, pre, inv_h2, out, log_w)
        if x.device.type == "cpu":
            return self.plain(x, ms, pre, inv_h2, out=out, log_w=log_w)
        raise ValueError(f"no kernel for device {x.device}")

    def plain(self, x, ms, pre, inv_h2, *, out=None,
              log_w=None) -> torch.Tensor:
        """The plain torch version of :meth:`run`, on any device: the same
        terms in the same order, a two-pass logsumexp; then the pool
        epilogue where ``log_w`` is given."""
        C, N, P, d = self._check(x, ms, pre, inv_h2, out, log_w)
        if out is None:
            out = torch.empty((C, N), dtype=torch.float32, device=x.device)
        rows = max(1, min(N, _PLAIN_CHUNK // P))        # points a block
        step = max(1, _PLAIN_CHUNK // max(1, rows * P))  # chains a block
        for c0 in range(0, C, step):
            sl = slice(c0, c0 + step)
            for n0 in range(0, N, rows):
                xs, sn = x[sl, n0:n0 + rows], slice(n0, n0 + rows)
                lw = pre[sl, None, :].expand(-1, xs.shape[1], P)
                for f in range(d):
                    lw = lw + xs[:, :, f:f + 1] * ms[sl, None, :, f]
                q2 = None
                for f in range(d):
                    term = (xs[:, :, f] * xs[:, :, f]) * inv_h2[sl, f:f + 1]
                    q2 = term if q2 is None else q2 + term
                out[sl, sn] = torch.logsumexp(lw, dim=-1) - 0.5 * q2
        if log_w is not None:
            lw = log_w - out
            log_w.copy_(torch.where(torch.isnan(lw),
                                    torch.full_like(lw, -math.inf), lw))
            x.masked_fill_(torch.isnan(x).any(dim=-1, keepdim=True), 0.0)
        return out

    def _launch(self, x, ms, pre, inv_h2, out=None,
                log_w=None) -> torch.Tensor:
        from ._build import load_library

        C, N, P, d = x.shape[0], x.shape[1], ms.shape[1], x.shape[2]
        if d > _MAX_D:
            raise ValueError(f"the CUDA kernel takes d <= {_MAX_D}, got {d}")
        if out is None:
            out = torch.empty((C, N), dtype=torch.float32, device=x.device)
        if C * N == 0:
            return out
        lib = load_library("kde_logprob")
        ptrs = (x.data_ptr(), ms.data_ptr(), pre.data_ptr(),
                inv_h2.data_ptr(), out.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if log_w is None:
                rc = lib.glabc_kde_logprob(*ptrs, C, N, P, d, stream)
            else:
                rc = lib.glabc_kde_logprob_pool(*ptrs, log_w.data_ptr(), C,
                                                N, P, d, stream)
        if rc != 0:
            raise RuntimeError(f"kde_logprob launch failed: CUDA error {rc}")
        if log_w is not None:
            type(self).pool_launches += 1
        elif d > _WIDE_D:
            type(self).wide_launches += 1
        else:
            type(self).launches += 1
        return out


def batched_kde_log_prob(kdes, x, kernel: BatchedMixtureLogProb = None
                         ) -> torch.Tensor:
    """Each chain's points ``x (C, N, d)`` under that chain's KDE (``kdes``
    batched over C chains) -> ``(C, N)``: the inputs in torch, then the
    kernel (or, for CPU tensors, its plain version)."""
    ms, pre, inv_h2 = kde_logprob_inputs(kdes)
    x = torch.as_tensor(x, dtype=torch.float32, device=ms.device).contiguous()
    return (kernel or BatchedMixtureLogProb()).run(x, ms, pre, inv_h2)
