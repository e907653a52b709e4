"""Dimension-generic affine coupling (RealNVP-style) normalizing flow.

Port of ``glabc_tpu/models/flows.py`` (the flow the reference hardwires in
its NF sampler, ``GLMCMC_NFs.py:51-63``: 32 x [AffineCouplingBlock(MLP
[1,128,128,2], init_zeros) + Permute('swap')] over a trainable base, Adam
lr 5e-4 / weight-decay 1e-5):

* conditioner MLP ``[d1, hidden, hidden, 2*d2]`` with a zero last layer
  (the identity flow at init, ``init_zeros=True``);
* each block transforms the last ``d2 = dim // 2`` coordinates conditioned
  on the first ``d1 = dim - d2`` and then rolls the coordinates by ``d2``
  (the reference's half swap for even dims, well defined for odd ones);
* the ``n_layers`` blocks have one parameter shape each and are stacked on a
  leading layer axis: ``w0 (L, d1, H)``, ``b0 (L, H)``, ``w1 (L, H, H)``,
  ``b1 (L, H)``, ``w2 (L, H, 2*d2)``, ``b2 (L, 2*d2)``, the JAX stack's
  layout, which the K7 kernel reads as it is;
* the base ``N(loc, exp(log_scale)^2)`` is trained with the blocks, as the
  JAX pytree's ``base`` leaves are.

``push_t``/``pull_t`` are the plain torch transforms on feature-major
``(dim, N)`` tiles; they carry autograd and are what training
(:meth:`CouplingFlow.forward_kld`) differentiates.  With
``matmul_dtype='bfloat16'`` they round the conditioner's product operands
to bfloat16: the plain version of the K7-bf16 kernel.  :meth:`forward_t`
and :meth:`log_prob_t` (feature-major), and :meth:`forward` and
:meth:`log_prob` on top of them, evaluate the flow without gradients
through ``ops/kernels/flow_kernel.py``: on the card that is the K7 kernel,
on the CPU its plain version (``push_t``/``pull_t`` under ``no_grad``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .distributions import DiagGaussian

__all__ = ["CouplingFlow", "lecun_normal"]

_LOG_2PI = math.log(2.0 * math.pi)
# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _bf16_operands(matmul_dtype: str) -> bool:
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError("matmul_dtype must be 'float32' or 'bfloat16', got "
                         f"{matmul_dtype!r}")
    return matmul_dtype == "bfloat16"


def lecun_normal(shape, generator=None, device=None) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal()``: a normal truncated to two
    standard deviations, scaled to variance ``1 / fan_in``, where ``fan_in``
    is ``shape[-2]`` times every leading axis (JAX's receptive field)."""
    fan_in = math.prod(shape[:-1])
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=device) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(torch.float32)


class CouplingFlow(nn.Module):
    """Stacked affine coupling flow over a trainable diagonal-Gaussian base.

    The parameters are ``loc``, ``log_scale`` (the base) and the stacked
    conditioner weights ``w0, b0, w1, b1, w2, b2``."""

    def __init__(self, loc, log_scale, w0, b0, w1, b1, w2, b2):
        super().__init__()
        self.loc = nn.Parameter(torch.as_tensor(loc, dtype=torch.float32))
        self.log_scale = nn.Parameter(torch.as_tensor(log_scale,
                                                      dtype=torch.float32))
        for name, x in zip(("w0", "b0", "w1", "b1", "w2", "b2"),
                           (w0, b0, w1, b1, w2, b2)):
            setattr(self, name,
                    nn.Parameter(torch.as_tensor(x, dtype=torch.float32)))
        d = self.loc.shape[0]
        d2 = d // 2
        L, H = self.w0.shape[0], self.w0.shape[-1]
        want = {"log_scale": (d,), "w0": (L, d - d2, H), "b0": (L, H),
                "w1": (L, H, H), "b1": (L, H), "w2": (L, H, 2 * d2),
                "b2": (L, 2 * d2)}
        for name, shape in want.items():
            if tuple(getattr(self, name).shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(getattr(self, name).shape)}")

    @classmethod
    def create(cls, dim: int, n_layers: int = 32, hidden: int = 128,
               base: DiagGaussian | None = None, generator=None,
               device=None) -> "CouplingFlow":
        """A fresh flow: lecun-normal ``w0``/``w1``, zero biases and a zero
        last layer (the identity), over ``base`` (default ``N(0, I)``)."""
        d2 = dim // 2
        d1 = dim - d2
        if d2 == 0:
            raise ValueError("CouplingFlow needs dim >= 2")
        if generator is not None:
            device = generator.device
        if base is None:
            loc = torch.zeros(dim)
            log_scale = torch.zeros(dim)
        else:
            loc, log_scale = base.loc.detach(), base.log_scale.detach()
        f = dict(device=device)
        return cls(loc.to(device).clone(), log_scale.to(device).clone(),
                   lecun_normal((n_layers, d1, hidden), generator, device),
                   torch.zeros((n_layers, hidden), **f),
                   lecun_normal((n_layers, hidden, hidden), generator, device),
                   torch.zeros((n_layers, hidden), **f),
                   torch.zeros((n_layers, hidden, 2 * d2), **f),
                   torch.zeros((n_layers, 2 * d2), **f))

    # ------------------------------------------------------------ geometry
    @property
    def dim(self) -> int:
        return self.loc.shape[0]

    @property
    def n_layers(self) -> int:
        return self.w0.shape[0]

    @property
    def hidden(self) -> int:
        return self.w0.shape[2]

    @property
    def base(self) -> DiagGaussian:
        """The base distribution's current parameters (detached)."""
        return DiagGaussian(self.loc.detach(), self.log_scale.detach())

    def stack(self):
        return (self.w0, self.b0, self.w1, self.b1, self.w2, self.b2)

    # ------------------------------------------------- plain transforms
    def _conditioner(self, l: int, u1: torch.Tensor,
                     bf16: bool = False) -> torch.Tensor:
        """Layer ``l``'s MLP on ``u1 (N, d1)`` -> ``(N, 2*d2)``.  With
        ``bf16`` the operands of the three products are rounded to bfloat16
        (to nearest even) and the products accumulate in float32; biases,
        ReLU and the result stay float32 (JAX ``FusedCouplingFlow(
        matmul_dtype='bfloat16')``)."""
        r = _bf16 if bf16 else (lambda t: t)
        h = torch.relu(r(u1) @ r(self.w0[l]) + self.b0[l])
        h = torch.relu(r(h) @ r(self.w1[l]) + self.b1[l])
        return r(h) @ r(self.w2[l]) + self.b2[l]

    def push_t(self, z_t: torch.Tensor, matmul_dtype: str = "float32"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """base -> data over all layers: ``z_t (dim, N)`` -> ``(x_t (dim,
        N), sum of the log-scales (N,))``; ``matmul_dtype='bfloat16'``
        rounds the conditioner's product operands (:meth:`_conditioner`)."""
        bf16 = _bf16_operands(matmul_dtype)
        d2 = self.dim // 2
        d1 = self.dim - d2
        u = z_t.T
        acc = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
        for l in range(self.n_layers):
            u1, u2 = u[:, :d1], u[:, d1:]
            ts = self._conditioner(l, u1, bf16)
            t, s = ts[:, :d2], ts[:, d2:]
            v2 = u2 * torch.exp(s) + t
            u = torch.cat([v2, u1], dim=1)     # roll([u1, v2], d2)
            acc = acc + s.sum(dim=1)
        return u.T, acc

    def pull_t(self, x_t: torch.Tensor, matmul_dtype: str = "float32"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """data -> base over all layers: ``x_t (dim, N)`` -> ``(z_t, sum of
        the log-scales (N,))``."""
        bf16 = _bf16_operands(matmul_dtype)
        d2 = self.dim // 2
        v = x_t.T
        acc = torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
        for l in reversed(range(self.n_layers)):
            u1, v2 = v[:, d2:], v[:, :d2]       # roll(v, -d2) = [u1, v2]
            ts = self._conditioner(l, u1, bf16)
            t, s = ts[:, :d2], ts[:, d2:]
            v = torch.cat([u1, (v2 - t) * torch.exp(-s)], dim=1)
            acc = acc + s.sum(dim=1)
        return v.T, acc

    def base_log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """The base density of ``z (N, dim)`` (differentiable)."""
        eps = (z - self.loc) / torch.exp(self.log_scale)
        return -0.5 * self.dim * _LOG_2PI - torch.sum(
            self.log_scale + 0.5 * eps * eps, dim=-1)

    # ------------------------------------------------------------------ api
    def forward_t(self, num_samples: int = 1, generator=None):
        """Sample in the feature-major layout: ``(x_t (dim, N), log q
        (N,))``, without gradients; the push is the K7 kernel on the
        card."""
        from ..ops.kernels.flow_kernel import flow_push_fused

        with torch.no_grad():
            eps = torch.randn((num_samples, self.dim), generator=generator,
                              dtype=torch.float32, device=self.loc.device)
            z = self.loc + torch.exp(self.log_scale) * eps
            log_p = -0.5 * self.dim * _LOG_2PI - torch.sum(
                self.log_scale + 0.5 * eps * eps, dim=-1)
            x_t, s = flow_push_fused(self, z.T.contiguous())
            return x_t, log_p - s

    def log_prob_t(self, x_t) -> torch.Tensor:
        """``log q`` of feature-major points ``x_t (dim, N)`` -> ``(N,)``,
        without gradients; the pull is the K7 kernel on the card."""
        from ..ops.kernels.flow_kernel import flow_pull_fused

        x_t = torch.as_tensor(x_t, dtype=torch.float32,
                              device=self.loc.device)
        with torch.no_grad():
            z_t, s = flow_pull_fused(self, x_t.contiguous())
            return self.base_log_prob(z_t.T) - s

    def forward(self, num_samples: int = 1, generator=None):
        """Sample: ``(x (N, dim), log q(x) (N,))``, through
        :meth:`forward_t`."""
        x_t, log_q = self.forward_t(num_samples, generator)
        return x_t.T, log_q

    def sample(self, num_samples: int = 1, generator=None) -> torch.Tensor:
        return self.forward(num_samples, generator)[0]

    def log_prob(self, x) -> torch.Tensor:
        """``log q(x)`` of ``x (N, dim)`` or ``(dim,)``, through
        :meth:`log_prob_t`."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.loc.device)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        out = self.log_prob_t(x.T)
        return out[0] if squeeze else out

    def forward_kld(self, x: torch.Tensor) -> torch.Tensor:
        """Forward KL training loss ``-mean log q(x)`` on data ``x (N,
        dim)`` (reference ``NF_model.forward_kld``, ``GLMCMC_NFs.py:119``),
        through the plain, differentiable pull."""
        z_t, s = self.pull_t(x.T)
        return -torch.mean(self.base_log_prob(z_t.T) - s)
