"""Probability distributions in torch.

Port of ``glabc_tpu/models/distributions.py`` (reference
``glabcmcmc/distribution.py``: Uniform :50, Gamma :90, DiagGaussian :143,
GaussianMixture :206).  Each distribution is an ``nn.Module``: fixed
parameters are buffers, the trainable mixture's are ``nn.Parameter``s, and
``.to(device)`` moves them.  Sampling takes an explicit ``torch.Generator``
where the JAX package threads a key; every method is batch-first and
broadcasts over leading axes.

* ``forward(num_samples, generator) -> (z, log_p)``
* ``log_prob(z) -> (...,)`` for ``z`` of shape ``(..., d)``
* ``sample(num_samples, generator) -> z``
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Uniform", "Gamma", "DiagGaussian", "GaussianMixture"]

_LOG_2PI = math.log(2.0 * math.pi)


def _as_1d(x, dim=None, device=None) -> torch.Tensor:
    """Scalars / nested shapes -> flat float32 event vector."""
    arr = torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)
    if dim is not None and arr.shape[0] == 1 and dim > 1:
        arr = arr.expand(dim)
    return arr.clone()


def _randn(shape, like: torch.Tensor, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=like.device)


class Uniform(nn.Module):
    """Box uniform on ``[low, high]^d``; any coordinate outside makes the
    whole row ``-inf`` (reference ``distribution.py:81-86``)."""

    def __init__(self, low: torch.Tensor, high: torch.Tensor):
        super().__init__()
        self.register_buffer("low", low)
        self.register_buffer("high", high)

    @classmethod
    def create(cls, dim: int, low=-2.0, high=2.0, device=None) -> "Uniform":
        return cls(_as_1d(low, dim, device), _as_1d(high, dim, device))

    @property
    def dim(self) -> int:
        return self.low.shape[-1]

    def _log_prob_const(self) -> torch.Tensor:
        return -torch.sum(torch.log(self.high - self.low), dim=-1)

    def sample(self, num_samples: int = 1, generator=None) -> torch.Tensor:
        u = torch.rand((num_samples, self.dim), generator=generator,
                       device=self.low.device)
        return self.low + (self.high - self.low) * u

    def log_prob(self, z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32, device=self.low.device)
        inside = torch.all((z >= self.low) & (z <= self.high), dim=-1)
        const = self._log_prob_const()
        return torch.where(inside, const, torch.full_like(const, -math.inf))

    def forward(self, num_samples: int = 1, generator=None):
        z = self.sample(num_samples, generator)
        return z, self._log_prob_const().expand(num_samples).clone()


class Gamma(nn.Module):
    """Independent Gamma per coordinate (concentration, rate); ``-inf``
    outside the support (reference ``distribution.py:136``)."""

    def __init__(self, concentration: torch.Tensor, rate: torch.Tensor):
        super().__init__()
        self.register_buffer("concentration", concentration)
        self.register_buffer("rate", rate)

    @classmethod
    def create(cls, concentration, rate, device=None) -> "Gamma":
        return cls(_as_1d(concentration, device=device),
                   _as_1d(rate, device=device))

    @property
    def dim(self) -> int:
        return self.concentration.shape[-1]

    def sample(self, num_samples: int = 1, generator=None) -> torch.Tensor:
        a = self.concentration.expand(num_samples, self.dim).contiguous()
        return torch._standard_gamma(a, generator=generator) / self.rate

    def log_prob(self, z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32,
                            device=self.concentration.device)
        a = self.concentration
        valid = z > 0
        zs = torch.where(valid, z, torch.ones_like(z))
        per_dim = (a * torch.log(self.rate) + (a - 1.0) * torch.log(zs)
                   - self.rate * zs - torch.lgamma(a))
        per_dim = torch.where(valid, per_dim,
                              torch.full_like(per_dim, -math.inf))
        return torch.sum(per_dim, dim=-1)

    def forward(self, num_samples: int = 1, generator=None):
        z = self.sample(num_samples, generator)
        return z, self.log_prob(z)


class DiagGaussian(nn.Module):
    """Gaussian with diagonal covariance, including the joint independent
    ``cdf`` (reference ``distribution.py:143-203``)."""

    def __init__(self, loc: torch.Tensor, log_scale: torch.Tensor):
        super().__init__()
        self.register_buffer("loc", loc)
        self.register_buffer("log_scale", log_scale)

    @classmethod
    def create(cls, dim: int, loc=0.0, log_scale=0.0,
               device=None) -> "DiagGaussian":
        return cls(_as_1d(loc, dim, device), _as_1d(log_scale, dim, device))

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, num_samples: int = 1, generator=None) -> torch.Tensor:
        eps = _randn((num_samples, self.dim), self.loc, generator)
        return self.loc + torch.exp(self.log_scale) * eps

    def log_prob(self, z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32, device=self.loc.device)
        eps = (z - self.loc) / torch.exp(self.log_scale)
        return -0.5 * self.dim * _LOG_2PI - torch.sum(
            self.log_scale + 0.5 * eps * eps, dim=-1)

    def forward(self, num_samples: int = 1, generator=None):
        eps = _randn((num_samples, self.dim), self.loc, generator)
        z = self.loc + torch.exp(self.log_scale) * eps
        log_p = -0.5 * self.dim * _LOG_2PI - torch.sum(
            self.log_scale + 0.5 * eps * eps, dim=-1)
        return z, log_p

    def cdf(self, z) -> torch.Tensor:
        """Joint independent CDF: product of per-coordinate normal CDFs."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.loc.device)
        x = (z - self.loc) / torch.exp(self.log_scale)
        per_dim = 0.5 * torch.erfc(-x / math.sqrt(2.0))
        return torch.prod(per_dim, dim=-1)


class GaussianMixture(nn.Module):
    """Mixture of diagonal Gaussians with trainable ``loc``, ``log_scale``
    and ``weight_logits`` (reference ``distribution.py:206-293``)."""

    def __init__(self, loc: torch.Tensor, log_scale: torch.Tensor,
                 weight_logits: torch.Tensor):
        super().__init__()
        self.loc = nn.Parameter(loc)
        self.log_scale = nn.Parameter(log_scale)
        self.weight_logits = nn.Parameter(weight_logits)

    @classmethod
    def create(cls, n_modes: int, dim: int, loc=None, scale=None,
               weights=None, generator=None, device=None) -> "GaussianMixture":
        f = dict(dtype=torch.float32, device=device)
        if loc is None:
            loc = torch.randn((n_modes, dim), generator=generator, **f)
        loc = torch.as_tensor(loc, **f).reshape(n_modes, dim)
        scale = (torch.ones((n_modes, dim), **f) if scale is None
                 else torch.as_tensor(scale, **f).reshape(n_modes, dim))
        weights = (torch.ones((n_modes,), **f) if weights is None
                   else torch.as_tensor(weights, **f).reshape(n_modes))
        weights = weights / torch.sum(weights)
        return cls(loc.clone(), torch.log(scale), torch.log(weights))

    @property
    def n_modes(self) -> int:
        return self.loc.shape[-2]

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def log_prob(self, z) -> torch.Tensor:
        z = torch.as_tensor(z, dtype=torch.float32, device=self.loc.device)
        eps = (z[..., None, :] - self.loc) / torch.exp(self.log_scale)
        log_p = (-0.5 * self.dim * _LOG_2PI
                 + torch.log_softmax(self.weight_logits, dim=-1)
                 - 0.5 * torch.sum(eps * eps, dim=-1)
                 - torch.sum(self.log_scale, dim=-1))
        return torch.logsumexp(log_p, dim=-1)

    def sample(self, num_samples: int = 1, generator=None) -> torch.Tensor:
        probs = torch.softmax(self.weight_logits.detach(), dim=-1)
        mode = torch.multinomial(probs, num_samples, replacement=True,
                                 generator=generator)
        eps = _randn((num_samples, self.dim), self.loc, generator)
        return self.loc[mode] + torch.exp(self.log_scale)[mode] * eps

    def forward(self, num_samples: int = 1, generator=None):
        z = self.sample(num_samples, generator)
        return z, self.log_prob(z)
