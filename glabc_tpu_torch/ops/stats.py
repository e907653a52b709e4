"""Chain diagnostics and weighted statistics in torch.

Port of ``glabc_tpu/ops/stats.py``: :func:`esjd` (reference ``ESJD.py:2-25``)
and its per-second score :func:`esjd_per_second` (``Mixture_hyper.py:36-37``),
:func:`weighted_std` (``kernel_density.py:39-68``) and :func:`chain_summary`
(the report every reference sampler prints, e.g. ``GLMCMC.py:113-135``), plus
ESS and rank-normalized split R-hat.  Inputs may be numpy arrays or tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["esjd", "esjd_per_second", "ess", "rhat", "weighted_std",
           "chain_summary", "ChainSummary"]


def _t(x, dtype=torch.float32) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def esjd(chain) -> torch.Tensor:
    """Expected squared jump distance as a generalized variance:
    ``det(delta^T delta / n) ** (1/d)`` over consecutive jumps
    (``ESJD.py:17-24``).  ``(N, d)`` or batched ``(..., N, d)``."""
    chain = _t(chain)
    delta = chain[..., 1:, :] - chain[..., :-1, :]
    n, d = delta.shape[-2], delta.shape[-1]
    m = torch.einsum("...nd,...ne->...de", delta, delta) / n
    det = torch.linalg.det(m)
    return torch.sign(det) * torch.abs(det) ** (1.0 / d)


def esjd_per_second(chain, wallclock_s: float, num_ite: int) -> torch.Tensor:
    """The reference's hyperparameter-selection score,
    ``esjd(chain) / (wallclock / num_ite)`` (``Mixture_hyper.py:36-37``)."""
    return esjd(chain) / (wallclock_s / num_ite)


def ess(chain) -> torch.Tensor:
    """Effective sample size per dimension (Geyer initial positive
    sequence): FFT autocovariance, paired lags truncated at the first
    non-positive pair sum.  ``(..., N, d) -> (..., d)``."""
    chain = _t(chain, torch.float64)
    n = chain.shape[-2]
    x = chain - chain.mean(dim=-2, keepdim=True)
    f = torch.fft.rfft(x, n=2 * n, dim=-2)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=-2)[..., :n, :] / n
    a0 = acov[..., :1, :]
    rho = acov / torch.where(a0 == 0, torch.ones_like(a0), a0)
    n_pairs = n // 2
    pairs = rho[..., :2 * n_pairs, :].reshape(
        *rho.shape[:-2], n_pairs, 2, rho.shape[-1]).sum(dim=-2)
    keep = torch.cumprod((pairs > 0.0).to(pairs.dtype), dim=-2)
    tau = -1.0 + 2.0 * torch.sum(pairs * keep, dim=-2)
    tau = torch.clamp_min(tau, 1.0)
    return (n / tau).to(torch.float32)


def rhat(chains) -> torch.Tensor:
    """Rank-normalized split R-hat per dimension (Vehtari et al. 2021) of
    ``(C >= 2, N, d)`` chains: the max of the bulk and the folded statistic.
    Host-side numpy/scipy; ties get average ranks."""
    from scipy.stats import norm as _norm
    from scipy.stats import rankdata as _rankdata

    x = (chains.detach().cpu().numpy() if isinstance(chains, torch.Tensor)
         else np.asarray(chains)).astype(np.float64)
    if x.ndim != 3 or x.shape[0] < 2:
        raise ValueError("rhat needs (C>=2, N, d) chains")
    C, N, d = x.shape
    half = N // 2
    if half < 2:
        raise ValueError("rhat needs at least 4 draws per chain")
    split = x[:, :2 * half, :].reshape(C * 2, half, d)
    m, n = C * 2, half

    def split_rhat(z):
        cm = z.mean(axis=1)
        B = n * cm.var(axis=0, ddof=1)
        W = z.var(axis=1, ddof=1).mean(axis=0)
        W = np.where(W == 0.0, np.finfo(np.float64).tiny, W)
        return np.sqrt(((n - 1) / n * W + B / n) / W)

    def rank_normal(v):
        flat = v.reshape(m * n, d)
        r = np.stack([_rankdata(flat[:, j], method="average")
                      for j in range(d)], axis=1)
        return _norm.ppf((r - 0.375) / (m * n + 0.25)).reshape(m, n, d)

    bulk = split_rhat(rank_normal(split))
    folded = split_rhat(rank_normal(
        np.abs(split - np.median(split.reshape(m * n, d), axis=0))))
    return torch.as_tensor(np.maximum(bulk, folded), dtype=torch.float32)


def weighted_std(x, weights, unbiased: bool = True,
                 dim: Optional[int] = None, *,
                 axis: Optional[int] = None) -> torch.Tensor:
    """Weighted standard deviation with the reliability-weight correction
    ``1 / clamp(1 - sum(w^2), min=1e-10)`` (``kernel_density.py:39-68``).
    Leading axes of ``weights`` are batch axes (one chain each): the weights
    are normalized over their last axis, which ``dim`` of ``x`` indexes
    (default 0; ``axis=`` is the JAX package's name for it)."""
    if dim is not None and axis is not None:
        raise ValueError("weighted_std: give dim= or axis=, not both")
    dim = axis if axis is not None else (0 if dim is None else dim)
    x, weights = _t(x), _t(weights)
    w = weights / torch.sum(weights, dim=-1, keepdim=True)
    w_ex = w.unsqueeze(-1) if x.dim() > w.dim() else w
    mean = torch.sum(w_ex * x, dim=dim, keepdim=True)
    diff = x - mean
    var = torch.sum(w_ex * (diff * diff), dim=dim)
    if unbiased:
        corr = torch.clamp(1.0 - torch.sum(w * w, dim=-1), min=1e-10)
        var = var / (corr.unsqueeze(-1) if var.dim() > corr.dim() else corr)
    return torch.sqrt(var)


@dataclasses.dataclass(frozen=True)
class ChainSummary:
    mean: torch.Tensor       # (d,)
    variance: torch.Tensor   # (d,)
    ci_lower: torch.Tensor   # (d,)
    ci_upper: torch.Tensor   # (d,)
    esjd: Optional[torch.Tensor] = None
    acceptance_rate: Optional[float] = None
    ess: Optional[torch.Tensor] = None
    rhat: Optional[torch.Tensor] = None

    def render(self) -> str:
        lines = []
        for i in range(self.mean.shape[0]):
            lines.append(f"Theta_Re {i + 1}:")
            lines.append(f"  Mean: {float(self.mean[i]):.4f}")
            lines.append(f"  Variance: {float(self.variance[i]):.4f}")
            lines.append("  95% Confidence Interval: "
                         f"({float(self.ci_lower[i]):.4f}, "
                         f"{float(self.ci_upper[i]):.4f})")
            if self.ess is not None:
                lines.append(f"  Effective Sample Size: {float(self.ess[i]):.2f}")
            if self.rhat is not None:
                lines.append(f"  R-hat: {float(self.rhat[i]):.4f}")
        if self.esjd is not None:
            lines.append(f"ESJD: {float(self.esjd):.6g}")
        if self.acceptance_rate is not None:
            lines.append(f"Acceptance rate: {float(self.acceptance_rate):.4f}")
        return "\n".join(lines)


def chain_summary(chain, acceptance_rate=None, with_esjd: bool = False,
                  with_ess: bool = False,
                  with_rhat: bool = False) -> ChainSummary:
    """Per-dimension mean / unbiased variance / z=1.96 CI over all leading
    axes, accumulated in float64 on the host (float32 sums over >1e7
    samples drift).  ``with_ess`` sums ESS over chains; ``with_rhat`` needs
    ``(C>=2, N>=4, d)`` chains and is omitted otherwise."""
    arr = (chain.detach().cpu().numpy() if isinstance(chain, torch.Tensor)
           else np.asarray(chain))
    d = arr.shape[-1]
    flat = arr.astype(np.float64).reshape(-1, d)
    mean = torch.as_tensor(flat.mean(axis=0), dtype=torch.float32)
    var = torch.as_tensor(flat.var(axis=0, ddof=1), dtype=torch.float32)
    std = torch.sqrt(var)
    z = 1.96
    e = None
    if with_ess:
        e = torch.sum(ess(arr if arr.ndim == 3 else arr[None]), dim=0)
    r = None
    if with_rhat and arr.ndim == 3 and arr.shape[0] >= 2 and arr.shape[1] >= 4:
        r = rhat(arr)
    return ChainSummary(mean=mean, variance=var, ci_lower=mean - z * std,
                        ci_upper=mean + z * std,
                        esjd=esjd(flat) if with_esjd else None,
                        acceptance_rate=acceptance_rate, ess=e, rhat=r)
