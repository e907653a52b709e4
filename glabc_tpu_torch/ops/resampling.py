"""Fixed-shape resampling primitives in torch.

Port of ``glabc_tpu/ops/resampling.py``: the reference's Python-loop
``weight_sampling`` (``GLMCMC.py:7-22``) becomes a Gumbel-max categorical and
its systematic resampler (``GLMCMC_NFs.py:29-40``) one ``searchsorted``.
The ``blocked_*`` and ``stable_partition_*`` helpers wait for AGLMCMC
(ROADMAP Queue 1, M8).
"""

from __future__ import annotations

import math

import torch

__all__ = ["sanitize_log_weights", "categorical_from_log_weights",
           "systematic_resample"]

_TINY = torch.finfo(torch.float32).tiny


def sanitize_log_weights(log_w: torch.Tensor) -> torch.Tensor:
    """Map NaN log-weights to ``-inf`` (zero mass), the reference's
    ``weight[isnan(weight)] = 0`` (``GLMCMC.py:80-81``) in log space."""
    return torch.where(torch.isnan(log_w), torch.full_like(log_w, -math.inf),
                       log_w)


def categorical_from_log_weights(log_w: torch.Tensor, generator=None,
                                 dim: int = -1) -> torch.Tensor:
    """One index per row proportional to ``exp(log_w)`` (Gumbel-max).
    Unnormalized weights are fine; NaNs are zero mass.  If every weight is
    zero the draw is index 0, the iSIR samplers' "stay" slot
    (``GLMCMC.py:84``)."""
    log_w = sanitize_log_weights(log_w)
    u = torch.rand(log_w.shape, generator=generator, dtype=torch.float32,
                   device=log_w.device).clamp_min(_TINY)
    score = log_w + (-torch.log(-torch.log(u)))
    score = torch.where(torch.isneginf(log_w),
                        torch.full_like(score, -math.inf), score)
    return torch.argmax(score, dim=dim)


def systematic_resample(w: torch.Tensor, num_samples: int,
                        generator=None) -> torch.Tensor:
    """Systematic resampling: index ``j`` appears
    ``#{i : cumsum(w)[j-1] <= u_i < cumsum(w)[j]}`` times, with
    ``u_i = (u + i) / N`` and one ``u ~ U[0, 1)``.  ``w`` should be
    normalized; NaNs and negatives count as 0."""
    w = torch.where(torch.isnan(w) | (w < 0), torch.zeros_like(w), w)
    c = torch.cumsum(w, dim=-1)
    u0 = torch.rand((), generator=generator, dtype=w.dtype, device=w.device)
    u = (u0 + torch.arange(num_samples, dtype=w.dtype, device=w.device)
         ) / num_samples
    idx = torch.searchsorted(c, u, right=True)
    return torch.clamp(idx, 0, w.shape[-1] - 1)
