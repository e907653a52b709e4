"""Fixed-shape resampling primitives in torch.

Port of ``glabc_tpu/ops/resampling.py``: the reference's Python-loop
``weight_sampling`` (``GLMCMC.py:7-22``) becomes a Gumbel-max categorical and
its systematic resampler (``GLMCMC_NFs.py:29-40``) one ``searchsorted``.

The JAX package writes its AGLMCMC selection helpers as one-hot matmuls and
a two-level block search, because gathers serialize on the TPU.  Here they
are what they compute: ``torch.searchsorted(..., right=True)`` plus a
``gather``, and an integer ``cumsum`` plus a scatter.  Counts are int64, so
the partition stays exact past 2^24 rows (the JAX float32 cumsum does not).
Every function takes any leading (chain) axes; results are bitwise equal to
the JAX functions' (same indices, same rows).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["sanitize_log_weights", "categorical_from_log_weights",
           "categorical_from_weights", "systematic_resample",
           "stable_partition_indices", "stable_partition_take",
           "blocked_searchsorted_take", "blocked_stable_partition_take"]

_TINY = torch.finfo(torch.float32).tiny


def sanitize_log_weights(log_w: torch.Tensor) -> torch.Tensor:
    """Map NaN log-weights to ``-inf`` (zero mass), the reference's
    ``weight[isnan(weight)] = 0`` (``GLMCMC.py:80-81``) in log space."""
    return torch.where(torch.isnan(log_w), torch.full_like(log_w, -math.inf),
                       log_w)


def categorical_from_log_weights(log_w: torch.Tensor, generator=None,
                                 dim: Optional[int] = None, *,
                                 axis: Optional[int] = None) -> torch.Tensor:
    """One index per row proportional to ``exp(log_w)`` (Gumbel-max) along
    ``dim`` (default -1; ``axis=`` is the JAX package's name for it).
    Unnormalized weights are fine; NaNs are zero mass.  If every weight is
    zero the draw is index 0, the iSIR samplers' "stay" slot
    (``GLMCMC.py:84``)."""
    if dim is not None and axis is not None:
        raise ValueError("categorical_from_log_weights: give dim= or axis=, "
                         "not both")
    dim = axis if axis is not None else (-1 if dim is None else dim)
    log_w = sanitize_log_weights(log_w)
    u = torch.rand(log_w.shape, generator=generator, dtype=torch.float32,
                   device=log_w.device).clamp_min(_TINY)
    score = log_w + (-torch.log(-torch.log(u)))
    score = torch.where(torch.isneginf(log_w),
                        torch.full_like(score, -math.inf), score)
    return torch.argmax(score, dim=dim)


def categorical_from_weights(w: torch.Tensor, generator=None,
                             dim: Optional[int] = None, *,
                             axis: Optional[int] = None) -> torch.Tensor:
    """:func:`categorical_from_log_weights` on linear weights ``w``; NaNs
    and negatives are zero mass.  ``axis=`` is an alias of ``dim=``."""
    w = torch.where(torch.isnan(w) | (w < 0), torch.zeros_like(w), w)
    pos = w > 0
    log_w = torch.where(pos, torch.log(torch.where(pos, w,
                                                   torch.ones_like(w))),
                        torch.full_like(w, -math.inf))
    return categorical_from_log_weights(log_w, generator, dim, axis=axis)


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


def _take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values (..., n, d)`` rows at ``idx (..., N)`` -> ``(..., N, d)``;
    2-D ``values`` are shared by every leading axis of ``idx``."""
    if values.dim() == 2:
        return values[idx]
    return torch.gather(values, -2,
                        idx[..., None].expand(*idx.shape, values.shape[-1]))


def blocked_searchsorted_take(sorted_vals: torch.Tensor,
                              queries: torch.Tensor, values: torch.Tensor,
                              block: int = 32):
    """``idx = clip(searchsorted(sorted_vals, queries, right), 0, n-1)`` and
    ``values[idx]``: ``sorted_vals (..., n)`` nondecreasing, ``queries
    (..., N)``, ``values (..., n, d)``.  Returns ``(picked (..., N, d), idx
    (..., N))``.  ``block`` is the JAX function's search block; the result
    does not depend on it."""
    del block
    n = sorted_vals.shape[-1]
    idx = torch.searchsorted(sorted_vals.contiguous(), queries.contiguous(),
                             right=True).clamp_(0, n - 1)
    return _take_rows(values.to(torch.float32), idx), idx


def stable_partition_indices(ok: torch.Tensor) -> torch.Tensor:
    """Indices listing the True rows of ``ok (..., n)`` first, each group in
    its original order: ``argsort(~ok, stable=True)`` in linear time, from
    two int64 cumulative sums and one scatter."""
    ok = ok.to(torch.bool)
    n = ok.shape[-1]
    rank_ok = torch.cumsum(ok, dim=-1, dtype=torch.int64) - 1
    rank_bad = torch.cumsum(~ok, dim=-1, dtype=torch.int64) - 1
    n_ok = rank_ok[..., -1:] + 1
    dest = torch.where(ok, rank_ok, n_ok + rank_bad)   # destination of row i
    src = torch.arange(n, dtype=torch.int64, device=ok.device).expand_as(dest)
    return torch.empty_like(dest).scatter_(-1, dest, src)


def stable_partition_take(x: torch.Tensor, ok: torch.Tensor,
                          n_take: int) -> torch.Tensor:
    """The first ``n_take`` rows of ``x (..., n, d)`` in the stable
    valid-first order of ``ok (..., n)``.  When fewer than ``n_take`` rows
    are valid, invalid rows fill the rest, as the JAX function does."""
    perm = stable_partition_indices(ok)[..., :n_take]
    return _take_rows(x.to(torch.float32), perm)


def blocked_stable_partition_take(x: torch.Tensor, ok: torch.Tensor,
                                  n_take: int,
                                  block: int = 128) -> torch.Tensor:
    """:func:`stable_partition_take` by the JAX function's route: the
    destination map inverted into two monotone searches over the int64
    cumulative counts of valid and of invalid rows."""
    ok = ok.to(torch.bool)
    cum_ok = torch.cumsum(ok, dim=-1, dtype=torch.int64)
    cum_bad = torch.cumsum(~ok, dim=-1, dtype=torch.int64)
    n_ok = cum_ok[..., -1:]
    p = torch.arange(n_take, dtype=torch.int64,
                     device=ok.device).expand(*ok.shape[:-1], n_take)
    # slot p takes the first row whose running count reaches p + 1
    val_pick, _ = blocked_searchsorted_take(cum_ok, p, x, block)
    bad_pick, _ = blocked_searchsorted_take(cum_bad, p - n_ok, x, block)
    return torch.where((p < n_ok)[..., None], val_pick, bad_pick)
