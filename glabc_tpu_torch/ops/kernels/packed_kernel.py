"""Packed layout of the fused Mixture GLMCMC kernel.

Port of ``glabc_tpu/ops/pallas/packed_kernel.py`` (``PackedMixtureGLMCMC``,
K1).  On the TPU, packing ``8/d`` chains into each sublane group kept every
row of the ``(8, C)`` tile live.  On a GPU each thread owns one chain and
loops over its own d, so packing changes only the addressing: this wrapper
launches the same CUDA kernel as :class:`FusedMixtureGLMCMC`, with the packed
layout (dim j of chain ``p*C + c`` at row ``p*d + j``, column ``c``).  The
same chain index draws the same stream in either layout, so packed and
unpacked runs give the same chains.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mixture_kernel import _MixtureKernelBase

__all__ = ["PackedMixtureGLMCMC", "PackedStats", "packed_state_init",
           "unpack_history"]

_SUB = 8


class PackedStats(NamedTuple):
    accepted: torch.Tensor        # (8, C), on each chain group's leader row
    global_attempts: torch.Tensor
    global_accepts: torch.Tensor
    local_accepts: torch.Tensor


class PackedMixtureGLMCMC(_MixtureKernelBase):
    """Fused GLMCMC with ``8/d`` chains per column, for ``d in {1, 2, 4, 8}``.
    State, logk (group-broadcast) and counters (leader rows) are ``(8, C)``;
    history ``(T, 8, C)``."""

    launches = 0
    _stats_type = PackedStats

    def __init__(self, theta_dim: int, y_obs, **kwargs):
        if _SUB % int(theta_dim):
            raise ValueError(f"packed kernel needs d | 8, got {theta_dim}")
        super().__init__(theta_dim, y_obs, **kwargs)
        self.pack = _SUB // self.d
        self.groups_rows = (self.d, self.d)

    def _groups(self, rows: int) -> int:
        if rows != _SUB:
            raise ValueError(f"packed state must have {_SUB} rows, got {rows}")
        return self.pack


def packed_state_init(problem, generator: torch.Generator, theta0,
                      num_cols: int, pack: int, y0=None, device=None):
    """Packed ``(8, num_cols)`` initial state for ``pack * num_cols`` chains.

    ``y0``: ``(d,)``/``(1, d)`` broadcasts to every chain, ``(C, d)`` gives
    each its own; ``None`` simulates each chain's from ``theta0`` (see
    :func:`~glabc_tpu_torch.models.problems.initial_chains`)."""
    from ...models.problems import initial_chains

    d = problem.theta_dim
    if pack * d != _SUB:
        raise ValueError(f"pack * d must be {_SUB}, got {pack} * {d}")
    th_all, y_all, logk = initial_chains(problem, generator, theta0,
                                         pack * num_cols, y0, device)

    def to_packed(x_cd):  # (pack*C, d) -> (8, C)
        return (x_cd.reshape(pack, num_cols, d).permute(0, 2, 1)
                .reshape(_SUB, num_cols).contiguous())

    return (to_packed(th_all), to_packed(y_all),
            to_packed(logk[:, None].expand(pack * num_cols, d)))


def unpack_history(hist, d: int) -> np.ndarray:
    """``(T, 8, C)`` packed history -> ``(pack*C, T, d)`` chains (numpy)."""
    x = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    T, sub, C = x.shape
    pack = sub // d
    return x.reshape(T, pack, d, C).transpose(1, 3, 0, 2).reshape(pack * C, T, d)
