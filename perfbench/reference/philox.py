"""Philox4x32-10 and the draws built on it, in plain torch.

A frozen copy of the port's plain random numbers: a draw is a pure function
of ``(seed, chain, step, block)`` (counter ``(chain, step, block, 0)``, key
``(seed & 0xffffffff, seed >> 32)``), lane ``i`` of a block one uniform
``(bits >> 8) 2^-24 + 2^-25``.  Keys may be tensors, one per row, so that
rows of different runs are stepped together.  Words are carried in int64
tensors holding values in ``[0, 2^32)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF

TWO_PI = float(np.float32(2.0 * math.pi))
_U_MAX = float(np.float32(1.0) - np.float32(2.0 ** -24))


def _mulhilo(a: int, b: torch.Tensor):
    p0 = (b & 0xFFFF) * a
    p1 = (b >> 16) * a
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & _MASK


def seed_key(seed):
    """Key words of a non-negative 64-bit seed (an int or an int64
    tensor)."""
    if isinstance(seed, torch.Tensor):
        return seed & _MASK, (seed >> 32) & _MASK
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return seed & _MASK, (seed >> 32) & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on broadcastable int64 counter and key words."""
    c = list(torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.int64)
                                       for x in (c0, c1, c2, c3))))
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def uniforms(seed, chain: torch.Tensor, step: int, n_blocks: int
             ) -> torch.Tensor:
    """``(R, 4 n_blocks)`` uniforms of blocks ``0 .. n_blocks - 1`` at
    absolute step ``step`` for rows of global chain ``chain (R,)`` and seed
    ``seed`` (an int, or an ``(R,)`` int64 tensor)."""
    k0, k1 = seed_key(seed)
    if isinstance(k0, torch.Tensor):
        k0, k1 = k0[:, None], k1[:, None]
    i64 = dict(dtype=torch.int64, device=chain.device)
    words = philox4x32(chain.to(torch.int64)[:, None],
                       torch.full((1, 1), int(step), **i64),
                       torch.arange(n_blocks, **i64)[None, :],
                       torch.zeros((1, 1), **i64), k0, k1)
    bits = torch.stack(words, dim=-1).reshape(chain.shape[0], 4 * n_blocks)
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)
    return torch.clamp_max(u, _U_MAX)


def normal_pair(u1: torch.Tensor, u2: torch.Tensor):
    """Box-Muller, both branches."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    a = u2 * TWO_PI
    return r * torch.cos(a), r * torch.sin(a)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))
