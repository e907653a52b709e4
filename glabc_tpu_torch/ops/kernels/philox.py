"""Philox4x32-10 in torch: the plain twin of ``csrc/philox.cuh``.

Replaces the TPU hardware PRNG helpers of
``glabc_tpu/ops/pallas/mixture_kernel.py:55-89`` (``_uniform``,
``_normal_pair``, ``_gumbel``).  Every draw is a pure function of
``(seed, chain, step, block)``: counter ``(chain, step, block, 0)``, key
``(seed & 0xffffffff, seed >> 32)``.  It gives the same bits on the CPU and
on the card, so the CUDA kernel can be held against this module on one
stream.

Words are carried in ``int64`` tensors holding values in ``[0, 2^32)``.  The
32x32 -> 64-bit products of a Philox round would overflow ``int64``, so the
variable operand is split into 16-bit halves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["philox4x32", "philox4x32_cuda", "uniform_from_bits",
           "normal_pair", "gumbel", "seed_key", "TWO_PI", "Draws",
           "block_uniforms"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF

# 2*pi rounded to float32, as the TPU kernel's ``(2.0 * np.pi) * u2``
TWO_PI = float(np.float32(2.0 * math.pi))
_U_MAX = float(np.float32(1.0) - np.float32(2.0 ** -24))


def _mulhilo(a: int, b: torch.Tensor):
    """``(hi, lo)`` words of ``a * b`` for a constant ``a < 2^32``."""
    p0 = (b & 0xFFFF) * a                 # < 2^48
    p1 = (b >> 16) * a                    # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)      # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & _MASK


def seed_key(seed: int):
    """The two key words of a (64-bit) integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return seed & _MASK, (seed >> 32) & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on broadcastable ``int64`` counter words.  Returns the
    four output words as ``int64`` tensors in ``[0, 2^32)``."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in (c0, c1, c2, c3)]
    c = list(torch.broadcast_tensors(*c))
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The TPU mapping ``(bits >> 8) * 2^-24 + 2^-25`` in float32.  The top
    value rounds to 1.0 in float32 and is sent to the largest float below 1,
    so ``u`` lies strictly inside ``(0, 1)``."""
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)
    return torch.clamp_max(u, _U_MAX)


def normal_pair(u1: torch.Tensor, u2: torch.Tensor):
    """Box-Muller, both branches: two independent standard normals."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    a = u2 * TWO_PI
    return r * torch.cos(a), r * torch.sin(a)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def block_uniforms(seed: int, chain_idx: torch.Tensor, step: int,
                   first, n_blocks: int) -> torch.Tensor:
    """The ``4 n_blocks`` uniforms of blocks ``first .. first + n_blocks
    - 1`` at absolute step ``step`` for chains ``chain_idx (C,)``: ``(C, 4
    n_blocks)``, lane ``i`` of block ``b`` at column ``4 (b - first) + i``.
    ``first`` is an int or a per-chain ``(C,)`` tensor."""
    k0, k1 = seed_key(seed)
    i64 = dict(dtype=torch.int64, device=chain_idx.device)
    blocks = torch.arange(n_blocks, **i64)[None, :]
    if isinstance(first, torch.Tensor):
        blocks = blocks + first.to(**i64)[:, None]
    else:
        blocks = blocks + int(first)
    words = philox4x32(chain_idx.to(torch.int64)[:, None],
                       torch.full((1, 1), int(step), **i64), blocks,
                       torch.zeros((1, 1), **i64), k0, k1)
    return uniform_from_bits(torch.stack(words, dim=-1).reshape(
        chain_idx.shape[0], 4 * n_blocks))


class Draws:
    """A cursor over the uniforms of consecutive Philox blocks, the twin of
    ``csrc/philox.cuh``'s ``Draws``: it starts at lane 0 of block
    ``first`` (counter ``(chain, step, block, 0)``) and hands out one
    uniform per lane, crossing into the next block after lane 3.  A normal
    pair is Box-Muller on the next two uniforms; :meth:`normals` is ``n``
    normals as consecutive pairs' (cos, sin) branches.  ``paired`` marks a
    simulator cursor that re-reads its proposal's blocks.  ``first`` may be
    a per-chain ``(C,)`` tensor (a batch of cursors with different
    starts).

    Every method returns ``(C,)`` (or ``(C, n)``) tensors for the chains
    ``chain_idx``; the tests substitute an object with the same methods."""

    def __init__(self, seed: int, chain_idx: torch.Tensor, step: int,
                 first, paired: bool = False):
        self.seed, self.chain_idx = int(seed), chain_idx
        self.step, self.first, self.paired = int(step), first, paired
        self.used = 0          # uniforms handed out
        self._cache = None     # (first block, uniforms) of the last fetch

    def uniforms(self, n: int) -> torch.Tensor:
        lo, hi = self.used, self.used + n
        b0, b1 = lo // 4, (hi + 3) // 4
        c = self._cache
        if c is None or c[0] > b0 or c[0] + c[1].shape[1] // 4 < b1:
            c = self._cache = (b0, block_uniforms(
                self.seed, self.chain_idx, self.step, self.first + b0,
                b1 - b0))
        self.used = hi
        off = 4 * c[0]
        return c[1][:, lo - off:hi - off]

    def uniform(self) -> torch.Tensor:
        return self.uniforms(1)[:, 0]

    def normal_pair(self):
        u = self.uniforms(2)
        return normal_pair(u[:, 0], u[:, 1])

    def normal_pairs(self, n: int):
        """``n`` pairs: ``(cos branches (C, n), sin branches (C, n))``."""
        u = self.uniforms(2 * n).reshape(-1, n, 2)
        return normal_pair(u[..., 0], u[..., 1])

    def normals(self, n: int) -> torch.Tensor:
        """``n`` normals ``(C, n)``: pair ``i`` gives normals ``2i`` (cos)
        and ``2i + 1`` (sin)."""
        a, b = self.normal_pairs((n + 1) // 2)
        return torch.stack([a, b], dim=-1).reshape(a.shape[0], -1)[:, :n]

    @property
    def blocks_used(self) -> int:
        return (self.used + 3) // 4


def philox4x32_cuda(words: torch.Tensor) -> torch.Tensor:
    """``csrc/philox.cuh`` itself, run on the card, for checking it against
    :func:`philox4x32`: ``words`` is an ``(n, 6)`` int64 CUDA tensor of
    counter words ``c0..c3`` and key words ``k0, k1`` in ``[0, 2^32)``.
    Returns the ``(n, 4)`` output words as int64."""
    from ._build import load_library

    if words.device.type != "cuda":
        raise ValueError(f"philox4x32_cuda needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dim() != 2 or words.shape[1] != 6 or words.dtype != torch.int64:
        raise ValueError("words must be an (n, 6) int64 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    lib = load_library()
    n = words.shape[0]
    # two's-complement int32 carries the same 32 bits as uint32
    src = torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32).contiguous()
    out = torch.empty((n, 4), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        rc = lib.glabc_philox4x32(src.data_ptr(), out.data_ptr(), n,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"philox4x32 launch failed: CUDA error {rc}")
    return out.to(torch.int64) & _MASK
