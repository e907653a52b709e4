"""Fused pool-iSIR transitions (AGLMCMC at global_frequency = 1): the CUDA
kernel's wrapper and its plain torch version.

Port of ``glabc_tpu/ops/pallas/pool_isir_kernel.py`` (``PoolISIR``, K3); the
kernel is ``csrc/pool_isir.cu``.  Step ``t`` of a launch runs iSIR over pool
slice ``t``: a Gumbel-argmax over the B candidates' precomputed log-weights
and the carried log-weight of the current state.  The kernel records the
flat slot ``t*B + j`` of the last selected candidate (``sel``, -1 when the
chain did not move in the launch) and a move count; the sampler gathers the
selected dataset and kernel value from the same pool.

Layout (the card's, not the TPU's: chains fastest, nothing padded):
pool theta ``(T, B, d, C)``, pool log-weights ``(T, B, C)``, state theta
``(d, C)``, carried log-weight, ``sel`` and ``moved`` ``(C,)``, history
``(T, d, C)``.  The kernel takes theta_dim up to 128: above 32 a
runtime-d variant (its own count, ``wide_launches``).  Random numbers:
Philox4x32-10, counter ``(chain, step0 + t, block, 0)``, Gumbel slot ``s``
in lane ``s % 4`` of block ``s // 4``: slots ``0..B-1`` for the
candidates, slot ``B`` for the current state.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .philox import gumbel, philox4x32, seed_key, uniform_from_bits

__all__ = ["PoolISIR", "pack_pool_theta", "pack_pool_logw", "draw_gumbels",
           "run_plain", "pool_isir_launch"]

_MAX_D = 128         # csrc/pool_isir.cu: theta_dim up to this
_WIDE_D = 32         # above this the runtime-d variant


def pack_pool_theta(theta: torch.Tensor, T: int, B: int) -> torch.Tensor:
    """``(C, T*B, d)`` pool thetas -> the kernel layout ``(T, B, d, C)``."""
    C, P, d = theta.shape
    if P != T * B:
        raise ValueError(f"pool has {P} rows, not T*B = {T * B}")
    return theta.reshape(C, T, B, d).permute(1, 2, 3, 0).contiguous()


def pack_pool_logw(log_w: torch.Tensor, T: int, B: int) -> torch.Tensor:
    """``(C, T*B)`` pool log-weights -> ``(T, B, C)``."""
    C, P = log_w.shape
    if P != T * B:
        raise ValueError(f"pool has {P} rows, not T*B = {T * B}")
    return log_w.reshape(C, T, B).permute(1, 2, 0).contiguous()


def draw_gumbels(seed: int, num_chains: int, step: int, B: int,
                 device=None, chain0: int = 0) -> torch.Tensor:
    """The kernel's ``(C, B+1)`` Gumbels at absolute step ``step`` for
    global chains ``chain0 .. chain0 + C - 1``."""
    k0, k1 = seed_key(seed)
    nblk = -(-(B + 1) // 4)
    i64 = dict(dtype=torch.int64, device=device)
    chain = torch.arange(chain0, chain0 + num_chains, **i64)
    blocks = torch.arange(nblk, **i64)
    words = philox4x32(chain[:, None], torch.full((1, 1), int(step), **i64),
                       blocks[None, :], torch.zeros((1, 1), **i64), k0, k1)
    u = uniform_from_bits(torch.stack(words, dim=-1).reshape(num_chains,
                                                             4 * nblk))
    return gumbel(u[:, :B + 1])


def run_plain(pool_theta, pool_logw, theta, logw,
              gumbels: Callable[[int], torch.Tensor],
              collect_history: bool = True):
    """The launch's T steps on explicit noise: ``gumbels(t) -> (C, B+1)``.
    Same arguments and results as :meth:`PoolISIR.run`."""
    T, B = pool_logw.shape[:2]
    C = theta.shape[1]
    th, lw_cur = theta.clone(), logw.clone()
    sel = torch.full((C,), -1.0, dtype=torch.float32, device=theta.device)
    moved = torch.zeros(C, dtype=torch.float32, device=theta.device)
    hist = (torch.empty((T, *theta.shape), dtype=torch.float32,
                        device=theta.device) if collect_history else None)
    for t in range(T):
        g = gumbels(t)
        best = lw_cur + g[:, B]
        mv = torch.zeros(C, dtype=torch.bool, device=theta.device)
        for j in range(B):
            lw = pool_logw[t, j]
            score = lw + g[:, j]
            upd = score > best      # strict: ties keep the earlier slot
            best = torch.where(upd, score, best)
            th = torch.where(upd[None, :], pool_theta[t, j], th)
            lw_cur = torch.where(upd, lw, lw_cur)
            sel = torch.where(upd, torch.full_like(sel, float(t * B + j)),
                              sel)
            mv = mv | upd
        moved = moved + mv.to(torch.float32)
        if collect_history:
            hist[t] = th
    return th, lw_cur, sel, moved, hist


def pool_isir_launch(num_chains: int, num_sms: int) -> int:
    """Threads per block of a K3 launch of ``num_chains`` chains on a card of
    ``num_sms`` SMs.  A block owns 32 chains; its warps share the parallel
    phases of its chunks.  The fewest of 8, 16 and 32 warps that give the
    launch 48 warps an SM (three quarters of an SM's 64), else 32.  32,768
    chains on 132 SMs: 1,024 blocks of 256 threads."""
    blocks = -(-num_chains // 32)
    warps = next((w for w in (8, 16) if blocks * w >= 48 * num_sms), 32)
    return 32 * warps


class PoolISIR:
    """Fused iSIR-over-pool transitions, problem-agnostic.

    ``launches`` counts launches of the CUDA kernel at theta_dim up to 32
    and ``wide_launches`` those of its runtime-d variant above
    (class-wide); each rises for nothing else.  ``block_chains`` is the
    number of threads per CUDA block (a multiple of 32 up to 1024; None:
    :func:`pool_isir_launch`'s for the launch's chain count); a block owns
    32 chains whatever its size, and the size does not change the
    results."""

    launches = 0
    wide_launches = 0

    def __init__(self, theta_dim: int, *, batch_size: int = 5,
                 steps_per_call: int = 200, block_chains: int | None = None,
                 collect_history: bool = True):
        self.d = int(theta_dim)
        self.B = int(batch_size)
        if not 1 <= self.B <= 7:
            raise ValueError(f"batch_size must be in [1, 7], got {batch_size}")
        if self.d < 1:
            raise ValueError(f"theta_dim must be >= 1, got {theta_dim}")
        self.T = int(steps_per_call)
        self.C_blk = None if block_chains is None else int(block_chains)
        if self.C_blk is not None and (self.C_blk % 32
                                       or not 32 <= self.C_blk <= 1024):
            raise ValueError("block_chains must be None or a multiple of 32 "
                             f"in [32, 1024], got {block_chains}")
        self.collect_history = bool(collect_history)

    def _check(self, pool_theta, pool_logw, theta, logw) -> int:
        dev = theta.device
        for name, x in (("pool_theta", pool_theta), ("pool_logw", pool_logw),
                        ("theta", theta), ("logw", logw)):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if x.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, theta on {dev}")
        if theta.dim() != 2 or theta.shape[0] != self.d:
            raise ValueError(f"theta must be ({self.d}, C), got "
                             f"{tuple(theta.shape)}")
        C = theta.shape[1]
        shapes = {"pool_theta": (tuple(pool_theta.shape),
                                 (self.T, self.B, self.d, C)),
                  "pool_logw": (tuple(pool_logw.shape), (self.T, self.B, C)),
                  "logw": (tuple(logw.shape), (C,))}
        for name, (got, want) in shapes.items():
            if got != want:
                raise ValueError(f"{name} must be {want}, got {got}")
        return C

    def run(self, seed: int, pool_theta, pool_logw, theta, logw, *,
            step0: int = 0, chain0: int = 0):
        """``steps_per_call`` transitions from absolute step ``step0``;
        column ``c`` draws as global chain ``chain0 + c``.  Returns
        ``(theta, logw, sel, moved, history or None)``."""
        self._check(pool_theta, pool_logw, theta, logw)
        if theta.device.type == "cuda":
            return self._launch(seed, pool_theta, pool_logw, theta, logw,
                                step0, chain0)
        if theta.device.type == "cpu":
            return self.plain(seed, pool_theta, pool_logw, theta, logw,
                              step0=step0, chain0=chain0)
        raise ValueError(f"no kernel for device {theta.device}")

    def plain(self, seed: int, pool_theta, pool_logw, theta, logw, *,
              step0: int = 0, gumbels: Optional[Callable] = None,
              chain0: int = 0):
        """The plain torch version of :meth:`run`, on any device: the same
        random numbers (or ``gumbels(t) -> (C, B+1)``) and results."""
        C = self._check(pool_theta, pool_logw, theta, logw)
        if gumbels is None:
            gumbels = lambda t: draw_gumbels(seed, C, step0 + t, self.B,
                                             theta.device, chain0)
        return run_plain(pool_theta, pool_logw, theta, logw, gumbels,
                         self.collect_history)

    def _threads(self, C: int, dev) -> int:
        """Threads per block of a launch on ``dev``."""
        if self.C_blk is not None:
            return self.C_blk
        return pool_isir_launch(
            C, torch.cuda.get_device_properties(dev).multi_processor_count)

    def _launch(self, seed, pool_theta, pool_logw, theta, logw, step0,
                chain0):
        from ._build import load_library

        if self.d > _MAX_D:
            raise ValueError(f"the CUDA kernel takes theta_dim <= {_MAX_D}, "
                             f"got {self.d}")
        lib = load_library("pool_isir")
        C = theta.shape[1]
        dev = theta.device
        th_o, lw_o = torch.empty_like(theta), torch.empty_like(logw)
        sel, moved = torch.empty_like(logw), torch.empty_like(logw)
        hist = (torch.empty((self.T, self.d, C), dtype=torch.float32,
                            device=dev) if self.collect_history else None)
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_pool_isir(
                ptr(pool_theta), ptr(pool_logw), ptr(theta), ptr(logw),
                ptr(th_o), ptr(lw_o), ptr(sel), ptr(moved), ptr(hist),
                self.d, C, self.T, self.B, int(self.collect_history), k0, k1,
                int(step0), int(chain0), self._threads(C, dev), stream)
        if rc != 0:
            raise RuntimeError(f"pool_isir launch failed: CUDA error {rc}")
        if self.d > _WIDE_D:
            type(self).wide_launches += 1
        else:
            type(self).launches += 1
        return th_o, lw_o, sel, moved, hist
