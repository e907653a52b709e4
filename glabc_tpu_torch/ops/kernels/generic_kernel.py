"""Generic fused GLMCMC / GlobalMCMC over a tile program (K8): the CUDA
kernel's wrapper and its plain torch version.

Port of ``glabc_tpu/ops/pallas/generic_kernel.py`` (``GenericFusedGLMCMC``);
the kernel is ``csrc/generic_glmcmc.cu``, built once per program header
(:mod:`.program`).  One step of a chain: the coin; then either the global
move (``'glmcmc'``: iSIR as a streaming Gumbel-argmax over the current state
and ``B`` candidates from ``sample_global``; ``'global'``: independence MH
with one) or the random-walk local move (``sample_local``, MH with
``prior_diff_lp``).  Each candidate is simulated once.

The kernel computes only the move the coin picks; this plain version
computes both for every chain and selects, with the same random numbers:
every use draws from its own Philox block range, so neither shifts the
other.  Layouts (the card's): theta ``(d, C)``, y ``(y_rows, C)``, logk and
the counters ``(C,)``, history ``(T, d, C)``.

Random numbers per step, counter ``(chain, step, block, 0)`` (``chain`` the
global index, ``chain0`` plus the column): scalar slot
``s`` is lane ``s % 4`` of block ``s // 4`` (glmcmc: Gumbels ``0..B``, the
local accept ``B+1``, the coin ``B+2``; global: the local accept 0, the
coin 1, the global accept 2); candidate ``b`` draws from block ``S + b G``
(its simulation at ``+0`` when the program's simulator is paired, else
``+global_blocks``), the local move from ``S + Bp G``.
"""

from __future__ import annotations

import numpy as np
import torch

from .mixture_kernel import FusedStats
from .philox import Draws, gumbel, seed_key
from .program import TileProgram

__all__ = ["GenericFusedGLMCMC", "GenericLayout", "run_plain",
           "philox_draws", "global_candidate", "isir_global"]


def philox_draws(seed: int, num_chains: int, device, chain0: int = 0):
    """``draws(step, first, paired=False)``: the kernels' Philox cursors for
    global chains ``chain0 .. chain0 + num_chains - 1`` from block
    ``first``.  A tensor ``first (R,)`` gives R cursors per chain at once,
    over ``R * num_chains`` columns, replicate-major."""
    chains = torch.arange(chain0, chain0 + num_chains, dtype=torch.int64,
                          device=device)

    def draws(step, first, paired=False):
        if isinstance(first, torch.Tensor):
            R = first.shape[0]
            return Draws(seed, chains.repeat(R), step,
                         first.to(device).repeat_interleave(num_chains),
                         paired)
        return Draws(seed, chains, step, first, paired)
    return draws


class GenericLayout:
    """The block layout of one step (see the module docstring)."""

    def __init__(self, program: TileProgram, B: int, glmcmc: bool):
        p = program
        self.n_scalar = B + 3 if glmcmc else 3
        self.S = -(-self.n_scalar // 4)
        self.g_sim = p.sim_offset(p.global_blocks)
        self.g_slot = p.slot_blocks(p.global_blocks)
        self.l_sim = p.sim_offset(p.local_blocks)
        self.local = self.S + (B if glmcmc else 1) * self.g_slot
        self.s_local = B + 1 if glmcmc else 0
        self.s_coin = B + 2 if glmcmc else 1

    def candidate(self, b: int) -> int:
        return self.S + b * self.g_slot


def _sel(m, a, b):
    return torch.where(m, a, b)


def global_candidate(p: TileProgram, lay: GenericLayout, draws, step: int,
                     b: int):
    """Candidate ``b`` of a step: theta from ``sample_global``, its dataset
    and its log epsilon-kernel value (``csrc/generic_moves.cuh``'s
    ``global_candidate``)."""
    first = lay.candidate(b)
    thp = p.sample_global(draws(step, first))
    yp = p.simulate(thp, draws(step, first + lay.g_sim, p.sim_paired))
    return thp, yp, p.log_kernel(yp)


def isir_global(p: TileProgram, lay: GenericLayout, B: int, draws, step: int,
                u, theta, y, logk):
    """The global move K8 and K9 share (``csrc/generic_moves.cuh``'s
    ``isir_global``): iSIR as a streaming Gumbel-argmax over the current
    state (Gumbel of ``u[:, 0]``) and ``B`` candidates (``u[:, b + 1]``);
    strict > keeps the earlier.  Returns the winner's ``(theta, y, logk)``
    and whether a candidate won."""
    best = (p.prior_minus_global_lp(theta) + logk) + gumbel(u[:, 0])
    moved = torch.zeros_like(logk, dtype=torch.bool)
    for b in range(B):
        thp, yp, lkp = global_candidate(p, lay, draws, step, b)
        score = (p.prior_minus_global_lp(thp) + lkp) + gumbel(u[:, b + 1])
        upd = score > best
        best = _sel(upd, score, best)
        theta, y = _sel(upd, thp, theta), _sel(upd, yp, y)
        logk, moved = _sel(upd, lkp, logk), moved | upd
    return theta, y, logk, moved


def run_plain(program: TileProgram, B: int, glmcmc: bool, gf: float, draws,
              theta, y, logk, *, steps: int, step0: int = 0,
              collect_history: bool = True):
    """``steps`` transitions of every chain, in the kernel's layouts, on
    the cursors ``draws(step, first, paired)``.  Returns ``(theta, y, logk,
    history (steps, d, C) or None, [acc, gatt, gacc, lacc])``."""
    p = program
    lay = GenericLayout(p, B, glmcmc)
    counters = [torch.zeros_like(logk) for _ in range(4)]
    hist = (torch.empty((steps, *theta.shape), dtype=torch.float32,
                        device=theta.device) if collect_history else None)
    f = lambda m: m.to(torch.float32)
    for t in range(steps):
        step = step0 + t
        u = draws(step, 0).uniforms(lay.n_scalar)
        is_g = u[:, lay.s_coin] < gf

        if glmcmc:
            w_th, w_y, w_lk, w_mv = isir_global(p, lay, B, draws, step, u,
                                                theta, y, logk)
        else:
            thp, yp, lkp = global_candidate(p, lay, draws, step, 0)
            la = (((p.prior_minus_global_lp(thp) + lkp)
                   - p.prior_minus_global_lp(theta)) - logk)
            w_mv = torch.log(u[:, 2]) < la
            w_th, w_y = _sel(w_mv, thp, theta), _sel(w_mv, yp, y)
            w_lk = _sel(w_mv, lkp, logk)
        thl = p.sample_local(theta, draws(step, lay.local))
        yl = p.simulate(thl, draws(step, lay.local + lay.l_sim,
                                   p.sim_paired))
        lkl = p.log_kernel(yl)
        l_mv = (torch.log(u[:, lay.s_local])
                < (p.prior_diff_lp(thl, theta) + lkl) - logk)
        l_th, l_y = _sel(l_mv, thl, theta), _sel(l_mv, yl, y)
        l_lk = _sel(l_mv, lkl, logk)
        theta, y = _sel(is_g, w_th, l_th), _sel(is_g, w_y, l_y)
        logk = _sel(is_g, w_lk, l_lk)
        moved = _sel(is_g, w_mv, l_mv)
        inc = (f(moved), f(is_g), f(is_g & moved), f(~is_g & moved))
        counters = [c + i for c, i in zip(counters, inc)]
        if collect_history:
            hist[t] = theta
    return (theta.contiguous(), y.contiguous(), logk.contiguous(), hist,
            counters)


class GenericFusedGLMCMC:
    """Fused GLMCMC (``algorithm='glmcmc'``) or GlobalMCMC (``'global'``)
    over a :class:`TileProgram`.  ``launches`` counts launches of the CUDA
    kernel (class-wide) and rises for nothing else; ``block_chains``
    (threads per CUDA block) does not change the results."""

    launches = 0

    def __init__(self, program: TileProgram, *, global_frequency: float = 0.9,
                 batch_size: int = 5, steps_per_call: int = 256,
                 block_chains: int = 256, collect_history: bool = True,
                 algorithm: str = "glmcmc"):
        if not isinstance(program, TileProgram):
            raise TypeError("program must be a glabc_tpu_torch TileProgram, "
                            f"got {type(program).__name__}")
        if algorithm not in ("glmcmc", "global"):
            raise ValueError(f"algorithm must be 'glmcmc' or 'global', got "
                             f"{algorithm!r}")
        if not 1 <= int(batch_size) <= 64:
            raise ValueError(f"batch_size must be in [1, 64], got "
                             f"{batch_size}")
        self.p = program
        self.d, self.y_rows = int(program.theta_dim), int(program.y_rows)
        self.algorithm = algorithm
        self.glmcmc = algorithm == "glmcmc"
        self.gf = float(np.float32(global_frequency))
        self.B = int(batch_size)
        self.T = int(steps_per_call)
        self.C_blk = int(block_chains)
        if self.C_blk % 32 or not 32 <= self.C_blk <= 1024:
            raise ValueError("block_chains must be a multiple of 32 in "
                             f"[32, 1024], got {block_chains}")
        self.collect_history = bool(collect_history)
        self._params_on = {}

    def _check(self, theta, y, logk) -> int:
        for name, x in (("theta", theta), ("y", y), ("logk", logk)):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if x.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.device != theta.device:
                raise ValueError(f"{name} is on {x.device}, theta on "
                                 f"{theta.device}")
        if theta.dim() != 2 or theta.shape[0] != self.d:
            raise ValueError(f"theta must be ({self.d}, C), got "
                             f"{tuple(theta.shape)}")
        C = theta.shape[1]
        for name, x, want in (("y", y, (self.y_rows, C)),
                              ("logk", logk, (C,))):
            if tuple(x.shape) != want:
                raise ValueError(f"{name} must be {want}, got "
                                 f"{tuple(x.shape)}")
        return C

    def run(self, seed: int, theta, y, logk, *, step0: int = 0,
            chain0: int = 0):
        """``steps_per_call`` transitions from absolute step ``step0``;
        column ``c`` draws as global chain ``chain0 + c``.  Returns
        ``(theta, y, logk, history or None, FusedStats)``."""
        self._check(theta, y, logk)
        if theta.device.type == "cuda":
            return self._launch(seed, theta, y, logk, step0, chain0)
        if theta.device.type == "cpu":
            return self.plain(seed, theta, y, logk, step0=step0,
                              chain0=chain0)
        raise ValueError(f"no kernel for device {theta.device}")

    def plain(self, seed: int, theta, y, logk, *, step0: int = 0,
              draws=None, chain0: int = 0):
        """The plain torch version of :meth:`run`, on any device: the same
        random numbers (or the cursors ``draws(step, first, paired)``) and
        results."""
        C = self._check(theta, y, logk)
        if draws is None:
            draws = philox_draws(seed, C, theta.device, chain0)
        th, yy, lk, hist, counters = run_plain(
            self.p, self.B, self.glmcmc, self.gf, draws, theta, y, logk,
            steps=self.T, step0=step0, collect_history=self.collect_history)
        return th, yy, lk, hist, FusedStats(*counters)

    def _launch(self, seed, theta, y, logk, step0, chain0):
        from ._build import load_library

        lib = load_library("generic_glmcmc", self.p)
        dev, C, p = theta.device, theta.shape[1], self.p
        params = self._params_on.get(dev)
        if params is None:   # a copy from the host waits for the stream: once
            params = self._params_on[dev] = p.params_on(dev)
        th_o, y_o, lk_o = (torch.empty_like(x) for x in (theta, y, logk))
        counters = [torch.empty_like(logk) for _ in range(4)]
        hist = (torch.empty((self.T, self.d, C), dtype=torch.float32,
                            device=dev) if self.collect_history else None)
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_generic_glmcmc(
                *(ptr(x) for x in (theta, y, logk, params, th_o, y_o, lk_o,
                                   hist, *counters)),
                self.d, self.y_rows, C, self.T, int(self.collect_history),
                int(self.glmcmc), self.B, p.global_blocks, p.sim_blocks,
                p.local_blocks, int(p.sim_paired), self.gf, k0, k1,
                int(step0), int(chain0), self.C_blk, stream)
        if rc != 0:
            raise RuntimeError(f"generic_glmcmc launch failed: CUDA error "
                               f"{rc}")
        type(self).launches += 1
        return th_o, y_o, lk_o, hist, FusedStats(*counters)
