"""Generic fused GLMALA over a tile program (K9): the CUDA kernel's wrapper
and its plain torch version.

Port of ``glabc_tpu/ops/pallas/generic_glmala_kernel.py``
(``GenericFusedGLMALA``); the kernel is ``csrc/generic_glmala.cu``, built
once per program header (:mod:`.program`).  One step of a chain is

* global (iSIR): ``B`` candidates from ``sample_global``, each simulated
  once, a Gumbel-argmax against the current state; the cached gradient
  stays stale (``GLMALA.py:183-199``);
* local (MALA): ``theta' = (theta + tau z) + grad tau^2 / 2``, the
  synthetic-likelihood gradient at ``theta'``, MH with the reverse drift;
  an accepted move carries its gradient.

The gradient is the JAX generic estimator: for coordinate ``k`` and
replicate ``r`` the program simulates at ``theta' +- fd e_k`` from one
Philox block range (common random numbers by replaying the cursor, where
the TPU kernel re-seeds with ``_GRAD_STRIDE``); the ddof=1 Gaussian
synthetic likelihood of the discrepancies per sign, central differences,
plus the program's ``prior_grad``.  Random numbers per step: scalar slots
as K6 (Gumbels ``0..B``, the accept ``B+1``, the per-chain coin ``B+2``),
candidate ``b`` at block ``S + b G``, the drift ``z`` at ``L = S + B G``
(one pair per dim, cos branch), the proposal's simulation at ``L + ZB``,
replicate ``r`` coordinate ``k`` at ``L + ZB + sb + (r d + k) sb``.

Coins: ``shared`` takes one host coin per step for every chain (a global
step skips the gradient batch); ``per_chain`` draws each chain's.  Layouts
(the card's): theta and grad ``(d, C)``, y ``(y_rows, C)``, logk and the
counters ``(C,)``, history ``(T, d, C)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .generic_kernel import GenericLayout, isir_global, philox_draws
from .philox import seed_key
from .program import TileProgram, div, rowsum

__all__ = ["GenericFusedGLMALA", "ProgMalaConfig", "program_sl_grad",
           "run_plain"]

_LOG_2PI = math.log(2.0 * math.pi)
# columns of one batched gradient simulation in the plain version
_GRAD_COLS = 1 << 20


def _f32(x) -> float:
    return float(np.float32(x))


class ProgMalaConfig:
    """The transition's constants, rounded to float32 once, and the block
    layout of a step."""

    def __init__(self, program: TileProgram, *, epsilon, global_frequency,
                 batch_size, tau, num_grad, fd_step):
        if int(num_grad) < 2:
            raise ValueError(f"num_grad must be >= 2 (ddof=1 variance), got "
                             f"{num_grad}")
        self.p = program
        self.d = int(program.theta_dim)
        self.B = int(batch_size)
        self.n_grad = int(num_grad)
        self.gf = _f32(global_frequency)
        self.tau = _f32(tau)
        self.half_tau2 = _f32(tau * tau / 2.0)
        self.fd = _f32(fd_step)
        self.two_fd = _f32(2.0 * fd_step)
        self.eps2 = _f32(epsilon * epsilon)
        self.c_norm = _f32(-0.5 * _LOG_2PI)
        self.lay = GenericLayout(program, self.B, True)
        self.L = self.lay.local
        self.ZB = -(-self.d // 2)
        self.grad_block = self.L + self.ZB + program.sim_blocks


def _std_normal_lp(z, c):
    return rowsum(c - (0.5 * z) * z)


def _sl_lp(cfg, s1, s2):
    n = float(cfg.n_grad)
    mu = div(s1, n)
    var = div(s2 - (n * mu) * mu, float(cfg.n_grad - 1))
    s = var + cfg.eps2
    return -0.5 * torch.log(s) - ((0.5 * mu) * mu) / s


def program_sl_grad(cfg: ProgMalaConfig, draws, step: int, theta):
    """The kernel's gradient at ``theta (d, C)`` for the cursors ``draws``:
    replicates in order, a batch of them per simulation call (their
    cursors start at different blocks), each replicate's ``+fd`` and
    ``-fd`` simulations on one block range."""
    p, d, C = cfg.p, cfg.d, theta.shape[1]
    sb = p.sim_blocks
    per = max(1, min(cfg.n_grad, _GRAD_COLS // max(C, 1)))
    rows = []
    for k in range(d):
        e = torch.zeros((d, 1), dtype=torch.float32, device=theta.device)
        e[k] = cfg.fd
        sums = None
        for r0 in range(0, cfg.n_grad, per):
            R = min(per, cfg.n_grad - r0)
            firsts = cfg.grad_block + (torch.arange(r0, r0 + R) * d + k) * sb
            dis = []
            for th in (theta + e, theta - e):
                y = p.simulate(th.repeat(1, R), draws(step, firsts))
                dis.append(p.discrepancy(y).reshape(R, C))
            for r in range(R):
                dp, dm = dis[0][r], dis[1][r]
                inc = (dp, dp * dp, dm, dm * dm)
                sums = (list(inc) if sums is None
                        else [a + b for a, b in zip(sums, inc)])
        s1p, s2p, s1m, s2m = sums
        rows.append(div(_sl_lp(cfg, s1p, s2p) - _sl_lp(cfg, s1m, s2m),
                        cfg.two_fd))
    return torch.stack(rows) + p.prior_grad(theta)


def _sel(m, a, b):
    return torch.where(m, a, b)


def run_plain(cfg: ProgMalaConfig, draws, theta, y, logk, grad, *, steps: int,
              step0: int = 0, coins=None, collect_history: bool = True):
    """``steps`` transitions in the kernel's layouts on the cursors
    ``draws(step, first, paired)``; ``coins`` the shared coins ``(steps,)``
    or None (per-chain).  Returns ``(theta, y, logk, grad, history or None,
    [acc, gatt, gacc, lacc])``."""
    p = cfg.p
    counters = [torch.zeros_like(logk) for _ in range(4)]
    hist = (torch.empty((steps, *theta.shape), dtype=torch.float32,
                        device=theta.device) if collect_history else None)
    f = lambda m: m.to(torch.float32)
    for t in range(steps):
        step = step0 + t
        u = draws(step, 0).uniforms(cfg.B + 3)
        if coins is None:
            is_g = u[:, cfg.B + 2] < cfg.gf
        else:
            is_g = torch.full_like(logk, bool(coins[t]), dtype=torch.bool)
        run_g = coins is None or bool(coins[t])
        run_l = coins is None or not bool(coins[t])
        if run_g:
            w_th, w_y, w_lk, w_mv = isir_global(p, cfg.lay, cfg.B, draws,
                                                step, u, theta, y, logk)
            g_state = (w_th, w_y, w_lk, grad, w_mv)
        if run_l:
            z, _ = draws(step, cfg.L).normal_pairs(cfg.d)
            z = z.T
            log_fwd = _std_normal_lp(z, cfg.c_norm)
            th_p = (theta + cfg.tau * z) + grad * cfg.half_tau2
            g_p = program_sl_grad(cfg, draws, step, th_p)
            y_p = p.simulate(th_p, draws(step, cfg.L + cfg.ZB))
            lk_p = p.log_kernel(y_p)
            z_rev = div((theta - th_p) - g_p * cfg.half_tau2, cfg.tau)
            log_rev = _std_normal_lp(z_rev, cfg.c_norm)
            log_acc = ((((p.prior_diff_lp(th_p, theta) + lk_p) + log_rev)
                        - logk) - log_fwd)
            l_mv = torch.log(u[:, cfg.B + 1]) < log_acc
            l_state = (_sel(l_mv, th_p, theta), _sel(l_mv, y_p, y),
                       _sel(l_mv, lk_p, logk), _sel(l_mv, g_p, grad), l_mv)
        if not run_l:
            new = g_state
        elif not run_g:
            new = l_state
        else:
            new = tuple(_sel(is_g, a, b) for a, b in zip(g_state, l_state))
        theta, y, logk, grad, moved = new
        inc = (f(moved), f(is_g), f(is_g & moved), f(~is_g & moved))
        counters = [c + i for c, i in zip(counters, inc)]
        if collect_history:
            hist[t] = theta
    return (theta.contiguous(), y.contiguous(), logk.contiguous(),
            grad.contiguous(), hist, counters)


class GenericFusedGLMALA:
    """Fused GLMALA over a :class:`TileProgram` (its ``discrepancy`` and
    ``prior_grad`` feed the gradient).  ``launches`` counts launches of the
    CUDA kernel (class-wide) and rises for nothing else; ``block_chains``
    (threads per CUDA block) does not change the results."""

    launches = 0

    def __init__(self, program: TileProgram, *, epsilon: float,
                 global_frequency: float = 0.8, batch_size: int = 5,
                 tau: float = 0.3, num_grad: int = 100, fd_step: float = 0.1,
                 steps_per_call: int = 16, block_chains: int = 256,
                 collect_history: bool = True, coin_mode: str = "shared"):
        if not isinstance(program, TileProgram):
            raise TypeError("program must be a glabc_tpu_torch TileProgram, "
                            f"got {type(program).__name__}")
        if coin_mode not in ("shared", "per_chain"):
            raise ValueError(f"coin_mode must be 'shared' or 'per_chain', got "
                             f"{coin_mode!r}")
        if not 1 <= int(batch_size) <= 64:
            raise ValueError(f"batch_size must be in [1, 64], got "
                             f"{batch_size}")
        self.p = program
        self.d, self.y_rows = int(program.theta_dim), int(program.y_rows)
        self.coin_mode = coin_mode
        self.cfg = ProgMalaConfig(
            program, epsilon=epsilon, global_frequency=global_frequency,
            batch_size=batch_size, tau=tau, num_grad=num_grad,
            fd_step=fd_step)
        self.B = self.cfg.B
        self.T = int(steps_per_call)
        self.C_blk = int(block_chains)
        if self.C_blk % 32 or not 32 <= self.C_blk <= 1024:
            raise ValueError("block_chains must be a multiple of 32 in "
                             f"[32, 1024], got {block_chains}")
        self.collect_history = bool(collect_history)
        self._params_on = {}

    def _check(self, theta, y, logk, grad, coins) -> int:
        for name, x in (("theta", theta), ("y", y), ("logk", logk),
                        ("grad", grad)):
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
                              ("grad", grad, (self.d, C)),
                              ("logk", logk, (C,))):
            if tuple(x.shape) != want:
                raise ValueError(f"{name} must be {want}, got "
                                 f"{tuple(x.shape)}")
        if self.coin_mode == "shared":
            if coins is None or tuple(coins.shape) != (self.T,):
                raise ValueError(f"coin_mode='shared' needs coins of shape "
                                 f"({self.T},)")
            if coins.dtype != torch.int32:
                raise TypeError(f"coins must be int32, got {coins.dtype}")
        return C

    def run(self, seed: int, theta, y, logk, grad, coins=None, *,
            step0: int = 0, chain0: int = 0):
        """``steps_per_call`` transitions from absolute step ``step0``;
        column ``c`` draws as global chain ``chain0 + c``.  ``coins``: the
        shared coins ``(T,)`` int32 (1: global), on the host or the state's
        device; ignored with ``per_chain``.  Returns ``(theta, y, logk,
        grad, history or None, [acc, gatt, gacc, lacc])``."""
        self._check(theta, y, logk, grad, coins)
        if theta.device.type == "cuda":
            return self._launch(seed, theta, y, logk, grad, coins, step0,
                                chain0)
        if theta.device.type == "cpu":
            return self.plain(seed, theta, y, logk, grad, coins, step0=step0,
                              chain0=chain0)
        raise ValueError(f"no kernel for device {theta.device}")

    def plain(self, seed: int, theta, y, logk, grad, coins=None, *,
              step0: int = 0, draws=None, chain0: int = 0):
        """The plain torch version of :meth:`run`, on any device: the same
        random numbers (or the cursors ``draws(step, first, paired)``) and
        results."""
        C = self._check(theta, y, logk, grad, coins)
        if draws is None:
            draws = philox_draws(seed, C, theta.device, chain0)
        host_coins = (None if self.coin_mode == "per_chain"
                      else coins.cpu().tolist())
        return run_plain(self.cfg, draws, theta, y, logk, grad,
                         steps=self.T, step0=step0, coins=host_coins,
                         collect_history=self.collect_history)

    def _launch(self, seed, theta, y, logk, grad, coins, step0, chain0):
        from ._build import load_library

        lib = load_library("generic_glmala", self.p)
        cfg, p, dev, C = self.cfg, self.p, theta.device, theta.shape[1]
        params = self._params_on.get(dev)
        if params is None:   # a copy from the host waits for the stream: once
            params = self._params_on[dev] = p.params_on(dev)
        th_o, y_o, lk_o, gr_o = (torch.empty_like(x)
                                 for x in (theta, y, logk, grad))
        counters = [torch.empty_like(logk) for _ in range(4)]
        hist = (torch.empty((self.T, self.d, C), dtype=torch.float32,
                            device=dev) if self.collect_history else None)
        shared = self.coin_mode == "shared"
        if shared:
            coins = coins.to(dev, non_blocking=True)
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_generic_glmala(
                *(ptr(x) for x in (theta, y, logk, grad, params,
                                   coins if shared else None, th_o, y_o,
                                   lk_o, gr_o, hist, *counters)),
                self.d, self.y_rows, C, self.T, self.B, cfg.n_grad,
                int(self.collect_history), int(shared), p.global_blocks,
                p.sim_blocks, int(p.sim_paired), cfg.gf, cfg.tau,
                cfg.half_tau2, cfg.fd, cfg.two_fd, cfg.eps2, cfg.c_norm,
                k0, k1, int(step0), int(chain0), self.C_blk, stream)
        if rc != 0:
            raise RuntimeError(f"generic_glmala launch failed: CUDA error "
                               f"{rc}")
        type(self).launches += 1
        return th_o, y_o, lk_o, gr_o, hist, counters
