"""Fused pool-iSIR + Mixture random-walk transitions (AGLMCMC at
global_frequency < 1, shared adaptation): the CUDA kernel's wrapper and its
plain torch version.

Port of ``glabc_tpu/ops/pallas/pool_isir_mixed_kernel.py``
(``PoolISIRMixed``, K5, and ``ResidentProposal``, ``resident_from_gaussian``,
``resident_from_kde``); the kernel is ``csrc/pool_isir_mixed.cu``.  Each
step a per-chain coin picks

* global: iSIR over pool slice ``t``.  The current state may have arrived
  by a local move, so its log-weight is recomputed: its density under the
  resident shared mixture (the epoch's shared KDE, or the initial Gaussian
  proposal before the first epoch), a logsumexp over its S components
  (the kernel carries it, with the prior, while the chain does not move);
* local: the Mixture-family random-walk MH move (``y = |theta| + sigma z``,
  Gaussian epsilon-kernel), the arithmetic of ``mixture_kernel.transition``;
  or, with ``program=``, a tile program's move (``sample_local``,
  ``simulate``, ``log_kernel``, ``prior_diff_lp``; the carried-state weight
  uses its ``prior_lp``), the kernel built for the program's header.

Pool cadence is slice-per-step: slice ``t`` belongs to step ``t`` and is
skipped when that step's coin is local.  Layouts are the card's: pool theta
``(T, B, d, C)`` and datasets ``(T, B, y_rows, C)``, pool log-weights and
kernel values ``(T, B, C)``, state theta ``(d, C)`` and y ``(y_rows, C)``
(``y_rows = d`` for the built-in move), ``logk`` and counters ``(C,)``,
history ``(T, d, C)``.  A program's local move draws ``sample_local`` from
block ``S_b = ceil((B + 3) / 4)`` on and its simulation from ``S_b +
(paired ? 0 : local_blocks)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .mixture_kernel import MixtureConfig, _gauss_lp, _kern_lp, _sum_dims
from .philox import gumbel, normal_pair, philox4x32, seed_key, uniform_from_bits
from .program import TileProgram

__all__ = ["PoolISIRMixed", "ResidentProposal", "default_launch",
           "resident_from_gaussian", "resident_from_kde", "resident_log_q",
           "MixedNoise", "draw_mixed_noise", "mixed_transition",
           "program_transition", "run_plain"]

_LOG_2PI = math.log(2.0 * math.pi)
_NEG = -1.0e30
_LANES = 32          # the warp the kernel sums a resident density over
_MAX_D = 128         # csrc/pool_isir_mixed.cu: theta_dim up to this
_WIDE_D = 32         # above this the built-in move's runtime-d variant


class ResidentProposal(NamedTuple):
    """A Gaussian mixture kept resident in the kernel's shared memory:
    ``log q(theta) = logsumexp_i(pre_i + mu_scaled_i . theta)
    - 0.5 sum_k theta_k^2 inv2h_k`` with ``mu_scaled = mu / h^2`` and
    ``pre_i = log_w_i - 0.5 sum_k mu_ik^2 / h_k^2 - sum_k log h_k
    - (d/2) log 2 pi``."""

    mu_scaled: torch.Tensor  # (S, d)
    pre: torch.Tensor        # (S,)
    inv2h: torch.Tensor      # (d,)


def _build_resident(mu, h, log_w) -> ResidentProposal:
    mu = torch.as_tensor(mu, dtype=torch.float32)                 # (n, d)
    h = torch.as_tensor(h, dtype=torch.float32, device=mu.device)  # (d,)
    d = mu.shape[1]
    const = -torch.sum(torch.log(h)) - 0.5 * d * _LOG_2PI
    inv_h2 = 1.0 / (h * h)
    pre = log_w + const - 0.5 * torch.sum(mu * mu * inv_h2, dim=-1)
    return ResidentProposal((mu * inv_h2).contiguous(), pre.contiguous(),
                            inv_h2.contiguous())


def resident_from_gaussian(loc, scale, device=None) -> ResidentProposal:
    """A diagonal Gaussian (the first epoch's proposal) as a one-component
    mixture of weight 1, without the KDE's ``+1e-10`` stabilizer: the exact
    parametric density."""
    loc = torch.as_tensor(np.asarray(loc, np.float32).reshape(1, -1),
                          device=device)
    d = loc.shape[1]
    scale = torch.as_tensor(np.broadcast_to(np.asarray(scale, np.float32),
                                            (d,)).copy(), device=device)
    return _build_resident(loc, scale, torch.zeros(1, device=loc.device))


def resident_from_kde(kde) -> ResidentProposal:
    """An unbatched (shared) fitted KDE as the resident mixture, with the
    ``log(w + 1e-10)`` stabilizer of ``KernelDensity.log_prob``."""
    return _build_resident(kde.X, kde.bandwidth,
                           torch.log(kde.weights + 1e-10))


def resident_log_q(res: ResidentProposal, theta: torch.Tensor) -> torch.Tensor:
    """``log q`` of ``theta (C, d)`` as the kernel's warp computes it: the
    affine terms left to right; component ``i`` belongs to lane ``i % 32``;
    the max over components (floored at -1e30); each lane's float32 sum of
    ``exp(sc - m)`` over its components in rising order; then the lanes'
    sums combined by an xor butterfly, ``p = p + p[lane ^ off]`` for off =
    16, 8, 4, 2, 1 (every lane ends with the same value).  S is padded to a
    multiple of 32 with terms that add exactly 0.0.  Bitwise equal to the
    kernel on the card."""
    d = theta.shape[1]
    dot = None
    for f in range(d):
        p = res.mu_scaled[None, :, f] * theta[:, f:f + 1]
        dot = p if dot is None else dot + p
    sc = dot + res.pre[None, :]                                    # (C, S)
    m = torch.clamp_min(torch.amax(sc, dim=-1), _NEG)
    e = torch.exp(sc - m[:, None])
    C, S = e.shape
    pad = -S % _LANES
    if pad:
        e = torch.cat([e, e.new_zeros((C, pad))], dim=1)
    e = e.reshape(C, -1, _LANES)                     # (C, S / 32, lane)
    s = e[:, 0]
    for k in range(1, e.shape[1]):
        s = s + e[:, k]
    idx = torch.arange(_LANES, device=s.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ off]
    q2 = _sum_dims((theta * theta) * res.inv2h)
    return (torch.log(s[:, 0]) + m) - 0.5 * q2


class MixedNoise(NamedTuple):
    """One step's random numbers for C chains."""

    gumbel: torch.Tensor    # (C, B+1): candidates 0..B-1, the current B
    u_local: torch.Tensor   # (C,)
    u_coin: torch.Tensor    # (C,)
    l1: torch.Tensor        # (C, d) local step normals
    l2: torch.Tensor        # (C, d) local simulator normals


def mixed_noise_from_uniforms(scalars, pairs, B: int) -> MixedNoise:
    """``scalars (C, B+3)`` in slot order and ``pairs (C, d, 2)`` Box-Muller
    uniforms -> :class:`MixedNoise`."""
    n1, n2 = normal_pair(pairs[..., 0], pairs[..., 1])
    return MixedNoise(gumbel(scalars[:, :B + 1]), scalars[:, B + 1],
                      scalars[:, B + 2], n1, n2)


def draw_mixed_noise(seed: int, num_chains: int, step: int, B: int, d: int,
                     device=None, chain0: int = 0) -> MixedNoise:
    """The kernel's random numbers at absolute step ``step`` for global
    chains ``chain0 .. chain0 + C - 1``: scalar blocks ``[0, S_b)``, then
    dim ``j``'s pair in block ``S_b + j // 2``."""
    k0, k1 = seed_key(seed)
    sb = -(-(B + 3) // 4)
    nblk = sb + -(-d // 2)
    i64 = dict(dtype=torch.int64, device=device)
    chain = torch.arange(chain0, chain0 + num_chains, **i64)
    blocks = torch.arange(nblk, **i64)
    words = philox4x32(chain[:, None], torch.full((1, 1), int(step), **i64),
                       blocks[None, :], torch.zeros((1, 1), **i64), k0, k1)
    u = uniform_from_bits(torch.stack(words, dim=-1).reshape(num_chains,
                                                             4 * nblk))
    pairs = u[:, 4 * sb:4 * sb + 2 * d].reshape(num_chains, d, 2)
    return mixed_noise_from_uniforms(u[:, :B + 3], pairs, B)


def mixed_transition(state, pool_slice, res: ResidentProposal,
                     noise: MixedNoise, cfg: MixtureConfig):
    """One step for every chain.  ``state = (theta (C, d), y (C, d),
    logk (C,))``; ``pool_slice = (theta (B, d, C), x (B, d, C),
    logw (B, C), logk (B, C))``.  Returns the new state and the counter
    increments ``(global_attempt, global_accept, local_accept)``."""
    theta, y, logk = state
    ptheta, px, plogw, plogk = pool_slice
    B = plogw.shape[0]
    y_obs = torch.tensor(cfg.y_obs, dtype=torch.float32, device=theta.device)
    prior = lambda th: _gauss_lp(th, cfg.prior_loc, cfg.inv_prior_scale,
                                 cfg.c_prior)
    # ---- 1. current state's log-weight under the resident proposal
    lp_theta = prior(theta)
    logw_cur = (lp_theta + logk) - resident_log_q(res, theta)
    # ---- 2. global: iSIR over the slice, strict > keeps ties
    best = logw_cur + noise.gumbel[:, B]
    b_th, b_y, b_lk = theta, y, logk
    moved = torch.zeros_like(logk, dtype=torch.bool)
    for j in range(B):
        score = plogw[j] + noise.gumbel[:, j]
        upd = score > best
        best = torch.where(upd, score, best)
        b_th = torch.where(upd[:, None], ptheta[j].T, b_th)
        b_y = torch.where(upd[:, None], px[j].T, b_y)
        b_lk = torch.where(upd, plogk[j], b_lk)
        moved = moved | upd
    # ---- 3. local random-walk MH
    thl = theta + cfg.lp_scale * noise.l1
    yl = thl.abs() + cfg.sigma * noise.l2
    lkl = _kern_lp(yl, y_obs, cfg)
    l_acc = torch.log(noise.u_local) < ((prior(thl) + lkl) - lp_theta) - logk
    # ---- 4. coin
    is_g = noise.u_coin < cfg.gf
    new_theta = torch.where(is_g[:, None], b_th,
                            torch.where(l_acc[:, None], thl, theta))
    new_y = torch.where(is_g[:, None], b_y,
                        torch.where(l_acc[:, None], yl, y))
    new_lk = torch.where(is_g, b_lk, torch.where(l_acc, lkl, logk))
    f = lambda m: m.to(torch.float32)
    return (new_theta, new_y, new_lk), (f(is_g), f(is_g & moved),
                                        f(~is_g & l_acc))


def program_transition(state, pool_slice, res: ResidentProposal,
                       program: TileProgram, gf: float, u, draws):
    """:func:`mixed_transition` with a tile program's local move.
    ``state = (theta (d, C), y (y_rows, C), logk (C,))`` in the kernel's
    layout; ``u (C, B + 3)`` the scalar slots; ``draws(first, paired)``
    the local move's cursors for this step."""
    p = program
    theta, y, logk = state
    ptheta, px, plogw, plogk = pool_slice
    B = plogw.shape[0]
    # ---- 1. current state's log-weight under the resident proposal
    logw_cur = (p.prior_lp(theta) + logk) - resident_log_q(res, theta.T)
    # ---- 2. global: iSIR over the slice, strict > keeps ties
    best = logw_cur + gumbel(u[:, B])
    b_th, b_y, b_lk = theta, y, logk
    moved = torch.zeros_like(logk, dtype=torch.bool)
    for j in range(B):
        score = plogw[j] + gumbel(u[:, j])
        upd = score > best
        best = torch.where(upd, score, best)
        b_th = torch.where(upd, ptheta[j], b_th)
        b_y = torch.where(upd, px[j], b_y)
        b_lk = torch.where(upd, plogk[j], b_lk)
        moved = moved | upd
    # ---- 3. the program's local move
    first = -(-(B + 3) // 4)
    thl = p.sample_local(theta, draws(first, False))
    yl = p.simulate(thl, draws(first + p.sim_offset(p.local_blocks),
                               p.sim_paired))
    lkl = p.log_kernel(yl)
    l_acc = torch.log(u[:, B + 1]) < (p.prior_diff_lp(thl, theta) + lkl) - logk
    # ---- 4. coin
    is_g = u[:, B + 2] < gf
    new = (torch.where(is_g, b_th, torch.where(l_acc, thl, theta)),
           torch.where(is_g, b_y, torch.where(l_acc, yl, y)),
           torch.where(is_g, b_lk, torch.where(l_acc, lkl, logk)))
    f = lambda m: m.to(torch.float32)
    return new, (f(is_g), f(is_g & moved), f(~is_g & l_acc))


def run_plain(res: ResidentProposal, ptheta, px, plogw, plogk, theta, y,
              logk, cfg: MixtureConfig, noise: Callable[[int], MixedNoise],
              collect_history: bool = True, program=None):
    """The launch's T steps on explicit noise, in the kernel's layouts; the
    results of :meth:`PoolISIRMixed.run` bit for bit.  Every step
    recomputes the current state's resident density, where the kernel
    carries it while the chain stays: the value is the same.  ``noise(t)``:
    a :class:`MixedNoise`, or with a ``program`` ``(u (C, B + 3),
    draws(first, paired))``."""
    T = plogw.shape[0]
    transposed = program is None
    state = (theta.T, y.T, logk) if transposed else (theta, y, logk)
    counters = [torch.zeros_like(logk) for _ in range(3)]
    hist = (torch.empty((T, *theta.shape), dtype=torch.float32,
                        device=theta.device) if collect_history else None)
    for t in range(T):
        sl = (ptheta[t], px[t], plogw[t], plogk[t])
        if program is None:
            state, inc = mixed_transition(state, sl, res, noise(t), cfg)
        else:
            state, inc = program_transition(state, sl, res, program, cfg.gf,
                                            *noise(t))
        counters = [c + i for c, i in zip(counters, inc)]
        if collect_history:
            hist[t] = state[0].T if transposed else state[0]
    th, yy = ((state[0].T, state[1].T) if transposed else state[:2])
    return (th.contiguous(), yy.contiguous(), state[2], *counters, hist)


def default_launch(num_chains: int, num_sms: int):
    """``(threads per block, chains per warp)`` for ``num_chains`` chains on
    a card of ``num_sms`` SMs.  A warp takes 32 chains, or 16 when 32 would
    leave one of the SMs' 4 schedulers without a warp (the lanes past 16
    are inert but share the resident densities); the block is the largest
    of 256, 128 and 64 threads that still makes a block for every SM, else
    32.  16,384 chains on 132 SMs: 1,024 warps of 16 in 256 blocks of 128
    threads."""
    lanes = 32 if -(-num_chains // 32) >= 4 * num_sms else 16
    warps = -(-num_chains // lanes)
    for threads in (256, 128, 64):
        if -(-warps * 32 // threads) >= num_sms:
            return threads, lanes
    return 32, lanes


class PoolISIRMixed:
    """Fused pool-iSIR + local-RW kernel (``global_frequency < 1``), with
    the built-in Mixture local move or a :class:`TileProgram`'s
    (``program=``; then ``y_obs``, ``epsilon``, ``sigma``, ``lp_scale`` and
    ``prior_*`` are the program's and are ignored here).  ``launches``
    counts launches of the built-in kernel at theta_dim up to 32,
    ``wide_launches`` those of its runtime-d variant above (up to 128) and
    ``program_launches`` those of a program's (class-wide), each rising for
    nothing else;
    ``block_chains`` (threads per CUDA block, a multiple of 32 up to 1024;
    None: :func:`default_launch`'s for the launch's chain count) does not
    change the results."""

    launches = 0
    wide_launches = 0
    program_launches = 0

    def __init__(self, theta_dim: int, y_obs=None, *, epsilon: float = 0.05,
                 sigma: float = 0.05, global_frequency: float = 0.5,
                 batch_size: int = 5, steps_per_call: int = 400,
                 lp_scale: float = 0.35, prior_loc: float = 0.0,
                 prior_scale: float = 1.0, block_chains: int | None = None,
                 collect_history: bool = True, program=None):
        self.d = int(theta_dim)
        if self.d < 1:
            raise ValueError(f"theta_dim must be >= 1, got {theta_dim}")
        self.program = program
        if program is not None:
            if not isinstance(program, TileProgram):
                raise TypeError("program must be a glabc_tpu_torch "
                                f"TileProgram, got {type(program).__name__}")
            if program.theta_dim != self.d:
                raise ValueError(f"program.theta_dim {program.theta_dim} != "
                                 f"theta_dim {self.d}")
            y_obs = np.zeros(self.d, np.float32)   # the program's own
        elif y_obs is None:
            raise ValueError("y_obs is needed for the built-in local move")
        self.y_rows = self.d if program is None else int(program.y_rows)
        self.B = int(batch_size)
        if not 1 <= self.B <= 7:
            raise ValueError(f"batch_size must be in [1, 7], got {batch_size}")
        self.T = int(steps_per_call)
        self.C_blk = None if block_chains is None else int(block_chains)
        if self.C_blk is not None and (self.C_blk % 32
                                       or not 32 <= self.C_blk <= 1024):
            raise ValueError("block_chains must be None or a multiple of 32 "
                             f"in [32, 1024], got {block_chains}")
        self.collect_history = bool(collect_history)
        self.cfg = MixtureConfig.create(
            self.d, y_obs, epsilon=epsilon, sigma=sigma,
            global_frequency=global_frequency, batch_size=self.B,
            prior_loc=prior_loc, prior_scale=prior_scale, ip_loc=0.0,
            ip_scale=1.0, lp_scale=lp_scale, algorithm="glmcmc")
        self._y_obs_on = {}   # device -> y_obs / parameters the kernel reads

    def _check(self, res, ptheta, px, plogw, plogk, theta, y, logk) -> int:
        dev = theta.device
        named = (("mu_scaled", res.mu_scaled), ("pre", res.pre),
                 ("inv2h", res.inv2h), ("pool_theta", ptheta),
                 ("pool_x", px), ("pool_logw", plogw), ("pool_logk", plogk),
                 ("theta", theta), ("y", y), ("logk", logk))
        for name, x in named:
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if x.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, theta on {dev}")
        d, T, B = self.d, self.T, self.B
        if theta.dim() != 2 or theta.shape[0] != d:
            raise ValueError(f"theta must be ({d}, C), got "
                             f"{tuple(theta.shape)}")
        C = theta.shape[1]
        S = res.pre.shape[0]
        want = {"mu_scaled": (S, d), "inv2h": (d,),
                "pool_theta": (T, B, d, C), "pool_x": (T, B, self.y_rows, C),
                "pool_logw": (T, B, C), "pool_logk": (T, B, C),
                "y": (self.y_rows, C), "logk": (C,)}
        for name, x in named:
            if name in want and tuple(x.shape) != want[name]:
                raise ValueError(f"{name} must be {want[name]}, got "
                                 f"{tuple(x.shape)}")
        return C

    def run(self, seed: int, res: ResidentProposal, ptheta, px, plogw, plogk,
            theta, y, logk, *, step0: int = 0, chain0: int = 0):
        """``steps_per_call`` transitions from absolute step ``step0``;
        column ``c`` draws as global chain ``chain0 + c``.  Returns
        ``(theta, y, logk, gatt, gacc, lacc, history or None)``."""
        args = (res, ptheta, px, plogw, plogk, theta, y, logk)
        self._check(*args)
        if theta.device.type == "cuda":
            return self._launch(seed, *args, step0, chain0)
        if theta.device.type == "cpu":
            return self.plain(seed, *args, step0=step0, chain0=chain0)
        raise ValueError(f"no kernel for device {theta.device}")

    def plain(self, seed: int, res: ResidentProposal, ptheta, px, plogw,
              plogk, theta, y, logk, *, step0: int = 0, noise=None,
              draws=None, chain0: int = 0):
        """The plain torch version of :meth:`run`, on any device: the same
        random numbers and results (:func:`run_plain`).  Built-in move:
        ``noise(t) -> MixedNoise`` may replace them; program move: the
        cursors ``draws(step, first, paired)``."""
        C = self._check(res, ptheta, px, plogw, plogk, theta, y, logk)
        if self.program is not None:
            if draws is None:
                from .generic_kernel import philox_draws
                draws = philox_draws(seed, C, theta.device, chain0)
            B = self.B

            def noise(t):
                step = step0 + t
                return (draws(step, 0).uniforms(B + 3),
                        lambda first, paired: draws(step, first, paired))
        elif noise is None:
            noise = lambda t: draw_mixed_noise(seed, C, step0 + t, self.B,
                                               self.d, theta.device, chain0)
        return run_plain(res, ptheta, px, plogw, plogk, theta, y, logk,
                         self.cfg, noise, self.collect_history, self.program)

    def _geometry(self, C: int, dev):
        """``(threads per block, chains per warp)`` of a launch on ``dev``."""
        threads, lanes = default_launch(
            C, torch.cuda.get_device_properties(dev).multi_processor_count)
        return (threads if self.C_blk is None else self.C_blk), lanes

    def _launch(self, seed, res, ptheta, px, plogw, plogk, theta, y, logk,
                step0, chain0):
        from ._build import load_library

        if self.d > _MAX_D:
            raise ValueError(f"the CUDA kernel takes theta_dim <= {_MAX_D}, "
                             f"got {self.d}")
        if self.program is not None:
            return self._launch_program(seed, res, ptheta, px, plogw, plogk,
                                        theta, y, logk, step0, chain0)
        lib = load_library("pool_isir_mixed")
        cfg, dev = self.cfg, theta.device
        C, S = theta.shape[1], res.pre.shape[0]
        th_o, y_o = torch.empty_like(theta), torch.empty_like(y)
        outs = [torch.empty_like(logk) for _ in range(4)]   # logk + counters
        hist = (torch.empty((self.T, self.d, C), dtype=torch.float32,
                            device=dev) if self.collect_history else None)
        y_obs = self._y_obs_on.get(dev)
        if y_obs is None:   # a copy from the host waits for the stream: once
            y_obs = self._y_obs_on[dev] = torch.tensor(
                cfg.y_obs, dtype=torch.float32, device=dev)
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_pool_isir_mixed(
                *(ptr(x) for x in (res.mu_scaled, res.pre, res.inv2h, y_obs,
                                   ptheta, px, plogw, plogk, theta, y, logk,
                                   th_o, y_o, *outs, hist)),
                self.d, C, self.T, self.B, S, int(self.collect_history),
                cfg.prior_loc, cfg.inv_prior_scale, cfg.c_prior,
                cfg.lp_scale, cfg.sigma, cfg.c_kern, cfg.a_kern, cfg.gf,
                k0, k1, int(step0), int(chain0), *self._geometry(C, dev),
                stream)
        if rc != 0:
            raise RuntimeError(f"pool_isir_mixed launch failed: CUDA error "
                               f"{rc}")
        if self.d > _WIDE_D:
            type(self).wide_launches += 1
        else:
            type(self).launches += 1
        return (th_o, y_o, *outs, hist)

    def _launch_program(self, seed, res, ptheta, px, plogw, plogk, theta, y,
                        logk, step0, chain0):
        from ._build import load_library

        p, dev = self.program, theta.device
        lib = load_library("pool_isir_mixed", p)
        C, S = theta.shape[1], res.pre.shape[0]
        th_o, y_o = torch.empty_like(theta), torch.empty_like(y)
        outs = [torch.empty_like(logk) for _ in range(4)]   # logk + counters
        hist = (torch.empty((self.T, self.d, C), dtype=torch.float32,
                            device=dev) if self.collect_history else None)
        params = self._y_obs_on.get(dev)
        if params is None:   # a copy from the host waits for the stream: once
            params = self._y_obs_on[dev] = p.params_on(dev)
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_pool_isir_mixed_program(
                *(ptr(x) for x in (res.mu_scaled, res.pre, res.inv2h, params,
                                   ptheta, px, plogw, plogk, theta, y, logk,
                                   th_o, y_o, *outs, hist)),
                self.d, self.y_rows, C, self.T, self.B, S,
                int(self.collect_history), p.local_blocks,
                int(p.sim_paired), self.cfg.gf, k0, k1, int(step0),
                int(chain0), *self._geometry(C, dev), stream)
        if rc != 0:
            raise RuntimeError(f"pool_isir_mixed (program) launch failed: "
                               f"CUDA error {rc}")
        type(self).program_launches += 1
        return (th_o, y_o, *outs, hist)
