"""Fused Mixture-family GLMCMC / GlobalMCMC transitions: the CUDA kernel's
wrapper and its plain torch version.

Port of ``glabc_tpu/ops/pallas/mixture_kernel.py`` (``FusedMixtureGLMCMC``,
K2; its PRNG helpers, K0, are ``philox.py`` / ``csrc/philox.cuh``).  The
kernel is ``csrc/mixture_glmcmc.cu``; it serves this unpacked ``(d_pad, C)``
layout and the packed layout of ``packed_kernel.py`` alike.

The plain version is factored as :func:`draw_noise` (torch Philox on the
kernel's counter layout) plus :func:`transition` (one step for every chain
on explicit noise).  It evaluates the global and the local branch for
every chain and then selects by the coin, where the kernel reads the coin
first and computes only the move it picks; the numbers are the same, and
every float operation is written in the kernel's order.  A wrapper takes the plain version only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .philox import gumbel, normal_pair, philox4x32, seed_key, uniform_from_bits

__all__ = ["FusedMixtureGLMCMC", "FusedStats", "fused_state_init",
           "MixtureConfig", "Noise", "draw_noise", "noise_from_uniforms",
           "transition", "run_plain"]

_LOG_2PI = math.log(2.0 * math.pi)
_SUB = 8


def _f32(x) -> float:
    return float(np.float32(x))


class FusedStats(NamedTuple):
    """Per-chain move counters accumulated inside one launch, float32 in the
    layout's logk shape: accepted moves, global attempts / accepts, local
    accepts (local attempts = steps - global attempts)."""

    accepted: torch.Tensor
    global_attempts: torch.Tensor
    global_accepts: torch.Tensor
    local_accepts: torch.Tensor


class MixtureConfig(NamedTuple):
    """The transition's constants, rounded to float32 once, as the kernel
    receives them."""

    d: int
    B: int
    glmcmc: bool
    prior_loc: float
    inv_prior_scale: float
    c_prior: float
    ip_loc: float
    ip_scale: float
    inv_ip_scale: float
    c_ip: float
    lp_scale: float
    sigma: float
    c_kern: float
    a_kern: float
    gf: float
    y_obs: tuple

    @classmethod
    def create(cls, d, y_obs, *, epsilon, sigma, global_frequency,
               batch_size, prior_loc, prior_scale, ip_loc, ip_scale,
               lp_scale, algorithm) -> "MixtureConfig":
        if algorithm not in ("glmcmc", "global"):
            raise ValueError(f"algorithm must be 'glmcmc' or 'global', "
                             f"got {algorithm!r}")
        y = np.broadcast_to(np.asarray(y_obs, np.float32).reshape(-1), (d,))
        return cls(
            d=int(d), B=int(batch_size), glmcmc=algorithm == "glmcmc",
            prior_loc=_f32(prior_loc), inv_prior_scale=_f32(1.0 / prior_scale),
            c_prior=_f32(-0.5 * _LOG_2PI - math.log(prior_scale)),
            ip_loc=_f32(ip_loc), ip_scale=_f32(ip_scale),
            inv_ip_scale=_f32(1.0 / ip_scale),
            c_ip=_f32(-0.5 * _LOG_2PI - math.log(ip_scale)),
            lp_scale=_f32(lp_scale), sigma=_f32(sigma),
            c_kern=_f32(-0.5 * _LOG_2PI - math.log(epsilon)),
            a_kern=_f32(0.5 / (epsilon * epsilon)),
            gf=_f32(global_frequency),
            y_obs=tuple(float(v) for v in y),
        )

    @property
    def n_proposals(self) -> int:
        return self.B if self.glmcmc else 1

    @property
    def n_scalars(self) -> int:
        """glmcmc: Gumbel 0..B, u_local, u_coin; global: u_local, u_coin,
        u_global."""
        return self.B + 3 if self.glmcmc else 3

    @property
    def scalar_blocks(self) -> int:
        return -(-self.n_scalars // 4)

    @property
    def pair_blocks(self) -> int:
        return -(-self.d // 2)

    @property
    def blocks_per_step(self) -> int:
        return self.scalar_blocks + (self.n_proposals + 1) * self.pair_blocks


class Noise(NamedTuple):
    """One step's random numbers for N chains."""

    gumbel: Optional[torch.Tensor]    # (N, B+1), glmcmc only
    u_local: torch.Tensor             # (N,)
    u_coin: torch.Tensor              # (N,)
    u_global: Optional[torch.Tensor]  # (N,), global only
    n1: torch.Tensor                  # (N, Bp, d) proposal normals
    n2: torch.Tensor                  # (N, Bp, d) simulator normals
    l1: torch.Tensor                  # (N, d) local step normals
    l2: torch.Tensor                  # (N, d) local simulator normals


def noise_from_uniforms(scalars: torch.Tensor, pairs: torch.Tensor,
                        cfg: MixtureConfig) -> Noise:
    """``scalars (N, n_scalars)`` uniforms in the kernel's slot order and
    ``pairs (N, Bp+1, d, 2)`` Box-Muller uniform pairs (the last proposal
    slot is the local move) -> :class:`Noise`."""
    n1, n2 = normal_pair(pairs[..., 0], pairs[..., 1])
    Bp = cfg.n_proposals
    if cfg.glmcmc:
        g = gumbel(scalars[:, :cfg.B + 1])
        u_local, u_coin, u_global = scalars[:, cfg.B + 1], scalars[:, cfg.B + 2], None
    else:
        g = None
        u_local, u_coin, u_global = scalars[:, 0], scalars[:, 1], scalars[:, 2]
    return Noise(g, u_local, u_coin, u_global, n1[:, :Bp], n2[:, :Bp],
                 n1[:, Bp], n2[:, Bp])


def draw_noise(seed: int, chain_idx: torch.Tensor, step: int,
               cfg: MixtureConfig) -> Noise:
    """The kernel's random numbers for chains ``chain_idx`` at absolute step
    ``step``: counter ``(chain, step, block, 0)``, key from ``seed``."""
    k0, k1 = seed_key(seed)
    dev = chain_idx.device
    N = chain_idx.shape[0]
    nblk = cfg.blocks_per_step
    blocks = torch.arange(nblk, dtype=torch.int64, device=dev)
    step_t = torch.full((1, 1), int(step), dtype=torch.int64, device=dev)
    zero = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    words = philox4x32(chain_idx.to(torch.int64)[:, None], step_t,
                       blocks[None, :], zero, k0, k1)
    u = uniform_from_bits(torch.stack(words, dim=-1).reshape(N, 4 * nblk))
    S, P, d = cfg.scalar_blocks, cfg.pair_blocks, cfg.d
    scalars = u[:, :cfg.n_scalars]
    pairs = (u[:, 4 * S:].reshape(N, cfg.n_proposals + 1, 4 * P)[:, :, :2 * d]
             .reshape(N, cfg.n_proposals + 1, d, 2))
    return noise_from_uniforms(scalars, pairs, cfg)


def _sum_dims(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right, as the kernel's loop does."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def _gauss_lp(th, loc, inv_scale, c):
    z = (th - loc) * inv_scale
    return _sum_dims(c - 0.5 * (z * z))


def _kern_lp(yv, y_obs, cfg):
    diff = yv - y_obs
    return cfg.c_kern - _sum_dims(diff * diff) * cfg.a_kern


def transition(state, noise: Noise, cfg: MixtureConfig):
    """One fused transition for every chain.

    ``state = (theta (N, d), y (N, d), logk (N,))``.  Returns the new state
    and the per-chain counter increments ``(accepted, global_attempt,
    global_accept, local_accept)`` as float32 ``(N,)``."""
    theta, y, logk = state
    y_obs = torch.tensor(cfg.y_obs, dtype=torch.float32, device=theta.device)
    prior = lambda th: _gauss_lp(th, cfg.prior_loc, cfg.inv_prior_scale,
                                 cfg.c_prior)
    ip = lambda th: _gauss_lp(th, cfg.ip_loc, cfg.inv_ip_scale, cfg.c_ip)
    lp_theta = prior(theta)

    if cfg.glmcmc:
        # iSIR as a streaming Gumbel-argmax; strict > keeps the earlier on ties
        best = ((lp_theta + logk) - ip(theta)) + noise.gumbel[:, 0]
        w_th, w_y, w_lk = theta, y, logk
        w_moved = torch.zeros_like(logk, dtype=torch.bool)
        for b in range(cfg.B):
            thp = cfg.ip_loc + cfg.ip_scale * noise.n1[:, b]
            yp = thp.abs() + cfg.sigma * noise.n2[:, b]
            lkp = _kern_lp(yp, y_obs, cfg)
            score = ((prior(thp) + lkp) - ip(thp)) + noise.gumbel[:, b + 1]
            upd = score > best
            best = torch.where(upd, score, best)
            w_th = torch.where(upd[:, None], thp, w_th)
            w_y = torch.where(upd[:, None], yp, w_y)
            w_lk = torch.where(upd, lkp, w_lk)
            w_moved = w_moved | upd
    else:
        # independence MH
        thp = cfg.ip_loc + cfg.ip_scale * noise.n1[:, 0]
        yp = thp.abs() + cfg.sigma * noise.n2[:, 0]
        lkp = _kern_lp(yp, y_obs, cfg)
        la = ((((prior(thp) + lkp) + ip(theta)) - ip(thp)) - lp_theta) - logk
        w_moved = torch.log(noise.u_global) < la
        w_th = torch.where(w_moved[:, None], thp, theta)
        w_y = torch.where(w_moved[:, None], yp, y)
        w_lk = torch.where(w_moved, lkp, logk)

    # local random-walk MH
    thl = theta + cfg.lp_scale * noise.l1
    yl = thl.abs() + cfg.sigma * noise.l2
    lkl = _kern_lp(yl, y_obs, cfg)
    la_l = ((prior(thl) + lkl) - lp_theta) - logk
    l_acc = torch.log(noise.u_local) < la_l
    l_th = torch.where(l_acc[:, None], thl, theta)
    l_y = torch.where(l_acc[:, None], yl, y)
    l_lk = torch.where(l_acc, lkl, logk)

    is_g = noise.u_coin < cfg.gf
    theta = torch.where(is_g[:, None], w_th, l_th)
    y = torch.where(is_g[:, None], w_y, l_y)
    logk = torch.where(is_g, w_lk, l_lk)
    f = lambda m: m.to(torch.float32)
    inc = (f(torch.where(is_g, w_moved, l_acc)), f(is_g), f(is_g & w_moved),
           f(~is_g & l_acc))
    return (theta, y, logk), inc


def run_plain(cfg: MixtureConfig, seed: int, theta, y, logk, *, steps: int,
              step0: int = 0, collect_history: bool = True, chain0: int = 0):
    """``steps`` transitions of every chain in the per-chain layout
    ``theta/y (N, d)``, ``logk (N,)``; row ``n`` is global chain ``chain0 +
    n``.  Returns ``(theta, y, logk, history (steps, N, d) or None, [acc,
    gatt, gacc, lacc])``."""
    N = theta.shape[0]
    chain_idx = torch.arange(chain0, chain0 + N, dtype=torch.int64,
                             device=theta.device)
    counters = [torch.zeros(N, dtype=torch.float32, device=theta.device)
                for _ in range(4)]
    hist = (torch.empty((steps, N, cfg.d), dtype=torch.float32,
                        device=theta.device) if collect_history else None)
    state = (theta, y, logk)
    for t in range(steps):
        noise = draw_noise(seed, chain_idx, step0 + t, cfg)
        state, inc = transition(state, noise, cfg)
        counters = [c + i for c, i in zip(counters, inc)]
        if collect_history:
            hist[t] = state[0]
    return (*state, hist, counters)


class _MixtureKernelBase:
    """Shared wrapper of ``csrc/mixture_glmcmc.cu`` for one state layout.

    A chain owns ``rows_per_group`` state rows and ``aux_rows`` logk/counter
    rows of column ``n % ncols`` in group ``n // ncols``.  Subclasses set
    the layout and keep their own class-level ``launches`` count, which
    rises by one for every launch of the CUDA kernel and for nothing else.
    """

    launches = 0
    _stats_type = FusedStats

    def __init__(self, theta_dim: int, y_obs, *, epsilon: float,
                 sigma: float, global_frequency: float = 0.9,
                 batch_size: int = 5, prior_loc=0.0, prior_scale=1.0,
                 ip_loc=0.0, ip_scale=1.0, lp_scale=0.35,
                 steps_per_call: int = 256, block_chains: int = 512,
                 collect_history: bool = True, algorithm: str = "glmcmc"):
        self.d = int(theta_dim)
        if self.d < 1:
            raise ValueError(f"theta_dim must be >= 1, got {theta_dim}")
        self.algorithm = algorithm
        self.cfg = MixtureConfig.create(
            self.d, y_obs, epsilon=epsilon, sigma=sigma,
            global_frequency=global_frequency, batch_size=batch_size,
            prior_loc=prior_loc, prior_scale=prior_scale, ip_loc=ip_loc,
            ip_scale=ip_scale, lp_scale=lp_scale, algorithm=algorithm)
        self.y_obs = np.asarray(self.cfg.y_obs, np.float32)
        self.B = self.cfg.B
        self.T = int(steps_per_call)
        # threads per CUDA block; any value gives the same chains
        self.C_blk = int(block_chains)
        if self.C_blk % 32 or not 32 <= self.C_blk <= 1024:
            raise ValueError("block_chains must be a multiple of 32 in "
                             f"[32, 1024], got {block_chains}")
        self.collect_history = bool(collect_history)
        self._y_obs_on = {}   # device -> y_obs tensor the kernel reads

    # ----------------------------------------------------------- layout
    groups_rows: tuple  # (rows_per_group, aux_rows), set by subclasses

    def _groups(self, rows: int) -> int:
        rpg = self.groups_rows[0]
        if rows % rpg:
            raise ValueError(f"state has {rows} rows, not a multiple of "
                             f"{rpg}")
        return rows // rpg

    def _check(self, theta, y, logk):
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
        if theta.dim() != 2 or y.shape != theta.shape:
            raise ValueError(f"theta/y must be equal 2-D shapes, got "
                             f"{tuple(theta.shape)} / {tuple(y.shape)}")
        groups = self._groups(theta.shape[0])
        want = (groups * self.groups_rows[1], theta.shape[1])
        if tuple(logk.shape) != want:
            raise ValueError(f"logk must be {want}, got {tuple(logk.shape)}")
        return groups

    def to_chains(self, x: torch.Tensor, groups: int, aux: bool = False):
        """Layout -> per-chain ``(N, d)`` (state) or ``(N,)`` (aux rows)."""
        rpg, ar = self.groups_rows
        ncols = x.shape[-1]
        if aux:
            return x.reshape(groups, ar, ncols)[:, 0].reshape(-1)
        return (x.reshape(groups, rpg, ncols)[:, :self.d]
                .permute(0, 2, 1).reshape(groups * ncols, self.d))

    def from_chains(self, x: torch.Tensor, groups: int, kind: str = "state"):
        """Per-chain -> layout.  ``kind``: 'state' (padding rows 0), 'logk'
        (every aux row), 'counter' (leader aux row, 0 elsewhere)."""
        rpg, ar = self.groups_rows
        ncols = x.shape[0] // groups
        if kind == "state":
            out = x.new_zeros((groups, rpg, ncols))
            out[:, :self.d] = x.reshape(groups, ncols, self.d).permute(0, 2, 1)
            return out.reshape(groups * rpg, ncols)
        v = x.reshape(groups, 1, ncols)
        if kind == "logk":
            return v.expand(groups, ar, ncols).reshape(groups * ar, ncols)
        out = x.new_zeros((groups, ar, ncols))
        out[:, :1] = v
        return out.reshape(groups * ar, ncols)

    # ------------------------------------------------------------- run
    def run(self, seed: int, theta, y, logk, *, step0: int = 0,
            chain0: int = 0):
        """Run ``steps_per_call`` transitions starting at absolute step
        ``step0``; the layout's chain ``n`` draws as global chain ``chain0 +
        n`` (a shard's offset).  Returns ``(theta, y, logk, history or
        None, stats)`` in the input layout; history is ``(T, rows,
        cols)``."""
        groups = self._check(theta, y, logk)
        if theta.device.type == "cuda":
            return self._launch(seed, theta, y, logk, groups, step0, chain0)
        if theta.device.type == "cpu":
            return self.plain(seed, theta, y, logk, step0=step0,
                              chain0=chain0)
        raise ValueError(f"no kernel for device {theta.device}")

    def plain(self, seed: int, theta, y, logk, *, step0: int = 0,
              chain0: int = 0):
        """The plain torch version of :meth:`run`, on any device: the same
        arguments, random numbers and results.  :meth:`run` takes it for
        CPU tensors; on the card it is what the kernel is held against."""
        groups = self._check(theta, y, logk)
        th, yy, lk, hist, counters = run_plain(
            self.cfg, seed, self.to_chains(theta, groups),
            self.to_chains(y, groups), self.to_chains(logk, groups, aux=True),
            steps=self.T, step0=step0,
            collect_history=self.collect_history, chain0=chain0)
        if hist is not None:
            hist = torch.stack([self.from_chains(h, groups) for h in hist])
        stats = self._stats_type(*(self.from_chains(c, groups, "counter")
                                   for c in counters))
        return (self.from_chains(th, groups), self.from_chains(yy, groups),
                self.from_chains(lk, groups, "logk"), hist, stats)

    def _launch(self, seed, theta, y, logk, groups, step0, chain0):
        from ._build import load_library

        lib = load_library()
        cfg = self.cfg
        rpg, ar = self.groups_rows
        ncols = theta.shape[1]
        dev = theta.device
        n = groups * ncols
        th_o, y_o = torch.empty_like(theta), torch.empty_like(y)
        lk_o = torch.empty_like(logk)
        hist = torch.empty((self.T if self.collect_history else 1,
                            *theta.shape), dtype=torch.float32, device=dev)
        counters = [torch.empty_like(logk) for _ in range(4)]
        y_obs = self._y_obs_on.get(dev)
        if y_obs is None:   # a copy from the host waits for the stream: once
            y_obs = self._y_obs_on[dev] = torch.tensor(
                cfg.y_obs, dtype=torch.float32, device=dev)
        # d without a register build keeps four d-vectors per chain in memory
        scratch = (None if lib.glabc_mixture_register_dims(self.d) else
                   torch.empty(4 * self.d * n, dtype=torch.float32,
                               device=dev))
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_mixture_glmcmc(
                ptr(theta), ptr(y), ptr(logk), ptr(y_obs), ptr(th_o),
                ptr(y_o), ptr(lk_o), ptr(hist), *(ptr(c) for c in counters),
                ptr(scratch), self.d, groups, rpg, ar, ncols, self.T,
                int(self.collect_history), int(cfg.glmcmc), cfg.B,
                cfg.prior_loc, cfg.inv_prior_scale, cfg.c_prior,
                cfg.ip_loc, cfg.ip_scale, cfg.inv_ip_scale, cfg.c_ip,
                cfg.lp_scale, cfg.sigma, cfg.c_kern, cfg.a_kern, cfg.gf,
                k0, k1, int(step0), int(chain0), self.C_blk, stream)
        if rc != 0:
            raise RuntimeError(f"mixture_glmcmc launch failed: CUDA error "
                               f"{rc}")
        type(self).launches += 1
        return (th_o, y_o, lk_o, hist if self.collect_history else None,
                self._stats_type(*counters))


class FusedMixtureGLMCMC(_MixtureKernelBase):
    """Fused GLMCMC for the (generalized) Mixture problem, unpacked layout:
    state ``(d_pad, C)`` with ``d_pad = max(8, ceil(d/8)*8)``, logk and
    counters ``(1, C)``.  Any ``d >= 1``.  ``algorithm``: 'glmcmc' (iSIR
    global move) or 'global' (independence MH; ``batch_size`` ignored)."""

    launches = 0

    def __init__(self, theta_dim: int, y_obs, **kwargs):
        super().__init__(theta_dim, y_obs, **kwargs)
        self.d_pad = max(_SUB, -(-self.d // _SUB) * _SUB)
        self.groups_rows = (self.d_pad, 1)


def fused_state_init(problem, generator: torch.Generator, theta0,
                     num_chains: int, d_pad: int = _SUB, y0=None,
                     device=None):
    """``(d_pad, C)`` padded initial state for the unpacked kernel.

    ``y0``: ``(d,)``/``(1, d)`` broadcasts to every chain, ``(C, d)`` gives
    each its own; ``None`` simulates each chain's from ``theta0`` (see
    :func:`~glabc_tpu_torch.models.problems.initial_chains`)."""
    from ...models.problems import initial_chains

    th_all, y_all, logk = initial_chains(problem, generator, theta0,
                                         num_chains, y0, device)
    d = problem.theta_dim
    theta = torch.zeros((d_pad, num_chains), dtype=torch.float32,
                        device=th_all.device)
    y = torch.zeros_like(theta)
    theta[:d] = th_all.T
    y[:d] = y_all.T
    return theta, y, logk[None, :].contiguous()
