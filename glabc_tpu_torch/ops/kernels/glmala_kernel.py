"""Fused Mixture-family GLMALA transitions (K6): the CUDA kernel's wrapper
and its plain torch version.

Port of ``glabc_tpu/ops/pallas/glmala_kernel.py`` (``PackedMixtureGLMALA``
and ``packed_grad_init``); the kernel is ``csrc/glmala.cu``.  One step of a
chain is

* global (iSIR): B candidates from ``N(ip_loc, ip_scale^2 I)``, each
  simulated once, a Gumbel-argmax over their log-weights and the current
  state's; the cached gradient stays as it was (the reference's lazy cache,
  ``GLMALA.py:183-199``);
* local (MALA): ``theta' = theta + tau z + grad tau^2 / 2``, the synthetic
  likelihood gradient at ``theta'`` by CRN central differences, MH with the
  reverse drift; an accepted move carries its gradient.

The gradient follows the TPU kernel's design: one simulator-noise vector
``z_r`` per replicate serves both signs and all ``d`` perturbed
coordinates; running sums of the discrepancy and of its square per sign and
coordinate give ``mu`` and the ddof=1 variance, ``log p = -log(var + eps^2)
/ 2 - mu^2 / (2 (var + eps^2))``, plus the closed-form prior gradient
``-(theta - loc) / scale^2``.

Coins: ``shared`` takes one host coin per step for every chain (a global
step skips the gradient batch); ``per_chain`` draws each chain's coin.
Layout (the card's): state ``(d, C)``, ``logk`` and counters ``(C,)``,
history ``(T, d, C)``, for ``d`` in {1, 2, 4, 8} as in the JAX kernel.

Random numbers per step, counter ``(chain, step, block, 0)``, ``chain`` the
global index (``chain0`` plus the column):

* blocks ``[0, S)``, ``S = ceil((B + 3) / 4)``: scalar slot ``s`` is lane
  ``s % 4`` of block ``s // 4``: Gumbels ``0`` (current state) and
  ``1..B`` (candidates), ``B + 1`` the local accept uniform, ``B + 2`` the
  per-chain coin;
* candidate ``b``, dim ``j``: block ``S + b P + j // 2`` with ``P =
  ceil(d / 2)``, lanes ``(2 (j % 2), 2 (j % 2) + 1)`` one Box-Muller pair:
  (proposal normal, simulator normal);
* the local move's ``(z, z_sim)`` for dim ``j``: block ``S + B P + j // 2``;
* gradient replicates ``2i`` and ``2i + 1``, dim ``j``: block ``S + (B + 1)
  P + i P + j // 2``, one Box-Muller pair (cos branch for ``2i``).

A step draws only the blocks of the move it takes, so computing one branch
shifts no other draw.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .mixture_kernel import MixtureConfig, _gauss_lp, _kern_lp, _sum_dims
from .philox import gumbel, normal_pair, philox4x32, seed_key, uniform_from_bits

__all__ = ["FusedMixtureGLMALA", "MalaConfig", "MalaNoise", "draw_mala_noise",
           "mala_noise_from_uniforms", "kernel_sl_sums", "sl_grad_from_sums",
           "kernel_sl_grad", "mala_transition", "run_plain", "glmala_launch"]

_LOG_2PI = math.log(2.0 * math.pi)


def _f32(x) -> float:
    return float(np.float32(x))


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` rounded once, as the kernel divides.  (On the card torch
    divides by a host scalar through its reciprocal, which can differ in
    the last bit; a divisor on the tensor's device is divided by.)"""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


class MalaConfig(NamedTuple):
    """The transition's constants, rounded to float32 once, as the kernel
    receives them."""

    mix: MixtureConfig
    n_grad: int
    tau: float
    half_tau2: float
    fd: float
    two_fd: float
    eps2: float
    ps2: float
    c_norm: float

    @classmethod
    def create(cls, d, y_obs, *, epsilon, sigma, global_frequency,
               batch_size, tau, num_grad, fd_step, prior_loc, prior_scale,
               ip_loc, ip_scale) -> "MalaConfig":
        if int(num_grad) < 2:
            raise ValueError(f"num_grad must be >= 2 (ddof=1 variance), got "
                             f"{num_grad}")
        mix = MixtureConfig.create(
            d, y_obs, epsilon=epsilon, sigma=sigma,
            global_frequency=global_frequency, batch_size=batch_size,
            prior_loc=prior_loc, prior_scale=prior_scale, ip_loc=ip_loc,
            ip_scale=ip_scale, lp_scale=1.0, algorithm="glmcmc")
        return cls(mix=mix, n_grad=int(num_grad), tau=_f32(tau),
                   half_tau2=_f32(tau * tau / 2.0), fd=_f32(fd_step),
                   two_fd=_f32(2.0 * fd_step), eps2=_f32(epsilon * epsilon),
                   ps2=_f32(prior_scale ** 2), c_norm=_f32(-0.5 * _LOG_2PI))

    @property
    def gf(self) -> float:
        return self.mix.gf

    @property
    def scalar_blocks(self) -> int:
        return -(-(self.mix.B + 3) // 4)

    @property
    def pair_blocks(self) -> int:
        return -(-self.mix.d // 2)

    @property
    def grad_pairs(self) -> int:
        return -(-self.n_grad // 2)

    @property
    def blocks_per_step(self) -> int:
        return (self.scalar_blocks + (self.mix.B + 1) * self.pair_blocks
                + self.grad_pairs * self.pair_blocks)


class MalaNoise(NamedTuple):
    """One step's random numbers for C chains."""

    gumbel: torch.Tensor    # (C, B+1): 0 the current state, 1..B candidates
    u_accept: torch.Tensor  # (C,)
    u_coin: torch.Tensor    # (C,)
    n1: torch.Tensor        # (C, B, d) proposal normals
    n2: torch.Tensor        # (C, B, d) simulator normals
    z: torch.Tensor         # (C, d) local drift noise
    z_sim: torch.Tensor     # (C, d) local simulator noise
    zg: torch.Tensor        # (C, n_grad, d) gradient replicates' normals


def mala_noise_from_uniforms(scalars, pairs, grad_pairs, cfg: MalaConfig):
    """``scalars (C, B+3)`` in slot order, ``pairs (C, B+1, d, 2)``
    Box-Muller uniforms (the last set is the local move's) and
    ``grad_pairs (C, ceil(n_grad/2), d, 2)`` -> :class:`MalaNoise`."""
    B, n = cfg.mix.B, cfg.n_grad
    n1, n2 = normal_pair(pairs[..., 0], pairs[..., 1])
    g1, g2 = normal_pair(grad_pairs[..., 0], grad_pairs[..., 1])
    C, npairs, d = g1.shape
    zg = torch.stack([g1, g2], dim=2).reshape(C, 2 * npairs, d)[:, :n]
    return MalaNoise(gumbel(scalars[:, :B + 1]), scalars[:, B + 1],
                     scalars[:, B + 2], n1[:, :B], n2[:, :B], n1[:, B],
                     n2[:, B], zg)


def draw_mala_noise(seed: int, num_chains: int, step: int, cfg: MalaConfig,
                    device=None, chain0: int = 0) -> MalaNoise:
    """The kernel's random numbers at absolute step ``step`` for global
    chains ``chain0 .. chain0 + C - 1``."""
    k0, k1 = seed_key(seed)
    i64 = dict(dtype=torch.int64, device=device)
    nblk = cfg.blocks_per_step
    words = philox4x32(torch.arange(chain0, chain0 + num_chains,
                                    **i64)[:, None],
                       torch.full((1, 1), int(step), **i64),
                       torch.arange(nblk, **i64)[None, :],
                       torch.zeros((1, 1), **i64), k0, k1)
    u = uniform_from_bits(torch.stack(words, dim=-1).reshape(num_chains,
                                                             4 * nblk))
    S, P, d, B = cfg.scalar_blocks, cfg.pair_blocks, cfg.mix.d, cfg.mix.B
    C = num_chains

    def pair_sets(first_block, n_sets):
        v = u[:, 4 * first_block:4 * (first_block + n_sets * P)]
        return v.reshape(C, n_sets, 4 * P)[:, :, :2 * d].reshape(
            C, n_sets, d, 2)

    return mala_noise_from_uniforms(u[:, :B + 3], pair_sets(S, B + 1),
                                    pair_sets(S + (B + 1) * P,
                                              cfg.grad_pairs), cfg)


def kernel_sl_sums(theta: torch.Tensor, zg: torch.Tensor, cfg: MalaConfig):
    """The running sums of the kernel's gradient at ``theta (C, d)`` from
    the standard normals ``zg (C, n_grad, d)``: replicate ``r``'s simulator
    noise ``sigma zg[:, r]`` serves both signs and every coordinate; per
    sign and coordinate the discrepancies and their squares are summed
    over the replicates in order, as the kernel adds them.  Returns
    ``(s1p, s2p, s1m, s2m)``, each ``(C, d)``."""
    m = cfg.mix
    C, d = theta.shape
    y_obs = torch.tensor(m.y_obs, dtype=torch.float32, device=theta.device)
    step = cfg.fd * torch.eye(d, dtype=torch.float32, device=theta.device)
    th_p = theta[:, None, :] + step        # (C, k, j): coordinate k moved
    th_m = theta[:, None, :] - step
    a_p, a_m = th_p.abs(), th_m.abs()
    s1p = s2p = s1m = s2m = torch.zeros((C, d), dtype=torch.float32,
                                        device=theta.device)
    for r in range(cfg.n_grad):
        zr = (m.sigma * zg[:, r])[:, None, :]
        diff = (a_p + zr) - y_obs
        dis = torch.sqrt(_sum_dims(diff * diff))
        s1p, s2p = s1p + dis, s2p + dis * dis
        diff = (a_m + zr) - y_obs
        dis = torch.sqrt(_sum_dims(diff * diff))
        s1m, s2m = s1m + dis, s2m + dis * dis
    return s1p, s2p, s1m, s2m


def sl_grad_from_sums(theta: torch.Tensor, s1p, s2p, s1m, s2m,
                      cfg: MalaConfig) -> torch.Tensor:
    """The gradient at ``theta (C, d)`` from the running sums of
    :func:`kernel_sl_sums`: the synthetic likelihood of each sign and
    coordinate, their central difference and the prior's gradient."""
    m = cfg.mix

    def sl_lp(s1, s2):
        mu = _div(s1, float(cfg.n_grad))
        var = _div(s2 - (float(cfg.n_grad) * mu) * mu, float(cfg.n_grad - 1))
        s = var + cfg.eps2
        return -0.5 * torch.log(s) - ((0.5 * mu) * mu) / s

    return (_div(sl_lp(s1p, s2p) - sl_lp(s1m, s2m), cfg.two_fd)
            + _div(-(theta - m.prior_loc), cfg.ps2))


def kernel_sl_grad(theta: torch.Tensor, zg: torch.Tensor,
                   cfg: MalaConfig) -> torch.Tensor:
    """The kernel's gradient estimate at ``theta (C, d)`` from the standard
    normals ``zg (C, n_grad, d)``."""
    return sl_grad_from_sums(theta, *kernel_sl_sums(theta, zg, cfg), cfg)


def _std_normal_lp(z, cfg):
    return _sum_dims(cfg.c_norm - 0.5 * (z * z))


def mala_transition(state, noise: MalaNoise, cfg: MalaConfig,
                    coin: Optional[bool] = None):
    """One step for every chain.  ``state = (theta (C, d), y (C, d),
    logk (C,), grad (C, d))``; ``coin`` is the shared coin (True: global)
    or None for per-chain coins.  Returns the new state and the counter
    increments ``(accepted, global_attempt, global_accept, local_accept)``
    as float32 ``(C,)``."""
    m = cfg.mix
    theta, y, logk, grad = state
    y_obs = torch.tensor(m.y_obs, dtype=torch.float32, device=theta.device)
    prior = lambda th: _gauss_lp(th, m.prior_loc, m.inv_prior_scale,
                                 m.c_prior)
    ip = lambda th: _gauss_lp(th, m.ip_loc, m.inv_ip_scale, m.c_ip)
    lp_theta = prior(theta)
    if coin is None:
        is_g = noise.u_coin < m.gf
    else:
        is_g = torch.full_like(logk, bool(coin), dtype=torch.bool)
    g_state = l_state = None
    if coin is None or coin:
        # iSIR as a streaming Gumbel-argmax; strict > keeps the earlier slot
        best = ((lp_theta + logk) - ip(theta)) + noise.gumbel[:, 0]
        w_th, w_y, w_lk = theta, y, logk
        g_moved = torch.zeros_like(logk, dtype=torch.bool)
        for b in range(m.B):
            thp = m.ip_loc + m.ip_scale * noise.n1[:, b]
            yp = thp.abs() + m.sigma * noise.n2[:, b]
            lkp = _kern_lp(yp, y_obs, m)
            score = ((prior(thp) + lkp) - ip(thp)) + noise.gumbel[:, b + 1]
            upd = score > best
            best = torch.where(upd, score, best)
            w_th = torch.where(upd[:, None], thp, w_th)
            w_y = torch.where(upd[:, None], yp, w_y)
            w_lk = torch.where(upd, lkp, w_lk)
            g_moved = g_moved | upd
        g_state = (w_th, w_y, w_lk, grad, g_moved)
    if coin is None or not coin:
        log_fwd = _std_normal_lp(noise.z, cfg)
        th_p = ((noise.z * cfg.tau) + theta) + grad * cfg.half_tau2
        grad_p = kernel_sl_grad(th_p, noise.zg, cfg)
        y_p = th_p.abs() + m.sigma * noise.z_sim
        lk_p = _kern_lp(y_p, y_obs, m)
        z_rev = _div((theta - th_p) - grad_p * cfg.half_tau2, cfg.tau)
        log_rev = _std_normal_lp(z_rev, cfg)
        log_acc = ((((prior(th_p) + lk_p) + log_rev) - lp_theta) - logk
                   ) - log_fwd
        l_acc = torch.log(noise.u_accept) < log_acc
        sel = lambda a, b: torch.where(
            l_acc.reshape(-1, *([1] * (a.dim() - 1))), a, b)
        l_state = (sel(th_p, theta), sel(y_p, y), sel(lk_p, logk),
                   sel(grad_p, grad), l_acc)
    if g_state is None:
        new = l_state
    elif l_state is None:
        new = g_state
    else:
        new = tuple(torch.where(is_g.reshape(-1, *([1] * (a.dim() - 1))),
                                a, b) for a, b in zip(g_state, l_state))
    moved = new[4]
    f = lambda x: x.to(torch.float32)
    return new[:4], (f(moved), f(is_g), f(is_g & moved), f(~is_g & moved))


def run_plain(cfg: MalaConfig, noise, theta, y, logk, grad, *, steps: int,
              coins=None, collect_history: bool = True):
    """``steps`` transitions in the kernel's layouts (``theta/y/grad (d,
    C)``, ``logk (C,)``) on ``noise(t) -> MalaNoise``; ``coins`` the shared
    coins ``(steps,)`` or None (per-chain).  Returns ``(theta, y, logk,
    grad, history or None, [acc, gatt, gacc, lacc])``."""
    state = (theta.T, y.T, logk, grad.T)
    counters = [torch.zeros_like(logk) for _ in range(4)]
    hist = (torch.empty((steps, *theta.shape), dtype=torch.float32,
                        device=theta.device) if collect_history else None)
    for t in range(steps):
        coin = None if coins is None else bool(coins[t])
        state, inc = mala_transition(state, noise(t), cfg, coin)
        counters = [c + i for c, i in zip(counters, inc)]
        if collect_history:
            hist[t] = state[0].T
    th, yy, lk, gr = state
    return (th.T.contiguous(), yy.T.contiguous(), lk.contiguous(),
            gr.T.contiguous(), hist, counters)


def glmala_launch(num_chains: int, num_sms: int, coin_mode: str = "shared"):
    """``(threads per block, chains per warp W)`` of a K6 launch of
    ``num_chains`` chains on a card of ``num_sms`` SMs.  The lanes of a
    warp past its W chains help with their candidates and gradients.

    * ``per_chain``: W is the largest of 16, 8 and 4 that still gives 8
      warps an SM (2 a scheduler), else 4: a step's few local chains deal
      their gradient items over the whole warp.
    * ``shared``: W is the largest of 32, 16, 8 and 4 that still gives 4
      warps an SM, else 4.  W = 32 runs a kernel of one thread a chain,
      with no helper lanes: a shared coin's steps are bound by the
      instructions they issue, not by the warps in flight (PERF.md), so
      more warps do not pay for the helpers' shuffles and staging there.

    The block is the largest of 256, 128 and 64 threads that still makes a
    block for every SM, else 32.  32,768 chains on 132 SMs: shared W = 32
    in blocks of 128 threads, per-chain W = 16 in blocks of 256."""
    cands, per_sm = (((32, 16, 8), 4) if coin_mode == "shared"
                     else ((16, 8), 8))
    lanes = next((w for w in cands
                  if -(-num_chains // w) >= per_sm * num_sms), 4)
    warps = -(-num_chains // lanes)
    for threads in (256, 128, 64):
        if -(-warps * 32 // threads) >= num_sms:
            return threads, lanes
    return 32, lanes


class FusedMixtureGLMALA:
    """Fused GLMALA for Mixture-family problems (``y = |theta| + sigma z``,
    Gaussian prior and importance proposal, Euclidean discrepancy, Gaussian
    epsilon-kernel), ``d`` in {1, 2, 4, 8}.

    ``launches`` counts launches of the CUDA kernel (class-wide) and rises
    for nothing else.  ``block_chains`` (threads per CUDA block, a multiple
    of 32 up to 1024) does not change the results; None takes
    :func:`glmala_launch`'s for the launch's chain count, which also gives
    the chains a warp."""

    launches = 0

    def __init__(self, theta_dim: int, y_obs, *, epsilon: float,
                 sigma: float, global_frequency: float = 0.8,
                 batch_size: int = 5, tau: float = 0.3, num_grad: int = 100,
                 fd_step: float = 0.1, prior_loc=0.0, prior_scale=1.0,
                 ip_loc=0.0, ip_scale=1.0, steps_per_call: int = 32,
                 block_chains: int | None = None,
                 collect_history: bool = True, coin_mode: str = "shared"):
        self.d = int(theta_dim)
        if self.d not in (1, 2, 4, 8):
            raise ValueError(f"the fused GLMALA kernel takes theta_dim in "
                             f"{{1, 2, 4, 8}}, got {theta_dim}")
        if coin_mode not in ("shared", "per_chain"):
            raise ValueError(f"coin_mode must be 'shared' or 'per_chain', got "
                             f"{coin_mode!r}")
        if not 1 <= int(batch_size) <= 7:
            raise ValueError(f"batch_size must be in [1, 7], got {batch_size}")
        self.coin_mode = coin_mode
        self.cfg = MalaConfig.create(
            self.d, y_obs, epsilon=epsilon, sigma=sigma,
            global_frequency=global_frequency, batch_size=batch_size,
            tau=tau, num_grad=num_grad, fd_step=fd_step,
            prior_loc=prior_loc, prior_scale=prior_scale, ip_loc=ip_loc,
            ip_scale=ip_scale)
        self.B = self.cfg.mix.B
        self.T = int(steps_per_call)
        self.C_blk = None if block_chains is None else int(block_chains)
        if self.C_blk is not None and (self.C_blk % 32
                                       or not 32 <= self.C_blk <= 1024):
            raise ValueError("block_chains must be None or a multiple of 32 "
                             f"in [32, 1024], got {block_chains}")
        self.collect_history = bool(collect_history)
        self._y_obs_on = {}   # device -> y_obs tensor the kernel reads

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
        for name, x, want in (("y", y, (self.d, C)), ("grad", grad,
                                                      (self.d, C)),
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
              step0: int = 0, noise=None, chain0: int = 0):
        """The plain torch version of :meth:`run`, on any device: the same
        random numbers (or ``noise(t) -> MalaNoise``) and results."""
        C = self._check(theta, y, logk, grad, coins)
        if noise is None:
            noise = lambda t: draw_mala_noise(seed, C, step0 + t, self.cfg,
                                              theta.device, chain0)
        host_coins = (None if self.coin_mode == "per_chain"
                      else coins.cpu().tolist())
        return run_plain(self.cfg, noise, theta, y, logk, grad,
                         steps=self.T, coins=host_coins,
                         collect_history=self.collect_history)

    def _geometry(self, C: int, dev):
        """``(threads per block, chains per warp)`` of a launch on ``dev``."""
        threads, lanes = glmala_launch(
            C, torch.cuda.get_device_properties(dev).multi_processor_count,
            self.coin_mode)
        return threads if self.C_blk is None else self.C_blk, lanes

    def _launch(self, seed, theta, y, logk, grad, coins, step0, chain0):
        from ._build import load_library

        lib = load_library("glmala")
        cfg, m, dev = self.cfg, self.cfg.mix, theta.device
        C = theta.shape[1]
        th_o, y_o, gr_o = (torch.empty_like(x) for x in (theta, y, grad))
        lk_o = torch.empty_like(logk)
        counters = [torch.empty_like(logk) for _ in range(4)]
        hist = (torch.empty((self.T, self.d, C), dtype=torch.float32,
                            device=dev) if self.collect_history else None)
        y_obs = self._y_obs_on.get(dev)
        if y_obs is None:   # a copy from the host waits for the stream: once
            y_obs = self._y_obs_on[dev] = torch.tensor(
                m.y_obs, dtype=torch.float32, device=dev)
        shared = self.coin_mode == "shared"
        if shared:
            coins = coins.to(dev, non_blocking=True)
        k0, k1 = seed_key(seed)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.glabc_glmala(
                *(ptr(x) for x in (theta, y, logk, grad, y_obs,
                                   coins if shared else None, th_o, y_o,
                                   lk_o, gr_o, hist, *counters)),
                self.d, C, self.T, self.B, cfg.n_grad,
                int(self.collect_history), int(shared),
                m.prior_loc, m.inv_prior_scale, m.c_prior, cfg.ps2,
                m.ip_loc, m.ip_scale, m.inv_ip_scale, m.c_ip, m.sigma,
                m.c_kern, m.a_kern, m.gf, cfg.tau, cfg.half_tau2, cfg.fd,
                cfg.two_fd, cfg.eps2, cfg.c_norm,
                k0, k1, int(step0), int(chain0), *self._geometry(C, dev),
                stream)
        if rc != 0:
            raise RuntimeError(f"glmala launch failed: CUDA error {rc}")
        type(self).launches += 1
        return th_o, y_o, lk_o, gr_o, hist, counters
