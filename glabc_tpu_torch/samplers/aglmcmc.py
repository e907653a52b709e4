"""AGLMCMC: adaptive global proposal (weighted KDE) with epsilon annealing,
plain torch path and the adaptation epochs the fused samplers share.

Port of ``glabc_tpu/samplers/aglmcmc.py`` (reference ``glabcmcmc/
AGLMCMC.py:44-289``):

* global moves are iSIR over a precomputed per-chain proposal pool, one
  ``batch_size`` slice per move (``AGLMCMC.py:130-164``);
* after every ``round(step_size / gf)`` steps an adaptation epoch
  (``:170-249``): anneal ``hat_eps`` by the quantile rule ``q = clamp(alpha
  #{dis < hat_eps} / n, 0, 1)``, ``hat_eps = max(quantile(dis, q),
  hat_eps_T)``; weight the pool at ``hat_eps`` for training; fit a weighted
  Silverman KDE; draw a 4x-oversampled pool from it, keep prior-supported
  draws (``prior > log 1e-10``), re-simulate and re-weight at the target
  epsilon;
* ``shared_adaptation=True``: one quantile over all chains' pools and one
  KDE, on ``shared_support`` points resampled systematically from all
  pools, from which every chain draws its own pool.

Every function steps all chains at once as batched tensors (``(C, P, d)``
pools) where the JAX package vmaps.  Randomness comes from one
``torch.Generator``.  The quantile is ``sort`` + linear interpolation at
``q (n - 1)`` (``jnp.quantile``'s default): ``torch.quantile`` rejects more
than 2^24 values and a per-chain ``q``.  The redrawn pools' density is the
K4 kernel (:func:`batched_kde_log_prob`; its plain version for CPU
tensors): per chain under each chain's KDE, and in the shared epoch under
the shared KDE taken as one chain (C = 1) whose points are a redraw chunk's
draws, up to K4's widest ``d`` (128; ``KernelDensity.log_prob`` above).
For the ``|theta| + sigma N(0, I)`` family (``MixtureProblem``,
``HighDimMixtureProblem``) a shared epoch's chunk is K10
(``ops/kernels/shared_redraw_kernel.py``: draws, prior check, partition,
simulation and weights of the rows in one launch) and K4 with its pool
epilogue, on the same random numbers and to the same pools as the
sequence they replace, which other problems keep.  The JAX epoch's
``logprob_backend`` choice is not carried over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..models.kde import KernelDensity
from ..ops.kernels.kde_logprob_kernel import (_MAX_D as _K4_MAX_D,
                                              BatchedMixtureLogProb,
                                              batched_kde_log_prob,
                                              kde_logprob_inputs)
from ..ops.kernels.shared_redraw_kernel import RedrawInputs, SharedRedraw
from ..ops.resampling import (categorical_from_log_weights,
                              stable_partition_take, systematic_resample)
from ..utils.profiling import annotate
from ._fused_io import restore_epoch_ckpt, save_epoch_ckpt
from ._shard import ChainShard
from .base import MoveCounts, SamplerResult, _select, local_rw_move
from .chain import init_chain_carry

__all__ = ["AGLMCMCConfig", "default_pool_slack", "Pool", "AGLCarry",
           "AGLResult", "quantile", "make_epoch_fn", "make_shared_epoch_fn",
           "run_aglmcmc"]

_NAN_DIS = 1.0e6 - 5.0                 # reference sentinel for NaN (:101)
_PRIOR_CUTOFF = float(np.log(1e-10))   # reference KDE prior filter (:224)


@dataclasses.dataclass(frozen=True)
class AGLMCMCConfig:
    global_frequency: float = 1.0
    batch_size: int = 5
    step_size: int = 200
    alpha: float = 0.8
    hat_eps_T: float = 0.2
    oversample: int = 4           # reference 4x (AGLMCMC.py:220)
    support_retries: int = 0
    pool_slack: int = 0           # extra pool slices beyond step_size

    @property
    def pool_slices(self) -> int:
        return self.step_size + self.pool_slack


def default_pool_slack(step_size: int, global_frequency: float) -> int:
    """Slack slices so that a fixed ``round(step_size/gf)``-step segment
    overshoots the pool with probability ~1e-9 per chain-epoch (5 sigma of
    the ``Binomial(seg_len, gf)`` consumed-slice count, plus 8).  0 at
    gf=1, where consumption is deterministic."""
    gf = float(global_frequency)
    if gf >= 1.0 or gf <= 0.0:
        return 0
    seg_len = max(1, int(round(step_size / gf)))
    sigma = float(np.sqrt(seg_len * gf * (1.0 - gf)))
    return int(np.ceil(5.0 * sigma)) + 8


class Pool(NamedTuple):
    """Per-chain proposal pools: ``theta (C, P, d)``, ``x (C, P, d_y)``,
    ``dis (C, P)`` (NaN masked to the sentinel), ``log_q (C, P)`` (proposal
    density at draw time), ``log_w (C, P)`` (MCMC log-weight at the target
    epsilon)."""

    theta: torch.Tensor
    x: torch.Tensor
    dis: torch.Tensor
    log_q: torch.Tensor
    log_w: torch.Tensor

    def rows(self, lo: int, hi: int) -> "Pool":
        """Pool slots ``[lo, hi)`` of every chain."""
        return Pool(*(a[:, lo:hi] for a in self))

    def chains(self, lo: int, hi: int) -> "Pool":
        return Pool(*(a[lo:hi] for a in self))

    @staticmethod
    def cat(pools) -> "Pool":
        return Pool(*(torch.cat(xs, dim=0) for xs in zip(*pools)))

    def selected(self, problem, sel, y_prev, logk_prev):
        """The dataset and kernel value of each chain's last selected slot
        (``sel``: the pool-iSIR kernel's flat slot, -1 when the chain did
        not move, which keeps ``y_prev`` and ``logk_prev``)."""
        rows = torch.arange(sel.shape[0], device=sel.device)
        idx = torch.clamp_min(sel, 0.0).to(torch.int64)
        moved = sel >= 0.0
        y_sel = self.x[rows, idx]
        logk_sel = problem.kernel_log_prob(self.dis[rows, idx])
        return (torch.where(moved[:, None], y_sel, y_prev),
                torch.where(moved, logk_sel, logk_prev))


class AGLCarry(NamedTuple):
    theta: torch.Tensor        # (C, d)
    y: torch.Tensor            # (C, d_y)
    log_kernel: torch.Tensor   # (C,)
    kk: torch.Tensor           # (C,) pool cursor: slices consumed this epoch
    generator: torch.Generator
    counts: MoveCounts


@dataclasses.dataclass
class AGLResult(SamplerResult):
    kde: Optional[KernelDensity] = None      # batched over chains, or shared
    hat_eps: Optional[np.ndarray] = None     # (C,) or () final thresholds
    hat_eps_hist: Optional[np.ndarray] = None  # (epochs, C) or (epochs,)
    # fused samplers: the kernel state (theta (d, C), y, log K[, log w])
    fused_state: Optional[tuple] = None


# ------------------------------------------------------------------ epochs
def quantile_position(q, n: int, device):
    """``(lo_i, hi_i, lw, hw)`` of ``jnp.quantile``'s 'linear' method over
    ``n`` values: the order statistics at ``floor`` and ``ceil`` of ``pos
    = q (n - 1)`` and their weights ``1 - (pos - floor)`` and ``pos -
    floor``, in float32 as JAX computes them."""
    q = torch.as_tensor(q, dtype=torch.float32, device=device)
    pos = q * torch.tensor(float(n - 1), dtype=torch.float32)
    low = torch.floor(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_i = torch.clamp(low, 0, n - 1).to(torch.int64)
    hi_i = torch.clamp(torch.ceil(pos), 0, n - 1).to(torch.int64)
    return lo_i, hi_i, lw, hw


def quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, q)`` over the last axis, 'linear' method, with
    ``q`` broadcast to ``x.shape[:-1]``: sort, then interpolate between
    the order statistics at ``floor`` and ``ceil`` of ``q (n - 1)``,
    computed in float32 as JAX does."""
    n = x.shape[-1]
    xs = torch.sort(x, dim=-1).values
    lo_i, hi_i, lw, hw = quantile_position(q, n, x.device)
    shape = x.shape[:-1]
    lo_v = torch.gather(xs, -1, lo_i.expand(shape)[..., None])[..., 0]
    hi_v = torch.gather(xs, -1, hi_i.expand(shape)[..., None])[..., 0]
    return lo_v * lw + hi_v * hw


def _anneal(dis: torch.Tensor, hat_eps: torch.Tensor,
            cfg: AGLMCMCConfig) -> torch.Tensor:
    """One annealing step of ``hat_eps`` (``AGLMCMC.py:174-196``) over the
    last axis of ``dis``; thresholds at ``hat_eps_T`` stay."""
    num_a = torch.sum(dis < hat_eps[..., None], dim=-1)
    q = torch.clamp(cfg.alpha * num_a / dis.shape[-1], 0.0, 1.0)
    new = torch.clamp_min(quantile(dis, q), cfg.hat_eps_T)
    return torch.where(hat_eps > cfg.hat_eps_T, new, hat_eps)


def _pool_from_proposals(problem, generator, theta_prop, log_q) -> Pool:
    """Simulate and weight proposals ``(..., d)`` (``AGLMCMC.py:84-112``)."""
    nan_row = torch.isnan(theta_prop).any(dim=-1)
    theta_safe = torch.where(nan_row[..., None],
                             torch.zeros_like(theta_prop), theta_prop)
    x = problem.simulate(theta_safe, generator)
    dis = problem.discrepancy(x)
    dis = torch.where(torch.isnan(dis) | nan_row,
                      torch.full_like(dis, _NAN_DIS), dis)
    log_k = problem.kernel_log_prob(dis)      # target epsilon (:104)
    log_w = problem.prior_log_prob(theta_prop) + log_k - log_q
    log_w = torch.where(nan_row | torch.isnan(log_w),
                        torch.full_like(log_w, -math.inf), log_w)
    return Pool(theta_safe, x, dis, log_q, log_w)


def _init_pools(problem, generator, proposal, num_chains: int,
                pool_rows: int) -> Pool:
    """``pool_rows`` draws per chain from the initial iSIR proposal."""
    th, log_q = proposal(num_chains * pool_rows, generator)
    return _pool_from_proposals(
        problem, generator, th.reshape(num_chains, pool_rows, -1),
        log_q.reshape(num_chains, pool_rows))


def _training_log_w(problem, pools: Pool, hat_eps) -> torch.Tensor:
    """The pool's log-weights at the annealed ``hat_eps``
    (``AGLMCMC.py:199-204``)."""
    return (problem.prior_log_prob(pools.theta)
            + problem.kernel_log_prob(pools.dis, hat_eps) - pools.log_q)


def _redraw(problem, cfg: AGLMCMCConfig, generator, kde: KernelDensity,
            num_rows: int, batch: tuple = ()) -> torch.Tensor:
    """Oversampled KDE draws, prior-supported rows first
    (``AGLMCMC.py:220-229``): ``(C, num_rows, d)``.  Rows out of support
    stay after the valid ones when fewer than ``num_rows`` are valid, as in
    the JAX package."""
    cand = kde.sample(generator, cfg.oversample * num_rows, batch=batch)
    ok = problem.prior_log_prob(cand) > _PRIOR_CUTOFF
    return stable_partition_take(cand, ok, num_rows)


def _epoch_update(problem, cfg: AGLMCMCConfig, generator, pools: Pool,
                  hat_eps: torch.Tensor):
    """Per-chain adaptation epoch for chains ``(C, ...)`` -> ``(new pools,
    batched KDE, hat_eps (C,))``."""
    P = pools.theta.shape[1]
    hat_eps = _anneal(pools.dis, hat_eps, cfg)
    w = torch.exp(_training_log_w(problem, pools, hat_eps[:, None]))
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    kde = KernelDensity.fit(pools.theta, w, bandwidth="silverman")
    new_theta = _redraw(problem, cfg, generator, kde, P)
    new_log_q = batched_kde_log_prob(kde, new_theta)          # K4
    return (_pool_from_proposals(problem, generator, new_theta, new_log_q),
            kde, hat_eps)


def make_epoch_fn(problem, cfg: AGLMCMCConfig, num_chains: int,
                  epoch_chunk: int = 0):
    """The per-chain adaptation epoch ``(generator, pools, hat_eps) ->
    (pools, kdes, hat_eps)``.  ``epoch_chunk > 0`` runs the chains in
    sequential chunks of that many (a memory bound for large runs; the
    draws then come from the generator chunk by chunk)."""
    C = num_chains
    chunk = epoch_chunk if (epoch_chunk and epoch_chunk < C) else C

    def epoch(generator, pools: Pool, hat_eps: torch.Tensor):
        if chunk == C:
            return _epoch_update(problem, cfg, generator, pools, hat_eps)
        outs = [_epoch_update(problem, cfg, generator,
                              pools.chains(c0, c0 + chunk),
                              hat_eps[c0:c0 + chunk])
                for c0 in range(0, C, chunk)]
        kdes = KernelDensity(*(torch.cat([getattr(o[1], f) for o in outs])
                               for f in ("X", "weights", "bandwidth")))
        return (Pool.cat([o[0] for o in outs]), kdes,
                torch.cat([o[2] for o in outs]))

    return epoch


def _shared_support(problem, pools: Pool, hat_eps, num: int,
                    generator) -> torch.Tensor:
    """``num`` pool rows ``(num, d)`` resampled systematically from all
    ``C * P`` rows by their training weights at ``hat_eps``.  The CDF runs
    in float64: a float32 running sum near 1 drops every increment below
    half an ulp (3e-8), and at 16,384 chains x 2,000 rows the mean weight
    is 3e-8, so a float32 scan would seldom pick the lighter rows."""
    P = pools.dis.shape[1]
    w = torch.exp(_training_log_w(problem, pools, hat_eps).to(torch.float64))
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    w = w / torch.sum(w)
    idx = systematic_resample(w.reshape(-1), num, generator)
    return pools.theta[idx // P, idx % P]


def _shared_epoch_update(problem, cfg: AGLMCMCConfig, shared_support: int,
                         generator, pools: Pool, hat_eps: torch.Tensor,
                         redraw_chunk: int = 0):
    """Shared adaptation epoch: one quantile over all ``C * P`` pool
    discrepancies, one KDE on ``shared_support`` points systematically
    resampled from the training weights of all pools, and per-chain pools
    drawn from it in chunks of ``redraw_chunk`` chains (the density of a
    chunk's draws is one K4 launch over ``chunk P`` points).  Returns
    ``(pools, kde (unbatched), hat_eps ())``; a ``glabc.epoch`` span
    around the spans of its phases (:func:`_redraw_chunks`)."""
    C, P = pools.dis.shape
    chunk = redraw_chunk if (redraw_chunk and redraw_chunk < C) else C
    if C % chunk:
        raise ValueError(f"num_chains={C} must be divisible by "
                         f"redraw_chunk={redraw_chunk}")
    with annotate("glabc.epoch"):
        with annotate("glabc.epoch.anneal"):
            hat_eps = _anneal(pools.dis.reshape(-1), hat_eps, cfg)
        with annotate("glabc.epoch.support"):
            support = _shared_support(problem, pools, hat_eps,
                                      shared_support, generator)
            kde = KernelDensity.fit(support, None, bandwidth="silverman")
        pools = _redraw_chunks(problem, cfg, generator, kde, C, P, chunk)
    return pools, kde, hat_eps


def _shared_density(kde: KernelDensity):
    """``log_q(x (..., d)) -> (...)`` under the shared (unbatched) KDE: K4
    with the KDE as one chain (C = 1) and ``x``'s rows as its points, the
    kernel's inputs built once; above K4's widest ``d``,
    ``KernelDensity.log_prob``."""
    if kde.dim > _K4_MAX_D:
        return kde.log_prob
    args = kde_logprob_inputs(KernelDensity(
        kde.X[None], kde.weights[None], kde.bandwidth[None]))
    kern = BatchedMixtureLogProb()

    def log_q(x):
        pts = x.reshape(1, -1, kde.dim).contiguous()
        return kern.run(pts, *args).reshape(x.shape[:-1])

    return log_q


def _redraw_inputs(problem, kde: KernelDensity):
    """K10's constants of an epoch (``problem.shared_redraw_inputs``: the
    ``|theta| + sigma N(0, I)`` family's) where the KDE is within K4's
    widest ``d``, whose pool epilogue completes K10's rows; None where the
    shared epoch keeps the generic sequence."""
    if kde.dim > _K4_MAX_D:
        return None
    return problem.shared_redraw_inputs(kde, _PRIOR_CUTOFF, _NAN_DIS)


def _redraw_chunks(problem, cfg: AGLMCMCConfig, generator,
                  kde: KernelDensity, num_chains: int, pool_rows: int,
                  chunk: int) -> Pool:
    """The shared epoch's new pools, ``chunk`` chains at a time.

    Where :func:`_redraw_inputs` gives K10's constants, each chunk's draws
    (``u``, ``z`` and the simulator's noise, drawn up front in the order
    the steps below once drew them) and K10, which writes the rows' theta,
    dataset,
    discrepancy and prior + log K (``glabc.epoch.redraw``, whose ``nbytes``
    are those rows' bytes), then K4 with its pool epilogue, the density and
    the log-weights (``glabc.epoch.density``); the rows are written into
    the epoch's pools in place.  Otherwise the KDE draws, prior check and
    stable partition (``glabc.epoch.redraw``, ``nbytes`` 0), their density
    (``glabc.epoch.density``, one K4 launch a chunk) and the simulated,
    weighted pool rows (``glabc.epoch.pool``).  Both give the same pools
    from the same generator."""
    inputs = _redraw_inputs(problem, kde)
    if inputs is not None:
        return _shared_redraw_chunks(cfg, generator, kde, inputs,
                                     num_chains, pool_rows, chunk)
    density = _shared_density(kde)
    parts = []
    for _ in range(0, num_chains, chunk):
        with annotate("glabc.epoch.redraw"):
            new_theta = _redraw(problem, cfg, generator, kde, pool_rows,
                                batch=(chunk,))
        with annotate("glabc.epoch.density"):
            log_q = density(new_theta)
        with annotate("glabc.epoch.pool"):
            parts.append(_pool_from_proposals(problem, generator, new_theta,
                                              log_q))
    return Pool.cat(parts)


def _shared_redraw_chunks(cfg: AGLMCMCConfig, generator, kde: KernelDensity,
                          inputs: RedrawInputs, num_chains: int,
                          pool_rows: int, chunk: int) -> Pool:
    """:func:`_redraw_chunks` through K10 and K4's pool epilogue."""
    C, P, d = num_chains, pool_rows, kde.dim
    M, dev = cfg.oversample * P, kde.X.device
    k4_args = kde_logprob_inputs(KernelDensity(
        kde.X[None], kde.weights[None], kde.bandwidth[None]))
    redraw, k4 = SharedRedraw(), BatchedMixtureLogProb()
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    pools = Pool(empty(C, P, d), empty(C, P, d), empty(C, P), empty(C, P),
                 empty(C, P))
    draw = dict(generator=generator, dtype=torch.float32, device=dev)
    nbytes = chunk * P * (2 * d + 2) * 4
    for c0 in range(0, C, chunk):
        rows = pools.chains(c0, c0 + chunk)
        with annotate("glabc.epoch.redraw", nbytes):
            u = torch.rand((chunk, M), **draw)
            z = torch.randn((chunk, M, d), **draw)
            noise = torch.randn((chunk, P, d), **draw)
            redraw.run(u, z, noise, inputs,
                       out=(rows.theta, rows.x, rows.dis, rows.log_w))
        with annotate("glabc.epoch.density"):
            k4.run(rows.theta.reshape(1, -1, d), *k4_args,
                   out=rows.log_q.reshape(1, -1),
                   log_w=rows.log_w.reshape(1, -1))
    return pools


def make_shared_epoch_fn(problem, cfg: AGLMCMCConfig, shared_support: int,
                         redraw_chunk: int = 0):
    """The shared adaptation epoch ``(generator, pools, hat_eps) ->
    (pools, kde, hat_eps)``."""

    def epoch(generator, pools: Pool, hat_eps: torch.Tensor):
        return _shared_epoch_update(problem, cfg, shared_support, generator,
                                    pools, hat_eps, redraw_chunk)

    return epoch


# -------------------------------------------------------------- scan path
def _build_step(problem, local_proposal, initial_proposal,
                cfg: AGLMCMCConfig):
    """Batched transition ``step(pool, kde, carry) -> carry`` plus the new
    thetas.  ``kde=None`` before the first epoch: the current state's
    density is the initial proposal's (``AGLMCMC.py:137-140``)."""
    gf, B = cfg.global_frequency, cfg.batch_size

    def step(pool: Pool, kde, carry: AGLCarry):
        gen = carry.generator
        theta, y, lk = carry.theta, carry.y, carry.log_kernel
        C = theta.shape[0]
        dev = theta.device
        is_global = torch.rand(C, generator=gen, device=dev) < gf
        # fresh slice per global move; the clamp fires only on the rare
        # binomial overshoot of a fixed-length segment (pool_slack)
        start = torch.clamp(carry.kk, max=cfg.pool_slices - 1) * B
        idx = start[:, None].to(torch.int64) + torch.arange(B, device=dev)
        take = lambda a: torch.gather(
            a, 1, idx.reshape(C, B, *([1] * (a.dim() - 2))).expand(
                C, B, *a.shape[2:]))
        th_s, x_s, dis_s, lw_s = (take(pool.theta), take(pool.x),
                                  take(pool.dis), take(pool.log_w))
        if kde is None:
            log_q_old = initial_proposal.log_prob(theta)
        elif kde.batch_shape:
            log_q_old = kde.log_prob(theta[:, None, :])[:, 0]
        else:
            log_q_old = kde.log_prob(theta)
        log_w_old = problem.prior_log_prob(theta) + lk - log_q_old
        ind = categorical_from_log_weights(
            torch.cat([log_w_old[:, None], lw_s], dim=1), gen)
        rows = torch.arange(C, device=dev)
        g = (torch.cat([theta[:, None], th_s], dim=1)[rows, ind],
             torch.cat([y[:, None], x_s], dim=1)[rows, ind],
             torch.cat([lk[:, None], problem.kernel_log_prob(dis_s)],
                       dim=1)[rows, ind],
             ind != 0)
        if gf >= 1.0:
            new, accepted = g[:3], g[3]
        else:
            loc = local_rw_move(problem, local_proposal, gen, theta, y, lk,
                                cfg.support_retries)
            sel = [_select(is_global, a, b) for a, b in zip(g, loc)]
            new, accepted = sel[:3], sel[3]
        kk = carry.kk + is_global.to(carry.kk.dtype)
        return AGLCarry(*new, kk, gen,
                        carry.counts.update(is_global, accepted))

    return step


def _kde_arrays(kde):
    return ({} if kde is None else
            {"kde.X": kde.X, "kde.weights": kde.weights,
             "kde.bandwidth": kde.bandwidth})


def _kde_from(arrays, device):
    if "kde.X" not in arrays:
        return None
    return KernelDensity(*(torch.as_tensor(arrays[f"kde.{f}"], device=device)
                           for f in ("X", "weights", "bandwidth")))


def _pool_arrays(pools: Pool) -> dict:
    return {f"pools.{k}": v for k, v in pools._asdict().items()}


def _pool_from(arrays, device) -> Pool:
    return Pool(*(torch.as_tensor(arrays[f"pools.{k}"], device=device)
                  for k in Pool._fields))


def run_aglmcmc(problem, generator, num_ite, theta0, local_proposal,
                initial_isir_proposal, global_frequency=1.0, batch_size=5,
                step_size=200, alpha=0.8, hat_eps_T=0.2, y0=None,
                num_chains: int = 1, on_segment=None, oversample: int = 4,
                support_retries: int = 0, epoch_chunk: int = 0,
                shared_adaptation: bool = False, shared_support: int = 4096,
                redraw_chunk: int = 0, mesh=None,
                pool_slack: Optional[int] = None,
                checkpoint_path: Optional[str] = None, resume: bool = False,
                device=None) -> AGLResult:
    """AGLMCMC, plain torch path.  Chains have length ``num_ite`` with the
    initial state at index 0.

    ``shared_adaptation=True`` switches to cross-chain adaptation (one
    quantile, one KDE on ``shared_support`` resampled points, redrawn in
    chunks of ``redraw_chunk`` chains); ``epoch_chunk`` bounds the memory of
    per-chain epochs.  ``pool_slack``: extra slices so gf<1 segments never
    reuse one (default ~5 sigma of the binomial overshoot, 0 at gf=1).

    ``checkpoint_path``/``resume``: the adaptation state (pools, KDE,
    ``hat_eps`` history, carry, generator state) is saved at every aligned
    segment boundary, before the epoch that follows it; ``resume=True``
    replays that epoch and continues bitwise, returning only the history
    after the resume point.

    ``mesh``: a 1-D ``DeviceMesh``; every rank calls with the same
    arguments and generator seed.  The initial states are drawn for every
    chain (the rank keeps its own), so the first row is the one-device
    run's; after it a rank draws from its own generator
    (``ChainShard.local_generator``), so the chains match a one-device run
    in distribution.  Per-chain adaptation runs on each rank alone; shared
    adaptation is the sharded epoch (``parallel.make_sharded_shared_epoch``),
    which fits the same KDE on every rank.  Every rank returns the whole
    history, counts and ``hat_eps``; ``kde`` and ``final_carry`` hold its
    own chains."""
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    if pool_slack is None:
        pool_slack = default_pool_slack(step_size, global_frequency)
    cfg = AGLMCMCConfig(global_frequency, batch_size, step_size, alpha,
                        hat_eps_T, oversample, support_retries, pool_slack)
    P = batch_size * cfg.pool_slices
    C = shard.local
    local_proposal = local_proposal.to(dev)
    initial_isir_proposal = initial_isir_proposal.to(dev)
    if shared_adaptation:
        chunk = redraw_chunk if redraw_chunk and redraw_chunk < C else 0
        if mesh is None:
            epoch_fn = make_shared_epoch_fn(problem, cfg, shared_support,
                                            chunk)
        else:
            from ..parallel.sharded import make_sharded_shared_epoch
            epoch_fn = make_sharded_shared_epoch(problem, cfg, shared_support,
                                                 mesh, chunk)
    else:
        epoch_fn = make_epoch_fn(problem, cfg, C, epoch_chunk)
    step = _build_step(problem, local_proposal, initial_isir_proposal, cfg)
    seg_len = (max(1, int(round(step_size / global_frequency)))
               if global_frequency > 0 else (num_ite - 1))
    ckpt_meta = {"sampler": "aglmcmc", "num_chains": shard.total,
                 "theta_dim": problem.theta_dim, "seg_len": seg_len,
                 "pool_rows": P, "shared": int(shared_adaptation),
                 **shard.meta}
    checkpoint_path = shard.path(checkpoint_path, resume)
    restored = (restore_epoch_ckpt(checkpoint_path, ckpt_meta)
                if resume and checkpoint_path is not None else None)
    if restored is None:
        cc = init_chain_carry(problem, generator, theta0, y0, shard.total,
                              dev)
        theta_init = cc.theta.cpu().numpy()[:, None, :]
        gen = shard.local_generator(generator)
        carry = AGLCarry(shard.keep(cc.theta), shard.keep(cc.y),
                         shard.keep(cc.log_kernel),
                         torch.zeros(C, dtype=torch.int32, device=dev),
                         gen, MoveCounts.zeros(C, dev))
        pools = _init_pools(problem, gen, initial_isir_proposal, C, P)
        kdes = None
        hat_eps = (torch.tensor(1.0e6) if shared_adaptation
                   else torch.full((C,), 1.0e6)).to(dev)
        hat_eps_hist = []
        done = n_epochs = 0
        pending_epoch = False
    else:
        arrays, done = restored
        t = lambda k: torch.as_tensor(arrays[k], device=dev)
        gen = shard.restore_rngs(arrays, generator)
        carry = AGLCarry(t("theta"), t("y"), t("log_kernel"), t("kk"), gen,
                         MoveCounts(*(t(f"counts.{k}")
                                      for k in MoveCounts._fields)))
        pools, kdes = _pool_from(arrays, dev), _kde_from(arrays, dev)
        hat_eps = t("hat_eps")
        hat_eps_hist = list(arrays["hat_eps_hist"])
        n_epochs = int(arrays["n_epochs"])
        theta_init = None
        pending_epoch = True

    # per-chain values of every rank, on the host
    host = lambda a: shard.gather_host(a, dev)
    blocks = []
    total = num_ite - 1
    while done < total:
        if pending_epoch:
            # the shared epoch draws from the run's generator, the same on
            # every rank; a per-chain epoch from the rank's own
            pools, kdes, hat_eps = epoch_fn(
                generator if shared_adaptation else gen, pools, hat_eps)
            hat_eps_hist.append(hat_eps.cpu().numpy())
            n_epochs += 1
            # fresh pool: the cursor goes back to slice 0 (AGLMCMC.py:249)
            carry = carry._replace(kk=torch.zeros_like(carry.kk))
            pending_epoch = False
        take = min(seg_len, total - done)
        seg = []
        for _ in range(take):
            carry = step(pools, kdes, carry)
            seg.append(carry.theta)
        blocks.append(host(torch.stack(seg, dim=1).cpu().numpy()))
        if on_segment is not None:
            on_segment(blocks[-1], done)
        done += take
        if take == seg_len:
            if done < total:
                pending_epoch = True
            if checkpoint_path is not None:
                state = {"theta": carry.theta, "y": carry.y,
                         "log_kernel": carry.log_kernel, "kk": carry.kk,
                         **shard.rng_arrays(generator, gen),
                         "hat_eps": hat_eps, "n_epochs": n_epochs,
                         "hat_eps_hist": np.asarray(hat_eps_hist,
                                                    np.float32)}
                state.update({f"counts.{k}": v
                              for k, v in carry.counts._asdict().items()})
                state.update(_pool_arrays(pools))
                state.update(_kde_arrays(kdes))
                save_epoch_ckpt(checkpoint_path, state, done, take, seg_len,
                                meta=ckpt_meta)

    head = [theta_init] if theta_init is not None else []
    thetas = (np.concatenate(head + blocks, axis=1) if head or blocks
              else np.zeros((shard.total, 0, problem.theta_dim), np.float32))
    per_chain = (lambda a: a) if shared_adaptation else host
    hist = (per_chain(np.asarray(hat_eps_hist).T).T if hat_eps_hist
            else None)
    return AGLResult(
        thetas=thetas,
        counts=MoveCounts(*(host(c.cpu().numpy()) for c in carry.counts)),
        final_carry=carry, kde=kdes,
        hat_eps=per_chain(hat_eps.cpu().numpy()), hat_eps_hist=hist)
