"""The fused AGLMCMC samplers: the loops around the pool kernels.

Port of ``glabc_tpu/samplers/aglmcmc_fused.py``.

* ``global_frequency == 1`` (:func:`run_aglmcmc_fused`): every transition is
  iSIR over a precomputed pool slice, the :class:`PoolISIR` kernel (K3).
  Between segments the per-chain adaptation epoch of the scan path runs
  (its redrawn-pool density is the K4 kernel), and the current state's
  log-weight is recomputed under each chain's new KDE by K4's formula, so
  that it and the pool's log-weights agree.  The kernel records the last
  selected pool slot; its dataset and kernel value are gathered from the
  pool after each launch.
* ``global_frequency < 1`` (:func:`run_aglmcmc_fused_mixed`): the
  :class:`PoolISIRMixed` kernel (K5) with a per-chain coin, the
  Mixture-family local move or a tile program's (``tile_program=``), and
  the current state's density under the resident shared KDE; adaptation is
  shared across chains.

Both run on one seed drawn from the generator, with each launch keyed by
the absolute index of its first transition, so a chain's stream does not
depend on ``pack_chunk``, ``block_chains`` or how the run is segmented (the
JAX package reseeds per launch).  History goes to the host by non-blocking
copies into pinned memory, collected at the end; ``thin`` and
``history_dtype='bfloat16'`` shrink the copy on the card first.

``mesh=`` (a 1-D ``DeviceMesh``): every rank draws the initial states of
all chains and keeps its contiguous range (the first row is the one-device
run's), then draws its pools, per-chain epochs and local redraws from its
own generator (``ChainShard.local_generator``): a run matches the
one-device run in distribution.  The kernels take the rank's first global
chain as ``chain0``; the shared epoch of the mixed kernel is
``parallel.make_sharded_shared_epoch``.  Every rank returns the whole
history, counts and ``hat_eps``; ``kde``, ``final_carry`` and
``fused_state`` hold its own chains.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..ops.kernels.kde_logprob_kernel import (BatchedMixtureLogProb,
                                              kde_logprob_inputs)
from ..ops.kernels.pool_isir_kernel import (PoolISIR, pack_pool_logw,
                                            pack_pool_theta)
from ..ops.kernels.pool_isir_mixed_kernel import (PoolISIRMixed,
                                                  resident_from_gaussian,
                                                  resident_from_kde)
from ..ops.kernels.program import check_program
from ..utils.profiling import annotate
from . import aglmcmc as _agl
from ._fused_io import FusedRun, to_host
from ._shard import ChainShard
from .aglmcmc import AGLCarry, AGLMCMCConfig, AGLResult

__all__ = ["run_aglmcmc_fused", "run_aglmcmc_fused_mixed"]


def _logw_under_kde(problem, kdes, theta_k, logk):
    """The current states' log-weights ``prior + log K - log q`` under each
    chain's KDE, ``log q`` by K4's formula (the plain version with one
    point per chain), as the pool's log-weights were computed."""
    th = theta_k.T.contiguous()                                  # (C, d)
    ms, pre, inv_h2 = kde_logprob_inputs(kdes)
    logq = BatchedMixtureLogProb().plain(th[:, None, :], ms, pre, inv_h2)
    return (problem.prior_log_prob(th) + logk - logq[:, 0]).contiguous()


def run_aglmcmc_fused(problem, generator, num_ite, theta0,
                      initial_isir_proposal, *, batch_size: int = 5,
                      step_size: int = 200, alpha: float = 0.8,
                      hat_eps_T: float = 0.2, oversample: int = 4,
                      num_chains: int = 4096,
                      block_chains: int | None = None,
                      collect_history: bool = True, y0=None,
                      seed: int | None = None, epoch_chunk: int = 0,
                      on_segment=None, mesh=None,
                      global_frequency: float = 1.0, lp_scale: float = 0.35,
                      shared_support: int = 4096, redraw_chunk: int = 512,
                      checkpoint_path: str | None = None,
                      resume: bool = False, pack_chunk: int = 0,
                      thin: int = 1, history_dtype=None,
                      tile_program=None, device=None) -> AGLResult:
    """AGLMCMC through the fused pool-iSIR kernel (K3).  ``global_frequency
    < 1`` goes to :func:`run_aglmcmc_fused_mixed`.

    Segments are ``step_size`` transitions, one pool; between them the
    per-chain adaptation epoch runs (``epoch_chunk`` bounds its memory).
    The result follows the scan path: chains of length ``num_ite`` with
    the initial state at index 0, the per-chain ``hat_eps`` history, the
    final chain-batched KDE.  The kernel always runs whole launches: when
    ``num_ite - 1`` is not a multiple of the launch length, the history is
    still ``num_ite`` long, the final carry is ahead of it, and the last
    launch's counts are pro rata.

    ``block_chains``: threads per CUDA block (None: each kernel's
    default; the mixed kernel's is chosen from ``num_chains``).

    ``pack_chunk``: launch ``step_size / pack_chunk`` sub-segments of that
    many steps, so only that part of the pool is ever held in the kernel's
    layout; the chains do not change.  ``thin``/``history_dtype``: keep
    iterations ``i % thin == 0`` (and the initial state) and/or copy the
    history as bfloat16; both exclude ``on_segment``.

    ``checkpoint_path``/``resume``: the loop state is saved at every epoch
    boundary; a resume continues bitwise and returns the history after the
    resume point."""
    if global_frequency < 1.0:
        return run_aglmcmc_fused_mixed(
            problem, generator, num_ite, theta0, initial_isir_proposal,
            global_frequency=global_frequency, batch_size=batch_size,
            step_size=step_size, alpha=alpha, hat_eps_T=hat_eps_T,
            oversample=oversample, num_chains=num_chains,
            block_chains=block_chains, collect_history=collect_history,
            y0=y0, seed=seed, on_segment=on_segment, mesh=mesh,
            lp_scale=lp_scale, shared_support=shared_support,
            redraw_chunk=redraw_chunk, checkpoint_path=checkpoint_path,
            resume=resume, thin=thin, history_dtype=history_dtype,
            tile_program=tile_program, device=device)
    if tile_program is not None:
        raise ValueError(
            "tile_program= gives the local move at global_frequency < 1; at "
            "global_frequency == 1 every move is pool iSIR, which serves any "
            "problem without one")
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    d = problem.theta_dim
    T, B, C = int(step_size), int(batch_size), shard.local
    P = T * B
    cfg = AGLMCMCConfig(1.0, B, T, alpha, hat_eps_T, oversample, 0, 0)
    sub_T = int(pack_chunk) if pack_chunk else T
    if T % sub_T:
        raise ValueError(f"pack_chunk={pack_chunk} must divide "
                         f"step_size={T}")
    n_sub = T // sub_T
    blk = {} if block_chains is None else {"block_chains": block_chains}
    kern = PoolISIR(d, batch_size=B, steps_per_call=sub_T,
                    collect_history=collect_history, **blk)
    epoch_fn = _agl.make_epoch_fn(problem, cfg, C, epoch_chunk)
    ip = initial_isir_proposal.to(dev)

    meta = {"sampler": "aglmcmc_fused", "num_chains": shard.total,
            "theta_dim": d, "steps_per_call": T, "batch_size": B}
    run = FusedRun(shard, dev, checkpoint_path, resume, meta,
                   collect_history=collect_history, on_segment=on_segment,
                   thin=thin, history_dtype=history_dtype,
                   counters=("g_acc",))
    if run.resumed:
        arrays = run.arrays
        gen = shard.restore_rngs(arrays, generator)
        pools, kdes = _agl._pool_from(arrays, dev), _agl._kde_from(arrays,
                                                                   dev)
        theta_k, logw_k, y_cur, logk, hat_eps = run.tensors(
            "theta_k", "logw_k", "y_cur", "logk", "hat_eps")
        hat_eps_hist = list(arrays["hat_eps_hist"])
        ep = int(arrays["ep"])
    else:
        th_c, y_cur, logk = (shard.keep(x) for x in run.initial_chains(
            problem, generator, theta0, y0))
        gen = shard.local_generator(generator)
        pools = _agl._init_pools(problem, gen, ip, C, P)
        theta_k = th_c.T.contiguous()
        logw_k = (problem.prior_log_prob(th_c) + logk
                  - ip.log_prob(th_c)).contiguous()
        kdes = None
        hat_eps = torch.full((C,), 1.0e6, device=dev)
        hat_eps_hist = []
        ep = 0
    seed = run.kernel_seed(seed, generator)
    pending_epoch = run.resumed

    total = num_ite - 1
    packed = None
    while run.done < total:
        if pending_epoch:
            pools, kdes, hat_eps = epoch_fn(gen, pools, hat_eps)
            hat_eps_hist.append(hat_eps.cpu().numpy())
            ep += 1
            packed = None
            logw_k = _logw_under_kde(problem, kdes, theta_k, logk)
            pending_epoch = False
        j = (run.done % T) // sub_T
        sp = pools if n_sub == 1 else pools.rows(j * sub_T * B,
                                                 (j + 1) * sub_T * B)
        if n_sub > 1 or packed is None:
            packed = (pack_pool_theta(sp.theta, sub_T, B),
                      pack_pool_logw(sp.log_w, sub_T, B))
        take = min(sub_T, total - run.done)
        theta_k, logw_k, sel, moved, hist = kern.run(
            seed, *packed, theta_k, logw_k, step0=run.done,
            chain0=shard.chain0)
        y_cur, logk = sp.selected(problem, sel, y_cur, logk)
        run.launched(hist, take, sub_T, [moved])
        if take == sub_T and run.done % T == 0:
            pending_epoch = run.done < total
            if run.path is not None:
                state = {"theta_k": theta_k, "logw_k": logw_k,
                         "y_cur": y_cur, "logk": logk, "hat_eps": hat_eps,
                         "ep": ep, **shard.rng_arrays(generator, gen),
                         "hat_eps_hist": np.asarray(hat_eps_hist,
                                                    np.float32)}
                state.update(_agl._pool_arrays(pools))
                state.update(_agl._kde_arrays(kdes))
                run.save(state)

    thetas, counts = run.finish(theta_k)
    carry = AGLCarry(theta_k.T.contiguous(), y_cur, logk,
                     torch.zeros(C, dtype=torch.int32, device=dev),
                     gen, counts)
    return AGLResult(
        thetas=thetas, counts=counts, final_carry=carry, kde=kdes,
        hat_eps=run.host(hat_eps),
        hat_eps_hist=(shard.gather_host(np.asarray(hat_eps_hist).T, dev).T
                      if hat_eps_hist else None),
        fused_state=(theta_k, y_cur, logk, logw_k))


@annotate("glabc.run.aglmcmc_fused_mixed")
def run_aglmcmc_fused_mixed(problem, generator, num_ite, theta0,
                            initial_isir_proposal, *,
                            global_frequency: float, batch_size: int = 5,
                            step_size: int = 200, alpha: float = 0.8,
                            hat_eps_T: float = 0.2, oversample: int = 4,
                            num_chains: int = 4096,
                            block_chains: int | None = None,
                            collect_history: bool = True, y0=None,
                            seed: int | None = None, on_segment=None,
                            mesh=None, lp_scale: float = 0.35,
                            shared_support: int = 4096,
                            redraw_chunk: int = 512,
                            checkpoint_path: str | None = None,
                            resume: bool = False, tile_program=None,
                            thin: int = 1, history_dtype=None,
                            device=None) -> AGLResult:
    """AGLMCMC at ``global_frequency < 1`` through the mixed kernel (K5):
    per-chain coin, the in-kernel local move, and the current state's
    density under the resident shared KDE.

    The local move is the built-in Mixture move (a Mixture-family problem:
    ``problem._noise_std``, ``y_dim == theta_dim``) or, with
    ``tile_program=`` (a :class:`~glabc_tpu_torch.ops.kernels.program.
    TileProgram`, e.g. ``problem.tile_program()``), the program's, any
    problem; pools and epochs simulate through ``problem.simulate``.
    ``initial_isir_proposal`` must be a diagonal Gaussian (its density is
    the first epoch's resident mixture).  Adaptation is shared:
    one quantile over all pools and one ``shared_support``-point KDE per
    epoch.  Pools are consumed slice-per-step: segments are ``seg_len =
    round(step_size / gf)`` steps with ``seg_len * batch_size`` pool rows,
    and a slice whose step flips a local coin is skipped.
    ``redraw_chunk`` is cut down to a divisor of ``num_chains`` (of a
    rank's chains under ``mesh``)."""
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    d = problem.theta_dim
    if tile_program is not None:
        check_program(problem, tile_program)
        sigma, y_obs = 0.0, None
    else:
        sigma = getattr(problem, "_noise_std", None)
        if sigma is None:
            raise ValueError(
                "run_aglmcmc_fused_mixed needs a Mixture-family problem (with "
                "a Gaussian simulator noise scale) for the in-kernel local "
                "move, or tile_program=; run_aglmcmc (scan) covers other "
                "problems")
        if problem.y_dim != d:
            raise ValueError("Mixture-family kernels require y_dim == "
                             "theta_dim")
        y_obs = problem.y_obs.cpu().numpy()
    loc = getattr(initial_isir_proposal, "loc", None)
    log_scale = getattr(initial_isir_proposal, "log_scale", None)
    if loc is None or log_scale is None:
        raise ValueError(
            "initial_isir_proposal must be a DiagGaussian (loc/log_scale): "
            "its density is evaluated in the kernel for the first epoch")
    gf = float(global_frequency)
    B, C = int(batch_size), shard.local
    seg_len = max(1, int(round(step_size / gf)))
    P = seg_len * B
    # pool_slices == seg_len: the shared epoch redraws P = seg_len * B rows
    cfg = AGLMCMCConfig(gf, B, step_size, alpha, hat_eps_T, oversample, 0,
                        seg_len - step_size)
    kern = PoolISIRMixed(
        d, y_obs, epsilon=problem.epsilon, sigma=sigma,
        global_frequency=gf, batch_size=B, steps_per_call=seg_len,
        lp_scale=lp_scale, block_chains=block_chains,
        collect_history=collect_history, program=tile_program)
    if redraw_chunk and redraw_chunk < C:
        while C % redraw_chunk:
            redraw_chunk -= 1
    else:
        redraw_chunk = 0
    if mesh is None:
        epoch_fn = _agl.make_shared_epoch_fn(problem, cfg, shared_support,
                                             redraw_chunk)
    else:
        from ..parallel.sharded import make_sharded_shared_epoch
        epoch_fn = make_sharded_shared_epoch(problem, cfg, shared_support,
                                             mesh, redraw_chunk)
    ip = initial_isir_proposal.to(dev)

    def pack(pools_):
        return (pack_pool_theta(pools_.theta, seg_len, B),
                pack_pool_theta(pools_.x, seg_len, B),
                pack_pool_logw(pools_.log_w, seg_len, B),
                pack_pool_logw(problem.kernel_log_prob(pools_.dis), seg_len,
                               B))

    meta = {"sampler": "aglmcmc_fused_mixed", "num_chains": shard.total,
            "theta_dim": d, "seg_len": seg_len, "batch_size": B,
            "shared_support": shared_support,
            "program": "" if tile_program is None else tile_program.name}
    run = FusedRun(shard, dev, checkpoint_path, resume, meta,
                   collect_history=collect_history, on_segment=on_segment,
                   thin=thin, history_dtype=history_dtype)
    if run.resumed:
        arrays = run.arrays
        gen = shard.restore_rngs(arrays, generator)
        pools, kde = _agl._pool_from(arrays, dev), _agl._kde_from(arrays,
                                                                  dev)
        theta_k, y_k, logk_k, hat_eps = run.tensors("theta_k", "y_k",
                                                    "logk_k", "hat_eps")
        hat_eps_hist = list(arrays["hat_eps_hist"])
        ep = int(arrays["ep"])
    else:
        th_c, y_c, logk_k = run.initial_chains(problem, generator, theta0,
                                               y0)
        theta_k, y_k = (shard.keep(x.T, dim=1) for x in (th_c, y_c))
        logk_k = shard.keep(logk_k)
        gen = shard.local_generator(generator)
        pools = _agl._init_pools(problem, gen, ip, C, P)
        kde = None
        hat_eps = torch.tensor(1.0e6, device=dev)
        hat_eps_hist = []
        ep = 0
    seed = run.kernel_seed(seed, generator)
    pending_epoch = run.resumed
    resident = (resident_from_gaussian(to_host(ip.loc),
                                       np.exp(to_host(ip.log_scale)),
                                       device=dev)
                if kde is None else resident_from_kde(kde))
    packed = pack(pools)

    total = num_ite - 1
    while run.done < total:
        if pending_epoch:
            # the run's generator, alike on every rank: the sharded epoch
            # draws each rank's redraw generator from it
            pools, kde, hat_eps = epoch_fn(generator, pools, hat_eps)
            hat_eps_hist.append(to_host(hat_eps))
            ep += 1
            with annotate("glabc.epoch.pool"):
                packed = pack(pools)
                resident = resident_from_kde(kde)
            pending_epoch = False
        take = min(seg_len, total - run.done)
        theta_k, y_k, logk_k, gatt, gacc, lacc, hist = kern.run(
            seed, resident, *packed, theta_k, y_k, logk_k, step0=run.done,
            chain0=shard.chain0)
        run.launched(hist, take, seg_len, (gatt, gacc, lacc))
        if take == seg_len:
            pending_epoch = run.done < total
            if run.path is not None:
                state = {"theta_k": theta_k, "y_k": y_k, "logk_k": logk_k,
                         "hat_eps": hat_eps, "ep": ep,
                         **shard.rng_arrays(generator, gen),
                         "hat_eps_hist": np.asarray(hat_eps_hist,
                                                    np.float32)}
                state.update(_agl._pool_arrays(pools))
                state.update(_agl._kde_arrays(kde))
                run.save(state)

    thetas, counts = run.finish(theta_k)
    carry = AGLCarry(theta_k.T.contiguous(), y_k.T.contiguous(), logk_k,
                     torch.zeros(C, dtype=torch.int32, device=dev),
                     gen, counts)
    return AGLResult(
        thetas=thetas, counts=counts, final_carry=carry, kde=kde,
        hat_eps=to_host(hat_eps),
        hat_eps_hist=np.asarray(hat_eps_hist) if hat_eps_hist else None,
        fused_state=(theta_k, y_k, logk_k))
