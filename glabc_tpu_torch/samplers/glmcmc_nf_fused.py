"""GLMCMC-NF with the reference's proposal pools: the pooled driver (any
global frequency) and the fused driver (global frequency 1).

Port of ``glabc_tpu/samplers/glmcmc_nf_fused.py`` (reference
``GLMCMC_NFs.py:70-140``):

* each epoch draws ``batch_size * pool_slices`` flow proposals per chain in
  one push of the flow (the K7 kernel on the card), simulates and weights
  them (``:70-86``);
* global moves are iSIR over the pool, one ``batch_size`` slice per move
  (``:93-111``); the current state's flow density is one pull of the flow
  (K7) over all chains per step (``:98``);
* when a segment ends the flow takes one Adam step of forward KL on an
  importance resample of the pool the chains consumed (``:114-124``), then
  the pool is redrawn from the updated flow (``:125-140``).

Pool cadence (``cadence``): ``'cursor'`` consumes slice ``kk`` of each
chain's pool (its private cursor, advanced on global moves) over a pool of
``step_size + slack`` slices; ``'slice'`` gives step ``t`` of a segment
slice ``t`` and skips it on a local step, over a pool of ``round(step_size
/ gf)`` slices, training on the whole pool (the same cadence as the mixed
AGLMCMC kernel).  ``shared_coin=True`` draws one coin per step for all
chains, so local steps skip the flow pull.

At ``global_frequency == 1`` (:func:`run_glmcmc_nf_fused`) every step is a
pool-iSIR move and the segment runs in the pool-iSIR kernel (K3); the
carried state log-weight is a pool candidate's between epochs, and is
recomputed under the new flow once per epoch by one K7 pull, as in
:func:`~glabc_tpu_torch.samplers.aglmcmc_fused.run_aglmcmc_fused`.

The training resample normalises its weights in float64: at 32,768 chains
the pool holds 3.3e7 rows whose mean weight lies below half an ulp of a
float32 running sum near 1 (PERF.md, the float32-CDF fault of the shared
AGLMCMC epoch).  The JAX drivers' ``flow_backend`` and ``chunk_rows`` have
no counterpart: on the card every flow evaluation outside training is K7,
whose activations never reach device memory, so the pool is pushed whole.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..ops.kernels.pool_isir_kernel import (PoolISIR, pack_pool_logw,
                                            pack_pool_theta)
from ..ops.resampling import categorical_from_log_weights, systematic_resample
from ._fused_io import restore_epoch_ckpt, save_epoch_ckpt
from .aglmcmc import (AGLCarry, Pool, _pool_arrays, _pool_from,
                      _pool_from_proposals, default_pool_slack)
from .aglmcmc_fused import (_AsyncBlocks, _finish_history, _history,
                            _history_opts, _resolve, _seed)
from .base import MoveCounts, _select, local_rw_move
from .chain import init_chain_carry
from .glmcmc_nf import (GLMCMCNFConfig, NFResult, adam_step,
                        flow_state_arrays, flow_state_from_arrays,
                        make_optimizer, new_flow)

__all__ = ["make_nf_pool_fn", "make_pool_trainer", "run_glmcmc_nf_pooled",
           "run_glmcmc_nf_fused"]


def make_nf_pool_fn(problem, num_chains: int, pool_slices: int,
                    batch_size: int):
    """``pool_fn(flow, generator) -> Pool`` of ``num_chains x pool_slices
    * batch_size`` flow proposals, simulated and weighted at the target
    epsilon (``GLMCMC_NFs.py:70-86``), in one push of the flow."""
    C, P = num_chains, pool_slices * batch_size

    def pool_fn(flow, generator) -> Pool:
        th, log_q = flow(C * P, generator)
        return _pool_from_proposals(problem, generator,
                                    th.reshape(C, P, -1), log_q.reshape(C, P))

    return pool_fn


def make_pool_trainer(cfg: GLMCMCNFConfig, num_chains: int,
                      max_train: int = 65536):
    """One reference training epoch on the pool (``GLMCMC_NFs.py:114-124``):
    resample ``min(C * step_size * batch_size, max_train)`` rows of the
    first ``step_size`` slices by their MCMC weights, one Adam step of
    forward KL.  Returns ``train(flow, opt, pools, generator) -> loss``."""
    P_train = cfg.step_size * cfg.batch_size
    n_train = min(num_chains * P_train, max_train)

    def train(flow, opt, pools: Pool, generator):
        d = pools.theta.shape[-1]
        theta = pools.theta[:, :P_train].reshape(-1, d)
        w = torch.exp(pools.log_w[:, :P_train].reshape(-1).to(torch.float64))
        w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
        idx = systematic_resample(w / torch.sum(w), n_train, generator)
        return adam_step(flow, opt, theta[idx])

    return train


# ------------------------------------------------------------ pooled steps
def _global_move(problem, pools: Pool, logq_old, carry: AGLCarry, B: int,
                 pool_slices: int, cadence: str, t: int):
    """iSIR over each chain's pool slice (``GLMCMC_NFs.py:93-111``) given
    the current states' flow log-density ``logq_old (C,)``.  Returns the
    new carry fields ``(theta, y, log_kernel, accepted)``."""
    theta, y, lk = carry.theta, carry.y, carry.log_kernel
    C = theta.shape[0]
    dev = theta.device
    if cadence == "slice":
        s = min(t, pool_slices - 1) * B
        th_s, x_s, dis_s, lw_s = (a[:, s:s + B] for a in (
            pools.theta, pools.x, pools.dis, pools.log_w))
    else:
        start = torch.clamp(carry.kk, max=pool_slices - 1).to(torch.int64) * B
        idx = start[:, None] + torch.arange(B, device=dev)
        take = lambda a: torch.gather(
            a, 1, idx.reshape(C, B, *([1] * (a.dim() - 2))).expand(
                C, B, *a.shape[2:]))
        th_s, x_s, dis_s, lw_s = (take(pools.theta), take(pools.x),
                                  take(pools.dis), take(pools.log_w))
    log_w_old = problem.prior_log_prob(theta) + lk - logq_old
    ind = categorical_from_log_weights(
        torch.cat([log_w_old[:, None], lw_s], dim=1), carry.generator)
    rows = torch.arange(C, device=dev)
    return (torch.cat([theta[:, None], th_s], dim=1)[rows, ind],
            torch.cat([y[:, None], x_s], dim=1)[rows, ind],
            torch.cat([lk[:, None], problem.kernel_log_prob(dis_s)],
                      dim=1)[rows, ind],
            ind != 0)


def _pooled_segment(problem, local_proposal, cfg: GLMCMCNFConfig, flow,
                    pools: Pool, carry: AGLCarry, length: int,
                    pool_slices: int, shared_coin: bool, cadence: str,
                    hist: Optional[torch.Tensor]):
    """``length`` steps of every chain over the pools; writes each step's
    states into ``hist (length, d, C)``.  Per-chain coins evaluate the flow
    every step; a shared coin only on global steps."""
    gen = carry.generator
    C = carry.theta.shape[0]
    dev = carry.theta.device
    gf, B = cfg.global_frequency, cfg.batch_size
    shared = (torch.rand(length, generator=gen, device=dev) < gf).tolist() \
        if shared_coin else None
    for t in range(length):
        if shared is not None:
            is_global = torch.full((C,), shared[t], dtype=torch.bool,
                                   device=dev)
        else:
            is_global = torch.rand(C, generator=gen, device=dev) < gf
        if shared is None or shared[t]:
            g = _global_move(problem, pools, flow.log_prob(carry.theta),
                             carry, B, pool_slices, cadence, t)
        if shared is None or not shared[t]:
            loc = local_rw_move(problem, local_proposal, gen, carry.theta,
                                carry.y, carry.log_kernel,
                                cfg.support_retries)
        if shared is None:
            new = [_select(is_global, a, b) for a, b in zip(g, loc)]
        else:
            new = list(g if shared[t] else loc)
        carry = AGLCarry(*new[:3], carry.kk + is_global.to(carry.kk.dtype),
                         gen, carry.counts.update(is_global, new[3]))
        if hist is not None:
            hist[t] = carry.theta.T
    return carry


def _nf_arrays(flow, opt, pools, num_train, losses, generator):
    state = flow_state_arrays(flow, opt)
    state.update(_pool_arrays(pools))
    state.update(num_train=num_train, rng_state=generator.get_state(),
                 losses=np.asarray([float(x) for x in losses], np.float64))
    return state


def run_glmcmc_nf_pooled(problem, generator, num_ite, theta0, local_proposal,
                         base=None, global_frequency=0.5, batch_size=5,
                         step_size=200, train_steps=50, y0=None,
                         num_chains: int = 1, n_layers: int = 32,
                         hidden: int = 128, on_segment=None, flow=None,
                         support_retries: int = 0, shared_coin: bool = False,
                         pool_slack: Optional[int] = None,
                         max_train: int = 65536,
                         learning_rate: float = 5e-4,
                         weight_decay: float = 1e-5,
                         checkpoint_path: str | None = None,
                         resume: bool = False, cadence: str = "cursor",
                         collect_history: bool = True, thin: int = 1,
                         history_dtype=None, mesh=None,
                         device=None) -> NFResult:
    """GLMCMC-NF over per-epoch flow pools (reference pool semantics).
    Chains have length ``num_ite`` with the initial state at index 0.

    ``cadence``: ``'cursor'`` (default) or ``'slice'`` (see the module
    docstring).  ``pool_slack``: extra slices of a cursor pool (default ~5
    sigma of the binomial overshoot of a segment).  ``thin``/
    ``history_dtype`` compress the history copy (not with ``on_segment``).
    ``checkpoint_path``/``resume``: the flow, Adam's state, the pools, the
    carry and the generator are saved after every whole segment; a resume
    replays the next epoch and continues bitwise."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-GPU chain sharding) is not ported yet (ROADMAP "
            "Queue 1, M12)")
    if cadence not in ("cursor", "slice"):
        raise ValueError(f"cadence must be 'cursor' or 'slice', got "
                         f"{cadence!r}")
    dev = resolve_device(device)
    check_generator(generator, dev)
    cfg = GLMCMCNFConfig(global_frequency, batch_size, step_size, train_steps,
                         n_layers, hidden, learning_rate, weight_decay,
                         support_retries)
    gf = float(global_frequency)
    seg_len = (max(1, int(round(step_size / gf))) if gf > 0
               else num_ite - 1)
    if cadence == "slice":
        pool_slices = seg_len
    else:
        if pool_slack is None:
            pool_slack = default_pool_slack(step_size, gf)
        pool_slices = step_size + pool_slack
    C, d = num_chains, problem.theta_dim
    local_proposal = local_proposal.to(dev)
    thin, hist_dt = _history_opts(thin, history_dtype, on_segment)
    pool_fn = make_nf_pool_fn(problem, C, pool_slices, batch_size)
    train = make_pool_trainer(cfg, C, max_train)

    ckpt_meta = {"sampler": "glmcmc_nf_pooled", "num_chains": C,
                 "theta_dim": d, "seg_len": seg_len,
                 "pool_slices": pool_slices, "batch_size": batch_size,
                 "n_layers": n_layers, "hidden": hidden, "cadence": cadence}
    restored = (restore_epoch_ckpt(checkpoint_path, ckpt_meta)
                if resume and checkpoint_path is not None else None)
    if restored is None:
        flow = new_flow(problem, generator, base, n_layers, hidden, flow, dev)
        opt = make_optimizer(flow, cfg)
        cc = init_chain_carry(problem, generator, theta0, y0, C, dev)
        carry = AGLCarry(cc.theta, cc.y, cc.log_kernel,
                         torch.zeros(C, dtype=torch.int32, device=dev),
                         generator, cc.counts)
        theta_init_row = cc.theta.cpu().numpy()[:, None, :]
        pools = pool_fn(flow, generator)
        losses, num_train, done = [], 0, 0
        pending_epoch = False
    else:
        arrays, done = restored
        t_ = lambda k: torch.as_tensor(arrays[k], device=dev)
        flow, opt = flow_state_from_arrays(arrays, cfg, dev)
        generator.set_state(torch.as_tensor(arrays["rng_state"]))
        pools = _pool_from(arrays, dev)
        carry = AGLCarry(t_("theta"), t_("y"), t_("log_kernel"), t_("kk"),
                         generator,
                         MoveCounts(*(t_(f"counts.{k}")
                                      for k in MoveCounts._fields)))
        losses = [float(x) for x in np.asarray(arrays["losses"]).ravel()]
        num_train = int(arrays["num_train"])
        theta_init_row = None
        pending_epoch = True

    async_blocks = _AsyncBlocks(thin, hist_dt)
    blocks = []
    total = num_ite - 1
    while done < total:
        if pending_epoch:
            # pool exhausted: train on it, then redraw from the updated flow
            # (GLMCMC_NFs.py:112-140; the redraw goes on after Train_step)
            if num_train < train_steps:
                losses.append(train(flow, opt, pools, generator))
                num_train += 1
            pools = pool_fn(flow, generator)
            carry = carry._replace(kk=torch.zeros_like(carry.kk))
            pending_epoch = False
        take = min(seg_len, total - done)
        hist = (torch.empty((take, d, C), dtype=torch.float32, device=dev)
                if collect_history else None)
        carry = _pooled_segment(problem, local_proposal, cfg, flow, pools,
                                carry, take, pool_slices, shared_coin,
                                cadence, hist)
        if collect_history:
            _history(hist, take, done, on_segment, async_blocks, blocks)
        done += take
        if take == seg_len:
            if done < total:
                pending_epoch = True
            if checkpoint_path is not None:
                state = _nf_arrays(flow, opt, pools, num_train, losses,
                                   generator)
                state.update(theta=carry.theta, y=carry.y,
                             log_kernel=carry.log_kernel, kk=carry.kk)
                state.update({f"counts.{k}": v
                              for k, v in carry.counts._asdict().items()})
                save_epoch_ckpt(checkpoint_path, state, done, take, seg_len,
                                meta=ckpt_meta)

    thetas = _finish_history(theta_init_row, blocks, async_blocks,
                             on_segment, collect_history, C, d, hist_dt)
    return NFResult(thetas=thetas, counts=carry.counts.numpy(),
                    final_carry=carry, flow=flow,
                    loss_hist=np.asarray([float(x) for x in losses]))


def run_glmcmc_nf_fused(problem, generator, num_ite, theta0,
                        local_proposal=None, base=None, batch_size=5,
                        step_size=200, train_steps=50, y0=None,
                        num_chains: int = 4096, n_layers: int = 32,
                        hidden: int = 128, block_chains: int = 256,
                        collect_history: bool = True, on_segment=None,
                        flow=None, seed: int | None = None,
                        max_train: int = 65536, learning_rate: float = 5e-4,
                        weight_decay: float = 1e-5, mesh=None,
                        checkpoint_path: str | None = None,
                        resume: bool = False, thin: int = 1,
                        history_dtype=None, device=None) -> NFResult:
    """GLMCMC-NF at ``global_frequency = 1`` through the pool-iSIR kernel
    (K3): every transition is iSIR over a pool slice, so a segment of
    ``step_size`` steps is one launch; pools (one K7 push each), training
    and the once-per-epoch state log-weight (one K7 pull) run between
    launches.  The driver contract of
    :func:`~glabc_tpu_torch.samplers.aglmcmc_fused.run_aglmcmc_fused`: a
    history of exactly ``num_ite`` rows, a final carry that may be ahead on
    a ragged last segment, whose counts are pro rata."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-GPU chain sharding) is not ported yet (ROADMAP "
            "Queue 1, M12)")
    del local_proposal  # gf=1: no local moves
    dev = resolve_device(device)
    check_generator(generator, dev)
    d = problem.theta_dim
    T, B, C = int(step_size), int(batch_size), int(num_chains)
    cfg = GLMCMCNFConfig(1.0, B, T, train_steps, n_layers, hidden,
                         learning_rate, weight_decay)
    kern = PoolISIR(d, batch_size=B, steps_per_call=T,
                    block_chains=block_chains,
                    collect_history=collect_history)
    pool_fn = make_nf_pool_fn(problem, C, T, B)
    train = make_pool_trainer(cfg, C, max_train)
    thin, hist_dt = _history_opts(thin, history_dtype, on_segment)

    def state_logw(flow_, theta_k, logk):
        """The carried log-weight under the current flow: the reference's
        per-global-move recompute (``GLMCMC_NFs.py:98-101``) once per epoch
        (between epochs the state is a pool candidate, whose weight the
        kernel carries)."""
        th = theta_k.T.contiguous()
        return (problem.prior_log_prob(th) + logk
                - flow_.log_prob(th)).contiguous()

    ckpt_meta = {"sampler": "glmcmc_nf_fused", "num_chains": C,
                 "theta_dim": d, "steps_per_call": T, "batch_size": B,
                 "n_layers": n_layers, "hidden": hidden}
    restored = (restore_epoch_ckpt(checkpoint_path, ckpt_meta)
                if resume and checkpoint_path is not None else None)
    if restored is None:
        flow = new_flow(problem, generator, base, n_layers, hidden, flow, dev)
        opt = make_optimizer(flow, cfg)
        cc = init_chain_carry(problem, generator, theta0, y0, C, dev)
        pools = pool_fn(flow, generator)
        theta_k = cc.theta.T.contiguous()
        y_cur, logk = cc.y, cc.log_kernel
        logw_k = state_logw(flow, theta_k, logk)
        theta_init_row = cc.theta.cpu().numpy()[:, None, :]
        seed = _seed(seed, generator)
        g_acc = torch.zeros(C, dtype=torch.float64, device=dev)
        losses, num_train = [], 0
        done = steps_run = 0
        pending_epoch = False
    else:
        arrays, done = restored
        t_ = lambda k: torch.as_tensor(arrays[k], device=dev)
        flow, opt = flow_state_from_arrays(arrays, cfg, dev)
        generator.set_state(torch.as_tensor(arrays["rng_state"]))
        pools = _pool_from(arrays, dev)
        theta_k, logw_k, y_cur, logk = (t_("theta_k"), t_("logw_k"),
                                        t_("y_cur"), t_("logk"))
        g_acc = t_("g_acc")
        steps_run, seed = int(arrays["steps_run"]), int(arrays["seed"])
        losses = [float(x) for x in np.asarray(arrays["losses"]).ravel()]
        num_train = int(arrays["num_train"])
        theta_init_row = None
        pending_epoch = True

    async_blocks = _AsyncBlocks(thin, hist_dt)
    blocks = []
    total = num_ite - 1
    packed = None
    while done < total:
        if pending_epoch:
            if num_train < train_steps:
                losses.append(train(flow, opt, pools, generator))
                num_train += 1
            pools = pool_fn(flow, generator)
            packed = None
            logw_k = state_logw(flow, theta_k, logk)
            pending_epoch = False
        if packed is None:
            packed = (pack_pool_theta(pools.theta, T, B),
                      pack_pool_logw(pools.log_w, T, B))
        take = min(T, total - done)
        theta_k, logw_k, sel, moved, hist = kern.run(
            seed, *packed, theta_k, logw_k, step0=done)
        if collect_history:
            _history(hist, take, done, on_segment, async_blocks, blocks)
        y_cur, logk = _resolve(problem, pools, sel, y_cur, logk)
        g_acc += moved.to(torch.float64) * (take / T)
        steps_run += take
        done += take
        if take == T:
            if done < total:
                pending_epoch = True
            if checkpoint_path is not None:
                state = _nf_arrays(flow, opt, pools, num_train, losses,
                                   generator)
                state.update(theta_k=theta_k, logw_k=logw_k, y_cur=y_cur,
                             logk=logk, g_acc=g_acc, steps_run=steps_run,
                             seed=seed)
                save_epoch_ckpt(checkpoint_path, state, done, take, T,
                                meta=ckpt_meta)

    thetas = _finish_history(theta_init_row, blocks, async_blocks,
                             on_segment, collect_history, C, d, hist_dt)
    counts = MoveCounts(
        global_attempts=np.full((C,), steps_run, np.int32),
        global_accepts=np.rint(g_acc.cpu().numpy()).astype(np.int32),
        local_attempts=np.zeros((C,), np.int32),
        local_accepts=np.zeros((C,), np.int32))
    carry = AGLCarry(theta_k.T.contiguous(), y_cur, logk,
                     torch.zeros(C, dtype=torch.int32, device=dev),
                     generator, counts)
    return NFResult(thetas=thetas, counts=counts, final_carry=carry,
                    flow=flow,
                    loss_hist=np.asarray([float(x) for x in losses]),
                    fused_state=(theta_k, y_cur, logk, logw_k))
