"""Drivers of the generic fused kernels over a tile program.

Port of ``glabc_tpu/samplers/fused_program.py``: ``run_fused_program`` runs
GLMCMC or GlobalMCMC (:class:`~glabc_tpu_torch.ops.kernels.generic_kernel.
GenericFusedGLMCMC`, K8) and ``run_glmala_program`` GLMALA
(:class:`~glabc_tpu_torch.ops.kernels.generic_glmala_kernel.
GenericFusedGLMALA`, K9) for any problem lowered to a
:class:`~glabc_tpu_torch.ops.kernels.program.TileProgram`, with the result
type of the plain samplers.  On CUDA tensors the kernels run; with
``device='cpu'`` their plain torch versions do, with the same random
numbers.

As in the port's other fused drivers, one kernel seed is drawn from the
generator and each launch passes the absolute index of its first step, so a
chain's stream depends neither on ``steps_per_call``, ``block_chains`` nor
segmenting.  Every launch runs ``steps_per_call`` transitions: a ragged last
launch's counts are pro rata and the final carry is ahead of the history.

``mesh=`` (a 1-D ``DeviceMesh``, one process per GPU): every rank draws the
initial state (and gradient) of all chains and keeps its contiguous range,
runs it with its first global chain as the kernel's ``chain0`` and gathers
the history and counts: the one-device run's result, bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..ops.kernels.generic_glmala_kernel import GenericFusedGLMALA
from ..ops.kernels.generic_kernel import GenericFusedGLMCMC
from ..ops.kernels.mixture_kernel import _initial_chains
from ..ops.kernels.program import TileProgram
from ..utils.io import carry_path
from ..utils.profiling import annotate
from ._fused_io import restore_epoch_ckpt, save_epoch_ckpt, to_host
from ._shard import ChainShard
from .aglmcmc_fused import _AsyncBlocks, _finish_history, _history, _seed
from .base import MoveCounts, SamplerResult
from .glmala import synthetic_likelihood_grad

__all__ = ["program_state_init", "run_fused_program", "run_glmala_program",
           "program_grad_init"]

# chains per call of the plain gradient estimator in program_grad_init: its
# 2 d num_grad simulations per chain would not fit at once for a large C
_GRAD_CHUNK = 4096


def _check_program(problem, program):
    if not isinstance(program, TileProgram):
        raise TypeError("tile_program must be a glabc_tpu_torch TileProgram "
                        "(a CUDA header and its torch twin), got "
                        f"{type(program).__name__}")
    if program.theta_dim != problem.theta_dim:
        raise ValueError(f"program.theta_dim {program.theta_dim} != "
                         f"problem.theta_dim {problem.theta_dim}")
    if program.y_rows != problem.y_dim:
        raise ValueError(f"program.y_rows {program.y_rows} != "
                         f"problem.y_dim {problem.y_dim}")


def program_state_init(problem, generator, theta0, num_chains: int, y0=None,
                       device=None):
    """Initial state in the kernels' layout: theta ``(d, C)``, y
    ``(y_rows, C)``, logk ``(C,)``; each chain's dataset simulated from
    ``theta0`` unless ``y0`` (``(y_dim,)`` broadcast or ``(C, y_dim)``) is
    given."""
    dev = resolve_device(device)
    th, y, logk = _initial_chains(problem, generator, theta0, num_chains, y0,
                                  dev)
    return th.T.contiguous(), y.T.contiguous(), logk.contiguous()


def program_grad_init(problem, generator, theta, num_grad: int,
                      fd_step: float = 0.1):
    """The initial ``(d, C)`` gradient at the chains ``theta (d, C)``: the
    plain CRN estimator (``synthetic_likelihood_grad``), ``_GRAD_CHUNK``
    chains at a time for any ``C``."""
    th, chunk = theta.T, _GRAD_CHUNK
    parts = [synthetic_likelihood_grad(problem, generator,
                                       th[c0:c0 + chunk].contiguous(),
                                       num_grad, fd_step)
             for c0 in range(0, th.shape[0], chunk)]
    return torch.cat(parts).T.contiguous()


def _loop(kern, run, state, counters, steps_run, done, call_idx, total,
          collect_history, on_segment, async_blocks, blocks, save,
          gather=None):
    """The launch loop shared by both drivers.  ``run(state, step0)`` ->
    ``(state, history, stats)``."""
    T = kern.T
    while done < total:
        state, hist, stats = run(state, call_idx * T, call_idx)
        call_idx += 1
        take = min(T, total - done)
        if collect_history:
            _history(hist, take, done, on_segment, async_blocks, blocks,
                     gather)
        frac = take / T   # the kernel always runs T steps
        for acc, x in zip(counters, stats[1:]):
            acc += x.to(torch.float64) * frac
        steps_run += take
        done += take
        if save is not None:
            save(state, counters, steps_run, call_idx, done, take)
    return state, steps_run


def _result(theta_init_row, blocks, async_blocks, on_segment,
            collect_history, shard, d, counters, steps_run, carry):
    """The run's result: the history (from ``theta_init_row``, None on
    a resume) when it is collected, else every chain's final state ``(C,
    1, d)``; the counters and the final states come to the host through
    ``to_host``."""
    if collect_history:
        thetas = _finish_history(theta_init_row, blocks, async_blocks,
                                 on_segment, True, shard.total, d, None)
    else:
        thetas = to_host(shard.gather(carry[0].T.contiguous()))[:, None, :]
    g_att, g_acc, l_acc = (np.rint(to_host(shard.gather(c))).astype(np.int32)
                           for c in counters)
    counts = MoveCounts(global_attempts=g_att, global_accepts=g_acc,
                        local_attempts=(steps_run - g_att).astype(np.int32),
                        local_accepts=l_acc)
    return SamplerResult(thetas=thetas, counts=counts, final_carry=carry)


def _initial_row(theta, collect_history):
    """The history's first row of every chain, ``(C, 1, d)`` on the host,
    when the history is collected (else None: no copy)."""
    if not collect_history:
        return None
    return to_host(theta.T.contiguous())[:, None, :]


def _init_state(problem, generator, theta0, shard, y0, dev,
                collect_history):
    """Every chain's initial state (the generator moves as on one
    device), the rank's own kept: ``(theta, y, logk)`` in the kernels'
    layout and, when the history is collected, its first row of every
    chain."""
    theta, y, logk = program_state_init(problem, generator, theta0,
                                        shard.total, y0, dev)
    return ((shard.keep(theta, 1), shard.keep(y, 1), shard.keep(logk)),
            _initial_row(theta, collect_history))


def _restore(checkpoint_path, resume, meta):
    if not (resume and checkpoint_path is not None
            and os.path.exists(carry_path(checkpoint_path))):
        return None
    return restore_epoch_ckpt(checkpoint_path, meta)


def _saver(checkpoint_path, names, seed, T, meta):
    if checkpoint_path is None:
        return None

    def save(state, counters, steps_run, call_idx, done, take):
        arrays = dict(zip(names, state))
        arrays.update(g_att=counters[0], g_acc=counters[1],
                      l_acc=counters[2], steps_run=steps_run,
                      call_idx=call_idx, seed=seed)
        save_epoch_ckpt(checkpoint_path, arrays, done, take, T, meta=meta)
    return save


@annotate("glabc.run.fused_program")
def run_fused_program(problem, program: TileProgram, generator, num_ite,
                      theta0, *, y0=None, global_frequency=0.9, batch_size=5,
                      num_chains: int = 1024, steps_per_call: int = 256,
                      block_chains: int = 256, collect_history: bool = True,
                      on_segment=None, seed: int | None = None,
                      algorithm: str = "glmcmc", mesh=None,
                      checkpoint_path: str | None = None,
                      resume: bool = False, device=None) -> SamplerResult:
    """GLMCMC (``algorithm='glmcmc'``) or GlobalMCMC (``'global'``) on a
    tile program through the generic fused kernel.  ``problem`` supplies
    the initial simulation and kernel value; ``program`` is its lowering
    (e.g. ``problem.tile_program()``).  Chains have length ``num_ite`` with
    the initial state at index 0; at ``collect_history=False``, ``thetas``
    is every chain's final state, ``(C, 1, d)``, as in
    :func:`~glabc_tpu_torch.samplers.glmcmc_fused.run_glmcmc_fused`.  The
    call is a ``glabc.run.fused_program`` span, its host copies
    ``glabc.io.*`` spans with their bytes.  ``checkpoint_path``/``resume``:
    the loop state is saved after every whole launch; a resume continues
    bitwise and returns the history after the resume point.  ``mesh``: a 1-D
    ``DeviceMesh``; every rank calls with the same arguments and generator
    seed, ``num_chains`` divides by its size, every rank returns the whole
    result and checkpoints its own chains."""
    _check_program(problem, program)
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    d, C = program.theta_dim, shard.local
    kern = GenericFusedGLMCMC(
        program, global_frequency=global_frequency, batch_size=batch_size,
        steps_per_call=steps_per_call, block_chains=block_chains,
        collect_history=collect_history, algorithm=algorithm)
    meta = {"kernel": "generic_program", "program": program.name,
            "algorithm": algorithm, "num_chains": shard.total,
            "theta_dim": d, "steps_per_call": kern.T, **shard.meta}
    checkpoint_path = shard.path(checkpoint_path, resume)
    restored = _restore(checkpoint_path, resume, meta)
    if restored is None:
        state, theta_init_row = _init_state(problem, generator, theta0,
                                            shard, y0, dev, collect_history)
        seed = _seed(seed, generator)
        counters = [torch.zeros(C, dtype=torch.float64, device=dev)
                    for _ in range(3)]
        steps_run = done = call_idx = 0
    else:
        arrays, done = restored
        t = lambda k: torch.as_tensor(arrays[k], device=dev)
        state = (t("theta"), t("y"), t("logk"))
        counters = [t("g_att"), t("g_acc"), t("l_acc")]
        steps_run, call_idx, seed = (int(arrays["steps_run"]),
                                     int(arrays["call_idx"]),
                                     int(arrays["seed"]))
        theta_init_row = None

    def run(st, step0, _):
        th, y, lk, hist, stats = kern.run(seed, *st, step0=step0,
                                          chain0=shard.chain0)
        return (th, y, lk), hist, stats

    gather = None if mesh is None else shard.gather
    async_blocks, blocks = _AsyncBlocks(gather=gather), []
    state, steps_run = _loop(
        kern, run, state, counters, steps_run, done, call_idx, num_ite - 1,
        collect_history, on_segment, async_blocks, blocks,
        _saver(checkpoint_path, ("theta", "y", "logk"), seed, kern.T, meta),
        gather)
    return _result(theta_init_row, blocks, async_blocks, on_segment,
                   collect_history, shard, d, counters, steps_run, state)


@annotate("glabc.run.glmala_program")
def run_glmala_program(problem, program: TileProgram, generator, num_ite,
                       theta0, *, y0=None, global_frequency=0.8,
                       batch_size=5, tau=0.3, num_grad: int = 100,
                       fd_step: float = 0.1, num_chains: int = 1024,
                       steps_per_call: int = 16, block_chains: int = 256,
                       collect_history: bool = True, on_segment=None,
                       seed: int | None = None, coin_mode: str = "shared",
                       mesh=None, checkpoint_path: str | None = None,
                       resume: bool = False,
                       device=None) -> SamplerResult:
    """GLMALA on a tile program through the generic fused kernel (the
    program's ``discrepancy`` and ``prior_grad`` feed the CRN
    synthetic-likelihood gradient).  The call contract of
    :func:`run_fused_program` (its ``thetas`` at ``collect_history=False``
    too), as a ``glabc.run.glmala_program`` span; ``coin_mode`` as in
    :func:`~glabc_tpu_torch.samplers.glmala_fused.run_glmala_fused`
    (``'shared'`` skips the gradient batch on global steps; its coins come
    from a host numpy stream seeded with the kernel seed, ``steps_per_call``
    per launch, replayed on resume).  The initial gradient is the plain
    estimator (:func:`program_grad_init`), at every chain under ``mesh``
    (the rank keeps its own)."""
    _check_program(problem, program)
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    d, C = program.theta_dim, shard.local
    kern = GenericFusedGLMALA(
        program, epsilon=float(problem.epsilon),
        global_frequency=global_frequency, batch_size=batch_size, tau=tau,
        num_grad=num_grad, fd_step=fd_step, steps_per_call=steps_per_call,
        block_chains=block_chains, collect_history=collect_history,
        coin_mode=coin_mode)
    T = kern.T
    meta = {"kernel": "generic_glmala", "program": program.name,
            "num_chains": shard.total, "theta_dim": d, "steps_per_call": T,
            "num_grad": int(num_grad), "coin_mode": coin_mode, **shard.meta}
    checkpoint_path = shard.path(checkpoint_path, resume)
    restored = _restore(checkpoint_path, resume, meta)
    if restored is None:
        theta, y, logk = program_state_init(problem, generator, theta0,
                                            shard.total, y0, dev)
        grad = program_grad_init(problem, generator, theta, num_grad,
                                 fd_step)
        theta_init_row = _initial_row(theta, collect_history)
        state = (shard.keep(theta, 1), shard.keep(y, 1), shard.keep(logk),
                 shard.keep(grad, 1))
        seed = _seed(seed, generator)
        counters = [torch.zeros(C, dtype=torch.float64, device=dev)
                    for _ in range(3)]
        steps_run = done = call_idx = 0
    else:
        arrays, done = restored
        t = lambda k: torch.as_tensor(arrays[k], device=dev)
        state = (t("theta"), t("y"), t("logk"), t("grad"))
        counters = [t("g_att"), t("g_acc"), t("l_acc")]
        steps_run, call_idx, seed = (int(arrays["steps_run"]),
                                     int(arrays["call_idx"]),
                                     int(arrays["seed"]))
        theta_init_row = None
    coin_rng = np.random.default_rng(seed)
    for _ in range(call_idx):        # replay the host coin stream on resume
        coin_rng.random(T)

    def run(st, step0, _):
        coins = torch.from_numpy(
            (coin_rng.random(T) < global_frequency).astype(np.int32))
        th, y, lk, gr, hist, inc = kern.run(seed, *st, coins, step0=step0,
                                            chain0=shard.chain0)
        return (th, y, lk, gr), hist, inc

    gather = None if mesh is None else shard.gather
    async_blocks, blocks = _AsyncBlocks(gather=gather), []
    state, steps_run = _loop(
        kern, run, state, counters, steps_run, done, call_idx, num_ite - 1,
        collect_history, on_segment, async_blocks, blocks,
        _saver(checkpoint_path, ("theta", "y", "logk", "grad"), seed, T,
               meta), gather)
    return _result(theta_init_row, blocks, async_blocks, on_segment,
                   collect_history, shard, d, counters, steps_run, state)
