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

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..models.problems import initial_chains
from ..ops.kernels.generic_glmala_kernel import GenericFusedGLMALA
from ..ops.kernels.generic_kernel import GenericFusedGLMCMC
from ..ops.kernels.program import TileProgram, check_program
from ..utils.profiling import annotate
from ._fused_io import FusedRun
from ._shard import ChainShard
from .base import SamplerResult
from .glmala import synthetic_likelihood_grad

__all__ = ["program_state_init", "run_fused_program", "run_glmala_program",
           "program_grad_init"]

# chains per call of the plain gradient estimator in program_grad_init: its
# 2 d num_grad simulations per chain would not fit at once for a large C
_GRAD_CHUNK = 4096


def program_state_init(problem, generator, theta0, num_chains: int, y0=None,
                       device=None):
    """Initial state in the kernels' layout: theta ``(d, C)``, y
    ``(y_rows, C)``, logk ``(C,)``; each chain's dataset simulated from
    ``theta0`` unless ``y0`` (``(y_dim,)`` broadcast or ``(C, y_dim)``) is
    given."""
    th, y, logk = initial_chains(problem, generator, theta0, num_chains, y0,
                                 device)
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


def _launches(run, kern, launch, state, num_ite, names):
    """The launch loop of both drivers: ``launch(state, step0)`` ->
    ``(state, history, counts)``; ``names`` are the state's checkpoint
    keys."""
    T, total = kern.T, num_ite - 1
    while run.done < total:
        state, hist, counts = launch(state, run.done)
        take = min(T, total - run.done)
        run.launched(hist, take, T, counts)
        if take == T and run.path is not None:
            run.save({**dict(zip(names, state)), "call_idx": run.done // T})
    thetas, counts = run.finish(state[0])
    return SamplerResult(thetas=thetas, counts=counts, final_carry=state)


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
    check_program(problem, program)
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    kern = GenericFusedGLMCMC(
        program, global_frequency=global_frequency, batch_size=batch_size,
        steps_per_call=steps_per_call, block_chains=block_chains,
        collect_history=collect_history, algorithm=algorithm)
    meta = {"kernel": "generic_program", "program": program.name,
            "algorithm": algorithm, "num_chains": shard.total,
            "theta_dim": program.theta_dim, "steps_per_call": kern.T}
    run = FusedRun(shard, dev, checkpoint_path, resume, meta,
                   collect_history=collect_history, on_segment=on_segment)
    names = ("theta", "y", "logk")
    if run.resumed:
        state = run.tensors(*names)
    else:
        th, y, logk = run.initial_chains(problem, generator, theta0, y0)
        state = (shard.keep(th.T, 1), shard.keep(y.T, 1), shard.keep(logk))
    seed = run.kernel_seed(seed, generator)

    def launch(st, step0):
        th, y, lk, hist, stats = kern.run(seed, *st, step0=step0,
                                          chain0=shard.chain0)
        return (th, y, lk), hist, stats[1:]

    return _launches(run, kern, launch, state, num_ite, names)


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
    check_program(problem, program)
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    kern = GenericFusedGLMALA(
        program, epsilon=float(problem.epsilon),
        global_frequency=global_frequency, batch_size=batch_size, tau=tau,
        num_grad=num_grad, fd_step=fd_step, steps_per_call=steps_per_call,
        block_chains=block_chains, collect_history=collect_history,
        coin_mode=coin_mode)
    T = kern.T
    meta = {"kernel": "generic_glmala", "program": program.name,
            "num_chains": shard.total, "theta_dim": program.theta_dim,
            "steps_per_call": T, "num_grad": int(num_grad),
            "coin_mode": coin_mode}
    run = FusedRun(shard, dev, checkpoint_path, resume, meta,
                   collect_history=collect_history, on_segment=on_segment)
    names = ("theta", "y", "logk", "grad")
    if run.resumed:
        state = run.tensors(*names)
    else:
        th, y, logk = run.initial_chains(problem, generator, theta0, y0)
        grad = program_grad_init(problem, generator, th.T, num_grad, fd_step)
        state = (shard.keep(th.T, 1), shard.keep(y.T, 1), shard.keep(logk),
                 shard.keep(grad, 1))
    seed = run.kernel_seed(seed, generator)
    coin_rng = np.random.default_rng(seed)
    for _ in range(run.done // T):   # replay the host coin stream on resume
        coin_rng.random(T)

    def launch(st, step0):
        coins = torch.from_numpy(
            (coin_rng.random(T) < global_frequency).astype(np.int32))
        th, y, lk, gr, hist, inc = kern.run(seed, *st, coins, step0=step0,
                                            chain0=shard.chain0)
        return (th, y, lk, gr), hist, inc[1:]

    return _launches(run, kern, launch, state, num_ite, names)
