"""High-level driver of the fused GLMALA kernel (K6).

Port of ``glabc_tpu/samplers/glmala_fused.py``: wraps
:class:`~glabc_tpu_torch.ops.kernels.glmala_kernel.FusedMixtureGLMALA` in
the result type of the plain samplers, for Mixture-family problems
(Gaussian prior and importance proposal, ``y = |theta| + sigma z``,
``theta_dim`` in {1, 2, 4, 8}).  On CUDA tensors the kernel runs; with
``device='cpu'`` its plain torch version does, with the same random
numbers.

The kernel seed is drawn once from the generator; each launch passes the
absolute index of its first step, so a chain's stream does not depend on
``steps_per_call``, ``block_chains`` or segmenting.  Shared coins come from
a host ``numpy`` stream seeded with the kernel seed, ``steps_per_call`` per
launch (the JAX driver's), replayed on resume.

``mesh=``: every rank draws the initial state and gradient of all chains
and keeps its contiguous range, draws the same shared coins, runs its range
with its first global chain as the kernel's ``chain0`` and gathers the
history and counts: the one-device run's result, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..ops.kernels.glmala_kernel import FusedMixtureGLMALA
from ._fused_io import FusedRun
from ._shard import ChainShard
from .base import SamplerResult
from .glmala import synthetic_likelihood_grad

__all__ = ["run_glmala_fused", "grad_init"]


def grad_init(problem, generator, theta_cd, num_grad: int,
              fd_step: float = 0.1) -> torch.Tensor:
    """The initial ``(d, C)`` gradient: the plain CRN finite-difference
    estimator at each chain's ``theta (C, d)`` (the reference's lazy
    first-use initialisation, ``GLMALA.py:183-184``; the JAX driver's
    ``packed_grad_init``)."""
    return synthetic_likelihood_grad(problem, generator, theta_cd, num_grad,
                                     fd_step).T.contiguous()


def run_glmala_fused(problem, generator, num_ite, theta0, *, y0=None,
                     ip_loc=0.0, ip_scale=1.0, prior_loc=0.0,
                     prior_scale=1.0, global_frequency=0.8, batch_size=5,
                     tau=0.3, num_grad=100, fd_step=0.1,
                     num_chains: int = 2048, steps_per_call: int = 32,
                     block_chains: int | None = None,
                     collect_history: bool = True,
                     coin_mode: str = "shared", on_segment=None,
                     seed: int | None = None, mesh=None,
                     checkpoint_path: str | None = None,
                     resume: bool = False, device=None) -> SamplerResult:
    """GLMALA through the fused kernel.  Chains have length ``num_ite``
    with the initial state at index 0, as on the plain path.

    ``coin_mode='shared'`` (default) draws one global/local coin per step
    for all chains, so global steps skip the gradient batch; ``'per_chain'``
    gives every chain its own coin, the reference semantics.

    Every launch runs ``steps_per_call`` transitions: when ``num_ite - 1``
    is not a multiple of it, the history is still exactly ``num_ite`` long,
    the final carry is ahead of it, and the last launch's counts are pro
    rata.  ``checkpoint_path``/``resume``: the loop state is saved after
    every whole launch; a resume continues bitwise and returns the history
    after the resume point.

    ``mesh``: a 1-D ``DeviceMesh``; every rank calls with the same
    arguments and generator seed, ``num_chains`` divides by its size, every
    rank returns the whole result and checkpoints its own chains."""
    shard = ChainShard(num_chains, mesh)
    dev = resolve_device(device)
    check_generator(generator, dev)
    d = problem.theta_dim
    sigma = getattr(problem, "_noise_std", None)
    if sigma is None:
        raise ValueError(
            "run_glmala_fused supports Mixture-family problems (with a "
            "Gaussian simulator noise scale); use run_glmala for other "
            "problems")
    if problem.y_dim != d:
        raise ValueError("Mixture-family kernels require y_dim == theta_dim")
    kern = FusedMixtureGLMALA(
        d, problem.y_obs.cpu().numpy(), epsilon=problem.epsilon, sigma=sigma,
        global_frequency=global_frequency, batch_size=batch_size, tau=tau,
        num_grad=num_grad, fd_step=fd_step, prior_loc=prior_loc,
        prior_scale=prior_scale, ip_loc=ip_loc, ip_scale=ip_scale,
        steps_per_call=steps_per_call, block_chains=block_chains,
        collect_history=collect_history, coin_mode=coin_mode)
    T = kern.T
    meta = {"kernel": "glmala", "num_chains": shard.total, "theta_dim": d,
            "steps_per_call": T, "num_grad": num_grad,
            "coin_mode": coin_mode}
    # restore before the state init, so a resume skips the initial
    # simulations and the gradient batch
    run = FusedRun(shard, dev, checkpoint_path, resume, meta,
                   collect_history=collect_history, on_segment=on_segment)
    if run.resumed:
        theta, y, logk, grad = run.tensors("theta", "y", "logk", "grad")
    else:
        # every chain's state and gradient: the generator moves as on one
        # device; the rank keeps its own
        th_c, y_c, logk = run.initial_chains(problem, generator, theta0, y0)
        grad = shard.keep(grad_init(problem, generator, th_c, num_grad,
                                    fd_step), dim=1)
        theta, y = (shard.keep(x.T, dim=1) for x in (th_c, y_c))
        logk = shard.keep(logk)
    seed = run.kernel_seed(seed, generator)
    coin_rng = np.random.default_rng(seed)
    for _ in range(run.done // T):   # replay the host coin stream on resume
        coin_rng.random(T)

    total = num_ite - 1
    while run.done < total:
        coins = torch.from_numpy(
            (coin_rng.random(T) < global_frequency).astype(np.int32))
        theta, y, logk, grad, hist, inc = kern.run(
            seed, theta, y, logk, grad, coins, step0=run.done,
            chain0=shard.chain0)
        take = min(T, total - run.done)
        run.launched(hist, take, T, inc[1:])
        if take == T and run.path is not None:
            run.save({"theta": theta, "y": y, "logk": logk, "grad": grad,
                      "call_idx": run.done // T})
    thetas, counts = run.finish(theta)
    return SamplerResult(thetas=thetas, counts=counts,
                         final_carry=(theta, y, logk, grad))
