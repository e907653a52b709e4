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

import os

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..ops.kernels.glmala_kernel import FusedMixtureGLMALA
from ..ops.kernels.mixture_kernel import _initial_chains
from ..utils.io import carry_path
from ._fused_io import restore_epoch_ckpt, save_epoch_ckpt
from ._shard import ChainShard
from .aglmcmc_fused import _AsyncBlocks, _finish_history, _history, _seed
from .base import MoveCounts, SamplerResult
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
    C, T = shard.local, kern.T
    ckpt_meta = {"kernel": "glmala", "num_chains": shard.total,
                 "theta_dim": d, "steps_per_call": T, "num_grad": num_grad,
                 "coin_mode": coin_mode, **shard.meta}
    checkpoint_path = shard.path(checkpoint_path, resume)
    # restore before the state init, so a resume skips the initial
    # simulations and the gradient batch
    restored = (restore_epoch_ckpt(checkpoint_path, ckpt_meta)
                if resume and checkpoint_path is not None
                and os.path.exists(carry_path(checkpoint_path)) else None)
    if restored is None:
        # every chain's state and gradient: the generator moves as on one
        # device; the rank keeps its own
        th_c, y_c, logk = _initial_chains(problem, generator, theta0,
                                          shard.total, y0, dev)
        grad = shard.keep(grad_init(problem, generator, th_c, num_grad,
                                    fd_step), dim=1)
        theta_init_row = th_c.cpu().numpy()[:, None, :]
        theta, y = (shard.keep(x.T, dim=1) for x in (th_c, y_c))
        logk = shard.keep(logk)
        seed = _seed(seed, generator)
        counters = [torch.zeros(C, dtype=torch.float64, device=dev)
                    for _ in range(3)]
        steps_run = done = call_idx = 0
    else:
        arrays, done = restored
        t = lambda k: torch.as_tensor(arrays[k], device=dev)
        theta, y, logk, grad = t("theta"), t("y"), t("logk"), t("grad")
        counters = [t("g_att"), t("g_acc"), t("l_acc")]
        steps_run, call_idx, seed = (int(arrays["steps_run"]),
                                     int(arrays["call_idx"]),
                                     int(arrays["seed"]))
        theta_init_row = None
    coin_rng = np.random.default_rng(seed)
    for _ in range(call_idx):        # replay the host coin stream on resume
        coin_rng.random(T)

    gather = None if mesh is None else shard.gather
    async_blocks = _AsyncBlocks(gather=gather)
    blocks = []
    total = num_ite - 1
    while done < total:
        coins = torch.from_numpy(
            (coin_rng.random(T) < global_frequency).astype(np.int32))
        theta, y, logk, grad, hist, inc = kern.run(
            seed, theta, y, logk, grad, coins, step0=call_idx * T,
            chain0=shard.chain0)
        call_idx += 1
        take = min(T, total - done)
        if collect_history:
            _history(hist, take, done, on_segment, async_blocks, blocks,
                     gather)
        frac = take / T   # the kernel always runs T steps
        for acc, x in zip(counters, inc[1:]):
            acc += x.to(torch.float64) * frac
        steps_run += take
        done += take
        if checkpoint_path is not None:
            state = {"theta": theta, "y": y, "logk": logk, "grad": grad,
                     "g_att": counters[0], "g_acc": counters[1],
                     "l_acc": counters[2], "steps_run": steps_run,
                     "call_idx": call_idx, "seed": seed}
            save_epoch_ckpt(checkpoint_path, state, done, take, T,
                            meta=ckpt_meta)

    thetas = _finish_history(theta_init_row, blocks, async_blocks,
                             on_segment, collect_history, shard.total, d,
                             None)
    g_att, g_acc, l_acc = (np.rint(shard.gather(c).cpu().numpy())
                           .astype(np.int32) for c in counters)
    counts = MoveCounts(global_attempts=g_att, global_accepts=g_acc,
                        local_attempts=(steps_run - g_att).astype(np.int32),
                        local_accepts=l_acc)
    return SamplerResult(thetas=thetas, counts=counts,
                         final_carry=(theta, y, logk, grad))
