"""High-level driver of the fused GLMCMC kernel.

Port of ``glabc_tpu/samplers/glmcmc_fused.py``: wraps
:class:`~glabc_tpu_torch.ops.kernels.packed_kernel.PackedMixtureGLMCMC` and
:class:`~glabc_tpu_torch.ops.kernels.mixture_kernel.FusedMixtureGLMCMC` (one
CUDA kernel, two layouts) in the result type of the plain samplers, for
Mixture-family problems (Gaussian prior and proposals,
``y = |theta| + sigma z``).  On CUDA tensors the kernel runs; with
``device='cpu'`` its plain torch version does, with the same random numbers.

The kernel seed is drawn once from the generator (as the JAX driver draws it
from the key); each launch passes the absolute index of its first step, so a
chain's stream does not depend on ``steps_per_call`` or ``block_chains``.

``mesh=`` (a 1-D ``DeviceMesh``, one process per GPU): every rank draws
the initial state of all chains and keeps its contiguous range, packs and
runs it on its own card with its first global chain as the kernel's
``chain0``, and gathers the history and counts over the group: the result
equals the one-device run's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import check_generator, resolve_device
from ..ops.kernels.mixture_kernel import FusedMixtureGLMCMC, fused_state_init
from ..ops.kernels.packed_kernel import PackedMixtureGLMCMC, packed_state_init
from ..utils.profiling import annotate
from ._fused_io import restore_fused_ckpt, save_fused_ckpt, to_host
from ._shard import ChainShard
from .base import MoveCounts, SamplerResult

__all__ = ["run_glmcmc_fused", "run_global_mcmc_fused"]

_SUB = 8


@annotate("glabc.run.glmcmc_fused")
def run_glmcmc_fused(problem, generator, num_ite, theta0, *, y0=None,
                     ip_loc=0.0, ip_scale=1.0, lp_scale=0.35, prior_loc=0.0,
                     prior_scale=1.0, global_frequency=0.9, batch_size=5,
                     num_chains: int = 1024, steps_per_call: int = 256,
                     block_chains: int = 512, collect_history: bool = True,
                     on_segment=None, seed: int | None = None,
                     kernel: str = "auto", mesh=None,
                     algorithm: str = "glmcmc",
                     checkpoint_path: str | None = None,
                     resume: bool = False, device=None) -> SamplerResult:
    """GLMCMC through the fused kernel.  Chains have length ``num_ite``
    with the initial state at index 0.

    ``kernel``: ``'packed'`` (``theta_dim | 8`` and ``num_chains`` a
    multiple of ``8/d``), ``'unpacked'``, or ``'auto'`` (packed when
    ``theta_dim | 8`` and ``num_chains`` is a multiple of
    ``(8/d) * block_chains``, as in the JAX driver).

    ``mesh``: a 1-D ``DeviceMesh``; every rank calls with the same
    arguments and generator seed.  ``num_chains`` must divide by its size
    ``w``; the ``C/w`` chains of a rank take the place of ``num_chains`` in
    the packing rules above (``'auto'`` packs when ``C/w`` is a multiple of
    ``(8/d) * block_chains``, else runs unpacked).  Every rank returns the
    whole result; a checkpoint is one file a rank.

    ``algorithm``: ``'glmcmc'`` (iSIR global move) or ``'global'``
    (independence MH; see :func:`run_global_mcmc_fused`).

    ``checkpoint_path``/``resume``: the loop state is saved after every
    aligned launch; ``resume=True`` continues where the run stopped, with
    only the remaining transitions in the result but whole-run counts.

    Every launch runs ``steps_per_call`` transitions; when ``num_ite - 1`` is
    not a multiple of it, the history is still exactly ``num_ite`` long, the
    final carry is ahead of the last recorded state, and the ragged launch's
    counters are scaled pro rata."""
    shard = ChainShard(num_chains, mesh)
    C_all, num_chains = num_chains, shard.local
    dev = resolve_device(device)
    check_generator(generator, dev)
    d = problem.theta_dim
    sigma = getattr(problem, "_noise_std", None)
    if sigma is None:
        raise ValueError("run_glmcmc_fused supports Mixture-family problems "
                         "(with a Gaussian simulator noise scale); use "
                         "run_glmcmc for other problems")
    pack = _SUB // d if _SUB % d == 0 else 0
    if kernel == "auto":
        kernel = ("packed" if pack and num_chains % (pack * block_chains) == 0
                  else "unpacked")
    if kernel not in ("packed", "unpacked"):
        raise ValueError(f"kernel must be 'auto', 'packed' or 'unpacked', "
                         f"got {kernel!r}")

    ckpt_meta = {"kernel": kernel, "algorithm": algorithm,
                 "num_chains": C_all, "theta_dim": d,
                 "steps_per_call": steps_per_call,
                 "block_chains": block_chains, **shard.meta}
    checkpoint_path = shard.path(checkpoint_path, resume)
    restored = (restore_fused_ckpt(checkpoint_path, ckpt_meta, dev)
                if resume and checkpoint_path is not None else None)
    kwargs = dict(epsilon=problem.epsilon, sigma=sigma,
                  global_frequency=global_frequency, batch_size=batch_size,
                  prior_loc=prior_loc, prior_scale=prior_scale, ip_loc=ip_loc,
                  ip_scale=ip_scale, lp_scale=lp_scale,
                  steps_per_call=steps_per_call, block_chains=block_chains,
                  collect_history=collect_history, algorithm=algorithm)
    y_obs = problem.y_obs.cpu().numpy()

    if kernel == "packed":
        if not pack:
            raise ValueError(f"packed kernel needs theta_dim | 8, got {d}")
        if num_chains % pack:
            raise ValueError(f"num_chains must be a multiple of {pack}")
        num_cols = num_chains // pack
        kern = PackedMixtureGLMCMC(d, y_obs, **kwargs)
        if restored is None:
            state = packed_state_init(problem, generator, theta0, num_cols,
                                      pack, y0=y0, device=dev,
                                      shard=shard.spec)

        def stats_row(x):   # (8, C) leader-row counters -> (pack*C,)
            return (x.reshape(pack, d, num_cols)[:, 0, :].reshape(num_chains)
                    .to(torch.float64))

        def hist_block(hist):   # (take, 8, C) -> (pack*C, take, d)
            return (hist.reshape(-1, pack, d, num_cols).permute(1, 3, 0, 2)
                    .reshape(num_chains, -1, d))
    else:
        kern = FusedMixtureGLMCMC(d, y_obs, **kwargs)
        if restored is None:
            state = fused_state_init(problem, generator, theta0, num_chains,
                                     kern.d_pad, y0=y0, device=dev,
                                     shard=shard.spec)

        def stats_row(x):
            return x[0].to(torch.float64)

        def hist_block(hist):   # (take, d_pad, C) -> (C, take, d)
            return hist[:, :d, :].permute(2, 0, 1)

    def host_block(hist):   # every rank's chains, on the host
        return to_host(shard.gather(hist_block(hist).contiguous()))

    if restored is not None:
        (state, counters, steps_run, call_idx, seed, done) = restored
        g_att, g_acc, l_acc = (torch.as_tensor(c, device=dev)
                               for c in counters)
    else:
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=generator.device))
        g_att, g_acc, l_acc = (torch.zeros(num_chains, dtype=torch.float64,
                                           device=dev) for _ in range(3))
        steps_run = done = call_idx = 0
    theta, y, logk = state
    total = num_ite - 1
    blocks = [host_block(theta[None])] if (collect_history and done == 0) else []
    while done < total:
        theta, y, logk, hist, stats = kern.run(seed, theta, y, logk,
                                               step0=call_idx * kern.T,
                                               chain0=shard.chain0)
        call_idx += 1
        take = min(kern.T, total - done)
        if collect_history:
            block = host_block(hist[:take])
            if on_segment is not None:
                on_segment(block, done)
            blocks.append(block)
        frac = take / kern.T   # the kernel always runs T steps
        g_att += stats_row(stats.global_attempts) * frac
        g_acc += stats_row(stats.global_accepts) * frac
        l_acc += stats_row(stats.local_accepts) * frac
        steps_run += take
        done += take
        if checkpoint_path is not None:
            save_fused_ckpt(checkpoint_path, (theta, y, logk),
                            (g_att, g_acc, l_acc), steps_run, call_idx, seed,
                            done, take, kern.T, meta=ckpt_meta)

    thetas = (np.concatenate(blocks, axis=1) if blocks
              else host_block(theta[None]))
    g_att, g_acc, l_acc = (to_host(shard.gather(c))
                           for c in (g_att, g_acc, l_acc))
    g_att_i = np.rint(g_att).astype(np.int32)
    counts = MoveCounts(
        global_attempts=g_att_i,
        global_accepts=np.rint(g_acc).astype(np.int32),
        local_attempts=(steps_run - g_att_i).astype(np.int32),
        local_accepts=np.rint(l_acc).astype(np.int32),
    )
    return SamplerResult(thetas=thetas, counts=counts,
                         final_carry=(theta, y, logk))


def run_global_mcmc_fused(problem, generator, num_ite, theta0, *, gp_loc=0.0,
                          gp_scale=1.0, lp_scale=0.35,
                          **kwargs) -> SamplerResult:
    """GlobalMCMC (independence-MH global + RW local, reference
    ``GlobalMCMC.py:6-98``) through the fused kernel: the global proposal
    ``N(gp_loc, gp_scale^2 I)`` takes the importance proposal's slot and
    ``batch_size`` is ignored."""
    return run_glmcmc_fused(problem, generator, num_ite, theta0,
                            ip_loc=gp_loc, ip_scale=gp_scale,
                            lp_scale=lp_scale, algorithm="global", **kwargs)
