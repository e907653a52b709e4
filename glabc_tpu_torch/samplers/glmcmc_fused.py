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

from .._device import check_generator, resolve_device
from ..ops.kernels.mixture_kernel import FusedMixtureGLMCMC
from ..ops.kernels.packed_kernel import PackedMixtureGLMCMC
from ..utils.profiling import annotate
from ._fused_io import FusedRun
from ._shard import ChainShard
from .base import SamplerResult

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
    with the initial state at index 0; at ``collect_history=False``,
    ``thetas`` is every chain's final state, ``(C, 1, d)``, as in every
    fused driver (``samplers/_fused_io.FusedRun``).

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
    num_chains = shard.local
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
        num_cols, groups = num_chains // pack, pack
        kern = PackedMixtureGLMCMC(d, y_obs, **kwargs)

        def hist_block(hist):   # (n, 8, C) -> (pack*C, n, d)
            return (hist.reshape(-1, pack, d, num_cols).permute(1, 3, 0, 2)
                    .reshape(num_chains, -1, d))
    else:
        kern, groups = FusedMixtureGLMCMC(d, y_obs, **kwargs), 1

        def hist_block(hist):   # (n, d_pad, C) -> (C, n, d)
            return hist[:, :d, :].permute(2, 0, 1)

    meta = {"kernel": kernel, "algorithm": algorithm,
            "num_chains": shard.total, "theta_dim": d,
            "steps_per_call": steps_per_call, "block_chains": block_chains}
    run = FusedRun(shard, dev, checkpoint_path, resume, meta,
                   collect_history=collect_history, on_segment=on_segment,
                   layout=hist_block)
    if run.resumed:
        theta, y, logk = run.tensors("theta", "y", "logk")
    else:
        th, yy, lk = (shard.keep(x) for x in run.initial_chains(
            problem, generator, theta0, y0))
        theta, y = kern.from_chains(th, groups), kern.from_chains(yy, groups)
        logk = kern.from_chains(lk, groups, "logk")
    seed = run.kernel_seed(seed, generator)
    T, total = kern.T, num_ite - 1
    while run.done < total:
        theta, y, logk, hist, stats = kern.run(seed, theta, y, logk,
                                               step0=run.done,
                                               chain0=shard.chain0)
        take = min(T, total - run.done)
        run.launched(hist, take, T, [kern.to_chains(x, groups, aux=True)
                                     for x in stats[1:]])
        if take == T and run.path is not None:
            run.save({"theta": theta, "y": y, "logk": logk,
                      "call_idx": run.done // T})
    thetas, counts = run.finish(theta)
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
