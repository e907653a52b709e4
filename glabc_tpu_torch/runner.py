"""MCMCRunner: the user-facing facade of the port.

Port of ``glabc_tpu/runner.py`` (reference ``glabcmcmc/MCMCRunner.py:6-121``):
same method names and argument order, output-directory management, CSV
writing and end-of-run summary, plus ``num_chains``, a seed, and an explicit
``device``.  The runner holds one ``torch.Generator`` on its device; each run
draws a fresh child generator from it unless one is passed.

All five methods are ported.  ``run_global_mcmc``, ``run_glmcmc``,
``run_aglmcmc`` and ``run_glmala`` take ``method='scan'`` (the plain torch
path) or ``method='fused'`` (the CUDA kernels); ``run_glmcmc_nf`` takes
``'pooled'`` (default), ``'fused'`` or ``'scan'``, routed as in the JAX
runner.  ``tile_program=`` (the generic TileProgram kernels) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .ops.stats import chain_summary
from .samplers.aglmcmc import run_aglmcmc
from .samplers.aglmcmc_fused import run_aglmcmc_fused
from .samplers.glmala import run_glmala
from .samplers.glmala_fused import run_glmala_fused
from .samplers.glmcmc import run_glmcmc
from .samplers.glmcmc_fused import run_global_mcmc_fused, run_glmcmc_fused
from .samplers.glmcmc_nf import run_glmcmc_nf
from .samplers.glmcmc_nf_fused import (run_glmcmc_nf_fused,
                                       run_glmcmc_nf_pooled)
from .samplers.global_mcmc import run_global_mcmc
from .utils.io import ChainWriter

__all__ = ["MCMCRunner"]


class MCMCRunner:
    def __init__(self, abc_set, output_dir: str = "./", seed: int = 0,
                 num_chains: int = 1, verbose: bool = True,
                 write_chains=None, segment_size: int = 10_000,
                 use_native_io: bool = False, device=None):
        """
        Args:
            abc_set: ABC problem (``glabc_tpu_torch.models.ABCProblem``).
            output_dir: directory for result CSVs (created if missing).
            seed: seed of the runner's generator.
            num_chains: parallel chains.
            write_chains: chains that reach CSV: None (chain 0, reference
                format), 'all', or an index list.
            verbose: print the reference-style summary after each run.
            device: where the runs go; default the current CUDA device.
        """
        if use_native_io:
            raise NotImplementedError(
                "use_native_io: the native chain writer is not ported yet "
                "(ROADMAP Queue 1, M13)")
        self.device = resolve_device(device)
        self.abc_set = abc_set
        self.output_dir = output_dir
        self.num_chains = num_chains
        self.verbose = verbose
        self.write_chains = write_chains
        self.segment_size = segment_size
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._open_writers = []
        # the latest run's SamplerResult (chains and per-chain move counts)
        self.last_result = None
        os.makedirs(output_dir, exist_ok=True)

    # ------------------------------------------------------------ plumbing
    def _next_generator(self, generator) -> torch.Generator:
        if generator is not None:
            return generator
        child = int(torch.randint(0, 2**62, (1,), generator=self._gen,
                                  device=self.device))
        g = torch.Generator(device=self.device)
        g.manual_seed(child)
        return g

    def _writer(self, output_file: Optional[str], theta0):
        if output_file is None:
            return None
        writer = ChainWriter(os.path.join(self.output_dir, output_file),
                             chains=self.write_chains)
        theta0 = np.asarray(theta0, np.float32)
        if theta0.ndim == 1:
            theta0 = np.broadcast_to(theta0, (self.num_chains, theta0.shape[0]))
        writer.write_initial(theta0)
        self._open_writers.append(writer)
        return writer.on_segment

    def _finish(self, result, sampler_name: str):
        self.last_result = result
        for w in self._open_writers:
            w.close()
        self._open_writers.clear()
        if self.verbose:
            rates = result.acceptance_rates()
            summary = chain_summary(
                result.thetas, acceptance_rate=float(rates["overall"].mean()),
                with_rhat=result.thetas.shape[0] >= 2)
            print(f"[{sampler_name}] {result.thetas.shape[0]} chain(s) x "
                  f"{result.thetas.shape[1]} iterations")
            print(summary.render())
            print(f"Acceptance (global/local): "
                  f"{float(rates['global'].mean()):.4f} / "
                  f"{float(rates['local'].mean()):.4f}")
        chains = result.thetas
        return chains[0] if chains.shape[0] == 1 else chains

    @staticmethod
    def _isotropic(dist, name: str):
        """Scalar (loc, scale) of a DiagGaussian; the fused kernel takes
        isotropic Gaussian proposals."""
        loc = dist.loc.detach().cpu().numpy()
        scale = np.exp(dist.log_scale.detach().cpu().numpy())
        if not (np.all(loc == loc.flat[0]) and np.all(scale == scale.flat[0])):
            raise ValueError(f"method='fused' needs an isotropic {name} "
                             "(constant loc/scale across dims); use "
                             "method='scan'")
        return float(loc.flat[0]), float(scale.flat[0])

    # ------------------------------------------------------------- runners
    def run_global_mcmc(self, num_iterations, initial_theta, initial_y,
                        global_frequency, local_proposal, global_proposal,
                        output_file: Optional[str] = "global_mcmc_results.csv",
                        generator=None, method: str = "scan", **kwargs):
        """GlobalMCMC (reference ``MCMCRunner.py:17-33``).  ``method='fused'``
        runs the fused kernel with the independence-MH global move."""
        on_segment = self._writer(output_file, initial_theta)
        gen = self._next_generator(generator)
        if method == "fused":
            gp_loc, gp_scale = self._isotropic(global_proposal,
                                               "global proposal")
            _, lp_scale = self._isotropic(local_proposal, "local proposal")
            res = run_global_mcmc_fused(
                self.abc_set, gen, num_iterations, initial_theta,
                y0=initial_y, gp_loc=gp_loc, gp_scale=gp_scale,
                lp_scale=lp_scale, global_frequency=global_frequency,
                num_chains=self.num_chains, on_segment=on_segment,
                device=self.device, **kwargs)
        elif method == "scan":
            res = run_global_mcmc(
                self.abc_set, gen, num_iterations, initial_theta,
                global_proposal, local_proposal, global_frequency,
                y0=initial_y, num_chains=self.num_chains,
                segment_size=self.segment_size, on_segment=on_segment,
                device=self.device, **kwargs)
        else:
            raise ValueError(f"method must be 'scan' or 'fused', got {method!r}")
        return self._finish(res, "GlobalMCMC")

    def run_glmcmc(self, num_iterations, initial_theta, initial_y,
                   global_frequency, local_proposal, importance_proposal,
                   batch_size, output_file: Optional[str] = "glmcmc_results.csv",
                   generator=None, method: str = "scan", **kwargs):
        """GLMCMC (reference ``MCMCRunner.py:35-53``).  ``method='fused'``
        runs the fused CUDA kernel (Mixture-family problems, isotropic
        Gaussian proposals); ``'scan'`` the plain torch path for any
        problem."""
        on_segment = self._writer(output_file, initial_theta)
        gen = self._next_generator(generator)
        if method == "fused":
            ip_loc, ip_scale = self._isotropic(importance_proposal,
                                               "importance proposal")
            _, lp_scale = self._isotropic(local_proposal, "local proposal")
            res = run_glmcmc_fused(
                self.abc_set, gen, num_iterations, initial_theta,
                y0=initial_y, ip_loc=ip_loc, ip_scale=ip_scale,
                lp_scale=lp_scale, global_frequency=global_frequency,
                batch_size=batch_size, num_chains=self.num_chains,
                on_segment=on_segment, device=self.device, **kwargs)
        elif method == "scan":
            res = run_glmcmc(
                self.abc_set, gen, num_iterations, initial_theta,
                importance_proposal, local_proposal, global_frequency,
                batch_size, y0=initial_y, num_chains=self.num_chains,
                segment_size=self.segment_size, on_segment=on_segment,
                device=self.device, **kwargs)
        else:
            raise ValueError(f"method must be 'scan' or 'fused', got {method!r}")
        return self._finish(res, "GLMCMC")

    def run_aglmcmc(self, num_iterations, initial_theta, initial_y,
                    global_frequency, local_proposal, Initial_ISIR_prop,
                    batch_size, step_size, alpha, hat_eps_T,
                    output_file: Optional[str] = "aglmcmc_results.csv",
                    generator=None, method: str = "scan", **kwargs):
        """AGLMCMC (reference ``MCMCRunner.py:55-76``).  ``method='fused'``
        runs the pool-iSIR kernel at ``global_frequency == 1`` (any problem;
        per-chain adaptation epochs) and the mixed kernel below it
        (Mixture-family problems, shared adaptation, RW scale from
        ``local_proposal`` unless ``lp_scale`` is given); ``'scan'`` the
        plain torch path."""
        on_segment = self._writer(output_file, initial_theta)
        gen = self._next_generator(generator)
        if method == "fused":
            extra = dict(kwargs)
            if float(global_frequency) < 1.0:
                # the mixed kernel implies shared adaptation: reject the
                # scan path's per-chain options rather than ignore them
                if extra.pop("shared_adaptation", True) is False:
                    raise ValueError(
                        "method='fused' at global_frequency < 1 runs the "
                        "mixed pool-iSIR kernel, which requires shared "
                        "(cross-chain) adaptation; per-chain adaptation at "
                        "gf < 1 is only available with method='scan'")
                if "epoch_chunk" in extra:
                    raise ValueError(
                        "epoch_chunk applies to per-chain epochs; the gf<1 "
                        "fused path adapts shared (tune redraw_chunk and "
                        "shared_support instead)")
                extra.setdefault(
                    "lp_scale",
                    self._isotropic(local_proposal, "local proposal")[1])
            res = run_aglmcmc_fused(
                self.abc_set, gen, num_iterations, initial_theta,
                Initial_ISIR_prop, batch_size=batch_size,
                step_size=step_size, alpha=alpha, hat_eps_T=hat_eps_T,
                y0=initial_y, num_chains=self.num_chains,
                on_segment=on_segment,
                global_frequency=float(global_frequency),
                device=self.device, **extra)
        elif method == "scan":
            res = run_aglmcmc(
                self.abc_set, gen, num_iterations, initial_theta,
                local_proposal, Initial_ISIR_prop, global_frequency,
                batch_size, step_size, alpha, hat_eps_T, y0=initial_y,
                num_chains=self.num_chains, on_segment=on_segment,
                device=self.device, **kwargs)
        else:
            raise ValueError(f"method must be 'scan' or 'fused', got {method!r}")
        return self._finish(res, "AGLMCMC")

    def run_glmala(self, num_iterations, initial_theta, initial_y,
                   global_frequency, importance_proposal, batch_size, tau,
                   num_grad, output_file: Optional[str] = "glmala_results.csv",
                   generator=None, method: str = "scan", **kwargs):
        """GLMALA (reference ``MCMCRunner.py:78-98``).  ``method='fused'``
        runs the fused GLMALA kernel (Mixture-family problems,
        ``theta_dim`` in {1, 2, 4, 8}, isotropic importance proposal;
        ``coin_mode='shared'`` by default); ``'scan'`` the plain torch path
        for any problem."""
        if kwargs.get("tile_program") is not None:
            raise NotImplementedError(
                "tile_program= (the generic GLMALA kernel) is not ported yet "
                "(ROADMAP Queue 1, M11)")
        kwargs.pop("tile_program", None)
        on_segment = self._writer(output_file, initial_theta)
        gen = self._next_generator(generator)
        if method == "fused":
            ip_loc, ip_scale = self._isotropic(importance_proposal,
                                               "importance proposal")
            res = run_glmala_fused(
                self.abc_set, gen, num_iterations, initial_theta,
                y0=initial_y, ip_loc=ip_loc, ip_scale=ip_scale,
                global_frequency=global_frequency, batch_size=batch_size,
                tau=tau, num_grad=num_grad, num_chains=self.num_chains,
                on_segment=on_segment, device=self.device, **kwargs)
        elif method == "scan":
            res = run_glmala(
                self.abc_set, gen, num_iterations, initial_theta,
                importance_proposal, global_frequency, batch_size, tau,
                num_grad, y0=initial_y, num_chains=self.num_chains,
                segment_size=self.segment_size, on_segment=on_segment,
                device=self.device, **kwargs)
        else:
            raise ValueError(f"method must be 'scan' or 'fused', got {method!r}")
        return self._finish(res, "GLMALA")

    def run_glmcmc_nf(self, num_iterations, initial_theta, initial_y,
                      global_frequency, local_proposal,
                      importance_proposal_base, batch_size, step_size,
                      train_steps,
                      output_file: Optional[str] = "glmcmc_nf_results.csv",
                      generator=None, method: str = "pooled", **kwargs):
        """GLMCMC-NF (reference ``MCMCRunner.py:100-121``).
        ``importance_proposal_base`` is the flow's base (a ``DiagGaussian``).

        * ``'pooled'`` (default): per-epoch flow pools, training on the
          consumed pool, one flow pull per step (cursor cadence);
        * ``'fused'``: at ``global_frequency == 1`` the pool-iSIR kernel
          (every move global); below it the pooled path with slice-per-step
          cadence;
        * ``'scan'``: fresh flow draws at every step.

        Every flow evaluation outside training is the K7 kernel on the
        card."""
        on_segment = self._writer(output_file, initial_theta)
        gen = self._next_generator(generator)
        gf = float(global_frequency)
        common = dict(base=importance_proposal_base, batch_size=batch_size,
                      step_size=step_size, train_steps=train_steps,
                      y0=initial_y, num_chains=self.num_chains,
                      on_segment=on_segment, device=self.device)
        if method == "fused" and gf == 1.0:
            res = run_glmcmc_nf_fused(
                self.abc_set, gen, num_iterations, initial_theta,
                local_proposal, **common, **kwargs)
        elif method in ("fused", "pooled"):
            if method == "fused":
                if kwargs.pop("cadence", "slice") != "slice":
                    raise ValueError(
                        "method='fused' at global_frequency < 1 runs the "
                        "slice cadence; use method='pooled' for the cursor "
                        "cadence")
                kwargs["cadence"] = "slice"
            res = run_glmcmc_nf_pooled(
                self.abc_set, gen, num_iterations, initial_theta,
                local_proposal, global_frequency=gf, **common, **kwargs)
        elif method == "scan":
            res = run_glmcmc_nf(
                self.abc_set, gen, num_iterations, initial_theta,
                local_proposal, global_frequency=gf, **common, **kwargs)
        else:
            raise ValueError(f"method must be 'pooled', 'fused' or 'scan', "
                             f"got {method!r}")
        return self._finish(res, "GLMCMC-NF")
