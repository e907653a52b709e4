"""glabc_tpu_torch: the PyTorch / CUDA port of glabc_tpu for NVIDIA Hopper.

A second package beside ``glabc_tpu`` (which stays the reference): the same
samplers, problems and diagnostics in torch, with every TPU kernel of the
ported paths rewritten by hand in CUDA for ``sm_90a``.  It carries GLMCMC
and GlobalMCMC on Mixture-family problems, AGLMCMC, GLMALA and GLMCMC-NF
(with its coupling flow), each plain and fused, and the generic fused
kernels over a tile program (MA(2), or a user's CUDA header and its torch
twin): ``run_fused_program``, ``run_glmala_program`` and the mixed AGLMCMC
kernel's ``tile_program=``; around them chain IO (CSV, or the native C++
writer of :mod:`glabc_tpu_torch.native`), versioned checkpoints
(``utils.CheckpointManager``), profiling hooks (``utils.annotate``,
``trace``, ``debug_mode``) and the examples of ``glabc_tpu_torch/
examples/``.

Entry points run on the current CUDA device unless they are given
``device='cpu'``; without a GPU and without a device they raise.  With
``mesh=`` (a 1-D ``DeviceMesh``, one process per GPU;
:mod:`glabc_tpu_torch.parallel`) they shard their chains over the ranks.  The CUDA
sources in ``csrc/`` build with ``nvcc`` at their first launch, into
``glabc_tpu_torch/_build/``.
"""

from .models import (ABCProblem, CouplingFlow, DiagGaussian, Gamma,
                     GaussianMixture, GKProblem, HighDimMixtureProblem,
                     KernelDensity, MA2Problem, MixtureProblem, Uniform)
from .ops import chain_summary, esjd, esjd_per_second, ess, rhat
from .ops.kernels.program import (TileProgram, ma2_tile_program,
                                  mixture_tile_program)
from .runner import MCMCRunner
from .samplers import (run_aglmcmc, run_aglmcmc_fused,
                       run_aglmcmc_fused_mixed, run_fused_program,
                       run_global_mcmc, run_global_mcmc_fused, run_glmala,
                       run_glmala_fused, run_glmala_program, run_glmcmc,
                       run_glmcmc_fused, run_glmcmc_nf, run_glmcmc_nf_fused,
                       run_glmcmc_nf_pooled)
from .utils import ChainWriter, load_carry, save_carry

__version__ = "0.1.0"

__all__ = [
    "MCMCRunner",
    "ChainWriter",
    "load_carry",
    "save_carry",
    "run_aglmcmc",
    "run_aglmcmc_fused",
    "run_aglmcmc_fused_mixed",
    "run_global_mcmc",
    "run_global_mcmc_fused",
    "run_glmcmc",
    "run_glmcmc_fused",
    "run_glmala",
    "run_glmala_fused",
    "run_glmcmc_nf",
    "run_glmcmc_nf_fused",
    "run_glmcmc_nf_pooled",
    "run_fused_program",
    "run_glmala_program",
    "TileProgram",
    "mixture_tile_program",
    "ma2_tile_program",
    "GKProblem",
    "MA2Problem",
    "ABCProblem",
    "CouplingFlow",
    "DiagGaussian",
    "Gamma",
    "GaussianMixture",
    "HighDimMixtureProblem",
    "KernelDensity",
    "MixtureProblem",
    "Uniform",
    "chain_summary",
    "esjd",
    "esjd_per_second",
    "ess",
    "rhat",
    "__version__",
]
