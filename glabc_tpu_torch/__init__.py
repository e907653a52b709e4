"""glabc_tpu_torch: the PyTorch / CUDA port of glabc_tpu for NVIDIA Hopper.

A second package beside ``glabc_tpu`` (which stays the reference): the same
samplers, problems and diagnostics in torch, with every TPU kernel of the
ported paths rewritten by hand in CUDA for ``sm_90a``.  This slice carries
GLMCMC and GlobalMCMC on Mixture-family problems and AGLMCMC, each plain
and fused.

Entry points run on the current CUDA device unless they are given
``device='cpu'``; without a GPU and without a device they raise.  The CUDA
sources in ``csrc/`` build with ``nvcc`` at their first launch, into
``glabc_tpu_torch/_build/``.
"""

from .models import (ABCProblem, DiagGaussian, Gamma, GaussianMixture,
                     HighDimMixtureProblem, KernelDensity, MixtureProblem,
                     Uniform)
from .ops import chain_summary, esjd, ess, rhat
from .runner import MCMCRunner
from .samplers import (run_aglmcmc, run_aglmcmc_fused,
                       run_aglmcmc_fused_mixed, run_global_mcmc,
                       run_global_mcmc_fused, run_glmcmc, run_glmcmc_fused)
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
    "ABCProblem",
    "DiagGaussian",
    "Gamma",
    "GaussianMixture",
    "HighDimMixtureProblem",
    "KernelDensity",
    "MixtureProblem",
    "Uniform",
    "chain_summary",
    "esjd",
    "ess",
    "rhat",
    "__version__",
]
