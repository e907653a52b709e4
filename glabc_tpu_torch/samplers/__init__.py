from .aglmcmc import (AGLCarry, AGLMCMCConfig, AGLResult, Pool,
                      default_pool_slack, make_epoch_fn, make_shared_epoch_fn,
                      run_aglmcmc)
from .aglmcmc_fused import run_aglmcmc_fused, run_aglmcmc_fused_mixed
from .base import (MoveCounts, SamplerResult, StepOut, independence_mh_move,
                   isir_move, local_rw_move, run_segmented)
from .chain import ChainCarry, init_chain_carry, sample_with_step
from .global_mcmc import (GlobalMCMCConfig, build_global_mcmc_step,
                          run_global_mcmc)
from .glmala import (GLMALAConfig, build_glmala_step, run_glmala,
                     synthetic_likelihood_grad)
from .glmala_fused import run_glmala_fused
from .glmcmc import GLMCMCConfig, build_glmcmc_step, run_glmcmc
from .glmcmc_fused import run_glmcmc_fused, run_global_mcmc_fused
from .glmcmc_nf import GLMCMCNFConfig, NFResult, run_glmcmc_nf
from .glmcmc_nf_fused import run_glmcmc_nf_fused, run_glmcmc_nf_pooled

__all__ = [
    "AGLCarry",
    "AGLMCMCConfig",
    "AGLResult",
    "Pool",
    "default_pool_slack",
    "make_epoch_fn",
    "make_shared_epoch_fn",
    "run_aglmcmc",
    "run_aglmcmc_fused",
    "run_aglmcmc_fused_mixed",
    "MoveCounts",
    "SamplerResult",
    "StepOut",
    "independence_mh_move",
    "isir_move",
    "local_rw_move",
    "run_segmented",
    "ChainCarry",
    "init_chain_carry",
    "sample_with_step",
    "GlobalMCMCConfig",
    "build_global_mcmc_step",
    "run_global_mcmc",
    "GLMCMCConfig",
    "build_glmcmc_step",
    "run_glmcmc",
    "run_glmcmc_fused",
    "run_global_mcmc_fused",
    "GLMALAConfig",
    "build_glmala_step",
    "run_glmala",
    "synthetic_likelihood_grad",
    "run_glmala_fused",
    "GLMCMCNFConfig",
    "NFResult",
    "run_glmcmc_nf",
    "run_glmcmc_nf_fused",
    "run_glmcmc_nf_pooled",
]
