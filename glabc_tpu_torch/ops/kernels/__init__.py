"""Hand-written CUDA kernels (``csrc/``) with their plain torch versions."""

from .flow_kernel import FlowPull, FlowPush, flow_pull_fused, flow_push_fused
from .glmala_kernel import FusedMixtureGLMALA
from .kde_logprob_kernel import (BatchedMixtureLogProb, batched_kde_log_prob,
                                 kde_logprob_inputs)
from .mixture_kernel import FusedMixtureGLMCMC, FusedStats, fused_state_init
from .packed_kernel import (PackedMixtureGLMCMC, PackedStats,
                            packed_state_init, unpack_history)
from .pool_isir_kernel import PoolISIR, pack_pool_logw, pack_pool_theta
from .pool_isir_mixed_kernel import (PoolISIRMixed, ResidentProposal,
                                     resident_from_gaussian, resident_from_kde)

__all__ = [
    "FlowPull",
    "FlowPush",
    "flow_pull_fused",
    "flow_push_fused",
    "FusedMixtureGLMALA",
    "BatchedMixtureLogProb",
    "batched_kde_log_prob",
    "kde_logprob_inputs",
    "FusedMixtureGLMCMC",
    "FusedStats",
    "fused_state_init",
    "PackedMixtureGLMCMC",
    "PackedStats",
    "packed_state_init",
    "unpack_history",
    "PoolISIR",
    "pack_pool_logw",
    "pack_pool_theta",
    "PoolISIRMixed",
    "ResidentProposal",
    "resident_from_gaussian",
    "resident_from_kde",
]
