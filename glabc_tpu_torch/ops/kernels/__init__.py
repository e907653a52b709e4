"""Hand-written CUDA kernels (``csrc/``) with their plain torch versions."""

from .mixture_kernel import FusedMixtureGLMCMC, FusedStats, fused_state_init
from .packed_kernel import (PackedMixtureGLMCMC, PackedStats,
                            packed_state_init, unpack_history)

__all__ = [
    "FusedMixtureGLMCMC",
    "FusedStats",
    "fused_state_init",
    "PackedMixtureGLMCMC",
    "PackedStats",
    "packed_state_init",
    "unpack_history",
]
