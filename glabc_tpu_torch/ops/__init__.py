from .resampling import (blocked_searchsorted_take,
                         blocked_stable_partition_take,
                         categorical_from_log_weights,
                         categorical_from_weights, sanitize_log_weights,
                         stable_partition_indices, stable_partition_take,
                         systematic_resample)
from .stats import (ChainSummary, chain_summary, esjd, esjd_per_second, ess,
                    rhat, weighted_std)

__all__ = [
    "blocked_searchsorted_take",
    "blocked_stable_partition_take",
    "categorical_from_log_weights",
    "categorical_from_weights",
    "sanitize_log_weights",
    "stable_partition_indices",
    "stable_partition_take",
    "systematic_resample",
    "ChainSummary",
    "chain_summary",
    "esjd",
    "esjd_per_second",
    "ess",
    "rhat",
    "weighted_std",
]
