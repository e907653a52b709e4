from .resampling import (categorical_from_log_weights, sanitize_log_weights,
                         systematic_resample)
from .stats import ChainSummary, chain_summary, esjd, ess, rhat, weighted_std

__all__ = [
    "categorical_from_log_weights",
    "sanitize_log_weights",
    "systematic_resample",
    "ChainSummary",
    "chain_summary",
    "esjd",
    "ess",
    "rhat",
    "weighted_std",
]
