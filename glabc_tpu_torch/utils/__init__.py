from .checkpoint import CheckpointManager
from .io import (ChainWriter, carry_path, load_carry, read_binary_chains,
                 save_carry)
from .profiling import annotate, debug_mode, trace

__all__ = ["ChainWriter", "CheckpointManager", "carry_path", "load_carry",
           "read_binary_chains", "save_carry", "annotate", "debug_mode",
           "trace"]
