"""Multi-GPU chain sharding: one process per GPU, ``mesh=`` a 1-D
``DeviceMesh`` (port of ``glabc_tpu/parallel``)."""

from .mesh import (CHAIN_AXIS, chain_range, check_mesh, gather_chains,
                   initialize_distributed, make_mesh, shard_chains)
from .sharded import (distributed_quantile, distributed_systematic_resample,
                      make_sharded_chain_state_trainer,
                      make_sharded_flow_trainer, make_sharded_shared_epoch,
                      rank_generator, sharded_hat_eps_update)

__all__ = [
    "CHAIN_AXIS",
    "chain_range",
    "check_mesh",
    "gather_chains",
    "initialize_distributed",
    "make_mesh",
    "shard_chains",
    "distributed_quantile",
    "distributed_systematic_resample",
    "make_sharded_chain_state_trainer",
    "make_sharded_flow_trainer",
    "make_sharded_shared_epoch",
    "rank_generator",
    "sharded_hat_eps_update",
]
