"""The sharded solves on ``torch.distributed``: one process per shard.

``init_group`` is the counterpart of the JAX package's ``make_mesh``."""

from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem
from polydeal_tpu_torch.parallel.sharding import (
    ShardedLevel,
    ShardedMatrix,
    ShardedSystem,
    build_halo_exchange,
    init_group,
    shard_block_matrix,
)

__all__ = ["ShardedBandedSystem", "ShardedLevel", "ShardedMatrix",
           "ShardedSystem", "build_halo_exchange", "init_group",
           "shard_block_matrix"]
