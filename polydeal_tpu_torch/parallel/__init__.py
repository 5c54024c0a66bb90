"""The sharded solve on ``torch.distributed``: one process per shard."""

from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem
from polydeal_tpu_torch.parallel.sharding import (
    build_halo_exchange,
    init_group,
)

__all__ = ["ShardedBandedSystem", "build_halo_exchange", "init_group"]
