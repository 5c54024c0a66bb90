from polydeal_tpu_torch.agglomeration.graph import (
    connected_components,
    split_disconnected,
)
from polydeal_tpu_torch.agglomeration.partition import (
    agglomerate_by_partition,
    partition_cells,
)
from polydeal_tpu_torch.agglomeration.rtree import RTreeAgglomerator, str_tile

__all__ = [
    "connected_components",
    "split_disconnected",
    "RTreeAgglomerator",
    "str_tile",
    "partition_cells",
    "agglomerate_by_partition",
]
