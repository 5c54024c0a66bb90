from polydeal_tpu_torch.agglomeration.rtree import RTreeAgglomerator, str_tile

__all__ = ["RTreeAgglomerator", "str_tile"]
