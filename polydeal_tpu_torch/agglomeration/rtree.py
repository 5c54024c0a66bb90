"""R-tree agglomeration via Sort-Tile-Recursive (STR) bulk loading.

TPU-native rebuild of the reference's boost R*-tree + visitor extraction
(reference include/agglomerator.h: ``CellsAgglomerator`` /
``Rtree_visitor``, :165-434).  Instead of walking a pointer tree, we build
the hierarchy bottom-up with sort-tile-recursive packing over cell-center
coordinates and store, for every tree level, a flat assignment array
``cell -> node id``.  Extracting the agglomerates of a level and the
parent->children hierarchy used by multigrid (reference
agglomerator.h:460-471 ``get_hierarchy``) are then O(1) array lookups.

Conventions matching the reference:
  * fanout defaults to 2^dim elements per node (examples/poisson.cc:572-573)
  * level 0 is the root (a single agglomerate = whole local mesh);
    deeper levels are finer (reference extraction_level semantics)
  * requesting a level deeper than the tree returns the leaves, i.e. one
    cell per agglomerate (the reference's depth-0 fallback,
    agglomerator.h:407-413).

Port note: a jax-free copy of ``polydeal_tpu/agglomeration/rtree.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["str_tile", "RTreeAgglomerator"]


def str_tile(points: np.ndarray, n_groups: int) -> np.ndarray:
    """Sort-tile-recursive grouping of points into ``n_groups`` labels.

    points: [n, dim].  Returns labels [n] in 0..n_groups-1 with group sizes
    differing by at most ceil(n/n_groups) vs floor.  Tiles along coordinate
    axes in order, recursively (the STR packing rule).
    """
    n, dim = points.shape
    labels = np.zeros(n, dtype=np.int64)
    if n_groups <= 1 or n == 0:
        return labels
    from polydeal_tpu_torch import native

    nat = native.str_tile(points, n_groups)
    if nat is not None:
        return nat

    def rec(idx: np.ndarray, pts: np.ndarray, k: int, axis: int, base: int):
        if k <= 1 or idx.shape[0] == 0:
            labels[idx] = base
            return
        # number of slices along this axis: k^(1/remaining_dims)
        rem = pts.shape[1] - axis
        if rem <= 1:
            # last axis: split directly into k runs
            order = np.argsort(pts[:, axis], kind="stable")
            bounds = np.linspace(0, idx.shape[0], k + 1).astype(np.int64)
            for g in range(k):
                labels[idx[order[bounds[g] : bounds[g + 1]]]] = base + g
            return
        s = int(np.ceil(k ** (1.0 / rem)))
        s = min(s, k)
        order = np.argsort(pts[:, axis], kind="stable")
        # distribute k groups over s slices as evenly as possible
        per = [k // s + (1 if i < k % s else 0) for i in range(s)]
        bounds = np.zeros(s + 1, dtype=np.int64)
        total = idx.shape[0]
        acc = 0
        for i in range(s):
            acc += per[i]
            bounds[i + 1] = int(round(total * acc / k))
        gbase = base
        for i in range(s):
            sl = order[bounds[i] : bounds[i + 1]]
            rec(idx[sl], pts[sl], per[i], axis + 1, gbase)
            gbase += per[i]

    rec(np.arange(n), points, n_groups, 0, 0)
    return labels


@dataclass
class RTreeAgglomerator:
    """Bottom-up STR hierarchy over fine-cell centers.

    Attributes:
      level_assign: list over tree levels (0 = root) of int arrays
        [n_cells] mapping each cell to its ancestor node id at that level.
        Node ids at each level are compact 0..n_nodes(level)-1.
      n_levels: depth of the tree including the leaf level.
    """

    level_assign: list  # list[np.ndarray]

    @classmethod
    def build(cls, centers: np.ndarray, fanout: int | None = None) -> "RTreeAgglomerator":
        """Build via a recursive STR *leaf ordering* (depth-first rank in
        the fanout-way tile tree).  Every level is then the chunking
        ``rank // fanout^(depth-level)`` — so children of any node are a
        contiguous id range (``parent = id // fanout``), the property the
        TPU transfer fast path and the banded SpMV offsets exploit, and
        polytope ids follow a space-filling-curve order (locality for
        sharding)."""
        centers = np.asarray(centers, dtype=np.float64)
        n, dim = centers.shape
        if fanout is None:
            fanout = 1 << dim  # 2^dim, the reference's convention
        rank = cls._leaf_order(centers, fanout)
        depth = 0
        while fanout**depth < n:
            depth += 1
        levels = [rank // (fanout ** (depth - l)) for l in range(depth)]
        levels.append(rank)  # leaf level
        return cls(level_assign=[lv.astype(np.int64) for lv in levels])

    @staticmethod
    def _leaf_order(centers: np.ndarray, fanout: int) -> np.ndarray:
        from polydeal_tpu_torch import native

        rank = native.str_leaf_order(centers, fanout)
        if rank is not None:
            return rank
        # python fallback: recursive fanout-way tiling
        n = centers.shape[0]
        rank = np.empty(n, dtype=np.int64)
        counter = [0]

        def rec(idx):
            if idx.shape[0] <= 1:
                for i in idx:
                    rank[i] = counter[0]
                    counter[0] += 1
                return
            k = min(fanout, idx.shape[0])
            labels = str_tile(centers[idx], k)
            for g in range(k):
                rec(idx[labels == g])

        rec(np.arange(n))
        return rank

    @property
    def n_levels(self) -> int:
        return len(self.level_assign)

    def n_nodes(self, level: int) -> int:
        level = min(level, self.n_levels - 1)
        return int(self.level_assign[level].max()) + 1

    def extract_agglomerates(self, level: int) -> np.ndarray:
        """cell2poly for the given extraction level (clamped to leaves)."""
        level = min(level, self.n_levels - 1)
        return self.level_assign[level].astype(np.int32)

    def hierarchy(self, coarse_level: int, fine_level: int) -> np.ndarray:
        """parent[fine_node] = coarse node id, for two tree levels.

        The analogue of ``CellsAgglomerator::get_hierarchy`` (reference
        agglomerator.h:460-471), flattened to a parent-pointer array.
        """
        cl = min(coarse_level, self.n_levels - 1)
        fl = min(fine_level, self.n_levels - 1)
        fine = self.level_assign[fl]
        coarse = self.level_assign[cl]
        parent = np.full(self.n_nodes(fl), -1, dtype=np.int64)
        parent[fine] = coarse
        return parent
