"""Graph/geometry partitioners for METIS-path parity.

The reference agglomerates by k-way graph partitioning with METIS
(``PolyUtils::partition_locally_owned_regions``, reference
include/poly_utils.h:553-704; serial path via
``GridTools::partition_triangulation`` in examples/poisson.cc:547-559).

We provide two host-side partitioners:

* ``rcb`` — recursive coordinate bisection over cell centers: balanced,
  contiguous, deterministic; our default "METIS-like" strategy.
* ``greedy`` — BFS region growing on the face-adjacency graph, for
  unstructured meshes where geometry is a poor proxy.
* ``multilevel`` — the METIS algorithm family proper: heavy-edge-matching
  coarsening, BFS initial bisection, FM boundary refinement
  (``agglomeration/multilevel.py``).

Both return a label per cell; ``agglomerate_by_partition`` additionally
repairs disconnected parts (reference ``define_agglomerate_with_check``).

Port note: a jax-free copy of ``polydeal_tpu/agglomeration/partition.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

from polydeal_tpu_torch.agglomeration.graph import split_disconnected, compact_labels

__all__ = ["partition_cells", "agglomerate_by_partition"]


def _rcb(points: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: split along widest axis."""
    n = points.shape[0]
    labels = np.zeros(n, dtype=np.int64)

    def rec(idx: np.ndarray, k: int, base: int):
        if k <= 1 or idx.shape[0] <= 1:
            labels[idx] = base
            return
        pts = points[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        k_lo = k // 2
        order = np.argsort(pts[:, axis], kind="stable")
        cut = int(round(idx.shape[0] * k_lo / k))
        rec(idx[order[:cut]], k_lo, base)
        rec(idx[order[cut:]], k - k_lo, base + k_lo)

    rec(np.arange(n), n_parts, 0)
    return labels


def _greedy_bfs(neighbors: np.ndarray, n_parts: int) -> np.ndarray:
    """BFS region growing: grow parts of ~equal size from farthest seeds."""
    n = neighbors.shape[0]
    target = int(np.ceil(n / n_parts))
    labels = np.full(n, -1, dtype=np.int64)
    unassigned = n
    part = 0
    seed = 0
    while unassigned > 0 and part < n_parts:
        # find an unassigned seed (first unassigned cell)
        while seed < n and labels[seed] >= 0:
            seed += 1
        if seed >= n:
            break
        frontier = [seed]
        labels[seed] = part
        count = 1
        unassigned -= 1
        while frontier and count < target:
            nxt = []
            for c in frontier:
                for nb in neighbors[c]:
                    if nb >= 0 and labels[nb] < 0:
                        labels[nb] = part
                        count += 1
                        unassigned -= 1
                        nxt.append(int(nb))
                        if count >= target:
                            break
                if count >= target:
                    break
            frontier = nxt
        part += 1
    # leftovers join an assigned neighbor (or last part)
    while True:
        left = np.where(labels < 0)[0]
        if left.size == 0:
            break
        progressed = False
        for c in left:
            for nb in neighbors[c]:
                if nb >= 0 and labels[nb] >= 0:
                    labels[c] = labels[nb]
                    progressed = True
                    break
        if not progressed:
            labels[left] = max(part - 1, 0)
            break
    return labels


def partition_cells(
    centers: np.ndarray,
    neighbors: np.ndarray,
    n_parts: int,
    strategy: str = "rcb",
) -> np.ndarray:
    """Partition cells into n_parts labeled 0..n_parts-1."""
    if n_parts <= 1:
        return np.zeros(centers.shape[0], dtype=np.int32)
    if strategy == "rcb":
        labels = _rcb(np.asarray(centers, dtype=np.float64), n_parts)
    elif strategy == "greedy":
        from polydeal_tpu_torch import native

        labels = native.greedy_partition(neighbors, n_parts)
        if labels is None:
            labels = _greedy_bfs(neighbors, n_parts)
    elif strategy == "multilevel":
        from polydeal_tpu_torch.agglomeration.multilevel import multilevel_partition

        labels = multilevel_partition(neighbors, n_parts)
    else:
        raise ValueError(f"unknown partition strategy: {strategy}")
    return compact_labels(labels)


def agglomerate_by_partition(
    centers: np.ndarray,
    neighbors: np.ndarray,
    n_parts: int,
    strategy: str = "rcb",
    repair: bool = True,
) -> np.ndarray:
    """cell2poly from a k-way partition, with connectivity repair."""
    labels = partition_cells(centers, neighbors, n_parts, strategy)
    if repair:
        labels = split_disconnected(labels, neighbors)
    return labels
