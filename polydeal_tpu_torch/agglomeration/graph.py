"""Cell-adjacency graph utilities.

Array equivalents of the reference's ``Utils::Graph`` +
``compute_connected_components`` (reference include/utils.h:59-79,1841-1915)
which back ``define_agglomerate_with_check`` — the repair mechanism that
splits a disconnected agglomerate into its face-connected components
(reference source/agglomeration_handler.cc:172-207, examples/repairing.cc).

All of this runs on the host at setup time (numpy + scipy.sparse), never
inside jit.

Port note: a jax-free copy of ``polydeal_tpu/agglomeration/graph.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

__all__ = ["adjacency_matrix", "connected_components", "split_disconnected"]


def adjacency_matrix(n_cells: int, neighbors: np.ndarray) -> sp.csr_matrix:
    """Symmetric face-adjacency matrix of the fine mesh.

    ``neighbors`` is [n_cells, n_faces] with -1 for boundary (FineMesh
    convention) — the analogue of
    ``internal::get_face_connectivity_of_cells`` (reference
    include/poly_utils.h:95-139).
    """
    rows = np.repeat(np.arange(n_cells), neighbors.shape[1])
    cols = neighbors.ravel()
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep]
    data = np.ones(rows.shape[0], dtype=np.int8)
    return sp.csr_matrix((data, (rows, cols)), shape=(n_cells, n_cells))


def connected_components(cells: np.ndarray, neighbors: np.ndarray) -> list[np.ndarray]:
    """Face-connected components of a subset of cells.

    ``cells``: 1D array of cell indices; ``neighbors``: full-mesh neighbor
    array.  Returns a list of arrays of cell indices.
    """
    cells = np.asarray(cells)
    pos = {int(c): i for i, c in enumerate(cells)}
    rows, cols = [], []
    for i, c in enumerate(cells):
        for nb in neighbors[c]:
            j = pos.get(int(nb))
            if j is not None:
                rows.append(i)
                cols.append(j)
    n = len(cells)
    A = sp.csr_matrix((np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(n, n))
    ncomp, labels = csgraph.connected_components(A, directed=False)
    return [cells[labels == k] for k in range(ncomp)]


def split_disconnected(cell2poly: np.ndarray, neighbors: np.ndarray) -> np.ndarray:
    """Repair an agglomeration so every polytope is face-connected.

    Vectorized global version of ``define_agglomerate_with_check``: compute
    connected components of the graph restricted to same-polytope edges;
    each component becomes its own polytope.  Returns a new, compact
    ``cell2poly`` (labels renumbered 0..n_poly-1, ordered by first cell).
    """
    from polydeal_tpu_torch import native

    nat = native.connected_components_labels(cell2poly, neighbors)
    if nat is not None:
        return nat
    n_cells = cell2poly.shape[0]
    rows = np.repeat(np.arange(n_cells), neighbors.shape[1])
    cols = neighbors.ravel()
    keep = (cols >= 0) & (cell2poly[rows] == cell2poly[np.maximum(cols, 0)])
    rows, cols = rows[keep], cols[keep]
    A = sp.csr_matrix(
        (np.ones(rows.shape[0], dtype=np.int8), (rows, cols)),
        shape=(n_cells, n_cells),
    )
    _, labels = csgraph.connected_components(A, directed=False)
    # renumber by first occurrence so polytope ids are deterministic
    _, first_idx, new_labels = np.unique(labels, return_index=True, return_inverse=True)
    order = np.argsort(np.argsort(first_idx))
    return order[new_labels].astype(np.int32)


def compact_labels(cell2poly: np.ndarray) -> np.ndarray:
    """Renumber arbitrary labels to 0..n_poly-1 by first occurrence."""
    _, first_idx, inv = np.unique(cell2poly, return_index=True, return_inverse=True)
    order = np.argsort(np.argsort(first_idx))
    return order[inv].astype(np.int32)
