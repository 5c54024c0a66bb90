"""Multilevel k-way graph partitioner — the METIS algorithm family.

Closes the reference's METIS path (``SparsityTools::partition`` inside
``PolyUtils::partition_locally_owned_regions``, reference
include/poly_utils.h:553-704) with the standard three-phase multilevel
scheme METIS itself uses:

  1. COARSEN: repeated heavy-edge matching (here: random-order maximal
     matching on the face-adjacency graph with vertex weights) until the
     graph is small;
  2. INITIAL PARTITION: recursive bisection by weighted BFS region
     growth on the coarsest graph;
  3. UNCOARSEN + REFINE: project labels back level by level, running
     boundary Kernighan–Lin/Fiedler-style refinement passes that move
     boundary vertices to the neighboring part with the largest edge-cut
     gain, subject to a balance constraint.

Host-side numpy (setup-time, like the reference's METIS call); the
matching and refinement passes are vectorized over vertices.

Port note: a jax-free copy of ``polydeal_tpu/agglomeration/multilevel.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["multilevel_partition"]


def _adjacency_lists(neighbors: np.ndarray):
    """[n, max_deg] face-neighbor array (−1 padded) — already the CSR-ish
    structure we need; returned as-is with a validity mask."""
    nb = np.asarray(neighbors, dtype=np.int64)
    return nb, nb >= 0


def _heavy_edge_matching(nb, mask, w_v, w_e, rng):
    """One coarsening level: maximal matching preferring heavy edges.

    Returns (coarse_map [n] -> coarse id, n_coarse)."""
    n = nb.shape[0]
    order = rng.permutation(n)
    matched = np.full(n, -1, dtype=np.int64)
    # python loop over vertices, but each visit is O(max_deg): fine for
    # setup-scale graphs (the reference calls METIS serially too)
    for v in order:
        if matched[v] >= 0:
            continue
        best, best_w = -1, -1.0
        for j in range(nb.shape[1]):
            u = nb[v, j]
            if u >= 0 and matched[u] < 0 and u != v:
                we = w_e[v, j]
                if we > best_w:
                    best, best_w = u, we
        if best >= 0:
            matched[v] = best
            matched[best] = v
        else:
            matched[v] = v
    # enumerate pairs
    coarse = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for v in range(n):
        if coarse[v] < 0:
            coarse[v] = nxt
            if matched[v] != v:
                coarse[matched[v]] = nxt
            nxt += 1
    return coarse, nxt


def _contract(nb, mask, w_v, w_e, coarse, n_coarse):
    """Contract the graph along the matching: adjacency dict per coarse
    vertex with summed edge weights."""
    adj = [dict() for _ in range(n_coarse)]
    wv = np.zeros(n_coarse)
    n = nb.shape[0]
    for v in range(n):
        cv = coarse[v]
        wv[cv] += w_v[v]
        for j in range(nb.shape[1]):
            u = nb[v, j]
            if u >= 0:
                cu = coarse[u]
                if cu != cv:
                    adj[cv][cu] = adj[cv].get(cu, 0.0) + w_e[v, j]
    max_deg = max((len(a) for a in adj), default=1) or 1
    nb_c = np.full((n_coarse, max_deg), -1, dtype=np.int64)
    we_c = np.zeros((n_coarse, max_deg))
    for c, a in enumerate(adj):
        for k, (u, w) in enumerate(a.items()):
            nb_c[c, k] = u
            we_c[c, k] = w
    return nb_c, nb_c >= 0, wv, we_c


def _grow_bisection(nb, w_v, k_lo, k, rng):
    """Initial 2-way split by weighted BFS growth from a random seed."""
    n = nb.shape[0]
    total = w_v.sum()
    target = total * k_lo / k
    labels = np.ones(n, dtype=np.int64)
    seed = int(rng.integers(n))
    frontier = [seed]
    labels[seed] = 0
    acc = w_v[seed]
    visited = {seed}
    while frontier and acc < target:
        nxt = []
        for v in frontier:
            for u in nb[v]:
                if u >= 0 and u not in visited:
                    visited.add(int(u))
                    labels[u] = 0
                    acc += w_v[u]
                    nxt.append(int(u))
                    if acc >= target:
                        break
            if acc >= target:
                break
        frontier = nxt
    return labels


def _refine_bisection(nb, mask, w_v, w_e, labels, k_lo, k, passes=4,
                      imbalance=1.05):
    """Boundary FM-style refinement: move boundary vertices to the other
    side when the edge-cut gain is positive and balance allows."""
    total = w_v.sum()
    target0 = total * k_lo / k
    for _ in range(passes):
        side = labels
        # external minus internal edge weight per vertex (vectorized)
        nbl = np.where(mask, side[np.maximum(nb, 0)], -1)
        same = (nbl == side[:, None]) & mask
        diff = (nbl >= 0) & (nbl != side[:, None])
        gain = (w_e * diff).sum(axis=1) - (w_e * same).sum(axis=1)
        order = np.argsort(-gain)
        w0 = w_v[side == 0].sum()
        moved = 0
        for v in order:
            if gain[v] <= 0:
                break
            new_w0 = w0 - w_v[v] if side[v] == 0 else w0 + w_v[v]
            if not (target0 / imbalance <= new_w0 <= target0 * imbalance):
                continue
            side[v] = 1 - side[v]
            w0 = new_w0
            moved += 1
        if moved == 0:
            break
    return labels


def _bisect_multilevel(nb, mask, w_v, w_e, k_lo, k, rng, coarsen_to=64):
    """Full multilevel 2-way partition of one (sub)graph."""
    levels = []
    while nb.shape[0] > coarsen_to:
        coarse, n_c = _heavy_edge_matching(nb, mask, w_v, w_e, rng)
        if n_c >= nb.shape[0]:  # no progress
            break
        levels.append((nb, mask, w_v, w_e, coarse))
        nb, mask, w_v, w_e = _contract(nb, mask, w_v, w_e, coarse, n_c)
    labels = _grow_bisection(nb, w_v, k_lo, k, rng)
    labels = _refine_bisection(nb, mask, w_v, w_e, labels, k_lo, k)
    for nb_f, mask_f, wv_f, we_f, coarse in reversed(levels):
        labels = labels[coarse]
        labels = _refine_bisection(nb_f, mask_f, wv_f, we_f, labels,
                                   k_lo, k)
    return labels


def multilevel_partition(neighbors: np.ndarray, n_parts: int,
                         seed: int = 0) -> np.ndarray:
    """k-way multilevel partition by recursive bisection.

    ``neighbors`` is the [n, max_deg] face-adjacency array (−1 padded);
    returns labels [n] in 0..n_parts-1.
    """
    nb, mask = _adjacency_lists(neighbors)
    n = nb.shape[0]
    rng = np.random.default_rng(seed)
    labels = np.zeros(n, dtype=np.int64)

    def rec(idx, k, base):
        if k <= 1 or idx.shape[0] <= 1:
            labels[idx] = base
            return
        # build the induced subgraph
        sub = np.full(n, -1, dtype=np.int64)
        sub[idx] = np.arange(idx.shape[0])
        nb_s = np.where(nb[idx] >= 0, sub[np.maximum(nb[idx], 0)], -1)
        mask_s = nb_s >= 0
        w_v = np.ones(idx.shape[0])
        w_e = mask_s.astype(np.float64)
        k_lo = k // 2
        side = _bisect_multilevel(nb_s, mask_s, w_v, w_e, k_lo, k, rng)
        rec(idx[side == 0], k_lo, base)
        rec(idx[side == 1], k - k_lo, base + k_lo)

    rec(np.arange(n), n_parts, 0)
    return labels
