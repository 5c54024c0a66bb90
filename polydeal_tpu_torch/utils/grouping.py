"""Padded group lists: the central gather-map builder.

Given integer labels (cell->polytope, fine-poly->parent, face->polytope,
...), build the padded inverse map [n_groups, C] of member indices plus a
mask — the structure every scatter-free TPU reduction in this framework
gathers through.  Fully vectorized (no Python loop over groups); the C++
host library (csrc/) provides a faster path for very large meshes.

Port note: a jax-free copy of ``polydeal_tpu/utils/grouping.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["padded_group_lists"]


def padded_group_lists(labels: np.ndarray, n_groups: int,
                       pad_value: int = -1):
    """Returns (members [n_groups, C] padded with pad_value,
    counts [n_groups]); C = max group size.

    members[g, :counts[g]] are the indices i with labels[i] == g, in
    ascending order.
    """
    labels = np.asarray(labels)
    n = labels.shape[0]
    counts = np.bincount(labels, minlength=n_groups)
    C = max(int(counts.max()), 1) if n else 1
    order = np.argsort(labels, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(n) - starts[labels[order]]
    members = np.full((n_groups, C), pad_value, dtype=np.int64)
    members[labels[order], pos] = order
    return members, counts
