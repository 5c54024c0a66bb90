"""Deterministic segment sums over static host labels.

The JAX package reduces with ``jax.ops.segment_sum``; its counterpart here,
``index_add_``, adds with float atomics on a CUDA tensor, so the order of
a sum -- and its rounding -- changes from run to run.  A
:class:`SegmentSum` instead gathers each segment's members through their
padded lists (``utils/grouping.padded_group_lists``, members in ascending
order) and sums over the padded axis: one fixed order on a device, so two
runs agree bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from polydeal_tpu_torch.utils.grouping import padded_group_lists

__all__ = ["SegmentSum", "segment_sum"]


class SegmentSum:
    """out[s] = sum of data[i] over labels[i] == s, for ``n_seg`` segments
    (empty ones give zero); the labels are fixed at construction, so one
    instance serves every reduction over them."""

    def __init__(self, labels, n_seg: int, device):
        members, _ = padded_group_lists(np.asarray(labels), n_seg)
        self.shape = members.shape  # [n_seg, C]
        self.idx = torch.as_tensor(np.maximum(members, 0).reshape(-1),
                                   device=device)
        pad = members < 0
        self.pad = torch.as_tensor(pad, device=device) if pad.any() else None

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        g = data[self.idx].reshape(self.shape + tuple(data.shape[1:]))
        if self.pad is not None:
            pad = self.pad.reshape(self.shape + (1,) * (data.dim() - 1))
            g = g.masked_fill(pad, 0)
        return g.sum(dim=1)


def segment_sum(data: torch.Tensor, labels, n_seg: int) -> torch.Tensor:
    """One deterministic segment sum (see :class:`SegmentSum`)."""
    return SegmentSum(labels, n_seg, data.device)(data)
