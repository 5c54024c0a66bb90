"""Carry the JAX package's objects, given as numpy arrays, into the port.

The two packages share layouts on purpose: a block-COO matrix, its
block-ELL form, a band, its i-major copy, a pack, the slot-padded assembly tables, the transfer embeddings, the
monodomain state, a mixed operator's merged blocks and an SA-AMG
hierarchy are the same arrays in both.  These helpers build the
port's objects from those arrays, so tests can run both packages on the
same band and tables.
Nothing here imports jax: the caller converts with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from polydeal_tpu_torch.ops.packed import PackPlan
from polydeal_tpu_torch.solvers.multigrid import Transfer
from polydeal_tpu_torch.sparse import (
    BlockBanded,
    BlockELL,
    BlockMatrix,
    BlockPacked,
)

__all__ = ["block_matrix_from_arrays", "ell_from_arrays",
           "banded_from_arrays", "packed_from_arrays", "groups_from_arrays",
           "transfer_from_arrays", "monodomain_state_from_arrays",
           "mixed_operator_from_arrays", "amg_from_arrays"]


def _t(a, device):
    # a copy: arrays from jax are read-only views
    return torch.as_tensor(np.array(a), device=device)


def block_matrix_from_arrays(data, rows, cols, n_block_rows: int,
                             n_block_cols: int, *, device) -> BlockMatrix:
    """BlockMatrix from a JAX ``BlockMatrix``'s ``data`` [nnz, nb, nb] and
    its sorted ``rows``/``cols``."""
    return BlockMatrix(data=_t(data, device),
                       rows=np.asarray(rows, dtype=np.int64),
                       cols=np.asarray(cols, dtype=np.int64),
                       n_block_rows=int(n_block_rows),
                       n_block_cols=int(n_block_cols))


def ell_from_arrays(data, cols, n_block_cols: int, *, device) -> BlockELL:
    """BlockELL from a JAX ``BlockELL``'s ``data`` [P, K, nb, nb] and
    ``cols`` [P, K]."""
    return BlockELL(data=_t(data, device),
                    cols=np.asarray(cols, dtype=np.int32),
                    n_block_cols=int(n_block_cols))


def banded_from_arrays(data, offsets, n_block_cols: int, data_i=None, *,
                       device) -> BlockBanded:
    """BlockBanded from a JAX band's ``data`` [n_off, nb, nb, P] (possibly
    zero-length when its o-major copy was dropped), ``offsets``,
    ``n_block_cols`` and optional i-major ``data_i`` [nb * R_pad, P]."""
    return BlockBanded(
        data=_t(data, device), offsets=np.asarray(offsets),
        n_block_cols=int(n_block_cols),
        data_i=None if data_i is None else _t(data_i, device))


def packed_from_arrays(data_i, oid, offsets, slots, nb: int, far_data=None,
                       far_rows=None, far_cols=None, *,
                       device) -> BlockPacked:
    """BlockPacked from a JAX pack's ``data_i`` [nb * R_pad, P], ``oid``
    [K, P] and its plan's ``offsets`` and ``slots`` (plus its far tail,
    if any)."""
    data_i = _t(data_i, device)
    plan = PackPlan(offsets=tuple(int(o) for o in offsets),
                    slots=tuple(tuple(int(i) for i in s) for s in slots),
                    P=data_i.shape[-1], nb=int(nb))
    far = far_data is not None
    return BlockPacked(
        data_i=data_i, oid=_t(np.asarray(oid, dtype=np.int32), device),
        plan=plan, far_data=_t(far_data, device) if far else None,
        far_rows=np.asarray(far_rows) if far else None,
        far_cols=np.asarray(far_cols) if far else None)


def groups_from_arrays(groups: dict, *, device) -> dict:
    """The ``build_banded_groups`` dict (nested dicts of arrays, ``bdry``
    possibly None) with every array as a tensor on ``device``."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return _t(v, device)

    return conv(groups)


def transfer_from_arrays(E, parent, n_coarse: int, grid_shape=None, *,
                         device) -> Transfer:
    """Transfer from a JAX ``Transfer``'s ``E`` [P_f, nb, nb] and
    ``parent`` map (plus its ``grid_shape``, if any)."""
    return Transfer(E=_t(E, device), parent=np.asarray(parent),
                    n_coarse=int(n_coarse),
                    grid_shape=None if grid_shape is None
                    else tuple(grid_shape))


def monodomain_state_from_arrays(u, u_prev, w, *, device) -> tuple:
    """(u, u_prev, w) tensors from a JAX monodomain state in its layouts:
    ``u`` and ``u_prev`` [n_dofs], the gating state ``w`` [3, C, q, P]."""
    return _t(u, device), _t(u_prev, device), _t(w, device)


def mixed_operator_from_arrays(space, merged: dict, *, device):
    """MixedOperator on the port's ``space`` from a JAX
    ``MixedOperator.finalize()``: {(test, trial): (rows, cols, data)} with
    field-local block rows/cols and data [n, block_test, block_trial]."""
    from polydeal_tpu_torch.assembly.mixed import MixedOperator

    op = MixedOperator(space)
    for (test, trial), (rows, cols, data) in merged.items():
        op.add(test, trial, np.asarray(rows), np.asarray(cols),
               _t(data, device))
    return op


def amg_from_arrays(As, Ps, Pts, dinvs, los, his, coarse_inv,
                    chebyshev_degree: int, n_smooth: int, *, device):
    """AMG from a JAX ``AMG``'s levels (coarse to fine): ``As``, ``Ps``
    and ``Pts`` as (data, rows, cols, n_block_rows, n_block_cols) block-COO
    tuples (None at the coarsest level of ``Ps``/``Pts``), ``dinvs``,
    the Chebyshev intervals ``los``/``his`` and the dense ``coarse_inv``."""
    from polydeal_tpu_torch.solvers.amg import AMG

    def bm(m):
        return None if m is None else block_matrix_from_arrays(
            *m, device=device)

    return AMG(As=[bm(m) for m in As], Ps=[bm(m) for m in Ps],
               Pts=[bm(m) for m in Pts],
               dinvs=[_t(d, device) for d in dinvs],
               los=[float(v) for v in los], his=[float(v) for v in his],
               coarse_inv=_t(coarse_inv, device),
               chebyshev_degree=int(chebyshev_degree),
               n_smooth=int(n_smooth))
