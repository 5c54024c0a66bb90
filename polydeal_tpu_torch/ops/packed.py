"""K6: the PACKED banded block SpMV, the hot op of the wide-offset path.

Counterpart of ``polydeal_tpu/ops/packed.py`` ``packed_matvec_t`` (Pallas
kernel ``_packed_matvec_impl``).  Without the lex relabel the R-tree's
space-filling-curve numbering gives every level many band offsets (37 at
the 3D leaf level) while each lane (block row) touches at most 2 dim + 1 of
them.  The packed format stores each lane's nonzero blocks in K slots:

* slots are a greedy conflict colouring of the offsets (two offsets
  conflict iff they share a lane), so K = the largest row degree (7 in 3D);
* ``data_i`` [nb * R_pad, P] stores the packed blocks i-major, rows
  (i, k, j), R_pad = K * nb rounded up to 16 (the JAX package's layout, so
  one array feeds either package; padding rows are never read);
* ``oid`` [K, P] int32 says which offset index slot k holds at lane p
  (-1: none; the stored block is then zero).

:class:`PackPlan`, :func:`choose_near_limit` and :func:`build_pack_plan`
are a jax-free copy of the JAX package's host code (only the imports
differ; ``tests/test_torch_packed.py`` holds them equal).  The TPU
mechanics (lane tiles, the T-padded x, pre-rolled far copies, funnel
shifts) have no counterpart: on Hopper ``x[j, p + o]`` is a bounds-checked
load at any |o|.

On a CUDA tensor :func:`packed_matvec_t` launches the hand-written kernel
of ``csrc/packed.cu`` (and raises if it cannot); on a CPU tensor it runs
the plain PyTorch version :func:`packed_matvec_t_ref`.  K6 halo
(:func:`packed_matvec_t_halo`, the counterpart of ``packed_matvec_t_halo``)
is K6 on one shard's lane slab, x read from ``x_ext`` [nb, per + 2T]; every
plan offset must then satisfy |o| <= T (``parallel/banded.py`` repacks a
pack whose plan does not, splitting off a far block-COO tail).

bf16 vectors: K6 and K6 halo read bf16 x in the kernel, as the JAX
package's keep it (``packed.py:294``, ``:333``), accumulate in f32 and
round y to bf16 once (``csrc/packed_bf16.cu``, its own translation unit);
the band is then f32 or bf16.  The plain versions gather their windows in
bf16 and take the products in f32 likewise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from polydeal_tpu_torch.ops.banded import (
    KernelBand,
    band_layout,
    halo_check,
    launch_product,
)

__all__ = ["PackPlan", "build_pack_plan", "choose_near_limit",
           "packed_matvec_t", "packed_matvec_t_ref", "packed_band",
           "packed_matvec_t_halo", "packed_matvec_t_halo_ref"]


@dataclass(frozen=True)
class PackPlan:
    """Static packing metadata (host-built, cheaply hashable).

    offsets: sorted distinct band offsets (tuple of int).
    slots:   tuple over slots of tuples of offset INDICES (into offsets).
    """

    offsets: tuple
    slots: tuple
    P: int
    nb: int

    @property
    def K(self) -> int:
        return len(self.slots)

    @property
    def R_pad(self) -> int:
        return -(-self.K * self.nb // 16) * 16


def choose_near_limit(P: int, nb: int, K_bound: int = 8,
                      itemsize: int = 4) -> int:
    """The lane-tile size T the kernel will use — and therefore the
    near/far offset split: |o| <= T is served by the prev/cur/next
    funnel-shift windows; |o| > T blocks (rare: the SFC ordering's
    block-crossing tail, <1% of lanes) go to the block-COO side term."""
    R_pad = -(-K_bound * nb // 16) * 16
    t = 4096
    while t >= 128:
        if P % t == 0 and nb * R_pad * t * itemsize <= 2 * 2**20:
            return t
        t //= 2
    return 128


def build_pack_plan(src: np.ndarray, dst: np.ndarray, P: int, nb: int,
                    offsets: np.ndarray | None = None,
                    near_limit: int | None = None):
    """Color the offsets of the directed block sparsity into
    conflict-free slots, optionally splitting off a far block-COO tail.

    src/dst: block row/col ids of the off-diagonal nonzero blocks (one
    direction suffices — the transpose direction and the diagonal are
    added here).

    ``near_limit``: -1 colors ALL offsets into slots (far offsets are
    then served in-kernel from pre-rolled x copies — the single-chip
    fast path); a positive value splits |o| > near_limit into the
    block-COO tail (required on shards, where global rolls are invalid);
    None picks the kernel's default tile.

    Returns (plan, oid, far_rows, far_cols):
      plan      static PackPlan over the colored offsets,
      oid       [K, P] int32 (-1 = inactive slot at that lane),
      far_rows/far_cols [n_far] int64, sorted by (offset, row) — the
                order to_packed extracts far blocks in.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # unique directed pairs, both directions, plus the diagonal
    key = np.unique(np.concatenate([src * P + dst, dst * P + src]))
    ua, ub = key // P, key % P
    rows = np.concatenate([ua, np.arange(P, dtype=np.int64)])
    offs = np.concatenate([ub - ua, np.zeros(P, dtype=np.int64)])

    if near_limit is None:
        near_limit = choose_near_limit(P, nb)
    if near_limit < 0:
        far = np.zeros(offs.shape[0], dtype=bool)
    else:
        far = np.abs(offs) > near_limit
    forder = np.lexsort((rows[far], offs[far]))
    far_rows = rows[far][forder]
    far_cols = far_rows + offs[far][forder]
    rows, offs = rows[~far], offs[~far]

    all_offsets = (np.unique(offs) if offsets is None
                   else np.asarray(offsets, dtype=np.int64))
    if near_limit >= 0:
        all_offsets = all_offsets[np.abs(all_offsets) <= near_limit]
    oidx = np.searchsorted(all_offsets, offs)
    assert (all_offsets[oidx] == offs).all(), "offsets must cover sparsity"
    n_o = all_offsets.shape[0]

    # conflict graph: offsets sharing a lane
    order = np.lexsort((oidx, rows))
    r_s, i_s = rows[order], oidx[order]
    conflict = np.zeros((n_o, n_o), dtype=bool)
    breaks = np.flatnonzero(np.diff(r_s)) + 1
    for r in np.split(i_s, breaks):
        conflict[np.ix_(r, r)] = True
    np.fill_diagonal(conflict, False)

    counts = np.bincount(oidx, minlength=n_o)
    slot_of = np.full(n_o, -1, dtype=np.int64)
    for o in np.argsort(-counts, kind="stable"):
        used = set(slot_of[conflict[o]]) - {-1}
        s = 0
        while s in used:
            s += 1
        slot_of[o] = s
    K = int(slot_of.max()) + 1
    slots = tuple(
        tuple(int(i) for i in np.flatnonzero(slot_of == k)) for k in range(K)
    )
    oid = np.full((K, P), -1, dtype=np.int32)
    oid[slot_of[oidx], rows] = oidx.astype(np.int32)
    plan = PackPlan(offsets=tuple(int(o) for o in all_offsets), slots=slots,
                    P=P, nb=nb)
    return plan, oid, far_rows, far_cols


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """K6's accumulator: f32 for bf16 vectors, the vectors' dtype
    otherwise."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def packed_matvec_t_ref(data_i: torch.Tensor, oid: torch.Tensor, offsets,
                        nb: int, xt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6, accumulating in ``xt``'s dtype (f32 for
    bf16 x): per slot, gather x[:, p + offsets[oid[k, p]]] (an exact zero
    where the slot is inactive or the column leaves [0, P)), then one
    einsum over the [nb, K, nb, P] view of ``data_i``; y in ``xt``'s
    dtype."""
    K, P = oid.shape
    R_pad = data_i.shape[0] // nb
    acc = _acc_dtype(xt)
    dev = xt.device
    offs = torch.as_tensor(offsets, device=dev).long()
    o = oid.long()
    q = torch.arange(P, device=dev) + offs[o.clamp(min=0)]  # [K, P]
    live = (o >= 0) & (q >= 0) & (q < P)
    Xg = xt[:, q.clamp(0, P - 1)]  # [nb, K, P], in x's dtype
    Xg = torch.where(live, Xg, torch.zeros((), dtype=xt.dtype, device=dev))
    D = (data_i.reshape(nb, R_pad, P)[:, :K * nb]
         .reshape(nb, K, nb, P).to(acc))
    return torch.einsum("ikjp,jkp->ip", D, Xg.to(acc)).to(xt.dtype)


def packed_band(data_i, oid, offsets, nb) -> KernelBand:
    """Validate a packed band for K6/K7 (``band_layout`` with K slots a
    lane, and its oid); a bf16 band serves K6 with bf16 vectors only."""
    if (oid.dtype != torch.int32 or oid.dim() != 2
            or oid.device != data_i.device or not oid.is_contiguous()):
        raise ValueError("oid must be a contiguous [K, P] int32 tensor on "
                         "the band's device")
    K = oid.shape[0]
    n_off, R_pad, P = band_layout(data_i, offsets, nb, n_slots=K)
    if oid.shape[1] != P:
        raise ValueError(f"oid {tuple(oid.shape)} is not [K, {P}]")
    return KernelBand("packed", data_i, nb, P, n_off, R_pad,
                      (oid.data_ptr(), offsets.data_ptr(), n_off, K, nb,
                       R_pad, P), offsets, (oid,))


def packed_matvec_t(data_i: torch.Tensor, oid: torch.Tensor, offsets,
                    nb: int, xt: torch.Tensor, *,
                    band: KernelBand | None = None) -> torch.Tensor:
    """y[i, p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] *
    x[j, p + offsets[oid[k, p]]], inactive slots adding nothing.

    ``offsets`` is the plan's int32 offset table on the band's device (as
    K1 takes its offsets); ``band`` this pack's :func:`packed_band`, if the
    caller keeps one.  ``xt`` is f32, f64 or bf16 (read as bf16 by the
    kernel, accumulated in f32).  Returns y [nb, P] in ``xt``'s dtype."""
    if xt.device.type == "cpu":
        return packed_matvec_t_ref(data_i, oid, offsets, nb, xt)
    if band is None:
        band = packed_band(data_i, oid, offsets, nb)
    return launch_product(band, xt)


def packed_matvec_t_halo_ref(data_i: torch.Tensor, oid: torch.Tensor,
                             offsets, nb: int, x_ext: torch.Tensor, *,
                             tile: int) -> torch.Tensor:
    """Plain PyTorch version of K6 halo, accumulating in ``x_ext``'s dtype
    (f32 for bf16): slot k of lane p reads x_ext[:, T + p +
    offsets[oid[k, p]]] (inside the slab's window, no padding), an exact
    zero where the slot is inactive; y in ``x_ext``'s dtype."""
    K, P = oid.shape
    halo_check(offsets, P, x_ext, tile)
    R_pad = data_i.shape[0] // nb
    acc = _acc_dtype(x_ext)
    dev = x_ext.device
    offs = torch.as_tensor(offsets, device=dev).long()
    o = oid.long()
    q = tile + torch.arange(P, device=dev) + offs[o.clamp(min=0)]  # [K, P]
    Xg = torch.where(o >= 0, x_ext[:, q],
                     torch.zeros((), dtype=x_ext.dtype,
                                 device=dev))  # [nb, K, P], in x's dtype
    D = (data_i.reshape(nb, R_pad, P)[:, :K * nb]
         .reshape(nb, K, nb, P).to(acc))
    return torch.einsum("ikjp,jkp->ip", D, Xg.to(acc)).to(x_ext.dtype)


def packed_matvec_t_halo(data_i: torch.Tensor, oid: torch.Tensor, offsets,
                         nb: int, x_ext: torch.Tensor, *, tile: int,
                         band: KernelBand | None = None) -> torch.Tensor:
    """K6 on one shard's lane slab: y[i, p] = sum_k sum_j
    data_i[i*R_pad + k*nb + j, p] * x_ext[j, T + p + offsets[oid[k, p]]].

    ``x_ext`` [nb, per + 2T] f32, f64 or bf16; ``tile`` is T, and every
    plan offset must be within it (raises otherwise, and on a wrong
    ``x_ext`` width).  A far block-COO tail is the caller's.  Returns y
    [nb, per] in ``x_ext``'s dtype."""
    if x_ext.device.type == "cpu":
        return packed_matvec_t_halo_ref(data_i, oid, offsets, nb, x_ext,
                                        tile=tile)
    if band is None:
        band = packed_band(data_i, oid, offsets, nb)
    return launch_product(band, x_ext, halo=tile)
