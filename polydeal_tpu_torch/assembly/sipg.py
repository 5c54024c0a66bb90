"""SIPG assembly straight into the banded layout, on torch tensors.

Counterpart of the direct banded path of ``polydeal_tpu/assembly/sipg.py``:
``build_banded_groups`` pads the face, boundary and cell tables per
polytope slot on the host, and ``assemble_sipg_banded_direct`` turns them
into the band with the volume, face group and boundary block kernels
(K3-K5, ``ops/sipg_kernels.py``), sums over the padded slots and lane
rolls -- no scatters or gathers; with a pack plan it emits the packed
format (``sparse.BlockPacked``) directly.  The tensors' device decides, as
the JAX package's backend does: on a CUDA tensor the blocks come from the
hand-written kernels (the JAX package's TPU branch), on a CPU tensor from
their plain einsum versions (its ``use_pallas=False`` branch).

Penalty: gamma = penalty_constant / h_F with penalty_constant =
10 (p + dim)(p + 1) and h_F the diameter of the smaller-id polytope, as in
the reference (poly_utils.h:2017-2019, 2057).
"""

from __future__ import annotations

import numpy as np
import torch

from polydeal_tpu_torch.handler import AgglomerationHandler
from polydeal_tpu_torch.ops.sipg_kernels import (
    boundary_blocks,
    face_group_blocks,
    volume_blocks,
)
from polydeal_tpu_torch.sparse import BlockBanded, BlockPacked, pack_blocks
from polydeal_tpu_torch.utils.grouping import padded_group_lists

__all__ = [
    "default_penalty_constant",
    "dirichlet_face_mask",
    "build_banded_groups",
    "assemble_rhs_direct",
    "assemble_sipg_banded_direct",
    "assemble_mass_banded_direct",
]


def default_penalty_constant(degree: int, dim: int) -> float:
    """10 (p + dim)(p + 1), cf. reference poly_utils.h:2017-2019."""
    return 10.0 * (degree + dim) * (degree + 1)


def dirichlet_face_mask(ah, dirichlet_ids) -> np.ndarray:
    """Static bool mask over ah.faces.boundary() rows: True = Dirichlet.

    ``dirichlet_ids=None`` means Dirichlet everywhere; otherwise only faces
    whose boundary id is listed get the Nitsche terms."""
    fb = ah.faces.boundary()
    if dirichlet_ids is None:
        return np.ones(fb.n_faces, dtype=bool)
    bid = (fb.boundary_id if fb.boundary_id is not None
           else np.zeros(fb.n_faces, dtype=np.int32))
    return np.isin(bid, np.asarray(list(dirichlet_ids)))


def build_banded_groups(ah: AgglomerationHandler, offsets: np.ndarray,
                        dtype=torch.float64, *, device,
                        dirichlet_ids=None) -> dict:
    """Slot-padded, entity-last tables: the banded assembly inputs.

    Interior faces are grouped by (offset, poly_in) into [C, q, ..., P]
    tables (C = most faces one polytope pair contributes), boundary faces
    and cells by polytope.  Padded slots carry zero weights (and h_f = 1),
    so they contribute exact zeros.  Only the IN-side unit points are
    stored: the out side is the same physical points pulled back into the
    neighbour's box, computed by the assembly.

    Returns a dict of tensors on ``device`` with the same keys as the JAX
    package's: groups {offset: {w, n, h_f, pts_in}}, bdry, vol {pts, w},
    ext_t and lo_t [dim, P]."""
    P = ah.n_poly
    ft = ah.faces
    offsets = np.asarray(offsets, dtype=np.int64)

    def put(a):  # contiguous, as the kernels take them
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def face_group(rows: np.ndarray, by: np.ndarray):
        members, _ = padded_group_lists(by, P) if rows.size else (
            np.full((P, 1), -1, dtype=np.int64), None)
        mask = members >= 0
        safe = np.where(mask, rows[np.maximum(members, 0)], 0)
        C = members.shape[1]
        s = safe.reshape(-1)
        pts = ft.points_in[s].reshape(P, C, *ft.points_in.shape[1:])
        pts = np.where(mask.reshape(P, C, 1, 1), pts, 0.5)
        w = ft.weights[s].reshape(P, C, -1)
        w = np.where(mask[:, :, None], w, 0.0)
        n = ft.normals[s].reshape(P, C, *ft.normals.shape[1:])
        h_f = np.where(mask, ft.h_f[safe], 1.0)
        return dict(
            w=put(np.transpose(w, (1, 2, 0))),  # [C, q, P]
            n=put(np.transpose(n, (1, 2, 3, 0))),  # [C, q, d, P]
            h_f=put(h_f.T),  # [C, P]
            pts_in=put(np.transpose(pts, (1, 2, 3, 0))),  # [C, q, d, P]
        )

    interior = ~ft.is_boundary
    off_of = np.where(interior, ft.poly_out - ft.poly_in, 0)
    groups = {}
    for o in (int(o) for o in offsets if o > 0):
        rows = np.where(interior & (off_of == o))[0]
        if rows.size:
            groups[o] = face_group(rows, ft.poly_in[rows])
    b_rows = np.where(ft.is_boundary)[0][dirichlet_face_mask(ah,
                                                             dirichlet_ids)]
    bdry = face_group(b_rows, ft.poly_in[b_rows]) if b_rows.size else None

    # volume: padded cells per polytope, entity-last
    members = ah.poly2cells  # [P, Cc]
    maskc = members >= 0
    s = np.maximum(members, 0).reshape(-1)
    Cc = members.shape[1]
    upts = ah.cell_qpoints_unit[s].reshape(
        P, Cc, *ah.cell_qpoints_unit.shape[1:])
    upts = np.where(maskc[:, :, None, None], upts, 0.5)
    wv = ah.cell_qweights[s].reshape(P, Cc, -1)
    wv = np.where(maskc[:, :, None], wv, 0.0)
    vol = dict(pts=put(np.transpose(upts, (1, 2, 3, 0))),
               w=put(np.transpose(wv, (1, 2, 0))))
    return dict(groups=groups, bdry=bdry, vol=vol,
                ext_t=put(ah.extents.T), lo_t=put(ah.bbox_lo.T))


def assemble_rhs_direct(ah: AgglomerationHandler, tables: dict, f_fn,
                        g_fn=None, penalty_constant: float | None = None,
                        basis=None) -> torch.Tensor:
    """Flat RHS over the slot-padded tables: int f v plus the Dirichlet
    Nitsche data terms.  ``f_fn``/``g_fn`` map real points [..., dim]
    tensors to values [...]."""
    basis = basis or ah.basis
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    ext_t, lo_t = tables["ext_t"], tables["lo_t"]

    def real_pts(unit):  # [C, q, d, P] -> [C, q, P, d] real coords
        r = lo_t[None, None] + unit * ext_t[None, None]
        return torch.movedim(r, 2, -1)

    vol = tables["vol"]
    B = basis.eval_t(vol["pts"])  # [C, q, nb, P]
    fv = f_fn(real_pts(vol["pts"]))  # [C, q, P]
    r = torch.einsum("cqip,cqp,cqp->ip", B, vol["w"], fv)

    g = tables["bdry"]
    if g_fn is not None and g is not None:
        Bb = basis.eval_t(g["pts_in"])
        Gb = basis.grad_t(g["pts_in"]) / ext_t[None, None, None]
        gn = torch.einsum("cqidp,cqdp->cqip", Gb, g["n"])
        gamma = penalty_constant / g["h_f"]  # [C, P]
        gv = g_fn(real_pts(g["pts_in"]))  # [C, q, P]
        r = r + torch.einsum(
            "cqip,cqp,cqp->ip",
            Bb * gamma[:, None, None, :] - gn, g["w"], gv)
    return r.T.reshape(-1)


def _emit_banded(pieces, offsets, nb, P, layout) -> BlockBanded:
    """Final banded container from per-offset [nb, nb, P] pieces;
    ``layout='imajor'`` emits only the i-major copy (rows (i, k, j),
    8-aligned i-slabs), never materializing the o-major band."""
    if layout == "imajor":
        n_off = offsets.shape[0]
        R = n_off * nb
        R_pad = -(-R // 8) * 8
        slabs = []
        for i in range(nb):
            slab = torch.cat([pc[i] for pc in pieces], dim=0)
            if R_pad != R:
                slab = torch.cat(
                    [slab, slab.new_zeros((R_pad - R, P))], dim=0)
            slabs.append(slab)
        data_i = torch.cat(slabs, dim=0)
        empty = data_i.new_zeros((n_off, nb, nb, 0))
        return BlockBanded(data=empty, offsets=offsets, n_block_cols=P,
                           data_i=data_i)
    if layout != "omajor":
        raise ValueError(f"unknown band layout: {layout!r}")
    return BlockBanded(data=torch.stack(pieces, dim=0), offsets=offsets,
                       n_block_cols=P)


def _emit_packed(pieces, offsets, plan, oid) -> BlockPacked:
    """BlockPacked straight from the per-offset [nb, nb, P] band pieces,
    with the selection of ``BlockBanded.to_packed``: the dense band (n_off
    rows, 37 at the flagship's fine level without the relabel) is never
    stacked."""
    by_off = {int(o): pc for o, pc in zip(offsets, pieces)}
    return BlockPacked(data_i=pack_blocks(by_off.__getitem__, plan, oid),
                       oid=oid, plan=plan)


def assemble_sipg_banded_direct(
    ah: AgglomerationHandler,
    tables: dict,
    offsets: np.ndarray,
    penalty_constant: float | None = None,
    layout: str = "omajor",
    pack_plan=None,
    pack_oid: torch.Tensor | None = None,
) -> BlockBanded | BlockPacked:
    """Banded SIPG matrix over slot-padded tables (see
    :func:`build_banded_groups`): the block kernels K3-K5, sums over the
    padded slots and lane rolls, no scatters or gathers.  Sign conventions
    follow the reference kernel (poly_utils.h:1870-1926); normals point
    outward from poly_in.  With ``pack_plan`` (a ``PackPlan`` over these
    offsets) and ``pack_oid`` (its [K, P] int32 slot table on the tables'
    device) the result is emitted packed instead."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    P, nb, deg, dim = ah.n_poly, ah.n_basis, ah.degree, ah.dim
    offsets = np.asarray(offsets, dtype=np.int64)
    ext_t = tables["ext_t"]  # [dim, P]
    lo_t = tables["lo_t"]  # [dim, P]

    diag = volume_blocks(tables["vol"], ext_t, deg, dim).reshape(nb, nb, P)
    rows = {int(o): None for o in offsets}
    for o, g in tables["groups"].items():
        m11, m12, m21, m22 = (
            m.reshape(nb, nb, P) for m in face_group_blocks(
                g, ext_t, lo_t, o, deg, dim, penalty_constant))
        # m22 and m21 belong to poly_out = p + o: roll them onto its lane
        diag = diag + m11 + torch.roll(m22, o, dims=-1)
        rows[o] = m12 if rows[o] is None else rows[o] + m12
        m21r = torch.roll(m21, o, dims=-1)
        rows[-o] = m21r if rows[-o] is None else rows[-o] + m21r
    if tables["bdry"] is not None:
        diag = diag + boundary_blocks(tables["bdry"], ext_t, deg, dim,
                                      penalty_constant).reshape(nb, nb, P)

    zero = diag.new_zeros((nb, nb, P))
    pieces = [diag if o == 0 else (rows[int(o)] if rows[int(o)] is not None
                                   else zero)
              for o in offsets]
    if pack_plan is not None:
        return _emit_packed(pieces, offsets, pack_plan, pack_oid)
    return _emit_banded(pieces, offsets, nb, P, layout)


def assemble_mass_banded_direct(ah: AgglomerationHandler, tables: dict,
                                coeff_fn=None, basis=None) -> torch.Tensor:
    """Block-diagonal mass matrix over the slot-padded tables, in the
    band-row layout [nb, nb, P] (add it to a band's offset-0 row).  An
    einsum, as in the JAX package: no TPU kernel computes it.
    ``coeff_fn`` maps real points [..., dim] to a coefficient [...]."""
    basis = basis or ah.basis
    vol = tables["vol"]
    B = basis.eval_t(vol["pts"])  # [C, q, nb, P]
    w = vol["w"]
    if coeff_fn is not None:
        ext_t, lo_t = tables["ext_t"], tables["lo_t"]
        r = lo_t[None, None] + vol["pts"] * ext_t[None, None]
        w = w * coeff_fn(torch.movedim(r, 2, -1))
    return torch.einsum("cqip,cqjp,cqp->ijp", B, B, w)
