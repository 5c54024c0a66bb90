"""SIPG assembly on torch tensors: the table path into a block-COO
matrix, and straight into the banded layout.

Counterpart of ``polydeal_tpu/assembly/sipg.py``.  The table path
(``build_volume_tables``, ``build_face_tables``, ``assemble_sipg_matrix``,
``assemble_rhs``, ``mass_matrix``, ``project``) evaluates the basis at
every fine cell's and fine face's quadrature points and reduces the
per-cell and per-face blocks onto polytopes and polytope pairs with
deterministic segment sums (``utils/segment.py``): plain einsums, as the
JAX package computes them in XLA outside any kernel.  The direct banded
path: ``build_banded_groups`` pads the face, boundary and cell tables per
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

from dataclasses import dataclass, replace

import numpy as np
import torch

from polydeal_tpu_torch.handler import AgglomerationHandler
from polydeal_tpu_torch.ops.sipg_kernels import (
    boundary_blocks,
    face_group_blocks,
    volume_blocks,
)
from polydeal_tpu_torch.sparse import (
    BlockBanded,
    BlockMatrix,
    BlockPacked,
    pack_blocks,
)
from polydeal_tpu_torch.utils.grouping import padded_group_lists
from polydeal_tpu_torch.utils.segment import segment_sum

__all__ = [
    "default_penalty_constant",
    "dirichlet_face_mask",
    "VolumeTables",
    "FaceTables",
    "build_volume_tables",
    "build_face_tables",
    "assemble_sipg_matrix",
    "assemble_rhs",
    "mass_matrix",
    "project",
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


@dataclass
class VolumeTables:
    """Dense per-fine-cell shape tables in the owning polytope's basis."""

    B: torch.Tensor  # [n_c, q, nb] values
    G: torch.Tensor  # [n_c, q, nb, dim] real-space gradients
    w: torch.Tensor  # [n_c, q] JxW
    x: torch.Tensor  # [n_c, q, dim] real points
    cell2poly: np.ndarray  # [n_c], host


@dataclass
class FaceTables:
    """Shape tables at interface quadrature points: both sides of an
    interior face (suffix 0 = poly_in, 1 = poly_out), side 0 only of a
    boundary face."""

    B0: torch.Tensor  # [n_f, qf, nb]
    G0: torch.Tensor  # [n_f, qf, nb, dim]
    B1: torch.Tensor | None
    G1: torch.Tensor | None
    w: torch.Tensor  # [n_f, qf]
    n: torch.Tensor  # [n_f, qf, dim]
    x: torch.Tensor  # [n_f, qf, dim] real points
    h_f: torch.Tensor  # [n_f]
    poly_in: np.ndarray  # host
    poly_out: np.ndarray | None  # host

    def select(self, rows: np.ndarray) -> "FaceTables":
        """The one-sided tables of the boundary rows ``rows``."""
        r = torch.as_tensor(rows, device=self.w.device)
        return FaceTables(B0=self.B0[r], G0=self.G0[r], B1=None, G1=None,
                          w=self.w[r], n=self.n[r], x=self.x[r],
                          h_f=self.h_f[r], poly_in=self.poly_in[rows],
                          poly_out=None)


def build_volume_tables(ah: AgglomerationHandler, dtype=torch.float64,
                        basis=None, *, device) -> VolumeTables:
    """Shape tables for ``basis`` (default: the handler's own) at the
    handler's composite quadrature."""
    basis = basis or ah.basis

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    pts = put(ah.cell_qpoints_unit)
    ext = put(ah.extents[ah.cell2poly])  # [n_c, dim]
    return VolumeTables(
        B=basis.eval(pts), G=basis.grad(pts) / ext[:, None, None, :],
        w=put(ah.cell_qweights), x=put(ah.cell_qpoints_real),
        cell2poly=ah.cell2poly)


def build_face_tables(ah: AgglomerationHandler, dtype=torch.float64,
                      basis=None, h_scale: str = "diameter", *, device):
    """Returns (interior: FaceTables, boundary: FaceTables).

    ``h_scale='orthogonal'`` replaces the penalty length h_f (the polytope
    bbox diameter by default) with the face-orthogonal depth
    (``metrics.face_h_orthogonal``); ``'orthogonal_exact'`` with its exact
    ray-shooting variant."""
    basis = basis or ah.basis
    faces = ah.faces
    if h_scale in ("orthogonal", "orthogonal_exact"):
        from polydeal_tpu_torch.metrics import face_h_orthogonal

        method = "exact" if h_scale == "orthogonal_exact" else "sampled"
        faces = replace(faces, h_f=face_h_orthogonal(ah, method=method))
    elif h_scale != "diameter":
        raise ValueError(f"unknown h_scale: {h_scale}")

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def side(poly, unit_pts):
        pts = put(unit_pts)
        ext = put(ah.extents[poly])
        return basis.eval(pts), basis.grad(pts) / ext[:, None, None, :]

    out = []
    for part, both_sides in ((faces.interior(), True),
                             (faces.boundary(), False)):
        B0, G0 = side(part.poly_in, part.points_in)
        B1 = G1 = p_out = None
        if both_sides:
            p_out = part.poly_out
            B1, G1 = side(p_out, part.points_out)
        out.append(FaceTables(
            B0=B0, G0=G0, B1=B1, G1=G1, w=put(part.weights),
            n=put(part.normals), x=put(part.points_real), h_f=put(part.h_f),
            poly_in=part.poly_in, poly_out=p_out))
    return out[0], out[1]


def _blk(a, b, wgt):
    return torch.einsum("fqi,fqj,fq->fij", a, b, wgt)


def _interior_blocks(ft: FaceTables, penalty_constant: float):
    """The four SIPG jump/average blocks per interior fine face; sign
    conventions of the reference kernel (poly_utils.h:1870-1926), the
    normal outward from poly_in.  The penalty is penalty_constant / h_f,
    rounded as the JAX package's table path rounds it."""
    gamma = (penalty_constant / ft.h_f)[:, None]  # [n_f, 1]
    gn0 = torch.einsum("fqid,fqd->fqi", ft.G0, ft.n)
    gn1 = torch.einsum("fqid,fqd->fqi", ft.G1, ft.n)
    w = ft.w
    wg = w * gamma
    M11 = (-0.5 * _blk(gn0, ft.B0, w) - 0.5 * _blk(ft.B0, gn0, w)
           + _blk(ft.B0, ft.B0, wg))
    M12 = (0.5 * _blk(gn0, ft.B1, w) - 0.5 * _blk(ft.B0, gn1, w)
           - _blk(ft.B0, ft.B1, wg))
    M21 = (-0.5 * _blk(gn1, ft.B0, w) + 0.5 * _blk(ft.B1, gn0, w)
           - _blk(ft.B1, ft.B0, wg))
    M22 = (0.5 * _blk(gn1, ft.B1, w) + 0.5 * _blk(ft.B1, gn1, w)
           + _blk(ft.B1, ft.B1, wg))
    return M11, M12, M21, M22


def _boundary_block(fb: FaceTables, penalty_constant: float):
    """Weak-Dirichlet boundary block (full-weight terms,
    poly_utils.h:2065-2082)."""
    gamma = (penalty_constant / fb.h_f)[:, None]
    gn = torch.einsum("fqid,fqd->fqi", fb.G0, fb.n)
    w = fb.w
    return (-_blk(fb.B0, gn, w) - _blk(gn, fb.B0, w)
            + _blk(fb.B0, fb.B0, w * gamma))


def assemble_sipg_matrix(
    ah: AgglomerationHandler,
    penalty_constant: float | None = None,
    include_boundary: bool = True,
    dtype=torch.float64,
    vol: VolumeTables | None = None,
    faces: tuple | None = None,
    dirichlet_ids=None,
    *,
    device,
) -> BlockMatrix:
    """The SIPG Laplace matrix as a BlockMatrix.  ``include_boundary=
    False`` drops the boundary Nitsche terms (the configuration of the
    reference's "SIPG annihilates linears" sanity tests)."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    if vol is None:
        vol = build_volume_tables(ah, dtype, device=device)
    if faces is None:
        faces = build_face_tables(ah, dtype, device=device)
    fi, fb = faces
    P = ah.n_poly

    # volume: per-cell stiffness, reduced onto polytopes
    A_cell = torch.einsum("cqid,cqjd,cq->cij", vol.G, vol.G, vol.w)
    A_diag = segment_sum(A_cell, vol.cell2poly, P)

    rows, cols, datas = [np.arange(P)], [np.arange(P)], []
    if fi.poly_in.shape[0] > 0:
        M11, M12, M21, M22 = _interior_blocks(fi, penalty_constant)
        A_diag = A_diag + segment_sum(M11, fi.poly_in, P)
        A_diag = A_diag + segment_sum(M22, fi.poly_out, P)
        # merge the off-diagonal blocks per polytope pair
        key = fi.poly_in.astype(np.int64) * P + fi.poly_out
        pairs, pair_id = np.unique(key, return_inverse=True)
        pin = (pairs // P).astype(np.int64)
        pout = (pairs % P).astype(np.int64)
        pair_id = pair_id.reshape(-1)
        rows += [pin, pout]
        cols += [pout, pin]
        datas += [segment_sum(M12, pair_id, pairs.shape[0]),
                  segment_sum(M21, pair_id, pairs.shape[0])]

    if include_boundary and fb.poly_in.shape[0] > 0:
        sel = np.where(dirichlet_face_mask(ah, dirichlet_ids))[0]
        if sel.shape[0]:
            fbd = fb.select(sel)
            A_diag = A_diag + segment_sum(
                _boundary_block(fbd, penalty_constant), fbd.poly_in, P)

    data = torch.cat([A_diag] + datas, dim=0)
    return BlockMatrix.from_blocks(np.concatenate(rows), np.concatenate(cols),
                                   data, P)


def assemble_rhs(
    ah: AgglomerationHandler,
    f_fn,
    g_fn=None,
    penalty_constant: float | None = None,
    dtype=torch.float64,
    vol: VolumeTables | None = None,
    faces: tuple | None = None,
    dirichlet_ids=None,
    neumann_fn=None,
    *,
    device,
) -> torch.Tensor:
    """Flat rhs: int f v plus, for the Dirichlet datum g, the boundary
    consistency and penalty terms int_GD (-grad v . n + gamma v) g, plus
    int_GN g_N v on the non-Dirichlet faces.  ``f_fn``/``g_fn`` map real
    points [..., dim] to values [...]; ``neumann_fn(x, n)`` is the flux
    datum.  ``g_fn=None`` is homogeneous Dirichlet; ``dirichlet_ids=None``
    makes every boundary face Dirichlet."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    if vol is None:
        vol = build_volume_tables(ah, dtype, device=device)
    if faces is None:
        faces = build_face_tables(ah, dtype, device=device)
    _, fb = faces
    P = ah.n_poly

    r_cell = torch.einsum("cqi,cq,cq->ci", vol.B, vol.w, f_fn(vol.x))
    rhs = segment_sum(r_cell, vol.cell2poly, P)
    if fb.poly_in.shape[0] > 0:
        dmask = dirichlet_face_mask(ah, dirichlet_ids)
        sel = np.where(dmask)[0]
        if g_fn is not None and sel.shape[0]:
            fs = fb.select(sel)
            gamma = (penalty_constant / fs.h_f)[:, None]
            gn = torch.einsum("fqid,fqd->fqi", fs.G0, fs.n)
            r_face = torch.einsum("fqi,fq,fq->fi",
                                  fs.B0 * gamma[..., None] - gn, fs.w,
                                  g_fn(fs.x))
            rhs = rhs + segment_sum(r_face, fs.poly_in, P)
        neu = np.where(~dmask)[0]
        if neumann_fn is not None and neu.shape[0]:
            fs = fb.select(neu)
            r_face = torch.einsum("fqi,fq,fq->fi", fs.B0, fs.w,
                                  neumann_fn(fs.x, fs.n))
            rhs = rhs + segment_sum(r_face, fs.poly_in, P)
    return rhs.reshape(-1)


def mass_matrix(ah: AgglomerationHandler, coeff_fn=None, dtype=torch.float64,
                vol: VolumeTables | None = None, *, device) -> BlockMatrix:
    """Block-diagonal mass matrix int c(x) u v (c = 1 by default)."""
    if vol is None:
        vol = build_volume_tables(ah, dtype, device=device)
    P = ah.n_poly
    w = vol.w if coeff_fn is None else vol.w * coeff_fn(vol.x)
    M_cell = torch.einsum("cqi,cqj,cq->cij", vol.B, vol.B, w)
    M = segment_sum(M_cell, vol.cell2poly, P)
    return BlockMatrix(M, np.arange(P), np.arange(P), P, P)


def project(ah: AgglomerationHandler, fn, dtype=torch.float64,
            vol: VolumeTables | None = None, *, device) -> torch.Tensor:
    """L2 projection of ``fn`` onto the polytopal DG space: exact for
    polynomials of degree <= p."""
    if vol is None:
        vol = build_volume_tables(ah, dtype, device=device)
    P = ah.n_poly
    M = mass_matrix(ah, dtype=dtype, vol=vol, device=device).data
    b_cell = torch.einsum("cqi,cq,cq->ci", vol.B, vol.w, fn(vol.x))
    b = segment_sum(b_cell, vol.cell2poly, P)
    return torch.linalg.solve(M, b[..., None])[..., 0].reshape(-1)


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
