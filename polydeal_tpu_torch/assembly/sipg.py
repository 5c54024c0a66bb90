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
rolls -- no scatters or gathers (a lane slab's build puts each face
group's blocks on the slab by lane maps instead); with a pack plan it
emits the packed format (``sparse.BlockPacked``) directly.  Which blocks
the kernels compute is one rule of the basis family, dimension, degree
and table dtype (``ops/sipg_kernels.kernel_blocks``: the P_p basis at p
1-3); every other basis (TensorDGQ, P_p at p >= 4) takes the einsum
branch, the JAX package's XLA branch, with the handler's basis.  The
tensors' device decides, as the JAX package's backend does: on a CUDA
tensor the kernels' blocks come from the hand-written kernels (the JAX
package's TPU branch), on a CPU tensor from their plain einsum versions
(its ``use_pallas=False`` branch).

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
    boundary_blocks_einsum,
    face_group_blocks,
    face_group_blocks_einsum,
    kernel_blocks,
    volume_blocks,
    volume_blocks_einsum,
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
    "banded_pieces",
    "last_setup_stats",
    "transpose_tables",
    "assemble_sipg_banded_t",
    "banded_gather_maps",
    "assemble_sipg_banded_gather",
    "assemble_sipg_banded",
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


# what the most recent build_banded_groups call built: "n_dev" (the number
# of slabs of its width in the level; 1 for a whole-level build), "lanes"
# (lo, hi) of a slab build, "max_lanes", the most lanes of any table it
# made, and "max_host_slab_bytes", the largest host array it made
last_setup_stats: dict = {}


def _lane_put(P: int, dtype, device):
    """Materializer for the entity-last (lane-major) setup tables.

    ``put(build, fill, idx, n_in)`` takes a function ``build(ids) ->
    np.ndarray`` that makes the lanes ``ids`` (global polytope ids) of a
    table [..., L] and lays out the table of the lanes ``idx`` (global ids,
    default all P): positions from ``n_in`` on, and ids outside [0, P), hold
    ``fill``.  A slab build passes only the lanes its slab needs, so no
    host array of the global lane count is ever made (the counterpart of
    the JAX package's one-slab-a-device ``_lane_put``; the reference's
    rank-local setup, source/agglomeration_handler.cc:85-87,1026-1091)."""
    def put(build, fill, idx=None, n_in=None):
        if idx is None:
            a = build(np.arange(P))
        else:
            pos = np.arange(idx.shape[0])
            valid = (pos < (idx.shape[0] if n_in is None else n_in)) & (
                idx >= 0) & (idx < P)
            part = build(idx[valid])
            a = np.full(part.shape[:-1] + (idx.shape[0],), fill,
                        dtype=part.dtype)
            a[..., valid] = part
        a = np.ascontiguousarray(a)
        last_setup_stats["max_lanes"] = max(
            last_setup_stats.get("max_lanes", 0), a.shape[-1])
        last_setup_stats["max_host_slab_bytes"] = max(
            last_setup_stats.get("max_host_slab_bytes", 0), a.nbytes)
        # contiguous, as the kernels take them
        return torch.as_tensor(a, dtype=dtype, device=device)

    return put


def _slab_face_lanes(has: np.ndarray, o: int, lo: int, hi: int):
    """The lanes a slab [lo, hi) needs of the face group of offset ``o``
    (``has``: which polytopes are the in side of such a face), or None if
    no face of the group touches the slab: (idx, n_in, k, keep, give).

    K4 reads the in side's box at lane q and the out side's at lane
    (q + k) mod L, so ``idx`` lists the in-side lanes (its first ``n_in``)
    followed by out-side lanes that put each in-side lane's out box k
    lanes on.  ``keep`` = (positions, slab lanes) of the faces whose
    poly_in lies in the slab (their m11 and m12), ``give`` the same of the
    faces whose poly_out does (their m21 and m22).  Of two layouts, the one
    with fewer lanes: the window [lo - o, hi + o) (k = o; for o >= per
    the windows [lo - o, hi - o), [lo, hi) and [lo + o, hi + o), k = per),
    or only the in-side lanes U that have a face, then U + o (k = |U|): a
    far, sparse offset costs its faces' lanes, not the slab's."""
    per = hi - lo
    s = min(o, per)
    near = np.arange(max(lo - o, 0), max(hi - o, 0))
    U = np.union1d(near, np.arange(lo, hi))
    U = U[has[U]]
    if U.size == 0:
        return None
    if 2 * U.size < per + 2 * s:
        kp = np.nonzero(U >= lo)[0]
        gp = np.nonzero((U + o >= lo) & (U + o < hi))[0]
        return (np.concatenate([U, U + o]), U.size, U.size,
                (kp, U[kp] - lo), (gp, U[gp] + o - lo))
    idx = np.concatenate([np.arange(lo - o, lo - o + s), np.arange(lo, hi),
                          np.arange(hi - s, hi) + o])
    lanes = np.arange(per)
    return idx, per + s, s, (s + lanes, lanes), (lanes, lanes)


def build_banded_groups(ah: AgglomerationHandler, offsets: np.ndarray,
                        dtype=torch.float64, *, device,
                        dirichlet_ids=None, lanes=None) -> dict:
    """Slot-padded, entity-last tables: the banded assembly inputs.

    Interior faces are grouped by (offset, poly_in) into [C, q, ..., P]
    tables (C = most faces one polytope pair contributes), boundary faces
    and cells by polytope.  Padded slots carry zero weights (and h_f = 1),
    so they contribute exact zeros.  Only the IN-side unit points are
    stored: the out side is the same physical points pulled back into the
    neighbour's box, computed by the assembly.

    Returns a dict of tensors on ``device`` with the same keys as the JAX
    package's: groups {offset: {w, n, h_f, pts_in}}, bdry, vol {pts, w},
    ext_t and lo_t [dim, P].

    ``lanes=(lo, hi)`` builds one lane slab for a shard-local setup, each
    table with only the lanes it needs: the volume and boundary tables and
    ext_t/lo_t the slab's own, each face group the lanes of
    :func:`_slab_face_lanes` (the faces whose poly_in or poly_out lies in
    the slab, and their out sides' boxes), with those lanes' own boxes
    (``ext``, ``lo``), K4's box offset ``k`` and the ``keep``/``give``
    lane maps as tensors; a group no face of which touches the slab is
    left out.  :func:`assemble_sipg_banded_direct` then returns the band of
    lanes [lo, hi): the reference's ghost-polytope layer
    (source/agglomeration_handler.cc:1026-1091) as static lanes, with no
    communication during setup."""
    P = ah.n_poly
    ft = ah.faces
    offsets = np.asarray(offsets, dtype=np.int64)
    own = None
    if lanes is not None:
        lo, hi = (int(v) for v in lanes)
        if not 0 <= lo < hi <= P:
            raise ValueError(f"lane slab {lanes} outside [0, {P})")
        lanes, own = (lo, hi), np.arange(lo, hi)
    last_setup_stats.clear()
    last_setup_stats["n_dev"] = (1 if lanes is None
                                 else P // (lanes[1] - lanes[0]))
    if lanes is not None:
        last_setup_stats["lanes"] = lanes
    put = _lane_put(P, dtype, device)

    def ext_of(idx):
        return ah.extents[idx].T  # [dim, L]

    def lo_of(idx):
        return ah.bbox_lo[idx].T

    def face_group(rows: np.ndarray, by: np.ndarray, o: int = 0):
        members, _ = padded_group_lists(by, P) if rows.size else (
            np.full((P, 1), -1, dtype=np.int64), None)
        mask = members >= 0
        safe = np.where(mask, rows[np.maximum(members, 0)], 0)
        C = members.shape[1]
        idx, n_in, extra = own, None, {}
        if lanes is not None and o:
            sl = _slab_face_lanes(mask[:, 0], o, *lanes)
            if sl is None:
                return None
            idx, n_in, k, keep, give = sl

            def lane_map(m):
                return tuple(torch.as_tensor(a, device=device) for a in m)

            extra = dict(ext=put(ext_of, 1.0, idx), lo=put(lo_of, 0.0, idx),
                         k=k, keep=lane_map(keep), give=lane_map(give))

        def b_pts(idx):  # [C, q, d, L]
            s, m = safe[idx], mask[idx]
            pts = ft.points_in[s.reshape(-1)].reshape(
                len(idx), C, *ft.points_in.shape[1:])
            pts = np.where(m.reshape(len(idx), C, 1, 1), pts, 0.5)
            return np.transpose(pts, (1, 2, 3, 0))

        def b_w(idx):  # [C, q, L]
            s, m = safe[idx], mask[idx]
            w = ft.weights[s.reshape(-1)].reshape(len(idx), C, -1)
            return np.transpose(np.where(m[:, :, None], w, 0.0), (1, 2, 0))

        def b_n(idx):  # [C, q, d, L]
            n = ft.normals[safe[idx].reshape(-1)].reshape(
                len(idx), C, *ft.normals.shape[1:])
            return np.transpose(n, (1, 2, 3, 0))

        def b_hf(idx):  # [C, L]
            return np.where(mask[idx], ft.h_f[safe[idx]], 1.0).T

        return dict(w=put(b_w, 0.0, idx, n_in), n=put(b_n, 0.0, idx, n_in),
                    h_f=put(b_hf, 1.0, idx, n_in),
                    pts_in=put(b_pts, 0.5, idx, n_in), **extra)

    interior = ~ft.is_boundary
    off_of = np.where(interior, ft.poly_out - ft.poly_in, 0)
    groups = {}
    for o in (int(o) for o in offsets if o > 0):
        rows = np.where(interior & (off_of == o))[0]
        if rows.size:
            g = face_group(rows, ft.poly_in[rows], o)
            if g is not None:
                groups[o] = g
    b_rows = np.where(ft.is_boundary)[0][dirichlet_face_mask(ah,
                                                             dirichlet_ids)]
    bdry = face_group(b_rows, ft.poly_in[b_rows]) if b_rows.size else None

    # volume: padded cells per polytope, entity-last
    members = ah.poly2cells  # [P, Cc]
    maskc = members >= 0
    safe_v = np.maximum(members, 0)
    Cc = members.shape[1]

    def bv_pts(idx):
        s, m = safe_v[idx], maskc[idx]
        upts = ah.cell_qpoints_unit[s.reshape(-1)].reshape(
            len(idx), Cc, *ah.cell_qpoints_unit.shape[1:])
        upts = np.where(m[:, :, None, None], upts, 0.5)
        return np.transpose(upts, (1, 2, 3, 0))

    def bv_w(idx):
        s, m = safe_v[idx], maskc[idx]
        wv = ah.cell_qweights[s.reshape(-1)].reshape(len(idx), Cc, -1)
        return np.transpose(np.where(m[:, :, None], wv, 0.0), (1, 2, 0))

    vol = dict(pts=put(bv_pts, 0.5, own), w=put(bv_w, 0.0, own))
    return dict(groups=groups, bdry=bdry, vol=vol,
                ext_t=put(ext_of, 1.0, own),  # [dim, L]
                lo_t=put(lo_of, 0.0, own))


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


def banded_pieces(ah: AgglomerationHandler, tables: dict, offsets,
                  penalty_constant: float | None = None,
                  basis=None) -> list:
    """The band of :func:`assemble_sipg_banded_direct` as one [nb, nb, L]
    block row a band offset (in ``offsets``' order), before it is laid
    out: K3-K5 where ``kernel_blocks`` gives them the handler's basis, else
    the einsums with ``basis`` (default: the handler's), sums over the
    padded slots and lane rolls; over a slab's tables, its own lanes [lo,
    hi) only, each face group's blocks put onto them by its ``keep`` and
    ``give`` lane maps."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    nb, deg, dim = ah.n_basis, ah.degree, ah.dim
    offsets = np.asarray(offsets, dtype=np.int64)
    ext_t = tables["ext_t"]  # [dim, P]
    lo_t = tables["lo_t"]  # [dim, P]
    P = ext_t.shape[1]  # the level's lanes, or a slab's own
    # the kernels evaluate the handler's own P_p basis; another basis
    # given here takes the einsums
    kern = (kernel_blocks(ah.family, dim, deg, ext_t.dtype)
            if basis is None or basis is ah.basis else frozenset())
    basis = basis or ah.basis

    def volume(vol, ext):
        if "volume" in kern:
            return volume_blocks(vol, ext, deg, dim)
        return volume_blocks_einsum(vol, ext, basis)

    def faces(g, ext, lo, o):
        if "face" in kern:
            return face_group_blocks(g, ext, lo, o, deg, dim,
                                     penalty_constant)
        return face_group_blocks_einsum(g, ext, lo, o, basis,
                                        penalty_constant)

    def boundary(g, ext):
        if "boundary" in kern:
            return boundary_blocks(g, ext, deg, dim, penalty_constant)
        return boundary_blocks_einsum(g, ext, basis, penalty_constant)

    diag = volume(tables["vol"], ext_t).reshape(nb, nb, P)
    rows = {int(o): None for o in offsets}
    for o, g in tables["groups"].items():
        if "k" in g:  # a slab's group, on its own lanes
            m11, m12, m21, m22 = (
                m.reshape(nb, nb, -1)
                for m in faces(g, g["ext"], g["lo"], g["k"]))

            def on_slab(m, lane_map):
                pos, lanes = lane_map
                out = m.new_zeros((nb, nb, P))
                out[..., lanes] = m[..., pos]
                return out

            m11, m12 = on_slab(m11, g["keep"]), on_slab(m12, g["keep"])
            m21r, m22r = on_slab(m21, g["give"]), on_slab(m22, g["give"])
        else:
            m11, m12, m21, m22 = (
                m.reshape(nb, nb, P) for m in faces(g, ext_t, lo_t, o))
            # m22 and m21 belong to poly_out = p + o: roll them onto its
            # lane
            m21r = torch.roll(m21, o, dims=-1)
            m22r = torch.roll(m22, o, dims=-1)
        diag = diag + m11 + m22r
        rows[o] = m12 if rows[o] is None else rows[o] + m12
        rows[-o] = m21r if rows[-o] is None else rows[-o] + m21r
    if tables["bdry"] is not None:
        diag = diag + boundary(tables["bdry"], ext_t).reshape(nb, nb, P)

    zero = diag.new_zeros((nb, nb, P))
    return [diag if o == 0 else (
        rows[int(o)] if rows[int(o)] is not None else zero)
        for o in offsets]


def assemble_sipg_banded_direct(
    ah: AgglomerationHandler,
    tables: dict,
    offsets: np.ndarray,
    penalty_constant: float | None = None,
    layout: str = "omajor",
    pack_plan=None,
    pack_oid: torch.Tensor | None = None,
    basis=None,
) -> BlockBanded | BlockPacked:
    """Banded SIPG matrix over slot-padded tables (see
    :func:`build_banded_groups`): the block kernels K3-K5 or, for a basis
    they are not built for (``ops/sipg_kernels.kernel_blocks``), the
    einsums with ``basis`` (default: the handler's), then sums over the
    padded slots and lane rolls, no scatters or gathers.  Sign conventions
    follow the reference kernel (poly_utils.h:1870-1926); normals point
    outward from poly_in.  With ``pack_plan`` (a ``PackPlan`` over these
    offsets) and ``pack_oid`` (its [K, P] int32 slot table on the tables'
    device) the result is emitted packed instead.

    Over one lane slab's tables (``build_banded_groups(lanes=(lo, hi))``)
    the kernels run on the lanes each table holds and the result holds the
    lanes [lo, hi) only (``pack_oid`` then [K, hi - lo], the plan's oid
    columns of those lanes): every block of those rows, columns anywhere
    in the level."""
    offsets = np.asarray(offsets, dtype=np.int64)
    pieces = banded_pieces(ah, tables, offsets, penalty_constant, basis)
    if pack_plan is not None:
        return _emit_packed(pieces, offsets, pack_plan, pack_oid)
    return _emit_banded(pieces, offsets, ah.n_basis, pieces[0].shape[-1],
                        layout)


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


def transpose_tables(vol: VolumeTables, faces):
    """Entity-LAST copies of the shape tables for the banded assembly over
    them (:func:`assemble_sipg_banded_t`, :func:`assemble_sipg_banded_gather`):
    [q, nb(, dim), entity].  Returns (vol_t, fi_t, fb_t, static): three
    dicts of tensors and one of the host index arrays (cell2poly, poly_in,
    poly_out, poly_b), with the JAX package's keys."""
    fi, fb = faces

    def t3(a):  # [F, q, i] -> [q, i, F]
        return None if a is None else a.permute(1, 2, 0).contiguous()

    def t4(a):  # [F, q, i, d] -> [q, i, d, F]
        return None if a is None else a.permute(1, 2, 3, 0).contiguous()

    def t2(a):  # [F, q] -> [q, F]
        return None if a is None else a.T.contiguous()

    vol_t = dict(B=t3(vol.B), G=t4(vol.G), w=t2(vol.w))
    fi_t = dict(B0=t3(fi.B0), G0=t4(fi.G0), B1=t3(fi.B1), G1=t4(fi.G1),
                w=t2(fi.w), n=t4(fi.n[:, :, None, :])[:, 0], h_f=fi.h_f)
    fb_t = dict(B0=t3(fb.B0), G0=t4(fb.G0), w=t2(fb.w),
                n=t4(fb.n[:, :, None, :])[:, 0], h_f=fb.h_f)
    static = dict(cell2poly=vol.cell2poly, poly_in=fi.poly_in,
                  poly_out=fi.poly_out, poly_b=fb.poly_in)
    return vol_t, fi_t, fb_t, static


def _entity_values_t(vol_t: dict, fi_t: dict, fb_t: dict, static: dict,
                     penalty_constant: float) -> torch.Tensor:
    """[E, nb, nb]: every entity's block over the entity-last tables, in
    the stream order volume cells, m11, m12, m21, m22 faces, boundary
    faces (the last only where ``static`` has any)."""
    gamma_i = penalty_constant / fi_t["h_f"]  # [F]
    gn0 = torch.einsum("qidf,qdf->qif", fi_t["G0"], fi_t["n"])
    gn1 = torch.einsum("qidf,qdf->qif", fi_t["G1"], fi_t["n"])
    w = fi_t["w"]
    wg = w * gamma_i[None, :]

    def blk(a, b, wgt):
        return torch.einsum("qif,qjf,qf->fij", a, b, wgt)

    B0, B1 = fi_t["B0"], fi_t["B1"]
    vals = [torch.einsum("qidc,qjdc,qc->cij", vol_t["G"], vol_t["G"],
                         vol_t["w"]),
            -0.5 * blk(gn0, B0, w) - 0.5 * blk(B0, gn0, w) + blk(B0, B0, wg),
            0.5 * blk(gn0, B1, w) - 0.5 * blk(B0, gn1, w) - blk(B0, B1, wg),
            -0.5 * blk(gn1, B0, w) + 0.5 * blk(B1, gn0, w) - blk(B1, B0, wg),
            0.5 * blk(gn1, B1, w) + 0.5 * blk(B1, gn1, w) + blk(B1, B1, wg)]
    if static["poly_b"].shape[0]:
        gamma_b = penalty_constant / fb_t["h_f"]
        gnb = torch.einsum("qidf,qdf->qif", fb_t["G0"], fb_t["n"])
        Bb, wb = fb_t["B0"], fb_t["w"]
        vals.append(-blk(Bb, gnb, wb) - blk(gnb, Bb, wb)
                    + blk(Bb, Bb, wb * gamma_b[None, :]))
    return torch.cat(vals, dim=0)


def _band_slots(static: dict, offsets: np.ndarray, P: int) -> np.ndarray:
    """The band slot (offset index * P + lane) of every entity, in the
    stream order of :func:`_entity_values_t`."""
    pin = static["poly_in"].astype(np.int64)
    pout = static["poly_out"].astype(np.int64)
    o0 = int(np.searchsorted(offsets, 0))
    slots = [o0 * P + static["cell2poly"].astype(np.int64),
             o0 * P + pin,
             np.searchsorted(offsets, pout - pin) * P + pin,
             np.searchsorted(offsets, pin - pout) * P + pout,
             o0 * P + pout]
    if static["poly_b"].shape[0]:
        slots.append(o0 * P + static["poly_b"].astype(np.int64))
    return np.concatenate(slots)


def _band_of_slots(vals: torch.Tensor, slots: np.ndarray,
                   offsets: np.ndarray, P: int) -> BlockBanded:
    """The band [n_off, nb, nb, P] of the entity blocks ``vals`` [E, nb,
    nb] summed into their slots (one deterministic segment sum)."""
    n_off = offsets.shape[0]
    nb = vals.shape[-1]
    band = segment_sum(vals, slots, n_off * P)  # [n_off * P, nb, nb]
    data = band.reshape(n_off, P, nb, nb).permute(0, 2, 3, 1).contiguous()
    return BlockBanded(data=data, offsets=offsets, n_block_cols=P)


def assemble_sipg_banded_t(
    ah: AgglomerationHandler,
    vol_t: dict,
    fi_t: dict,
    fb_t: dict,
    static: dict,
    offsets: np.ndarray,
    penalty_constant: float | None = None,
) -> BlockBanded:
    """Banded SIPG assembly over entity-last tables (see
    :func:`transpose_tables`): every entity's block by einsums, summed into
    its band slot by a deterministic segment sum."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    P = ah.n_poly
    offsets = np.asarray(offsets, dtype=np.int64)
    vals = _entity_values_t(vol_t, fi_t, fb_t, static, penalty_constant)
    return _band_of_slots(vals, _band_slots(static, offsets, P), offsets, P)


def banded_gather_maps(ah: AgglomerationHandler, static: dict,
                       offsets: np.ndarray):
    """Static reduction maps for the banded assembly: for each band offset
    o, ``maps[o]`` = (idx [P, C_o] int64, mask [P, C_o] float64), the padded
    list of the entities (in the stream order of
    :func:`assemble_sipg_banded_t`: volume cells, m11, m12, m21, m22 faces,
    boundary faces) whose block lands in slot (o, p).  A jax-free copy of
    the JAX package's host function."""
    P = ah.n_poly
    pin = static["poly_in"].astype(np.int64)
    pout = static["poly_out"].astype(np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    o0 = int(np.searchsorted(offsets, 0))
    n_fi = pin.shape[0]
    n_c = static["cell2poly"].shape[0]
    base_m11 = n_c
    base_m12 = base_m11 + n_fi
    base_m21 = base_m12 + n_fi
    base_m22 = base_m21 + n_fi
    base_b = base_m22 + n_fi

    okey = [[] for _ in range(offsets.shape[0])]  # entity ids per offset
    opoly = [[] for _ in range(offsets.shape[0])]

    def put(o_idx, polys, base):
        for oi in np.unique(o_idx):
            m = o_idx == oi
            okey[oi].append(np.where(m)[0] + base)
            opoly[oi].append(polys[m])

    put(np.full(n_c, o0), static["cell2poly"].astype(np.int64), 0)
    put(np.full(n_fi, o0), pin, base_m11)
    put(np.searchsorted(offsets, pout - pin), pin, base_m12)
    put(np.searchsorted(offsets, pin - pout), pout, base_m21)
    put(np.full(n_fi, o0), pout, base_m22)
    if static["poly_b"].shape[0]:
        pb = static["poly_b"].astype(np.int64)
        put(np.full(pb.shape[0], o0), pb, base_b)

    maps = []
    for k in range(offsets.shape[0]):
        if okey[k]:
            ents = np.concatenate(okey[k])
            pols = np.concatenate(opoly[k])
            # group entity ids by target polytope; pad with entity 0 and
            # a zero mask (members indexes into `ents`)
            members, _ = padded_group_lists(pols, P)
            mask = members >= 0
            safe = ents[np.where(mask, members, 0)]
            maps.append((safe, mask.astype(np.float64)))
        else:
            maps.append((np.zeros((P, 1), dtype=np.int64),
                         np.zeros((P, 1))))
    return maps


def assemble_sipg_banded_gather(
    ah: AgglomerationHandler,
    vol_t: dict,
    fi_t: dict,
    fb_t: dict,
    static: dict,
    offsets: np.ndarray,
    maps=None,
    penalty_constant: float | None = None,
) -> BlockBanded:
    """Banded SIPG assembly, gather form: the blocks of
    :func:`assemble_sipg_banded_t`, reduced into each band slot by the
    static padded gathers and masked sums of :func:`banded_gather_maps`."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    P = ah.n_poly
    offsets = np.asarray(offsets, dtype=np.int64)
    if maps is None:
        maps = banded_gather_maps(ah, static, offsets)
    vals = _entity_values_t(vol_t, fi_t, fb_t, static, penalty_constant)
    dev = vals.device
    pieces = []
    for idx, mask in maps:
        g = vals[torch.as_tensor(idx.reshape(-1), device=dev)].reshape(
            idx.shape + vals.shape[1:])  # [P, C, nb, nb]
        m = torch.as_tensor(mask, dtype=vals.dtype, device=dev)
        pieces.append(torch.einsum("pc,pcij->ijp", m, g))
    return BlockBanded(data=torch.stack(pieces, dim=0), offsets=offsets,
                       n_block_cols=P)


def assemble_sipg_banded(
    ah: AgglomerationHandler,
    offsets: np.ndarray | None = None,
    penalty_constant: float | None = None,
    include_boundary: bool = True,
    dtype=torch.float64,
    vol: VolumeTables | None = None,
    faces: tuple | None = None,
    *,
    device,
) -> BlockBanded:
    """The SIPG matrix straight in the banded layout [n_off, nb, nb, P]
    from the standard tables, without a block-COO matrix: every entity's
    block by einsums, summed into its band slot by a deterministic segment
    sum.  ``offsets`` fixes the band (a superset may be passed); by
    default it is the mesh's.  ``include_boundary=False`` drops the
    boundary Nitsche terms."""
    if penalty_constant is None:
        penalty_constant = default_penalty_constant(ah.degree, ah.dim)
    if vol is None:
        vol = build_volume_tables(ah, dtype, device=device)
    if faces is None:
        faces = build_face_tables(ah, dtype, device=device)
    fi, fb = faces
    P = ah.n_poly
    pin = fi.poly_in.astype(np.int64)
    pout = fi.poly_out.astype(np.int64)
    if offsets is None:
        offsets = np.unique(np.concatenate([
            pout - pin, pin - pout, np.zeros(1, dtype=np.int64)]))
    offsets = np.asarray(offsets, dtype=np.int64)
    static = dict(cell2poly=vol.cell2poly, poly_in=fi.poly_in,
                  poly_out=fi.poly_out,
                  poly_b=(fb.poly_in if include_boundary
                          else fb.poly_in[:0]))
    M11, M12, M21, M22 = _interior_blocks(fi, penalty_constant)
    vals = [torch.einsum("cqid,cqjd,cq->cij", vol.G, vol.G, vol.w),
            M11, M12, M21, M22]
    if static["poly_b"].shape[0]:
        vals.append(_boundary_block(fb, penalty_constant))
    return _band_of_slots(torch.cat(vals, dim=0),
                          _band_slots(static, offsets, P), offsets, P)
