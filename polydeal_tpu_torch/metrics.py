"""Polytopal mesh quality metrics.

Rebuild of ``PolyUtils::compute_quality_metrics`` (reference
include/poly_utils.h:708-855; printed by examples/metrics.cc:311-356)
and ``compute_h_orthogonal`` (poly_utils.h:399-513).  The reference uses
CGAL; both metrics here come in two grades:

* ``method="sampled"`` — from the materialized quadrature (host numpy):
  inscribed radius = min distance from the volume-centroid to boundary
  quadrature points; h_orthogonal = depth of the polytope's quadrature
  points behind the face plane.  Cheap, resolution-limited.
* ``method="exact"`` — exact f64 computational geometry on the fine-face
  vertex polygons (the CGAL replacement): h_orthogonal by ray shooting
  from the face midpoint against the polytope's other boundary
  segments/triangles (the reference's Ray_2/Segment_2 and
  Ray_3/Triangle_3 construction, poly_utils.h:420-497), inscribed circle
  (2D) by multi-seed maximization of the exact min-distance-to-boundary
  function (converges to the medial-axis optimum the reference reads off
  the CGAL segment Delaunay graph, poly_utils.h:727-759).

Definitions follow the reference exactly: circumscribed radius =
polytope diameter / 2 with diameter = bbox diagonal
(agglomeration_accessor.h:583-599), uniformity factor = diameter /
mesh_size (max diameter), box_ratio = composite measure / bbox volume,
overlap ("coverage") = sum of bbox volumes / domain volume
(poly_utils.h:777-850).

Port note: a jax-free copy of ``polydeal_tpu/metrics.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_quality_metrics", "compute_h_orthogonal",
           "face_h_orthogonal", "polytope_boundary_faces"]


def polytope_boundary_faces(handler):
    """Exact polytope boundary geometry from the fine mesh (host).

    Returns ``(poly, verts, centers, normals)``: for every fine face on
    a polytopal boundary (interface or domain boundary), the owning
    polytope id, its vertex coordinates [n_bf, 2^(dim-1), dim] (3D quads
    in lexicographic order: the cycle is v0 v1 v3 v2, matching deal.II
    vertex numbering so the reference's triangle split (0,1,3)/(0,3,2)
    applies, poly_utils.h:465-497), the face center, and the outward
    unit normal at the center.  The array analogue of the accessor's
    ``polytope_boundary()`` (agglomeration_accessor.h:575-578).
    """
    mesh = handler.mesh
    c2p = np.asarray(handler.cell2poly)
    nbrs = mesh.neighbors  # [n_c, 2*dim]
    other = np.where(nbrs >= 0, c2p[np.maximum(nbrs, 0)], -1)
    on_b = other != c2p[:, None]  # [n_c, 2*dim]
    cells, lfaces = np.nonzero(on_b)
    fv = mesh.face_vertex_ids()[cells, lfaces]  # [n_bf, nvf]
    verts = mesh.vertices[fv]  # [n_bf, nvf, dim]
    centers = verts.mean(axis=1)
    cc = mesh.cell_centers()[cells]
    if handler.dim == 2:
        e = verts[:, 1] - verts[:, 0]
        normals = np.stack([e[:, 1], -e[:, 0]], axis=-1)
    else:
        d1 = verts[:, 1] - verts[:, 0]
        d2 = verts[:, 2] - verts[:, 0]
        normals = np.cross(d1, d2)
    normals /= np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-300)
    flip = np.einsum("fd,fd->f", normals, centers - cc) < 0
    normals[flip] *= -1.0
    return c2p[cells], verts, centers, normals


def _ray_depth_2d(origin, direction, segs):
    """Min distance from ``origin`` to the 2D segments hit by the ray
    ``origin + t*direction`` (t >= 0); inf if none hit.  Distance is the
    exact point-SEGMENT distance, matching the reference's
    ``CGAL::squared_distance(midpoint, segm)`` over intersected segments
    (poly_utils.h:435-447)."""
    a, b = segs[:, 0], segs[:, 1]  # [m, 2]
    e = b - a
    # solve origin + t d = a + s e;  cross products (2D scalar)
    den = direction[0] * e[:, 1] - direction[1] * e[:, 0]
    ao = a - origin
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ao[:, 0] * e[:, 1] - ao[:, 1] * e[:, 0]) / den
        s = (ao[:, 0] * direction[1] - ao[:, 1] * direction[0]) / den
    hit = (np.abs(den) > 1e-300) & (t >= -1e-12) & (s >= -1e-12) \
        & (s <= 1 + 1e-12)
    if not hit.any():
        return np.inf
    # exact point-segment distance for the hit segments
    ah, eh = a[hit], e[hit]
    u = np.clip(np.einsum("md,md->m", origin - ah, eh)
                / np.maximum(np.einsum("md,md->m", eh, eh), 1e-300), 0, 1)
    closest = ah + u[:, None] * eh
    return float(np.sqrt(((origin - closest) ** 2).sum(axis=1).min()))


def _point_tri_dist2(p, tri):
    """Exact squared distance from point ``p`` to triangles [m, 3, 3]."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab, ac, ap = b - a, c - a, p - a
    d1 = np.einsum("md,md->m", ab, ap)
    d2 = np.einsum("md,md->m", ac, ap)
    bp = p - b
    d3 = np.einsum("md,md->m", ab, bp)
    d4 = np.einsum("md,md->m", ac, bp)
    cp = p - c
    d5 = np.einsum("md,md->m", ab, cp)
    d6 = np.einsum("md,md->m", ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-300)
    v = vb / denom
    w = vc / denom
    closest = a + v[:, None] * ab + w[:, None] * ac  # face region
    # vertex regions
    closest = np.where((d1 <= 0)[:, None] & (d2 <= 0)[:, None], a, closest)
    closest = np.where((d3 >= 0)[:, None] & (d4 <= d3)[:, None], b, closest)
    closest = np.where((d6 >= 0)[:, None] & (d5 <= d6)[:, None], c, closest)
    # edge regions
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ab = np.clip(d1 / np.maximum(d1 - d3, 1e-300), 0, 1)
        t_ac = np.clip(d2 / np.maximum(d2 - d6, 1e-300), 0, 1)
        t_bc = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-300),
                       0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    closest = np.where(on_bc[:, None], b + t_bc[:, None] * (c - b), closest)
    closest = np.where(on_ac[:, None], a + t_ac[:, None] * ac, closest)
    closest = np.where(on_ab[:, None], a + t_ab[:, None] * ab, closest)
    return ((p - closest) ** 2).sum(axis=1)


def _ray_depth_3d(origin, direction, quads):
    """Min distance from ``origin`` to the triangles (quad split
    (0,1,3)/(0,3,2), poly_utils.h:465-497) hit by the ray; inf if none
    hit.  Möller–Trumbore intersection + exact point-triangle
    distance."""
    tris = np.concatenate([quads[:, [0, 1, 3]], quads[:, [0, 3, 2]]], axis=0)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = b - a, c - a
    pv = np.cross(np.broadcast_to(direction, e2.shape), e2)
    det = np.einsum("md,md->m", e1, pv)
    tv = origin - a
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        u = np.einsum("md,md->m", tv, pv) * inv
        qv = np.cross(tv, e1)
        v = np.einsum("d,md->m", direction, qv) * inv
        t = np.einsum("md,md->m", e2, qv) * inv
    eps = 1e-12
    with np.errstate(invalid="ignore"):
        hit = (np.abs(det) > 1e-300) & (u >= -eps) & (v >= -eps) \
            & (u + v <= 1 + eps) & (t >= -eps)
    if not hit.any():
        return np.inf
    return float(np.sqrt(_point_tri_dist2(origin, tris[hit]).min()))


def _h_orthogonal_exact_rows(handler):
    """Exact h_perp per fine boundary face: (poly, centers, values)."""
    poly, verts, centers, normals = polytope_boundary_faces(handler)
    order = np.argsort(poly, kind="stable")
    starts = np.searchsorted(poly[order], np.arange(handler.n_poly + 1))
    vals = np.empty(poly.shape[0])
    for p in range(handler.n_poly):
        rows = order[starts[p]:starts[p + 1]]
        if not rows.size:
            continue
        for k, r in enumerate(rows):
            others = np.delete(rows, k)
            if not others.size:
                vals[r] = np.inf
                continue
            if handler.dim == 2:
                vals[r] = _ray_depth_2d(centers[r], -normals[r],
                                        verts[others])
            else:
                vals[r] = _ray_depth_3d(centers[r], -normals[r],
                                        verts[others])
    return poly, centers, vals


def face_h_orthogonal(handler, method: str = "sampled") -> np.ndarray:
    """Per-face-ROW orthogonal length scale [n_f] for penalty scaling.

    Fine-face-granularity variant of :func:`compute_h_orthogonal`: for
    each face row, the depth of the owning polytope(s) behind the face,
    interior rows taking the min of the two sides (the sharper
    penalty).  Wire into the assembly via
    ``build_face_tables(..., h_scale='orthogonal')`` — the optional
    penalty scaling of reference poly_utils.h:399-513.

    ``method="sampled"`` measures the depth of the polytope's volume
    quadrature points behind the face plane; ``method="exact"`` ray-
    shoots from the face midpoint against the polytope's other boundary
    segments/triangles in exact f64 (the reference's CGAL construction,
    poly_utils.h:420-497).
    """
    if method == "exact":
        return _face_h_orthogonal_exact(handler)
    if method != "sampled":
        raise ValueError(f"unknown method: {method}")
    ft = handler.faces
    pts = handler.vol_points_real  # [P, Q, dim]
    w = ft.weights  # [n_f, q]
    nbar = (w[..., None] * ft.normals).sum(axis=1)
    nbar /= np.maximum(np.linalg.norm(nbar, axis=-1, keepdims=True), 1e-300)
    xbar = (w[..., None] * ft.points_real).sum(axis=1) \
        / np.maximum(w.sum(axis=1), 1e-300)[:, None]
    # depth of side polytope behind the plane: max_q (xbar - x_q) . nbar
    d_in = np.einsum("fqd,fd->fq",
                     xbar[:, None, :] - pts[ft.poly_in], nbar).max(axis=1)
    h = d_in
    interior = ft.poly_out >= 0
    if interior.any():
        p_out = np.maximum(ft.poly_out, 0)
        d_out = np.einsum(
            "fqd,fd->fq", pts[p_out] - xbar[:, None, :], nbar).max(axis=1)
        h = np.where(interior, np.minimum(d_in, d_out), d_in)
    return np.maximum(h, 1e-12)


def _face_h_orthogonal_exact(handler) -> np.ndarray:
    """Exact per-face-row h_perp: match face-table rows to the fine
    boundary faces by center (KD-tree per polytope) and take the ray-
    shooting depth; interior rows take the min of the two sides."""
    from scipy.spatial import cKDTree

    poly, centers, vals = _h_orthogonal_exact_rows(handler)
    ft = handler.faces
    wsum = np.maximum(ft.weights.sum(axis=1), 1e-300)
    row_c = (ft.weights[..., None] * ft.points_real).sum(axis=1) \
        / wsum[:, None]

    trees = {}

    def depth(row_ids, side_poly):
        out = np.empty(row_ids.shape[0])
        for p in np.unique(side_poly):
            t = trees.get(p)
            if t is None:
                m = poly == p
                trees[p] = t = (cKDTree(centers[m]), vals[m])
            sel = side_poly == p
            d, idx = t[0].query(row_c[row_ids][sel])
            assert (d < 0.5 * np.asarray(handler.diameters)[p]).all()
            out[sel] = t[1][idx]
        return out

    rows = np.arange(ft.n_faces)
    h = depth(rows, ft.poly_in)
    interior = ft.poly_out >= 0
    if interior.any():
        h_out = depth(rows[interior], ft.poly_out[interior])
        h[interior] = np.minimum(h[interior], h_out)
    return np.where(np.isfinite(h), h, np.asarray(handler.diameters)[
        ft.poly_in])


def _point_in_polygon(p, segs):
    """Crossing-number parity of a +x ray against the segment soup (no
    ordering needed — polytope boundaries are closed loops)."""
    a, b = segs[:, 0], segs[:, 1]
    cond = (a[:, 1] > p[1]) != (b[:, 1] > p[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        x_at = a[:, 0] + (p[1] - a[:, 1]) * (b[:, 0] - a[:, 0]) \
            / (b[:, 1] - a[:, 1])
    return int(np.count_nonzero(cond & (p[0] < x_at))) % 2 == 1


def _inscribed_radius_2d(segs, seeds):
    """Largest inscribed circle radius of the closed polygon bounded by
    ``segs`` [m, 2, 2]: multi-seed Nelder–Mead maximization of the exact
    min point-segment distance (the optimum is a medial-axis vertex —
    what the reference reads off the CGAL segment Delaunay graph,
    poly_utils.h:727-759); converges to f64 precision for polytopes of
    fine cells."""
    from scipy.optimize import minimize

    a = segs[:, 0]
    e = segs[:, 1] - a
    ee = np.maximum(np.einsum("md,md->m", e, e), 1e-300)

    def dist(p):
        u = np.clip(np.einsum("md,md->m", p[None] - a, e) / ee, 0, 1)
        c = a + u[:, None] * e
        return float(np.sqrt(((p - c) ** 2).sum(axis=1).min()))

    def neg(p):
        d = dist(p)
        return -d if _point_in_polygon(p, segs) else d

    best = -np.inf
    scores = np.array([-neg(s) for s in seeds])
    for i in np.argsort(scores)[::-1][:4]:
        r = minimize(neg, seeds[i], method="Nelder-Mead",
                     options=dict(xatol=1e-12, fatol=1e-13, maxiter=400))
        best = max(best, -float(r.fun))
    return best


def compute_quality_metrics(handler, method: str = "sampled") -> dict:
    """Per-polytope metric arrays + their means, with the reference's
    definitions (poly_utils.h:708-855): uniformity_factor = diameter /
    mesh_size (max diameter); circle_ratio = r_inscribed /
    r_circumscribed with r_circumscribed = diameter / 2 (bbox diagonal,
    agglomeration_accessor.h:583-599); box_ratio = composite measure /
    bbox volume; coverage (the reference's overlap_factor) = sum of
    bbox volumes / domain volume.

    ``method="exact"`` (2D) computes the inscribed radius by exact
    computational geometry on the fine-face boundary polygon;
    ``method="sampled"`` uses the min centroid-to-boundary-quadrature
    distance.
    """
    P = handler.n_poly
    # centroid from the composite quadrature
    w = handler.vol_weights  # [P, Q]
    x = handler.vol_points_real  # [P, Q, dim]
    measure = w.sum(axis=1)
    centroid = (w[..., None] * x).sum(axis=1) / measure[:, None]

    if method == "exact":
        if handler.dim != 2:
            # the reference's exact metrics are 2D-only
            # (poly_utils.h:713 static_assert)
            raise ValueError("method='exact' is 2D-only (as the reference)")
        poly, verts, _, _ = polytope_boundary_faces(handler)
        cc = handler.mesh.cell_centers()
        c2p = np.asarray(handler.cell2poly)
        r_in = np.empty(P)
        for p in range(P):
            segs = verts[poly == p]
            seeds = np.concatenate(
                [cc[c2p == p], centroid[p][None]], axis=0)
            r_in[p] = _inscribed_radius_2d(segs, seeds)
    elif method == "sampled":
        ft = handler.faces
        r_in = np.full(P, np.inf)

        def upd(poly_ids, pts):
            d = np.linalg.norm(pts - centroid[poly_ids][:, None, :],
                               axis=-1)
            np.minimum.at(r_in, poly_ids, d.min(axis=1))

        fb, fi = ft.boundary(), ft.interior()
        if fb.n_faces:
            upd(fb.poly_in, fb.points_real)
        if fi.n_faces:
            upd(fi.poly_in, fi.points_real)
            upd(fi.poly_out, fi.points_real)
    else:
        raise ValueError(f"unknown method: {method}")

    diameters = np.asarray(handler.diameters)
    r_circ = 0.5 * diameters
    box_ratio = measure / handler.volumes
    circle_ratio = r_in / r_circ
    uniformity = diameters / diameters.max()
    return dict(
        uniformity_factor=uniformity,
        circle_ratio=circle_ratio,
        box_ratio=box_ratio,
        mean_uniformity=float(uniformity.mean()),
        mean_circle_ratio=float(circle_ratio.mean()),
        mean_box_ratio=float(box_ratio.mean()),
        coverage=float(handler.volumes.sum() / measure.sum()),
    )


def compute_h_orthogonal(handler, method: str = "sampled") -> dict:
    """h_perp per polytopal face: {(poly_in, poly_out) -> depth}.

    ``method="sampled"``: the mean unit normal n̄ and face centroid x̄
    define the face plane; h_perp = max over the polytope's volume
    quadrature points of (x̄ - x)·n̄ — how deep the polytope extends
    behind the face.  ``method="exact"``: min over the polytopal face's
    constituent fine faces of the exact ray-shooting depth from the
    poly_in side (value parity with the reference's CGAL construction,
    poly_utils.h:420-497).  Boundary faces keyed with poly_out = -1."""
    if method == "exact":
        h = _face_h_orthogonal_exact(handler)
        ft = handler.faces
        out = {}
        for r in range(ft.n_faces):
            k = (int(ft.poly_in[r]), int(ft.poly_out[r]))
            out[k] = min(out.get(k, np.inf), float(h[r]))
        return out
    if method != "sampled":
        raise ValueError(f"unknown method: {method}")
    ft = handler.faces
    pts = handler.vol_points_real  # [P, Q, dim]
    key = ft.poly_in.astype(np.int64) * (handler.n_poly + 1) + (
        ft.poly_out.astype(np.int64) % (handler.n_poly + 1))
    uniq, inv = np.unique(key, return_inverse=True)
    out = {}
    for u_idx, u in enumerate(uniq):
        sel = inv == u_idx
        w = ft.weights[sel].reshape(-1)
        n = ft.normals[sel].reshape(-1, handler.dim)
        x = ft.points_real[sel].reshape(-1, handler.dim)
        nbar = (w[:, None] * n).sum(axis=0)
        nbar /= max(np.linalg.norm(nbar), 1e-300)
        xbar = (w[:, None] * x).sum(axis=0) / w.sum()
        p_in = int(ft.poly_in[sel][0])
        p_out = int(ft.poly_out[sel][0])
        depth = np.max((xbar[None, :] - pts[p_in]) @ nbar)
        out[(p_in, p_out)] = float(depth)
    return out
