"""Per-polytope polynomial degree (hp) on one polytopal mesh, on torch
tensors.

Counterpart of ``polydeal_tpu/fem/hp.py`` (the reference's hp
FECollection, source/agglomeration_handler.cc:381-474): polytopes are
bucketed by degree, each bucket one :class:`~polydeal_tpu_torch.fem.system.
Field` over its polytopes; interior faces split into (degree_in,
degree_out) classes, the mixed-degree ones assembling rectangular SIPG
blocks through ``assembly/mixed.py``.  A face's penalty uses the larger
side's degree: gamma = 10 (p_max + dim)(p_max + 1) / h_f.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_hp_poisson", "solve_hp_dense", "hp_l2_error",
           "interpolate_hp_to_fine_grid"]


def build_hp_poisson(ah, degrees, f_fn, g_fn=None, dtype=torch.float64, *,
                     device):
    """The SIPG Laplacian with a degree per polytope (``degrees`` [n_poly]
    ints) on ``device``: (space, op, rhs)."""
    from polydeal_tpu_torch.assembly.mixed import (
        MixedOperator,
        MixedRhs,
        face_side_tables,
        scalar_interior_blocks,
    )
    from polydeal_tpu_torch.assembly.sipg import (
        build_volume_tables,
        default_penalty_constant,
    )
    from polydeal_tpu_torch.fem.basis import LegendreDGP
    from polydeal_tpu_torch.fem.system import Field, SystemSpace

    dim = ah.dim
    degrees = np.asarray(degrees, dtype=np.int64)
    if degrees.shape[0] != ah.n_poly:
        raise ValueError(f"{degrees.shape[0]} degrees for {ah.n_poly} "
                         f"polytopes")
    degs = sorted(int(d) for d in np.unique(degrees))
    if ah.n_quad < max(degs) + 1:
        # the tables use the handler's quadrature: p+1 Gauss points per
        # direction integrate the degree-2p stiffness and penalty terms
        raise ValueError(
            f"handler n_quad={ah.n_quad} under-integrates hp degree "
            f"{max(degs)}; build the AgglomerationHandler with "
            f"n_quad >= {max(degs) + 1}")
    bases = {d: LegendreDGP(dim, d) for d in degs}
    space = SystemSpace(ah, [Field(f"u{d}", bases[d], 1,
                                   np.where(degrees == d)[0]) for d in degs])
    loc = {d: space.local_poly(f"u{d}") for d in degs}

    op = MixedOperator(space)
    rhs = MixedRhs(space)
    c2p = ah.cell2poly

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # volume: one stiffness einsum per degree bucket
    for d in degs:
        cells = np.where(degrees[c2p] == d)[0]
        if not cells.size:
            continue
        v = build_volume_tables(ah, dtype, basis=bases[d], device=device)
        c = torch.as_tensor(cells, device=device)
        G, w = v.G[c], v.w[c]
        K = torch.einsum("cqid,cqjd,cq->cij", G, G, w)
        rows = loc[d][c2p[cells]]
        op.add(f"u{d}", f"u{d}", rows, rows, K)
        rhs.add(f"u{d}", rows, torch.einsum("cqi,cq,cq->ci", v.B[c], w,
                                            f_fn(v.x[c])))

    # interior faces by (deg_in, deg_out) class
    ft = ah.faces
    is_b = ft.poly_out < 0
    din = degrees[ft.poly_in]
    dout = np.where(is_b, -1, degrees[np.maximum(ft.poly_out, 0)])
    for da in degs:
        for db in degs:
            m = (~is_b) & (din == da) & (dout == db)
            if not m.any():
                continue
            fsel = ft._select(m)
            B0, G0 = face_side_tables(bases[da], fsel, 0, ah.extents, dtype,
                                      device=device)
            B1, G1 = face_side_tables(bases[db], fsel, 1, ah.extents, dtype,
                                      device=device)
            sigma = (default_penalty_constant(max(da, db), dim)
                     / np.asarray(fsel.h_f))
            blocks = scalar_interior_blocks(
                (B0, B1), (G0, G1), t(fsel.weights), t(fsel.normals),
                t(sigma))
            names = (f"u{da}", f"u{db}")
            sides = (loc[da][fsel.poly_in], loc[db][fsel.poly_out])
            for (s, u), val in blocks.items():
                op.add(names[s], names[u], sides[s], sides[u], val)

    # boundary Nitsche per bucket
    for d in degs:
        m = is_b & (din == d)
        if not m.any():
            continue
        fsel = ft._select(m)
        B0, G0 = face_side_tables(bases[d], fsel, 0, ah.extents, dtype,
                                  device=device)
        w = t(fsel.weights)
        nrm = t(fsel.normals)
        gamma = t(default_penalty_constant(d, dim) / np.asarray(fsel.h_f))
        gn = torch.einsum("fqid,fqd->fqi", G0, nrm)
        Mb = (-torch.einsum("fqi,fqj,fq->fij", B0, gn, w)
              - torch.einsum("fqi,fqj,fq->fij", gn, B0, w)
              + torch.einsum("fqi,fqj,fq->fij", B0, B0, w * gamma[:, None]))
        rows = loc[d][fsel.poly_in]
        op.add(f"u{d}", f"u{d}", rows, rows, Mb)
        if g_fn is not None:
            gv = g_fn(t(fsel.points_real))
            rb = torch.einsum("fqi,fq,fq->fi",
                              B0 * gamma[:, None, None] - gn, w, gv)
            rhs.add(f"u{d}", rows, rb)

    return space, op, rhs.finalize(dtype, device=device)


def solve_hp_dense(space, op, rhs):
    """Direct solve (the test-scale path; the iterative one is GMRES on
    ``op.matvec`` with ``op.block_jacobi()``)."""
    return torch.linalg.solve(op.to_dense(), rhs)


def interpolate_hp_to_fine_grid(space, ah, x, degree: int | None = None,
                                family: str = "dgq"):
    """An hp solution on one fine-grid space (the largest bucket degree by
    default): the sum of the buckets' interpolations, each zero outside
    its polytopes (the reference's hp ``interpolate_to_fine_grid``,
    poly_utils.h:1322-1458).  Returns [n_cells, n_fine_basis]."""
    from polydeal_tpu_torch.postprocess import interpolate_field_to_fine_grid

    if degree is None:
        degree = max(f.basis.degree for f in space.fields.values())
    total = None
    for name in space.fields:
        v = interpolate_field_to_fine_grid(space, ah, x, name,
                                           degree=degree, family=family)
        total = v if total is None else total + v
    return total[:, 0]


def hp_l2_error(ah, space, degrees, x, exact_fn) -> float:
    """Global L2 error of the hp solution against an exact field."""
    from polydeal_tpu_torch.assembly.sipg import build_volume_tables
    from polydeal_tpu_torch.fem.basis import LegendreDGP

    degrees = np.asarray(degrees)
    c2p = ah.cell2poly
    total = 0.0
    for d in sorted(int(v) for v in np.unique(degrees)):
        cells = np.where(degrees[c2p] == d)[0]
        if not cells.size:
            continue
        vol = build_volume_tables(ah, x.dtype, basis=LegendreDGP(ah.dim, d),
                                  device=x.device)
        c = torch.as_tensor(cells, device=x.device)
        loc = space.local_poly(f"u{d}")
        ub = space.unpack(x, f"u{d}")[:, 0, :][
            torch.as_tensor(loc[c2p[cells]], device=x.device)]
        vals = torch.einsum("cqi,ci->cq", vol.B[c], ub)
        diff = vals - exact_fn(vol.x[c])
        total = total + torch.sum(vol.w[c] * diff**2)
    return float(torch.sqrt(total))
