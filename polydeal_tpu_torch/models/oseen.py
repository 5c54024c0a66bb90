"""Two-domain Oseen flow (the Kovasznay benchmark) with upwind DG on
agglomerated polytopal meshes, on torch tensors.

Counterpart of ``polydeal_tpu/models/oseen.py`` (the reference's
examples/oseen.cc): the Kovasznay flow on (-1/2, 3/2) x (0, 2), IPDG with
upwind convection, two velocity/pressure spaces on the two halves whose
degrees may differ (four :class:`Field`s; interface faces couple
different spaces), split by the line x = 1/2 (:func:`run`) or the curve
x = 1/2 + a sin(pi y) (:func:`run_curved`, the fine cells classified by
the curve and disconnected pieces split).

Formulation (oseen.cc:745-1240): nu grad v : grad u - (div v) p
+ q (div u) + v.(beta.grad) u; SIPG velocity faces with sigma_v =
40 nu (p+1)(p+d)/diam; pressure-jump stabilization sigma_p =
1/(nu/diam + beta_max); upwind face term -(beta.n)(v_down.[u]); beta =
u_exact, nu = 1/Re.  The right-hand side f = -nu Laplace u + (beta.grad)u
+ grad p is written out by hand (the JAX package takes it by autodiff).

    python -m polydeal_tpu_torch.models.oseen --device cpu --n 16
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from polydeal_tpu_torch.utils.segment import segment_sum

PENALTY_V = 40.0
PENALTY_P = 1.0

__all__ = ["kovasznay", "oseen_rhs", "build_oseen", "pressure_mean_vector",
           "solve_oseen_dense", "solve_oseen_iterative",
           "oseen_block_hierarchy", "oseen_mg_preconditioner",
           "solve_oseen_mg", "oseen_errors", "run",
           "curved_split_agglomeration", "run_curved"]


def _lam(Re: float) -> float:
    return Re / 2.0 - np.sqrt(Re * Re / 4.0 + 4.0 * np.pi**2)


def kovasznay(Re: float = 10.0):
    """Exact (u, p) of the Kovasznay flow (oseen.cc:160-205); p without
    the zero-mean shift."""
    lam = _lam(Re)
    k = 2 * math.pi

    def u(x):
        ex = torch.exp(lam * x[..., 0])
        return torch.stack([
            1.0 - ex * torch.cos(k * x[..., 1]),
            lam / k * ex * torch.sin(k * x[..., 1]),
        ], dim=-1)

    def p(x):
        return 0.5 * torch.exp(2.0 * lam * x[..., 0])

    return u, p


def _kovasznay_grad(Re: float):
    """x [..., 2] -> J [..., 2, 2], J[i, j] = du_i/dx_j."""
    lam = _lam(Re)
    k = 2 * math.pi

    def J(x):
        ex = torch.exp(lam * x[..., 0])
        c, s = torch.cos(k * x[..., 1]), torch.sin(k * x[..., 1])
        return torch.stack([
            torch.stack([-lam * ex * c, k * ex * s], dim=-1),
            torch.stack([lam * lam / k * ex * s, lam * ex * c], dim=-1),
        ], dim=-2)

    return J


def oseen_rhs(Re: float = 10.0):
    """f = -nu Laplace u + (beta.grad) u + grad p with beta = u_exact."""
    lam = _lam(Re)
    k = 2 * math.pi
    nu = 1.0 / Re
    u, _ = kovasznay(Re)
    J = _kovasznay_grad(Re)

    def f(x):
        ex = torch.exp(lam * x[..., 0])
        c, s = torch.cos(k * x[..., 1]), torch.sin(k * x[..., 1])
        lap = torch.stack([-(lam * lam - k * k) * ex * c,
                           lam / k * (lam * lam - k * k) * ex * s], dim=-1)
        conv = torch.einsum("...ij,...j->...i", J(x), u(x))
        gp = torch.stack([lam * torch.exp(2.0 * lam * x[..., 0]),
                          torch.zeros_like(ex)], dim=-1)
        return -nu * lap + conv + gp

    return f


def build_oseen(ah, domain_id, degrees=((2, 1), (2, 1)), Re: float = 10.0,
                u_exact=None, f_fn=None, beta_fn=None, dtype=torch.float64,
                *, device):
    """The two-space Oseen system on ``device``: (space, op, rhs, meta).
    ``domain_id[p]`` is 0 (left) or 1 (right); ``degrees[k]`` = (velocity
    degree, pressure degree) of space k.  Default data: Kovasznay."""
    from polydeal_tpu_torch.assembly.mixed import (
        MixedOperator, MixedRhs, expand_vector_blocks, face_side_tables,
        stokes_boundary_blocks, stokes_boundary_rhs, stokes_interior_blocks,
        swap_sides,
    )
    from polydeal_tpu_torch.assembly.sipg import build_volume_tables
    from polydeal_tpu_torch.fem.basis import LegendreDGP
    from polydeal_tpu_torch.fem.system import Field, SystemSpace

    dim = ah.dim
    nu = 1.0 / Re
    domain_id = np.asarray(domain_id)
    if u_exact is None or f_fn is None:
        ue, _ = kovasznay(Re)
        u_exact = u_exact or ue
        f_fn = f_fn or oseen_rhs(Re)
    beta_fn = beta_fn or u_exact

    names = (("uL", "pL"), ("uR", "pR"))
    bases = {}
    fields = []
    polys = [np.where(domain_id == k)[0] for k in (0, 1)]
    for k in (0, 1):
        dv, dp = degrees[k]
        bases[names[k][0]] = LegendreDGP(dim, dv)
        bases[names[k][1]] = LegendreDGP(dim, dp)
        fields.append(Field(names[k][0], bases[names[k][0]], dim, polys[k]))
        fields.append(Field(names[k][1], bases[names[k][1]], 1, polys[k]))
    space = SystemSpace(ah, fields)
    loc = [space.local_poly(names[k][0]) for k in (0, 1)]
    deg_v = [degrees[0][0], degrees[1][0]]

    op = MixedOperator(space)
    rhs = MixedRhs(space)
    diam = ah.diameters

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def side_tables(basis, f, side):
        return face_side_tables(basis, f, side, ah.extents, dtype,
                                device=device)

    # ---------------- volume terms, per space
    c2p = ah.cell2poly
    vols = {}
    cells = [np.where(domain_id[c2p] == k)[0] for k in (0, 1)]
    for k in (0, 1):
        vn, pn = names[k]
        vol_v = build_volume_tables(ah, dtype, basis=bases[vn], device=device)
        vol_p = build_volume_tables(ah, dtype, basis=bases[pn], device=device)
        vols[k] = (vol_v, vol_p)
        cs = torch.as_tensor(cells[k], device=device)
        rows = loc[k][c2p[cells[k]]]
        Gv, Bv, wv = vol_v.G[cs], vol_v.B[cs], vol_v.w[cs]
        betav = beta_fn(vol_v.x[cs])
        Ks = nu * torch.einsum("cqid,cqjd,cq->cij", Gv, Gv, wv)
        conv = torch.einsum("cqi,cqjd,cqd,cq->cij", Bv, Gv, betav, wv)
        op.add(vn, vn, rows, rows, expand_vector_blocks(Ks + conv, dim))
        Bp = vol_p.B[cs]
        vp = -torch.einsum("cqid,cqj,cq->cdij", Gv, Bp, wv)
        c_, d_, i_, j_ = vp.shape
        op.add(vn, pn, rows, rows, vp.reshape(c_, d_ * i_, j_))
        pv = torch.einsum("cqi,cqjd,cq->cidj", Bp, Gv, wv)
        op.add(pn, vn, rows, rows, pv.reshape(c_, j_, d_ * i_))
        fv = f_fn(vol_v.x[cs])
        rhs.add(vn, rows, torch.einsum("cqi,cqd,cq->cdi", Bv, fv, wv))

    # ---------------- faces
    ft = ah.faces
    dom_in = domain_id[ft.poly_in]
    dom_out = np.where(ft.poly_out >= 0,
                       domain_id[np.maximum(ft.poly_out, 0)], -1)
    is_b = ft.poly_out < 0

    def tau_v(k, p):
        return nu * (deg_v[k] + 1) * (deg_v[k] + dim) / diam[p]

    def face_penalties(f, ka, kb):
        """(sigma_v, sigma_p, beta at the face points)."""
        beta = beta_fn(t(f.points_real))
        bmax = torch.linalg.vector_norm(beta, dim=-1).amax(dim=-1)  # [f]
        sv = PENALTY_V * np.maximum(tau_v(ka, f.poly_in),
                                    tau_v(kb, f.poly_out))
        # the larger of the two sides' zetas (oseen.cc:1013-1020)
        za = 1.0 / (nu / t(diam[f.poly_in]) + bmax)
        zb = 1.0 / (nu / t(diam[f.poly_out]) + bmax)
        return t(sv), PENALTY_P * torch.maximum(za, zb), beta

    # interior faces per (ka, kb) class, side 0 = space ka
    for ka, kb in ((0, 0), (1, 1), (0, 1)):
        if ka == kb:
            m = (~is_b) & (dom_in == ka) & (dom_out == ka)
        else:
            m = (~is_b) & (dom_in != dom_out)
        if not m.any():
            continue
        f = ft._select(m)
        if ka != kb:
            f = swap_sides(f, diam, domain_id[f.poly_in] == 1)
        vn_a, pn_a = names[ka]
        vn_b, pn_b = names[kb]
        Bv0, Gv0 = side_tables(bases[vn_a], f, 0)
        Bv1, Gv1 = side_tables(bases[vn_b], f, 1)
        Bp0, _ = side_tables(bases[pn_a], f, 0)
        Bp1, _ = side_tables(bases[pn_b], f, 1)
        sv, sp_, beta = face_penalties(f, ka, kb)
        blocks = stokes_interior_blocks(
            (Bv0, Bv1), (Gv0, Gv1), (Bp0, Bp1), t(f.weights), t(f.normals),
            sv, sp_, nu, beta=beta)
        sides = (loc[ka][f.poly_in], loc[kb][f.poly_out])
        fname = ((vn_a, pn_a), (vn_b, pn_b))
        for ((kt, st), (kl, sl)), val in blocks.items():
            op.add(fname[st][kt == "p"], fname[sl][kl == "p"],
                   sides[st], sides[sl], val)

    # boundary faces (Dirichlet everywhere, upwind inflow terms)
    for k in (0, 1):
        m = is_b & (dom_in == k)
        if not m.any():
            continue
        f = ft._select(m)
        vn, pn = names[k]
        Bv0, Gv0 = side_tables(bases[vn], f, 0)
        Bp0, _ = side_tables(bases[pn], f, 0)
        w_, n_ = t(f.weights), t(f.normals)
        beta = beta_fn(t(f.points_real))
        sv = t(PENALTY_V * tau_v(k, f.poly_in))
        blocks = stokes_boundary_blocks(Bv0, Gv0, Bp0, w_, n_, sv, nu,
                                        beta=beta)
        lb = loc[k][f.poly_in]
        op.add(vn, vn, lb, lb, blocks[("v", "v")])
        op.add(vn, pn, lb, lb, blocks[("v", "p")])
        op.add(pn, vn, lb, lb, blocks[("p", "v")])
        g = u_exact(t(f.points_real))
        rv, rp = stokes_boundary_rhs(Bv0, Gv0, Bp0, w_, n_, sv, nu, g,
                                     beta=beta)
        rhs.add(vn, lb, rv)
        rhs.add(pn, lb, rp)

    meta = dict(dim=dim, domain_id=domain_id, names=names, vols=vols,
                bases=bases, Re=Re, cells=cells,
                rows=[loc[k][c2p[cells[k]]] for k in (0, 1)])
    return space, op, rhs.finalize(dtype, device=device), meta


def pressure_mean_vector(space, meta) -> torch.Tensor:
    parts = {}
    for k in (0, 1):
        vn, pn = meta["names"][k]
        vol_p = meta["vols"][k][1]
        f = space.fields[vn]
        parts[vn] = vol_p.w.new_zeros((f.n_polys, f.block))
        c = torch.as_tensor(meta["cells"][k], device=vol_p.w.device)
        ints = torch.einsum("cqi,cq->ci", vol_p.B[c], vol_p.w[c])
        parts[pn] = segment_sum(ints, meta["rows"][k],
                                space.fields[pn].n_polys)
    return space.pack(parts)


def _regularized(space, op, meta):
    m = pressure_mean_vector(space, meta)
    return lambda v: op.matvec(v) + m * torch.dot(m, v)


def solve_oseen_dense(space, op, rhs, meta) -> torch.Tensor:
    m = pressure_mean_vector(space, meta)
    K = op.to_dense()
    K += torch.outer(m, m)
    return torch.linalg.solve(K, rhs)


def solve_oseen_iterative(space, op, rhs, meta, rtol: float = 1e-10,
                          restart: int = 60, max_restarts: int = 200,
                          capture: bool | None = None):
    """GMRES(restart) with field-wise block-Jacobi on the coupled operator
    (+ the rank-1 zero-mean term); ``capture`` as in ``gmres_solve``, the
    result's ``setup_s`` the block inversions'."""
    from polydeal_tpu_torch.solvers.gmres import timed_gmres

    return timed_gmres(_regularized(space, op, meta), rhs, op.block_jacobi,
                       restart=restart, rtol=rtol,
                       max_restarts=max_restarts, capture=capture)


def oseen_block_hierarchy(mesh, n: int, block: int, degree: int):
    """Nested block-agglomeration chain on the Kovasznay rectangle whose
    finest level matches :func:`run`'s numbering: (handlers, parents)."""
    from polydeal_tpu_torch.handler import AgglomerationHandler

    m0 = n // block
    sides = [m0]
    while sides[-1] % 2 == 0 and sides[-1] > 2:
        sides.append(sides[-1] // 2)
    sides = sides[::-1]
    centers = mesh.cell_centers()
    c2ps = []
    for m in sides:
        bx = np.minimum(((centers[:, 0] + 0.5) / 2.0 * m).astype(int), m - 1)
        by = np.minimum((centers[:, 1] / 2.0 * m).astype(int), m - 1)
        c2ps.append((bx * m + by).astype(np.int32))
    handlers = [AgglomerationHandler(mesh, c, degree=degree) for c in c2ps]
    parents = []
    for li in range(len(sides) - 1):
        m = sides[li + 1]
        ids = np.arange(m * m)
        bx, by = ids // m, ids % m
        parents.append(((bx // 2) * (m // 2) + by // 2).astype(np.int64))
    return handlers, parents


def oseen_mg_preconditioner(space, op, meta, mesh, n: int, block: int,
                            structure: str = "diag"):
    """The field-wise R3MG preconditioner of :func:`solve_oseen_mg`; its
    ``mgs`` attribute holds the velocity multigrids by degree."""
    from polydeal_tpu_torch.assembly import assemble_sipg_matrix
    from polydeal_tpu_torch.solvers import build_multigrid

    nu = 1.0 / meta["Re"]
    dim = meta["dim"]
    dev = meta["vols"][0][0].w.device
    dtype = meta["vols"][0][0].w.dtype
    tri = structure == "tri"
    if structure not in ("diag", "tri"):
        raise ValueError(f"unknown structure: {structure!r}")
    bj = None if tri else op.block_jacobi()

    mgs = {}
    for k in (0, 1):
        vn, _ = meta["names"][k]
        deg = space.fields[vn].basis.degree
        if deg not in mgs:
            handlers, parents = oseen_block_hierarchy(mesh, n, block, deg)
            pc = PENALTY_V * (deg + 1) * (deg + dim)
            Am = assemble_sipg_matrix(handlers[-1], penalty_constant=pc,
                                      dtype=dtype, device=dev)
            mgs[deg] = (build_multigrid(handlers, parents, Am, dtype=dtype,
                                        device=dev), handlers[-1])

    # stabilized pressure-Schur blocks (D_stab + M_p/nu)^-1 per polytope
    Sinvs = {}
    if tri:
        for k in (0, 1):
            _, pn = meta["names"][k]
            fp = space.fields[pn]
            vol_p = meta["vols"][k][1]
            c = torch.as_tensor(meta["cells"][k], device=dev)
            Mc = torch.einsum("cqi,cqj,cq->cij", vol_p.B[c], vol_p.B[c],
                              vol_p.w[c])
            Mp = segment_sum(Mc, meta["rows"][k], fp.n_polys)
            Sinvs[pn] = torch.linalg.inv(op.diag_blocks(pn) + Mp / nu)

    polys_t = {name: torch.as_tensor(f.polys, device=dev)
               for name, f in space.fields.items()}

    def field_v(vn, r):
        # r: [n_polys, block] -> a velocity V-cycle per component
        f = space.fields[vn]
        mg_v, ah_v = mgs[f.basis.degree]
        rr = r.reshape(f.n_polys, f.n_components, f.basis.n_basis)
        comps = []
        for d in range(f.n_components):
            full = r.new_zeros((ah_v.n_poly, f.basis.n_basis))
            full[polys_t[vn]] = rr[:, d, :]
            z = mg_v.v_cycle(full.reshape(-1)) / nu
            comps.append(z.reshape(ah_v.n_poly, -1)[polys_t[vn]])
        return torch.stack(comps, dim=1).reshape(f.n_polys, f.block)

    order = [meta["names"][0][0], meta["names"][0][1],
             meta["names"][1][0], meta["names"][1][1]]
    is_vel = {meta["names"][k][0] for k in (0, 1)}

    def M(v):
        parts = {}
        zbj = None if tri else bj(v)
        done = {}
        for name in order:
            f = space.fields[name]
            r = space.unpack(v, name).reshape(f.n_polys, f.block)
            if tri:
                for prev, zp in done.items():
                    r = r - op.block_apply(name, prev, zp)
            if name in is_vel:
                z = field_v(name, r)
            elif tri:
                z = torch.einsum("pij,pj->pi", Sinvs[name], r)
            else:
                z = zbj[space.dof_slice(name)].reshape(f.n_polys, f.block)
            done[name] = z
            parts[name] = z
        return space.pack(parts)

    M.mgs = {deg: v[0] for deg, v in mgs.items()}
    return M


def solve_oseen_mg(space, op, rhs, meta, mesh, n: int, block: int,
                   rtol: float = 1e-10, restart: int = 200,
                   max_restarts: int = 40, structure: str = "diag",
                   capture: bool | None = None):
    """GMRES with a field-wise R3MG preconditioner: each space's velocity
    block gets a penalty-matched scalar SIPG V-cycle per component
    (scaled by 1/nu), the pressures keep the stabilization block-Jacobi
    (``structure='diag'``, the default) or, block-lower-triangularly,
    stabilized mass-Schur blocks (``'tri'``: measured worse in the JAX
    package, kept for study).  ``capture`` as in ``gmres_solve``; the
    result's ``setup_s`` is the preconditioner's, ``solve_s`` the
    solve's."""
    from polydeal_tpu_torch.solvers.gmres import timed_gmres

    return timed_gmres(
        _regularized(space, op, meta), rhs,
        lambda: oseen_mg_preconditioner(space, op, meta, mesh, n, block,
                                        structure),
        restart=restart, rtol=rtol, max_restarts=max_restarts,
        capture=capture)


def oseen_errors(space, x, meta):
    """(u_L2, u_H1semi, p_L2) over the whole domain against Kovasznay, the
    exact pressure shifted to zero mean."""
    u_ex, p_ex = kovasznay(meta["Re"])
    J = _kovasznay_grad(meta["Re"])
    dev = x.device
    area = 0.0
    mean = 0.0
    for k in (0, 1):
        vol_p = meta["vols"][k][1]
        c = torch.as_tensor(meta["cells"][k], device=dev)
        mean = mean + torch.einsum("cq,cq->", vol_p.w[c], p_ex(vol_p.x[c]))
        area = area + vol_p.w[c].sum()
    mean = mean / area
    e_u2 = e_h1 = e_p2 = 0.0
    for k in (0, 1):
        vn, pn = meta["names"][k]
        vol_v, vol_p = meta["vols"][k]
        c = torch.as_tensor(meta["cells"][k], device=dev)
        rows = torch.as_tensor(meta["rows"][k], device=dev)
        U = space.unpack(x, vn)[rows]
        uh = torch.einsum("cqi,cdi->cqd", vol_v.B[c], U)
        du = uh - u_ex(vol_v.x[c])
        e_u2 = e_u2 + torch.einsum("cq,cqd->", vol_v.w[c], du**2)
        Gh = torch.einsum("cqie,cdi->cqde", vol_v.G[c], U)
        e_h1 = e_h1 + torch.einsum("cq,cqde->", vol_v.w[c],
                                   (Gh - J(vol_v.x[c]))**2)
        Pc = space.unpack(x, pn)[rows][:, 0]
        ph = torch.einsum("cqi,ci->cq", vol_p.B[c], Pc)
        dp = ph - (p_ex(vol_p.x[c]) - mean)
        e_p2 = e_p2 + torch.einsum("cq,cq->", vol_p.w[c], dp**2)
    return (float(torch.sqrt(e_u2)), float(torch.sqrt(e_h1)),
            float(torch.sqrt(e_p2)))


def _rectangle(n):
    from polydeal_tpu_torch.mesh import hyper_rectangle

    return hyper_rectangle(2, [n, n], lo=[-0.5, 0.0], hi=[1.5, 2.0])


def run(n=16, block=2, degrees=((2, 1), (2, 1)), Re=10.0,
        dtype=torch.float64, *, device):
    """Kovasznay flow on (-1/2, 3/2) x (0, 2), block-agglomerated, split
    at x = 1/2 into the two spaces, solved densely: (space, x, meta); the
    system is ``meta['system']`` = (op, rhs)."""
    from polydeal_tpu_torch.handler import AgglomerationHandler

    mesh = _rectangle(n)
    centers = mesh.cell_centers()
    m = n // block
    bx = np.minimum(((centers[:, 0] + 0.5) / 2.0 * m).astype(int), m - 1)
    by = np.minimum((centers[:, 1] / 2.0 * m).astype(int), m - 1)
    c2p = bx * m + by
    deg_max = max(degrees[0][0], degrees[1][0])
    ah = AgglomerationHandler(mesh, c2p, degree=deg_max)
    pcx = np.zeros(ah.n_poly)
    np.add.at(pcx, c2p, centers[:, 0])
    pcx /= np.bincount(c2p)
    domain_id = (pcx > 0.5).astype(int)
    space, op, rhs, meta = build_oseen(ah, domain_id, degrees, Re,
                                       dtype=dtype, device=device)
    x = solve_oseen_dense(space, op, rhs, meta)
    meta["system"] = (op, rhs)
    return space, x, meta


def curved_split_agglomeration(mesh, n: int, block: int, curve_fn):
    """Block agglomeration that never straddles the curved interface
    x = curve_fn(y) (oseen.cc:519-600, by cell classification): blocks
    with cells on both sides split into one polytope per side, pieces a
    wiggly curve disconnects split further.  Returns (c2p,
    domain_id[poly])."""
    from polydeal_tpu_torch.agglomeration.graph import (compact_labels,
                                                        split_disconnected)

    centers = mesh.cell_centers()
    m = n // block
    bx = np.minimum(((centers[:, 0] + 0.5) / 2.0 * m).astype(int), m - 1)
    by = np.minimum((centers[:, 1] / 2.0 * m).astype(int), m - 1)
    side = (centers[:, 0] > curve_fn(centers[:, 1])).astype(np.int64)
    key = (bx * m + by) * 2 + side
    _, c2p = np.unique(key, return_inverse=True)
    c2p = split_disconnected(c2p.reshape(-1).astype(np.int64),
                             mesh.neighbors)
    c2p = compact_labels(c2p)
    n_poly = int(c2p.max()) + 1
    dom = np.zeros(n_poly, dtype=np.int64)
    np.maximum.at(dom, c2p, side)
    return c2p.astype(np.int32), dom.astype(int)


def run_curved(n=16, block=2, degrees=((2, 1), (2, 1)), Re=10.0,
               amplitude=0.15, dtype=torch.float64, *, device):
    """Kovasznay flow with the two spaces split by the curved interface
    x = 1/2 + amplitude sin(pi y) (oseen.cc:519-600): (space, x, meta)."""
    from polydeal_tpu_torch.handler import AgglomerationHandler

    mesh = _rectangle(n)
    c2p, domain_id = curved_split_agglomeration(
        mesh, n, block, lambda y: 0.5 + amplitude * np.sin(np.pi * y))
    deg_max = max(degrees[0][0], degrees[1][0])
    ah = AgglomerationHandler(mesh, c2p, degree=deg_max)
    space, op, rhs, meta = build_oseen(ah, domain_id, degrees, Re,
                                       dtype=dtype, device=device)
    x = solve_oseen_dense(space, op, rhs, meta)
    meta["system"] = (op, rhs)
    return space, x, meta


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--block", type=int, default=2)
    ap.add_argument("--degree-v", type=int, default=2)
    ap.add_argument("--Re", type=float, default=10.0)
    args = ap.parse_args()
    dv = args.degree_v
    space, x, meta = run(args.n, args.block, ((dv, dv - 1), (dv, dv - 1)),
                         args.Re, device=torch.device(args.device))
    e = oseen_errors(space, x, meta)
    print(f"n={args.n} dofs={space.n_dofs}")
    print(f"u L2: {e[0]:.4e}  u H1: {e[1]:.4e}  p L2: {e[2]:.4e}")


if __name__ == "__main__":
    main()
