"""Coupled Stokes-Darcy flow with Beavers-Joseph-Saffman interface
coupling on agglomerated polytopal meshes, on torch tensors.

Counterpart of ``polydeal_tpu/models/darcy_stokes.py`` (the reference's
examples/darcy_stokes.cc): the unit square split into a Stokes region (top)
and a Darcy region (bottom), IPDG on polytopal agglomerates that never
straddle the interface, verified against the Lipnikov-Vassilev-Yotov
manufactured solution (darcy_stokes.cc:96-135).  Three fields on polytope
subsets (velocity and Stokes pressure on the Stokes polytopes, Darcy
pressure on the others, ``fem/system.py``), each face class one index
selection and one einsum batch (``assembly/mixed.py``), the zero-mean
pressure constraint a rank-1 term m m^T.  The manufactured right-hand
sides are the derivatives of the exact solution written out by hand (the
JAX package takes them by autodiff).

Solves: dense (the reference's UMFPACK), GMRES with field-wise
block-Jacobi, and GMRES with the field-wise R3MG preconditioner
(:func:`mg_block_preconditioner`), whose velocity and Darcy-pressure
V-cycles run on banded levels (K0 and fused K0 on the card).

Physical parameters as in the reference (darcy_stokes.cc:536-551):
nu = 0.1, K = I, alpha_BJ = 0.5, penalty constants 40 / 1 / 10.

    python -m polydeal_tpu_torch.models.darcy_stokes --device cpu --n 16
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass

import numpy as np
import torch

from polydeal_tpu_torch.utils.segment import segment_sum

NU = 0.1
KAPPA = 1.0
ALPHA_BJ = 0.5
OMEGA = 6.0

__all__ = ["u_exact_fn", "pS_exact_fn", "pD_exact_fn", "manufactured_rhs",
           "StokesDarcySystem", "build_darcy_stokes", "pressure_mean_vector",
           "solve_darcy_stokes_dense", "solve_darcy_stokes_iterative",
           "block_hierarchy", "coarse_domain_ids", "mg_block_preconditioner",
           "solve_darcy_stokes_mg", "errors", "run"]


def _consts():
    G = np.sqrt(NU * KAPPA) / ALPHA_BJ
    xi = (1.0 - G) / (2.0 * (1.0 + G))
    chi = (-30.0 * xi - 17.0) / 48.0
    return G, xi, chi


def u_exact_fn():
    _, xi, _ = _consts()

    def u(p):  # [..., 2] -> [..., 2], defined on the Stokes side
        x, y = p[..., 0], p[..., 1]
        return torch.stack([
            (2.0 - x) * (1.5 - y) * (y - xi),
            -y**3 / 3.0 + y**2 / 2.0 * (xi + 1.5) - 1.5 * xi * y - 0.5
            + torch.sin(OMEGA * x),
        ], dim=-1)

    return u


def _u_grad_fn():
    """[..., 2] -> [..., 2 (component), 2 (derivative)]."""
    _, xi, _ = _consts()

    def g(p):
        x, y = p[..., 0], p[..., 1]
        return torch.stack([
            torch.stack([-(1.5 - y) * (y - xi),
                         (2.0 - x) * (1.5 + xi - 2.0 * y)], dim=-1),
            torch.stack([OMEGA * torch.cos(OMEGA * x),
                         -y**2 + y * (xi + 1.5) - 1.5 * xi], dim=-1),
        ], dim=-2)

    return g


def pS_exact_fn():
    _, xi, chi = _consts()

    def pS(p):
        x, y = p[..., 0], p[..., 1]
        return (-(torch.sin(OMEGA * x) + chi) / (2.0 * KAPPA)
                + NU * (0.5 - xi) + torch.cos(math.pi * y))

    return pS


def pD_exact_fn():
    _, _, chi = _consts()

    def pD(p):
        x, y = p[..., 0], p[..., 1]
        return (-(chi * (y + 0.5) ** 2) / (2.0 * KAPPA)
                - torch.sin(OMEGA * x) * y / KAPPA)

    return pD


def manufactured_rhs():
    """(f_S, f_D, g_D): f_S = -nu Laplace u + grad p_S, f_D = -div(K grad
    p_D) and the Neumann datum g_D(x, n) = -K grad p_D . n of the exact
    solution above."""
    _, xi, chi = _consts()

    def f_S(p):
        x, y = p[..., 0], p[..., 1]
        lap_u1 = -2.0 * (2.0 - x)
        lap_u2 = -OMEGA**2 * torch.sin(OMEGA * x) - 2.0 * y + (xi + 1.5)
        dpx = -OMEGA * torch.cos(OMEGA * x) / (2.0 * KAPPA)
        dpy = -math.pi * torch.sin(math.pi * y)
        return torch.stack([-NU * lap_u1 + dpx, -NU * lap_u2 + dpy], dim=-1)

    def f_D(p):
        x, y = p[..., 0], p[..., 1]
        lap = OMEGA**2 * torch.sin(OMEGA * x) * y / KAPPA - chi / KAPPA
        return -KAPPA * lap

    def g_D(p, n):
        x, y = p[..., 0], p[..., 1]
        gx = -OMEGA * torch.cos(OMEGA * x) * y / KAPPA
        gy = -chi * (y + 0.5) / KAPPA - torch.sin(OMEGA * x) / KAPPA
        return -KAPPA * (gx * n[..., 0] + gy * n[..., 1])

    return f_S, f_D, g_D


@dataclass
class StokesDarcySystem:
    space: object
    op: object  # MixedOperator
    rhs: torch.Tensor
    meta: dict


def build_darcy_stokes(ah, domain_id, degree_v=2, degree_pS=1, degree_pD=1,
                       penalty_v=40.0, penalty_pS=1.0, penalty_pD=10.0,
                       u_dirichlet=None, f_S=None, f_D=None, g_D=None,
                       dtype=torch.float64, *, device) -> StokesDarcySystem:
    """The coupled Stokes-Darcy IPDG system on ``device``.

    ``domain_id[p]`` = 0 for Stokes polytopes, 1 for Darcy; agglomerates
    must not straddle the interface (the reference builds one R-tree per
    subdomain, darcy_stokes.cc:806-822).  Default data: the manufactured
    solution."""
    from polydeal_tpu_torch.assembly.mixed import (
        MixedOperator, MixedRhs, bjs_interface_blocks, expand_vector_blocks,
        face_side_tables, scalar_interior_blocks, stokes_boundary_blocks,
        stokes_boundary_rhs, stokes_interior_blocks, swap_sides,
    )
    from polydeal_tpu_torch.assembly.sipg import build_volume_tables
    from polydeal_tpu_torch.fem.basis import LegendreDGP
    from polydeal_tpu_torch.fem.system import Field, SystemSpace

    dim = ah.dim
    if dim != 2:
        raise ValueError("the Stokes-Darcy model is 2D (as the reference)")
    domain_id = np.asarray(domain_id)
    sp_polys = np.where(domain_id == 0)[0]
    da_polys = np.where(domain_id == 1)[0]

    bv = LegendreDGP(dim, degree_v)
    bpS = LegendreDGP(dim, degree_pS)
    bpD = LegendreDGP(dim, degree_pD)
    space = SystemSpace(ah, [Field("u", bv, dim, sp_polys),
                             Field("pS", bpS, 1, sp_polys),
                             Field("pD", bpD, 1, da_polys)])
    loc_s = space.local_poly("u")
    loc_d = space.local_poly("pD")

    if u_dirichlet is None:
        u_dirichlet = u_exact_fn()
    mf_S, mf_D, mg_D = manufactured_rhs()
    f_S = f_S or mf_S
    f_D = f_D or mf_D
    g_D = g_D or mg_D

    op = MixedOperator(space)
    rhs = MixedRhs(space)
    diam = ah.diameters

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # ---------------- volume terms
    vol_v = build_volume_tables(ah, dtype, basis=bv, device=device)
    vol_pS = build_volume_tables(ah, dtype, basis=bpS, device=device)
    vol_pD = build_volume_tables(ah, dtype, basis=bpD, device=device)
    c2p = ah.cell2poly
    cs = np.where(domain_id[c2p] == 0)[0]  # Stokes fine cells
    cd = np.where(domain_id[c2p] == 1)[0]
    rows_s = loc_s[c2p[cs]]
    rows_d = loc_d[c2p[cd]]
    cs_t = torch.as_tensor(cs, device=device)
    cd_t = torch.as_tensor(cd, device=device)

    Gv, wv = vol_v.G[cs_t], vol_v.w[cs_t]
    # nu grad v : grad u per component: scalar stiffness (x) I_dim
    Ks = NU * torch.einsum("cqid,cqjd,cq->cij", Gv, Gv, wv)
    op.add("u", "u", rows_s, rows_s, expand_vector_blocks(Ks, dim))
    # - (div v) p + q (div u); div of component-d test fn i = G[:, :, i, d]
    BpSs = vol_pS.B[cs_t]
    vp = -torch.einsum("cqid,cqj,cq->cdij", Gv, BpSs, wv)
    c_, d_, i_, j_ = vp.shape
    op.add("u", "pS", rows_s, rows_s, vp.reshape(c_, d_ * i_, j_))
    pv = torch.einsum("cqi,cqjd,cq->cidj", BpSs, Gv, wv)
    op.add("pS", "u", rows_s, rows_s, pv.reshape(c_, j_, d_ * i_))
    # Darcy volume: K grad q . grad p
    Gd, wd = vol_pD.G[cd_t], vol_pD.w[cd_t]
    Kd = KAPPA * torch.einsum("cqid,cqjd,cq->cij", Gd, Gd, wd)
    op.add("pD", "pD", rows_d, rows_d, Kd)
    fSv = f_S(vol_v.x[cs_t])  # [c, q, dim]
    rhs.add("u", rows_s, torch.einsum("cqi,cqd,cq->cdi", vol_v.B[cs_t], fSv,
                                      wv))
    fDv = f_D(vol_pD.x[cd_t])
    rhs.add("pD", rows_d, torch.einsum("cqi,cq,cq->ci", vol_pD.B[cd_t], fDv,
                                       wd))

    # ---------------- face classes
    ft = ah.faces
    dom_in = domain_id[ft.poly_in]
    dom_out = np.where(ft.poly_out >= 0,
                       domain_id[np.maximum(ft.poly_out, 0)], -1)
    is_b = ft.poly_out < 0
    m_ss = (~is_b) & (dom_in == 0) & (dom_out == 0)
    m_dd = (~is_b) & (dom_in == 1) & (dom_out == 1)
    m_sd = (~is_b) & (dom_in != dom_out)
    m_bs = is_b & (dom_in == 0)
    m_bd = is_b & (dom_in == 1)

    def tau_v(p):
        return NU * (degree_v + 1) * (degree_v + dim) / diam[p]

    def side_tables(basis, f, side):
        return face_side_tables(basis, f, side, ah.extents, dtype,
                                device=device)

    # Stokes-Stokes interior faces
    if m_ss.any():
        fss = ft._select(m_ss)
        Bv0, Gv0 = side_tables(bv, fss, 0)
        Bv1, Gv1 = side_tables(bv, fss, 1)
        Bp0, _ = side_tables(bpS, fss, 0)
        Bp1, _ = side_tables(bpS, fss, 1)
        sigma_v = penalty_v * np.maximum(tau_v(fss.poly_in),
                                         tau_v(fss.poly_out))
        zeta = diam / NU
        sigma_p = penalty_pS * np.maximum(zeta[fss.poly_in],
                                          zeta[fss.poly_out])
        blocks = stokes_interior_blocks(
            (Bv0, Bv1), (Gv0, Gv1), (Bp0, Bp1), t(fss.weights),
            t(fss.normals), t(sigma_v), t(sigma_p), NU)
        sides_ = (loc_s[fss.poly_in], loc_s[fss.poly_out])
        name = {"v": "u", "p": "pS"}
        for ((kt, st), (kl, sl)), val in blocks.items():
            op.add(name[kt], name[kl], sides_[st], sides_[sl], val)

    # Darcy-Darcy interior faces
    if m_dd.any():
        fdd = ft._select(m_dd)
        B0, G0 = side_tables(bpD, fdd, 0)
        B1, G1 = side_tables(bpD, fdd, 1)
        tau = KAPPA * (degree_pD + 1) * (degree_pD + dim) / diam
        sigma = penalty_pD * np.maximum(tau[fdd.poly_in], tau[fdd.poly_out])
        blocks = scalar_interior_blocks(
            (B0, B1), (G0, G1), t(fdd.weights), t(fdd.normals), t(sigma),
            kappa=KAPPA)
        sides_ = (loc_d[fdd.poly_in], loc_d[fdd.poly_out])
        for (s, u_), val in blocks.items():
            op.add("pD", "pD", sides_[s], sides_[u_], val)

    # Stokes-Darcy interface (BJS), oriented with side 0 = Stokes
    if m_sd.any():
        fsd = swap_sides(ft._select(m_sd), diam, dom_in[m_sd] == 1)
        Bv0, _ = side_tables(bv, fsd, 0)
        BpD1, _ = side_tables(bpD, fsd, 1)
        nu_over_G = ALPHA_BJ * np.sqrt(NU) / np.sqrt(KAPPA)
        blocks = bjs_interface_blocks(Bv0, BpD1, t(fsd.weights),
                                      t(fsd.normals), nu_over_G)
        ls, ld = loc_s[fsd.poly_in], loc_d[fsd.poly_out]
        op.add("u", "pD", ls, ld, blocks[("v", "p")])
        op.add("pD", "u", ld, ls, blocks[("p", "v")])
        op.add("u", "u", ls, ls, blocks[("v", "v")])

    # Stokes outer boundary (Dirichlet velocity)
    if m_bs.any():
        fbs = ft._select(m_bs)
        Bv0, Gv0 = side_tables(bv, fbs, 0)
        Bp0, _ = side_tables(bpS, fbs, 0)
        w_, n_ = t(fbs.weights), t(fbs.normals)
        sigma_v = t(penalty_v * tau_v(fbs.poly_in))
        blocks = stokes_boundary_blocks(Bv0, Gv0, Bp0, w_, n_, sigma_v, NU)
        lb = loc_s[fbs.poly_in]
        op.add("u", "u", lb, lb, blocks[("v", "v")])
        op.add("u", "pS", lb, lb, blocks[("v", "p")])
        op.add("pS", "u", lb, lb, blocks[("p", "v")])
        g = u_dirichlet(t(fbs.points_real))
        rv, rp = stokes_boundary_rhs(Bv0, Gv0, Bp0, w_, n_, sigma_v, NU, g)
        rhs.add("u", lb, rv)
        rhs.add("pS", lb, rp)

    # Darcy outer boundary (Neumann): rhs only
    if m_bd.any():
        fbd = ft._select(m_bd)
        B0, _ = side_tables(bpD, fbd, 0)
        gD = g_D(t(fbd.points_real), t(fbd.normals))
        rb = -torch.einsum("fqi,fq,fq->fi", B0, gD, t(fbd.weights))
        rhs.add("pD", loc_d[fbd.poly_in], rb)

    meta = dict(dim=dim, domain_id=domain_id, vol_v=vol_v, vol_pS=vol_pS,
                vol_pD=vol_pD, cells_s=cs, cells_d=cd, rows_s=rows_s,
                rows_d=rows_d, degree_v=degree_v)
    return StokesDarcySystem(space=space, op=op,
                             rhs=rhs.finalize(dtype, device=device),
                             meta=meta)


def pressure_mean_vector(sys: StokesDarcySystem) -> torch.Tensor:
    """m with m^T x = int_OmegaS p_S + int_OmegaD p_D (the zero-mean
    functional, darcy_stokes.cc:1723-1776)."""
    sp, meta = sys.space, sys.meta
    dev = sys.rhs.device
    fu = sp.fields["u"]
    parts = {"u": sys.rhs.new_zeros((fu.n_polys, fu.block))}
    for name, vol, cells, rows in (("pS", meta["vol_pS"], meta["cells_s"],
                                    meta["rows_s"]),
                                   ("pD", meta["vol_pD"], meta["cells_d"],
                                    meta["rows_d"])):
        c = torch.as_tensor(cells, device=dev)
        ints = torch.einsum("cqi,cq->ci", vol.B[c], vol.w[c])
        parts[name] = segment_sum(ints, rows, sp.fields[name].n_polys)
    return sp.pack(parts)


def _regularized(sys):
    """The coupled operator with the rank-1 zero-mean term m m^T."""
    m = pressure_mean_vector(sys)
    return lambda v: sys.op.matvec(v) + m * torch.dot(m, v)


def solve_darcy_stokes_dense(sys: StokesDarcySystem) -> torch.Tensor:
    """Direct solve with the rank-1 zero-mean term (the reference's
    UMFPACK and dof pinning, darcy_stokes.cc:1688-1716)."""
    m = pressure_mean_vector(sys)
    K = sys.op.to_dense()
    K += torch.outer(m, m)
    return torch.linalg.solve(K, sys.rhs)


def solve_darcy_stokes_iterative(sys: StokesDarcySystem, rtol: float = 1e-10,
                                 restart: int = 60, max_restarts: int = 200):
    """GMRES(restart) on the coupled operator (+ the rank-1 zero-mean
    term) with field-wise block-Jacobi."""
    from polydeal_tpu_torch.solvers.gmres import gmres_solve

    return gmres_solve(_regularized(sys), sys.rhs, M=sys.op.block_jacobi(),
                       restart=restart,
                       rtol=rtol, max_restarts=max_restarts)


def block_hierarchy(mesh, n: int, block: int, degree: int):
    """Nested block-agglomeration chain (coarse -> fine) whose finest level
    matches :func:`run`'s numbering: (handlers, parents)."""
    from polydeal_tpu_torch.handler import AgglomerationHandler

    bs = n // block
    sides = [bs]
    while sides[-1] % 2 == 0 and sides[-1] > 2:
        sides.append(sides[-1] // 2)
    sides = sides[::-1]  # coarse -> fine
    centers = mesh.cell_centers()
    c2ps = []
    for s in sides:
        blk = n // s
        bx = np.minimum((centers[:, 0] * n // blk).astype(int), s - 1)
        by = np.minimum((centers[:, 1] * n // blk).astype(int), s - 1)
        c2ps.append((bx * s + by).astype(np.int32))
    handlers = [AgglomerationHandler(mesh, c, degree=degree) for c in c2ps]
    parents = []
    for li in range(len(sides) - 1):
        s = sides[li + 1]
        ids = np.arange(s * s)
        bx, by = ids // s, ids % s
        parents.append(((bx // 2) * (s // 2) + by // 2).astype(np.int64))
    return handlers, parents


def coarse_domain_ids(domain_id, parents: list) -> list:
    """Each level's domain ids (coarse -> fine, the fine ``domain_id``
    last), carried down the hierarchy through the parent maps; raises
    where a coarse polytope's children lie in different subdomains."""
    doms = [np.asarray(domain_id)]
    for parent in parents[::-1]:
        parent = np.asarray(parent)
        fine = doms[0]
        if fine.shape[0] != parent.shape[0]:
            raise ValueError(f"{fine.shape[0]} domain ids for a level of "
                             f"{parent.shape[0]} polytopes")
        dom = np.zeros(int(parent.max()) + 1, dtype=fine.dtype)
        dom[parent] = fine
        if not np.array_equal(dom[parent], fine):
            raise ValueError("the subdomains are not aligned with the "
                             "hierarchy")
        doms.insert(0, dom)
    return doms


def mg_block_preconditioner(sys: StokesDarcySystem, mesh, n: int,
                            block: int, nu: float | None = None,
                            kappa: float | None = None,
                            penalty_v: float = 40.0,
                            source: str = "system",
                            ps_mode: str = "bj",
                            structure: str = "diag"):
    """Field-wise R3MG preconditioner of the coupled GMRES solve.

    u: a V-cycle on the velocity block (``source='system'``: the true u-u
    block of the coupled system re-assembled on every hierarchy level, all
    components in one cycle; ``'proxy'``: a scalar SIPG per level and
    component scaled by 1/nu); pS: block-Jacobi of its stabilization block
    (``ps_mode='bj'``), nu M_p^-1 (``'mass'``) or (D_C + M_p/nu)^-1
    (``'mass+stab'``); pD: a V-cycle on the true pD-pD block (Neumann on
    its subdomain: coarse deflation) or the scalar proxy scaled by
    1/kappa.  ``structure='tri'`` applies the blocks block-lower-
    triangularly (u, then pS less its u coupling, then pD less its u and
    pS couplings); it needs an explicit pS block.

    The coarse levels' systems take their subdomains from the fine
    system's ``domain_id`` through the hierarchy's parents
    (:func:`coarse_domain_ids`), so any hierarchy-aligned split works."""
    from polydeal_tpu_torch.assembly import assemble_sipg_matrix
    from polydeal_tpu_torch.solvers import (build_field_block_multigrid,
                                            build_multigrid)

    nu = NU if nu is None else nu
    kappa = KAPPA if kappa is None else kappa
    sp = sys.space
    dev, dtype = sys.rhs.device, sys.rhs.dtype
    fu, fpS, fpD = sp.fields["u"], sp.fields["pS"], sp.fields["pD"]
    deg_v = fu.basis.degree
    deg_pS = fpS.basis.degree
    deg_pD = fpD.basis.degree
    dim = mesh.dim
    if structure == "tri" and ps_mode == "bj":
        raise ValueError("structure='tri' needs an explicit pS Schur block "
                         "(ps_mode 'mass' or 'mass+stab')")

    level_ops = None
    if source == "system":
        # the coupled system re-assembled on every level (shared by the u
        # and pD chains: the same polytope ids on each level)
        handlers_v, parents_v = block_hierarchy(mesh, n, block, deg_v)
        doms = coarse_domain_ids(sys.meta["domain_id"], parents_v)
        level_ops = []
        for li, h in enumerate(handlers_v):
            if li == len(handlers_v) - 1:
                level_ops.append((sp, sys.op))
                continue
            sys_l = build_darcy_stokes(
                h, doms[li], degree_v=deg_v, degree_pS=deg_pS,
                degree_pD=deg_pD, penalty_v=penalty_v, dtype=dtype,
                device=dev)
            level_ops.append((sys_l.space, sys_l.op))
    elif source != "proxy":
        raise ValueError(f"unknown source: {source!r}")

    mgs = {}
    specs = (("u", deg_v, nu, penalty_v * (deg_v + 1) * (deg_v + dim)),
             ("pD", deg_pD, kappa, None))
    for name, deg, scale, pc in specs:
        handlers, parents = (
            (handlers_v, parents_v) if source == "system" and deg == deg_v
            else block_hierarchy(mesh, n, block, deg))
        if source == "system":
            mg_f = build_field_block_multigrid(sp, sys.op, name, handlers,
                                               parents, chebyshev_degree=5,
                                               dtype=dtype,
                                               level_ops=level_ops)
            mgs[name] = (mg_f, 1.0, handlers[-1], True)
        else:
            A = assemble_sipg_matrix(handlers[-1], penalty_constant=pc,
                                     dtype=dtype, device=dev)
            mgs[name] = (build_multigrid(handlers, parents, A, dtype=dtype,
                                         device=dev),
                         scale, handlers[-1], False)

    bj = sys.op.block_jacobi()
    ps_apply = None
    if ps_mode != "bj":
        meta = sys.meta
        volp = meta["vol_pS"]
        c = torch.as_tensor(meta["cells_s"], device=dev)
        Mc = torch.einsum("cqi,cqj,cq->cij", volp.B[c], volp.B[c], volp.w[c])
        Mp = segment_sum(Mc, meta["rows_s"], fpS.n_polys)
        if ps_mode == "mass":
            Sinv = nu * torch.linalg.inv(Mp)
        elif ps_mode == "mass+stab":
            Sinv = torch.linalg.inv(sys.op.diag_blocks("pS") + Mp / nu)
        else:
            raise ValueError(f"unknown ps_mode: {ps_mode!r}")

        def ps_apply(rb):  # [n_polys_pS, block]
            return torch.einsum("pij,pj->pi", Sinv, rb)

    polys_t = {name: torch.as_tensor(sp.fields[name].polys, device=dev)
               for name in ("u", "pD")}

    def field_mg(name, r):
        # r: field-local [n_f, d, nb]
        mg_f, s_f, ah_f, true_block = mgs[name]
        f = sp.fields[name]
        idx = polys_t[name]
        if true_block:
            # one V-cycle over all components (component-major blocks)
            full = r.new_zeros((ah_f.n_poly, f.block))
            full[idx] = r.reshape(f.n_polys, f.block)
            z = mg_f.v_cycle(full.reshape(-1))
            return z.reshape(ah_f.n_poly, f.block)[idx].reshape(
                f.n_polys, f.n_components, f.basis.n_basis)
        comps = []
        for d in range(f.n_components):
            full = r.new_zeros((ah_f.n_poly, f.basis.n_basis))
            full[idx] = r[:, d, :]
            z = mg_f.v_cycle(full.reshape(-1)) / s_f
            comps.append(z.reshape(ah_f.n_poly, f.basis.n_basis)[idx])
        return torch.stack(comps, dim=1)

    tri = structure == "tri"

    def M(v):
        zu = field_mg("u", sp.unpack(v, "u"))
        parts = {"u": zu}
        rS = sp.unpack(v, "pS").reshape(fpS.n_polys, fpS.block)
        zu_b = zu.reshape(fu.n_polys, fu.block)
        if tri:
            rS = rS - sys.op.block_apply("pS", "u", zu_b)
        if ps_apply is None:
            parts["pS"] = bj(v)[sp.dof_slice("pS")]
            zS_b = parts["pS"].reshape(fpS.n_polys, fpS.block)
        else:
            zS_b = ps_apply(rS)
            parts["pS"] = zS_b
        rD = sp.unpack(v, "pD")
        if tri:
            rD_b = (rD.reshape(fpD.n_polys, fpD.block)
                    - sys.op.block_apply("pD", "u", zu_b)
                    - sys.op.block_apply("pD", "pS", zS_b))
            rD = rD_b.reshape(fpD.n_polys, fpD.n_components,
                              fpD.basis.n_basis)
        parts["pD"] = field_mg("pD", rD)
        return sp.pack(parts)

    M.mgs = {name: v[0] for name, v in mgs.items()}
    return M


def solve_darcy_stokes_mg(sys: StokesDarcySystem, mesh, n: int, block: int,
                          rtol: float = 1e-10, restart: int = 200,
                          max_restarts: int = 40, ps_mode: str = "mass+stab",
                          structure: str = "tri"):
    """GMRES with the field-wise R3MG preconditioner, block-triangular by
    default (velocity V-cycle, stabilized pressure-Schur pS block, pD
    V-cycle): mesh-robust iteration counts."""
    from polydeal_tpu_torch.solvers.gmres import gmres_solve

    M = mg_block_preconditioner(sys, mesh, n, block, ps_mode=ps_mode,
                                structure=structure)
    return gmres_solve(_regularized(sys), sys.rhs, M=M, restart=restart,
                       rtol=rtol,
                       max_restarts=max_restarts)


def errors(sys: StokesDarcySystem, x: torch.Tensor):
    """(u_L2, u_H1semi, pS_L2, pD_L2) against the manufactured solution,
    the combined pressure mean of the exact fields removed (computed
    numerically)."""
    sp, meta = sys.space, sys.meta
    dev = x.device
    u, pS, pD = u_exact_fn(), pS_exact_fn(), pD_exact_fn()
    vol_v, vol_pS, vol_pD = meta["vol_v"], meta["vol_pS"], meta["vol_pD"]
    cs = torch.as_tensor(meta["cells_s"], device=dev)
    cd = torch.as_tensor(meta["cells_d"], device=dev)
    rs = torch.as_tensor(meta["rows_s"], device=dev)
    rd = torch.as_tensor(meta["rows_d"], device=dev)

    mean_ex = (torch.einsum("cq,cq->", vol_pS.w[cs], pS(vol_pS.x[cs]))
               + torch.einsum("cq,cq->", vol_pD.w[cd], pD(vol_pD.x[cd])))
    mean_ex = mean_ex / vol_pS.w.sum()

    Ub = sp.unpack(x, "u")[rs]  # [c, dim, nbv]
    uh = torch.einsum("cqi,cdi->cqd", vol_v.B[cs], Ub)
    du = uh - u(vol_v.x[cs])
    e_u = torch.sqrt(torch.einsum("cq,cqd->", vol_v.w[cs], du**2))
    Gh = torch.einsum("cqie,cdi->cqde", vol_v.G[cs], Ub)
    gex = _u_grad_fn()(vol_v.x[cs])
    e_u_h1 = torch.sqrt(torch.einsum("cq,cqde->", vol_v.w[cs],
                                     (Gh - gex) ** 2))
    Pb = sp.unpack(x, "pS")[rs][:, 0]
    ph = torch.einsum("cqi,ci->cq", vol_pS.B[cs], Pb)
    e_ps = torch.sqrt(torch.einsum(
        "cq,cq->", vol_pS.w[cs], (ph - (pS(vol_pS.x[cs]) - mean_ex)) ** 2))
    Db = sp.unpack(x, "pD")[rd][:, 0]
    dh = torch.einsum("cqi,ci->cq", vol_pD.B[cd], Db)
    e_pd = torch.sqrt(torch.einsum(
        "cq,cq->", vol_pD.w[cd], (dh - (pD(vol_pD.x[cd]) - mean_ex)) ** 2))
    return float(e_u), float(e_u_h1), float(e_ps), float(e_pd)


def run(n=32, block=4, degree_v=2, degree_pS=1, degree_pD=1,
        dtype=torch.float64, *, device):
    """Block agglomeration of the unit square's n x n grid that never
    straddles y = 1/2 (block | n/2), assembled and solved densely:
    (sys, x)."""
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.mesh import hyper_cube

    if n % 2 or (n // 2) % block:
        raise ValueError("run needs block | n/2")
    mesh = hyper_cube(2, n)
    centers = mesh.cell_centers()
    bx = np.minimum((centers[:, 0] * n // block).astype(int), n // block - 1)
    by = np.minimum((centers[:, 1] * n // block).astype(int), n // block - 1)
    c2p = bx * (n // block) + by
    ah = AgglomerationHandler(mesh, c2p, degree=degree_v)
    pcy = np.zeros(ah.n_poly)
    np.add.at(pcy, c2p, centers[:, 1])
    pcy /= np.bincount(c2p)
    domain_id = (pcy < 0.5).astype(int)
    sys = build_darcy_stokes(ah, domain_id, degree_v, degree_pS, degree_pD,
                             dtype=dtype, device=device)
    return sys, solve_darcy_stokes_dense(sys)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--block", type=int, default=4)
    ap.add_argument("--degree-v", type=int, default=2)
    args = ap.parse_args()
    sys_, x = run(args.n, args.block, args.degree_v,
                  device=torch.device(args.device))
    e_u, e_u_h1, e_ps, e_pd = errors(sys_, x)
    print(f"n={args.n} dofs={sys_.space.n_dofs}")
    print(f"u  L2: {e_u:.4e}   H1: {e_u_h1:.4e}")
    print(f"pS L2: {e_ps:.4e}  pD L2: {e_pd:.4e}")


if __name__ == "__main__":
    main()
