"""Stokes flow with vector DG on polytopal meshes, on torch tensors.

Counterpart of ``polydeal_tpu/models/stokes.py``, the foundation of the
reference's coupled-flow family (examples/darcy_stokes.cc, oseen.cc):
mixed [DGP_p]^dim velocity x DGP_{p-1} pressure,

  a(u,v) = component-wise SIPG Laplacian,
  b(v,q) = -int q div v + int_F {q} [v].n + int_dOmega q v.n,
  c(p,q) = delta sum_F h_F int_F [p][q]  (pressure-jump stabilization),

[[A, B^T], [B, -C]] (u, p) = (F, G) with the mean pressure pinned by a
rank-1 term, solved densely.  Velocity dofs [P, dim, nbv] flattened, then
pressure [P, nbp].  Every reduction is a deterministic segment sum.

    python -m polydeal_tpu_torch.models.stokes --device cpu --n 8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from polydeal_tpu_torch.utils.segment import segment_sum

__all__ = ["build_stokes_operators", "stokes_rhs", "solve_stokes_dense",
           "pressure_mean_vector", "pressure_errors", "velocity_errors",
           "divergence_norm"]


def build_stokes_operators(ah, degree_u=None, dtype=torch.float64,
                           delta=0.1, *, device):
    """(A_scalar, B, C, meta): the scalar SIPG velocity block, the
    pressure-velocity coupling B [P x P blocks of nbp x dim*nbv] and the
    pressure stabilization C, as BlockMatrix objects on ``device``."""
    from polydeal_tpu_torch.assembly import (
        assemble_sipg_matrix,
        build_face_tables,
        build_volume_tables,
        default_penalty_constant,
    )
    from polydeal_tpu_torch.fem.basis import LegendreDGP
    from polydeal_tpu_torch.sparse import BlockMatrix

    dim = ah.dim
    degree_u = degree_u or ah.degree
    if degree_u < 1:
        raise ValueError("the velocity degree must be at least 1")
    basis_u = LegendreDGP(dim, degree_u)
    basis_p = LegendreDGP(dim, degree_u - 1)
    nbv, nbp = basis_u.n_basis, basis_p.n_basis
    P = ah.n_poly

    vol_u = build_volume_tables(ah, dtype, basis=basis_u, device=device)
    vol_p = build_volume_tables(ah, dtype, basis=basis_p, device=device)
    fi_u, fb_u = build_face_tables(ah, dtype, basis=basis_u, device=device)
    fi_p, fb_p = build_face_tables(ah, dtype, basis=basis_p, device=device)

    A_scalar = assemble_sipg_matrix(ah, dtype=dtype, vol=vol_u,
                                    faces=(fi_u, fb_u), device=device)

    # B: volume -int q d_d v_d -> [n_c, nbp, nbv, dim]
    Bv_cell = -torch.einsum("cqi,cqjd,cq->cijd", vol_p.B, vol_u.G, vol_u.w)
    B_diag = segment_sum(Bv_cell, vol_u.cell2poly, P)
    rows = [np.arange(P)]
    cols = [np.arange(P)]
    datas = [B_diag]
    n_ = fi_u.n
    w_ = fi_u.w

    def fblk(qB, vB, sign):
        return sign * 0.5 * torch.einsum("fqi,fqj,fqd,fq->fijd", qB, vB, n_,
                                         w_)

    f_in, f_out = fi_u.poly_in, fi_u.poly_out
    B_diag2 = segment_sum(fblk(fi_p.B0, fi_u.B0, +1.0), f_in, P)
    B_diag2 = B_diag2 + segment_sum(fblk(fi_p.B1, fi_u.B1, -1.0), f_out, P)
    datas[0] = datas[0] + B_diag2
    key = fi_u.poly_in.astype(np.int64) * P + fi_u.poly_out
    pairs, pair_id = np.unique(key, return_inverse=True)
    pair_id = pair_id.reshape(-1)
    n_pairs = pairs.shape[0]
    B01 = segment_sum(fblk(fi_p.B0, fi_u.B1, -1.0), pair_id, n_pairs)
    B10 = segment_sum(fblk(fi_p.B1, fi_u.B0, +1.0), pair_id, n_pairs)
    rows += [(pairs // P), (pairs % P)]
    cols += [(pairs % P), (pairs // P)]
    datas += [B01, B10]
    if fb_u.poly_in.shape[0]:  # boundary: + int q v.n
        Bb = torch.einsum("fqi,fqj,fqd,fq->fijd", fb_p.B0, fb_u.B0, fb_u.n,
                          fb_u.w)
        datas[0] = datas[0] + segment_sum(Bb, fb_u.poly_in, P)
    # (d, jv) flattened into one column-block axis of size dim*nbv
    data = torch.cat(
        [d.permute(0, 1, 3, 2).reshape(d.shape[0], nbp, dim * nbv)
         for d in datas], dim=0)
    B = BlockMatrix.from_blocks(np.concatenate(rows), np.concatenate(cols),
                                data, P, P)

    # C: delta sum h_F int [p][q]
    hf = fi_p.h_f[:, None]
    wC = fi_p.w * hf * delta
    C00 = torch.einsum("fqi,fqj,fq->fij", fi_p.B0, fi_p.B0, wC)
    C11 = torch.einsum("fqi,fqj,fq->fij", fi_p.B1, fi_p.B1, wC)
    C01 = -torch.einsum("fqi,fqj,fq->fij", fi_p.B0, fi_p.B1, wC)
    C10 = -torch.einsum("fqi,fqj,fq->fij", fi_p.B1, fi_p.B0, wC)
    Cd = segment_sum(C00, f_in, P) + segment_sum(C11, f_out, P)
    C01m = segment_sum(C01, pair_id, n_pairs)
    C10m = segment_sum(C10, pair_id, n_pairs)
    C = BlockMatrix.from_blocks(
        np.concatenate([np.arange(P), pairs // P, pairs % P]),
        np.concatenate([np.arange(P), pairs % P, pairs // P]),
        torch.cat([Cd, C01m, C10m], dim=0), P, P)

    meta = dict(dim=dim, nbv=nbv, nbp=nbp, P=P, basis_u=basis_u,
                basis_p=basis_p, vol_u=vol_u, vol_p=vol_p,
                fi_u=fi_u, fb_u=fb_u, fi_p=fi_p, fb_p=fb_p,
                penalty=default_penalty_constant(degree_u, dim))
    return A_scalar, B, C, meta


def stokes_rhs(ah, meta, f_fn, g_fn):
    """(F, G): F = int f.v plus the velocity-Dirichlet Nitsche terms per
    component; G = int_dOmega q g.n (from b's boundary term)."""
    dim, nbp, P = meta["dim"], meta["nbp"], meta["P"]
    vol_u, fb_u, fb_p = meta["vol_u"], meta["fb_u"], meta["fb_p"]
    gamma_c = meta["penalty"]

    fv = f_fn(vol_u.x)  # [n_c, q, dim]
    Fc = torch.einsum("cqi,cqd,cq->cdi", vol_u.B, fv, vol_u.w)
    F = segment_sum(Fc, vol_u.cell2poly, P)  # [P, dim, nbv]
    G = vol_u.w.new_zeros((P, nbp))
    if fb_u.poly_in.shape[0]:
        gv = g_fn(fb_u.x)  # [n_f, q, dim]
        gamma = (gamma_c / fb_u.h_f)[:, None]
        gn = torch.einsum("fqid,fqd->fqi", fb_u.G0, fb_u.n)
        # per component: int (-d_n v + gamma v) g_d
        Ff = torch.einsum("fqi,fqd,fq->fdi", fb_u.B0 * gamma[..., None] - gn,
                          gv, fb_u.w)
        F = F + segment_sum(Ff, fb_u.poly_in, P)
        gq = torch.einsum("fqi,fqd,fqd,fq->fi", fb_p.B0, gv, fb_u.n, fb_u.w)
        G = G + segment_sum(gq, fb_u.poly_in, P)
    return F.reshape(-1), G.reshape(-1)


def solve_stokes_dense(ah, f_fn, g_fn, degree_u=None, delta=0.1,
                       dtype=torch.float64, *, device):
    """The whole saddle system assembled densely and solved with the mean
    pressure pinned by K + m m^T (the correctness path; small problems).
    Returns (U, Pr, meta)."""
    A_s, B, C, meta = build_stokes_operators(ah, degree_u, dtype, delta,
                                             device=device)
    dim, nbv, nbp, P = meta["dim"], meta["nbv"], meta["nbp"], meta["P"]
    nU, nP = P * dim * nbv, P * nbp

    # component-major expansion of the scalar SIPG into the velocity block
    Ad = A_s.to_dense().reshape(P, nbv, P, nbv)
    eye = torch.eye(dim, dtype=Ad.dtype, device=Ad.device)
    Afull = torch.einsum("ricj,de->rdicej", Ad, eye).reshape(nU, nU)
    Bd = B.to_dense()  # [nP, nU]
    Cd = C.to_dense()
    K = torch.cat([torch.cat([Afull, Bd.T], dim=1),
                   torch.cat([Bd, -Cd], dim=1)], dim=0)
    F, G = stokes_rhs(ah, meta, f_fn, g_fn)
    rhs = torch.cat([F, G])
    m = pressure_mean_vector(ah, meta)
    K = K + torch.outer(m, m)
    sol = torch.linalg.solve(K, rhs)
    return sol[:nU], sol[nU:], meta


def pressure_mean_vector(ah, meta) -> torch.Tensor:
    """m with m^T x = int_Omega p for the (u, p) layout."""
    vol_p = meta["vol_p"]
    dim, nbv, P = meta["dim"], meta["nbv"], meta["P"]
    ints = torch.einsum("cqi,cq->ci", vol_p.B, vol_p.w)
    mp = segment_sum(ints, vol_p.cell2poly, P)
    return torch.cat([mp.new_zeros(P * dim * nbv), mp.reshape(-1)])


def _cells(vol, dev):
    return torch.as_tensor(vol.cell2poly, dtype=torch.long, device=dev)


def pressure_errors(ah, meta, Pr, exact_p) -> float:
    """L2 error of the pressure against a zero-mean exact pressure."""
    vol_p = meta["vol_p"]
    nbp, P = meta["nbp"], meta["P"]
    Pb = Pr.reshape(P, nbp)[_cells(vol_p, Pr.device)]
    vals = torch.einsum("cqi,ci->cq", vol_p.B, Pb)
    pex = exact_p(vol_p.x)
    mean = torch.sum(vol_p.w * pex) / vol_p.w.sum()
    diff = vals - (pex - mean)
    return float(torch.sqrt(torch.sum(vol_p.w * diff**2)))


def velocity_errors(ah, meta, U, exact_u) -> float:
    """L2 error of the velocity."""
    vol_u = meta["vol_u"]
    dim, nbv, P = meta["dim"], meta["nbv"], meta["P"]
    Ub = U.reshape(P, dim, nbv)[_cells(vol_u, U.device)]
    vals = torch.einsum("cqi,cdi->cqd", vol_u.B, Ub)
    diff = vals - exact_u(vol_u.x)
    return float(torch.sqrt(torch.sum(vol_u.w[..., None] * diff**2)))


def divergence_norm(ah, meta, U) -> float:
    """||div u_h||_L2 over the fine cells."""
    vol_u = meta["vol_u"]
    dim, nbv, P = meta["dim"], meta["nbv"], meta["P"]
    Ub = U.reshape(P, dim, nbv)[_cells(vol_u, U.device)]
    div = torch.einsum("cqid,cdi->cq", vol_u.G, Ub)
    return float(torch.sqrt(torch.sum(vol_u.w * div**2)))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--n-agglomerates", type=int, default=8)
    args = ap.parse_args()
    from polydeal_tpu_torch.agglomeration import agglomerate_by_partition
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.mesh import hyper_cube

    m = hyper_cube(2, args.n)
    c2p = agglomerate_by_partition(m.cell_centers(), m.neighbors,
                                   args.n_agglomerates)
    ah = AgglomerationHandler(m, c2p, degree=args.degree)
    # the exact flow u = (y, x) (divergence-free, Laplace u = 0), p = 0
    u_ex = lambda x: torch.stack([x[..., 1], x[..., 0]], dim=-1)
    f = lambda x: torch.zeros_like(x)
    U, Pr, meta = solve_stokes_dense(ah, f, u_ex, degree_u=args.degree,
                                     device=torch.device(args.device))
    print(f"velocity L2 error: {velocity_errors(ah, meta, U, u_ex):.3e}")
    print(f"||div u_h||: {divergence_norm(ah, meta, U):.3e}")


if __name__ == "__main__":
    main()
