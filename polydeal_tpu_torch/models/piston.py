"""3D piston: unstructured hex geometry, boundary ids and an R3MG solve,
on torch tensors.

Counterpart of ``polydeal_tpu/models/piston.py`` (the reference's
examples/3D_piston.cc): diffusion-reaction on a procedurally generated 3D
piston (a cylindrical crown with a combustion bowl and a stepped skirt:
a carved structured grid, a curved coordinate map), R-tree agglomerated
and solved with R3MG-preconditioned CG.  Boundary ids: 1 = crown top
(Dirichlet, hot), 2 = skirt bottom (Dirichlet, cool), 0 = the rest
(homogeneous Neumann).  Every level is a block-COO matrix that
``Multigrid.setup`` bands: K0 and fused K0 on the card (K1 and K2 where a
level reaches ``IMAJOR_MIN_P`` polytopes).

    python -m polydeal_tpu_torch.models.piston --device cpu --n 16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["piston_mesh", "solve_piston"]


def piston_mesh(n: int = 16):
    """Carved and mapped structured hex grid shaped like a piston: from
    [-1,1]^2 x [0,1] keep the crown (square radius <= 1, z >= 0.55) and
    the skirt (square radius <= 0.82, z < 0.55), map the square
    cross-section to a disc and sink a combustion bowl into the top."""
    from polydeal_tpu_torch.mesh.fine_mesh import FineMesh, hyper_rectangle

    base = hyper_rectangle(3, [n, n, n], lo=[-1, -1, 0], hi=[1, 1, 1])
    centers = base.cell_centers()
    rs = np.maximum(np.abs(centers[:, 0]), np.abs(centers[:, 1]))
    z = centers[:, 2]
    keep = ((z >= 0.55) & (rs <= 0.999)) | ((z < 0.55) & (rs <= 0.82))
    cells = base.cells[keep]
    used = np.unique(cells)
    remap = np.full(base.n_vertices, -1, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    verts = base.vertices[used].copy()

    # square -> disc on the cross-section (p' = p max(|x|,|y|) / |p|)
    xy = verts[:, :2]
    rfrm = np.maximum(np.abs(xy[:, 0]), np.abs(xy[:, 1]))
    rlen = np.linalg.norm(xy, axis=1)
    scale = np.where(rlen > 1e-12, rfrm / np.maximum(rlen, 1e-12), 1.0)
    verts[:, :2] = xy * scale[:, None]
    # combustion bowl: the top surface sinks near the axis
    r2 = verts[:, 0] ** 2 + verts[:, 1] ** 2
    bowl = 0.25 * np.exp(-6.0 * r2)
    verts[:, 2] = verts[:, 2] * (1.0 - bowl * np.clip(verts[:, 2], 0, 1))

    mesh = FineMesh(dim=3, vertices=verts,
                    cells=remap[cells].astype(np.int32))

    def ids(fc, nrm):
        out = np.zeros(fc.shape[0], dtype=np.int32)
        out[(nrm[:, 2] > 0.5) & (fc[:, 2] > 0.5)] = 1  # crown top
        out[(nrm[:, 2] < -0.5) & (fc[:, 2] < 0.1)] = 2  # skirt bottom
        return out

    return mesh.mark_boundary(ids)


def solve_piston(n: int = 16, degree: int = 1, reaction: float = 1.0,
                 t_hot: float = 1.0, t_cool: float = 0.0,
                 rtol: float = 1e-8, verbose: bool = True,
                 dtype=torch.float64, *, device):
    """-Laplace u + c u = 0, u = t_hot on the crown and t_cool on the skirt
    bottom, no flux elsewhere; R-tree agglomerated R3MG-CG.  Returns
    (summary dict, (handler, CG result))."""
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator
    from polydeal_tpu_torch.assembly import (assemble_rhs,
                                             assemble_sipg_matrix,
                                             mass_matrix)
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.postprocess import evaluate_at_quadrature
    from polydeal_tpu_torch.solvers import build_rtree_hierarchy
    from polydeal_tpu_torch.solvers.multigrid import (Multigrid, Transfer,
                                                      build_embedding)

    device = torch.device(device)
    _build.prepare_device(device)
    mesh = piston_mesh(n)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    levels = list(range(1, agg.n_levels - 1)) or [agg.n_levels - 1]
    handlers, parents = build_rtree_hierarchy(mesh, agg, levels,
                                              degree=degree)
    ah = handlers[-1]

    def g_dirichlet(x):
        # hot on the crown (its faces lie high), cool at the bottom
        return torch.where(x[..., 2] > 0.5, torch.full_like(x[..., 2], t_hot),
                           torch.full_like(x[..., 2], t_cool))

    dir_ids = (1, 2)

    def asm_level(h):
        K = assemble_sipg_matrix(h, dtype=dtype, dirichlet_ids=dir_ids,
                                 device=device)
        M = mass_matrix(h, dtype=dtype, device=device)
        return K.add(M.scale(reaction))

    transfers = [
        Transfer(E=build_embedding(handlers[l], handlers[l + 1], parents[l],
                                   dtype=dtype, device=device),
                 parent=parents[l], n_coarse=handlers[l].n_poly)
        for l in range(len(handlers) - 1)
    ]
    mg = Multigrid.setup([asm_level(h) for h in handlers], transfers)
    b = assemble_rhs(ah, lambda x: torch.zeros_like(x[..., 0]), g_dirichlet,
                     dtype=dtype, dirichlet_ids=dir_ids,
                     neumann_fn=lambda x, nrm: torch.zeros_like(x[..., 0]),
                     device=device)
    res = mg.solve_cg(b, rtol=rtol, maxiter=200)

    # sanity: the solution is bounded by the Dirichlet data (a maximum
    # principle up to DG wiggle)
    uq, _ = evaluate_at_quadrature(ah, res.x)
    out = dict(
        n_cells=mesh.n_cells,
        n_poly=ah.n_poly,
        n_dofs=ah.n_dofs,
        iterations=int(res.iterations),
        residual=float(res.residual),
        u_min=float(uq.min()),
        u_max=float(uq.max()),
    )
    if verbose:
        print(f"piston: cells={out['n_cells']} polytopes={out['n_poly']} "
              f"dofs={out['n_dofs']} iters={out['iterations']} "
              f"u in [{out['u_min']:.3f}, {out['u_max']:.3f}]")
    return out, (ah, res)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--vtu", default=None, help="write the solution as VTU")
    args = ap.parse_args()
    if args.vtu:
        raise NotImplementedError(
            "--vtu needs io.py, not ported yet (ROADMAP Queue 1 item 9)")
    solve_piston(args.n, args.degree, device=torch.device(args.device))


if __name__ == "__main__":
    main()
