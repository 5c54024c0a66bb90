"""Diffusion-reaction on agglomerated polytopal meshes, on torch tensors.

Counterpart of ``polydeal_tpu/models/diffusion_reaction.py`` (the
reference's examples/diffusion_reaction.cc): -Laplace u + c u = f with SIPG
on an R-tree hierarchy, CG preconditioned by R3MG whose every level is
re-assembled as K + c M, and the convergence-rate study across
refinements; the METIS-like partition arm (and a tree too small for a
hierarchy) solves with CG and SA-AMG (``solvers/amg.py``).

    python -m polydeal_tpu_torch.models.diffusion_reaction --device cpu \\
        --dim 2 --n 16 [--convergence]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

__all__ = ["solve_diffusion_reaction", "convergence_study"]


def solve_diffusion_reaction(
    dim: int = 2,
    n: int = 16,
    degree: int = 1,
    reaction: float = 1.0,
    strategy: str = "rtree",
    rtol: float = 1e-9,
    dtype=torch.float64,
    verbose: bool = True,
    *,
    device,
) -> dict:
    """Solve -Laplace u + c u = f, u = prod sin(pi x), on ``device``;
    returns n_dofs, iterations and l2 (the JAX package's keys) and the
    solution ``x``."""
    from polydeal_tpu_torch.agglomeration import (
        RTreeAgglomerator,
        agglomerate_by_partition,
    )
    from polydeal_tpu_torch.assembly.sipg import (
        assemble_rhs,
        assemble_sipg_matrix,
        mass_matrix,
    )
    from polydeal_tpu_torch.mesh import hyper_cube
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.postprocess import compute_global_error
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.solvers import (
        block_nullspace,
        build_amg,
        build_rtree_hierarchy,
    )
    from polydeal_tpu_torch.solvers.multigrid import (
        Multigrid,
        Transfer,
        build_embedding,
    )

    if strategy not in ("rtree", "metis"):
        raise ValueError(f"unknown strategy: {strategy}")
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.prepare_device(device)
    mesh = hyper_cube(dim, n)

    # manufactured solution: -Laplace u + c u = (dim pi^2 + c) u
    def u_ex(x):
        return torch.prod(torch.sin(math.pi * x), dim=-1)

    def f(x):
        return (dim * math.pi**2 + reaction) * u_ex(x)

    handlers = []
    if strategy == "rtree":
        agg = RTreeAgglomerator.build(mesh.cell_centers())
        handlers, parents = build_rtree_hierarchy(
            mesh, agg, list(range(1, agg.n_levels - 1)), degree=degree)
    else:
        c2p = agglomerate_by_partition(
            mesh.cell_centers(), mesh.neighbors,
            max(mesh.n_cells // (2**dim), 1))
        ah = AgglomerationHandler(mesh, c2p, degree=degree)
    if handlers:
        ah = handlers[-1]

    def operator(h):
        K = assemble_sipg_matrix(h, dtype=dtype, device=device)
        M = mass_matrix(h, dtype=dtype, device=device)
        return K.add(M.scale(reaction))

    A = operator(ah)
    b = assemble_rhs(ah, f, u_ex, dtype=dtype, device=device)
    if len(handlers) > 1:
        # every level is the diffusion + reaction operator, re-assembled
        transfers = [
            Transfer(E=build_embedding(handlers[l], handlers[l + 1],
                                       parents[l], dtype=dtype,
                                       device=device),
                     parent=parents[l], n_coarse=handlers[l].n_poly)
            for l in range(len(handlers) - 1)
        ]
        mg = Multigrid.setup([operator(h) for h in handlers[:-1]] + [A],
                             transfers)
        res = mg.solve_cg(b, rtol=rtol)
    else:
        # no geometric hierarchy (the METIS-like partition, or a one-level
        # tree): CG + smoothed-aggregation AMG, the reference's
        # configuration (METIS agglomerates, Trilinos AMG;
        # diffusion_reaction.cc:710-724)
        res = build_amg(A, nullspace=block_nullspace(ah)).solve_cg(
            b, rtol=rtol)

    l2, _ = compute_global_error(ah, res.x, u_ex)
    if verbose:
        print(f"n={n} polytopes={ah.n_poly} dofs={ah.n_dofs} "
              f"iters={int(res.iterations)} L2={float(l2):.6e}")
    return dict(n_dofs=ah.n_dofs, iterations=int(res.iterations),
                l2=float(l2), x=res.x)


def convergence_study(dim=2, degree=1, sizes=(8, 16, 32), **kw):
    """L2 errors across refinements and the rates between them (the
    reference's diffusion_reaction.cc check)."""
    errs = [solve_diffusion_reaction(dim=dim, n=n, degree=degree, **kw)["l2"]
            for n in sizes]
    rates = [float(np.log2(errs[i] / errs[i + 1]))
             for i in range(len(errs) - 1)]
    return errs, rates


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--reaction", type=float, default=1.0)
    ap.add_argument("--strategy", default="rtree", choices=("rtree", "metis"))
    ap.add_argument("--convergence", action="store_true")
    args = ap.parse_args()
    kw = dict(strategy=args.strategy, reaction=args.reaction,
              dtype=getattr(torch, args.dtype),
              device=torch.device(args.device))
    if args.convergence:
        errs, rates = convergence_study(dim=args.dim, degree=args.degree,
                                        **kw)
        print("errors:", errs)
        print("rates:", rates)
    else:
        solve_diffusion_reaction(dim=args.dim, n=args.n, degree=args.degree,
                                 **kw)


if __name__ == "__main__":
    main()
