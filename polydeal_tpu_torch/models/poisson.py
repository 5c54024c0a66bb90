"""Poisson on an agglomerated polytopal mesh, on torch tensors.

Counterpart of ``polydeal_tpu/models/poisson.py`` (the reference's
examples/poisson.cc: SIPG Poisson with METIS-like, R-tree or trivial
agglomeration) through the general block-COO path: the table assembly into
a ``BlockMatrix``, and R3MG whose ``Multigrid.setup`` turns every level
into a band (K0/K1/K2 on the card) or a block-ELL matrix.  As a CLI:

    python -m polydeal_tpu_torch.models.poisson --device cpu \\
        --dtype float64 --dim 2 --n 16

prints the mesh and agglomeration summary, the levels, the solver's
iterations and residual, and the L2/H1 errors against the product-sine
manufactured solution.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

__all__ = ["solve_poisson", "level_summary"]


def level_summary(mg) -> list:
    """(polytopes, format, band offsets or None) of each multigrid level,
    coarse to fine; format is 'banded' (K0 / fused K0), 'banded i-major'
    (K1 / K2), 'packed' or 'ell'."""
    from polydeal_tpu_torch.sparse import BlockBanded, BlockPacked

    out = []
    for e in mg.ells:
        if isinstance(e, BlockBanded):
            fmt = "banded i-major" if e.data_i is not None else "banded"
            out.append((e.n_block_rows, fmt, len(e.offsets)))
        elif isinstance(e, BlockPacked):
            out.append((e.n_block_rows, "packed", len(e.plan.offsets)))
        else:
            out.append((e.n_block_rows, "ell", None))
    return out


def solve_poisson(
    dim: int = 2,
    n: int = 16,
    degree: int = 1,
    strategy: str = "rtree",
    n_agglomerates: int | None = None,
    solver: str = "mg",
    distort: float = 0.0,
    rtol: float = 1e-9,
    dtype=torch.float64,
    verbose: bool = True,
    *,
    device,
) -> dict:
    """Solve -Laplace u = f on [0,1]^dim, u = prod sin(pi x), on ``device``.

    ``strategy``: 'rtree' (the R-tree hierarchy, every extraction level
    from 1 to the leaves' parents, plus the fine cells), 'metis' (a
    partition into ``n_agglomerates`` parts, default n_cells / 2^dim) or
    'trivial' (one cell a polytope).  ``solver``: 'mg' (R3MG-preconditioned
    CG, on an R-tree hierarchy), 'cg' (block-Jacobi CG; also what 'mg'
    runs without a hierarchy) or 'amg' (CG preconditioned by SA-AMG on the
    assembled matrix, ``solvers/amg.py``; its setup runs on the host).
    The 'mg' and 'amg' solves run on the card as captured programs.

    Returns the JAX package's keys (n_cells, n_poly, n_dofs, iterations,
    residual, l2, h1, t_setup, t_assembly, t_solve: host seconds, read
    after a device synchronise on CUDA) plus ``t_precond`` (the part of
    t_solve that built the multigrid or SA-AMG hierarchy, else 0.0),
    ``x`` (the solution),
    ``handlers`` (the fine handler last), ``A`` (the fine BlockMatrix),
    ``b``, ``mg`` (None without multigrid), ``amg`` (the SA-AMG
    hierarchy of the 'amg' arm, else None) and ``levels``
    (:func:`level_summary`)."""
    from polydeal_tpu_torch.agglomeration import (
        RTreeAgglomerator,
        agglomerate_by_partition,
    )
    from polydeal_tpu_torch.assembly.sipg import (
        assemble_rhs,
        assemble_sipg_matrix,
    )
    from polydeal_tpu_torch.handler import AgglomerationHandler
    from polydeal_tpu_torch.mesh import distort_random, hyper_cube
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.postprocess import compute_global_error
    from polydeal_tpu_torch.solvers import (
        block_jacobi_preconditioner,
        block_nullspace,
        build_amg,
        build_multigrid,
        build_rtree_hierarchy,
        cg_solve,
    )

    if solver not in ("mg", "cg", "amg"):
        raise ValueError(f"unknown solver: {solver}")
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    _build.prepare_device(device)

    def log(*a):
        if verbose:
            print(*a)

    t0 = time.perf_counter()
    m0 = hyper_cube(dim, n)
    mesh = distort_random(m0, distort, seed=1) if distort else m0

    def u_ex(x):
        return torch.prod(torch.sin(math.pi * x), dim=-1)

    def f(x):
        return dim * math.pi**2 * u_ex(x)

    def grad_u(x):
        comps = []
        for d in range(dim):
            g = math.pi * torch.cos(math.pi * x[..., d])
            for e in range(dim):
                if e != d:
                    g = g * torch.sin(math.pi * x[..., e])
            comps.append(g)
        return torch.stack(comps, dim=-1)

    handlers = parents = None
    if strategy == "rtree":
        agg = RTreeAgglomerator.build(m0.cell_centers())
        handlers, parents = build_rtree_hierarchy(
            mesh, agg, list(range(1, agg.n_levels - 1)), degree=degree)
        ah = handlers[-1]
    elif strategy == "metis":
        n_agg = n_agglomerates or max(mesh.n_cells // (2**dim), 1)
        c2p = agglomerate_by_partition(m0.cell_centers(), m0.neighbors,
                                       n_agg)
        ah = AgglomerationHandler(mesh, c2p, degree=degree)
    elif strategy == "trivial":
        ah = AgglomerationHandler(
            mesh, np.arange(mesh.n_cells, dtype=np.int32), degree=degree)
    else:
        raise ValueError(f"unknown strategy: {strategy}")
    t_setup = time.perf_counter() - t0
    log(f"mesh: {mesh.n_cells} cells | polytopes: {ah.n_poly} | "
        f"DoFs: {ah.n_dofs} (p={degree}) | setup {t_setup:.2f}s")

    t0 = time.perf_counter()
    A = assemble_sipg_matrix(ah, dtype=dtype, device=device)
    b = assemble_rhs(ah, f, u_ex, dtype=dtype, device=device)
    sync()
    t_asm = time.perf_counter() - t0
    log(f"assembly: {t_asm:.3f}s ({A.data.shape[0]} blocks)")

    t0 = time.perf_counter()
    mg = amg = None
    t_precond = 0.0
    if solver == "mg" and handlers is not None and len(handlers) > 1:
        mg = build_multigrid(handlers, parents, A, dtype=dtype, device=device)
        sync()
        t_precond = time.perf_counter() - t0
        res = mg.solve_cg(b, rtol=rtol)
    elif solver == "amg":
        # the reference's Trilinos-AMG comparison arm
        # (examples/agglo_amg.cc:1473-1530), as smoothed aggregation on the
        # assembled matrix
        amg = build_amg(A, nullspace=block_nullspace(ah))
        sync()
        t_precond = time.perf_counter() - t0
        res = amg.solve_cg(b, rtol=rtol)
    else:
        res = cg_solve(A.matvec, b,
                       M=block_jacobi_preconditioner(A.diag_blocks()),
                       rtol=rtol, maxiter=10000)
    sync()
    t_solve = time.perf_counter() - t0
    levels = None if mg is None else level_summary(mg)
    if levels is not None:
        log(f"levels (polytopes, format, offsets): {levels}")
    log(f"solve [{solver}]: {t_solve:.3f}s, {int(res.iterations)} "
        f"iterations, residual {float(res.residual):.2e}")

    l2, h1 = compute_global_error(ah, res.x, u_ex, grad_u)
    log(f"L2 error = {float(l2):.6e}   H1 error = {float(h1):.6e}")
    return dict(
        n_cells=mesh.n_cells,
        n_poly=ah.n_poly,
        n_dofs=ah.n_dofs,
        iterations=int(res.iterations),
        residual=float(res.residual),
        l2=float(l2),
        h1=float(h1),
        t_setup=t_setup,
        t_assembly=t_asm,
        t_solve=t_solve,
        t_precond=t_precond,
        x=res.x,
        handlers=handlers or [ah],
        A=A,
        b=b,
        mg=mg,
        amg=amg,
        levels=levels,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--n", type=int, default=16, help="cells per direction")
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--strategy", default="rtree",
                    choices=("rtree", "metis", "trivial"))
    ap.add_argument("--n-agglomerates", type=int, default=None)
    ap.add_argument("--solver", default="mg", choices=("mg", "amg", "cg"))
    ap.add_argument("--distort", type=float, default=0.0)
    ap.add_argument("--rtol", type=float, default=1e-9)
    args = ap.parse_args()
    solve_poisson(
        dim=args.dim, n=args.n, degree=args.degree, strategy=args.strategy,
        n_agglomerates=args.n_agglomerates, solver=args.solver,
        distort=args.distort, rtol=args.rtol,
        dtype=getattr(torch, args.dtype), device=torch.device(args.device))


if __name__ == "__main__":
    main()
