"""Reference numbers of the JAX package's general block-COO path, for the
checks of the PyTorch port's scalar models.

Runs the JAX package's own entry points on the CPU in float64 and prints
one JSON object: iterations and L2/H1 errors of ``solve_poisson``
(R-tree + R3MG; the METIS-like partition + block-Jacobi CG arm), the
diffusion-reaction solves behind ``convergence_study``, and a
Galerkin-coarsened R3MG solve.  ``chip_smoke.py`` holds the port's
card runs to these numbers.

    JAX_PLATFORMS=cpu python tools/jax_coo_constants.py [--cases a,c,...]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def poisson(dim, n, degree, strategy="rtree", solver="mg"):
    from polydeal_tpu.models.poisson import solve_poisson

    r = solve_poisson(dim=dim, n=n, degree=degree, strategy=strategy,
                      solver=solver, verbose=False)
    return {k: r[k] for k in ("n_dofs", "iterations", "l2", "h1")}


def diffusion_reaction(dim, n, degree):
    from polydeal_tpu.models.diffusion_reaction import (
        solve_diffusion_reaction)

    return solve_diffusion_reaction(dim=dim, n=n, degree=degree,
                                    verbose=False)


def galerkin(dim, n):
    """``build_multigrid(mode="galerkin")`` on the R-tree hierarchy of
    ``solve_poisson``, p=1, its system and rtol."""
    import jax.numpy as jnp

    import polydeal_tpu as pd
    from polydeal_tpu.agglomeration import RTreeAgglomerator
    from polydeal_tpu.assembly import assemble_rhs, assemble_sipg_matrix
    from polydeal_tpu.postprocess import compute_global_error
    from polydeal_tpu.solvers import build_multigrid, build_rtree_hierarchy

    mesh = pd.hyper_cube(dim, n)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    handlers, parents = build_rtree_hierarchy(
        mesh, agg, list(range(1, agg.n_levels - 1)), degree=1)
    ah = handlers[-1]
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    A = assemble_sipg_matrix(ah)
    b = assemble_rhs(ah, lambda x: dim * jnp.pi**2 * u_ex(x), u_ex)
    mg = build_multigrid(handlers, parents, A, mode="galerkin")
    res = mg.solve_cg(b, rtol=1e-9)
    l2, _ = compute_global_error(ah, res.x, u_ex)
    return dict(n_dofs=ah.n_dofs, iterations=int(res.iterations),
                l2=float(l2))


CASES = {
    "poisson_3d_p1_n16": lambda: poisson(3, 16, 1),
    "poisson_3d_p1_n32": lambda: poisson(3, 32, 1),
    "poisson_3d_p2_n16": lambda: poisson(3, 16, 2),
    "poisson_3d_p2_n32": lambda: poisson(3, 32, 2),
    "dr_3d_p1_n16": lambda: diffusion_reaction(3, 16, 1),
    "dr_3d_p1_n32": lambda: diffusion_reaction(3, 32, 1),
    "poisson_2d_p2_n128_metis_cg": lambda: poisson(2, 128, 2, "metis", "cg"),
    "galerkin_3d_p1_n32": lambda: galerkin(3, 32),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name in args.cases.split(","):
        t0 = time.perf_counter()
        out[name] = CASES[name]()
        print(f"{name}: {out[name]} ({time.perf_counter() - t0:.1f} s)",
              file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
