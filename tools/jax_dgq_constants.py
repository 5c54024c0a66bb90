"""Reference numbers of the JAX package's flagship solve with the TensorDGQ
basis, for the checks of the PyTorch port's dgq path.

Runs the JAX package on the CPU in float64, configured as the port's
``setup_flagship(n, degree, family="dgq", dtype=torch.float64,
precond_dtype=None)``: the R-tree hierarchy of ``hyper_cube(3, n)`` with
the lex relabel trimmed to 3 extraction levels, the fine band assembled
directly (the einsum branch), R3MG with degree-5 Chebyshev, one sweep, an
explicit-inverse coarse solve, CG from an FMG start to rtol 1e-8.  Prints
one JSON object: per case the DoF, CG iterations and the L2 error against
the exact solution prod sin(pi x).  ``chip_smoke.py`` (phase 16) holds the
port's card run to these numbers.

    JAX_PLATFORMS=cpu python tools/jax_dgq_constants.py [--cases q1_n32]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def flagship(n, degree, family="dgq"):
    import jax.numpy as jnp
    import numpy as np

    import polydeal_tpu as pd
    from polydeal_tpu.agglomeration import RTreeAgglomerator
    from polydeal_tpu.assembly.sipg import (assemble_rhs_direct,
                                            assemble_sipg_banded_direct,
                                            build_banded_groups)
    from polydeal_tpu.postprocess import compute_global_error
    from polydeal_tpu.solvers import (build_multigrid, build_rtree_hierarchy,
                                      detect_grid_shapes)

    mesh = pd.hyper_cube(3, n)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    lv0 = max(1, agg.n_levels - 1 - 3)
    handlers, parents = build_rtree_hierarchy(
        mesh, agg, list(range(lv0, agg.n_levels - 1)), degree=degree,
        family=family, relabel="lex")
    ah = handlers[-1]
    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    groups = build_banded_groups(ah, offs, jnp.float64)
    A0 = assemble_sipg_banded_direct(ah, groups, offsets=offs,
                                     use_pallas=False)
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    b = assemble_rhs_direct(ah, groups, lambda x: 3 * jnp.pi**2 * u_ex(x),
                            u_ex)
    mg = build_multigrid(handlers, parents, A0, dtype=jnp.float64,
                         grid_shapes=detect_grid_shapes(handlers, parents),
                         chebyshev_degree=5, n_smooth=1,
                         smoothing_range=20.0, level_assembly="banded",
                         coarse_solver="inv", fused_smoother=False)
    res = mg.solve_cg(b, rtol=1e-8, maxiter=100, fmg=True)
    l2, _ = compute_global_error(ah, res.x, u_ex)
    return dict(n_dofs=ah.n_dofs, iterations=int(res.iterations),
                l2=float(l2))


CASES = {
    "q1_n32": lambda: flagship(32, 1),
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
