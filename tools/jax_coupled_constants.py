"""Reference numbers of the JAX package's SA-AMG arms and coupled models,
for the checks of the PyTorch port's phase 10 in ``chip_smoke.py``.

Runs the JAX package's own entry points on the CPU in float64 and prints
one JSON object: iterations and L2/H1 errors of ``solve_poisson`` with
``solver="amg"`` and of diffusion-reaction's partition arm; the
Stokes-Darcy errors of the dense solve and the MG-GMRES iterations of
``run(n, 2)`` + ``solve_darcy_stokes_mg``; Oseen's errors (straight and
curved split) and MG-GMRES iterations; the piston's iterations and
extrema; one hp dense solve.  ``chip_smoke.py`` holds the port's card
runs to these numbers (``JAX_COUPLED``).

    JAX_PLATFORMS=cpu python tools/jax_coupled_constants.py [--cases a,b]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# the coupled MG-GMRES solves' tolerance: the JAX package's tests'
# (tests/test_darcy_stokes.py:158, tests/test_oseen.py:128), at which its
# recorded darcy trajectory 49/92/103/109 was taken
RTOL = 1e-11


def poisson_amg(dim, n):
    from polydeal_tpu.models.poisson import solve_poisson

    r = solve_poisson(dim=dim, n=n, degree=1, solver="amg", verbose=False)
    return {k: r[k] for k in ("n_dofs", "iterations", "l2", "h1")}


def dr_partition(n):
    from polydeal_tpu.models.diffusion_reaction import (
        solve_diffusion_reaction)

    return solve_diffusion_reaction(dim=2, n=n, strategy="metis",
                                    verbose=False)


def darcy(n):
    """Errors of ``run(n, 2)``'s dense solve and the MG-GMRES iterations
    (rtol ``RTOL``)."""
    import polydeal_tpu as pd
    from polydeal_tpu.models import darcy_stokes as ds

    sys_, x = ds.run(n, 2)
    e = ds.errors(sys_, x)
    res = ds.solve_darcy_stokes_mg(sys_, pd.hyper_cube(2, n), n, 2,
                                   rtol=RTOL)
    return dict(n_dofs=sys_.space.n_dofs, u_l2=e[0], u_h1=e[1], pS_l2=e[2],
                pD_l2=e[3], mg_iterations=int(res.iterations))


def oseen(n, curved=False, mg=True):
    from polydeal_tpu.mesh.fine_mesh import hyper_rectangle
    from polydeal_tpu.models import oseen as os_

    space, x, meta = (os_.run_curved if curved else os_.run)(n, 2)
    e = os_.oseen_errors(space, x, meta)
    out = dict(n_dofs=space.n_dofs, u_l2=e[0], u_h1=e[1], p_l2=e[2])
    if mg:
        mesh = hyper_rectangle(2, [n, n], lo=[-0.5, 0.0], hi=[1.5, 2.0])
        _, op, rhs, _ = os_.build_oseen(space.ah, meta["domain_id"])
        out["mg_iterations"] = int(os_.solve_oseen_mg(
            space, op, rhs, meta, mesh, n, 2, rtol=RTOL).iterations)
    return out


def piston(n):
    from polydeal_tpu.models.piston import solve_piston

    out, _ = solve_piston(n=n, degree=1, verbose=False)
    return out


def hp():
    """``build_hp_poisson`` on the JAX hp test's mesh (n = 8, R-tree level
    2, p = 1 left and 2 right of x = 1/2) with u = x^2 + y: its L2 error
    and the solution's 2-norm."""
    import jax.numpy as jnp
    import numpy as np

    import polydeal_tpu as pd
    from polydeal_tpu.agglomeration import RTreeAgglomerator
    from polydeal_tpu.fem import hp as hp_

    mesh = pd.hyper_cube(2, 8)
    c2p = RTreeAgglomerator.build(mesh.cell_centers()).extract_agglomerates(2)
    ah = pd.AgglomerationHandler(mesh, c2p, degree=1, n_quad=3)
    cx = np.zeros(ah.n_poly)
    np.add.at(cx, c2p, mesh.cell_centers()[:, 0])
    cx /= np.bincount(c2p)
    degrees = np.where(cx < 0.5, 1, 2)
    u = lambda x: x[..., 0] ** 2 + x[..., 1]
    space, op, rhs = hp_.build_hp_poisson(
        ah, degrees, f_fn=lambda x: jnp.full(x.shape[:-1], -2.0), g_fn=u)
    x = hp_.solve_hp_dense(space, op, rhs)
    return dict(n_dofs=space.n_dofs,
                l2=hp_.hp_l2_error(ah, space, degrees, x, u),
                x_norm=float(jnp.linalg.norm(x)))


CASES = {
    "amg_poisson_3d_p1_n16": lambda: poisson_amg(3, 16),
    "amg_poisson_3d_p1_n32": lambda: poisson_amg(3, 32),
    "dr_partition_2d_n16": lambda: dr_partition(16),
    "dr_partition_2d_n32": lambda: dr_partition(32),
    "darcy_n8": lambda: darcy(8),
    "darcy_n16": lambda: darcy(16),
    "darcy_n32": lambda: darcy(32),
    "darcy_n64": lambda: darcy(64),
    "oseen_n16": lambda: oseen(16),
    "oseen_curved_n16": lambda: oseen(16, curved=True, mg=False),
    "piston_n16": lambda: piston(16),
    "hp": hp,
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
