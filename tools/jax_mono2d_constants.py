"""Reference numbers of the JAX package's 2D high-order monodomain, for the
checks of the PyTorch port's run of it on the card.

Runs the JAX package on the CPU in float64: ``MonodomainConfig(dim=2,
n_refinements=5, degree=p)`` (the command line's defaults otherwise: BDF2
at dt 1e-4, stimulus 300 within radius 0.1 of the origin until 2e-3, CG to
its rtol preconditioned by R3MG) with the lex relabel, one BDF1 step and
then ``N_BDF2`` BDF2 steps, for p = 4 and 5 (nb = 15, 21: the shape at
which the JAX package runs its Pallas K5 alone).  Prints one JSON object:
per case the DoF, the CG iterations per step (BDF1 first) and the
integrals of u and u^2 over the fine mesh at the end.  ``chip_smoke.py``
(phase 17) holds the port's f64 card run to these numbers.

    JAX_PLATFORMS=cpu python tools/jax_mono2d_constants.py [--cases p4_n5]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

N_BDF2 = 5


def mono2d(degree, n_ref):
    import jax
    import numpy as np

    import polydeal_tpu.config as cfg_mod
    import polydeal_tpu.models.monodomain as mono

    s = mono.MonodomainSolver.build(
        cfg_mod.MonodomainConfig(dim=2, n_refinements=n_ref, degree=degree),
        relabel="lex")
    u, w = s.initial_state()
    u1, w1, it1 = jax.jit(lambda a, b, c: s.step(a, b, c, 0.0, True))(u, u,
                                                                      w)
    uf, _, _, its = s.steps_scan(u1, u, w1, s.cfg.dt, N_BDF2)
    uq = np.asarray(s.u_at_quad(uf), np.float64)
    wq = np.asarray(s.w_t, np.float64)
    return dict(n_dofs=int(s.handler.n_dofs),
                iterations=[int(it1)] + [int(i) for i in np.asarray(its)],
                int_u=float((wq * uq).sum()),
                int_u2=float((wq * uq * uq).sum()))


CASES = {
    "p4_n5": lambda: mono2d(4, 5),
    "p5_n5": lambda: mono2d(5, 5),
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
