"""How far the f32 flagship solve lies from the f64 one, by basis.

For each case (family, degree, n) it sets up the flagship twice on one
device, f64 (no low-precision copies) and f32 (``--precond`` smoothing
copies, bf16 by default), solves both to rtol 1e-8 and prints one JSON
line: both iteration counts and max |x_f32 - x_f64| / max |x_f64|; then
the same f32 solve with the CG operator's fine band replaced by the f64
band rounded to f32 (``rounded``), and the f64 solve with its fine band
replaced by the f32-assembled one widened to f64 (``f64_on_f32_band``):
they tell the band's rounding from the f32 arithmetic of the solve.

    python tools/f32_band_drift.py --device cpu --cases dgq:1:16,dgp:4:8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rel(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max())


def case(family, degree, n, device, precond):
    import torch

    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)

    t0 = time.perf_counter()
    kw = dict(n=n, degree=degree, family=family, device=device)
    ref = setup_flagship(**kw, dtype=torch.float64, precond_dtype=None)
    r64 = solve_flagship(ref, maxiter=200)
    fs = setup_flagship(**kw, precond_dtype=precond)
    r32 = solve_flagship(fs, maxiter=200)
    out = dict(family=family, degree=degree, n=n,
               nb=fs.handlers[-1].n_basis, its_f64=r64.iterations,
               its_f32=r32.iterations, x_rel=rel(r32.x, r64.x))
    A32, A64 = fs.mg.ells[-1], ref.mg.ells[-1]
    key = "data_i" if A64.data_i is not None else "data"
    b32, b64 = getattr(A32, key), getattr(A64, key)
    assembled = b32.clone()
    # the CG operator's fine band only: the preconditioner moves the
    # iterations, not the solution CG converges to
    b32.copy_(b64.to(b32.dtype))
    r = solve_flagship(fs, maxiter=200)
    out.update(its_rounded=r.iterations, x_rel_rounded=rel(r.x, r64.x))
    b64.copy_(assembled.to(b64.dtype))
    r = solve_flagship(ref, maxiter=200)
    out.update(its_f64_on_f32_band=r.iterations,
               x_rel_f64_on_f32_band=rel(r.x, r64.x))
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", default="dgq:1:16,dgq:1:32,dgq:2:16,dgp:4:8",
                    help="family:degree:n, comma-separated")
    ap.add_argument("--precond", default="bfloat16",
                    help="dtype of the f32 solve's smoothing copies")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    precond = getattr(torch, args.precond)
    for c in args.cases.split(","):
        family, degree, n = c.split(":")
        print(json.dumps(case(family, int(degree), int(n),
                              torch.device(args.device), precond)),
              flush=True)


if __name__ == "__main__":
    main()
