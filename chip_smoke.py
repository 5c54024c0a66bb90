"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each must pass; nothing falls back to the CPU):
  1. require a CUDA device (exit 2 without one) and the port's package;
  2. build the CUDA kernels from polydeal_tpu_torch/csrc/;
  3. check K1 (banded SpMV) and K2 (fused Chebyshev step/residual, all
     three modes) against their plain PyTorch versions at the flagship's
     fine-level shapes, for f32, bf16 and f64 bands, and time both;
  4. a small f64 flagship solve (n=16, every level on the kernels) on the
     card against the same solve on the CPU;
  5. the flagship R3MG Poisson solve at n=64, p=1 (1,048,576 DoF) on the
     card, which must reach rtol 1e-8 in 18-22 CG iterations through K1
     and K2.
Prints the card, a JSON line of per-kernel results, and last
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# flagship fine level: nb=4 (p=1, 3D), 7 offsets of the lex-relabelled
# 64^3 grid, R_pad = 28, P = 64^3
NB, P_FINE = 4, 64**3
OFFSETS_FINE = (-4096, -64, -1, 0, 1, 64, 4096)
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_pair(torch, kernel, plain, reps=50):
    """Mean ms per call of kernel and plain version, in turns (plain,
    kernel, kernel, plain), by CUDA events over ``reps`` calls."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kernel()
    plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_kernels(torch, dev):
    """Phase 3: K1/K2 against their plain versions; returns per-kernel
    (max_abs_err, ms, plain_ms) at the main path's dtypes."""
    from polydeal_tpu_torch.ops import (
        banded_cheb_step_t, banded_cheb_step_t_ref, banded_matvec_t_imajor,
        banded_matvec_t_imajor_ref, banded_residual_t, banded_residual_t_ref)

    n_off = len(OFFSETS_FINE)
    R_pad = -(-n_off * NB // 8) * 8
    gen = torch.Generator(device=dev).manual_seed(0)
    offs = torch.tensor(OFFSETS_FINE, dtype=torch.int32, device=dev)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    out = {"K1": [0.0, None, None], "K2": [0.0, None, None]}

    def record(name, label, got, ref, tol):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        parts = ("x'", "d'") if len(got) == 2 else ("y",)
        for part, g, r in zip(parts, got, ref):
            err = float((g - r).abs().max())
            rel = err / float(r.abs().max())
            log(f"  {name} {label} {part}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {tol:g})")
            if not rel <= tol:
                fail(f"{name} {label} disagrees with its plain version: "
                     f"rel {rel:.3e} > {tol:g}")
            out[name][0] = max(out[name][0], err)

    for dname, ddt, vdt in (("float32", torch.float32, torch.float32),
                            ("bfloat16", torch.bfloat16, torch.float32),
                            ("float64", torch.float64, torch.float64)):
        tol = TOL[dname]
        data_i = rnd(NB * R_pad, P_FINE, dtype=ddt)
        x, b, d = (rnd(NB, P_FINE, dtype=vdt) for _ in range(3))
        dinv = 1.0 + rnd(NB, P_FINE, dtype=vdt).abs()
        c1, c2 = 0.37, 1.21
        k1 = lambda: banded_matvec_t_imajor(data_i, offs, NB, x)
        p1 = lambda: banded_matvec_t_imajor_ref(data_i, offs, NB, x)
        record("K1", f"{dname} band", k1(), p1(), tol)
        cases = {
            "step0": (lambda: banded_cheb_step_t(data_i, offs, NB, x, None, b,
                                                 dinv, c1, c2),
                      lambda: banded_cheb_step_t_ref(data_i, offs, NB, x,
                                                     None, b, dinv, c1, c2)),
            "step": (lambda: banded_cheb_step_t(data_i, offs, NB, x, d, b,
                                                dinv, c1, c2),
                     lambda: banded_cheb_step_t_ref(data_i, offs, NB, x, d, b,
                                                    dinv, c1, c2)),
            "residual": (lambda: banded_residual_t(data_i, offs, NB, x, b),
                         lambda: banded_residual_t_ref(data_i, offs, NB, x,
                                                       b)),
        }
        for mode, (kf, pf) in cases.items():
            record("K2", f"{dname} band {mode}", kf(), pf(), tol)
        torch.cuda.synchronize()
        ms1, pms1 = time_pair(torch, k1, p1)
        ms2, pms2 = time_pair(torch, *cases["step"])
        log(f"  {dname} band: K1 {ms1:.4f} ms (plain {pms1:.4f} ms); "
            f"K2 step {ms2:.4f} ms (plain {pms2:.4f} ms)")
        # the main path runs K1 on the f32 CG operator and K2 on the bf16
        # smoother copies
        if dname == "float32":
            out["K1"][1:] = [ms1, pms1]
        if dname == "bfloat16":
            out["K2"][1:] = [ms2, pms2]
        del data_i, x, b, d, dinv
    return out


def small_solve_check(torch, dev):
    """Phase 4: f64 flagship at n=16 with every level on the kernels, on
    the card, against the same solve on the CPU (plain versions)."""
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.solvers import multigrid

    saved = multigrid.IMAJOR_MIN_P
    multigrid.IMAJOR_MIN_P = 0  # i-major copies (K1/K2) on every level
    try:
        res = {}
        for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            fs = setup_flagship(n=16, device=device, dtype=torch.float64,
                                precond_dtype=None)
            r = solve_flagship(fs)
            res[name] = (r.iterations, r.x.cpu(),
                         float(r.residual) / float(fs.b.norm()))
    finally:
        multigrid.IMAJOR_MIN_P = saved
    (ic, xc, rc), (ig, xg, rg) = res["cpu"], res["cuda"]
    diff = float((xc - xg).abs().max()) / float(xc.abs().max())
    log(f"  n=16 f64: cpu {ic} iters (rel res {rc:.3e}), cuda {ig} iters "
        f"(rel res {rg:.3e}), max |x_cuda - x_cpu| / max |x| = {diff:.3e}")
    # a summation-order change may move the stopping test by one iteration;
    # the solutions then agree to the solver tolerance
    if abs(ic - ig) > 1 or not diff <= 1e-6 or not rg <= 1e-8:
        fail("small f64 solve on the card disagrees with the CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; the port's kernels "
              "run only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "polydeal_tpu_torch")):
        print("chip_smoke: run from the root of a checkout (the "
              "polydeal_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {smi}")

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"  built in {build_s:.2f} s")
    for line in _build.last_build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 3: kernels against their plain versions (flagship shapes)")
    kres = check_kernels(torch, dev)
    torch.cuda.empty_cache()

    log("phase 4: small f64 solve, card against CPU")
    small_solve_check(torch, dev)

    log("phase 5: flagship n=64, p=1 on the card")
    _build.reset_launches()
    fs = setup_flagship(n=64, device=dev)
    res = solve_flagship(fs)  # cold
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = solve_flagship(fs)  # warm
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    counts = dict(_build.launches)
    bnorm = float(fs.b.norm())
    rel = float(res.residual) / bnorm
    x = res.x
    phases = {k: round(v, 3) for k, v in fs.setup_phases.items()}
    log(f"  levels {fs.level_sizes}, band offsets {fs.band_offsets.tolist()},"
        f" {fs.n_dofs} DoF")
    log(f"  setup phases (s): {phases}")
    log(f"  warm solve: {solve_s:.4f} s, {res.iterations} iterations, "
        f"relative residual {rel:.3e}")
    log(f"  kernel build: {build_s:.2f} s; launches over setup + 2 solves: "
        f"{counts}")
    if tuple(x.shape) != (fs.n_dofs,) or not bool(torch.isfinite(x).all()):
        fail("flagship solution has the wrong shape or non-finite values")
    if not rel <= 1e-8:
        fail(f"flagship relative residual {rel:.3e} > 1e-8")
    if not 18 <= res.iterations <= 22:
        fail(f"flagship took {res.iterations} iterations, outside 18-22")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the main path")

    # Reference: the same system solved in f64.  The f32 solve's residual
    # above is CG's recursive one; an f32 vector cannot have a small TRUE
    # residual here (A amplifies its rounding by lambda_max: rounding the
    # f64 solution to f32 alone leaves ~1e-3 at n=64), so the f32 solution
    # is held to the f64 one instead.
    ref = setup_flagship(n=64, device=dev, dtype=torch.float64,
                         precond_dtype=None)
    res64 = solve_flagship(ref)
    true64 = float((ref.b - ref.mg.ells[-1].matvec(res64.x)).norm()) / float(
        ref.b.norm())
    diff = float((x.double() - res64.x).abs().max()) / float(
        res64.x.abs().max())
    log(f"  f64 reference solve: {res64.iterations} iterations, true "
        f"relative residual {true64:.3e}; max |x_f32 - x_f64| / max |x_f64|"
        f" = {diff:.3e}")
    if not true64 <= 1.01e-8:
        fail(f"f64 reference true relative residual {true64:.3e} > 1e-8")
    if not diff <= 1e-4:
        fail(f"f32 flagship solution differs from the f64 one by {diff:.3e}")

    src = "polydeal_tpu_torch/csrc/banded.cu"
    kernels = [
        dict(name="banded_matvec_imajor", route="cuda", source=src,
             replaces="polydeal_tpu/ops/banded.py:65",
             launches=counts["banded_matvec_imajor"],
             max_abs_err=kres["K1"][0], ms=kres["K1"][1],
             plain_ms=kres["K1"][2]),
        dict(name="banded_fused_cheb", route="cuda", source=src,
             replaces="polydeal_tpu/ops/fused_cheb.py:210",
             launches=counts["banded_fused_cheb"],
             max_abs_err=kres["K2"][0], ms=kres["K2"][1],
             plain_ms=kres["K2"][2]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
