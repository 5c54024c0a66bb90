"""K0 and fused K0 (``csrc/banded_omajor.cu``) and K5 at 2D p = 4-5
(``csrc/sipg.cu``) of this checkout against another checkout's, in one
process on one card, on the bands and tables of the paths that run them.

Builds this checkout's kernel library and, with ``--parent DIR``, the
library of the checkout at DIR (its ``polydeal_tpu_torch/csrc``; the C
interface is the same, but for K0's plan, which a parent from before it
crossed the interface chooses itself: ``PlanFree``), then runs each case
through this checkout's wrappers with either library loaded, in turns
parent, tree, tree, parent.

K0: per band, K0's product and fused K0's step, each timed by its device
duration in a torch.profiler trace (microseconds a launch, 30 launches a
trace): warm (back to back, as a captured solve's replays find a band of a
few MB in L2) and cold (L2 evicted by a 512 MB read before each launch);
beside them the traced duration of an empty kernel on the same grid (the
launch floor), the byte bound (the band entries the offsets reach, x, and
y -- or x, b, d, dinv, x', d' fused -- over 3.35 TB/s), a torch.sparse CSR
``torch.mv`` of the same band (f32 and f64 bands) and the tree's plan.
Every mode (product, step, step0, residual) is held to its plain version
(1e-5 / 1e-12 relative to the largest entry) with either library, the
tree's two launches bitwise, and the tree against the parent bitwise.
The bands: the coupled fine bands (darcy_stokes' u and pD blocks, oseen's
scalar proxy, n=64, f64), the lex flagship's 4096-lane level (f32 and its
bf16 smoothing copy), the monodomain's levels at 64-4096 lanes and its
fine block-Jacobi operator, the COO Poisson's 4096-lane 25-offset f64
band, the 2D monodomain's levels under 32768 lanes (p = 4 at
n_refinements=9, p = 5 at 8) and TensorDGQ Q1 / Q2 / P_4's (n = 64 / 32
/ 32; the f32 band and the bf16 smoothing copy).  ``--quick`` takes
seeded bands at such shapes instead (no model set-up).

K5 at 2D p = 4 and 5 (and K3-K5 at the p = 1-3 shapes of
``profile_sipg.SIPG_SHAPES``), f32 and f64, on seeded tables: device ms of
one launch with L2 evicted (``profile_sipg.cold_ms``), the tree against the
parent bitwise.

Prints one line a case and one JSON object last; ``--out`` writes the
JSON too.

    python3 tools/profile_k0.py [--parent DIR] [--quick] [--out FILE]
        [--models coupled,lex,monodomain,coo,mono2d,dgq] [--no-sipg]

``--models`` takes only those models' real bands; ``--no-sipg`` leaves
out K3-K5.
"""

import argparse
import ctypes
import glob
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
C1, C2 = 0.37, 1.21
REPS = 30  # launches a trace
# the models whose real bands the default run takes, in order
MODELS = ("coupled", "lex", "monodomain", "coo", "mono2d", "dgq")
K0_ENTRIES = ("pd_banded_matvec_omajor", "pd_banded_fused_omajor")
SIPG_ENTRIES = ("pd_sipg_form_info", "pd_sipg_volume", "pd_sipg_face",
                "pd_sipg_boundary")
# where K0's entries take the plan: after P, three arguments
PLAN_ARGS = slice(8, 11)


def bind(lib, tree, names):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = getattr(tree, name).argtypes
        fn.restype = ctypes.c_int


def takes_plan(parent: str) -> bool:
    """Whether the checkout at ``parent`` passes K0's plan through its C
    interface."""
    for src in glob.glob(os.path.join(parent, "polydeal_tpu_torch", "csrc",
                                      "*.cu")):
        with open(src) as f:
            text = f.read()
        if "pd_banded_matvec_omajor(" in text:
            return "int path, int threads" in text
    raise SystemExit(f"profile_k0: no K0 entry under {parent}")


class PlanFree:
    """A library whose K0 entries take no plan (it chooses its own),
    called as this checkout's are: the plan's arguments dropped."""

    def __init__(self, lib, tree):
        self._lib = lib
        for name in K0_ENTRIES:
            types = list(getattr(tree, name).argtypes)
            del types[PLAN_ARGS]
            getattr(lib, name).argtypes = types
            getattr(lib, name).restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def pd_banded_matvec_omajor(self, *args):
        args = list(args)
        del args[PLAN_ARGS]
        return self._lib.pd_banded_matvec_omajor(*args)

    def pd_banded_fused_omajor(self, *args):
        args = list(args)
        del args[PLAN_ARGS]
        return self._lib.pd_banded_fused_omajor(*args)


def traced_groups(torch, fns, kernel, n=REPS, before=None, tries=3):
    """Device microseconds per launch of each of ``fns`` (zero-argument
    calls launching one kernel whose name holds ``kernel`` each): ``n``
    calls of each (``before`` ahead of every call) inside one
    torch.profiler trace, each function's calls in a host range of their
    own; a function's launches are the kernel's records that start inside
    its range.  A trace that lost more than half of a function's records
    is taken again; None where every trace did."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = [None] * len(fns)
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for k, fn in enumerate(fns):
                with torch.profiler.record_function(f"k0_group_{k}"):
                    for _ in range(n):
                        if before is not None:
                            before()
                        fn()
                    torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        spans = {e.name(): (e.start_ns(), e.end_ns()) for e in events
                 if e.name().startswith("k0_group_")
                 and e.device_type() != cuda}
        recs = [(e.start_ns(), e.end_ns() - e.start_ns()) for e in events
                if e.device_type() == cuda and kernel in e.name()]
        for k in range(len(fns)):
            if out[k] is not None or f"k0_group_{k}" not in spans:
                continue
            lo, hi = spans[f"k0_group_{k}"]
            mine = [d for s, d in recs if lo <= s <= hi]
            if 2 * len(mine) >= n:
                out[k] = sum(mine) / len(mine) / 1e3
        if all(v is not None for v in out):
            break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose kernels to time "
                    "beside this one's")
    ap.add_argument("--quick", action="store_true",
                    help="seeded bands at the paths' shapes, no model set-up")
    ap.add_argument("--models", default=",".join(MODELS),
                    help="the real bands' models, of " + ",".join(MODELS))
    ap.add_argument("--no-sipg", action="store_true",
                    help="time K0 only (no K3-K5 tables)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    models = set(args.models.split(","))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k0: needs a CUDA device")
    import chip_smoke as cs
    from profile_k1 import build_other
    from polydeal_tpu_torch.models import profile_sipg as ps
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.ops import banded as bd
    from polydeal_tpu_torch.ops import fused_cheb as fc
    from polydeal_tpu_torch.ops import sipg_kernels as sk
    from polydeal_tpu_torch.sparse import BlockBanded

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    parent = {}
    builder = None
    if args.parent:
        builder = threading.Thread(target=build_other,
                                   args=(args.parent, parent))
        builder.start()
    t0 = time.perf_counter()
    tree = _build.load_library()
    libs, built = {"tree": tree}, {"tree": time.perf_counter() - t0}
    if builder is not None:
        builder.join()
        if "error" in parent:
            raise SystemExit(f"profile_k0: the parent's build failed: "
                             f"{parent['error']}")
        built["parent"] = parent["seconds"]
        bind(parent["lib"], tree, SIPG_ENTRIES)
        if takes_plan(args.parent):
            bind(parent["lib"], tree, K0_ENTRIES)
            libs["parent"] = parent["lib"]
        else:
            libs["parent"] = PlanFree(parent["lib"], tree)
    print(f"built (s, in parallel): "
          f"{ {k: round(v, 2) for k, v in built.items()} }; the tree by "
          f"source: " + ", ".join(
              line[3:] for line in _build.last_build_log().splitlines()
              if line.startswith("== ")), flush=True)
    high_k5 = lambda line: "Boundary<" in line and (", 2, 4>" in line
                                                   or ", 2, 5>" in line)
    for line in ps.ptxas_summary(_build.last_build_log()):
        if "omajor_kernel" in line or high_k5(line):
            print(f"  ptxas (tree): {line}", flush=True)
    for line in ps.ptxas_summary(parent.get("log", "")):
        if high_k5(line):
            print(f"  ptxas (parent): {line}", flush=True)

    order = (["parent", "tree", "tree", "parent"] if "parent" in libs
             else ["tree", "tree"])
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.ones(512 << 18, dtype=torch.float32, device=dev)
    cold = lambda: flush.sum()  # a read: no dirty lines to write back
    results = {"k0": [], "k5": []}

    def use(lib):
        _build._lib = lib
        sk.sipg_form.cache_clear()

    def k0_case(label, data, offsets, nb, P):
        """K0's modes on one band ``data`` [n_off, nb, nb, P] with int
        ``offsets`` (host): held, bitwise, timed in turns."""
        dname = str(data.dtype).split(".")[-1]
        vdt = torch.float64 if dname == "float64" else torch.float32
        tol = TOL[dname]
        offs = torch.as_tensor(offsets, dtype=torch.int32, device=dev)
        kb = bd.omajor_band(data, offs)
        x, b, d, dinv = cs.cheb_vectors(torch, gen, nb, P, vdt)
        calls = {
            "product": (lambda: bd.banded_matvec_t_omajor(data, offs, x,
                                                          band=kb),
                        lambda: bd.banded_matvec_t_omajor_ref(data, offs,
                                                              x)),
            "step": (lambda: fc.banded_cheb_step_t_omajor(
                data, offs, x, d, b, dinv, C1, C2, band=kb),
                lambda: fc.banded_cheb_step_t_omajor_ref(
                    data, offs, x, d, b, dinv, C1, C2)),
            "step0": (lambda: fc.banded_cheb_step_t_omajor(
                data, offs, x, None, b, dinv, C1, C2, band=kb),
                lambda: fc.banded_cheb_step_t_omajor_ref(
                    data, offs, x, None, b, dinv, C1, C2)),
            "residual": (lambda: fc.banded_residual_t_omajor(
                data, offs, x, b, band=kb),
                lambda: fc.banded_residual_t_omajor_ref(data, offs, x, b))}
        tup = lambda r: r if isinstance(r, tuple) else (r,)
        outs = {}
        for name, lib in libs.items():
            use(lib)
            for mode, (kf, pf) in calls.items():
                got, ref = tup(kf()), tup(pf())
                rel = max(float((g - r).abs().max() / r.abs().max())
                          for g, r in zip(got, ref))
                if not rel <= tol:
                    raise SystemExit(f"{label} {mode}: the {name} kernel "
                                     f"disagrees with its plain version: "
                                     f"{rel:.3e}")
                outs[name, mode] = got
                if name == "tree" and not all(
                        torch.equal(a, g) for a, g in zip(tup(kf()), got)):
                    raise SystemExit(f"{label} {mode}: two launches differ")
        bitwise = "parent" not in libs or all(
            torch.equal(a, g) for mode in calls
            for a, g in zip(outs["tree", mode], outs["parent", mode]))
        use(tree)
        plan = kb.plan
        empty = lambda: tree.pd_empty_kernel(
            plan.blocks, plan.threads, _build.stream_handle(dev))
        floor = traced_groups(torch, [empty], "empty_kernel")[0]
        fns = [calls["product"][0], calls["step"][0]]
        times = {k: {"warm": [], "cold": []} for k in libs}
        for name in order:
            use(libs[name])
            times[name]["warm"].append(traced_groups(torch, fns,
                                                     "omajor_kernel"))
            times[name]["cold"].append(traced_groups(torch, fns,
                                                     "omajor_kernel",
                                                     before=cold))
        use(tree)
        band = SimpleNamespace(n_basis=nb, n_block_rows=P, offsets=offsets)
        vsz = x.element_size()
        pdt = "float64" if dname == "float64" else "float32"
        bounds = [ps.bound(*cs.k0_work(band, data, vsz, f), pdt)[0] * 1e3
                  for f in (False, True)]
        csr = None
        if dname in ("float32", "float64"):
            bi = BlockBanded(data, np.asarray(offsets), P).with_imajor()
            A = cs.csr_of_band(torch, bi.data_i, list(offsets), nb,
                               bi.data_i.shape[0] // nb, P)
            xf = x.T.contiguous().view(-1)
            csr = cs.time_one(torch, lambda: torch.mv(A, xf)) * 1e3
            del A, bi, xf

        def mean(name, kind, k):
            v = [t[k] for t in times[name][kind] if t[k] is not None]
            return sum(v) / len(v) if v else None

        row = dict(case=label, dtype=dname, nb=nb, P=P, n_off=len(offsets),
                   plan=plan._asdict(), floor_us=floor, bitwise=bitwise,
                   bound_us=dict(product=bounds[0], step=bounds[1]),
                   csr_us=csr, times=times)
        results["k0"].append(row)
        fmt = lambda v: "-" if v is None else f"{v:.2f}"
        parts = []
        for k, mode in enumerate(("product", "step")):
            parts.append(f"{mode} " + ", ".join(
                f"{n} {fmt(mean(n, 'warm', k))}/{fmt(mean(n, 'cold', k))}"
                for n in libs) + f" (bound {bounds[k]:.2f})")
        print(f"  K0 {label} {dname} nb={nb} P={P} n_off={len(offsets)}: "
              + "; ".join(parts) + f" us warm/cold; floor {fmt(floor)}; CSR "
              f"{fmt(csr)}; plan build={plan.build} path={plan.path} threads="
              f"{plan.threads} blocks={plan.blocks} batch={plan.batch}; "
              f"bitwise "
              f"{bitwise}", flush=True)
        if not bitwise:
            raise SystemExit(f"{label}: the tree's K0 differs from the "
                             f"parent's")
        use(tree)
        del kb, x, b, d, dinv, outs

    def band_case(label, e, smoother=None):
        """``k0_case`` on a real band ``e`` and on the smoother's copy of
        it (another dtype)."""
        offsets = [int(o) for o in e.offsets]
        nb, P = e.n_basis, e.n_block_rows
        k0_case(label, e.data, offsets, nb, P)
        if smoother is not None and smoother.data.dtype != e.data.dtype:
            k0_case(f"{label} smoothing copy", smoother.data, offsets, nb, P)

    if args.quick:
        def seeded(nb, P, offsets, dtype):
            data = torch.randn(len(offsets), nb, nb, P, generator=gen,
                               device=dev, dtype=torch.float64)
            p = torch.arange(P, device=dev)
            for k, o in enumerate(offsets):  # the band contract
                data[k, :, :, ((p + o) < 0) | ((p + o) >= P)] = 0.0
            return data.to(dtype)

        lex2 = lambda m: [-m, -1, 0, 1, m]
        lex3 = lambda m: [-m * m, -m, -1, 0, 1, m, m * m]
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        for label, nb, P, offs, dts in (
                ("coupled-like nb=6", 6, 1024, lex2(32), (f64,)),
                ("coupled-like nb=12", 12, 1024, lex2(32), (f64,)),
                ("coupled-like nb=3", 3, 1024, lex2(32), (f64,)),
                ("lex 4096", 4, 4096, lex3(16), (f32, bf16)),
                ("COO-like 25 offsets", 4, 4096,
                 sorted({a * 256 + b * 16 + c for a in (-1, 0, 1)
                         for b in (-1, 0, 1) for c in (-1, 0, 1)})[1:-1],
                 (f64,)),
                ("mono 64", 4, 64, lex3(4), (f32,)),
                ("mono2d p4 16384", 15, 16384, lex2(128), (f32,)),
                ("mono2d p5 4096", 21, 4096, lex2(64), (f32,)),
                ("Q1 4096", 8, 4096, lex3(16), (bf16,)),
                ("Q2 4096", 27, 4096, lex3(16), (bf16, f32)),
                ("P4 512", 35, 512, lex3(8), (bf16,))):
            for dt in dts:
                k0_case(label, seeded(nb, P, offs, dt), offs, nb, P)
    else:
        from polydeal_tpu_torch.config import MonodomainConfig
        from polydeal_tpu_torch.mesh import hyper_cube
        from polydeal_tpu_torch.models import darcy_stokes as ds
        from polydeal_tpu_torch.models import oseen as os_
        from polydeal_tpu_torch.models.flagship import setup_flagship
        from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                          bench_config)
        from polydeal_tpu_torch.models.poisson import solve_poisson

        if "coupled" in models:
            s, _ = ds.run(64, 2, device=dev)
            M = ds.mg_block_preconditioner(s, hyper_cube(2, 64), 64, 2,
                                           ps_mode="mass+stab",
                                           structure="tri")
            band_case("darcy u n=64 fine", M.mgs["u"].ells[-1])
            band_case("darcy pD n=64 fine", M.mgs["pD"].ells[-1])
            del s, M
            space, _, meta = os_.run(64, 2, device=dev)
            op, _ = meta["system"]
            M = os_.oseen_mg_preconditioner(space, op, meta,
                                            os_._rectangle(64), 64, 2)
            band_case("oseen n=64 fine", M.mgs[2].ells[-1])
            del space, meta, op, M
            torch.cuda.empty_cache()
        if "lex" in models:
            fs = setup_flagship(n=64, device=dev)
            band_case("lex flagship 4096-lane", fs.mg.ells[1],
                      fs.mg.lo_ells[1])
            del fs
        if "monodomain" in models:
            ms = MonodomainSolver.build(bench_config(6), relabel="lex",
                                        device=dev)
            for e in ms.mg.ells[1:4]:
                band_case(f"monodomain {e.n_block_rows}-lane", e)
            band_case("monodomain fine block-Jacobi operator", ms.A)
            del ms
            torch.cuda.empty_cache()
        if "coo" in models:
            r = solve_poisson(dim=3, n=64, degree=1, device=dev,
                              verbose=False)
            for e in r["mg"].ells:
                if e.data_i is None and e.n_block_rows == 4096:
                    band_case(f"COO 4096-lane {len(e.offsets)}-offset", e)
            del r
            torch.cuda.empty_cache()
        for label, degree, n_ref in (("mono2d p4", 4, 9),
                                     ("mono2d p5", 5, 8)):
            if "mono2d" not in models:
                break
            ms = MonodomainSolver.build(
                MonodomainConfig(dim=2, n_refinements=n_ref, degree=degree),
                relabel="lex", device=dev)
            for e in ms.mg.ells[1:]:
                if e.data_i is None:
                    band_case(f"{label} {e.n_block_rows}-lane", e)
            del ms
            torch.cuda.empty_cache()
        for label, family, degree, n in (("Q1", "dgq", 1, 64),
                                         ("Q2", "dgq", 2, 32),
                                         ("P4", "dgp", 4, 32)):
            if "dgq" not in models:
                break
            fs = setup_flagship(n=n, degree=degree, family=family,
                                device=dev)
            for e, lo in zip(fs.mg.ells[1:], fs.mg.lo_ells[1:]):
                if e.data_i is None:
                    band_case(f"{label} {e.n_block_rows}-lane", e, lo)
            del fs
            torch.cuda.empty_cache()

    # K5 at 2D p = 4-5, and K3-K5 at the p = 1-3 shapes
    for label, (dim, deg, P, vq, fq, bq, off) in ps.SIPG_SHAPES.items():
        if args.no_sipg:
            break
        pc = 10.0 * (deg + dim) * (deg + 1)
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            (vol, face, bdry), ext, lo = ps.sipg_tables(
                dev, dt, dim, P, (vq, fq, bq), gen)
            cases = {}
            if vol is not None:
                v = dict(pts=vol["pts_in"], w=vol["w"])
                cases["K3"] = lambda v=v: sk.volume_blocks(v, ext, deg, dim)
            if face is not None:
                cases["K4"] = lambda: ps.blocks(sk.face_group_blocks(
                    face, ext, lo, off, deg, dim, pc))
            cases["K5"] = lambda: sk.boundary_blocks(bdry, ext, deg, dim,
                                                     pc)
            for kname, kf in cases.items():
                outs, times = {}, {k: [] for k in libs}
                for name, lib in libs.items():
                    use(lib)
                    outs[name] = kf()
                    if name == "tree" and not torch.equal(kf(),
                                                          outs[name]):
                        raise SystemExit(f"{kname} {label} {dname}: two "
                                         f"launches differ")
                for name in order:
                    use(libs[name])
                    times[name].append(ps.cold_ms(kf))
                use(tree)
                bitwise = "parent" not in libs or torch.equal(
                    outs["tree"], outs["parent"])
                kind = {"K3": "volume", "K4": "face", "K5": "boundary"}[kname]
                C, q = {"K3": vq, "K4": fq, "K5": bq}[kname]
                nbytes, flops = ps.sipg_work(kind, dim, deg, C, q, P,
                                             dt.itemsize)
                b_ms, b_by = ps.bound(nbytes, flops, dname)
                pl = sk.sipg_launch_plan(P, C, q,
                                         sk.sipg_form(kind, dim, deg, dt))
                results["k5"].append(dict(
                    case=label, kernel=kname, dtype=dname, times=times,
                    bound_ms=b_ms, bound_by=b_by, bitwise=bitwise,
                    plan=dict(lanes=pl.lanes, ranks=pl.ranks, G=pl.G,
                              S=pl.S)))
                mean = {k: sum(v) / len(v) for k, v in times.items()}
                print(f"  {kname} {label} {dname}: " + "; ".join(
                    f"{k} {', '.join(f'{t:.4f}' for t in v)} ms "
                    f"({b_ms / mean[k]:.1%})" for k, v in times.items())
                    + f"; bound {b_ms:.4f} ms {b_by}; plan lanes "
                    f"{pl.lanes} ranks {pl.ranks} G {pl.G} S {pl.S}; "
                    f"bitwise {bitwise}", flush=True)
                if not bitwise:
                    raise SystemExit(f"{kname} {label} {dname}: the tree "
                                     f"differs from the parent")
                del outs
            del vol, face, bdry, ext, lo, cases
            torch.cuda.empty_cache()

    print(smi)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi,
           "build_s": built, **results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"device": out["device"], "smi": smi,
                      "build_s": built}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
