"""K1, K2 and their halo entries on their runtime-nb build
(``csrc/banded_any_nb.cu``) of this checkout against another checkout's,
in one process on one card, on the real bands of the paths that run them.

Builds this checkout's kernel library and, with ``--parent DIR``, the
library of the checkout at DIR (its ``polydeal_tpu_torch/csrc``; the C
interface is the same), then times each case through this checkout's
wrappers with either library loaded, in turns parent, tree, tree, parent:
device ms of one launch with L2 evicted before it
(``profile_sipg.cold_ms``, median of 15), beside its bound (the bytes it
must move over 3.35 TB/s: the band once, its vectors once) and, for the
products, a torch.sparse CSR ``torch.mv`` of the same band (K1's library
yardstick).  The bands:

* ``chip_smoke.py`` phase 16's fine bands (``setup_flagship(family=...)``,
  lex, f32): TensorDGQ Q1 at n=64 (nb 8, 262144 lanes), Q2 at n=32 (nb
  27, 32768 lanes), P_4 at n=32 (nb 35, 32768 lanes): K1 on the f32 band
  and its f64 cast, K2's step on the bf16 smoothing copy and the f64
  cast; K1 halo and K2 halo's step on slab 1 of the band cut four ways
  (x_ext with its ring neighbours' T lanes), f32 and f64;
* phase 17's fine bands (the 2D monodomain, lex, f32): p=4 at
  n_refinements=9 (nb 15, 262144 lanes) and p=5 at n_refinements=8 (nb
  21, 65536 lanes): K1 (f32, f64), K2's step on the f32 band (the
  monodomain smooths on it), a bf16 copy and the f64 cast.

Each kernel's output is held to its plain version (1e-5 / 1e-12 relative
to the largest entry) with either library, and the tree's two launches
bitwise.  Prints one line a case (with the tree's plan: W, S, rows R, row
chunks a block) and one JSON object last; ``--out`` writes the JSON too.

    python3 tools/profile_any_nb.py [--parent DIR] [--out FILE]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL = {"float32": 1e-5, "float64": 1e-12}
ENTRIES = ("pd_banded_matvec", "pd_banded_matvec_halo", "pd_banded_fused",
           "pd_banded_fused_halo")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose kernels to time "
                    "beside this one's")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_any_nb: needs a CUDA device")
    import chip_smoke as cs
    from profile_k1 import build_other
    from polydeal_tpu_torch.config import MonodomainConfig
    from polydeal_tpu_torch.models import profile_sipg as ps
    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.models.monodomain import MonodomainSolver
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.ops import banded as bd
    from polydeal_tpu_torch.ops import fused_cheb as fc
    from polydeal_tpu_torch.parallel.banded import _tile_for

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    other = {}
    th = None
    if args.parent:
        th = threading.Thread(target=build_other, args=(args.parent, other))
        th.start()
    t0 = time.perf_counter()
    tree = _build.load_library()
    build_s = time.perf_counter() - t0
    libs = {"tree": tree}
    if th is not None:
        th.join()
        if "error" in other:
            raise SystemExit(f"profile_any_nb: parent build failed: "
                             f"{other['error']}")
        for name in ENTRIES:
            fn = getattr(other["lib"], name)
            fn.argtypes = getattr(tree, name).argtypes
            fn.restype = ctypes.c_int
        libs["parent"] = other["lib"]
    print(f"built: tree {build_s:.2f} s, parent "
          f"{other.get('seconds', 0.0):.2f} s (in parallel)", flush=True)
    for line in ps.ptxas_summary(_build.last_build_log()):
        if "any_nb_kernel" in line:
            print(f"  ptxas (tree): {line}", flush=True)

    order = (["parent", "tree", "tree", "parent"] if "parent" in libs
             else ["tree", "tree"])
    results = []

    def case(label, kernel, kf, pf, nbytes, dname, csr=None, plan=None):
        """Hold ``kf`` to ``pf`` with each library (the tree's twice,
        bitwise), then time it in turns; ``csr`` a zero-argument CSR
        product to time beside it."""
        tol = TOL["float64" if dname == "float64" else "float32"]
        ref = pf()
        ref = ref if isinstance(ref, tuple) else (ref,)
        for name, lib in libs.items():
            _build._lib = lib
            got = kf()
            got = got if isinstance(got, tuple) else (got,)
            rel = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            if not rel <= tol:
                raise SystemExit(f"{label} {kernel}: the {name} kernel "
                                 f"disagrees with its plain version: "
                                 f"{rel:.3e}")
            if name == "tree":
                again = kf()
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, g) for a, g in zip(again, got)):
                    raise SystemExit(f"{label} {kernel}: two launches "
                                     f"differ")
        times = {k: [] for k in libs}
        for name in order:
            _build._lib = libs[name]
            times[name].append(ps.cold_ms(kf))
        _build._lib = tree
        b_ms = nbytes / ps.HBM_BPS * 1e3
        row = dict(case=label, kernel=kernel, dtype=dname, bound_ms=b_ms,
                   mb=nbytes / 1e6, **times)
        if plan is not None:
            row["plan"] = dict(W=plan.W, S=plan.S, R=plan.rows,
                               CB=plan.chunks)
        if csr is not None:
            row["csr_ms"] = cs.time_one(torch, csr)
        results.append(row)
        share = {k: b_ms / (sum(v) / len(v)) for k, v in times.items()}
        print(f"  {label} {kernel} {dname}: "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)} ms "
                          f"({share[k]:.1%})" for k, v in times.items())
              + f"; bound {b_ms:.4f} ms ({nbytes / 1e6:.1f} MB)"
              + ("" if plan is None else
                 f"; plan W={plan.W} S={plan.S} R={plan.rows} "
                 f"CB={plan.chunks}")
              + ("" if csr is None else f"; CSR {row['csr_ms']:.4f} ms"),
              flush=True)

    gen = torch.Generator(device=dev).manual_seed(11)

    def dname_of(t):
        return str(t.dtype).split(".")[-1]

    def k1(label, e, di):
        nb, P, offs = e.n_basis, e.n_block_rows, e.offsets_t
        n_off, R_pad = len(e.offsets), di.shape[0] // nb
        vdt = torch.float64 if di.dtype == torch.float64 else torch.float32
        kb = bd.imajor_band(di, offs, nb)
        x = cs.cheb_vectors(torch, gen, nb, P, vdt)[0]
        A = cs.csr_of_band(torch, di, e.offsets.tolist(), nb, R_pad, P)
        xf = x.T.contiguous().view(-1)
        case(label, "K1", lambda: bd.banded_matvec_t_imajor(
                 di, offs, nb, x, band=kb),
             lambda: bd.banded_matvec_t_imajor_ref(di, offs, nb, x),
             n_off * nb * nb * P * di.element_size()
             + 2 * nb * P * x.element_size(), dname_of(di),
             csr=lambda: torch.mv(A, xf), plan=bd.k1_plan(kb, x))

    def k2(label, e, di):
        nb, P, offs = e.n_basis, e.n_block_rows, e.offsets_t
        vdt = torch.float64 if di.dtype == torch.float64 else torch.float32
        x, b, d, dinv = cs.cheb_vectors(torch, gen, nb, P, vdt)
        kb = bd.imajor_band(di, offs, nb)
        case(label, "K2 step", lambda: fc.banded_cheb_step_t(
                 di, offs, nb, x, d, b, dinv, 0.37, 1.21, band=kb),
             lambda: fc.banded_cheb_step_t_ref(di, offs, nb, x, d, b, dinv,
                                               0.37, 1.21),
             len(e.offsets) * nb * nb * P * di.element_size()
             + 6 * nb * P * x.element_size(), dname_of(di))

    def halo(label, e, di):
        nb, P = e.n_basis, e.n_block_rows
        per = P // 4
        T = _tile_for(e, per)
        t = di.dtype
        x, b, d, dinv = cs.cheb_vectors(torch, gen, nb, P, t)
        slab = cs.Slab(torch, di[:, per:2 * per].contiguous(), e.offsets_t,
                       nb, T)
        x_ext = cs.ring_ext(torch, x, 1, per, T)
        b, d, dinv = (v[:, per:2 * per].contiguous() for v in (b, d, dinv))
        A = slab.csr(torch)
        xf = x_ext.T.contiguous().view(-1)
        calls = slab.calls(x_ext, b, d, dinv)
        lab = f"{label} slab 1 of 4 ({per} lanes, T={T})"
        case(lab, "K1 halo", *calls["product"],
             slab.work(x_ext.element_size(), False)[0], dname_of(di),
             csr=lambda: torch.mv(A, xf),
             plan=bd.k1_plan(slab.kb, x_ext, T))
        case(lab, "K2 halo step", *calls["step"],
             slab.work(x_ext.element_size(), True)[0], dname_of(di))

    for label, family, degree, n in (("Q1 n=64", "dgq", 1, 64),
                                     ("Q2 n=32", "dgq", 2, 32),
                                     ("P4 n=32", "dgp", 4, 32)):
        print(f"{label} fine band", flush=True)
        fs = setup_flagship(n=n, degree=degree, family=family, device=dev)
        e, lo = fs.mg.ells[-1], fs.mg.lo_ells[-1]
        del fs
        torch.cuda.empty_cache()
        k1(label, e, e.data_i)
        k1(label, e, e.data_i.double())
        k2(label, e, lo.data_i)
        k2(label, e, e.data_i.double())
        halo(label, e, e.data_i)
        halo(label, e, e.data_i.double())
        del e, lo
        torch.cuda.empty_cache()

    for label, degree, n_ref in (("mono2d p4 n_ref=9", 4, 9),
                                 ("mono2d p5 n_ref=8", 5, 8)):
        print(f"{label} fine band", flush=True)
        ms = MonodomainSolver.build(
            MonodomainConfig(dim=2, n_refinements=n_ref, degree=degree),
            relabel="lex", device=dev)
        e = ms.mg.ells[-1]
        del ms
        torch.cuda.empty_cache()
        k1(label, e, e.data_i)
        k1(label, e, e.data_i.double())
        k2(label, e, e.data_i)
        k2(label, e, e.data_i.to(torch.bfloat16))
        k2(label, e, e.data_i.double())
        del e
        torch.cuda.empty_cache()

    print(smi)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi,
           "build_s": build_s, "parent_build_s": other.get("seconds"),
           "cases": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
