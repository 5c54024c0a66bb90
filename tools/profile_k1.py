"""K1, K1 halo and K2 of this checkout against another checkout's kernels,
in one process on one card, on the main path's real bands.

Builds this checkout's kernel library and, with ``--parent DIR``, the
library of the checkout at DIR (its ``polydeal_tpu_torch/csrc``; the C
interface of the kernels timed here is the same), then times each case
through this checkout's wrappers with either library loaded, in turns
parent, tree, tree, parent: device ms of one launch with L2 evicted
before it (``profile_sipg.cold_ms``, median of 15), beside the launch's
bound (bytes over 3.35 TB/s) and, for the products, a torch.sparse CSR
``torch.mv`` of the same band (K1's library yardstick).  The cases:

* the COO Poisson's bands (``solve_poisson(dim=3, n=64, degree=1)``, its
  own f64 bands and their f32 casts): K1 on the 32768-lane 31-offset and
  262144-lane 37-offset levels, K2's step on the 32768-lane one;
* the lex flagship (``setup_flagship(n=64)``): K1 on the fine f32 band and
  the 32768-lane f32 band, K2's step on the fine bf16 smoother copy;
* the structured flagship (``bench_sharded``'s hierarchy): K1 halo on the
  fine slab at world size 1 (x_ext [nb, P + 2T]), and on slab 1 of the
  32768-lane level cut four ways (8192 lanes), f32 and f64.

Each kernel's output is held to its plain version (1e-5 / 1e-12 relative
to the largest entry) with either library.  Prints one line a case and
one JSON object last; ``--out`` writes the JSON to a file too.

    python3 tools/profile_k1.py [--parent DIR] [--out FILE]
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL = {"float32": 1e-5, "float64": 1e-12}
ENTRIES = ("pd_banded_matvec", "pd_banded_matvec_halo", "pd_banded_fused")


def build_other(parent: str, out: dict) -> None:
    """Build the kernel library of the checkout at ``parent`` into
    ``out["lib"]`` (``out["error"]`` on failure), bound like this one's
    for the entries timed here."""
    from polydeal_tpu_torch.ops import _build

    try:
        srcs = sorted(glob.glob(os.path.join(
            parent, "polydeal_tpu_torch", "csrc", "*.cu")))
        so = os.path.join(parent, "libpd_kernels_parent.so")
        t0 = time.perf_counter()
        out["log"] = _build._build(srcs, so)
        out["seconds"] = time.perf_counter() - t0
        out["lib"] = ctypes.CDLL(so)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        out["error"] = repr(e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose kernels to time "
                    "beside this one's")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k1: needs a CUDA device")
    import chip_smoke as cs
    from polydeal_tpu_torch.models import profile_sipg as ps
    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.models.poisson import solve_poisson
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
            raise SystemExit(f"profile_k1: parent build failed: "
                             f"{other['error']}")
        for name in ENTRIES:
            fn = getattr(other["lib"], name)
            fn.argtypes = getattr(tree, name).argtypes
            fn.restype = ctypes.c_int
        libs["parent"] = other["lib"]
    print(f"built: tree {build_s:.2f} s, parent "
          f"{other.get('seconds', 0.0):.2f} s (in parallel)", flush=True)
    for line in ps.ptxas_summary(_build.last_build_log()):
        if "banded_matvec_imajor_kernel" in line:
            print(f"  ptxas (tree): {line}", flush=True)

    order = (["parent", "tree", "tree", "parent"] if "parent" in libs
             else ["tree", "tree"])
    results = []

    def case(label, kernel, kf, pf, nbytes, dname, csr=None, plan=None):
        """Hold ``kf`` to ``pf`` with each library, then time it in turns;
        ``csr`` a zero-argument CSR product to time beside it."""
        tol = TOL["float64" if dname == "float64" else "float32"]
        ref = pf()
        for name, lib in libs.items():
            _build._lib = lib
            got = kf()
            got = got if isinstance(got, tuple) else (got,)
            want = ref if isinstance(ref, tuple) else (ref,)
            rel = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, want))
            if not rel <= tol:
                raise SystemExit(f"{label}: the {name} kernel disagrees "
                                 f"with its plain version: {rel:.3e}")
        times = {k: [] for k in libs}
        for name in order:
            _build._lib = libs[name]
            times[name].append(ps.cold_ms(kf))
        _build._lib = tree
        b_ms = nbytes / ps.HBM_BPS * 1e3
        row = dict(case=label, kernel=kernel, dtype=dname,
                   bound_ms=b_ms, mb=nbytes / 1e6, **times)
        if plan is not None:
            row["plan"] = dict(W=plan.W, S=plan.S)
        if csr is not None:
            row["csr_ms"] = cs.time_one(torch, csr)
        results.append(row)
        share = {k: b_ms / (sum(v) / len(v)) for k, v in times.items()}
        print(f"  {label} {kernel} {dname}: "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)} ms "
                          f"({share[k]:.1%})" for k, v in times.items())
              + f"; bound {b_ms:.4f} ms ({nbytes / 1e6:.1f} MB)"
              + ("" if plan is None else f"; plan W={plan.W}, S={plan.S}")
              + ("" if csr is None else f"; CSR {row['csr_ms']:.4f} ms"),
              flush=True)

    gen = torch.Generator(device=dev).manual_seed(11)

    def k1_cases(label, e, types):
        nb, P = e.n_basis, e.n_block_rows
        n_off, R_pad = len(e.offsets), e.data_i.shape[0] // e.n_basis
        for di in types:
            dname = str(di.dtype).split(".")[-1]
            vdt = torch.float64 if dname == "float64" else torch.float32
            offs = e.offsets_t
            kb = bd.imajor_band(di, offs, nb)
            x = cs.cheb_vectors(torch, gen, nb, P, vdt)[0]
            A = cs.csr_of_band(torch, di, e.offsets.tolist(), nb, R_pad, P)
            xf = x.T.contiguous().view(-1)
            ent = n_off * nb * nb * P
            case(label, "K1", lambda: bd.banded_matvec_t_imajor(
                     di, offs, nb, x, band=kb),
                 lambda: bd.banded_matvec_t_imajor_ref(di, offs, nb, x),
                 ent * di.element_size() + 2 * nb * P * x.element_size(),
                 dname, csr=lambda: torch.mv(A, xf),
                 plan=bd.k1_plan(kb, x))
            del A, xf, x, kb

    def k2_case(label, e, di):
        nb, P, offs = e.n_basis, e.n_block_rows, e.offsets_t
        dname = str(di.dtype).split(".")[-1]
        vdt = torch.float64 if dname == "float64" else torch.float32
        x, b, d, dinv = cs.cheb_vectors(torch, gen, nb, P, vdt)
        kb = bd.imajor_band(di, offs, nb)
        ent = len(e.offsets) * nb * nb * P
        case(label, "K2 step", lambda: fc.banded_cheb_step_t(
                 di, offs, nb, x, d, b, dinv, 0.37, 1.21, band=kb),
             lambda: fc.banded_cheb_step_t_ref(di, offs, nb, x, d, b, dinv,
                                               0.37, 1.21),
             ent * di.element_size() + 6 * nb * P * x.element_size(), dname)

    def halo_case(label, e, per, r, types):
        nb, P = e.n_basis, e.n_block_rows
        T = _tile_for(e, per)
        for data in types:
            dname = str(data.dtype).split(".")[-1]
            vdt = torch.float64 if dname == "float64" else torch.float32
            x = cs.cheb_vectors(torch, gen, nb, P, vdt)[0]
            slab = cs.Slab(torch, data[:, r * per:(r + 1) * per].contiguous(),
                           e.offsets_t, nb, T)
            x_ext = cs.ring_ext(torch, x, r, per, T)
            A = slab.csr(torch)
            xf = x_ext.T.contiguous().view(-1)
            case(f"{label} ({per} lanes, T={T})", "K1 halo",
                 lambda: bd.banded_matvec_t_halo(
                     slab.data_i, slab.offs, nb, x_ext, tile=T,
                     band=slab.kb),
                 lambda: bd.banded_matvec_t_halo_ref(
                     slab.data_i, slab.offs, nb, x_ext, tile=T),
                 slab.work(x_ext.element_size(), False)[0], dname,
                 csr=lambda: torch.mv(A, xf),
                 plan=bd.k1_plan(slab.kb, x_ext, T))
            del A, xf, slab, x_ext, x

    print("COO Poisson n=64 (f64 bands and their f32 casts)", flush=True)
    r = solve_poisson(dim=3, n=64, degree=1, device=dev, verbose=False)
    for e in r["mg"].ells:
        if e.data_i is not None:
            lab = f"COO {e.n_block_rows}-lane {len(e.offsets)}-offset"
            k1_cases(lab, e, cs.band_types(torch, e.data_i))
            if e.n_block_rows == 32768:
                k2_case(lab, e, e.data_i)
    del r
    torch.cuda.empty_cache()

    print("lex flagship n=64", flush=True)
    fs = setup_flagship(n=64, device=dev)
    for e in fs.mg.ells[2:]:
        k1_cases(f"lex {e.n_block_rows}-lane", e, (e.data_i,))
    k2_case("lex 262144-lane bf16 copy", fs.mg.lo_ells[-1],
            fs.mg.lo_ells[-1].data_i)
    del fs
    torch.cuda.empty_cache()

    print("structured flagship n=64 (bench_sharded's hierarchy)", flush=True)
    fst = setup_flagship(n=64, hierarchy="structured", device=dev)
    fine, mid = fst.mg.ells[-1], fst.mg.ells[2]
    halo_case("structured fine slab", fine, fine.n_block_rows, 0,
              (fine.data_i,))
    halo_case("structured 32768-lane slab 1 of 4", mid,
              mid.n_block_rows // 4, 1, (mid.data_i, mid.data_i.double()))
    del fst
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
