"""K3-K5 (the SIPG assembly kernels) level by level on a CUDA card.

Run from the root of a checkout, on a machine with a CUDA card::

    python -m polydeal_tpu_torch.models.profile_sipg [--out FILE]
        [--shapes fine,p2,...]

Measures, in one process on ``cuda:0``:

* the lex flagship (n=64, p=1): its ``setup_phases``, the f32 solve's
  iterations and its drift from an f64 solve of the same system
  (max |x_f32 - x_f64| / max |x_f64|);
* the monodomain at ``bench_monodomain``'s configuration: its
  ``setup_phases``;
* K3, K4 and K5 on every level of both hierarchies (the flagship's
  512-262144 lanes, the monodomain's 8-262144), on the level's real f32
  tables: the device time per assembly by CUDA events (the median of 15
  calls, each after a 512 MB read that evicts the L2 cache and covers the
  host's launch work; K4 summed over the level's face groups), the bound of
  the same work (``sipg_work``: every input read once and every output written
  once over 3.35 TB/s, or the operations the symmetric form needs over the
  f32 peak), its share, the launches one assembly of the level makes, and
  the level's C and q;
* the same at the seeded ``SIPG_SHAPES["p2"]`` tables (p=2, nb=10), in
  f32 and f64.

With ``--shapes`` it measures only the named ``SIPG_SHAPES`` tables, in
f32.  It reaches the kernels only through their wrappers, so it measures
an older checkout's kernels too.  Prints the card, one line per level and
kind, the ptxas report of the SIPG kernels when this process built the
library, and last one JSON object with every number (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess

import torch

__all__ = ["sipg_work", "sipg_tables", "bound", "cold_ms", "level_tables",
           "level_rows", "shape_rows", "table_groups", "mono_handlers",
           "ptxas_summary", "main", "SIPG_SHAPES", "HBM_BPS", "PEAK_FLOPS"]

# NVIDIA's H100 SXM data sheet: HBM rate and peak rates outside the tensor
# cores, for the bound (least time) of a kernel's work
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# seeded SIPG tables at the shapes the flagship gives K3-K5 (p=1, 3D, with
# the lex relabel): (dim, degree, P, (C, q) of the volume, face and boundary
# groups, a face offset).  "fine" is the 64^3 level, "coarse" the 4096-lane
# level (C > 1), "p2" the 32768-lane level's shapes at p=2 (nb=10); "p2
# 8 lanes" and "p3 8 lanes" a coarse level's at p=2 and 3, where the plan
# splits a lane's points over point ranks of a block and entry ranks share
# staged point values.
SIPG_SHAPES = {
    "fine": (3, 1, 64**3, (1, 8), (1, 4), (3, 4), 64),
    "coarse": (3, 1, 4096, (64, 8), (16, 4), (48, 4), 16),
    "p2": (3, 2, 32768, (8, 27), (4, 9), (12, 9), 32),
    "p2 8 lanes": (3, 2, 8, (1024, 27), (1024, 9), (1024, 9), 1),
    "p3 8 lanes": (3, 3, 8, (1024, 64), (1024, 16), (1024, 16), 1),
}
KINDS = ("volume", "face", "boundary")


def bound(nbytes: float, flops: float, dtype: str):
    """(least ms, what bounds it): the bytes the work must move over the
    HBM rate, or its operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sipg_work(kind, dim, degree, C, q, P, esz):
    """(bytes, operations) of one K3/K4/K5 call: every input read once and
    every output written once; per quadrature point the operations the
    function needs: the basis and its real gradients (and phi, dn phi) per
    side, the vectors an entry is made of, and each of the E = M (M + 1) / 2
    distinct entries of the symmetric M x M form (M = nb, 2 nb for K4's four
    blocks): dim FMAs an entry for K3, two for K4 and K5 (an FMA counts
    two).  The same count reads every kernel of these forms."""
    nb = math.comb(degree + dim, dim)
    legendre = dim * (2 + 7 * (degree - 1) + 2 * (degree + 1))
    grad = legendre + nb * dim * dim  # real gradients
    side = grad + nb * (dim - 1) + nb * (2 * dim - 1)  # and phi, dn phi
    tri = nb * (nb + 1) // 2
    pts = C * q * dim * P
    if kind == "volume":  # w grad phi, then the entries
        nbytes = (pts + C * q * P + dim * P + nb * nb * P) * esz
        per_point = grad + nb * dim + tri * 2 * dim
    elif kind == "boundary":  # pts, n, w, h_f, ext; out
        nbytes = (2 * pts + C * q * P + C * P + dim * P + nb * nb * P) * esz
        # w gamma; beta, u, u + w gamma beta; the entries
        per_point = side + 2 + 4 * nb + tri * 4
    else:  # face: pts, n, w, h_f, ext, lo; four blocks out
        nbytes = (2 * pts + C * q * P + C * P + 2 * dim * P
                  + 4 * nb * nb * P) * esz
        # the side-1 pull-back, w gamma and -w / 2, both sides' vectors,
        # the 2 nb (2 nb + 1) / 2 entries
        per_point = (2 * side + 4 * dim + 3 + 8 * nb
                     + nb * (2 * nb + 1) * 4)
    return nbytes, per_point * C * q * P


def sipg_tables(dev, dtype, dim, P, groups, gen):
    """Seeded tables: unit points in [0, 1), normals, positive weights,
    face diameters and extents, box origins; one group per (C, q)."""
    def r(*shape):
        return torch.rand(*shape, generator=gen, device=dev,
                          dtype=torch.float64).to(dtype)

    out = [dict(pts_in=r(C, q, dim, P), n=r(C, q, dim, P) - 0.5,
                w=r(C, q, P), h_f=0.5 + r(C, P)) for C, q in groups]
    return out, 0.5 + r(dim, P), r(dim, P)


def cold_ms(fn, reps=15):
    """Median device ms of one call of ``fn`` with the L2 cache evicted
    before it, by CUDA events around the call: a sum over 512 MB (a read,
    so the cache holds no dirty lines to write back; ~0.16 ms, longer than
    the wrapper's host work) runs first, so the events hold the call's
    kernels and not the host's time to launch them.  One warm-up."""
    buf = torch.ones(512 << 18, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        buf.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in ev)[reps // 2]


def blocks(x):
    """A kernel's blocks as one tensor (K4's four stacked)."""
    return torch.stack(x) if isinstance(x, tuple) else x


def level_tables(h, dtype, dev):
    """(tables of ``build_banded_groups``, penalty constant) of one level,
    at the level's own band offsets."""
    from polydeal_tpu_torch.assembly.sipg import (build_banded_groups,
                                                  default_penalty_constant)

    ft = h.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype("int64")
    offs = sorted({0, *diffs.tolist(), *(-diffs).tolist()})
    t = build_banded_groups(h, offs, dtype, device=dev)
    return t, default_penalty_constant(h.degree, h.dim)


def kernel_calls(t, pc, deg, dim, plain=False):
    """{kind: [zero-argument calls]} of one level's assembly: K3, K4 per
    face group and K5 (their plain versions with ``plain``), each
    returning what the wrapper returns (``blocks`` makes it one
    tensor)."""
    from polydeal_tpu_torch.ops import sipg_kernels as sk

    sfx = "_ref" if plain else ""
    vol_fn = getattr(sk, "volume_blocks" + sfx)
    face_fn = getattr(sk, "face_group_blocks" + sfx)
    bdry_fn = getattr(sk, "boundary_blocks" + sfx)
    ext, lo = t["ext_t"], t["lo_t"]
    return {
        "volume": [lambda: vol_fn(t["vol"], ext, deg, dim)],
        "face": [lambda g=g, o=o: face_fn(g, ext, lo, o, deg, dim, pc)
                 for o, g in t["groups"].items()],
        "boundary": [lambda: bdry_fn(t["bdry"], ext, deg, dim, pc)],
    }


def table_groups(t):
    """{kind: the tables of its calls} of one level's tables."""
    return {"volume": [t["vol"]], "face": list(t["groups"].values()),
            "boundary": [t["bdry"]]}


def level_rows(t, pc, deg, dim, reps=10):
    """One row per kind of a level's tables: device ms per assembly
    (``cold_ms``; K4 summed over the face groups), its bound and share,
    the launches one assembly makes, and C and q (the largest over K4's
    groups)."""
    dname = str(t["ext_t"].dtype).split(".")[-1]
    calls, groups = kernel_calls(t, pc, deg, dim), table_groups(t)
    P = t["ext_t"].shape[1]
    rows = {}
    for kind in KINDS:
        ms = sum(cold_ms(fn, reps) for fn in calls[kind])
        nbytes = flops = 0.0
        for g in groups[kind]:
            C, q, _ = g["w"].shape
            b, f = sipg_work(kind, dim, deg, C, q, P, g["w"].element_size())
            nbytes, flops = nbytes + b, flops + f
        b_ms, b_by = bound(nbytes, flops, dname)
        Cq = max((g["w"].shape[:2] for g in groups[kind]),
                 key=lambda s: s[0] * s[1])
        rows[kind] = dict(P=P, C=int(Cq[0]), q=int(Cq[1]), ms=ms,
                          bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                          launches=len(calls[kind]), mbytes=nbytes / 1e6)
    return rows


def format_row(label, kind, r):
    return (f"  {label} P={r['P']} {kind}: C={r['C']} q={r['q']}, "
            f"{r['launches']} launch(es): {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}, {r['mbytes']:.2f} MB), "
            f"{r['share']:.1%} of it")


def mono_handlers(cfg, relabel="lex"):
    """The monodomain's hierarchy (``MonodomainSolver.build``'s first
    phase, rebuilt the same way): its level handlers, coarse to fine."""
    from polydeal_tpu_torch.agglomeration.rtree import RTreeAgglomerator
    from polydeal_tpu_torch.mesh.fine_mesh import hyper_cube
    from polydeal_tpu_torch.solvers import multigrid

    mesh = hyper_cube(cfg.dim, 2**cfg.n_refinements)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    levels = (list(range(cfg.multigrid.starting_level, agg.n_levels - 1))
              or [1])
    return multigrid.build_rtree_hierarchy(mesh, agg, levels,
                                           degree=cfg.degree,
                                           relabel=relabel)[0]


def ptxas_summary(build_log: str) -> list:
    """One line per compiled kernel: its name (kernel and form, type, dim,
    degree for the SIPG kernels), registers, and the stack and spill
    report."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            kern = args = None
            # the kernel's length-prefixed identifier; a namespace hash
            # may end in digits that run into its length
            for k in re.finditer(r"\d+", name):
                for i in range(len(k.group())):
                    ident = name[k.end():k.end() + int(k.group()[i:])]
                    if ident.endswith("_kernel"):
                        kern = ident
                        args = re.match(r"I(\w+?)EEv",
                                        name[k.end() + len(ident):])
                        break
                if kern:
                    break
            f = re.search(r"(Volume|Boundary|Face)FormI([fd])Li(\d)ELi(\d)E",
                          name)
            if kern and f:
                name = (f"{kern} {f.group(1)}<{f.group(2)}, {f.group(3)}, "
                        f"{f.group(4)}>")
            elif kern:
                name = f"{kern}<{args.group(1)}>" if args else kern
            continue
        if "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers; {spill}")
            name = None
    return out


def shape_rows(name, dtype, dev, gen):
    """``level_rows`` of the seeded tables at ``SIPG_SHAPES[name]``."""
    dim, deg, P, vq, fq, bq, off = SIPG_SHAPES[name]
    (vol, face, bdry), ext, lo = sipg_tables(dev, dtype, dim, P,
                                             (vq, fq, bq), gen)
    t = dict(vol=dict(pts=vol["pts_in"], w=vol["w"]), groups={off: face},
             bdry=bdry, ext_t=ext, lo_t=lo)
    return level_rows(t, 10.0 * (deg + dim) * (deg + 1), deg, dim)


def main(argv=None) -> int:
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)
    from polydeal_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated SIPG_SHAPES names: time only "
                    "their seeded f32 tables, not the hierarchies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sipg: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    _build.load_library()
    ptxas = [s for s in ptxas_summary(_build.last_build_log())
             if "Volume" in s or "Face" in s or "Boundary" in s]
    for s in ptxas:
        print(f"  ptxas: {s}")
    res = dict(card=smi, ptxas=ptxas, levels={})
    gen = torch.Generator(device=dev).manual_seed(1)

    if args.shapes:
        for name in args.shapes.split(","):
            res["levels"][f"{name} float32"] = shape_rows(
                name, torch.float32, dev, gen)
    else:
        fs = setup_flagship(n=64, device=dev)
        r32 = solve_flagship(fs)
        x32, it32 = r32.x.double(), r32.iterations
        res["flagship_setup_phases"] = dict(fs.setup_phases)
        for h in fs.handlers:
            t, pc = level_tables(h, torch.float32, dev)
            res["levels"][f"flagship {h.n_poly}"] = level_rows(
                t, pc, h.degree, h.dim)
            del t
        del fs, r32
        torch.cuda.empty_cache()
        ref = setup_flagship(n=64, device=dev, dtype=torch.float64,
                             precond_dtype=None)
        r64 = solve_flagship(ref)
        res["flagship_drift"] = float((x32 - r64.x).abs().max()) / float(
            r64.x.abs().max())
        res["flagship_iterations"] = dict(f32=it32, f64=r64.iterations)
        del ref, r64, x32
        torch.cuda.empty_cache()

        ms = MonodomainSolver.build(bench_config(6), relabel="lex",
                                    device=dev)
        res["monodomain_setup_phases"] = dict(ms.setup_phases)
        del ms
        torch.cuda.empty_cache()
        for h in mono_handlers(bench_config(6)):
            t, pc = level_tables(h, torch.float32, dev)
            res["levels"][f"monodomain {h.n_poly}"] = level_rows(
                t, pc, h.degree, h.dim)
            del t
        torch.cuda.empty_cache()
        for dt in (torch.float32, torch.float64):
            res["levels"][f"p2 {str(dt).split('.')[-1]}"] = shape_rows(
                "p2", dt, dev, gen)
            torch.cuda.empty_cache()

    for label, rows in res["levels"].items():
        for kind, r in rows.items():
            print(format_row(label, kind, r))
    if not args.shapes:
        print(f"  flagship setup phases (s): {res['flagship_setup_phases']}")
        print("  monodomain setup phases (s): "
              f"{res['monodomain_setup_phases']}")
        print(f"  flagship f32 drift from f64: {res['flagship_drift']:.4e}")
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
