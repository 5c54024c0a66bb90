"""The captured solves of this checkout against another checkout's, in one
process on one card: the device loops (``solvers/graphs``: one program
and one host read a solve) against the parent's loops.

With ``--parent DIR`` (a checkout, e.g. ``git archive`` of the parent
commit unpacked into the gitignored ``_parent/``), both packages are
imported into this process under their one name, each with its own
modules (``sys.modules`` holds one of them at a time: :func:`use`).  Where
the parent's ``csrc/`` is this checkout's but for files it lacks, the
parent runs on this checkout's kernel library (the same kernels); else it
builds its own.  Every arm is set up by each package from the same seeds
(so the systems are the same bits), solved captured (the default on the
card) once cold, then in turns parent, tree, tree, parent until each has
``--reps`` warm calls (at least 11).  Per arm and package:

* the iterations (GMRES: steps; the monodomain: per step) and whether x
  is bitwise the parent's, else its largest difference relative to the
  parent's largest entry (the run exits 1 where the iterations differ,
  or x does but on the arms whose coarsest level this checkout solves
  by two triangular solves where the parent called ``lu_solve``:
  ``LU_ARMS``, held to 1e-6 there);
* warm host-clock medians and range (synchronised);
* host reads a solve (``loop.last``) and bodies run;
* the host thread's CPU seconds (``time.thread_time``) from the call to
  the moment its last work is queued (the last launch or replay) and to
  its return, after the final read (medians);
* one traced solve (``torch.profiler``, ``profile_flagship._traced``):
  span, device busy time, idle share, device operations and how many
  are records of the port's kernels (any device record where the arm
  runs none; an arm whose trace holds none is marked ``records: 0``), of
  the parent's solve only: the tree's is one device program, and the
  profiler drops the records of kernels inside its WHILE bodies
  (``tools/while_probe.py --fault``; ``traced: null``).

The arms: the lex and ``relabel=None`` flagships at n=64 (1,048,576 DoF,
f32, bf16 smoothing copies), the monodomain's 20 BDF2 steps at 1,048,576
DoF (``steps_scan``), darcy_stokes and oseen MG-GMRES at n=64, SA-AMG CG
at n=64, the matrix-free and bf16-vector flagship compositions at n=64,
the block-ELL hierarchy (2D n=32, permuted), the TensorDGQ Q1 flagship at
n=64, the 2D monodomain at p = 4 (n_refinements=9, 3,932,160 DoF) and p =
5 (n_refinements=8), 20 steps each, and both sharded systems at world
size 1 on a one-rank NCCL group (the structured flagship's
``ShardedBandedSystem``, the COO Poisson n=64 ``ShardedSystem``).

With ``--coarse``, this checkout only, no timing: on each arm of
``LU_ARMS``, every coarse LU factored by its setup and one solve, the
solve by ``solvers/lu`` (the pivot permutation and two triangular
solves) against ``torch.linalg.lu_solve`` (cuSOLVER getrs, the parent's
call) on the same factors, for three seeded right-hand sides: the
largest difference relative to the largest entry, in the factors' dtype
and with the factors cast to f64, beside the order and the dtype's
epsilon.

    python3 tools/profile_loops.py [--parent DIR] [--arms a,b,...]
        [--reps N] [--coarse] [--out FILE]
"""

import argparse
import contextlib
import filecmp
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "polydeal_tpu_torch"
# every module an arm reaches, imported up front (function-level imports
# run under use() as well)
MODULES = ["ops._build", "mesh", "agglomeration", "assembly.sipg",
           "sparse", "config", "models.flagship", "models.monodomain",
           "models.darcy_stokes", "models.oseen", "models.poisson",
           "models.profile_flagship", "solvers.multigrid", "solvers.graphs",
           "solvers.gmres", "solvers.amg", "parallel.banded",
           "parallel.sharding"]
MONO_STEPS = 20


def _ours(name: str) -> bool:
    return name == PKG or name.startswith(PKG + ".")


def load(root: str) -> dict:
    """The package at ``root``, imported afresh: {module name: module};
    ``sys.modules`` is left as it was."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if _ours(k)}
    sys.path.insert(0, root)
    importlib.invalidate_caches()
    try:
        for m in MODULES:
            importlib.import_module(f"{PKG}.{m}")
        return {k: sys.modules.pop(k) for k in list(sys.modules)
                if _ours(k)}
    finally:
        sys.path.remove(root)
        sys.modules.update(saved)


@contextlib.contextmanager
def use(mods: dict):
    """``mods`` as the package in ``sys.modules`` (for the imports made
    inside functions), as a namespace of its modules."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if _ours(k)}
    sys.modules.update(mods)
    try:
        yield SimpleNamespace(**{m.replace(".", "_"): mods[f"{PKG}.{m}"]
                                 for m in MODULES})
    finally:
        # keep what the calls imported with this package
        mods.update({k: sys.modules.pop(k) for k in list(sys.modules)
                     if _ours(k)})
        sys.modules.update(saved)


QUEUED = [0.0]  # host thread time after the last launch or replay


def stamp(cls, name: str) -> None:
    """Record ``time.thread_time()`` after each call of ``cls.name``."""
    fn = getattr(cls, name)

    def wrapped(self, *a, **kw):
        out = fn(self, *a, **kw)
        QUEUED[0] = time.thread_time()
        return out

    setattr(cls, name, wrapped)


# ---- the arms: each returns (solve, loop, device) under use(P) --------
# solve() runs the captured solve and returns (x, iterations); loop() is
# its solvers/graphs loop


def _flagship(P, dev, **kw):
    maxiter = kw.pop("maxiter", 100)
    fs = P.models_flagship.setup_flagship(n=64, device=dev, **kw)
    solve = lambda: (lambda r: (r.x, r.iterations))(
        P.models_flagship.solve_flagship(fs, maxiter=maxiter))
    return solve, lambda: fs.mg.cg_loop(1e-8, maxiter, fs.b.dtype)


def arm_lex(P, dev, torch):
    return _flagship(P, dev)


def arm_relabel_none(P, dev, torch):
    return _flagship(P, dev, relabel=None)


def arm_bf16_vectors(P, dev, torch):
    return _flagship(P, dev, vector_dtype=torch.bfloat16, maxiter=200)


def arm_dgq_q1(P, dev, torch):
    return _flagship(P, dev, family="dgq")


def arm_matfree(P, dev, torch):
    fl = P.models_flagship
    fs = fl.setup_flagship(n=64, device=dev)
    mg = P.solvers_multigrid.build_multigrid(
        fs.handlers, fs.parents, None, chebyshev_degree=fl.CHEBYSHEV_DEGREE,
        n_smooth=fl.N_SMOOTH, smoothing_range=fl.SMOOTHING_RANGE,
        grid_shapes=fs.grid_shapes, precond_dtype=torch.bfloat16,
        dtype=torch.float32, coarse_solver="inv", level_assembly="banded",
        matfree_fine=True, device=dev)
    b = fs.b
    del fs
    solve = lambda: (lambda r: (r.x, r.iterations))(
        mg.solve_cg(b, rtol=1e-8, fmg=True))
    return solve, lambda: mg.cg_loop(1e-8, 200, b.dtype)


def arm_block_ell(P, dev, torch, n=32):
    import numpy as np

    tpd, tmg, tsipg = sys.modules[PKG], P.solvers_multigrid, P.assembly_sipg
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator

    m = tpd.hyper_cube(2, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    hs, ps = tmg.build_rtree_hierarchy(m, agg, list(range(2, agg.n_levels
                                                          - 1)), degree=1)
    perm = np.random.default_rng(3).permutation(hs[-1].n_poly)
    hs = hs[:-1] + [tpd.AgglomerationHandler(m, perm[hs[-1].cell2poly],
                                             degree=1)]
    ps = ps[:-1] + [np.asarray(ps[-1])[np.argsort(perm)]]
    u = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    A = tsipg.assemble_sipg_matrix(hs[-1], device=dev)
    b = tsipg.assemble_rhs(hs[-1], lambda x: 2 * math.pi**2 * u(x), u,
                           device=dev)
    mg = tmg.build_multigrid(hs, ps, A, device=dev)
    solve = lambda: (lambda r: (r.x, r.iterations))(
        mg.solve_cg(b, rtol=1e-9))
    return solve, lambda: mg.cg_loop(1e-9, 200, b.dtype)


def _mono(P, dev, torch, cfg):
    ms = P.models_monodomain.MonodomainSolver.build(cfg, relabel="lex",
                                                    device=dev)
    u, w = ms.initial_state()
    u1, w1, _ = ms.step(u, u, w, 0.0, True)

    def solve():
        uf, _, _, its = ms.steps_scan(u1, u, w1, cfg.dt, MONO_STEPS)
        return uf, its

    return solve, lambda: ms.mg.cg_loop(cfg.solver.rtol,
                                        cfg.solver.max_iterations,
                                        torch.float32)


def arm_monodomain(P, dev, torch):
    return _mono(P, dev, torch, P.models_monodomain.bench_config(6))


def arm_mono2d_p4(P, dev, torch):
    return _mono(P, dev, torch, P.config.MonodomainConfig(
        dim=2, n_refinements=9, degree=4))


def arm_mono2d_p5(P, dev, torch):
    return _mono(P, dev, torch, P.config.MonodomainConfig(
        dim=2, n_refinements=8, degree=5))


def _gmres(P, A, M, rhs):
    loop = P.solvers_graphs.GMRESLoop(A, M, rhs, restart=200, rtol=1e-11,
                                      max_restarts=40)
    solve = lambda: (lambda r: (r.x, r.iterations))(loop.solve(rhs))
    return solve, lambda: loop


def arm_darcy(P, dev, torch, n=64):
    ds = P.models_darcy_stokes
    s, _ = ds.run(n, 2, device=dev)
    M = ds.mg_block_preconditioner(s, P.mesh.hyper_cube(2, n), n, 2,
                                   ps_mode="mass+stab", structure="tri")
    return _gmres(P, ds._regularized(s), M, s.rhs)


def arm_oseen(P, dev, torch, n=64):
    os_ = P.models_oseen
    space, _, meta = os_.run(n, 2, device=dev)
    op, rhs = meta["system"]
    M = os_.oseen_mg_preconditioner(space, op, meta, os_._rectangle(n), n,
                                    2)
    return _gmres(P, os_._regularized(space, op, meta), M, rhs)


def arm_amg(P, dev, torch, n=64):
    rp = P.models_poisson.solve_poisson(dim=3, n=n, degree=1, solver="amg",
                                        device=dev, verbose=False)
    amg, b = rp["amg"], rp["b"]
    del rp
    solve = lambda: (lambda r: (r.x, r.iterations))(
        amg.solve_cg(b, rtol=1e-9))
    return solve, lambda: amg._loops[(1e-9, 300, b.dtype)][0]


def arm_sharded_banded(P, dev, torch, group):
    fs = P.models_flagship.setup_flagship(n=64, device=dev,
                                          hierarchy="structured")
    ss = P.parallel_banded.ShardedBandedSystem.from_multigrid(fs.mg, group)
    b = fs.b
    del fs

    def solve():
        x, k, _ = ss.solve_cg_async(b, rtol=1e-8, maxiter=100)
        return x, int(k)

    return solve, lambda: ss._compiled(1e-8, 100, True, b.dtype)[0]


def arm_sharded_flat(P, dev, torch, group):
    ra = P.models_poisson.solve_poisson(dim=3, n=64, degree=1, device=dev,
                                        verbose=False)
    ss = P.parallel_sharding.ShardedSystem.from_multigrid(ra["mg"], group)
    b = ra["b"]
    del ra

    def solve():
        x, k, _ = ss.solve_cg_local(b, rtol=1e-9, maxiter=100)
        return x, k

    return solve, lambda: ss._compiled(1e-9, 100, True, b.dtype)[0]


ARMS = {"lex": arm_lex, "relabel_none": arm_relabel_none,
        "monodomain": arm_monodomain, "darcy": arm_darcy,
        "oseen": arm_oseen, "amg": arm_amg, "matfree": arm_matfree,
        "bf16_vectors": arm_bf16_vectors, "block_ell": arm_block_ell,
        "dgq_q1": arm_dgq_q1, "mono2d_p4": arm_mono2d_p4,
        "mono2d_p5": arm_mono2d_p5, "sharded_banded": arm_sharded_banded,
        "sharded_flat": arm_sharded_flat}
SHARDED = ("sharded_banded", "sharded_flat")
# the arms whose hierarchies solve the coarsest level by LU (the
# monodomain's, the coupled models' field blocks, the block-ELL one):
# rounding there differs from the parent's lu_solve
LU_ARMS = ("monodomain", "mono2d_p4", "mono2d_p5", "darcy", "oseen",
           "block_ell")


def timed(torch, solve):
    """(x, iterations, host s, thread CPU s to the last queued work, to
    the return) of one synchronised call."""
    torch.cuda.synchronize()
    QUEUED[0] = c0 = time.thread_time()
    t0 = time.perf_counter()
    x, its = solve()
    c1 = time.thread_time()
    torch.cuda.synchronize()
    return x, its, time.perf_counter() - t0, QUEUED[0] - c0, c1 - c0


def records_of(ops, name):
    """The trace's records of the port's kernels (any device record for
    the arms that run none of them)."""
    none = name in ("amg", "sharded_flat")
    return sum(o["count"] for o in ops
               if none or any(k in o["name"] for k in (
                   "banded", "packed", "omajor", "any_nb", "set_condition")))


def run_arm(torch, name, pkgs, dev, group, reps):
    """The arm measured for every package in ``pkgs`` ({label: mods})."""
    _traced = pkgs["tree"][f"{PKG}.models.profile_flagship"]._traced

    arms, out = {}, {}
    for who, mods in pkgs.items():
        with use(mods) as P:
            extra = (group,) if name in SHARDED else ()
            t0 = time.perf_counter()
            solve, loop = ARMS[name](P, dev, torch, *extra)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            x, its, cold_s, _, _ = timed(torch, solve)  # the capture
            arms[who] = (solve, loop)
            out[who] = dict(setup_s=setup_s, cold_s=cold_s, iterations=its,
                            walls=[], queued_cpu=[], read_cpu=[])
            out[who]["x"] = x
    order = list(pkgs)
    turns = order + order[::-1]
    while min(len(o["walls"]) for o in out.values()) < reps:
        for who in turns:
            with use(pkgs[who]):
                x, its, wall, qc, rc = timed(torch, arms[who][0])
            o = out[who]
            o["walls"].append(wall)
            o["queued_cpu"].append(qc)
            o["read_cpu"].append(rc)
            if its != o["iterations"] or not torch.equal(x, o["x"]):
                o["unsteady"] = True
    for who in order:
        with use(pkgs[who]):
            loop = arms[who][1]()
            last = dict(loop.last)
            tr = None
            # a device program (the tree's loops) is not traced: the
            # profiler drops the records of kernels inside WHILE bodies
            if not hasattr(pkgs[who][f"{PKG}.solvers.graphs"],
                           "LoopProgram"):
                span, busy, n_ops, ops = _traced(arms[who][0], top=None)
                tr = dict(span_ms=span, busy_ms=busy,
                          idle_share=1 - busy / span, device_ops=n_ops,
                          records=records_of(ops, name))
        o = out[who]
        o.update(last=last, traced=tr)
    row = {}
    for who in order:
        o = out[who]
        w = o.pop("walls")
        row[who] = dict(
            iterations=o["iterations"], setup_s=o["setup_s"],
            cold_s=o["cold_s"],
            warm_s=dict(median=statistics.median(w), min=min(w), max=max(w),
                        n=len(w)),
            queued_cpu_s=statistics.median(o.pop("queued_cpu")),
            read_cpu_s=statistics.median(o.pop("read_cpu")),
            host_reads=o["last"].get("host_reads"),
            bodies=o["last"].get("replays"), last=o["last"],
            traced=o["traced"], unsteady=o.get("unsteady", False))
    if "parent" in out:
        row["same_iterations"] = (out["parent"]["iterations"]
                                  == out["tree"]["iterations"])
        xp, xt = out["parent"]["x"], out["tree"]["x"]
        row["x_bitwise"] = bool(torch.equal(xp, xt))
        row["x_rel_diff"] = float((xt.double() - xp.double()).abs().max()
                                  / xp.double().abs().max())
        row["warm_ratio"] = (row["tree"]["warm_s"]["median"]
                             / row["parent"]["warm_s"]["median"])
    del arms, out
    gc.collect()
    torch.cuda.empty_cache()
    return row


def coarse_arm(torch, name, mods, dev, group):
    """``--coarse`` on one arm: {factors' shape and dtype: the order n,
    eps, and the differences on three seeded right-hand sides, on the
    factors and on the factors cast to f64}, for every coarse LU that
    the arm's setup and one solve factor."""
    lu_mod = mods[f"{PKG}.solvers.lu"]
    seen = {}

    def pivots(lu):
        seen[lu[0].data_ptr()] = lu
        return lu_mod.pivot_permutation(lu)

    with use(mods) as P:
        for m in (P.solvers_multigrid, P.parallel_sharding):
            m.pivot_permutation = pivots
        try:
            extra = (group,) if name in SHARDED else ()
            run, _ = ARMS[name](P, dev, torch, *extra)
            run()
            torch.cuda.synchronize()
        finally:
            for m in (P.solvers_multigrid, P.parallel_sharding):
                m.pivot_permutation = lu_mod.pivot_permutation
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for LU, piv in seen.values():
        row = dict(n=LU.shape[0], eps=torch.finfo(LU.dtype).eps)
        for label, dt in (("rel_diff", LU.dtype),
                          ("rel_diff_f64", torch.float64)):
            L, diffs = LU.to(dt), []
            perm = lu_mod.pivot_permutation((L, piv))
            for _ in range(3):
                b = torch.randn(LU.shape[0], generator=gen, device=dev,
                                dtype=dt)
                x = lu_mod.lu_solve(L, perm, b)
                ref = torch.linalg.lu_solve(L, piv, b[:, None])[:, 0]
                diffs.append(float((x - ref).abs().max()
                                   / ref.abs().max()))
            row[label] = diffs
        out[f"{tuple(LU.shape)} {str(LU.dtype).split('.')[-1]}"] = row
    gc.collect()
    torch.cuda.empty_cache()
    return out


def same_csrc(parent: str) -> bool:
    """Whether every source of the parent's ``csrc/`` is this checkout's."""
    mine = os.path.join(ROOT, PKG, "csrc")
    theirs = os.path.join(parent, PKG, "csrc")
    return all(filecmp.cmp(os.path.join(theirs, f), os.path.join(mine, f),
                           shallow=False)
               for f in os.listdir(theirs)
               if os.path.isfile(os.path.join(theirs, f)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--coarse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_loops: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.coarse:
        MODULES.append("solvers.lu")
    pkgs = {"tree": load(ROOT)}
    if args.parent and not args.coarse:
        pkgs = {"parent": load(os.path.abspath(args.parent)), **pkgs}
    t0 = time.perf_counter()
    tree_build = pkgs["tree"][f"{PKG}.ops._build"]
    lib = tree_build.load_library()
    build_s = time.perf_counter() - t0
    shared = None
    if args.parent:
        shared = same_csrc(os.path.abspath(args.parent))
        pb = pkgs["parent"][f"{PKG}.ops._build"]
        if shared:
            pb._lib = lib  # the same kernels: this checkout's library
        else:
            pb.load_library()
    for who, mods in pkgs.items():
        g = mods[f"{PKG}.solvers.graphs"]
        stamp(g.Program, "replay")
        if hasattr(g, "LoopProgram"):
            stamp(g.LoopProgram, "launch")
    arms = args.arms.split(",")
    if args.coarse and args.arms == ",".join(ARMS):
        arms = list(LU_ARMS)
    group = store = None
    if any(a in SHARDED for a in arms):
        with use(pkgs["tree"]) as P:
            store = tempfile.mkdtemp(prefix="profile_loops_")
            group = P.parallel_sharding.init_group(
                0, 1, device=dev, store_path=os.path.join(store, "store"))
    res = dict(card=smi, torch=torch.__version__, build_s=build_s,
               parent=args.parent, parent_on_tree_library=shared, arms={})
    bad = []
    for name in arms:
        if args.coarse:
            res["arms"][name] = row = coarse_arm(torch, name, pkgs["tree"],
                                                 dev, group)
            print(name, json.dumps(row), flush=True)
            continue
        row = run_arm(torch, name, pkgs, dev, group, args.reps)
        res["arms"][name] = row
        print(name, json.dumps(row), flush=True)
        if args.parent and not (row["same_iterations"] and (
                row["x_bitwise"] or (name in LU_ARMS
                                     and row["x_rel_diff"] <= 1e-6))):
            bad.append(name)
    if group is not None:
        with use(pkgs["tree"]) as P:
            P.parallel_sharding.leave_group()
    res["mismatch"] = bad
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
