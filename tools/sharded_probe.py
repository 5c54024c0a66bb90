"""Both sharded systems' CG across GPUs, one process a card, each solve
one device program (the peer kernels of ``parallel/peer.py`` in the WHILE
body, NCCL only at setup), held to its eager solve; run on two checkouts,
it compares a tree with its parent.

Run from the root of a checkout on a host with ``--nproc`` CUDA cards::

    python3 tools/sharded_probe.py --nproc 4 [--n 64] [--arms structured,flat]
        [--trace] [--timeout 600]
    python3 tools/sharded_probe.py --root DIR --nproc 4 --n 64 \\
        --arms structured,lex,none,local,flat --out FILE.json --x FILE.npz \\
        [--hi-from FILE.json]
    python3 tools/sharded_probe.py --compare PARENT.npz TREE.npz

(``--device cpu`` runs the same flow on gloo CPU processes, where nothing
is captured: a rehearsal.)  ``--root DIR`` imports ``polydeal_tpu_torch``
from ``DIR`` (by default this checkout; a parent unpacked with ``git
archive`` into a gitignored directory is the other side of a comparison).

Every rank (rank r on ``cuda:r``, one group through a FileStore) runs the
``--arms`` in turn: ``structured`` (``models/sharded.setup_sharded``, f32
with bf16 smoothing copies, rtol 1e-8), ``lex`` (the R-tree flagship,
lex), ``none`` (``relabel=None``: packed levels, far tails at 4 ranks),
``local`` or ``localN`` (``setup_local``: shard-local setup, at side N)
and ``flat`` (the flat block-COO ``ShardedSystem`` on the 2D R-tree
problem of side n, f64, rtol 1e-9).  With ``--hi-from`` a banded arm
takes each sharded level's Chebyshev bounds (``lo``, ``hi``) from rank 0's
record of that arm in an earlier ``--out`` instead of its own.  For each
arm: setup seconds; ``graph_ok`` (on a card a refused system is a
failure); ``models/sharded.eager_and_graph`` (eager and default solves,
least of 3 warm each, host clock; per rank the iterations, host reads,
bodies run, exchanges a solve and the device peak); two more solves (x
bitwise, the dot x . x's bits); each sharded level's ``lo`` and ``hi`` and
the replicated bottom's ``his`` (bits: ``setup_local`` estimates a
sharded level's by a sharded power iteration, whose dots are the
system's); the host's peak RSS; the body program's node types
(``tools/while_probe.node_types``); where the system has a peer group,
each of its exchanges on the arm's real shapes (every sharded level's
ring and far tail, or the flat level's halo rows and restriction, the
gathers, a dot) held bitwise to its plain version over NCCL, and after
``close()`` a solve raising; with ``--trace``, rank 0's traced eager
solve (span, device busy time, idle share, the 8 device operations with
the most time; a WHILE program is not traced whole).  Each rank rewrites
its record after every stage, so a run cut at ``--timeout`` seconds says
how far it got.  Rank 0 gathers x (``--x``: an npz, arm -> x).  Prints
one JSON line (every rank's record with ``--out`` written there instead,
and the cards' names and power limits); exits 1 unless every rank
finished and every arm, on a card captured with one host read a solve on
every rank, took equal iterations both ways with x within 1e-6 (f32) and
1e-12 (f64) relative of the eager one, x bitwise over two solves, the
dots' bits alike on every rank and every exchange bitwise against NCCL's.
``--compare`` holds one run's x to another's by arm (max |x - x_parent|
/ max |x_parent|, bitwise) and prints a JSON line.
"""

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.environ.get("SHARDED_PROBE_ROOT",
                                      os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

TOL = {"flat": 1e-12}  # f64; the banded arms are f32: 1e-6


def _peer_checks(torch, ss, arm):
    """Each exchange of ``ss``'s peer group on this arm's shapes against
    its plain version over the group (NCCL), bitwise; {name: equal}."""
    pg = ss.peer
    gen = torch.Generator(device=pg.device).manual_seed(100 + pg.rank)
    out = {}
    if arm == "flat":
        lv, pl = ss.levels[-1], ss.params[-1]
        x = torch.randn((lv.rows_per_shard, ss.nb), generator=gen,
                        dtype=torch.float64, device=pg.device)
        sends = [(d, pl[f"send{t}"]) for t, d in enumerate(lv.deltas)]
        if sends:
            out["halo_rows"] = all(torch.equal(a, b) for a, b in zip(
                pg.rows(x, sends), pg.rows_plain(x, sends)))
        part = torch.randn((lv.n_rows_pad, ss.nb), generator=gen,
                           dtype=torch.float64, device=pg.device)
        out["reduce_scatter"] = torch.equal(pg.reduce_scatter(part),
                                            pg.reduce_scatter_plain(part))
    else:
        for li, (lv, pl) in enumerate(zip(ss.levels, ss.params)):
            x = torch.randn((lv.nb, lv.per), generator=gen,
                            device=pg.device)
            out[f"ring {li}"] = all(torch.equal(a, b) for a, b in zip(
                pg.ring(x, lv.T), pg.ring_plain(x, lv.T)))
            if lv.has_far:
                sends = [(d, pl[f"fsend{t}"])
                         for t, d in enumerate(lv.deltas)]
                out[f"far {li}"] = all(torch.equal(a, b) for a, b in zip(
                    pg.rows(x.T, sends), pg.rows_plain(x.T, sends)))
        x = torch.randn((ss.nb, ss.levels[-1].per), generator=gen,
                        device=pg.device)
    out["all_gather"] = torch.equal(pg.all_gather(x.contiguous()),
                                    pg.all_gather_plain(x.contiguous()))
    d = (x * x).sum().reshape(1).double()
    out["reduce"] = torch.equal(pg.reduce(d), pg.reduce_plain(d))
    torch.cuda.synchronize()
    return out


def _bounds(path):
    """{arm: (lo hex list, hi hex list)} of rank 0's record in ``path``
    (an earlier run's ``--out``)."""
    with open(path) as f:
        rank0 = json.load(f)["ranks"][0]
    return {arm: (row["lo"], row["hi"]) for arm, row in
            rank0["arms"].items() if "hi" in row}


def _setup(sm, arm, n, dev, group):
    """(system, rhs, rtol, side) of one arm."""
    from polydeal_tpu_torch.parallel.sharding import ShardedSystem

    if arm == "flat":
        _, _, b, mg = sm.flat_problem(n, device=dev)
        return ShardedSystem.from_multigrid(mg, group), b, 1e-9, n
    if arm.startswith("local"):
        an = int(arm[len("local"):] or n)
        sh = sm.setup_local(an, device=dev, group=group)
        return sh.ss, sh.b, 1e-8, an
    kw = {"structured": {}, "lex": dict(hierarchy="rtree"),
          "none": dict(hierarchy="rtree", relabel=None)}[arm]
    sh = sm.setup_sharded(n, device=dev, group=group, **kw)
    return sh.ss, sh.b, 1e-8, n


def rank_main(rank, world, store, arms, n, out_dir, timeout, device,
              hi_from, trace):
    import torch
    import torch.distributed as dist

    from polydeal_tpu_torch.models import sharded as sm
    from polydeal_tpu_torch.parallel.sharding import init_group, leave_group

    sys.path.insert(0, HERE)
    import while_probe

    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(
        "cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    group = init_group(rank, world, device=dev, store_path=store,
                       timeout=timeout)
    cuda = dev.type == "cuda"
    bounds = _bounds(hi_from) if hi_from else {}
    res = dict(rank=rank, root=ROOT, stage="setup", arms={})
    path = os.path.join(out_dir, f"rank{rank}.json")
    xs = {}

    def report(stage=None):  # with the host's peak RSS so far
        if stage is not None:
            res["stage"] = stage
        res["rss_mb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024
        with open(path, "w") as f:
            json.dump(res, f)

    for arm in arms:
        row = res["arms"][arm] = dict(stage="setup")
        report(arm)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ss, b, rtol, an = _setup(sm, arm, n, dev, group)
        if cuda:
            torch.cuda.synchronize(dev)
        row.update(n=an, setup_s=time.perf_counter() - t0)
        if arm in bounds:
            for lv, lo, hi in zip(ss.levels, *bounds[arm]):
                lv.lo, lv.hi = float.fromhex(lo), float.fromhex(hi)
            row["hi_from"] = hi_from
        if arm != "flat":
            row.update(lo=[float(lv.lo).hex() for lv in ss.levels],
                       hi=[float(lv.hi).hex() for lv in ss.levels],
                       rep_his=[h if h is None else float(h).hex()
                                for h in ss.rep_mg.his])
        if cuda and not ss.graph_ok(ss._local(b)):
            row["stage"] = "graph_ok refused the system"
            report()
            break
        row["stage"] = "solve"
        report()
        row.update(sm.eager_and_graph(ss, b, rtol, dev))
        x1, k1, _ = ss.solve_cg_local(b, rtol=rtol, maxiter=sm.MAXITER)
        x2, _, _ = ss.solve_cg_local(b, rtol=rtol, maxiter=sm.MAXITER)
        row.update(iterations=k1, x_bitwise=torch.equal(x1, x2),
                   dot_hex=float(ss._dot(x1, x1)).hex())
        if cuda:
            loop = ss._compiled(rtol, sm.MAXITER, True, b.dtype)[0]
            row.update(last=loop.last,
                       body_nodes=while_probe.node_types(loop.body.graph),
                       peak_mb=torch.cuda.max_memory_allocated(dev) / 2**20)
            del loop
        if trace and rank == 0 and cuda:
            from polydeal_tpu_torch.models.profile_flagship import _traced

            try:
                span, busy, n_ops, ops = _traced(
                    lambda: ss.solve_cg_local(b, rtol=rtol,
                                              maxiter=sm.MAXITER,
                                              capture=False), top=8)
                row["traced_eager"] = dict(
                    span_ms=span, busy_ms=busy, idle_share=1 - busy / span,
                    device_ops=n_ops, top_ops=ops)
            except RuntimeError as e:  # a trace without device records
                row["traced_eager"] = str(e)
        elif trace:
            ss.solve_cg_local(b, rtol=rtol, maxiter=sm.MAXITER,
                              capture=False)
        x = ss._gather(x1)
        if rank == 0:
            xs[arm] = x.double().cpu().numpy()
        if getattr(ss, "peer", None) is not None and cuda:
            row["peer_vs_nccl"] = _peer_checks(torch, ss, arm)
            ss.close()
            try:
                ss.solve_cg_local(b, rtol=rtol, maxiter=sm.MAXITER)
                row["closed_raises"] = False
            except (RuntimeError, ValueError):
                row["closed_raises"] = True
        elif hasattr(ss, "close"):
            ss.close()
        row["stage"] = "done"
        report()
        del ss, b, x, x1, x2
        dist.barrier(group=group, **(dict(device_ids=[dev.index]) if cuda
                                     else {}))
    else:
        res["stage"] = "done"
    report()
    leave_group()
    if rank == 0 and xs:
        import numpy as np

        np.savez(os.path.join(out_dir, "x.npz"), **xs)
    if res["stage"] == "done":
        report("left")


def held(ranks, nproc, arms, device) -> bool:
    """Every rank finished, and every arm, on a card captured with one
    host read a solve on every rank, held to its eager solve, bitwise run
    to run, its dots alike on every rank and its exchanges bitwise
    against NCCL's."""
    if len(ranks) != nproc or any(r["stage"] != "left" for r in ranks):
        return False
    for arm in arms:
        rows = [r["arms"].get(arm, {}) for r in ranks]
        if any(s.get("stage") != "done" for s in rows) or len(
                {s["dot_hex"] for s in rows}) != 1:
            return False
        for s in rows:
            if not (s["graph_iterations"] == s["eager_iterations"]
                    and s["graph_eager_diff"] <= TOL.get(arm, 1e-6)
                    and s["x_bitwise"]):
                return False
            if device == "cuda" and not (
                    s["captured"]
                    and all(q.get("host_reads") == 1
                            for q in s.get("ranks", [{}]))
                    and all(s.get("peer_vs_nccl", {None: False}).values())
                    and s.get("closed_raises")):
                return False
    return True


def run(args) -> int:
    import torch
    import torch.multiprocessing as mp

    from polydeal_tpu_torch.ops import _build

    arms = args.arms.split(",")
    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"{args.nproc} ranks need {args.nproc} cards")
        _build.load_library()  # build once, before the ranks load it
    os.environ["SHARDED_PROBE_ROOT"] = ROOT
    tmp = tempfile.mkdtemp(prefix="sharded_probe_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        rank_main, args=(args.nproc, os.path.join(tmp, "store"), arms,
                         args.n, tmp, args.timeout, args.device,
                         args.hi_from, args.trace),
        nprocs=args.nproc, join=False, start_method="spawn")
    finished, error = False, None
    t_end = time.monotonic() + args.timeout
    try:
        while not (finished := ctx.join(timeout=5)):
            if time.monotonic() > t_end:
                break
    except Exception as e:  # a rank failed: its record says where
        error = str(e)[-3000:]
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
    ranks = []
    for r in range(args.nproc):
        p = os.path.join(tmp, f"rank{r}.json")
        if os.path.exists(p):
            with open(p) as f:
                ranks.append(json.load(f))
    if args.x and os.path.exists(os.path.join(tmp, "x.npz")):
        shutil.copy(os.path.join(tmp, "x.npz"), args.x)
    shutil.rmtree(tmp, ignore_errors=True)
    smi = ["cpu"] if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    ok = finished and held(ranks, args.nproc, arms, args.device)
    out = dict(root=ROOT, n=args.n, nproc=args.nproc, arms=arms,
               finished=finished, ok=ok, error=error,
               seconds=time.perf_counter() - t0, cards=smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, ranks=ranks), f)
    else:
        out["ranks"] = ranks
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def compare(parent, tree) -> int:
    import numpy as np

    a, b = np.load(parent), np.load(tree)
    out = {}
    for arm in sorted(set(a.files) & set(b.files)):
        xp, xt = a[arm], b[arm]
        out[arm] = dict(rel=float(np.abs(xt - xp).max() / np.abs(xp).max()),
                        bitwise=bool(np.array_equal(xt, xp)))
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose polydeal_tpu_torch runs")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--arms", default="structured,flat",
                    help="of structured, lex, none, local[N], flat")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: gloo processes, a rehearsal (no capture)")
    ap.add_argument("--out", default=None,
                    help="write every rank's record here")
    ap.add_argument("--x", default=None, help="rank 0's x by arm (npz)")
    ap.add_argument("--hi-from", default=None,
                    help="take the banded arms' lo, hi from this --out")
    ap.add_argument("--trace", action="store_true",
                    help="trace rank 0's eager solve of each arm")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the ranks are killed")
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.root is not None and os.path.abspath(args.root) != ROOT:
        os.environ["SHARDED_PROBE_ROOT"] = os.path.abspath(args.root)
        os.execv(sys.executable, [sys.executable, *sys.argv])
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
