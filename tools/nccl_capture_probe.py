"""Run both sharded systems' captured CG across GPUs (NCCL collectives in
CUDA graphs) and hold each to its eager solve.

Run from the root of a checkout on a host with ``--nproc`` CUDA cards::

    python3 tools/nccl_capture_probe.py --nproc 4 [--n 64] [--timeout 600]
        [--banded packed]

(``--device cpu`` runs the same flow on gloo CPU processes, where nothing
is captured: a rehearsal of the script.)

Each rank (rank r on ``cuda:r``, NCCL through a FileStore) builds, in
turn, ``bench_sharded``'s structured system (``models/sharded
.setup_sharded``, f32 with bf16 smoothing copies, the
``ShardedBandedSystem``; with ``--banded packed`` the R-tree flagship with
``relabel=None`` instead, whose packed levels 4 ranks repack with far
tails) and the flat block-COO ``ShardedSystem`` of the 2D R-tree problem of
side ``--n`` (``models/sharded.flat_problem``, f64).  For each it captures
the CG programs (``_compiled`` and the body; on a card a system that
``graph_ok`` refuses is a failure, since nothing would be captured), and
only where every rank captured them (an all-reduced flag, so that no rank
waits in a replayed collective for one that failed) solves eagerly
(``capture=False``) and captured, both timed (``models/sharded
.eager_and_graph``: least of 3 warm solves, host clock, synchronised).
Prints one JSON line: per rank and system, both iterations, the largest
|x_graph - x_eager| over the ranks relative to max |x_eager|, both times,
the captured loop's replays (bodies run) and host reads of its last
solve, capture seconds and pool MB, rank 0's traced solve each way (span,
device busy time, idle share, the 8 device operations with the most
time), or the error a capture raised; and the
cards' names and power limits.  Each rank rewrites its JSON after every
stage (``stage``: setup, banded:capture, banded:solve, flat:setup,
flat:capture, flat:solve, done, and left once the group is destroyed), so
a run cut at ``--timeout`` seconds still says how far each rank got.
Exits 1 unless every rank finished and every system, on a card captured,
took equal iterations both ways with x within 1e-6 (f32) and 1e-12 (f64)
relative of the eager one.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL = {"banded": 1e-6, "flat": 1e-12}  # f32 and f64 solves


def rank_main(rank, world, store, n, out_dir, device, banded):
    import torch
    import torch.distributed as dist

    from polydeal_tpu_torch.models.profile_flagship import _traced
    from polydeal_tpu_torch.models.sharded import (MAXITER,
                                                   eager_and_graph,
                                                   flat_problem,
                                                   setup_sharded)
    from polydeal_tpu_torch.parallel.sharding import (ShardedSystem,
                                                      init_group,
                                                      leave_group)

    res = dict(rank=rank, stage="setup")

    def report(stage):
        res["stage"] = stage
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)

    def run(name, ss, b, rtol):
        report(f"{name}:capture")
        ok, captures = 1, ss.graph_ok(b)
        if dev.type == "cuda" and not captures:
            res[f"{name}_capture_error"] = "graph_ok refused the system"
            ok = 0
        elif captures:
            try:
                loop = ss._compiled(rtol, MAXITER, True, b.dtype)[0]
                loop.body = loop._capture_body()
                torch.cuda.synchronize(dev)
            except Exception as e:  # the probe's result: what it raised
                res[f"{name}_capture_error"] = f"{type(e).__name__}: {e}"[:600]
                ok = 0
        flag = torch.tensor([ok], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not flag.item():
            return
        report(f"{name}:solve")
        res[name] = eager_and_graph(ss, b, rtol, dev)
        # one more solve each way on every rank, rank 0's traced
        for mode, capture in (("eager", False), ("graph", None)):
            solve = lambda: ss.solve_cg_local(b, rtol=rtol, maxiter=MAXITER,
                                              capture=capture)
            if rank != 0 or dev.type != "cuda":
                solve()
                continue
            try:
                span, busy, n_ops, ops = _traced(solve, top=8)
                res[name][f"traced_{mode}"] = dict(
                    span_ms=span, busy_ms=busy, idle_share=1 - busy / span,
                    device_ops=n_ops, top_ops=ops)
            except RuntimeError as e:  # a trace without device records
                res[name][f"traced_{mode}"] = str(e)

    report("setup")
    dev = (torch.device("cuda", rank) if device == "cuda"
           else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init_group(rank, world, device=dev, store_path=store, timeout=90.0)
    kw = (dict(hierarchy="rtree", relabel=None) if banded == "packed"
          else {})
    sh = setup_sharded(n, device=dev, group=dist.group.WORLD, **kw)
    run("banded", sh.ss, sh.b, 1e-8)
    del sh
    report("flat:setup")
    _, _, b, mg = flat_problem(n, device=dev)
    run("flat", ShardedSystem.from_multigrid(mg, dist.group.WORLD), b, 1e-9)
    report("done")
    leave_group()
    report("left")


def held(ranks, nproc, device) -> bool:
    """Every rank done, and each system's solve, on a card captured, held
    to the eager one on every rank."""
    if len(ranks) != nproc or any(r["stage"] != "left" for r in ranks):
        return False
    for r in ranks:
        for name, tol in TOL.items():
            s = r.get(name)
            if s is None or s["graph_iterations"] != s["eager_iterations"]:
                return False
            if device == "cuda" and not s["captured"]:
                return False
            if not s["graph_eager_diff"] <= tol:
                return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--banded", choices=("structured", "packed"),
                    default="structured",
                    help="the banded system: bench_sharded's, or the "
                         "relabel=None R-tree flagship (far tails)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the ranks are killed")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    from polydeal_tpu_torch.ops import _build

    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"{args.nproc} ranks need {args.nproc} cards")
        _build.load_library()  # build once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            rank_main, args=(args.nproc, os.path.join(tmp, "store"), args.n,
                             tmp, args.device, args.banded),
            nprocs=args.nproc,
            join=False, start_method="spawn")
        t_end = time.monotonic() + args.timeout
        finished = False
        try:
            while not (finished := ctx.join(timeout=5)):
                if time.monotonic() > t_end:
                    break
        except Exception as e:  # a rank failed: its JSON says where
            print(f"probe: {e}", file=sys.stderr)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        ranks = []
        for r in range(args.nproc):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
    smi = ["cpu"] if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    ok = finished and held(ranks, args.nproc, args.device)
    print(json.dumps(dict(n=args.n, nproc=args.nproc, banded=args.banded,
                          finished=finished,
                          ok=ok, ranks=ranks, cards=smi)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
