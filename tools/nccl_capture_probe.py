"""Try the captured sharded CG across GPUs (NCCL collectives in a CUDA
graph).

Run from the root of a checkout on a host with ``--nproc`` CUDA cards::

    python3 tools/nccl_capture_probe.py --nproc 4 [--n 64] [--timeout 600]

(``--device cpu`` runs the same flow on gloo CPU processes, where the
capture is refused: a rehearsal of the script.)

Each rank (rank r on ``cuda:r``, NCCL through a FileStore) builds
``bench_sharded``'s structured system (``models/sharded.setup_sharded``),
solves it through the eager loop (``solve_cg_local(capture=False)``) and
then through the captured programs, with ``ShardedBandedSystem.graph_ok``
forced to admit more than one rank: the port's rule refuses that, since
its halo exchanges and all-reduces were never held to the eager solve
inside a capture.  Prints one JSON line: per rank, the eager iterations
and warm ms (least of 3, host clock, synchronised), and either the
captured solve's iterations, warm ms and max |x_graph - x_eager| on its
slab, or the error its capture raised; and the card's name and power
limit.  Each rank rewrites its JSON after every stage (``stage``: setup,
eager, capture, graph, done), so a run cut at ``--timeout`` seconds still
says how far each rank got.
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


def rank_main(rank, world, store, n, out_dir, device):
    import torch
    import torch.distributed as dist

    from polydeal_tpu_torch.models.sharded import min_ms, setup_sharded
    from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem
    from polydeal_tpu_torch.parallel.sharding import init_group

    res = dict(rank=rank, stage="setup")

    def report(stage):
        res["stage"] = stage
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)

    report("setup")
    dev = (torch.device("cuda", rank) if device == "cuda"
           else torch.device("cpu"))
    init_group(rank, world, device=dev, store_path=store, timeout=90.0)
    sh = setup_sharded(n, device=dev, group=dist.group.WORLD)
    ss, b = sh.ss, sh.b
    report("eager")
    eager = lambda: ss.solve_cg_local(b, rtol=1e-8, maxiter=100,
                                      capture=False)
    x_e, k_e, _ = eager()
    res.update(eager_iterations=k_e, eager_ms=min_ms(eager, dev))
    report("capture")
    ShardedBandedSystem.graph_ok = lambda self, v: True
    # capture both programs first; replay only where every rank captured,
    # so that no rank waits in a replayed collective for one that failed
    captured = 1
    try:
        loop = ss._compiled(1e-8, 100, True, b.dtype)[0]
        loop.body = loop._capture_body()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    except Exception as e:  # the probe's result: what the capture raised
        res["capture_error"] = f"{type(e).__name__}: {e}"[:600]
        captured = 0
    flag = torch.tensor([captured], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    res["all_captured"] = bool(flag.item())
    if res["all_captured"]:
        report("graph")
        graph = lambda: ss.solve_cg_local(b, rtol=1e-8, maxiter=100,
                                          capture=True)
        x_g, k_g, _ = graph()
        res.update(graph_iterations=k_g,
                   max_abs_diff=float((x_g - x_e).abs().max()),
                   graph_ms=min_ms(graph, dev),
                   capture_s=sum(p.seconds for p in loop.captured))
    report("done")
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
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
                             tmp, args.device), nprocs=args.nproc,
            join=False, start_method="spawn")
        t_end = time.monotonic() + args.timeout
        while not (ok := ctx.join(timeout=5)):
            if time.monotonic() > t_end:
                for p in ctx.processes:
                    p.kill()
                break
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
    print(json.dumps(dict(n=args.n, nproc=args.nproc, finished=ok,
                          ranks=ranks, cards=smi)), flush=True)
    return 0 if ok and len(ranks) == args.nproc else 1


if __name__ == "__main__":
    sys.exit(main())
