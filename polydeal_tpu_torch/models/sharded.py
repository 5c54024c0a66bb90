"""The sharded flagship solve: ``ShardedBandedSystem`` on one process per
shard, held to the unsharded solve.

Counterpart of ``bench_sharded(n, degree, rtol)`` in the repo's
``bench.py``, without its timing harness: the structured hierarchy at
n=64, p=1 (levels 512/4096/32768/262144, 7 band offsets, grid transfers),
f32 with bf16 band copies for smoothing, degree-5 Chebyshev with one
sweep, an explicit-inverse coarse solve; CG to rtol 1e-8 from zero (no
FMG), sharded and unsharded, and the largest difference of their
solutions.  ``bench_sharded`` runs it on one device; here any number of
ranks can, each building the same problem from the same deterministic
host code.

Usage, one GPU per rank (rank r on ``cuda:r``) or CPU processes::

    python -m polydeal_tpu_torch.models.sharded --nproc 4 --device cpu --n 8
    python -m polydeal_tpu_torch.models.sharded --nproc 1

    group = init_group(rank, world, device=dev, store_path=path)
    sh = setup_sharded(n=64, device=dev, group=group)
    x, iters, res = solve_sharded(sh)
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import tempfile
import time
from dataclasses import dataclass

import torch

from polydeal_tpu_torch.models.flagship import Flagship, setup_flagship
from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem
from polydeal_tpu_torch.parallel.sharding import init_group
from polydeal_tpu_torch.solvers import multigrid

__all__ = ["Sharded", "share", "setup_sharded", "solve_sharded",
           "level_meta", "max_offset", "min_ms", "run_case", "run_rank",
           "spawn"]

REPS = 3  # warm timed solves, the least kept (bench_sharded's)


@dataclass
class Sharded:
    """This rank's share of the flagship system: what a sharded solve
    needs, not the global bands of the sharded levels."""
    ss: ShardedBandedSystem
    b: torch.Tensor  # the flat global rhs
    n_dofs: int
    level_sizes: list


def share(fs: Flagship, group=None) -> Sharded:
    """This rank's share of ``fs`` over ``group`` (None: one shard)."""
    return Sharded(ShardedBandedSystem.from_multigrid(fs.mg, group), fs.b,
                   fs.n_dofs, fs.level_sizes)


def setup_sharded(n: int = 64, degree: int = 1, *, device, group=None,
                  dtype=torch.float32, precond_dtype=torch.bfloat16,
                  hierarchy: str = "structured", relabel: str | None = "lex"
                  ) -> Sharded:
    """The flagship system (``setup_flagship``, ``bench_sharded``'s
    configuration by default), which every rank builds whole, and this
    rank's share of its multigrid; the whole system is dropped."""
    return share(setup_flagship(n, degree, device=device, dtype=dtype,
                                precond_dtype=precond_dtype,
                                hierarchy=hierarchy, relabel=relabel), group)


def solve_sharded(sh: Sharded, rtol: float = 1e-8, maxiter: int = 100):
    """Sharded MG-CG from zero: (x flat global, iterations, residual)."""
    return sh.ss.solve_cg(sh.b, rtol=rtol, maxiter=maxiter)


def level_meta(ss: ShardedBandedSystem) -> list:
    """Each sharded level's (kind, per, T, has_far, deltas, n_sends),
    coarse to fine."""
    return [(lv.kind, lv.per, lv.T, lv.has_far, tuple(lv.deltas),
             tuple(lv.n_sends)) for lv in ss.levels]


def max_offset(ell) -> int:
    """The largest |offset| of a level's band, or of its pack's plan."""
    offs = ell.plan.offsets if hasattr(ell, "plan") else ell.offsets
    return max(abs(int(o)) for o in offs)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def min_ms(fn, device, reps: int = REPS) -> float:
    """Least wall ms of ``reps`` calls of ``fn``, each synchronised."""
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts)


def run_case(case: dict, device, group) -> dict:
    """One problem on this rank: the flagship system of ``case`` (keys n,
    hierarchy, relabel, dtype, precond_dtype and vector_dtype as torch dtype
    names, rtol, and optionally ``pack_min_p``, a lower pack threshold for
    small test problems, and ``timed``), its sharded solve and V-cycle on
    every rank and, on rank 0 only, the unsharded no-FMG solve and V-cycle
    they are held to; with ``timed`` both solves are timed as ``bench_sharded``
    times them (least of ``REPS`` warm runs).  Rank 0 returns numbers and
    host arrays, the other ranks their sharded numbers."""
    saved = multigrid.PACK_MIN_P
    if case.get("pack_min_p") is not None:
        multigrid.PACK_MIN_P = case["pack_min_p"]
    try:
        pdt, vdt = case.get("precond_dtype"), case.get("vector_dtype")
        fs = setup_flagship(
            case["n"], device=device,
            dtype=getattr(torch, case.get("dtype", "float32")),
            precond_dtype=None if pdt is None else getattr(torch, pdt),
            vector_dtype=None if vdt is None else getattr(torch, vdt),
            hierarchy=case.get("hierarchy", "structured"),
            relabel=case.get("relabel", "lex"))
    finally:
        multigrid.PACK_MIN_P = saved
    sh = share(fs, group)
    ss, b = sh.ss, sh.b
    if ss.rank != 0:
        fs = None  # only rank 0 keeps the whole system, to compare with
    rtol = case.get("rtol", 1e-8)
    x, k, res = ss.solve_cg(b, rtol=rtol, maxiter=100)
    out = dict(n_dofs=sh.n_dofs, levels=sh.level_sizes, n_dev=ss.n_dev,
               meta=level_meta(ss), comm=ss.comm_bytes_per_spmv(),
               lo_vec=str(ss.lo_vec).removeprefix("torch."),
               has_lo=[lv.has_lo for lv in ss.levels],
               iterations=k, residual=res, bnorm=float(b.norm()),
               x=x.cpu().numpy(), v_cycle=ss.v_cycle(b).cpu().numpy())
    if case.get("timed"):
        out["sharded_ms"] = min_ms(
            lambda: ss.solve_cg_local(b, rtol=rtol, maxiter=100), device)
    if fs is None:
        return out
    # no collective below: the other ranks may have left
    ru = fs.mg.solve_cg(b, rtol=rtol, maxiter=100)
    out.update(
        fine_max_offset=max_offset(fs.mg.ells[-1]),
        unsharded_iterations=ru.iterations,
        max_abs_diff=float((x - ru.x).abs().max()),
        x_unsharded=ru.x.cpu().numpy(),
        v_cycle_unsharded=fs.mg.v_cycle(b).cpu().numpy())
    if case.get("timed"):
        out["unsharded_ms"] = min_ms(
            lambda: fs.mg.solve_cg(b, rtol=rtol, maxiter=100), device)
        out["ratio"] = out["sharded_ms"] / out["unsharded_ms"]
    return out


def run_rank(rank: int, world: int, device: str, store_path: str,
             cases: list, out_path: str | None = None,
             timeout: float = 120.0) -> None:
    """A rank's whole run: join the group (rank r on ``cuda:r`` for a CUDA
    ``device``), run every case, write rank 0's results (a pickled list)
    to ``out_path``, leave the group.  The spawn target of :func:`spawn`."""
    dev = (torch.device("cuda", rank) if device == "cuda"
           else torch.device(device))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    group = init_group(rank, world, device=dev, store_path=store_path,
                       timeout=timeout)
    try:
        results = [run_case(c, dev, group) for c in cases]
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0 and out_path is not None:
        with open(out_path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(out_path + ".tmp", out_path)


def spawn(world: int, cases: list, *, device: str,
          timeout: float = 300.0) -> list:
    """Run ``cases`` on ``world`` fresh processes (the ``spawn`` start
    method; a gloo or NCCL group through a FileStore in a temporary
    directory) and return rank 0's results.  Raises if a rank fails or the
    run outlasts ``timeout`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.pkl")
        ctx = mp.start_processes(
            run_rank, args=(world, device, os.path.join(tmp, "store"), cases,
                            out, timeout),
            nprocs=world, join=False, start_method="spawn")
        t_end = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, t_end - time.monotonic())):
            if time.monotonic() > t_end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks outlasted {timeout} s")
        with open(out, "rb") as f:
            return pickle.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks (one GPU each on cuda)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--hierarchy", choices=("structured", "rtree"),
                    default="structured")
    ap.add_argument("--relabel", choices=("lex", "none"), default="lex",
                    help="the rtree hierarchy's numbering (none: packed "
                         "levels)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.nproc:
        raise SystemExit(f"sharded: {args.nproc} ranks need {args.nproc} "
                         f"CUDA devices, found {torch.cuda.device_count()}")
    case = dict(n=args.n, hierarchy=args.hierarchy,
                relabel=None if args.relabel == "none" else "lex",
                dtype="float32", precond_dtype="bfloat16", rtol=1e-8,
                timed=True)
    (r,) = spawn(args.nproc, [case], device=args.device, timeout=3000.0)
    keep = ("n_dofs", "levels", "n_dev", "meta", "comm", "iterations",
            "unsharded_iterations", "residual", "bnorm", "max_abs_diff",
            "unsharded_ms", "sharded_ms", "ratio")
    out = {k: r[k] for k in keep if k in r}
    out["device"] = "cpu"
    if args.device == "cuda":
        # the card's name and power limit, beside every time printed
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
