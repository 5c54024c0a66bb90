"""What the far block-COO tail's fixed-order sum costs on one card, at the
shapes a 4-rank split of the ``relabel=None`` flagship gives it.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/far_tail_sum.py [--n 64] [--ranks 4]

Sets up the R-tree flagship with ``relabel=None`` (``models/flagship``,
f32 with bf16 smoothing copies, ``bench_sharded``'s precisions) on
``cuda:0``.  For each packed level, repacked for ``--ranks`` slabs as
``ShardedBandedSystem`` repacks it (``_shard_ready``), and each rank, it
builds the rank's far tail with ``ShardedBandedSystem._build_far`` and
times the tail's local work (gather of x, block products, ``SegmentSum``
by row) two ways, each as the captured solve runs it: 50 calls captured in
one CUDA graph, its replay timed by CUDA events (device time a call, with
no host dispatch between the calls).  The two ways: over the
rank's own entries, as the system runs it, and over its share padded to
the largest share with the padding at local row 0 (what a padded layout
would cost where the shares differ).  It counts the packed-level SpMVs of one eager world-size-1
solve (``solve_cg_local(capture=False)``: residuals, Chebyshev steps and
the fine operator, each a far SpMV at ``--ranks`` ranks) and prints one
JSON line: per level and rank the entries, the ``SegmentSum`` width and
both times; per level the SpMVs a solve; and per solve the sum over
levels of SpMVs x the slowest rank's time, each way (ranks run in lock
step), with the card's name and power limit.  Exchanges are not timed.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS, WARM = 50, 5


def replay_ms(torch, fn) -> float:
    """Mean ms a call of ``fn`` over one replay of ``REPS`` captured calls
    (after ``WARM`` eager calls on a side stream and one warm replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARM):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def spmvs_per_solve(torch, fs, dev) -> dict:
    """{lanes: packed-level SpMVs} of one eager world-size-1 solve."""
    import polydeal_tpu_torch.parallel.banded as pb

    counts = {}

    def counted(fn):
        def wrap(data, oid, *args, **kw):
            counts[oid.shape[-1]] = counts.get(oid.shape[-1], 0) + 1
            return fn(data, oid, *args, **kw)
        return wrap

    names = ("packed_matvec_t_halo", "packed_cheb_step_t_halo",
             "packed_residual_t_halo")
    saved = {n: getattr(pb, n) for n in names}
    ss = pb.ShardedBandedSystem.from_multigrid(fs.mg)
    try:
        for n in names:
            setattr(pb, n, counted(saved[n]))
        _, k, _ = ss.solve_cg_local(fs.b, rtol=1e-8, maxiter=100,
                                    capture=False)
    finally:
        for n in names:
            setattr(pb, n, saved[n])
    return dict(iterations=k, by_lanes=counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch

    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.parallel.banded import (
        ShardedBandedSystem,
        _shard_ready,
        _SLevel,
    )
    from polydeal_tpu_torch.sparse import BlockPacked
    from polydeal_tpu_torch.utils.segment import SegmentSum

    if not torch.cuda.is_available():
        raise SystemExit("far_tail_sum: needs a CUDA card")
    dev = torch.device("cuda", 0)
    fs = setup_flagship(args.n, device=dev, dtype=torch.float32,
                        precond_dtype=torch.bfloat16, hierarchy="rtree",
                        relabel=None)
    n_dev = args.ranks
    gen = torch.Generator(device=dev).manual_seed(15)
    levels = []
    for ell in fs.mg.ells:
        if not isinstance(ell, BlockPacked):
            continue
        per = ell.n_block_rows // n_dev
        ready = _shard_ready(ell, per)
        if not ready._has_far():
            continue
        rows, cols = np.asarray(ready.far_rows), np.asarray(ready.far_cols)
        owner = rows // per
        nnz_per = int(np.bincount(owner, minlength=n_dev).max())
        nb = ready.n_basis
        ranks = []
        for rank in range(n_dev):
            lv = _SLevel(kind="packed", per=per, T=1, lo=0.0, hi=1.0, nb=nb)
            pl_ = dict(data_i=ready.data_i[:, :1])
            ShardedBandedSystem._build_far(
                lv, pl_, rows, cols, lambda idx: ready.far_data[
                    torch.as_tensor(idx, device=dev)], per, n_dev, rank)
            mine = np.where(owner == rank)[0]
            k = mine.size
            # the share padded to the largest, padding at local row 0
            labels = np.zeros(nnz_per, dtype=np.int64)
            labels[:k] = rows[mine] - rank * per
            padded = SegmentSum(labels, per, dev)
            fdata_pad = pl_["fdata"].new_zeros((nnz_per, nb, nb))
            fdata_pad[:k] = pl_["fdata"][:k]
            fcols_pad = torch.zeros(nnz_per, dtype=torch.int64, device=dev)
            fcols_pad[:pl_["fcols"].shape[0]] = pl_["fcols"]
            xg = torch.randn((per + sum(lv.n_sends), nb), generator=gen,
                             device=dev, dtype=torch.float32)

            def own():
                return pl_["frow_sum"](torch.einsum(
                    "kij,kj->ki", pl_["fdata"], xg[pl_["fcols"]]))

            def pad():
                return padded(torch.einsum("kij,kj->ki", fdata_pad,
                                           xg[fcols_pad]))

            diff = float((own() - pad()).abs().max())
            ranks.append(dict(rank=rank, entries=int(k),
                              width_own=pl_["frow_sum"].shape[1],
                              width_padded=padded.shape[1],
                              ms_own=replay_ms(torch, own),
                              ms_padded=replay_ms(torch, pad),
                              max_abs_diff=diff))
        levels.append(dict(lanes=ell.n_block_rows, per=per, nnz_per=nnz_per,
                           ranks=ranks))
    counts = spmvs_per_solve(torch, fs, dev)
    total = {"own": 0.0, "padded": 0.0}
    for lvl in levels:
        lvl["spmvs_per_solve"] = counts["by_lanes"].get(lvl["lanes"], 0)
        for way in total:
            total[way] += lvl["spmvs_per_solve"] * max(
                r[f"ms_{way}"] for r in lvl["ranks"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps(dict(n=args.n, ranks=n_dev,
                          iterations=counts["iterations"], levels=levels,
                          ms_per_solve=total, card=smi[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
