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

:func:`setup_local` builds each rank's share shard-locally
(``ShardedBandedSystem.setup_local``: only its lane slabs of the sharded
levels, their tables and bands through K3-K5 one slab at a time) instead of
from the whole system.  :func:`dryrun` is the counterpart of the repo's
``__graft_entry__.dryrun_multichip``: the R-tree hierarchy on
``hyper_cube(2, 16)`` at p=1 in f64 with a packed fine level (a far
block-COO tail once a slab is narrower than its offsets), sharded and held
to the host solve, then the flat block-COO ``ShardedSystem`` on the 2D
n=8 problem.  On GPUs (NCCL) every sharded solve runs as captured programs
by default; :func:`eager_and_graph` times it beside the eager loop
(``capture=False``), and :func:`masked_case` runs on CPU ranks the CG that
the captured loop replays.

Usage, one GPU per rank (rank r on ``cuda:r``) or CPU processes::

    python -m polydeal_tpu_torch.models.sharded --nproc 4 --device cpu --n 8
    python -m polydeal_tpu_torch.models.sharded --nproc 4 --device cpu --n 8 \
        --local
    python -m polydeal_tpu_torch.models.sharded --nproc 4 --device cpu \
        --dryrun
    python -m polydeal_tpu_torch.models.sharded --nproc 1

    group = init_group(rank, world, device=dev, store_path=path)
    sh = setup_sharded(n=64, device=dev, group=group)
    x, iters, res = solve_sharded(sh)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import subprocess
import tempfile
import time
from dataclasses import dataclass

import torch

from polydeal_tpu_torch.models import flagship
from polydeal_tpu_torch.models.flagship import Flagship, setup_flagship
from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem
from polydeal_tpu_torch.parallel.sharding import (
    ShardedSystem,
    init_group,
    leave_group,
)
from polydeal_tpu_torch.solvers import multigrid
from polydeal_tpu_torch.utils.segment import SegmentSum

__all__ = ["Sharded", "share", "setup_sharded", "setup_local",
           "solve_sharded", "level_meta", "max_offset", "min_ms", "run_case",
           "case_flagship", "eager_and_graph", "masked_case", "local_case",
           "flat_problem", "flat_case", "packed_problem", "dryrun",
           "run_rank", "spawn"]

REPS = 3  # warm timed solves, the least kept (bench_sharded's)
MAXITER = 100  # CG's iteration cap in every case here
BLIND = 3  # masked_case's bodies after the stop


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
    """This rank's share of the flagship system (``setup_flagship``,
    ``bench_sharded``'s configuration by default), built whole by every
    rank and then shared out (the whole system is dropped);
    :func:`setup_local` builds it shard-locally."""
    return share(setup_flagship(n, degree, device=device, dtype=dtype,
                                precond_dtype=precond_dtype,
                                hierarchy=hierarchy, relabel=relabel), group)


def _u_exact(x):
    return torch.prod(torch.sin(math.pi * x), dim=-1)


def _f_poisson(x):
    return x.shape[-1] * math.pi**2 * _u_exact(x)


def setup_local(n: int = 64, degree: int = 1, *, device, group=None,
                dtype=torch.float32, precond_dtype=torch.bfloat16,
                hierarchy: str = "structured", relabel: str | None = "lex"
                ) -> Sharded:
    """This rank's share of the flagship system built shard-locally: the
    host hierarchy whole, then ``ShardedBandedSystem.setup_local`` with the
    flagship's smoother and coarse solve (``setup_flagship``'s), and this
    rank's part of the rhs from its slab tables (``b`` is then local)."""
    _build_prepare(device)
    handlers, parents, grid_shapes = flagship.flagship_hierarchy(
        n, degree, hierarchy, relabel)
    ss = ShardedBandedSystem.setup_local(
        handlers, parents, group, device=device, grid_shapes=grid_shapes,
        dtype=dtype, precond_dtype=precond_dtype,
        chebyshev_degree=flagship.CHEBYSHEV_DEGREE,
        n_smooth=flagship.N_SMOOTH,
        smoothing_range=flagship.SMOOTHING_RANGE, coarse_solver="inv",
        rhs=(_f_poisson, _u_exact))
    return Sharded(ss, ss.b_local, handlers[-1].n_dofs,
                   [h.n_poly for h in handlers])


def _build_prepare(device) -> None:
    """What setup_flagship does first on a device: TF32 off, the kernel
    library loaded."""
    from polydeal_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.prepare_device(device)


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
    they are held to; with ``timed`` both solves are timed as
    ``bench_sharded`` times them (least of ``REPS`` warm runs), the sharded
    one eager and captured (:func:`eager_and_graph`).  Rank 0 returns
    numbers and host arrays, the other ranks their sharded numbers.  A case
    with ``kind`` "local" runs :func:`local_case`, "dryrun" :func:`dryrun`,
    "flat" :func:`flat_case`, "masked" :func:`masked_case`."""
    if case.get("kind") == "local":
        return local_case(case, device, group)
    if case.get("kind") == "flat":
        return flat_case(case, device, group)
    if case.get("kind") == "dryrun":
        return dryrun(device, group)
    if case.get("kind") == "masked":
        return masked_case(case, device, group)
    fs = case_flagship(case, device)
    sh = share(fs, group)
    ss, b = sh.ss, sh.b
    if ss.rank != 0:
        fs = None  # only rank 0 keeps the whole system, to compare with
    rtol = case.get("rtol", 1e-8)
    x, k, res = ss.solve_cg(b, rtol=rtol, maxiter=MAXITER)
    out = dict(n_dofs=sh.n_dofs, levels=sh.level_sizes, n_dev=ss.n_dev,
               meta=level_meta(ss), comm=ss.comm_bytes_per_spmv(),
               lo_vec=str(ss.lo_vec).removeprefix("torch."),
               has_lo=[lv.has_lo for lv in ss.levels],
               iterations=k, residual=res, bnorm=float(b.norm()),
               x=x.cpu().numpy(), v_cycle=ss.v_cycle(b).cpu().numpy())
    if case.get("timed"):
        out.update(eager_and_graph(ss, b, rtol, device))
    if fs is None:
        return out
    # no collective below: the other ranks may have left
    ru = fs.mg.solve_cg(b, rtol=rtol, maxiter=MAXITER)
    out.update(
        fine_max_offset=max_offset(fs.mg.ells[-1]),
        unsharded_iterations=ru.iterations,
        max_abs_diff=float((x - ru.x).abs().max()),
        x_unsharded=ru.x.cpu().numpy(),
        v_cycle_unsharded=fs.mg.v_cycle(b).cpu().numpy())
    if case.get("timed"):
        out["unsharded_ms"] = min_ms(
            lambda: fs.mg.solve_cg(b, rtol=rtol, maxiter=MAXITER), device)
        out["ratio"] = out["sharded_ms"] / out["unsharded_ms"]
    return out


def case_flagship(case: dict, device) -> Flagship:
    """The flagship system of ``case`` (keys as :func:`run_case`'s)."""
    saved = multigrid.PACK_MIN_P
    if case.get("pack_min_p") is not None:
        multigrid.PACK_MIN_P = case["pack_min_p"]
    try:
        pdt, vdt = case.get("precond_dtype"), case.get("vector_dtype")
        return setup_flagship(
            case["n"], device=device,
            dtype=getattr(torch, case.get("dtype", "float32")),
            precond_dtype=None if pdt is None else getattr(torch, pdt),
            vector_dtype=None if vdt is None else getattr(torch, vdt),
            hierarchy=case.get("hierarchy", "structured"),
            relabel=case.get("relabel", "lex"))
    finally:
        multigrid.PACK_MIN_P = saved


def _max_over_ranks(v: torch.Tensor, group) -> list:
    """The entries of ``v`` (1-D), each its largest over the group."""
    if group is not None:
        v = v.clone()
        torch.distributed.all_reduce(v, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
    return v.tolist()


def eager_and_graph(ss, b, rtol: float, device) -> dict:
    """The eager solve (``solve_cg_local(capture=False)``) of a sharded
    system ``ss`` (either kind) beside its default one, captured where
    ``ss.graph_ok`` admits it (else eager again): the iterations of each,
    whether the default was captured, the largest |x - x_eager| over every
    rank's share relative to the largest |x_eager| (``graph_eager_diff``;
    0: bitwise) and, where captured, the loop's replays (bodies run) and
    host reads of its last solve (``CGLoop.last``) and
    its programs' capture seconds and pool MB; both timed as
    ``bench_sharded`` times a solve: ``sharded_eager_ms`` and
    ``sharded_ms`` (least of ``REPS`` warm solves; ``sharded_ms`` is the
    default path's).  Every rank of the group calls it."""
    solve = lambda capture=None: ss.solve_cg_local(
        b, rtol=rtol, maxiter=MAXITER, capture=capture)
    x_e, k_e, _ = solve(False)
    x_g, k_g, _ = solve()
    captured = ss.graph_ok(b)
    d, m = _max_over_ranks(torch.stack([(x_g - x_e).abs().max(),
                                        x_e.abs().max()]), ss.group)
    out = dict(eager_iterations=k_e, graph_iterations=k_g, captured=captured,
               graph_eager_diff=d / m)
    out["sharded_eager_ms"] = min_ms(lambda: solve(False), device)
    out["sharded_ms"] = min_ms(solve, device)
    if captured:
        loop = ss._compiled(rtol, MAXITER, True, b.dtype)[0]
        out.update({k: loop.last[k] for k in ("replays", "host_reads")})
        out.update(capture_s=sum(p.seconds for p in loop.captured),
                   pool_mb=sum(p.pool_bytes for p in loop.captured) / 2**20)
    return out


def masked_case(case: dict, device, group) -> dict:
    """CG of one sharded system of ``case`` on this rank as the captured
    loop (``solvers/graphs.CGLoop``) runs it, eagerly: ``cg_init``, the
    masked ``cg_body`` to the stop, then ``BLIND`` more bodies,
    each of which must leave the state bitwise as it was; held to the
    rank's eager ``solve_cg_local(capture=False)``.  ``case["system"]`` is
    "flat" (the flat ``ShardedSystem`` on :func:`flat_problem` of
    ``case["n"]``) or "banded" (``ShardedBandedSystem`` of the flagship of
    the case's keys, as :func:`run_case`).  Returns every rank's record
    (``flags``: ``active`` after the start and after each body;
    ``unchanged`` per blind body; ``k``, ``k_eager``, ``x_equal``;
    ``raised``: whether ``capture=True`` raised) and the gathered x."""
    from polydeal_tpu_torch.solvers.cg import cg_body, cg_init

    rtol, maxiter = case.get("rtol", 1e-9), MAXITER
    if case["system"] == "flat":
        _, _, b, mg = flat_problem(case["n"], device=device)
        ss = ShardedSystem.from_multigrid(mg, group)
    else:
        fs = case_flagship(case, device)
        ss, b = ShardedBandedSystem.from_multigrid(fs.mg, group), fs.b
    A, M = ss.cg_ops()
    st, tol = cg_init(A, ss._local(b), None, M, rtol, maxiter=maxiter,
                      dot=ss._dot)
    flags, unchanged = [bool(st.active)], []
    while flags[-1]:
        st = cg_body(A, M, st, tol, maxiter, ss._dot)
        flags.append(bool(st.active))
    for _ in range(BLIND):
        nxt = cg_body(A, M, st, tol, maxiter, ss._dot)
        unchanged.append(all(torch.equal(p, q) for p, q in zip(nxt, st)))
        flags.append(bool(nxt.active))
        st = nxt
    x_e, k_e, _ = ss.solve_cg_local(b, rtol=rtol, maxiter=maxiter,
                                    capture=False)
    try:
        ss.solve_cg_local(b, rtol=rtol, maxiter=maxiter, capture=True)
        raised = False
    except ValueError:
        raised = True
    mine = dict(rank=ss.rank, flags=flags, unchanged=unchanged,
                k=int(st.k), k_eager=k_e, x_equal=torch.equal(st.x, x_e),
                raised=raised)
    ranks = [mine]
    if group is not None:
        ranks = [None] * ss.n_dev
        torch.distributed.all_gather_object(ranks, mine, group=group)
    return dict(n_dev=ss.n_dev, ranks=ranks, x=ss._gather(st.x).cpu().numpy(),
                meta=(level_meta(ss) if case["system"] != "flat" else None))


def _global_lanes(ss) -> list:
    """(level index, key, shape) of every tensor of a sharded level's
    params that has a dimension of the level's global lane count."""
    bad = []
    for li, (lv, pl_) in enumerate(zip(ss.levels, ss.params)):
        P_l = lv.per * ss.n_dev
        for key, t in pl_.items():
            if torch.is_tensor(t) and P_l in t.shape:
                bad.append((li, key, tuple(t.shape)))
    return bad


def _same(a, b) -> bool:
    """Whether two entries of a level's params are equal: tensors bitwise,
    segment sums by their member lists (other entries, such as kept kernel
    launch arguments, pass)."""
    if torch.is_tensor(b):
        return torch.equal(a, b)
    if isinstance(b, SegmentSum):
        return torch.equal(a.idx, b.idx) and a.shape == b.shape
    return True


def local_case(case: dict, device, group) -> dict:
    """The shard-local setup of the flagship system of ``case`` (keys as
    :func:`run_case`'s) on every rank, held by the caller to
    ``from_multigrid`` of the whole setup (which every rank also builds
    here): both solves from zero, their eigenvalue estimates and fine
    slabs, which of the local system's tensors have a dimension of their
    level's global lane count (``global_lanes``; none may, beyond one
    rank), and per sharded level the largest host table of its slab build
    beside that of a whole-level build (``table_bytes``)."""
    from polydeal_tpu_torch.assembly import sipg

    saved = multigrid.PACK_MIN_P
    if case.get("pack_min_p") is not None:
        multigrid.PACK_MIN_P = case["pack_min_p"]
    pdt = case.get("precond_dtype")
    kw = dict(dtype=getattr(torch, case.get("dtype", "float32")),
              precond_dtype=None if pdt is None else getattr(torch, pdt),
              hierarchy=case.get("hierarchy", "structured"),
              relabel=case.get("relabel", "lex"))
    try:
        sl = setup_local(case["n"], device=device, group=group, **kw)
        sg = share(setup_flagship(case["n"], device=device, **kw), group)
    finally:
        multigrid.PACK_MIN_P = saved
    rtol = case.get("rtol", 1e-8)
    ss, gs = sl.ss, sg.ss
    x, k, res = ss.solve_cg(sl.b, rtol=rtol, maxiter=MAXITER)
    xg, kg, resg = gs.solve_cg(sg.b, rtol=rtol, maxiter=MAXITER)
    both = (eager_and_graph(ss, sl.b, rtol, device)
            if case.get("timed") else {})
    fine = ss.params[-1]
    handlers, _, _ = flagship.flagship_hierarchy(
        case["n"], 1, kw["hierarchy"], kw["relabel"])
    whole = []
    for h in handlers[len(handlers) - len(ss.levels):]:
        sipg.build_banded_groups(h, multigrid.band_offsets(h), kw["dtype"],
                                 device=device)
        whole.append(sipg.last_setup_stats["max_host_slab_bytes"])
    return dict(
        n_dev=ss.n_dev, meta=level_meta(ss), meta_global=level_meta(gs),
        iterations=k, iterations_global=kg, residual=res,
        bnorm=float(sg.b.norm()), max_abs_diff=float((x - xg).abs().max()),
        x=x.cpu().numpy(),
        lam_rel=[abs(a.hi - b.hi) / b.hi for a, b in zip(ss.levels,
                                                         gs.levels)],
        b_diff=float((ss._local(sl.b) - gs._local(sg.b)).abs().max()),
        slabs_equal=[all(_same(a[key], b[key]) for key in b
                         if key != "dinv")
                     for a, b in zip(ss.params, gs.params)],
        dinv_diff=max(float((a["dinv"] - b["dinv"]).abs().max())
                      for a, b in zip(ss.params, gs.params)),
        fine_data_i=fine["data_i"].cpu().numpy(),
        global_lanes=_global_lanes(ss), rep_levels=ss.rep_mg.n_levels,
        table_bytes=[(st["max_host_slab_bytes"], w)
                     for st, w in zip(ss.setup_stats, whole)], **both)


def flat_problem(n: int, degree: int = 1, *, device, dtype=torch.float64,
                 **mg_kw):
    """(fine handler, A, b, mg): the 2D Poisson problem on the R-tree
    hierarchy of ``hyper_cube(2, n)`` (every extraction level), table
    assembly, R3MG over block-COO levels (``build_multigrid``'s defaults,
    ``mg_kw`` on top): the JAX package's ``tests/test_sharding.py``
    ``setup_problem``."""
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator
    from polydeal_tpu_torch.assembly.sipg import (assemble_rhs,
                                                  assemble_sipg_matrix)
    from polydeal_tpu_torch.mesh import hyper_cube

    m0 = hyper_cube(2, n)
    agg = RTreeAgglomerator.build(m0.cell_centers())
    handlers, parents = multigrid.build_rtree_hierarchy(
        m0, agg, list(range(1, agg.n_levels - 1)) or [1], degree=degree)
    hf = handlers[-1]
    A = assemble_sipg_matrix(hf, dtype=dtype, device=device)
    b = assemble_rhs(hf, _f_poisson, _u_exact, dtype=dtype, device=device)
    mg = multigrid.build_multigrid(handlers, parents, A, dtype=dtype,
                                   device=device, **mg_kw)
    return hf, A, b, mg


def flat_case(case: dict, device, group) -> dict:
    """:func:`flat_problem` (case keys n, and optionally chebyshev_degree
    and n_smooth) through the flat block-COO ``ShardedSystem`` over
    ``group`` (keys rtol, maxiter, precondition), beside the same solve on
    the host: MG-CG, or CG with no preconditioner.  Returns both solutions
    and iteration counts, the fine level's halo metadata and the L2 error
    of the sharded solution."""
    from polydeal_tpu_torch.postprocess import compute_global_error
    from polydeal_tpu_torch.solvers.cg import cg_solve

    mg_kw = {k: case[k] for k in ("chebyshev_degree", "n_smooth")
             if k in case}
    hf, A, b, mg = flat_problem(case["n"], device=device, **mg_kw)
    rtol, maxiter = case.get("rtol", 1e-9), case.get("maxiter", 100)
    pre = case.get("precondition", True)
    ss = ShardedSystem.from_multigrid(mg, group)
    x, k, res = ss.solve_cg(b, rtol=rtol, maxiter=maxiter, precondition=pre)
    host = (mg.solve_cg(b, rtol=rtol, maxiter=maxiter) if pre
            else cg_solve(A.matvec, b, rtol=rtol, maxiter=maxiter))
    fine = ss.levels[-1]
    return dict(n_dev=ss.n_dev, iterations=k, residual=res,
                x=x.cpu().numpy(), host_iterations=host.iterations,
                x_host=host.x.cpu().numpy(),
                fine=dict(rows_per_shard=fine.rows_per_shard,
                          n_rows_pad=fine.n_rows_pad, deltas=fine.deltas,
                          n_sends=fine.n_sends,
                          nested_transfer=fine.nested_transfer),
                l2=float(compute_global_error(hf, x, _u_exact)[0]))


def packed_problem(device, near_limit):
    """(handlers, b, mg) of the dry run's problem: the R-tree hierarchy on
    ``hyper_cube(2, 16)``, p=1, f64, banded level assembly, every level of
    a multiple of 128 polytopes packed with ``pack_near_limit=
    near_limit(P)`` (P: the fine polytopes), so that the fine pack's
    offsets beyond it form a far block-COO tail."""
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator
    from polydeal_tpu_torch.assembly.sipg import (
        assemble_rhs,
        assemble_sipg_banded_direct,
        build_banded_groups,
    )
    from polydeal_tpu_torch.mesh import hyper_cube

    f64 = torch.float64
    mesh = hyper_cube(2, 16)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    handlers, parents = multigrid.build_rtree_hierarchy(
        mesh, agg, list(range(1, agg.n_levels - 1)), degree=1)
    ah = handlers[-1]
    offs = multigrid.band_offsets(ah)
    groups = build_banded_groups(ah, offs, f64, device=device)
    A = assemble_sipg_banded_direct(ah, groups, offs)
    del groups
    b = assemble_rhs(ah, _f_poisson, _u_exact, dtype=f64, device=device)
    mg = multigrid.build_multigrid(
        handlers, parents, A, dtype=f64, level_assembly="banded", pack=True,
        pack_near_limit=near_limit(ah.n_poly), device=device)
    return handlers, b, mg


def dryrun(device, group) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip`` on this
    rank: the R-tree hierarchy on ``hyper_cube(2, 16)``, p=1, f64, banded
    level assembly, every level of a multiple of 128 polytopes packed with
    ``pack_near_limit=max(per // 2, 4)`` (per: the fine lanes a rank), the
    packed fine level sharded over ``group`` and held to the host solve
    (rtol 1e-8: the same iterations, x within 1e-9, the residual at most
    1e-8 |b|); then the flat block-COO ``ShardedSystem`` on the 2D n=8
    problem (f32, table assembly) at rtol 1e-6 (the same iterations, x
    within 1e-4).  Raises on a failed hold; returns the numbers, with
    ``comm_bytes_per_spmv(8)``."""
    from polydeal_tpu_torch.sparse import BlockPacked

    _build_prepare(device)
    n_dev = 1 if group is None else torch.distributed.get_world_size(group)
    handlers, b, mg = packed_problem(
        device, lambda P: max(P // n_dev // 2, 4))
    fine = mg.ells[-1]
    if not isinstance(fine, BlockPacked):
        raise RuntimeError("dryrun: the fine level is not packed")
    host = mg.solve_cg(b, rtol=1e-8, maxiter=60)
    ss = ShardedBandedSystem.from_multigrid(mg, group)
    x, iters, res = ss.solve_cg(b, rtol=1e-8, maxiter=60)
    diff = float((x - host.x).abs().max())
    bnorm = float(b.norm())
    out = dict(n_dev=n_dev, levels=[h.n_poly for h in handlers],
               fine_has_far=fine._has_far(), meta=level_meta(ss),
               iterations=iters, host_iterations=host.iterations,
               max_abs_diff=diff, residual=res, bnorm=bnorm,
               comm=ss.comm_bytes_per_spmv(dtype_bytes=8))
    if iters != host.iterations or not diff <= 1e-9 or not (
            res <= 1e-8 * bnorm):
        raise RuntimeError(f"dryrun: the sharded packed solve misses the "
                           f"host solve: {out}")

    # the flat block-COO path (the JAX dryrun's _build_problem(2, 8, 1):
    # table assembly, f32)
    _, _, b2, mg2 = flat_problem(8, device=device, dtype=torch.float32)
    ss2 = ShardedSystem.from_multigrid(mg2, group)
    x2, it2, _ = ss2.solve_cg(b2, rtol=1e-6, maxiter=40)
    r2 = mg2.solve_cg(b2, rtol=1e-6, maxiter=40)
    diff2 = float((x2 - r2.x).abs().max())
    out.update(flat_iterations=it2, flat_host_iterations=r2.iterations,
               flat_max_abs_diff=diff2,
               flat_halo_rows=sum(ss2.levels[-1].n_sends))
    if it2 != r2.iterations or not diff2 <= 1e-4:
        raise RuntimeError(f"dryrun: the flat sharded solve misses the host "
                           f"solve: {out}")
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
        leave_group()
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
    ap.add_argument("--local", action="store_true",
                    help="build each rank's share shard-locally and hold it "
                         "to the share of the whole setup")
    ap.add_argument("--dryrun", action="store_true",
                    help="the multi-rank dry run (2D packed R-tree f64 and "
                         "the flat block-COO solve) instead")
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.nproc:
        raise SystemExit(f"sharded: {args.nproc} ranks need {args.nproc} "
                         f"CUDA devices, found {torch.cuda.device_count()}")
    case = dict(n=args.n, hierarchy=args.hierarchy,
                relabel=None if args.relabel == "none" else "lex",
                dtype="float32", precond_dtype="bfloat16", rtol=1e-8,
                timed=True)
    # the eager and the captured sharded solve (eager_and_graph)
    both = ("eager_iterations", "graph_iterations", "captured",
            "graph_eager_diff", "sharded_eager_ms", "sharded_ms", "replays",
            "host_reads", "capture_s", "pool_mb")
    keep = ("n_dofs", "levels", "n_dev", "meta", "comm", "iterations",
            "unsharded_iterations", "residual", "bnorm", "max_abs_diff",
            "unsharded_ms", "ratio") + both
    if args.dryrun:
        case = dict(kind="dryrun")
        keep = ("n_dev", "levels", "fine_has_far", "meta", "iterations",
                "host_iterations", "max_abs_diff", "residual", "bnorm",
                "comm", "flat_iterations", "flat_host_iterations",
                "flat_max_abs_diff", "flat_halo_rows")
    elif args.local:
        case = dict(case, kind="local")
        keep = ("n_dev", "meta", "iterations", "iterations_global",
                "residual", "bnorm", "max_abs_diff", "lam_rel", "b_diff",
                "slabs_equal", "global_lanes", "rep_levels",
                "table_bytes") + both
    (r,) = spawn(args.nproc, [case], device=args.device, timeout=3000.0)
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
