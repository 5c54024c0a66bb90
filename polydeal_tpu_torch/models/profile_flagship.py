"""Where the flagship solve's, or the monodomain step's, time goes on a
CUDA card.

Run from the root of a checkout, on a machine with a CUDA card::

    python -m polydeal_tpu_torch.models.profile_flagship [--relabel none]
    python -m polydeal_tpu_torch.models.profile_flagship --model monodomain
    python -m polydeal_tpu_torch.models.profile_flagship --model mono2d \
        [--relabel none]
    python -m polydeal_tpu_torch.models.profile_flagship --model oseen
    python -m polydeal_tpu_torch.models.profile_flagship --model darcy
    python -m polydeal_tpu_torch.models.profile_flagship --model amg

Sets the flagship (n=64, p=1) up on ``cuda:0`` -- with ``--relabel none``
without the lex relabel, so the fine level and levels 4096 and 32768 are
packed and run K6/K7 -- and measures, in one process, each solve both
ways: through the eager loop (``capture=False``) and as captured programs
(``solvers/graphs``, the default on the card):

* warm solves on the host clock (synchronised): two warm-ups each, then
  11 timed solves each, in turns (median and range);
* the captured loop's cost: bodies run and host reads of the last
  solve, capture seconds, the graph pool's MB;
* parts by CUDA events, 20 calls each: one V-cycle (the CG
  preconditioner), one fine-level SpMV (the CG operator), one FMG guess;
  and, 5 calls, the warm fine-level band assembly from its f32 tables
  (K3-K5 and the lane rolls and concatenations around them);
* one traced warm eager solve under ``torch.profiler`` (the captured solve
  is one device program whose WHILE bodies the profiler cannot trace):
  the device's busy
  time (the union of its kernel, copy and fill intervals) over the solve's
  span in the same trace, hence the busy and idle shares; the number of
  device operations (launches, copies and fills); and the device
  operations by total time (K2's name carries its lanes per thread, so
  the fine and the 32768-lane level read apart).  The profiler slows the
  host's dispatch, so a traced eager solve is slower than the untimed ones
  and its idle share is an upper bound for them;
* one traced warm fine-level band assembly (straight into the packed
  format when the fine level is packed), read the same way.

With ``--model monodomain`` it sets up ``bench.py``'s bench_monodomain
configuration (n_refinements=6, 1,048,576 DoF, lex relabel) instead and
measures, both ways: the 20 warm BDF2 steps after the BDF1 one through
``steps_scan`` on the host clock (synchronised; two warm-up passes, then
11 timed, in turns) with the CG iterations of every step; one traced warm
BDF2 step, read as the traced solve above; and one V-cycle and one
fine-level SpMV by CUDA events.  ``--model mono2d`` measures the same
for the 2D high-order monodomain of ``chip_smoke.py`` phase 17
(``MonodomainConfig(dim=2, n_refinements=9, degree=4)``, 3,932,160 DoF,
the command line's defaults otherwise; ``--relabel none`` for its packed
arm), where K5 computes the boundary blocks.

With ``--model oseen`` it sets up the Oseen (Kovasznay) system at n=64
and its field-wise R3MG preconditioner (``models/oseen.py``, the
MG-GMRES of ``chip_smoke.py`` phase 10, rtol 1e-11) and measures the
GMRES solve both ways (``gmres_solve(capture=False)`` against one
``solvers/graphs.GMRESLoop``); ``--model darcy`` the same for the
Stokes-Darcy MG-GMRES at n=64 (``models/darcy_stokes.py``, phase 10's
triangular field-block preconditioner); with ``--model amg`` the SA-AMG
CG solve
(``AMG.solve_cg``) of the n=64 3D p=1 COO Poisson system (1,048,576 DoF,
phase 9's; its host setup ~20 s).  Each: the preconditioner's setup
seconds, warm solves on the host clock (one warm-up each, then
``REPEATS_SLOW`` in turns), the captured loop's cost, one preconditioner
application and one operator application by CUDA events, and one traced
warm solve each.

Prints the card and a table, and last one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

__all__ = ["busy_us", "traced_span", "device_intervals", "main",
           "profile_flagship", "profile_monodomain", "profile_oseen",
           "profile_darcy", "profile_amg"]

_LABEL = "flagship_solve"  # the traced range's record_function label
N = 64
N_STEPS = 20  # monodomain BDF2 steps per timed pass (bench.py's)
REPEATS = 11
REPEATS_SLOW = 5  # the oseen and amg solves (seconds each, eager)
# (name, capture) of the two solve paths: the eager loop and the captured
# programs (solvers/graphs), the default on the card
MODES = (("eager", False), ("graph", None))


def busy_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of the [start, end) ``intervals`` clipped to
    [lo, hi]: the time at least one of them was running."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def traced_span(events, label: str) -> tuple:
    """(start_us, end_us) of the host-side ``record_function`` range
    ``label`` in a profiler trace's events (``kineto_results.events()``,
    read as they are: a solve of a million launches makes no Python event
    tree); it must occur once."""
    span = [e for e in events if e.name() == label
            and e.device_type() == torch.autograd.DeviceType.CPU]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} ranges {label!r} in the trace")
    return span[0].start_ns() / 1e3, span[0].end_ns() / 1e3


def device_intervals(events, label: str):
    """(name, start_us, end_us) of every device-side event of a profiler
    trace (kernels, copies, fills), leaving out the device-side copy of
    the ``record_function`` range ``label``, which spans them all."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in events if e.device_type() == cuda and e.name() != label]


def _cuda_ms(fn, reps: int = 20) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _traced(fn, top: int | None):
    """Trace one call of ``fn`` under ``torch.profiler``: (span_ms,
    busy_ms, device operations (launches, copies and fills), the ``top``
    device operations by total time as dicts; every one with
    ``top=None``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(_LABEL):
            fn()
            torch.cuda.synchronize()  # the range spans fn's device work
    events = prof.profiler.kineto_results.events()
    lo, hi = traced_span(events, _LABEL)
    dev_ev = device_intervals(events, _LABEL)
    if not dev_ev:
        raise RuntimeError("the trace holds no device events")
    busy = busy_us([(s, e) for _, s, e in dev_ev], lo, hi)
    by_name = {}
    for name, s, e in dev_ev:
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + (e - s))
    dev_sum = sum(t for _, t in by_name.values())
    ops = [dict(name=n[:100], count=c, ms=t / 1e3, share=t / dev_sum)
           for n, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:top]]
    return (hi - lo) / 1e3, busy / 1e3, len(dev_ev), ops


def _print_ops(tables) -> None:
    for title, rows in tables:
        print(f"{'device op, ' + title + ' (first 70 chars)':70s} "
              f"{'count':>6s} {'ms':>9s} {'share':>6s}")
        for d in rows:
            print(f"{d['name'][:70]:70s} {d['count']:6d} {d['ms']:9.3f} "
                  f"{d['share']:6.1%}")


def _modes(run, reps: int = REPEATS, warm: int = 2) -> dict:
    """Host-clock seconds of ``run(capture)`` (synchronised) for the eager
    loop (capture=False) and the captured programs (capture=None), after
    ``warm`` warm-up calls each, ``reps`` calls each in turns."""
    for _, capture in MODES:
        for _ in range(warm):
            run(capture)
    walls = {"eager": [], "graph": []}
    for _ in range(reps):
        for name, capture in MODES:
            t0 = time.perf_counter()
            run(capture)
            walls[name].append(time.perf_counter() - t0)
    return walls


def _spread(walls) -> dict:
    return dict(median=statistics.median(walls), min=min(walls),
                max=max(walls))


def _traced_modes(run, top: int) -> dict:
    """One traced call of ``run(capture)`` per mode: span, busy time, busy
    and idle shares, device operations and the ``top`` ones by time.  The
    captured solve is one device program whose loops are WHILE nodes: the
    profiler drops the records of kernels inside them, so that mode is
    not traced."""
    out = {}
    for name, capture in MODES:
        if capture is None:
            out[name] = dict(not_traced="one device program (WHILE "
                             "nodes): the profiler cannot trace it",
                             top_ops=[])
            continue
        span, busy, n_ops, ops = _traced(lambda: run(capture), top=top)
        out[name] = dict(span_ms=span, busy_ms=busy, busy_share=busy / span,
                         idle_share=1.0 - busy / span, device_ops=n_ops,
                         top_ops=ops)
    return out


def profile_monodomain(dev, smi: str, cfg=None, relabel="lex") -> dict:
    """The monodomain's numbers (see the module docstring): at ``cfg``
    (default ``bench_config(6)``) with ``relabel``."""
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)

    cfg = cfg or bench_config(6, N_STEPS)
    s = MonodomainSolver.build(cfg, relabel=relabel, device=dev)
    dt = cfg.dt
    u, w = s.initial_state()
    u1, w1, it1 = s.step(u, u, w, 0.0, True)
    iters = {}

    def steps(capture):
        out = s.steps_scan(u1, u, w1, dt, N_STEPS, capture=capture)
        torch.cuda.synchronize()
        iters[capture] = out[3]
        return out

    walls = _modes(steps)
    mg = s.mg
    parts = dict(v_cycle_ms=_cuda_ms(lambda: mg.v_cycle(u1)),
                 fine_spmv_ms=_cuda_ms(lambda: mg.ells[-1].matvec(u1)))
    traced = _traced_modes(lambda capture: s.step(u1, u, w1, dt, False,
                                                  capture=capture), top=15)
    _print_ops([(f"one BDF2 step, {m}", traced[m]["top_ops"])
                for m, _ in MODES])
    med = {m: statistics.median(v) for m, v in walls.items()}
    return dict(
        card=smi, model="monodomain", dim=cfg.dim, degree=cfg.degree,
        n_refinements=cfg.n_refinements, n_dofs=s.handler.n_dofs,
        levels=[e.n_block_rows for e in mg.ells], relabel=relabel,
        n_steps=N_STEPS, iterations_per_step=[it1] + list(iters[None]),
        iterations_per_step_eager=[it1] + list(iters[False]),
        cg_iters_per_step=sum(iters[None]) / N_STEPS,
        setup_phases_s=s.setup_phases,
        warm_steps_s={m: _spread(v) for m, v in walls.items()},
        step_ms={m: v / N_STEPS * 1e3 for m, v in med.items()},
        steps_per_s={m: N_STEPS / v for m, v in med.items()},
        dof_steps_per_s={m: s.handler.n_dofs * N_STEPS / v
                         for m, v in med.items()},
        **parts, traced_step=traced)


def _graph_cost(loop) -> dict:
    """A captured loop's last solve and its programs' capture seconds and
    pool MB."""
    return dict(loop.last, capture_s=sum(p.seconds for p in loop.captured),
                pool_mb=sum(p.pool_bytes for p in loop.captured) / 2**20)


def _solve_modes(solve, loop, setup_s, parts, extra) -> dict:
    """The numbers of a solve measured both ways: ``solve(capture)``
    returns its iterations; ``loop`` serves the captured solves."""
    iters = {}

    def run(capture):
        iters[capture] = solve(capture)
        torch.cuda.synchronize()

    walls = _modes(run, reps=REPEATS_SLOW, warm=1)
    cost = _graph_cost(loop)
    traced = _traced_modes(run, top=15)
    _print_ops([(f"solve, {m}", traced[m]["top_ops"]) for m, _ in MODES])
    return dict(extra, iterations=iters[None], iterations_eager=iters[False],
                setup_s=setup_s,
                warm_solve_s={m: _spread(v) for m, v in walls.items()},
                graph_cost=cost, **parts, traced_solve=traced)


def profile_oseen(dev, smi: str, n: int = N) -> dict:
    """The oseen MG-GMRES numbers (see the module docstring)."""
    from polydeal_tpu_torch.models import oseen as os_
    from polydeal_tpu_torch.solvers.gmres import gmres_solve
    from polydeal_tpu_torch.solvers.graphs import GMRESLoop

    space, _, meta = os_.run(n, 2, device=dev)
    op, rhs = meta["system"]
    A = os_._regularized(space, op, meta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = os_.oseen_mg_preconditioner(space, op, meta, os_._rectangle(n), n,
                                    2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(restart=200, rtol=1e-11, max_restarts=40)
    loop = GMRESLoop(A, M, rhs, **kw)

    def solve(capture):
        if capture is None:
            return loop.solve(rhs).iterations
        return gmres_solve(A, rhs, M=M, capture=False, **kw).iterations

    parts = dict(precond_ms=_cuda_ms(lambda: M(rhs)),
                 operator_ms=_cuda_ms(lambda: A(rhs)))
    return _solve_modes(solve, loop, setup_s, parts, dict(
        card=smi, model="oseen", n=n, n_dofs=space.n_dofs,
        levels={deg: [e.n_block_rows for e in mg.ells]
                for deg, mg in M.mgs.items()}))


def profile_darcy(dev, smi: str, n: int = N) -> dict:
    """The darcy_stokes MG-GMRES numbers (see the module docstring)."""
    from polydeal_tpu_torch.mesh import hyper_cube
    from polydeal_tpu_torch.models import darcy_stokes as ds
    from polydeal_tpu_torch.solvers.gmres import gmres_solve
    from polydeal_tpu_torch.solvers.graphs import GMRESLoop

    s, _ = ds.run(n, 2, device=dev)
    A, rhs = ds._regularized(s), s.rhs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = ds.mg_block_preconditioner(s, hyper_cube(2, n), n, 2,
                                   ps_mode="mass+stab", structure="tri")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(restart=200, rtol=1e-11, max_restarts=40)
    loop = GMRESLoop(A, M, rhs, **kw)

    def solve(capture):
        if capture is None:
            return loop.solve(rhs).iterations
        return gmres_solve(A, rhs, M=M, capture=False, **kw).iterations

    parts = dict(precond_ms=_cuda_ms(lambda: M(rhs)),
                 operator_ms=_cuda_ms(lambda: A(rhs)))
    return _solve_modes(solve, loop, setup_s, parts, dict(
        card=smi, model="darcy", n=n, n_dofs=s.space.n_dofs,
        levels={f: [e.n_block_rows for e in mg.ells]
                for f, mg in M.mgs.items() if hasattr(mg, "ells")}))


def profile_amg(dev, smi: str, n: int = N) -> dict:
    """The SA-AMG CG numbers (see the module docstring)."""
    from polydeal_tpu_torch.models.poisson import solve_poisson

    rp = solve_poisson(dim=3, n=n, degree=1, solver="amg", device=dev,
                       verbose=False)  # a captured solve: the loop exists
    A, b, amg = rp["A"], rp["b"], rp["amg"]
    loop = amg._loops[(1e-9, 300, b.dtype)][0]

    def solve(capture):
        return amg.solve_cg(b, rtol=1e-9, capture=capture).iterations

    parts = dict(v_cycle_ms=_cuda_ms(lambda: amg.v_cycle(b)),
                 fine_spmv_ms=_cuda_ms(lambda: A.matvec(b)))
    return _solve_modes(solve, loop, rp["t_precond"], parts, dict(
        card=smi, model="amg", n=n, n_dofs=int(b.shape[0]),
        levels=[m.shape[0] for m in amg.As]))


def profile_flagship(dev, smi: str, relabel) -> dict:
    """The flagship's numbers (see the module docstring)."""
    from polydeal_tpu_torch.assembly.sipg import (
        assemble_sipg_banded_direct, build_banded_groups)
    from polydeal_tpu_torch.models.flagship import (setup_flagship,
                                                    solve_flagship)

    fs = setup_flagship(n=N, device=dev, relabel=relabel)
    mg = fs.mg
    nb = mg.ells[-1].n_basis
    bt = fs.b.reshape(-1, nb).T.contiguous()

    iters = {}

    def solve(capture):
        res = solve_flagship(fs, capture=capture)
        torch.cuda.synchronize()
        iters[capture] = res.iterations
        return res

    walls = _modes(solve)
    graph_cost = _graph_cost(mg.cg_loop(1e-8, 100, fs.b.dtype))
    parts = dict(v_cycle_ms=_cuda_ms(lambda: mg.v_cycle(fs.b)),
                 fine_spmv_ms=_cuda_ms(lambda: mg.ells[-1].matvec_t(bt)),
                 fmg_ms=_cuda_ms(lambda: mg.fmg_guess(bt)))
    fine = fs.handlers[-1]
    tabs = build_banded_groups(fine, fs.band_offsets, torch.float32,
                               device=dev)
    A = mg.ells[-1]
    pack = (dict(pack_plan=A.plan, pack_oid=A.oid) if fs.format == "packed"
            else {})
    band = lambda: assemble_sipg_banded_direct(fine, tabs, fs.band_offsets,
                                               **pack)
    parts["fine_band_ms"] = _cuda_ms(band, reps=5)
    band_span, band_busy, _, band_ops = _traced(band, top=8)
    del tabs

    traced = _traced_modes(solve, top=15)

    _print_ops([(f"solve, {m}", traced[m]["top_ops"]) for m, _ in MODES]
               + [("fine band assembly", band_ops)])
    return dict(
        card=smi, model="flagship", n=N, n_dofs=fs.n_dofs,
        levels=fs.level_sizes,
        relabel=fs.relabel, fine_format=fs.format,
        iterations=iters[None], iterations_eager=iters[False],
        setup_phases_s=fs.setup_phases,
        warm_solve_s={m: _spread(v) for m, v in walls.items()},
        graph_cost=graph_cost, **parts, traced_solve=traced,
        traced_band_ms=band_span, traced_band_busy_ms=band_busy,
        band_device_ops=band_ops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("flagship", "monodomain", "mono2d",
                                        "oseen", "darcy", "amg"),
                    default="flagship")
    ap.add_argument("--relabel", choices=("lex", "none"), default="lex",
                    help="the hierarchy's numbering (none: packed levels)")
    args = ap.parse_args(argv)
    relabel = None if args.relabel == "none" else "lex"
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.model == "monodomain":
        out = profile_monodomain(dev, smi)
    elif args.model == "mono2d":
        from polydeal_tpu_torch.config import MonodomainConfig

        out = profile_monodomain(dev, smi, MonodomainConfig(
            dim=2, n_refinements=9, degree=4), relabel)
    elif args.model == "oseen":
        out = profile_oseen(dev, smi)
    elif args.model == "darcy":
        out = profile_darcy(dev, smi)
    elif args.model == "amg":
        out = profile_amg(dev, smi)
    else:
        out = profile_flagship(dev, smi, relabel)
    ph = out.get("setup_phases_s")
    if ph is not None:
        print(f"first use, before and outside the setup phases (s): "
              f"kernel_load {ph['kernel_load']:.3f}, cuda_init "
              f"{ph['cuda_init']:.3f}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
