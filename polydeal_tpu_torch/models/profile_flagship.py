"""Where the flagship solve's, or the monodomain step's, time goes on a
CUDA card.

Run from the root of a checkout, on a machine with a CUDA card::

    python -m polydeal_tpu_torch.models.profile_flagship [--relabel none]
    python -m polydeal_tpu_torch.models.profile_flagship --model monodomain

Sets the flagship (n=64, p=1) up on ``cuda:0`` -- with ``--relabel none``
without the lex relabel, so the fine level and levels 4096 and 32768 are
packed and run K6/K7 -- and measures, in one process:

* warm solves on the host clock (synchronised): two warm-ups, then
  five timed solves;
* parts by CUDA events, 20 calls each: one V-cycle (the CG
  preconditioner), one fine-level SpMV (the CG operator), one FMG guess;
  and, 5 calls, the warm fine-level band assembly from its f32 tables
  (K3-K5 and the lane rolls and concatenations around them);
* one traced warm solve under ``torch.profiler``: the device's busy time
  (the union of its kernel, copy and fill intervals) over the solve's span
  in the same trace, hence the busy and idle shares; the number of device
  operations (launches, copies and fills); and the device operations by
  total time (K2's name carries its lanes per thread, so the fine and the
  32768-lane level read apart).  The profiler slows the host's dispatch, so
  the traced solve is slower than the untimed ones and its idle share is
  an upper bound for them;
* one traced warm fine-level band assembly (straight into the packed
  format when the fine level is packed), read the same way.

With ``--model monodomain`` it sets up ``bench.py``'s bench_monodomain
configuration (n_refinements=6, 1,048,576 DoF, lex relabel) instead and
measures: the 20 warm BDF2 steps after the BDF1 one on the host clock
(synchronised; one warm-up pass, then five timed) with the CG iterations
of every step; one V-cycle and one fine-level SpMV by CUDA events; and
one traced warm BDF2 step, read as the traced solve above.

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
           "profile_flagship", "profile_monodomain"]

_LABEL = "flagship_solve"  # the traced range's record_function label
N = 64
N_STEPS = 20  # monodomain BDF2 steps per timed pass (bench.py's)
REPEATS = 5


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
    ``label`` in a profiler trace; it must occur once."""
    span = [e for e in events if e.name == label
            and e.device_type == torch.autograd.DeviceType.CPU]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} ranges {label!r} in the trace")
    return span[0].time_range.start, span[0].time_range.end


def device_intervals(events, label: str):
    """(name, start_us, end_us) of every device-side event of a profiler
    trace (kernels, copies, fills), leaving out the device-side copy of
    the ``record_function`` range ``label``, which spans them all."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in events if e.device_type == cuda and e.name != label]


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


def _traced(fn, top: int):
    """Trace one call of ``fn`` under ``torch.profiler``: (span_ms,
    busy_ms, device operations (launches, copies and fills), the ``top``
    device operations by total time as dicts)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(_LABEL):
            fn()
            torch.cuda.synchronize()  # the range spans fn's device work
    events = prof.events()
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


def profile_monodomain(dev, smi: str) -> dict:
    """The monodomain's numbers (see the module docstring)."""
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)

    cfg = bench_config(6, N_STEPS)
    s = MonodomainSolver.build(cfg, relabel="lex", device=dev)
    dt = cfg.dt
    u, w = s.initial_state()
    u1, w1, it1 = s.step(u, u, w, 0.0, True)

    def steps():
        out = s.steps_scan(u1, u, w1, dt, N_STEPS)
        torch.cuda.synchronize()
        return out

    steps()
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        _, _, _, iters = steps()
        walls.append(time.perf_counter() - t0)
    mg = s.mg
    parts = dict(v_cycle_ms=_cuda_ms(lambda: mg.v_cycle(u1)),
                 fine_spmv_ms=_cuda_ms(lambda: mg.ells[-1].matvec(u1)))
    span, busy, n_ops, ops = _traced(lambda: s.step(u1, u, w1, dt, False),
                                     top=15)
    med = statistics.median(walls)
    _print_ops([("one BDF2 step", ops)])
    return dict(
        card=smi, model="monodomain", n_dofs=s.handler.n_dofs,
        levels=[e.n_block_rows for e in mg.ells], relabel="lex",
        n_steps=N_STEPS, iterations_per_step=[it1] + list(iters),
        cg_iters_per_step=sum(iters) / N_STEPS,
        setup_phases_s=s.setup_phases, warm_steps_s=walls,
        warm_steps_median_s=med, steps_per_s=N_STEPS / med,
        dof_steps_per_s=s.handler.n_dofs * N_STEPS / med, **parts,
        traced_step_ms=span, traced_busy_ms=busy,
        traced_busy_share=busy / span, traced_idle_share=1.0 - busy / span,
        traced_device_ops=n_ops, device_ops=ops)


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

    def solve():
        res = solve_flagship(fs)
        torch.cuda.synchronize()
        return res

    for _ in range(2):
        solve()
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        res = solve()
        walls.append(time.perf_counter() - t0)
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

    span, busy, n_ops, ops = _traced(solve, top=15)

    _print_ops([("solve", ops), ("fine band assembly", band_ops)])
    return dict(
        card=smi, model="flagship", n=N, n_dofs=fs.n_dofs,
        levels=fs.level_sizes,
        relabel=fs.relabel, fine_format=fs.format,
        iterations=res.iterations,
        setup_phases_s=fs.setup_phases,
        warm_solve_s=walls, warm_solve_median_s=statistics.median(walls),
        **parts,
        traced_solve_ms=span, traced_busy_ms=busy,
        traced_busy_share=busy / span, traced_idle_share=1.0 - busy / span,
        traced_device_ops=n_ops, device_ops=ops, traced_band_ms=band_span,
        traced_band_busy_ms=band_busy, band_device_ops=band_ops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("flagship", "monodomain"),
                    default="flagship")
    ap.add_argument("--relabel", choices=("lex", "none"), default="lex",
                    help="the flagship hierarchy's numbering (none: packed "
                         "levels)")
    args = ap.parse_args(argv)
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
    else:
        out = profile_flagship(dev, smi,
                               None if args.relabel == "none" else "lex")
    ph = out["setup_phases_s"]
    print(f"first use, before and outside the setup phases (s): kernel_load "
          f"{ph['kernel_load']:.3f}, cuda_init {ph['cuda_init']:.3f}",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
