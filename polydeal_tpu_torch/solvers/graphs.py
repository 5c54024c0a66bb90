"""Captured programs: the counterpart of ``jax.jit``'s program cache for
the solves.

The JAX package runs each solve as one device program: ``cg_solve`` is a
``lax.while_loop`` (``polydeal_tpu/solvers/cg.py``), the monodomain step a
jitted program and its time loop a ``lax.scan``.  Here a solve on the card
is a few ``torch.cuda.CUDAGraph``s over static buffers:

* :func:`capture` records one program: a warm-up run on a side stream
  first (it builds and loads the kernel library, makes each band's kept
  launch arguments and reads host-side offsets, all outside the capture),
  then the capture into a pool the caller shares between its programs.  A
  capture that fails raises; nothing falls back to the eager loop.
* Launch accounting: the wrappers count their launches in Python
  (``ops/_build.launches``), so a capture counts what it records and a
  replay counts nothing.  :func:`capture` takes each counter's change
  during the capture back out and :meth:`Program.replay` adds it once a
  replay, so the counts read as for the eager solve (warm-up runs count:
  they launch).
* :class:`CGLoop` is CG as captured programs: static ``(x, r, p, rz, k,
  active)`` buffers, start programs that fill them (``cg_init`` on a
  right-hand side the program computes) and one program of one masked
  ``cg_body`` iteration.  :meth:`CGLoop.run` replays the body back to back
  and reads the ``active`` flag of body *i* through pinned memory and an
  event only after it has queued body *i + 1* where more are queued, so
  the device does not wait for the host inside a solve.  It starts each
  solve by queuing as many bodies as the previous solve took; past that it
  keeps one body ahead.  Bodies queued after convergence are masked:
  no-ops on the state that still cost device time, counted in
  ``last["masked"]``.
* :class:`GMRESLoop` is GMRES (``solvers/gmres``) as three captured
  programs on one static ``GMRESState``: a restart cycle's start, one
  masked Arnoldi step and the cycle's end.  :meth:`GMRESLoop.solve` queues
  the steps of a cycle as :meth:`CGLoop.run` queues bodies (as many as the
  same cycle of the previous solve took, then one ahead), and reads the
  outer loop's condition once a cycle, after the cycle's end.

CUDA's conditional WHILE nodes would be the exact counterpart of
``while_loop`` (no host read at all); they are not used yet.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from polydeal_tpu_torch.ops import _build
from polydeal_tpu_torch.solvers.cg import CGState, cg_body, cg_init
from polydeal_tpu_torch.solvers.gmres import (
    GMRESResult,
    gmres_cycle_end,
    gmres_cycle_start,
    gmres_init,
    gmres_reset,
    gmres_step,
)

__all__ = ["Program", "capture", "CGLoop", "GMRESLoop"]


class Program:
    """One captured program and the kernel launches one replay makes."""

    def __init__(self, graph, launches: dict, seconds: float,
                 pool_bytes: int):
        self.graph = graph
        self.launches = launches
        self.seconds = seconds  # warm-up and capture, host clock
        self.pool_bytes = pool_bytes  # device memory the capture reserved

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            _build.launches[k] += n


def capture(compute: Callable | None, commit: Callable, *, device,
            pool) -> Program:
    """Capture ``commit(compute())`` as one program on ``device``.

    ``compute`` reads static buffers and returns new tensors (it may write
    buffers that only it writes); ``commit`` copies them into the static
    buffers the next program reads.  ``compute`` runs once on a side stream
    first, without ``commit``, so the warm-up leaves the state as it was
    (and makes the NCCL communicators its collectives use).  ``pool`` is a
    ``torch.cuda.graph_pool_handle()`` shared by the programs that replay
    in turn on one stream.  The capture checks only this thread's CUDA
    calls (``capture_error_mode="thread_local"``): a process group's
    NCCL watchdog thread queries the events of earlier work, which under
    ``"global"`` would invalidate a capture, and this thread makes every
    call that goes into the program."""
    device = torch.device(device)
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        if compute is not None:
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                compute()
            cur.wait_stream(side)
        torch.cuda.synchronize(device)
        before = dict(_build.launches)
        # torch.cuda.graph empties the cache before it captures: do it
        # here, so that the reserved bytes' growth is the capture's
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool,  # raises on failure
                                  capture_error_mode="thread_local"):
                commit(None if compute is None else compute())
        finally:
            delta = {k: _build.launches[k] - n for k, n in before.items()
                     if _build.launches[k] != n}
            _build.launches.update(before)
        torch.cuda.synchronize(device)
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
    return Program(graph, delta, time.perf_counter() - t0, pool_bytes)


def _copy_state(dst: CGState, src: CGState) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class CGLoop:
    """CG (``solvers/cg``) on static buffers as captured programs.

    ``A`` and ``M`` act on tensors like ``like`` (shape, dtype, device);
    ``rtol``, ``atol`` and ``maxiter`` are fixed in the programs, as they
    are static arguments of the JAX package's jitted solves.  Start
    programs come from :meth:`start_program`; :meth:`run` replays one of
    them and then the body until CG stops.  After a run, ``state`` holds
    the result (the next run overwrites it) and ``last`` what the run
    cost: ``iterations``, ``replays`` (bodies queued), ``masked``
    (``replays - iterations``) and ``host_reads`` (event waits);
    ``total`` sums them over every run, with ``runs``."""

    def __init__(self, A: Callable, M: Callable | None, like: torch.Tensor,
                 *, rtol: float, maxiter: int, atol: float = 0.0,
                 dot: Callable | None = None):
        if like.device.type != "cuda":
            raise ValueError(f"captured programs need a CUDA tensor, not "
                             f"one on {like.device}")
        self.A, self.M, self.dot = A, M, dot
        self.rtol, self.atol, self.maxiter = rtol, atol, maxiter
        self.device = like.device
        self.pool = torch.cuda.graph_pool_handle()
        zeros = lambda **kw: torch.zeros((), device=self.device, **kw)
        self.state = CGState(
            torch.zeros_like(like), torch.zeros_like(like),
            torch.zeros_like(like), zeros(dtype=like.dtype),
            zeros(dtype=torch.int32), zeros(dtype=torch.bool))
        self.tol = zeros(dtype=like.dtype)
        self.body = None
        self.captured = []  # every Program of this loop, starts and body
        # flags[j]: the state's active after j bodies (0: after the start)
        self._flags = torch.zeros(maxiter + 1, dtype=torch.bool,
                                  pin_memory=True)
        self._events = [torch.cuda.Event() for _ in range(maxiter + 1)]
        self.n_pred = 0
        self.last = {}
        self.total = dict.fromkeys(("runs", "iterations", "replays",
                                    "masked", "host_reads"), 0)

    def start_program(self, rhs: Callable,
                      x0: Callable | None = None) -> Program:
        """Capture ``b = rhs()`` (static inputs to the right-hand side in
        the loop's layout) and ``cg_init`` from it, starting from ``x0(b)``
        when given (e.g. an FMG guess), else from zero."""

        def compute():
            b = rhs()
            return cg_init(self.A, b, None if x0 is None else x0(b), self.M,
                           self.rtol, self.atol, self.maxiter, self.dot)

        def commit(out):
            st, tol = out
            _copy_state(self.state, st)
            self.tol.copy_(tol)

        prog = capture(compute, commit, device=self.device, pool=self.pool)
        self.captured.append(prog)
        return prog

    def _capture_body(self) -> Program:
        prog = capture(
            lambda: cg_body(self.A, self.M, self.state, self.tol,
                            self.maxiter, self.dot),
            lambda st: _copy_state(self.state, st), device=self.device,
            pool=self.pool)
        self.captured.append(prog)
        return prog

    def _queue(self, program: Program, j: int) -> None:
        program.replay()
        self._flags[j].copy_(self.state.active, non_blocking=True)
        self._events[j].record()

    def run(self, start: Program) -> int:
        """Replay ``start``, then the body until CG stops; returns the
        iterations (read from the flags: no other host read)."""
        if self.body is None:
            self.body = self._capture_body()
        with torch.cuda.device(self.device):
            self._queue(start, 0)
            queued, n, reads = 0, 0, 0
            pred = min(self.n_pred, self.maxiter)

            def queue_to(m):
                nonlocal queued
                while queued < min(m, self.maxiter):
                    queued += 1
                    self._queue(self.body, queued)

            queue_to(pred)
            while True:
                self._events[n].synchronize()
                reads += 1
                if not bool(self._flags[n]):
                    break
                n += 1
                # body n is needed; past the prediction keep one ahead
                queue_to(n + 1 if n > pred else n)
        self.n_pred = n
        self.last = dict(iterations=n, replays=queued, masked=queued - n,
                         host_reads=reads)
        self.total["runs"] += 1
        for k, v in self.last.items():
            self.total[k] += v
        return n


class GMRESLoop:
    """GMRES(``restart``) (``solvers/gmres``) on static buffers as captured
    programs: the cycle's start, one masked Arnoldi step and the cycle's
    end, all three captured at the first solve, before it resets the
    state (their warm-ups run on that state), in one shared pool.

    ``A`` and ``M`` act on vectors like ``like``; ``rtol`` and
    ``max_restarts`` are fixed as in :func:`gmres_solve`.  After a solve,
    ``last`` holds what it cost: ``iterations``, ``replays`` (steps
    queued), ``masked`` (``replays - iterations``), ``cycles`` and
    ``host_reads`` (event waits: each queued step's condition that the
    host needed, and the outer condition after the reset and after each
    cycle); ``total`` sums them over every solve, with ``runs``."""

    def __init__(self, A: Callable, M: Callable | None, like: torch.Tensor,
                 *, restart: int, rtol: float, max_restarts: int):
        if like.device.type != "cuda":
            raise ValueError(f"captured programs need a CUDA tensor, not "
                             f"one on {like.device}")
        self.A, self.M = A, M
        self.restart, self.rtol, self.max_restarts = (restart, rtol,
                                                      max_restarts)
        self.device = like.device
        self.pool = torch.cuda.graph_pool_handle()
        self.b = torch.zeros_like(like)
        self.state = gmres_init(like, restart)
        self.programs = None  # (cycle start, step, cycle end)
        self.captured = []
        # flags[j]: the cycle's active after j steps (0: after its start)
        self._flags = torch.zeros(restart + 1, dtype=torch.bool,
                                  pin_memory=True)
        self._events = [torch.cuda.Event() for _ in range(restart + 1)]
        self._go = torch.zeros((), dtype=torch.bool, pin_memory=True)
        self._res = torch.zeros((), dtype=like.dtype, pin_memory=True)
        self._end = torch.cuda.Event()
        self.pred = []  # the steps of each cycle of the previous solve
        self.last = {}
        self.total = dict.fromkeys(("runs", "iterations", "replays",
                                    "masked", "cycles", "host_reads"), 0)

    def _capture(self) -> None:
        st = self.state
        self.programs = [
            capture(fn, lambda _: None, device=self.device, pool=self.pool)
            for fn in (lambda: gmres_cycle_start(self.A, self.b, st),
                       lambda: gmres_step(self.A, self.M, st),
                       lambda: gmres_cycle_end(st, self.max_restarts))]
        self.captured.extend(self.programs)

    def _read_go(self) -> bool:
        self._go.copy_(self.state.go, non_blocking=True)
        self._res.copy_(self.state.res, non_blocking=True)
        self._end.record()
        self._end.synchronize()
        return bool(self._go)

    def solve(self, b: torch.Tensor,
              x0: torch.Tensor | None = None) -> GMRESResult:
        """GMRES on A x = b from ``x0`` (zero when None); ``x`` of the
        result is a copy (the next solve overwrites the state)."""
        if self.programs is None:
            self._capture()
        start, step, end = self.programs
        st, m = self.state, self.restart
        with torch.cuda.device(self.device):
            self.b.copy_(b)
            gmres_reset(st, self.b, x0, self.rtol, self.max_restarts)
            go, reads, replays, cycles = self._read_go(), 1, 0, []
            while go:
                start.replay()
                self._flags[0].copy_(st.active, non_blocking=True)
                self._events[0].record()
                c = len(cycles)
                pred = min(self.pred[c] if c < len(self.pred) else 0, m)
                queued, n = 0, 0

                def queue_to(k):
                    nonlocal queued
                    while queued < min(k, m):
                        queued += 1
                        step.replay()
                        self._flags[queued].copy_(st.active,
                                                  non_blocking=True)
                        self._events[queued].record()

                queue_to(pred)
                while True:
                    self._events[n].synchronize()
                    reads += 1
                    if not bool(self._flags[n]):
                        break
                    n += 1
                    # step n is needed; past the prediction keep one ahead
                    queue_to(n + 1 if n > pred else n)
                end.replay()
                go = self._read_go()
                reads += 1
                cycles.append(n)
                replays += queued
        self.pred = cycles
        its = sum(cycles)
        self.last = dict(iterations=its, replays=replays,
                         masked=replays - its, cycles=len(cycles),
                         host_reads=reads)
        self.total["runs"] += 1
        for k, v in self.last.items():
            self.total[k] += v
        return GMRESResult(x=st.x.clone(), iterations=its,
                           residual=float(self._res))
