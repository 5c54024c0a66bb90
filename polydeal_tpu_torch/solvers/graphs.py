"""Captured programs: the counterpart of ``jax.jit``'s program cache and of
``lax.while_loop`` for the solves.

The JAX package runs each solve as one device program: ``cg_solve`` is a
``lax.while_loop`` (``polydeal_tpu/solvers/cg.py``), GMRES a ``while_loop``
over restart cycles with the Arnoldi steps inside, the monodomain step a
jitted program and its time loop a ``lax.scan``.  Here a solve on the card
is one CUDA graph built from programs captured by torch:

* :func:`capture` records one program (a ``torch.cuda.CUDAGraph`` kept as
  a graph, ``keep_graph=True``): a warm-up run on a side stream first (it
  builds and loads the kernel library, makes each band's kept launch
  arguments and reads host-side offsets, all outside the capture), then
  the capture into a pool the caller shares between its programs.  A
  capture that fails raises; nothing falls back to the eager loop.
* :class:`LoopProgram` is the device program of a solve: captured
  programs as child graph nodes and loops as conditional WHILE nodes
  (``csrc/graph_loop.cu``).  A loop's body is a captured program followed
  by ``set_condition``, a one-thread kernel that writes the loop's device
  flag (the state's ``active`` or ``go``) into the node's condition, as
  the JAX loop evaluates ``cond`` on the device, and adds one to the
  loop's count of tests, a device counter.  The program is instantiated
  once and launched as one unit; building or instantiating it raises on
  any CUDA error.
* Launch accounting: the wrappers count their launches in Python
  (``ops/_build.launches``), so a capture counts what it records and a
  launch counts nothing.  :func:`capture` takes each counter's change
  during the capture back out.  A solve's one host read takes the
  loops' counts of tests with its result; from them the loop adds each
  program's counts as many times as it ran (a loop tests its condition
  once before its first body and once after each, so the bodies run are
  the tests less the entries) and ``set_condition``'s once a test.  Host
  reads are counted where they are made.
* :class:`CGLoop` is CG as one program a solve: static ``(x, r, p, rz, k,
  active)`` buffers, a start program that fills them (``cg_init`` on a
  right-hand side the program computes), then WHILE(active) { one masked
  ``cg_body`` }.  :meth:`CGLoop.run` launches it and reads ``k``: one host
  read a solve.  The body keeps its mask, so the state is bitwise that of
  the body run to the stop.
* :class:`GMRESLoop` is GMRES (``solvers/gmres``) as one program a solve on
  one static ``GMRESState``: the reset, then WHILE(go) { the cycle's
  start, WHILE(active) { one Arnoldi step }, the cycle's end }: a loop
  inside a loop, as the JAX package's ``fori_loop`` of steps sits inside
  its ``while_loop`` of cycles.  One host read a solve.

Every caller goes through these loops on the card: ``Multigrid.cg_loop``,
``AMG.solve_cg``, the monodomain's step and ``steps_scan`` (one program a
step, launched ``n_steps`` times before the one read) and both sharded
systems at every world size (their exchanges across ranks are the port's
own peer kernels, ``parallel/peer.py``: plain kernel nodes a WHILE body
holds, where NCCL's are not).

Teardown: a program holds raw graph handles and, through ``keep``, the
captured programs whose pool its nodes run in.  :meth:`LoopProgram.close`
synchronises the stream it launched on, destroys the executable graph
and the graph, and only then drops ``keep``; the loops' ``close`` reach
their programs, and the solvers that cache loops (``Multigrid``, ``AMG``,
the monodomain's step programs, the sharded systems) have a ``close``
that reaches their loops.  One ``atexit`` hook closes every program and
loop still open before torch's CUDA state goes away; after it,
``__del__`` closes only what is still open, never during a capture.
"""

from __future__ import annotations

import atexit
import ctypes
import gc
import time
import weakref
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

__all__ = ["Program", "capture", "LoopProgram", "CGLoop", "GMRESLoop",
           "close_all"]


class Program:
    """One captured program and the kernel launches one run of it makes."""

    def __init__(self, graph, launches: dict, seconds: float,
                 pool_bytes: int):
        self.graph = graph
        self.launches = launches
        self.seconds = seconds  # warm-up and capture, host clock
        self.pool_bytes = pool_bytes  # device memory the capture reserved

    def count(self, times: int = 1) -> None:
        """Add the launches of ``times`` runs to the counters."""
        for k, n in self.launches.items():
            _build.launches[k] += n * times

    def replay(self) -> None:
        self.graph.replay()
        self.count()


def capture(compute: Callable | None, commit: Callable, *, device,
            pool) -> Program:
    """Capture ``commit(compute())`` as one program on ``device``.

    ``compute`` reads static buffers and returns new tensors (it may write
    buffers that only it writes); ``commit`` copies them into the static
    buffers the next program reads.  ``compute`` runs once on a side stream
    first, without ``commit``, so the warm-up leaves the state as it was
    (and makes the NCCL communicators its collectives use).  ``pool`` is a
    ``torch.cuda.graph_pool_handle()`` shared by the programs that run in
    turn on one stream.  The capture checks only this thread's CUDA
    calls (``capture_error_mode="thread_local"``): a process group's
    NCCL watchdog thread queries the events of earlier work, which under
    ``"global"`` would invalidate a capture, and this thread makes every
    call that goes into the program.  The graph is kept as a graph
    (``keep_graph=True``), so that :class:`LoopProgram` can put copies of
    it into its nodes."""
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
        graph = torch.cuda.CUDAGraph(keep_graph=True)
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


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _build.load_library().pd_cuda_error_name(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


class _Chain:
    """Nodes added one after another to a graph of the kernel library
    (``csrc/graph_loop.cu``): the outermost graph of a
    :class:`LoopProgram` or a loop's body."""

    def __init__(self, lib, graph, keep: list):
        self.lib, self.graph, self.tail = lib, graph, None
        self.keep = keep  # what the nodes point to, alive with the program

    def _add(self, fn, *args, what: str) -> None:
        node = ctypes.c_void_p()
        _check(fn(self.graph, self.tail, *args, ctypes.byref(node)), what)
        self.tail = node

    def child(self, program: Program) -> None:
        """A copy of ``program``'s graph."""
        self.keep.append(program)
        self._add(self.lib.pd_graph_add_child,
                  ctypes.c_void_p(program.graph.raw_cuda_graph()),
                  what="adding a captured program to a device loop")

    def set_condition(self, handle, flag: torch.Tensor,
                      tests: torch.Tensor) -> None:
        self.keep.extend((flag, tests))
        self._add(self.lib.pd_graph_add_set_condition, handle,
                  ctypes.c_void_p(flag.data_ptr()),
                  ctypes.c_void_p(tests.data_ptr()),
                  what="adding set_condition to a device loop")

    def loop(self, flag: torch.Tensor, body: Callable,
             tests: torch.Tensor) -> None:
        """WHILE(flag) { ``body(chain)`` and set_condition(flag) }, after
        one set_condition(flag) that gives the first test its value; each
        set_condition adds one to ``tests`` (one int64 on the device)."""
        if flag.dtype != torch.bool or flag.numel() != 1:
            raise ValueError("a loop's flag is one bool on the device")
        if tests.dtype != torch.int64 or tests.numel() != 1:
            raise ValueError("a loop's count of tests is one int64 on the "
                             "device")
        handle = ctypes.c_ulonglong()
        _check(self.lib.pd_graph_condition(self.graph, ctypes.byref(handle)),
               "creating a loop condition")
        self.set_condition(handle, flag, tests)
        node, inner = ctypes.c_void_p(), ctypes.c_void_p()
        _check(self.lib.pd_graph_add_while(self.graph, self.tail, handle,
                                           ctypes.byref(node),
                                           ctypes.byref(inner)),
               "adding a WHILE node")
        self.tail = node
        chain = _Chain(self.lib, inner, self.keep)
        body(chain)
        chain.set_condition(handle, flag, tests)


class LoopProgram:
    """One device program: ``build(chain)`` adds captured programs
    (``chain.child``) and loops (``chain.loop``) in order; the graph is
    instantiated once and :meth:`launch` runs it as one unit on the
    device's current stream, with no host read.  :meth:`close` frees it
    (see the module docstring)."""

    def __init__(self, build: Callable, device):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        self._stream = None  # the stream of the last launch
        lib = self._lib = _build.load_library()
        _LIVE.add(self)
        _check(lib.pd_graph_create(ctypes.byref(self._graph)),
               "creating a device loop")
        self.keep = []  # captured programs and flags the nodes point to
        build(_Chain(lib, self._graph, self.keep))
        _check(lib.pd_graph_instantiate(self._graph,
                                        ctypes.byref(self._exec)),
               "instantiating a device loop")

    @property
    def closed(self) -> bool:
        return not (self._exec or self._graph)

    def launch(self) -> None:
        if self.closed:
            raise RuntimeError("launching a closed device loop")
        with torch.cuda.device(self.device):
            self._stream = torch.cuda.current_stream(self.device)
            _check(self._lib.pd_graph_launch(
                self._exec, ctypes.c_void_p(_build.stream_handle(
                    self.device))), "launching a device loop")

    def close(self) -> None:
        """Synchronise the stream of the last launch, destroy the
        executable graph and the graph, then drop ``keep`` (the captured
        programs give their pool back only after that)."""
        if self.closed:
            return
        if self._stream is not None:
            self._stream.synchronize()
        exe, graph = self._exec, self._graph
        self._exec, self._graph = ctypes.c_void_p(), ctypes.c_void_p()
        if exe:
            self._lib.pd_graph_exec_destroy(exe)
        if graph:
            self._lib.pd_graph_destroy(graph)
        self.keep = []
        self._stream = None

    def __del__(self):
        # a program still open when collected: closed here, but not while
        # this thread captures another (a destroy inside a thread_local
        # capture would invalidate that capture): then after it.  An
        # executable graph in flight is freed when it completes
        if getattr(self, "_lib", None) is None or self.closed:
            return
        _DROPPED.append((self._lib, self._exec, self._graph))
        self._exec, self._graph = ctypes.c_void_p(), ctypes.c_void_p()
        if not torch.cuda.is_current_stream_capturing():
            while _DROPPED:
                lib, exe, graph = _DROPPED.pop()
                if exe:
                    lib.pd_graph_exec_destroy(exe)
                if graph:
                    lib.pd_graph_destroy(graph)


_DROPPED = []  # (library, executable graph, graph) of collected programs
_LIVE = weakref.WeakSet()  # every LoopProgram made
_LOOPS = weakref.WeakSet()  # every CGLoop and GMRESLoop made


def close_all() -> None:
    """Close every loop (its programs and captured programs) and device
    program still open.  ``parallel/sharding.leave_group`` calls it before
    the process group goes; the ``atexit`` hook before CUDA does."""
    for loop in list(_LOOPS):
        loop.close()
    for prog in list(_LIVE):
        prog.close()


@atexit.register
def _close_at_exit() -> None:
    # registered after torch's own hooks (this module imports torch), so
    # it runs before them; a context already lost (a trapped kernel)
    # makes the synchronise raise: the destroys are then skipped
    if not torch.cuda.is_initialized():
        return
    try:
        close_all()
    except RuntimeError:
        pass


def _sync(device) -> None:
    """Wait for ``device``'s work before captured programs are dropped
    (torch then frees each graph and gives its pool back)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


def _copy_state(dst: CGState, src: CGState) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _tally(total: dict, last: dict) -> None:
    for k, v in last.items():
        total[k] += v


class CGLoop:
    """CG (``solvers/cg``) on static buffers as one device program a solve.

    ``A`` and ``M`` act on tensors like ``like`` (shape, dtype, device);
    ``rtol``, ``atol`` and ``maxiter`` are fixed in the programs, as they
    are static arguments of the JAX package's jitted solves.  Start
    programs come from :meth:`start_program`; :meth:`program` puts one in
    front of WHILE(active) { the body } and any programs after it;
    :meth:`run` launches that and reads the iterations.  After a run,
    ``state`` holds the result (the next run overwrites it) and ``last``
    what the run cost: ``iterations``, ``replays`` (bodies run, from the
    device's count of the condition's tests), ``host_reads`` (counted
    where made) and ``runs`` (launches); ``total`` sums them over every
    run."""

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
        self.tests = zeros(dtype=torch.int64)  # set_condition counts them
        self.reads = 0  # host reads made
        self.body = None
        self.captured = []  # every Program of this loop, starts and body
        self._programs = {}  # LoopProgram by (start, *after)
        self.last = {}
        self.total = dict.fromkeys(("runs", "iterations", "replays",
                                    "host_reads"), 0)
        self.closed = False
        _LOOPS.add(self)

    def close(self) -> None:
        """Close the device programs, synchronise, then drop the captured
        programs (their pool goes back to the allocator); the loop runs
        no more."""
        if self.closed:
            return
        self.closed = True
        for prog in self._programs.values():
            prog.close()
        _sync(self.device)
        self._programs, self.captured, self.body = {}, [], None

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

    def add_program(self, compute: Callable | None,
                    commit: Callable) -> Program:
        """Capture a program in this loop's pool, to run after the loop
        (:meth:`program`'s ``after``)."""
        prog = capture(compute, commit, device=self.device, pool=self.pool)
        self.captured.append(prog)
        return prog

    def _capture_body(self) -> None:
        if self.body is None:
            self.body = capture(
                lambda: cg_body(self.A, self.M, self.state, self.tol,
                                self.maxiter, self.dot),
                lambda st: _copy_state(self.state, st), device=self.device,
                pool=self.pool)
            self.captured.append(self.body)

    def program(self, start: Program, after: tuple = ()) -> LoopProgram:
        """The device program ``start``, WHILE(active) { the body },
        then ``after`` (made at first use; the body is captured at the
        first program)."""
        key = (start, *after)
        if self.closed:
            raise RuntimeError("this loop is closed")
        if key not in self._programs:
            self._capture_body()

            def build(chain):
                chain.child(start)
                chain.loop(self.state.active,
                           lambda body: body.child(self.body), self.tests)
                for p in after:
                    chain.child(p)

            self._programs[key] = LoopProgram(build, self.device)
        return self._programs[key]

    def _read(self, t: torch.Tensor) -> list:
        self.reads += 1
        return t.tolist()

    def launch(self, start: Program, after: tuple = (), times: int = 1,
               per_run: torch.Tensor | None = None) -> list:
        """Launch ``program(start, after)`` ``times`` times with no read
        between, then read the host once: the iterations of each run
        (``per_run``, an integer tensor of ``times`` entries that
        ``after`` writes; by default the state's ``k``, for one run) and
        the count of the condition's tests.  Counts the launches, records
        ``last`` and ``total``, returns the iterations per run."""
        prog = self.program(start, after)
        reads = self.reads
        with torch.cuda.device(self.device):
            self.tests.zero_()
            for _ in range(times):
                prog.launch()
            its = self.state.k.reshape(1) if per_run is None else per_run
            *iterations, tests = self._read(torch.cat(
                [its.to(torch.int64), self.tests.reshape(1)]))
        bodies = tests - times  # each run tests once before its bodies
        for p in (start, *after):
            p.count(times)
        self.body.count(bodies)
        _build.launches["set_condition"] += tests
        self.last = dict(runs=times, iterations=sum(iterations),
                         replays=bodies, host_reads=self.reads - reads)
        _tally(self.total, self.last)
        return iterations

    def run(self, start: Program) -> int:
        """Launch ``start`` and the loop as one program; returns the
        iterations, from the one host read."""
        return self.launch(start)[0]


class GMRESLoop:
    """GMRES(``restart``) (``solvers/gmres``) on static buffers as one
    device program a solve: the reset, then WHILE(go) { the cycle's start,
    WHILE(active) { one masked Arnoldi step }, the cycle's end }.  The
    programs are captured at the first solve, before its reset (their
    warm-ups run on the state), in one shared pool.

    ``A`` and ``M`` act on vectors like ``like``; ``rtol`` and
    ``max_restarts`` are fixed as in :func:`gmres_solve`.  After a solve,
    ``last`` holds what it cost: ``iterations``, ``replays`` (steps run)
    and ``cycles``, both from the device's counts of the two loops'
    tests, and ``host_reads`` (counted where made); ``total`` sums them
    over every solve, with ``runs``."""

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
        self.x0 = torch.zeros_like(like)
        self.state = gmres_init(like, restart)
        # the tests of go and of active, counted by set_condition
        self.tests = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.reads = 0  # host reads made
        self.programs = None  # (cycle start, step, cycle end)
        self.body = None  # the step
        self._solve = None  # (reset program, LoopProgram)
        self.captured = []
        self.last = {}
        self.total = dict.fromkeys(("runs", "iterations", "replays",
                                    "cycles", "host_reads"), 0)
        self.closed = False
        _LOOPS.add(self)

    def close(self) -> None:
        """As :meth:`CGLoop.close`."""
        if self.closed:
            return
        self.closed = True
        if self._solve is not None:
            self._solve[1].close()
        _sync(self.device)
        self._solve, self.programs, self.body = None, None, None
        self.captured = []

    def _capture(self) -> None:
        st = self.state
        self.programs = [
            capture(fn, lambda _: None, device=self.device, pool=self.pool)
            for fn in (lambda: gmres_cycle_start(self.A, self.b, st),
                       lambda: gmres_step(self.A, self.M, st),
                       lambda: gmres_cycle_end(st, self.max_restarts))]
        self.body = self.programs[1]
        self.captured.extend(self.programs)

    def _program(self):
        """(the reset program, the solve's device program); the reset
        starts from ``x0``, which a solve from zero zeroes."""
        if self.closed:
            raise RuntimeError("this loop is closed")
        if self._solve is None:
            if self.programs is None:
                self._capture()
            st = self.state
            rp = capture(lambda: gmres_reset(st, self.b, self.x0, self.rtol,
                                             self.max_restarts),
                         lambda _: None, device=self.device, pool=self.pool)
            self.captured.append(rp)
            start, step, end = self.programs

            def cycle(chain):
                chain.child(start)
                chain.loop(st.active, lambda inner: inner.child(step),
                           self.tests[1])
                chain.child(end)

            def build(chain):
                chain.child(rp)
                chain.loop(st.go, cycle, self.tests[0])

            self._solve = (rp, LoopProgram(build, self.device))
        return self._solve

    def _read(self, t: torch.Tensor) -> list:
        self.reads += 1
        return t.tolist()

    def solve(self, b: torch.Tensor,
              x0: torch.Tensor | None = None) -> GMRESResult:
        """GMRES on A x = b from ``x0`` (zero when None); ``x`` of the
        result is a copy (the next solve overwrites the state)."""
        reset, prog = self._program()
        st, reads = self.state, self.reads
        with torch.cuda.device(self.device):
            self.b.copy_(b)
            if x0 is None:
                self.x0.zero_()
            else:
                self.x0.copy_(x0)
            self.tests.zero_()
            prog.launch()
            total, res, go_tests, active_tests = self._read(torch.cat([
                torch.stack([st.total.to(torch.float64),
                             st.res.to(torch.float64)]),
                self.tests.to(torch.float64)]))
        # go is tested before the first cycle and after each; active
        # before each cycle's first step and after each step
        its, cycles = int(total), int(go_tests) - 1
        steps = int(active_tests) - cycles
        start, step, end = self.programs
        reset.count()
        start.count(cycles)
        end.count(cycles)
        step.count(steps)
        _build.launches["set_condition"] += int(go_tests + active_tests)
        self.last = dict(iterations=its, replays=steps, cycles=cycles,
                         host_reads=self.reads - reads)
        self.total["runs"] += 1
        _tally(self.total, self.last)
        return GMRESResult(x=self.state.x.clone(), iterations=its,
                           residual=res)
