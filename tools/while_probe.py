"""Probe of the device-loop route (``csrc/graph_loop.cu``,
``solvers/graphs.LoopProgram``) on a CUDA card.

Answers, and prints as one JSON object (``--out`` writes it too):

* ``versions``: torch, its CUDA, ``nvcc --version``, the NVIDIA kernel
  module's version; whether
  ``torch.cuda.CUDAGraph`` takes ``keep_graph=True`` and has
  ``raw_cuda_graph()``;
* ``child_body``: a torch-captured program as a child graph node in a
  conditional WHILE node's body, ended by the library's ``set_condition``
  node: a device counter incremented until it reaches n stops at n, for n
  = 0, 1 and 37, two launches each;
* ``setter_in_capture``: ``set_condition`` launched inside the torch
  capture of the body (so it lands in the child graph) instead of as a
  node of the body; the body's own first node sets the condition from a
  cap of 50 iterations, so a setter that does not act ends the loop there
  and not never;
* ``nested``: a WHILE inside a WHILE's body (GMRES's steps inside its
  cycles): three outer iterations of 2, 3 and 4 inner ones;
* ``bodies``: each loop the port captures, at a small size, run as one
  device program against its eager loop (iterations, max |x_g - x_e| /
  max |x_e|, host reads a solve) with the node types of its body graph
  (``cudaGraphGetNodes``, child graphs counted through): the lex,
  ``relabel=None``, bf16-vector, matrix-free and block-ELL hierarchies'
  CG, SA-AMG's CG, darcy_stokes' MG-GMRES, the monodomain's steps_scan,
  the structured system sharded on a one-rank NCCL group, and a counter
  loop whose body holds phase 15 (b)'s collectives (an exchange to self,
  an all_reduce, an all_gather_into_tensor).

With ``--fault``, whether the device programs fault, each case in a
process of its own (its exit code, its last lines): a plain-torch
program of oseen's shape (a WHILE of 2 cycles, each a WHILE of 200 steps
of 500 elementwise kernels) launched untraced and then traced by
``torch.profiler`` (device records against the kernels it ran), the
oseen n=64 MG-GMRES and the flat ``ShardedSystem`` (COO Poisson n=64,
world size 1) device programs untraced (x bitwise alike on every solve)
and then traced; and ``compute-sanitizer --tool memcheck`` on a small
plain program and on oseen n=8's, untraced.

With ``--collectives N`` (N cards, one process each on an NCCL group):
whether NCCL's all_reduce, all_gather_into_tensor and send/recv across
ranks go into a WHILE body, with the bodies' node types; and the ring
halo exchange of the structured sharded system (4 rows of T lanes each
side, f32, T = 64 and 4096) by send/recv (``parallel/sharding.exchange``,
as ``ShardedBandedSystem._halo_x``) against one all-gather of both ends:
microseconds an exchange, each a captured program replayed back to back
by the host, and the all-gather in a WHILE loop where its program
instantiates.  These need no kernel of the port, so the loops run on the
probe's own library.

Every case records the CUDA error text where something is refused, and
the run goes on.  A loop that has not ended 60 s after its launch ends
the process (exit 3), so a condition that never falls cannot hold the
card.  The diagnostic entries (node types, DOT prints, set_condition
launched on a stream) are in ``tools/while_probe.cu``, which this probe
alone builds (with the loop entries of ``csrc/graph_loop.cu`` it
includes) into the kernel library's build directory.

    python3 tools/while_probe.py [--fault | --collectives N] [--out FILE]
"""

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import shutil
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "event_wait", 7: "event_record",
              8: "ext_semaphore_signal", 9: "ext_semaphore_wait",
              10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional",
              # what a conditional body may refuse (csrc/graph_loop.cu)
              16: "memcpy_host_end", 17: "memset_2d",
              18: "kernel_sync_domain", 19: "kernel_cooperative",
              20: "kernel_cluster"}


PROBE_SRC = os.path.join(ROOT, "tools", "while_probe.cu")
# the probe's own entries (tools/while_probe.cu): (argtypes, restype)
PROBE_ENTRIES = {
    "pd_set_condition": ([ctypes.c_ulonglong, ctypes.c_void_p,
                          ctypes.c_void_p], ctypes.c_int),
    "pd_graph_node_types": ([ctypes.c_void_p, ctypes.c_void_p],
                            ctypes.c_int),
    "pd_graph_dot": ([ctypes.c_void_p, ctypes.c_char_p], ctypes.c_int),
}
_PROBE = []  # the probe's library, once loaded


def probe_library():
    """``tools/while_probe.cu`` built once per source into the kernel
    library's build directory, and loaded with the loop entries'
    (``ops/_build.GRAPH_LOOP_ENTRIES``) and its own prototypes."""
    if _PROBE:
        return _PROBE[0]
    from polydeal_tpu_torch.ops import _build

    h = hashlib.sha256(" ".join(_build._FLAGS).encode())
    for src in (PROBE_SRC, os.path.join(_build._CSRC, "graph_loop.cu")):
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(_build._BUILD_DIR,
                      f"while_probe_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_build._BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}"
        r = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared",
                            "-o", tmp, PROBE_SRC], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {PROBE_SRC}:\n{r.stdout}"
                               f"{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, (args, res) in {**_build.GRAPH_LOOP_ENTRIES,
                              **PROBE_ENTRIES}.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    _PROBE.append(lib)
    return lib


def counter(torch, dev, n=1):
    """A device count of a loop's tests (int64 zeros)."""
    return torch.zeros(n, dtype=torch.int64, device=dev)


def done_or_exit(torch, label, seconds=60.0):
    """Wait for the work queued so far; end the process if it has not
    finished within ``seconds`` (a loop whose condition never falls)."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > seconds:
            print(json.dumps({"hang": label}), flush=True)
            os._exit(3)
        time.sleep(0.001)


def node_types(graph):
    """{type name: count} of a torch CUDAGraph kept as a graph."""
    counts = (ctypes.c_longlong * 32)()
    err = probe_library().pd_graph_node_types(
        ctypes.c_void_p(graph.raw_cuda_graph()), counts)
    if err:
        return {"error": err}
    return {NODE_TYPES.get(i, str(i)): counts[i] for i in range(32)
            if counts[i]}


DOT_DIR = [tempfile.gettempdir()]  # where the DOT prints go (--out's dir)


def alloc_neighbours(graph, label):
    """The nodes next to each memory allocation and free node of a torch
    CUDAGraph (its DOT print, written to ``DOT_DIR/label.dot``): what
    allocated inside the capture."""
    import re

    path = os.path.join(DOT_DIR[0], label.replace(" ", "_") + ".dot")
    err = probe_library().pd_graph_dot(
        ctypes.c_void_p(graph.raw_cuda_graph()), path.encode())
    if err:
        return {"error": err}
    with open(path) as f:
        text = f.read()
    labels = dict(re.findall(r'"(\w+)"\s*\[[^\]]*?label="(.*?)"\]', text,
                             re.S))
    edges = re.findall(r'"(\w+)"\s*->\s*"(\w+)"', text)
    out = []
    for node, lab in labels.items():
        if "MEM_ALLOC" not in lab and "MEM_FREE" not in lab:
            continue
        near = ([labels.get(a, a) for a, b in edges if b == node][:2]
                + [labels.get(b, b) for a, b in edges if a == node][:2])
        out.append({"node": lab[:120],
                    "near": [re.sub(r"\s+", " ", x)[:300] for x in near]})
    return out[:8]


def guarded(fn):
    """fn()'s result, or the error it raised (type, text, last frames)."""
    try:
        return fn()
    except Exception as e:  # the probe reports refusals
        return {"error": f"{type(e).__name__}: {e}",
                "where": traceback.format_exc().splitlines()[-6:]}


def versions(torch):
    out = dict(torch=torch.__version__, cuda=torch.version.cuda,
               device=torch.cuda.get_device_name(0))
    for cmd, key in ((["nvcc", "--version"], "nvcc"),
                     (["nvidia-smi", "--query-gpu=driver_version,name,"
                       "power.limit", "--format=csv,noheader"], "gpu")):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=30)
            out[key] = r.stdout.strip().splitlines()[-1]
        except (OSError, subprocess.SubprocessError) as e:
            out[key] = str(e)
    g = guarded(lambda: torch.cuda.CUDAGraph(keep_graph=True))
    out["keep_graph"] = not isinstance(g, dict)
    out["raw_cuda_graph"] = hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph")
    return out


def counter_programs(torch, graphs, dev, n, pool):
    """(counter, flag, init program, body program): init sets the counter
    to 0, the body adds 1; both leave flag = counter < n."""
    c = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    lim = torch.full((), n, dtype=torch.int64, device=dev)

    def init(_):
        c.zero_()
        flag.copy_(c < lim)

    def body(_):
        c.add_(1)
        flag.copy_(c < lim)

    return (c, flag, graphs.capture(None, init, device=dev, pool=pool),
            graphs.capture(None, body, device=dev, pool=pool))


def child_body(torch, dev):
    from polydeal_tpu_torch.solvers import graphs

    out = {}
    for n in (0, 1, 37):
        pool = torch.cuda.graph_pool_handle()
        c, flag, pi, pb = counter_programs(torch, graphs, dev, n, pool)

        def build(ch):
            ch.child(pi)
            ch.loop(flag, lambda body: body.child(pb), counter(torch, dev))

        prog = graphs.LoopProgram(build, dev)
        got = []
        for _ in range(2):
            prog.launch()
            done_or_exit(torch, f"child_body n={n}")
            got.append(int(c))
        out[str(n)] = got
    # one launch of n = 37 timed by events: the loop's cost an iteration
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        prog.launch()
    ev[1].record()
    torch.cuda.synchronize()
    out["ms_per_launch_n37"] = ev[0].elapsed_time(ev[1]) / 10
    return out


def setter_in_capture(torch, dev, n=5, cap=50):
    from polydeal_tpu_torch.solvers import graphs

    lib = probe_library()
    g, h = ctypes.c_void_p(), ctypes.c_ulonglong()
    graphs._check(lib.pd_graph_create(ctypes.byref(g)), "graph create")
    graphs._check(lib.pd_graph_condition(g, ctypes.byref(h)), "condition")
    pool = torch.cuda.graph_pool_handle()
    c = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    safe = torch.zeros((), dtype=torch.bool, device=dev)

    def init(_):
        c.zero_()
        flag.copy_(c < n)
        safe.copy_(c < cap)

    def body(_):
        c.add_(1)
        flag.copy_(c < n)
        safe.copy_(c < cap)
        graphs._check(lib.pd_set_condition(
            h, ctypes.c_void_p(flag.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)),
            "set_condition in a capture")

    pi = graphs.capture(None, init, device=dev, pool=pool)
    pb = graphs.capture(None, body, device=dev, pool=pool)
    keep = []
    ch = graphs._Chain(lib, g, keep)
    tests = counter(torch, dev)
    ch.child(pi)
    ch.set_condition(h, flag, tests)
    node, inner = ctypes.c_void_p(), ctypes.c_void_p()
    graphs._check(lib.pd_graph_add_while(g, ch.tail, h, ctypes.byref(node),
                                         ctypes.byref(inner)), "while")
    ib = graphs._Chain(lib, inner, keep)
    # ends the loop at cap if the child's does not
    ib.set_condition(h, safe, tests)
    ib.child(pb)
    ex = ctypes.c_void_p()
    graphs._check(lib.pd_graph_instantiate(g, ctypes.byref(ex)),
                  "instantiate")
    graphs._check(lib.pd_graph_launch(ex, ctypes.c_void_p(
        torch.cuda.current_stream().cuda_stream)), "launch")
    done_or_exit(torch, "setter_in_capture")
    got = int(c)
    lib.pd_graph_exec_destroy(ex)
    lib.pd_graph_destroy(g)
    return dict(n=n, cap=cap, iterations=got,
                setter_in_child_acts=got == n)


def nested(torch, dev, outer=3):
    from polydeal_tpu_torch.solvers import graphs

    pool = torch.cuda.graph_pool_handle()
    z = lambda dt: torch.zeros((), dtype=dt, device=dev)
    cyc, j, tot = z(torch.int64), z(torch.int64), z(torch.int64)
    go, act = z(torch.bool), z(torch.bool)

    def reset(_):
        cyc.zero_()
        tot.zero_()
        go.copy_(cyc < outer)

    def start(_):
        j.zero_()
        act.copy_(j < cyc + 2)

    def step(_):
        j.add_(1)
        tot.add_(1)
        act.copy_(j < cyc + 2)

    def end(_):
        cyc.add_(1)
        go.copy_(cyc < outer)

    pr, ps, pt, pe = (graphs.capture(None, f, device=dev, pool=pool)
                      for f in (reset, start, step, end))

    tests = counter(torch, dev, 2)

    def cycle(ch):
        ch.child(ps)
        ch.loop(act, lambda inner: inner.child(pt), tests[1])
        ch.child(pe)

    def build(ch):
        ch.child(pr)
        ch.loop(go, cycle, tests[0])

    prog = graphs.LoopProgram(build, dev)
    got = []
    for _ in range(2):
        prog.launch()
        done_or_exit(torch, "nested")
        got.append((int(cyc), int(tot)))
    return dict(want=(outer, sum(c + 2 for c in range(outer))), got=got)


def rel(a, b):
    return float((a.double() - b.double()).abs().max()) / float(
        b.double().abs().max())


def cg_case(torch, mg, b, loop_of, **kw):
    """A Multigrid's captured solve against its eager one (where the
    device program is refused: the error and the body's node types)."""
    eager = mg.solve_cg(b, capture=False, **kw)
    out = guarded(lambda: mg.solve_cg(b, **kw))
    loop = loop_of()
    nodes = (node_types(loop.body.graph) if loop.body is not None
             else None)
    if isinstance(out, dict):
        return dict(out, body_nodes=nodes, allocs=guarded(
            lambda: alloc_neighbours(loop.body.graph, "body")))
    done_or_exit(torch, "cg")
    graph = mg.solve_cg(b, **kw)
    return dict(iterations=(eager.iterations, graph.iterations),
                diff=rel(graph.x, eager.x), last=loop.last,
                body_nodes=nodes)


def bodies(torch, dev, group):
    import polydeal_tpu_torch as tpd
    from polydeal_tpu_torch.agglomeration import RTreeAgglomerator
    from polydeal_tpu_torch.assembly import sipg as tsipg
    from polydeal_tpu_torch.models import darcy_stokes as ds
    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)
    from polydeal_tpu_torch.models.poisson import solve_poisson
    from polydeal_tpu_torch.parallel.banded import ShardedBandedSystem
    from polydeal_tpu_torch.solvers import graphs
    from polydeal_tpu_torch.solvers import multigrid as tmg
    from polydeal_tpu_torch.solvers.gmres import gmres_solve

    f64 = dict(dtype=torch.float64, precond_dtype=None)
    out = {}

    def flagship(**kw):
        fs = setup_flagship(n=16, device=dev, **kw)
        return cg_case(torch, fs.mg, fs.b,
                       lambda: fs.mg.cg_loop(1e-8, 100, fs.b.dtype),
                       rtol=1e-8, maxiter=100, fmg=True)

    out["lex"] = guarded(lambda: flagship(**f64))

    def packed():
        old = tmg.PACK_MIN_P
        tmg.PACK_MIN_P = 0
        try:
            return flagship(relabel=None, **f64)
        finally:
            tmg.PACK_MIN_P = old

    out["relabel_none"] = guarded(packed)
    out["bf16_vectors"] = guarded(
        lambda: flagship(vector_dtype=torch.bfloat16))

    def matfree():
        fs = setup_flagship(n=16, device=dev, **f64)
        mg = tmg.build_multigrid(fs.handlers, fs.parents, None,
                                 grid_shapes=fs.grid_shapes,
                                 level_assembly="banded", matfree_fine=True,
                                 device=dev)
        return cg_case(torch, mg, fs.b,
                       lambda: mg.cg_loop(1e-8, 200, fs.b.dtype),
                       rtol=1e-8, maxiter=200, fmg=True)

    out["matfree"] = guarded(matfree)

    def ell():
        m = tpd.hyper_cube(2, 16)
        agg = RTreeAgglomerator.build(m.cell_centers())
        hs, ps = tmg.build_rtree_hierarchy(
            m, agg, list(range(2, agg.n_levels - 1)), degree=1)
        import numpy as np

        perm = np.random.default_rng(3).permutation(hs[-1].n_poly)
        hs = hs[:-1] + [tpd.AgglomerationHandler(m, perm[hs[-1].cell2poly],
                                                 degree=1)]
        ps = ps[:-1] + [np.asarray(ps[-1])[np.argsort(perm)]]
        u = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
        A = tsipg.assemble_sipg_matrix(hs[-1], device=dev)
        b = tsipg.assemble_rhs(hs[-1], lambda x: 2 * math.pi**2 * u(x), u,
                               device=dev)
        mg = tmg.build_multigrid(hs, ps, A, device=dev)
        return cg_case(torch, mg, b, lambda: mg.cg_loop(1e-9, 200, b.dtype),
                       rtol=1e-9, maxiter=200)

    out["block_ell"] = guarded(ell)

    def amg():
        rp = solve_poisson(dim=2, n=16, solver="amg", device=dev,
                           verbose=False)
        a, b = rp["amg"], rp["b"]
        eager = a.solve_cg(b, capture=False)
        graph = a.solve_cg(b)
        loop = a._loops[(1e-9, 300, b.dtype)][0]
        return dict(iterations=(eager.iterations, graph.iterations),
                    diff=rel(graph.x, eager.x), last=loop.last,
                    body_nodes=node_types(loop.body.graph))

    out["amg"] = guarded(amg)

    def gmres():
        s, _ = ds.run(8, 2, device=dev)
        A, b = ds._regularized(s), s.rhs
        M = ds.mg_block_preconditioner(s, tpd.hyper_cube(2, 8), 8, 2,
                                       ps_mode="mass+stab", structure="tri")
        kw = dict(restart=200, rtol=1e-11, max_restarts=40)
        loop = graphs.GMRESLoop(A, M, b, **kw)
        loop._capture()
        nodes = {k: node_types(p.graph) for k, p in zip(
            ("start", "step", "end"), loop.programs)}
        graph = guarded(lambda: loop.solve(b))
        if isinstance(graph, dict):
            return dict(graph, nodes=nodes, allocs=guarded(
                lambda: alloc_neighbours(loop.programs[1].graph,
                                         "gmres_step")))
        done_or_exit(torch, "gmres")
        eager = gmres_solve(A, b, M=M, capture=False, **kw)
        graph = loop.solve(b)
        return dict(iterations=(eager.iterations, graph.iterations),
                    diff=rel(graph.x, eager.x), last=loop.last,
                    nodes=nodes)

    out["gmres_darcy"] = guarded(gmres)

    def mono():
        s = MonodomainSolver.build(bench_config(3), dtype=torch.float64,
                                   relabel="lex", device=dev)
        res = {}
        for capture in (False, True):
            u, w = s.initial_state()
            got = guarded(lambda: s.step(u, u, w, 0.0, True,
                                         capture=capture))
            if isinstance(got, dict):
                g = s._graphs
                progs = {f"start bdf2={k}": p for k, p in g._starts.items()}
                progs["body"] = g.loop.body
                return dict(got, nodes={
                    k: node_types(p.graph) for k, p in progs.items()
                    if p is not None}, allocs={
                    k: guarded(lambda p=p, k=k: alloc_neighbours(
                        p.graph, "mono " + k))
                    for k, p in progs.items() if p is not None})
            u1, w1, it1 = got
            uf, _, wf, its = s.steps_scan(u1, u, w1, s.cfg.dt, 4,
                                          capture=capture)
            res[capture] = ([it1] + its, uf)
        loop = s.mg.cg_loop(s.cfg.solver.rtol, s.cfg.solver.max_iterations,
                            torch.float64)
        return dict(iterations=(res[False][0], res[True][0]),
                    diff=rel(res[True][1], res[False][1]), last=loop.last)

    out["monodomain"] = guarded(mono)

    def sharded():
        fs = setup_flagship(n=16, device=dev, hierarchy="structured", **f64)
        ss = ShardedBandedSystem.from_multigrid(fs.mg, group)
        xe, ke, _ = ss.solve_cg_local(fs.b, rtol=1e-9, maxiter=100,
                                      capture=False)
        x, k, _ = ss.solve_cg_async(fs.b, rtol=1e-9, maxiter=100)
        done_or_exit(torch, "sharded")
        loop = ss._compiled(1e-9, 100, True, fs.b.dtype)[0]
        return dict(iterations=(ke, int(k)), diff=rel(x, xe),
                    last=loop.last, body_nodes=node_types(loop.body.graph))

    out["sharded_nccl_ws1"] = guarded(sharded)
    for ops in (("exchange",), ("all_reduce",), ("all_gather",),
                ("exchange", "all_reduce", "all_gather")):
        out["collectives_loop " + "+".join(ops)] = guarded(
            lambda: collectives_loop(torch, dev, group, ops))
    return out


def collectives_loop(torch, dev, group, ops, n=3):
    """Phase 15 (b)'s collectives ``ops`` in a loop's body, n iterations:
    the exchange (a ring: to the next rank, from the one before) doubles
    x, the all-reduce and the all-gather land in buffers only they write
    (x doubles without the exchange too)."""
    import torch.distributed as dist

    from polydeal_tpu_torch.parallel.sharding import exchange
    from polydeal_tpu_torch.solvers import graphs

    world, r = dist.get_world_size(group), dist.get_rank(group)
    pool = torch.cuda.graph_pool_handle()
    x = torch.ones((4096, 4), dtype=torch.float64, device=dev)
    s = torch.zeros(1, dtype=torch.float64, device=dev)
    g = torch.zeros((world * 4096, 4), dtype=torch.float64, device=dev)
    c = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)

    def compute():
        send, recv = 2.0 * x, torch.empty_like(x)
        if "exchange" in ops:
            exchange(group, [(send, (r + 1) % world, recv,
                              (r - 1) % world, 0)])
        else:
            recv.copy_(send)
        t = (x * x).sum().reshape(1)
        if "all_reduce" in ops:
            dist.all_reduce(t, group=group)
        gg = x.new_zeros(g.shape)
        if "all_gather" in ops:
            dist.all_gather_into_tensor(gg, x + 1.0, group=group)
        return recv, t, gg

    def commit(res):
        recv, t, gg = res
        x.copy_(recv)
        s.copy_(t)
        g.copy_(gg)
        c.add_(1)
        flag.copy_(c < n)

    def init(_):
        x.fill_(1.0)
        c.zero_()
        flag.copy_(c < n)

    pi = graphs.capture(None, init, device=dev, pool=pool)
    pb = graphs.capture(compute, commit, device=dev, pool=pool)

    def build(ch):
        ch.child(pi)
        ch.loop(flag, lambda body: body.child(pb), counter(torch, dev))

    nodes = node_types(pb.graph)
    prog = guarded(lambda: graphs.LoopProgram(build, dev))
    if isinstance(prog, dict):
        return dict(prog, body_nodes=nodes)
    prog.launch()
    done_or_exit(torch, "collectives_loop")
    want = 2.0 ** n
    ranks = world if "all_reduce" in ops else 1
    return dict(iterations=int(c), x_ok=bool((x == want).all()),
                s_ok=float(s[0]) == ranks * 4096 * 4 * (want / 2) ** 2,
                g_ok=("all_gather" not in ops
                      or bool((g == want / 2 + 1.0).all())),
                body_nodes=nodes)


def halo_costs(torch, dev, group, reps=200):
    """The structured system's ring halo (``ShardedBandedSystem._halo_x``:
    4 rows, T lanes from each neighbour, f32) by NCCL send/recv and by one
    all_gather_into_tensor of every rank's two ends: both give x_ext
    bitwise alike; microseconds an exchange, each captured as one program
    replayed ``reps`` times back to back (the host's loop) and, where the
    program instantiates, run as the body of a WHILE loop of ``reps``
    iterations."""
    import torch.distributed as dist

    from polydeal_tpu_torch.parallel.sharding import exchange
    from polydeal_tpu_torch.solvers import graphs

    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for T in (64, 4096):
        per = 3 * T
        gen = torch.Generator(device=dev).manual_seed(r)
        x = torch.randn((4, per), generator=gen, device=dev)

        def p2p():
            lh, rh = x.new_empty((4, T)), x.new_empty((4, T))
            exchange(group, [
                (x[:, per - T:].contiguous(), (r + 1) % n, lh, (r - 1) % n,
                 0),
                (x[:, :T].contiguous(), (r - 1) % n, rh, (r + 1) % n, 1)])
            return torch.cat([lh, x, rh], dim=1)

        def gather():
            ends = torch.stack([x[:, :T], x[:, per - T:]])
            allg = x.new_empty((2 * n, 4, T))
            dist.all_gather_into_tensor(allg, ends, group=group)
            return torch.cat([allg[2 * ((r - 1) % n) + 1], x,
                              allg[2 * ((r + 1) % n)]], dim=1)

        row = dict(same=bool(torch.equal(p2p(), gather())))
        for name, fn in (("send_recv", p2p), ("all_gather", gather)):
            pool = torch.cuda.graph_pool_handle()
            ext = x.new_zeros((4, per + 2 * T))
            c = torch.zeros((), dtype=torch.int64, device=dev)
            flag = torch.zeros((), dtype=torch.bool, device=dev)

            def commit(e):
                ext.copy_(e)
                c.add_(1)
                flag.copy_(c < reps)

            def init(_):
                c.zero_()
                flag.copy_(c < reps)

            pb = graphs.capture(fn, commit, device=dev, pool=pool)
            pi = graphs.capture(None, init, device=dev, pool=pool)
            pb.graph.replay()  # instantiates it, outside the timing
            dist.barrier(group=group)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(reps):
                pb.graph.replay()
            ev[1].record()
            torch.cuda.synchronize()
            res = dict(replayed_us=ev[0].elapsed_time(ev[1]) / reps * 1e3,
                       body_nodes=node_types(pb.graph))

            def build(ch, pi=pi, pb=pb, flag=flag):
                ch.child(pi)
                ch.loop(flag, lambda body: body.child(pb),
                        counter(torch, dev))

            prog = guarded(lambda: graphs.LoopProgram(build, dev))
            if isinstance(prog, dict):
                res["while"] = prog
            else:
                prog.launch()  # its first launch uploads it
                done_or_exit(torch, f"halo {name} T={T}")
                dist.barrier(group=group)
                torch.cuda.synchronize()
                ev[0].record()
                prog.launch()
                ev[1].record()
                done_or_exit(torch, f"halo {name} T={T}")
                res["while"] = dict(
                    us=ev[0].elapsed_time(ev[1]) / reps * 1e3,
                    iterations=int(c))
            row[name] = res
        out[f"T={T}"] = row
    return out


def collectives_rank(torch, rank, world, store, out):
    """One rank of ``--collectives``: the loops on the probe's library (no
    kernel of the port runs here)."""
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.parallel.sharding import init_group, leave_group

    dev = torch.device("cuda", rank)
    group = init_group(rank, world, device=dev, store_path=store)
    _build._lib = probe_library()
    res = dict(world=world, card=versions(torch).get("gpu"))
    for ops in (("all_reduce",), ("all_gather",), ("exchange",)):
        res["+".join(ops)] = guarded(
            lambda: collectives_loop(torch, dev, group, ops))
    res["halo"] = guarded(lambda: halo_costs(torch, dev, group))
    if rank == 0:
        with open(out, "w") as f:
            f.write(json.dumps(res) + "\n")
    leave_group()
    return 0


def collectives(world, timeout=120):
    """``--collectives``: ``world`` rank processes; rank 0's result, with
    every rank's exit code and the last lines of a failed one's errors."""
    tmp = tempfile.mkdtemp(prefix="while_probe_nccl_")
    out = os.path.join(tmp, "rank0.json")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--collectives",
         str(world), "--rank", str(r), "--store",
         os.path.join(tmp, "store"), "--rank-out", out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    rcs, errs = [], []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        rcs.append(p.returncode)
        errs.append(err[-1500:] if p.returncode else "")
    res = dict(rcs=rcs, errors=[e for e in errs if e])
    if os.path.exists(out):
        with open(out) as f:
            res.update(json.loads(f.read()))
    return res


# ---- --fault: does a device program fault, traced or not ----------------


def plain_program(torch, dev, outer, inner, width):
    """A nested WHILE program of plain torch work, oseen's shape: ``outer``
    cycles of ``inner`` steps, each step a captured program of ``width``
    elementwise kernels; (program, checks, kernels a launch runs)."""
    from polydeal_tpu_torch.solvers import graphs

    pool = torch.cuda.graph_pool_handle()
    z = lambda dt: torch.zeros((), dtype=dt, device=dev)
    cyc, j = z(torch.int64), z(torch.int64)
    go, act = z(torch.bool), z(torch.bool)
    v = torch.zeros(1024, dtype=torch.float32, device=dev)
    tests = counter(torch, dev, 2)

    def reset(_):
        cyc.zero_()
        v.zero_()
        go.copy_(cyc < outer)

    def start(_):
        j.zero_()
        act.copy_(j < inner)

    def step(_):
        for _ in range(width):
            v.add_(1.0)
        j.add_(1)
        act.copy_(j < inner)

    def end(_):
        cyc.add_(1)
        go.copy_(cyc < outer)

    pr, ps, pt, pe = (graphs.capture(None, f, device=dev, pool=pool)
                      for f in (reset, start, step, end))

    def cycle(ch):
        ch.child(ps)
        ch.loop(act, lambda body: body.child(pt), tests[1])
        ch.child(pe)

    def build(ch):
        ch.child(pr)
        ch.loop(go, cycle, tests[0])

    prog = graphs.LoopProgram(build, dev)

    def check():
        return dict(v_ok=bool((v == outer * inner * width).all()),
                    tests=tests.tolist(),
                    tests_ok=tests.tolist() == [outer + 1,
                                                outer * (inner + 1)])

    def launch():
        tests.zero_()
        prog.launch()

    return launch, check, outer * inner * (width + 2)


def traced_ops(torch, fn):
    """(device records, span ms) of one traced call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return 0, 0.0
    lo = min(e.time_range.start for e in ev)
    hi = max(e.time_range.end for e in ev)
    return len(ev), (hi - lo) / 1e3


def say(**kw):
    print(json.dumps(kw), flush=True)


def fault_case(torch, dev, name):
    """One ``--fault`` case, its progress printed line by line (so that
    the lines before a fault show where it struck)."""
    from polydeal_tpu_torch.ops import _build

    _build.load_library()
    if name.startswith("plain"):
        small = name == "plain_small"
        launch, check, kernels = plain_program(
            torch, dev, 2, 5 if small else 200, 10 if small else 500)
        for i in range(3):
            launch()
            say(case=name, traced=False, launch=i, **check())
        if small:
            return 0
        for i in range(3):
            recs, span = traced_ops(torch, launch)
            say(case=name, traced=True, launch=i, device_records=recs,
                kernels_run=kernels, span_ms=span, **check())
        return 0
    if name.startswith("oseen"):
        from polydeal_tpu_torch.models import oseen as os_
        from polydeal_tpu_torch.solvers.graphs import GMRESLoop

        n = 8 if name == "oseen_small" else 64
        space, _, meta = os_.run(n, 2, device=dev)
        op, rhs = meta["system"]
        M = os_.oseen_mg_preconditioner(space, op, meta, os_._rectangle(n),
                                        n, 2)
        A = os_._regularized(space, op, meta)
        loop = GMRESLoop(A, M, rhs, restart=200, rtol=1e-11,
                         max_restarts=40)
        solve = lambda: loop.solve(rhs)
    else:  # flat
        from polydeal_tpu_torch.models.poisson import solve_poisson
        from polydeal_tpu_torch.parallel.sharding import (ShardedSystem,
                                                          init_group)

        group = init_group(0, 1, device=dev, store_path=os.path.join(
            tempfile.mkdtemp(prefix="while_probe_"), "store"))
        ra = solve_poisson(dim=3, n=64, degree=1, device=dev, verbose=False)
        ss = ShardedSystem.from_multigrid(ra["mg"], group)
        b = ra["b"]
        del ra
        loop = ss._compiled(1e-9, 100, True, b.dtype)[0]

        def solve():
            x, k, _ = ss.solve_cg_local(b, rtol=1e-9, maxiter=100)
            return type("R", (), dict(x=x, iterations=k))
    first = solve()
    x0 = first.x.clone()
    untraced = 3 if name in ("flat", "oseen_small") else 10
    for i in range(untraced):
        r = solve()
        torch.cuda.synchronize()
        say(case=name, traced=False, solve=i, iterations=r.iterations,
            x_bitwise=bool(torch.equal(r.x, x0)), last=loop.last)
    if name == "oseen_small":
        return 0
    for i in range(2):
        got = []
        recs, span = traced_ops(torch, lambda: got.append(solve()))
        say(case=name, traced=True, solve=i, device_records=recs,
            span_ms=span, iterations=got[0].iterations,
            x_bitwise=bool(torch.equal(got[0].x, x0)))
    return 0


def fault(timeout=150):
    """``--fault``: every case in its own process; and memcheck."""
    me = [sys.executable, os.path.abspath(__file__), "--fault-case"]
    runs = [(c, me + [c], timeout) for c in ("plain", "oseen", "flat")]
    san = (shutil.which("compute-sanitizer")
           or "/usr/local/cuda/bin/compute-sanitizer")
    runs += [(f"memcheck {c}", [san, "--tool", "memcheck", "--print-limit",
                                "20", *me, c], limit)
             for c, limit in (("plain_small", 90), ("oseen_small", 120))]
    out = {}
    for label, cmd, limit in runs:
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=limit)
            rc, so, se = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = "timeout", e.stdout or "", e.stderr or ""
            so, se = (t.decode() if isinstance(t, bytes) else t
                      for t in (so, se))
        except OSError as e:
            rc, so, se = "not run", "", str(e)
        out[label] = dict(rc=rc, seconds=time.perf_counter() - t0,
                          lines=[json.loads(x) for x in so.splitlines()
                                 if x.startswith("{")],
                          head=(so + se)[:1500] if rc != 0 else "",
                          tail=(so + se)[-1500:] if rc != 0 else "")
        print(label, json.dumps(out[label]), flush=True)
        if label == "memcheck plain_small" and rc != 0:
            break  # the tool does not run here: no second attempt
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", action="store_true")
    ap.add_argument("--fault-case", default=None)
    ap.add_argument("--collectives", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    ap.add_argument("--rank-out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("while_probe: needs a CUDA device", file=sys.stderr)
        return 2
    if args.fault_case:
        return fault_case(torch, torch.device("cuda", 0), args.fault_case)
    if args.rank is not None:
        return collectives_rank(torch, args.rank, args.collectives,
                                args.store, args.rank_out)
    if args.fault or args.collectives:
        res = {"versions": versions(torch)}
        t0 = time.perf_counter()
        probe_library()
        res["probe_build_s"] = time.perf_counter() - t0
        if args.fault:
            from polydeal_tpu_torch.ops import _build

            t0 = time.perf_counter()
            _build.load_library()  # once, for every case's process
            res["build_s"] = time.perf_counter() - t0
            res["fault"] = fault()
        else:
            res["collectives"] = collectives(args.collectives)
        return write(res, args.out)
    from polydeal_tpu_torch.ops import _build
    from polydeal_tpu_torch.parallel.sharding import init_group, leave_group

    dev = torch.device("cuda", 0)
    if args.out:
        DOT_DIR[0] = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(DOT_DIR[0], exist_ok=True)
    res = {"versions": versions(torch)}
    t0 = time.perf_counter()
    _build.load_library()
    res["build_s"] = time.perf_counter() - t0
    for key, fn in (("child_body", lambda: child_body(torch, dev)),
                    ("setter_in_capture",
                     lambda: setter_in_capture(torch, dev)),
                    ("nested", lambda: nested(torch, dev))):
        res[key] = guarded(fn)
        print(key, json.dumps(res[key]), flush=True)
    store = tempfile.mkdtemp(prefix="while_probe_")
    group = init_group(0, 1, device=dev,
                       store_path=os.path.join(store, "store"))
    res["bodies"] = bodies(torch, dev, group)
    for k, v in res["bodies"].items():
        print(k, json.dumps(v), flush=True)
    leave_group()
    return write(res, args.out)


def write(res, out):
    line = json.dumps(res)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
