"""The device loops (``csrc/graph_loop.cu``, ``solvers/graphs.LoopProgram``):
CUDA graphs whose conditional WHILE nodes run a solve's loop on the card.

On the CPU: the ctypes prototypes ``ops/_build.GRAPH_LOOP_ENTRIES`` gives
the C entries match their declarations in ``csrc/graph_loop.cu``, and
``tools/while_probe.PROBE_ENTRIES`` those in ``tools/while_probe.cu``,
read from the sources as text (the libraries build only where nvcc is);
a program's launch counts are added once a run it made; a loop refuses a
flag that is not one bool and a count of tests that is not one int64;
``CGLoop`` and ``GMRESLoop`` refuse a CPU tensor (capture has no CPU
mode).

On a card (``-m cuda``; the file imports no JAX, so it runs there with
``--noconftest``), f64:
* ``set_condition`` to its plain meaning: a loop whose body adds one to a
  device counter until it reaches n stops at n and counts n + 1 tests,
  for n = 0, 1 and 37, two launches alike;
* CG (the n=8 lex flagship) as one device program against the eager
  loop: the same iterations, x within 1e-12, one host read, the body run
  once an iteration and ``set_condition`` once more (the device's count
  of tests); a zero right-hand side takes 0 iterations both ways;
* GMRES (darcy_stokes n=8, MG-GMRES) the same, with ``max_restarts=0``
  (no cycle) giving 0 iterations both ways;
* the monodomain's ``steps_scan`` (n_refinements=3, lex, BDF1 then 4 BDF2
  steps): the eager iterations per step, u within 1e-12, one host read
  for the four steps.
"""

import ctypes
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.solvers import graphs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import while_probe  # noqa: E402

# each library's entries and the source that declares them
LIBRARIES = {
    "graph_loop": (_build.GRAPH_LOOP_ENTRIES,
                   os.path.join(ROOT, "polydeal_tpu_torch", "csrc",
                                "graph_loop.cu")),
    "while_probe": (while_probe.PROBE_ENTRIES, while_probe.PROBE_SRC)}

# C parameter and return types of the entries, as ctypes passes them
C_TYPES = {"void*": ctypes.c_void_p, "void**": ctypes.c_void_p,
           "const void*": ctypes.c_void_p, "long long*": ctypes.c_void_p,
           "unsigned long long*": ctypes.c_void_p,
           "unsigned long long": ctypes.c_ulonglong, "int": ctypes.c_int,
           "const char*": ctypes.c_char_p}


def _declarations(src):
    """{name: ([parameter types], return type)} of the extern "C" entries
    of the source ``src``."""
    with open(src) as f:
        text = f.read()
    body = text[text.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(
            r"^(int|const char\*) (pd_\w+)\(([^)]*)\)", body, re.M):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if p:
                types.append(re.sub(r"\s*\w+$", "", p).replace(" *", "*"))
        out[name] = (types, ret)
    return out


def test_every_entry_has_a_prototype():
    for entries, src in LIBRARIES.values():
        assert set(_declarations(src)) == set(entries)


@pytest.mark.parametrize("lib, name", [
    pytest.param(lib, name, id=name)
    for lib, (entries, _) in sorted(LIBRARIES.items())
    for name in sorted(entries)])
def test_prototype_matches_the_source(lib, name):
    entries, src = LIBRARIES[lib]
    params, ret = _declarations(src)[name]
    args, res = entries[name]
    assert [C_TYPES[p] for p in params] == args
    assert C_TYPES[ret] == res


def test_probe_source_includes_the_loop_entries():
    """The probe's library holds the loop entries too (it runs the
    collectives' loops without the kernel library)."""
    with open(while_probe.PROBE_SRC) as f:
        assert '#include "../polydeal_tpu_torch/csrc/graph_loop.cu"' in \
            f.read()
    assert not set(while_probe.PROBE_ENTRIES) & set(
        _build.GRAPH_LOOP_ENTRIES)


@pytest.mark.parametrize("flag, tests", [
    (torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int64)),
    (torch.zeros(2, dtype=torch.bool), torch.zeros((), dtype=torch.int64)),
    (torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.int32)),
    (torch.zeros((), dtype=torch.bool), torch.zeros(2, dtype=torch.int64))],
    ids=["flag-int", "flag-two", "tests-int32", "tests-two"])
def test_loop_refuses_bad_flag_or_count(flag, tests):
    chain = graphs._Chain(None, None, [])
    with pytest.raises(ValueError, match="one (bool|int64)"):
        chain.loop(flag, lambda body: None, tests)


def test_program_count_adds_its_launches(monkeypatch):
    counts = dict.fromkeys(_build.launches, 0)
    monkeypatch.setattr(_build, "launches", counts)
    prog = graphs.Program(None, {"banded_fused_cheb": 12,
                                 "banded_matvec_imajor": 1}, 0.0, 0)
    prog.count(7)
    prog.count()
    assert counts["banded_fused_cheb"] == 96
    assert counts["banded_matvec_imajor"] == 8
    assert "set_condition" in counts


def test_loops_refuse_the_cpu():
    v = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CGLoop(lambda x: x, None, v, rtol=1e-8, maxiter=10)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GMRESLoop(lambda x: x, None, v, restart=4, rtol=1e-8,
                         max_restarts=2)


# ---- on a card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 37])
def test_cuda_set_condition_counts_to_n(cuda, n):
    pool = torch.cuda.graph_pool_handle()
    c = torch.zeros((), dtype=torch.int64, device=cuda)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    tests = torch.zeros((), dtype=torch.int64, device=cuda)

    def init(_):
        c.zero_()
        flag.copy_(c < n)

    def body(_):
        c.add_(1)
        flag.copy_(c < n)

    pi = graphs.capture(None, init, device=cuda, pool=pool)
    pb = graphs.capture(None, body, device=cuda, pool=pool)

    def build(ch):
        ch.child(pi)
        ch.loop(flag, lambda b: b.child(pb), tests)

    prog = graphs.LoopProgram(build, cuda)
    got = []
    for _ in range(2):
        tests.zero_()
        prog.launch()
        got.append((int(c), int(tests)))
    assert got == [(n, n + 1), (n, n + 1)]


@pytest.mark.cuda
def test_cuda_cg_while_matches_eager(cuda):
    from polydeal_tpu_torch.models.flagship import setup_flagship

    fs = setup_flagship(n=8, device=cuda, dtype=torch.float64,
                        precond_dtype=None)
    mg = fs.mg
    for b in (fs.b, torch.zeros_like(fs.b)):
        eager = mg.solve_cg(b, rtol=1e-8, maxiter=100, capture=False)
        mg.solve_cg(b, rtol=1e-8, maxiter=100)  # captures
        _build.reset_launches()
        got = mg.solve_cg(b, rtol=1e-8, maxiter=100)
        torch.cuda.synchronize()
        loop = mg.cg_loop(1e-8, 100, torch.float64)
        assert got.iterations == eager.iterations
        assert loop.last == dict(runs=1, iterations=eager.iterations,
                                 replays=eager.iterations, host_reads=1)
        assert _build.launches["set_condition"] == eager.iterations + 1
        assert _rel(got.x, eager.x) <= 1e-12 if eager.iterations else \
            torch.equal(got.x, eager.x)
    assert eager.iterations == 0


@pytest.mark.cuda
def test_cuda_gmres_while_matches_eager(cuda):
    import polydeal_tpu_torch as tpd
    from polydeal_tpu_torch.models import darcy_stokes as ds
    from polydeal_tpu_torch.solvers.gmres import gmres_solve

    s, _ = ds.run(8, 2, device=cuda)
    A, b = ds._regularized(s), s.rhs
    M = ds.mg_block_preconditioner(s, tpd.hyper_cube(2, 8), 8, 2,
                                   ps_mode="mass+stab", structure="tri")
    for kw in (dict(restart=200, rtol=1e-11, max_restarts=40),
               dict(restart=200, rtol=1e-11, max_restarts=0)):
        loop = graphs.GMRESLoop(A, M, b, **kw)
        loop.solve(b)  # captures
        eager = gmres_solve(A, b, M=M, capture=False, **kw)
        got = loop.solve(b)
        assert got.iterations == eager.iterations
        assert loop.last["host_reads"] == 1
        assert loop.last["replays"] == eager.iterations
        assert _rel(got.x, eager.x) <= 1e-12 if eager.iterations else \
            torch.equal(got.x, eager.x)
    assert eager.iterations == 0 and loop.last["cycles"] == 0


@pytest.mark.cuda
def test_cuda_steps_scan_one_read(cuda):
    from polydeal_tpu_torch.models.monodomain import (MonodomainSolver,
                                                      bench_config)

    s = MonodomainSolver.build(bench_config(3), dtype=torch.float64,
                               relabel="lex", device=cuda)
    out = {}
    for capture in (False, True):
        u, w = s.initial_state()
        u1, w1, it1 = s.step(u, u, w, 0.0, True, capture=capture)
        uf, _, wf, its = s.steps_scan(u1, u, w1, s.cfg.dt, 4,
                                      capture=capture)
        out[capture] = ([it1] + its, uf, wf)
    loop = s.mg.cg_loop(s.cfg.solver.rtol, s.cfg.solver.max_iterations,
                        torch.float64)
    assert out[True][0] == out[False][0]
    assert loop.last == dict(runs=4, iterations=sum(out[True][0][1:]),
                             replays=sum(out[True][0][1:]), host_reads=1)
    for a, b in zip(out[True][1:], out[False][1:]):
        assert _rel(a, b) <= 1e-12
