"""The captured solves (``solvers/graphs``): which solves capture, launch
accounting, and graph against eager on a card.

On the CPU: a replay adds its program's launch counts; ``CGLoop`` refuses
a CPU tensor; ``Multigrid.graph_ok`` admits banded and packed hierarchies
and refuses block-ELL and matrix-free levels and bf16 smoothing vectors;
``capture=True`` raises on the CPU (nothing falls back), and
``capture=False`` is the CPU's own path.

On a card (``-m cuda``; the file imports no JAX, so it runs there with
``--noconftest``), f64 at n=8 (levels 8/64/512):
* the lex flagship and the ``relabel=None`` one (levels packed from 0
  polytopes), FMG on: the captured solve takes the eager solve's
  iterations to a solution within 1e-12 relative (the same kernels on the
  same data; the captured products may take other cuBLAS algorithms), a
  second captured solve queues no masked body, and a warm captured solve
  counts the same launches per kernel as the eager one;
* the monodomain (n_refinements=3, lex): a BDF1 step and four BDF2 steps
  through ``steps_scan`` captured and eager, the same iterations per step,
  u and w within 1e-12;
* the sharded system at world size 1 (no process group):
  ``solve_cg_async`` against the eager ``solve_cg_local``;
* a capture that syncs with the host raises.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.models.flagship import (  # noqa: E402
    setup_flagship,
    solve_flagship,
)
from polydeal_tpu_torch.models.monodomain import (  # noqa: E402
    MonodomainSolver,
    bench_config,
)
from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.parallel.banded import (  # noqa: E402
    ShardedBandedSystem,
)
from polydeal_tpu_torch.solvers import graphs  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
F64 = dict(n=8, dtype=torch.float64, precond_dtype=None)


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_counts_the_programs_launches(monkeypatch):
    counts = dict.fromkeys(_build.launches, 0)
    monkeypatch.setattr(_build, "launches", counts)
    prog = graphs.Program(_Graph(), {"banded_matvec_imajor": 3,
                                     "banded_fused_cheb": 12}, 0.0, 0)
    for _ in range(4):
        prog.replay()
    assert prog.graph.replays == 4
    assert counts["banded_matvec_imajor"] == 12
    assert counts["banded_fused_cheb"] == 48
    assert sum(counts.values()) == 60


def test_cg_loop_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CGLoop(lambda v: v, None, torch.zeros(4), rtol=1e-8,
                      maxiter=10)


@pytest.fixture(scope="module")
def lex():
    return setup_flagship(device=CPU, **F64)


def test_graph_rule(lex):
    mg = lex.mg
    assert mg.graph_ok()
    # a block-ELL level, or a matrix-free fine level, keeps the eager loop
    ells = list(mg.ells)
    ells[1] = ells[1].to_block_matrix().to_ell()
    assert not dataclasses.replace(mg, ells=ells).graph_ok()
    mf = tmg.MatrixFreeLevel(None, mg.ells[-1].diagonal())
    assert not dataclasses.replace(mg, ells=ells[:-1] + [mf]).graph_ok()
    # bf16 smoothing vectors too (a later port)
    bf = [None] + [d.to(torch.bfloat16) for d in mg.dinvs_t[1:]]
    assert not dataclasses.replace(mg, lo_ells=list(mg.ells),
                                   lo_dinvs=bf).graph_ok()
    # f32 band copies for the smoother's products are captured
    fs = setup_flagship(n=8, device=CPU, dtype=torch.float64,
                        precond_dtype=torch.float32)
    assert fs.mg.graph_ok()


def test_capture_true_raises_on_the_cpu(lex):
    want = solve_flagship(lex)
    got = solve_flagship(lex, capture=False)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)
    with pytest.raises(ValueError):
        solve_flagship(lex, capture=True)
    s = MonodomainSolver.build(bench_config(3), dtype=torch.float64,
                               relabel="lex", device=CPU)
    u, w = s.initial_state()
    with pytest.raises(ValueError):
        s.step(u, u, w, 0.0, True, capture=True)
    with pytest.raises(ValueError):
        s.steps_scan(u, u, w, 0.0, 2, capture=True)


# ---- on a card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _counts_of(fn):
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in _build.launches.items() if n}


@pytest.mark.cuda
@pytest.mark.parametrize("relabel", ["lex", None], ids=["lex", "packed"])
def test_cuda_graph_solve_matches_eager(cuda, relabel, monkeypatch):
    if relabel is None:
        monkeypatch.setattr(tmg, "PACK_MIN_P", 0)
    fs = setup_flagship(device=cuda, relabel=relabel, **F64)
    assert fs.mg.graph_ok()
    if relabel is None:
        assert fs.format == "packed"
    eager, c_eager = _counts_of(lambda: solve_flagship(fs, capture=False))
    cold = solve_flagship(fs)  # captures
    loop = fs.mg.cg_loop(1e-8, 100, torch.float64)
    assert loop.last["iterations"] == cold.iterations
    warm, c_warm = _counts_of(lambda: solve_flagship(fs))
    assert cold.iterations == warm.iterations == eager.iterations
    assert loop.last["masked"] == 0
    assert loop.last["replays"] == eager.iterations
    assert loop.last["host_reads"] == eager.iterations + 1
    assert torch.equal(cold.x, warm.x)
    assert _rel(warm.x, eager.x) <= 1e-12
    assert c_warm == c_eager
    assert all(p.launches for p in loop.captured)


@pytest.mark.cuda
def test_cuda_graph_monodomain_matches_eager(cuda):
    s = MonodomainSolver.build(bench_config(3), dtype=torch.float64,
                               relabel="lex", device=cuda)
    dt = s.cfg.dt
    out = {}
    for capture in (False, True):
        u, w = s.initial_state()
        u1, w1, it1 = s.step(u, u, w, 0.0, True, capture=capture)
        uf, up, wf, its = s.steps_scan(u1, u, w1, dt, 4, capture=capture)
        out[capture] = ([it1] + its, uf, up, wf)
    (ie, *ve), (ig, *vg) = out[False], out[True]
    assert ie == ig and all(2 <= i <= 5 for i in ie)
    for a, b in zip(vg, ve):
        assert _rel(a, b) <= 1e-12


@pytest.mark.cuda
def test_cuda_solve_cg_async(cuda):
    fs = setup_flagship(device=cuda, hierarchy="structured", **F64)
    ss = ShardedBandedSystem.from_multigrid(fs.mg)
    assert ss.graph_ok(fs.b)
    x, k, res = ss.solve_cg_async(fs.b, rtol=1e-9, maxiter=100)
    assert k.device.type == "cuda" and x.device.type == "cuda"
    xe, ke, re = ss.solve_cg_local(fs.b, rtol=1e-9, maxiter=100,
                                   capture=False)
    xl, kl, rl = ss.solve_cg_local(fs.b, rtol=1e-9, maxiter=100)
    assert int(k) == ke == kl
    assert torch.equal(xl, x)
    assert _rel(x, xe) <= 1e-12


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda):
    x = torch.ones(8, device=cuda)
    out = torch.zeros(8, device=cuda)
    with pytest.raises(RuntimeError):
        graphs.capture(lambda: x * float(x.sum()), out.copy_, device=cuda,
                       pool=torch.cuda.graph_pool_handle())
