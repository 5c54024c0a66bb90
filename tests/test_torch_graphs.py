"""The captured solves (``solvers/graphs``): which solves capture, launch
accounting, and graph against eager on a card.

On the CPU: a replay adds its program's launch counts; ``CGLoop`` and
``GMRESLoop`` refuse a CPU tensor; ``Multigrid.graph_ok`` admits banded,
packed, block-ELL and matrix-free levels and bf16 smoothing vectors, and
refuses a level of another kind and a hierarchy without a coarse solve;
``capture=True`` raises on the CPU (nothing falls back: the flagship, the
monodomain, GMRES, SA-AMG), and ``capture=False`` is the CPU's own path;
the newly admitted hierarchies (a block-ELL fine level from a permuted 2D
n=16 R-tree hierarchy and the n=8 flagship's levels under a matrix-free
fine level, both run flat; bf16 smoothing vectors) solve through the
same ``cg_init``/``cg_body`` a captured loop replays, blind bodies after
the stop leaving the state bitwise unchanged.

On a card (``-m cuda``; the file imports no JAX, so it runs there with
``--noconftest``), f64 at n=8 (levels 8/64/512):
* the lex flagship and the ``relabel=None`` one (levels packed from 0
  polytopes), FMG on: the captured solve takes the eager solve's
  iterations to a solution within 1e-12 relative (the same kernels on the
  same data; the captured products may take other cuBLAS algorithms), a
  second captured solve runs the body once an iteration with one host
  read, and a warm captured solve counts the same launches per kernel as
  the eager one, and ``set_condition`` once an iteration and once more;
* the monodomain (n_refinements=3, lex): a BDF1 step and four BDF2 steps
  through ``steps_scan`` captured and eager, the same iterations per step,
  u and w within 1e-12;
* the sharded system at world size 1 (no process group):
  ``solve_cg_async`` against the eager ``solve_cg_local``;
* GMRES (``GMRESLoop``) on darcy_stokes n=8 (MG-GMRES, block-triangular,
  and block-Jacobi GMRES) and oseen n=8 (MG-GMRES): the captured solve
  takes the eager iterations to x within 1e-12 relative; a warm solve
  runs the step once an iteration, reads the host once, counts the eager
  solve's launches and ``set_condition`` iterations + 2 cycles + 1
  times; the operator's lazy tables are made by the warm-up, before the
  capture;
* SA-AMG CG (2D n=16): the same against the eager loop;
* the three hierarchies above: captured against eager, the same
  iterations, x within 1e-12 (f64) or 1e-6 (bf16 vectors, f32);
* a capture that syncs with the host raises.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu_torch.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models import darcy_stokes as ds  # noqa: E402
from polydeal_tpu_torch.models import oseen as os_  # noqa: E402
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
from polydeal_tpu_torch.models.poisson import solve_poisson  # noqa: E402
from polydeal_tpu_torch.solvers import graphs  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402
from polydeal_tpu_torch.solvers.cg import cg_body, cg_init  # noqa: E402
from polydeal_tpu_torch.solvers.gmres import gmres_solve  # noqa: E402
from polydeal_tpu_torch.sparse import BlockELL  # noqa: E402

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
    # a block-ELL level, a matrix-free fine level and bf16 smoothing
    # vectors are captured too
    ells = list(mg.ells)
    ells[1] = ells[1].to_block_matrix().to_ell()
    assert dataclasses.replace(mg, ells=ells).graph_ok()
    mf = tmg.MatrixFreeLevel(None, mg.ells[-1].diagonal())
    assert dataclasses.replace(mg, ells=ells[:-1] + [mf]).graph_ok()
    bf = [None] + [d.to(torch.bfloat16) for d in mg.dinvs_t[1:]]
    assert dataclasses.replace(mg, lo_ells=list(mg.ells),
                               lo_dinvs=bf).graph_ok()
    # f32 band copies for the smoother's products are captured
    fs = setup_flagship(n=8, device=CPU, dtype=torch.float64,
                        precond_dtype=torch.float32)
    assert fs.mg.graph_ok()
    # a level of another kind, or no coarse solve, is not
    assert not dataclasses.replace(mg, ells=[object()] + ells[1:]).graph_ok()
    assert not dataclasses.replace(mg, coarse_lu=()).graph_ok()


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


def test_gmres_and_amg_refuse_capture_on_the_cpu():
    b = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GMRESLoop(lambda v: v, None, b, restart=4, rtol=1e-8,
                         max_restarts=2)
    with pytest.raises(ValueError, match="CUDA"):
        gmres_solve(lambda v: 2.0 * v, b, capture=True)
    r = gmres_solve(lambda v: 2.0 * v, b)  # the CPU's own path
    assert r.iterations == 1 and torch.allclose(r.x, b / 2)
    rp = solve_poisson(dim=2, n=8, solver="amg", device=CPU, verbose=False)
    amg = rp["amg"]
    with pytest.raises(ValueError, match="CUDA"):
        amg.solve_cg(rp["b"], capture=True)
    re = amg.solve_cg(rp["b"], capture=False)
    assert re.iterations == rp["iterations"]
    assert torch.equal(re.x, rp["x"])


def _permuted(device, n=16):
    """(handlers, parents, A, b) of a 2D R-tree hierarchy (levels from
    extraction level 2) whose fine polytopes are renumbered by a seeded
    permutation (parents remapped): the fine band has more than
    ``MAX_BAND_OFFSETS`` offsets, so the fine level is block-ELL."""
    m = tpd.hyper_cube(2, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    hs, ps = tmg.build_rtree_hierarchy(m, agg, list(range(2, agg.n_levels
                                                          - 1)), degree=1)
    perm = np.random.default_rng(3).permutation(hs[-1].n_poly)
    hs = hs[:-1] + [tpd.AgglomerationHandler(m, perm[hs[-1].cell2poly],
                                             degree=1)]
    ps = ps[:-1] + [np.asarray(ps[-1])[np.argsort(perm)]]
    u = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    A = tsipg.assemble_sipg_matrix(hs[-1], device=device)
    b = tsipg.assemble_rhs(hs[-1], lambda x: 2 * math.pi**2 * u(x), u,
                           device=device)
    return hs, ps, A, b


def _admitted(kind, device):
    """(multigrid, rhs, rtol, fmg, maxiter) of a hierarchy the graph rule
    newly admits: a block-ELL or matrix-free fine level (the flat layout),
    bf16 smoothing vectors."""
    if kind == "ell":
        hs, ps, A, b = _permuted(device)
        mg = tmg.build_multigrid(hs, ps, A, device=device)
        assert isinstance(mg.ells[-1], BlockELL)
        return mg, b, 1e-9, False, 200
    if kind == "matfree":  # the flagship's levels under a matrix-free one
        fs = setup_flagship(device=device, **F64)
        mg = tmg.build_multigrid(fs.handlers, fs.parents, None,
                                 grid_shapes=fs.grid_shapes,
                                 level_assembly="banded", matfree_fine=True,
                                 device=device)
        assert isinstance(mg.ells[-1], tmg.MatrixFreeLevel)
        return mg, fs.b, 1e-8, True, 200
    fs = setup_flagship(n=8, device=device, vector_dtype=torch.bfloat16)
    assert fs.mg.lo_dinvs[-1].dtype == torch.bfloat16
    return fs.mg, fs.b, 1e-8, True, 200


@pytest.mark.parametrize("kind", ["ell", "matfree", "bf16"])
def test_admitted_hierarchy_masked_bodies(kind):
    """The CG a captured loop replays on such a hierarchy (flat where the
    fine level is: ``Multigrid._fine_layout``), run on the CPU as the loop
    runs it: ``cg_init``, bodies to the stop, then blind bodies, each
    leaving the state bitwise unchanged; the result is ``solve_cg``'s
    bitwise."""
    mg, b, rtol, fmg, maxiter = _admitted(kind, CPU)
    assert mg.graph_ok()
    assert mg._is_t(mg.n_levels - 1) == (kind == "bf16")
    want = mg.solve_cg(b, rtol=rtol, fmg=fmg, maxiter=maxiter)
    assert want.iterations > 1
    with pytest.raises(ValueError):
        mg.solve_cg(b, rtol=rtol, fmg=fmg, maxiter=maxiter, capture=True)
    A, M, to_in, to_out = mg._fine_layout()
    bt = to_in(b)
    st, tol = cg_init(A, bt, mg.fmg_guess(bt) if fmg else None, M, rtol,
                      maxiter=maxiter)
    while bool(st.active):
        st = cg_body(A, M, st, tol, maxiter)
    for _ in range(3):
        nxt = cg_body(A, M, st, tol, maxiter)
        assert all(torch.equal(p, q) for p, q in zip(nxt, st))
        st = nxt
    assert int(st.k) == want.iterations
    assert torch.equal(to_out(st.x), want.x)


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


def _kernels(counts):
    """The port's kernels' counts: all but ``set_condition``, which only
    a device loop launches (once a test of its condition)."""
    return {k: n for k, n in counts.items() if k != "set_condition"}


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
    assert loop.last["replays"] == eager.iterations
    assert loop.last["host_reads"] == 1
    assert torch.equal(cold.x, warm.x)
    assert _rel(warm.x, eager.x) <= 1e-12
    assert _kernels(c_warm) == c_eager
    assert c_warm["set_condition"] == eager.iterations + 1
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


def _coupled(kind, device):
    """(A, M, b, GMRES keywords, the mixed operator) of a coupled solve at
    n=8: darcy_stokes' MG-GMRES (block-triangular) and block-Jacobi GMRES,
    oseen's MG-GMRES."""
    mg_kw = dict(restart=200, rtol=1e-11, max_restarts=40)
    if kind.startswith("darcy"):
        s, _ = ds.run(8, 2, device=device)
        A, b, op = ds._regularized(s), s.rhs, s.op
        if kind == "darcy-bj":
            return A, op.block_jacobi(), b, dict(restart=60, rtol=1e-10,
                                                 max_restarts=200), op
        M = ds.mg_block_preconditioner(s, tpd.hyper_cube(2, 8), 8, 2,
                                       ps_mode="mass+stab", structure="tri")
        return A, M, b, mg_kw, op
    space, _, meta = os_.run(8, 2, device=device)
    op, b = meta["system"]
    M = os_.oseen_mg_preconditioner(space, op, meta, os_._rectangle(8), 8, 2)
    return os_._regularized(space, op, meta), M, b, mg_kw, op


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["darcy-mg", "darcy-bj", "oseen-mg"])
def test_cuda_gmres_graph_matches_eager(cuda, kind):
    A, M, b, kw, op = _coupled(kind, cuda)
    assert op._plans is None  # the warm-up before the capture makes them
    loop = graphs.GMRESLoop(A, M, b, **kw)
    cold = loop.solve(b)  # captures
    assert op._plans
    eager, c_eager = _counts_of(lambda: gmres_solve(A, b, M=M, capture=False,
                                                    **kw))
    warm, c_warm = _counts_of(lambda: loop.solve(b))
    assert cold.iterations == warm.iterations == eager.iterations > 1
    assert loop.last["replays"] == eager.iterations
    assert loop.last["host_reads"] == 1
    assert torch.equal(cold.x, warm.x)
    assert _rel(warm.x, eager.x) <= 1e-12
    assert _kernels(c_warm) == c_eager
    assert c_warm["set_condition"] == (eager.iterations
                                       + 2 * loop.last["cycles"] + 1)
    assert len(loop.captured) == 4  # the reset, cycle start, step, end
    # gmres_solve captures by default on the card
    assert gmres_solve(A, b, M=M, **kw).iterations == eager.iterations


@pytest.mark.cuda
def test_cuda_amg_graph_matches_eager(cuda):
    rp = solve_poisson(dim=2, n=16, solver="amg", device=cuda, verbose=False)
    amg, b = rp["amg"], rp["b"]
    cold = amg.solve_cg(b)  # the captured programs' second solve
    eager = amg.solve_cg(b, capture=False)
    warm = amg.solve_cg(b)
    loop = amg._loops[(1e-9, 300, b.dtype)][0]
    assert cold.iterations == warm.iterations == eager.iterations \
        == rp["iterations"]
    assert loop.last["host_reads"] == 1 and loop.total["runs"] == 3
    assert torch.equal(cold.x, warm.x) and torch.equal(cold.x, rp["x"])
    assert _rel(warm.x, eager.x) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ell", "matfree", "bf16"])
def test_cuda_admitted_hierarchy_graph_matches_eager(cuda, kind):
    mg, b, rtol, fmg, maxiter = _admitted(kind, cuda)
    kw = dict(rtol=rtol, fmg=fmg, maxiter=maxiter)
    eager = mg.solve_cg(b, capture=False, **kw)
    cold = mg.solve_cg(b, **kw)  # captures
    warm = mg.solve_cg(b, **kw)
    assert cold.iterations == warm.iterations == eager.iterations > 1
    last = mg.cg_loop(rtol, maxiter, b.dtype).last
    assert last["replays"] == eager.iterations and last["host_reads"] == 1
    assert torch.equal(cold.x, warm.x)
    assert _rel(warm.x, eager.x) <= (1e-6 if kind == "bf16" else 1e-12)


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda):
    x = torch.ones(8, device=cuda)
    out = torch.zeros(8, device=cuda)
    with pytest.raises(RuntimeError):
        graphs.capture(lambda: x * float(x.sum()), out.copy_, device=cuda,
                       pool=torch.cuda.graph_pool_handle())
