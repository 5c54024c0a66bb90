"""The port's device-loop solves against the JAX package's one-program
solves, on the CPU.

The JAX side runs as ``tests/conftest.py`` sets it up (CPU, x64); the port
at f64 on the CPU, where every solve runs the device-loop body eagerly
(the captured programs need a card: ``tests/test_torch_graphs.py``).
Checked here:

* ``cg_solve`` (``cg_init``, ``cg_body``, ``cg_finish``) against the JAX
  ``cg_solve``'s ``lax.while_loop`` on one seeded SPD stencil system with
  a Jacobi preconditioner: zero and given ``x0``, an ``atol`` stop, ``maxiter``
  reached and an already converged ``b`` (k = 0); the same iterations, x
  within 1e-12 relative;
* bodies after convergence (or after ``maxiter``) leave ``(x, r, p, rz,
  k, active)`` bitwise unchanged, so ``maxiter`` blind bodies give
  ``cg_solve``'s result bitwise: what the captured loop's masked replays
  rely on;
* ``Multigrid.solve_cg`` with FMG on and off against the JAX package's on
  the n=8 lex flagship hierarchy;
* the monodomain ``step`` with the time as a device scalar before, at and
  after the stimulus' end, and ``steps_scan`` against the JAX
  ``lax.scan``: the same iterations per step, u and w within 1e-12;
* ``ShardedBandedSystem.solve_cg_async`` at world size 1 against
  ``solve_cg_local`` (bitwise) and the JAX package's ``solve_cg_async``
  on a one-device mesh;
* ``BlockBanded @ x`` and ``BlockPacked @ x`` against the JAX operators.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu.config as jcfg  # noqa: E402
import polydeal_tpu.models.monodomain as jmono  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.ops.packed import build_pack_plan  # noqa: E402
from polydeal_tpu.parallel import make_mesh  # noqa: E402
from polydeal_tpu.parallel.banded import (  # noqa: E402
    ShardedBandedSystem as JShardedBandedSystem,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_multigrid,
    build_rtree_hierarchy,
    build_structured_hierarchy,
    detect_grid_shapes,
)
from polydeal_tpu.solvers.cg import cg_solve as jcg_solve  # noqa: E402
from polydeal_tpu_torch import config as tcfg  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.models import monodomain as tmono  # noqa: E402
from polydeal_tpu_torch.models.flagship import setup_flagship  # noqa: E402
from polydeal_tpu_torch.ops import packed as tpk  # noqa: E402
from polydeal_tpu_torch.parallel.banded import (  # noqa: E402
    ShardedBandedSystem,
)
from polydeal_tpu_torch.solvers import cg as tcg  # noqa: E402

CPU = torch.device("cpu")
N = 8
DT = 5e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ---- cg_solve ------------------------------------------------------------

@pytest.fixture(scope="module")
def spd():
    """A seeded SPD system: the 1D stencil d_i v_i - v_{i-1} - v_{i+1}
    (n=200, d_i in [2.1, 3.1): condition ~40), elementwise in both
    packages, so only the dots' summation orders differ; b and x0."""
    rng = np.random.default_rng(13)
    n = 200
    return (2.1 + rng.uniform(0, 1, n), rng.standard_normal(n),
            rng.standard_normal(n))


def _stencil(d, xp):
    cat = jnp.concatenate if xp is jnp else torch.cat

    def apply(v):
        z = xp.zeros(1, dtype=v.dtype)
        return d * v - cat([v[1:], z]) - cat([z, v[:-1]])

    return apply


# (name, cg keyword arguments, whether x0 is given, whether b is zero)
CG_CASES = [
    ("zero_x0", dict(rtol=1e-10, maxiter=200), False, False),
    ("given_x0", dict(rtol=1e-10, maxiter=200), True, False),
    ("atol_stop", dict(rtol=1e-14, atol=1e-3, maxiter=200), False, False),
    ("maxiter", dict(rtol=1e-14, maxiter=7), False, False),
    ("converged_b", dict(rtol=1e-10, maxiter=200), False, True),
]


def _both_cg(spd, kw, with_x0, zero_b):
    d, b, x0 = spd
    if zero_b:
        b = np.zeros_like(b)
    dj = jnp.asarray(d)
    ref = jcg_solve(_stencil(dj, jnp), jnp.asarray(b),
                    x0=jnp.asarray(x0) if with_x0 else None,
                    M=lambda r: r / dj, **kw)
    dt_ = torch.from_numpy(d)
    args = (_stencil(dt_, torch), torch.from_numpy(b))
    tkw = dict(x0=torch.from_numpy(x0) if with_x0 else None,
               M=lambda r: r / dt_, **kw)
    return ref, args, tkw


@pytest.mark.parametrize("name,kw,with_x0,zero_b", CG_CASES,
                         ids=[c[0] for c in CG_CASES])
def test_cg_matches_jax_while_loop(spd, name, kw, with_x0, zero_b):
    ref, args, tkw = _both_cg(spd, kw, with_x0, zero_b)
    got = tcg.cg_solve(*args, **tkw)
    assert got.iterations == int(ref.iterations)
    if name == "maxiter":
        assert got.iterations == kw["maxiter"]
    if name == "converged_b":
        assert got.iterations == 0
        assert float(got.x.abs().max()) == 0.0
    else:
        assert got.iterations > 0
        assert _rel(got.x.numpy(), ref.x) <= 1e-12
    assert abs(float(got.residual) - float(ref.residual)) <= 1e-12 * max(
        float(ref.residual), np.abs(spd[1]).max())


@pytest.mark.parametrize("name,kw,with_x0,zero_b", CG_CASES,
                         ids=[c[0] for c in CG_CASES])
def test_masked_bodies_leave_the_state_bitwise(spd, name, kw, with_x0,
                                               zero_b):
    """maxiter + 3 bodies without a host read (the captured loop's
    replays) give cg_solve's state bitwise, and each body after the stop
    returns every state tensor unchanged."""
    _, (A, b), tkw = _both_cg(spd, kw, with_x0, zero_b)
    x0, M = tkw.pop("x0"), tkw.pop("M")
    want = tcg.cg_solve(A, b, x0=x0, M=M, **tkw)
    st, tol = tcg.cg_init(A, b, x0, M, kw["rtol"], kw.get("atol", 0.0),
                          kw["maxiter"])
    for _ in range(want.iterations):
        assert bool(st.active)
        st = tcg.cg_body(A, M, st, tol, kw["maxiter"])
    assert not bool(st.active)
    assert int(st.k) == want.iterations
    for _ in range(kw["maxiter"] - want.iterations + 3):
        nxt = tcg.cg_body(A, M, st, tol, kw["maxiter"])
        assert all(torch.equal(a, c) for a, c in zip(nxt, st))
        assert all(a.dtype == c.dtype for a, c in zip(nxt, st))
        st = nxt
    x, res = tcg.cg_finish(st)
    assert torch.equal(x, want.x) and torch.equal(res, want.residual)


def test_cg_with_a_dot_matches_jax(spd):
    """The all-reduced dot's form (norms as sqrt(dot(v, v)))."""
    ref, args, tkw = _both_cg(spd, dict(rtol=1e-10, maxiter=200), False,
                              False)
    got = tcg.cg_solve(*args, dot=lambda a, c: torch.dot(a, c), **tkw)
    assert got.iterations == int(ref.iterations)
    assert _rel(got.x.numpy(), ref.x) <= 1e-12


# ---- Multigrid.solve_cg ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_lex():
    """The lex flagship hierarchy at n=8 on the JAX package, f64, as its
    tests run it, solved with FMG off and on."""
    mesh = pd.hyper_cube(3, N)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    handlers, parents = build_rtree_hierarchy(
        mesh, agg, list(range(max(1, agg.n_levels - 4), agg.n_levels - 1)),
        degree=1, relabel="lex")
    gs = detect_grid_shapes(handlers, parents)
    mg, b = _jax_mg(handlers, parents, gs)
    out = {}
    for fmg in (False, True):
        res = mg.solve_cg(b, rtol=1e-8, maxiter=100, fmg=fmg)
        out[fmg] = (np.asarray(res.x), int(res.iterations))
    return out


def _jax_mg(handlers, parents, gs):
    ah = handlers[-1]
    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    groups = build_banded_groups(ah, offs, jnp.float64)
    A0 = assemble_sipg_banded_direct(ah, groups, offsets=offs,
                                     use_pallas=False)
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    b = assemble_rhs_direct(ah, groups, lambda x: 3 * jnp.pi**2 * u_ex(x),
                            u_ex)
    mg = build_multigrid(handlers, parents, A0, dtype=jnp.float64,
                         grid_shapes=gs, chebyshev_degree=5, n_smooth=1,
                         smoothing_range=20.0, level_assembly="banded",
                         coarse_solver="inv", fused_smoother=False)
    return mg, b


@pytest.mark.parametrize("fmg", [False, True], ids=["zero", "fmg"])
def test_multigrid_solve_matches_jax(jax_lex, fmg):
    fs = setup_flagship(n=N, device=CPU, dtype=torch.float64,
                        precond_dtype=None)
    assert fs.mg.graph_ok()  # the hierarchy the card captures
    res = fs.mg.solve_cg(fs.b, rtol=1e-8, maxiter=100, fmg=fmg)
    x, its = jax_lex[fmg]
    assert res.iterations == its
    assert _rel(res.x.numpy(), x) <= 1e-12
    assert float(res.residual) <= 1e-8 * float(fs.b.norm())


# ---- the monodomain ----------------------------------------------------------

def _mono_cfg(mod):
    cfg = mod.MonodomainConfig(
        dim=2, n_refinements=4, degree=1, time_stepping_scheme="BDF2",
        dt=DT, final_time=5 * DT, end_time_current=2 * DT,
        applied_current=300.0, stimulus_radius=0.3)
    cfg.solver.rtol = 1e-8
    return cfg


# step times: before the stimulus ends, at its end (off: t < end is
# false), after it
STEP_TIMES = (1.5 * DT, 2 * DT, 2.5 * DT)


@pytest.fixture(scope="module")
def mono():
    """Both solvers (lex, 2D n_refinements=4) and the JAX results: one
    BDF1 step at each of STEP_TIMES from a perturbed state, and BDF1 then
    four BDF2 steps through its lax.scan."""
    js = jmono.MonodomainSolver.build(_mono_cfg(jcfg), relabel="lex")
    ts = tmono.MonodomainSolver.build(_mono_cfg(tcfg), dtype=torch.float64,
                                      relabel="lex", device=CPU)
    u0, w0 = js.initial_state()
    u0 = u0 + 0.05 * jnp.asarray(
        np.random.default_rng(5).standard_normal(u0.shape))
    steps = {}
    for t in STEP_TIMES:
        u1, w1, it = jax.jit(lambda a, c, t=t: js.step(a, a, c, t, True))(
            u0, w0)
        steps[t] = (np.asarray(u1), np.asarray(w1), int(it))
    uz, wz = js.initial_state()
    u1, w1, it1 = jax.jit(lambda a, c: js.step(a, a, c, 0.0, True))(uz, wz)
    uf, up, wf, its = js.steps_scan(u1, uz, w1, DT, 4)
    scan = dict(iters=[int(it1)] + [int(i) for i in np.asarray(its)],
                u=np.asarray(uf), u_prev=np.asarray(up), w=np.asarray(wf))
    return dict(ts=ts, u0=np.asarray(u0), w0=np.asarray(w0), steps=steps,
                scan=scan)


@pytest.mark.parametrize("t", STEP_TIMES, ids=["before", "at", "after"])
def test_step_stimulus_switch_matches_jax(mono, t):
    ts = mono["ts"]
    u0, w0 = (torch.tensor(mono[k]) for k in ("u0", "w0"))
    u1, w1, it = ts.step(u0, u0, w0, torch.tensor(t, dtype=torch.float64),
                         True)
    ru, rw, rit = mono["steps"][t]
    assert it == rit
    assert _rel(u1.numpy(), ru) <= 1e-12
    assert _rel(w1.numpy(), rw) <= 1e-12
    # a float time is the same step
    u2, w2, it2 = ts.step(u0, u0, w0, t, True)
    assert it2 == it and torch.equal(u2, u1) and torch.equal(w2, w1)


def test_stimulus_switches_off(mono):
    """The three step times give two distinct steps: stimulus on before
    the end, off at and after it."""
    u = {t: mono["steps"][t][0] for t in STEP_TIMES}
    assert np.abs(u[STEP_TIMES[0]] - u[STEP_TIMES[1]]).max() > 1e-6
    assert np.array_equal(u[STEP_TIMES[1]], u[STEP_TIMES[2]])


def test_steps_scan_matches_jax_scan(mono):
    ts, ref = mono["ts"], mono["scan"]
    u, w = ts.initial_state()
    u1, w1, it1 = ts.step(u, u, w, 0.0, True)
    uf, up, wf, its = ts.steps_scan(u1, u, w1, DT, 4)
    assert [it1] + its == ref["iters"]
    assert all(2 <= i <= 6 for i in its)
    for got, key in ((uf, "u"), (up, "u_prev"), (wf, "w")):
        assert _rel(got.numpy(), ref[key]) <= 1e-12
    # the time loop of run() is the same trajectory
    ur, wr, itr = ts.run(n_steps=5)
    assert itr == ref["iters"]
    assert torch.equal(ur, uf) and torch.equal(wr, wf)


# ---- ShardedBandedSystem.solve_cg_async -------------------------------------

@pytest.fixture(scope="module")
def jax_structured():
    """The structured n=8 system's sharded solve on a one-device JAX
    mesh."""
    mesh = pd.hyper_cube(3, N)
    handlers, parents, gs = build_structured_hierarchy(
        mesh, N, degree=1, coarsest_side=max(2, N >> 3))
    mg, b = _jax_mg(handlers, parents, gs)
    x, k, res = JShardedBandedSystem.from_multigrid(
        mg, make_mesh(1)).solve_cg_async(b, rtol=1e-9, maxiter=100)
    return np.asarray(x), int(k[0]), float(res[0])


def test_solve_cg_async_matches_local_and_jax(jax_structured):
    fs = setup_flagship(n=N, device=CPU, dtype=torch.float64,
                        precond_dtype=None, hierarchy="structured")
    ss = ShardedBandedSystem.from_multigrid(fs.mg)
    assert not ss.graph_ok(fs.b)  # the CPU runs the eager body
    x, k, res = ss.solve_cg_async(fs.b, rtol=1e-9, maxiter=100)
    assert isinstance(k, torch.Tensor) and k.dtype == torch.int32
    assert x.shape == (ss.nb, ss.levels[-1].per)
    xl, kl, rl = ss.solve_cg_local(fs.b, rtol=1e-9, maxiter=100)
    assert int(k) == kl and torch.equal(x, xl) and torch.equal(res, rl)
    jx, jk, jres = jax_structured
    assert int(k) == jk
    assert _rel(x.T.reshape(-1).numpy(), jx) <= 1e-12
    assert abs(float(res) - jres) <= 1e-12 * float(fs.b.norm())
    with pytest.raises(ValueError):  # graphs need a card
        ss.solve_cg_local(fs.b, capture=True)


# ---- __matmul__ ----------------------------------------------------------

def test_matmul_matches_jax():
    """``A @ x`` of a band and its pack (the 2D n=16 R-tree leaf level,
    leaf-rank order) against the JAX operators, f64."""
    m = pd.hyper_cube(2, 16)
    agg = RTreeAgglomerator.build(m.cell_centers())
    h = pd.AgglomerationHandler(m, agg.extract_agglomerates(
        agg.n_levels - 1), degree=1)
    ft = h.faces
    interior = ~ft.is_boundary
    src, dst = ft.poly_in[interior], ft.poly_out[interior]
    diffs = (dst - src).astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    A = assemble_sipg_banded_direct(
        h, build_banded_groups(h, offs, jnp.float64), offsets=offs,
        use_pallas=False)
    plan, oid, _, _ = build_pack_plan(src, dst, h.n_poly, h.n_basis,
                                      offsets=offs, near_limit=-1)
    Ap = A.to_packed(plan, jnp.asarray(oid))
    tA = interop.banded_from_arrays(A.data, offs, h.n_poly, device=CPU)
    tplan, toid, _, _ = tpk.build_pack_plan(src, dst, h.n_poly, h.n_basis,
                                            offsets=offs, near_limit=-1)
    tAp = tA.to_packed(tplan, torch.as_tensor(toid))
    x = np.random.default_rng(8).standard_normal(h.n_dofs)
    for ja, ta in ((A, tA), (Ap, tAp)):
        got = (ta @ torch.from_numpy(x)).numpy()
        assert _rel(got, ja @ jnp.asarray(x)) <= 1e-13
        assert np.array_equal(got, ta.matvec(torch.from_numpy(x)).numpy())
