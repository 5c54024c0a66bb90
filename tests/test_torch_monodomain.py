"""The port's monodomain slice against the JAX package's, on the CPU.

The JAX side runs as ``tests/conftest.py`` sets it up (CPU, x64); the port
at f64 on the CPU, where its kernel wrappers run their plain versions.
Checked here:

* ``config`` (a copy): ``to_text`` of the defaults and a ``from_text``
  round trip;
* the ionic model at seeded u and w, 1e-14 relative to the largest value;
* ``assemble_mass_banded_direct`` (with and without ``coeff_fn``),
  ``BlockBanded.diag_blocks`` and ``add_to_diagonal_band`` and
  ``block_jacobi_preconditioner``, 1e-13;
* ``MonodomainSolver.build`` at dim=3, ``n_refinements=3`` (levels 8, 64,
  512) with the lex relabel: every level's band, B_t, w_t and stim_t to
  1e-12; then one BDF1 and four BDF2 steps on the multigrid path: the same
  CG iterations per step, u and w within 1e-10;
* a JAX state carried over by ``interop.monodomain_state_from_arrays``
  continues the JAX trajectory in the port;
* checkpoint and resume, bitwise, as ``test_accessor_checkpoint.py``
  checks the JAX package's.

The leaf-rank numbering (``relabel=None``) and the block-Jacobi path are in
``test_torch_monodomain_relabel.py``.
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
    assemble_mass_banded_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.solvers import (  # noqa: E402
    block_jacobi_preconditioner,
    build_rtree_hierarchy,
)
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu_torch import checkpoint as tck  # noqa: E402
from polydeal_tpu_torch import config as tcfg  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models import monodomain as tmono  # noqa: E402
from polydeal_tpu_torch.solvers import cg as tcg  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
DT = 5e-5


def _cfg(mod, dim=3, preconditioner="agglomg"):
    """The same small configuration for either package's config module:
    BDF2, stimulus for the first two steps."""
    cfg = mod.MonodomainConfig(
        dim=dim, n_refinements=3, degree=1, time_stepping_scheme="BDF2",
        dt=DT, final_time=5 * DT, end_time_current=2 * DT,
        applied_current=300.0, stimulus_radius=0.3)
    cfg.solver.rtol = 1e-8
    cfg.multigrid.preconditioner = preconditioner
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX solver (lex) and its trajectory: BDF1, then 4 BDF2 steps."""
    s = jmono.MonodomainSolver.build(_cfg(jcfg), relabel="lex")
    u, w = s.initial_state()
    u1, w1, it1 = jax.jit(lambda a, b, c: s.step(a, b, c, 0.0, True))(u, u,
                                                                       w)
    uf, up, wf, its = s.steps_scan(u1, u, w1, DT, 4)
    return dict(solver=s, state1=(u1, u, w1),
                iters=[int(it1)] + [int(i) for i in np.asarray(its)],
                u=np.asarray(uf), u_prev=np.asarray(up), w=np.asarray(wf))


@pytest.fixture(scope="module")
def port_solver():
    return tmono.MonodomainSolver.build(_cfg(tcfg), dtype=torch.float64,
                                        relabel="lex", device=CPU)


def test_config_matches_jax():
    assert tcfg.to_text(tcfg.MonodomainConfig()) == jcfg.to_text(
        jcfg.MonodomainConfig())
    cfg = tcfg.MonodomainConfig(dim=3, dt=2e-4)
    cfg.ionic.sigma = 5e-4
    cfg.multigrid.preconditioner = "jacobi"
    text = tcfg.to_text(cfg)
    assert tcfg.from_text(text) == cfg
    assert jcfg.to_text(jcfg.from_text(text)) == text


def test_ionic_functions_match_jax():
    rng = np.random.default_rng(11)
    u = rng.uniform(-0.1, 1.6, size=(6, 50))
    w = rng.uniform(0.0, 1.0, size=(3, 6, 50))  # gating axis first
    p = jcfg.BuenoOrovioParams()
    tp = tcfg.BuenoOrovioParams()
    U, W = torch.from_numpy(u), torch.from_numpy(w)
    Wl = torch.movedim(W, 0, -1)  # gating axis last
    pairs = [
        (jmono.ionic_rates(jnp.asarray(u), p), tmono.ionic_rates(U, tp)),
        (jmono.ionic_rates_t(jnp.asarray(u), p), tmono.ionic_rates_t(U, tp)),
        ((jmono.ionic_current(jnp.asarray(u), jnp.asarray(Wl.numpy()), p),),
         (tmono.ionic_current(U, Wl, tp),)),
        ((jmono.ionic_current_t(jnp.asarray(u), jnp.asarray(w), p),),
         (tmono.ionic_current_t(U, W, tp),)),
    ]
    for ref, got in pairs:
        for r, g in zip(ref, got):
            assert _rel(r, g.numpy()) <= 1e-14


def test_mass_diag_blocks_and_block_jacobi_match_jax():
    levels = lambda m, agg, build: build(
        m, agg, list(range(1, agg.n_levels - 1)), degree=1,
        relabel="lex")[0][-1]
    mesh, tmesh = pd.hyper_cube(3, 8), tpd.hyper_cube(3, 8)
    h = levels(mesh, RTreeAgglomerator.build(mesh.cell_centers()),
               build_rtree_hierarchy)
    th = levels(tmesh, tpd.agglomeration.RTreeAgglomerator.build(
        tmesh.cell_centers()), tmg.build_rtree_hierarchy)
    ft = h.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    g = build_banded_groups(h, offs, jnp.float64)
    tg = interop.groups_from_arrays(g, device=CPU)
    for coeff in (None, lambda x: 1.0 + x[..., 0] * x[..., 1]):
        ref = assemble_mass_banded_direct(h, g, coeff_fn=coeff)
        got = tsipg.assemble_mass_banded_direct(th, tg, coeff_fn=coeff)
        assert _rel(ref, got.numpy()) <= 1e-13
    Md = assemble_mass_banded_direct(h, g)
    K = assemble_sipg_banded_direct(h, g, offsets=offs, use_pallas=False)
    A = K.add_to_diagonal_band(2.5 * Md)
    tK = interop.banded_from_arrays(K.data, offs, h.n_poly, device=CPU)
    tA = tK.add_to_diagonal_band(2.5 * torch.from_numpy(np.array(Md)))
    assert tA.data_i is None
    assert torch.equal(tK.data, torch.from_numpy(np.array(K.data)))
    assert _rel(A.data, tA.data.numpy()) <= 1e-13
    ref_blocks = np.asarray(A.diag_blocks())
    for band in (tA, tA.with_imajor(drop_omajor=True)):
        assert _rel(ref_blocks, band.diag_blocks().numpy()) <= 1e-13
    r = np.random.default_rng(2).standard_normal(h.n_dofs)
    ref = block_jacobi_preconditioner(A.diag_blocks())(jnp.asarray(r))
    got = tcg.block_jacobi_preconditioner(tA.diag_blocks())(
        torch.from_numpy(r))
    assert _rel(ref, got.numpy()) <= 1e-13
    with pytest.raises(ValueError):  # the o-major band is needed
        tA.with_imajor(drop_omajor=True).add_to_diagonal_band(
            torch.from_numpy(np.array(Md)))


def test_build_matches_jax(jax_run, port_solver):
    js, ts = jax_run["solver"], port_solver
    assert len(js.mg.ells) == len(ts.mg.ells) == 3
    for a, b in zip(js.mg.ells, ts.mg.ells):
        assert np.array_equal(a.offsets, b.offsets)
        assert b.data_i is None  # all below IMAJOR_MIN_P: K0 on the card
        assert _rel(a.data, b.data.numpy()) <= 1e-12
    assert [e.n_block_rows for e in ts.mg.ells] == [8, 64, 512]
    assert len(ts.mg.ells[-1].offsets) == 7
    assert _rel(js.A.data, ts.A.data.numpy()) <= 1e-12
    for name in ("B_t", "w_t", "stim_t"):
        assert _rel(getattr(js, name), getattr(ts, name).numpy()) <= 1e-12
    assert float(ts.stim_t.sum()) > 0  # the stimulus covers some points


def test_mg_steps_match_jax(jax_run, port_solver):
    s = port_solver
    u, w = s.initial_state()
    u1, w1, it1 = s.step(u, u, w, 0.0, True)
    uf, up, wf, its = s.steps_scan(u1, u, w1, DT, 4)
    assert [it1] + its == jax_run["iters"]
    assert all(2 <= i <= 5 for i in jax_run["iters"])
    assert np.abs(uf.numpy() - jax_run["u"]).max() <= 1e-10
    assert np.abs(up.numpy() - jax_run["u_prev"]).max() <= 1e-10
    assert np.abs(wf.numpy() - jax_run["w"]).max() <= 1e-10
    uq = s.u_at_quad(uf)
    assert 0.01 < float(uq.max()) < 2.0


def test_interop_state_continues_jax_trajectory(jax_run, port_solver):
    """The JAX state after its BDF1 step, carried over, runs the same four
    BDF2 steps in the port."""
    u1, u0, w1 = (np.asarray(a) for a in jax_run["state1"])
    tu1, tu0, tw1 = interop.monodomain_state_from_arrays(u1, u0, w1,
                                                         device=CPU)
    assert tuple(tw1.shape) == (3, *port_solver.w_t.shape)
    uf, _, wf, its = port_solver.steps_scan(tu1, tu0, tw1, DT, 4)
    assert its == jax_run["iters"][1:]
    assert np.abs(uf.numpy() - jax_run["u"]).max() <= 1e-10
    assert np.abs(wf.numpy() - jax_run["w"]).max() <= 1e-10


def test_checkpoint_layout(tmp_path):
    state = dict(u=np.arange(5.0), w=torch.ones((2, 3), dtype=torch.float32))
    path = tck.save_checkpoint(str(tmp_path), 3, state)
    assert path.endswith("step_00000003")
    tck.save_checkpoint(str(tmp_path), 7, {**state, "u": 2 * state["u"]})
    assert tck.latest_step(str(tmp_path)) == 7
    assert tck.latest_step(str(tmp_path / "none")) is None
    step, restored = tck.restore_checkpoint(str(tmp_path))
    assert step == 7 and np.array_equal(restored["u"], 2 * state["u"])
    step3, restored3 = tck.restore_checkpoint(str(tmp_path), 3)
    assert restored3["w"].dtype == np.float32
    assert np.array_equal(restored3["w"], state["w"].numpy())
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "none"))


def test_checkpoint_resume_bitwise(tmp_path):
    """6 BDF2 steps uninterrupted against 4 steps with checkpoints and a
    resumed run to 6: bitwise equal, as the JAX package's test."""
    cfg = tcfg.MonodomainConfig(dim=2, n_refinements=3, degree=1, dt=DT,
                                final_time=3e-4, stimulus_radius=0.4,
                                time_stepping_scheme="BDF2")
    cfg.multigrid.preconditioner = "jacobi"

    def build():
        return tmono.MonodomainSolver.build(cfg, dtype=torch.float64,
                                            device=CPU)

    u_full, w_full, _ = build().run(n_steps=6)
    ckdir = str(tmp_path / "ck")
    build().run(n_steps=4, checkpoint_dir=ckdir, checkpoint_every=2)
    assert tck.latest_step(ckdir) == 4
    u_res, w_res, iters = build().run(n_steps=6, checkpoint_dir=ckdir,
                                      resume=True)
    assert len(iters) == 2  # steps 5 and 6 only
    assert torch.equal(u_full, u_res) and torch.equal(w_full, w_res)
