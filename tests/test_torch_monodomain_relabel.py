"""The port's monodomain without the lex relabel, and on its block-Jacobi
path, against the JAX package's, on the CPU (the JAX side as
``tests/conftest.py`` sets it up: CPU, x64).

* ``relabel=None`` (the R-tree's leaf-rank numbering, 7/13/19 band offsets
  on the 8/64/512-polytope levels of dim=3, ``n_refinements=3``): every
  level's band, B_t, w_t and stim_t to 1e-12; one BDF1 and four BDF2 steps
  on the multigrid path with the same CG iterations per step, u and w
  within 1e-10;
* the block-Jacobi path (CG on the fine o-major band, the K0 product) at
  dim=2, ``n_refinements=3``, as the JAX package's relabel-invariance test:
  the lex and leaf-rank numberings give the same ordering-invariant
  integrals, and the leaf-rank run equals the JAX package's;
* the command line runs on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import polydeal_tpu.config as jcfg  # noqa: E402
import polydeal_tpu.models.monodomain as jmono  # noqa: E402
from polydeal_tpu_torch import config as tcfg  # noqa: E402
from polydeal_tpu_torch.models import monodomain as tmono  # noqa: E402

CPU = torch.device("cpu")
DT = 5e-5


def _cfg(mod, dim=3, preconditioner="agglomg"):
    """The same small configuration for either package's config module:
    BDF2, stimulus for the first two steps."""
    cfg = mod.MonodomainConfig(
        dim=dim, n_refinements=3, degree=1, time_stepping_scheme="BDF2",
        dt=DT, final_time=5 * DT, end_time_current=2 * DT,
        applied_current=300.0, stimulus_radius=0.3)
    cfg.solver.rtol = 1e-8 if preconditioner == "agglomg" else 1e-10
    cfg.multigrid.preconditioner = preconditioner
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _jax_steps(s):
    u, w = s.initial_state()
    u1, w1, it1 = jax.jit(lambda a, b, c: s.step(a, b, c, 0.0, True))(u, u,
                                                                       w)
    uf, _, wf, its = s.steps_scan(u1, u, w1, DT, 4)
    return ([int(it1)] + [int(i) for i in np.asarray(its)], np.asarray(uf),
            np.asarray(wf))


def _port_steps(s):
    u, w = s.initial_state()
    u1, w1, it1 = s.step(u, u, w, 0.0, True)
    uf, _, wf, its = s.steps_scan(u1, u, w1, DT, 4)
    return [it1] + its, uf, wf


def test_leaf_rank_build_and_steps_match_jax():
    js = jmono.MonodomainSolver.build(_cfg(jcfg), relabel=None)
    ts = tmono.MonodomainSolver.build(_cfg(tcfg), dtype=torch.float64,
                                      relabel=None, device=CPU)
    assert [len(e.offsets) for e in ts.mg.ells] == [7, 13, 19]
    for a, b in zip(js.mg.ells, ts.mg.ells):
        assert np.array_equal(a.offsets, b.offsets)
        assert _rel(a.data, b.data.numpy()) <= 1e-12
    for name in ("B_t", "w_t", "stim_t"):
        assert _rel(getattr(js, name), getattr(ts, name).numpy()) <= 1e-12
    j_iters, ju, jw = _jax_steps(js)
    t_iters, tu, tw = _port_steps(ts)
    assert t_iters == j_iters
    assert np.abs(tu.numpy() - ju).max() <= 1e-10
    assert np.abs(tw.numpy() - jw).max() <= 1e-10


def test_jacobi_relabel_invariance_and_jax_parity():
    def integrals(s, u):
        uq = s.u_at_quad(u)
        return float((s.w_t * uq).sum()), float((s.w_t * uq**2).sum())

    runs = {}
    for relabel in ("lex", None):
        s = tmono.MonodomainSolver.build(
            _cfg(tcfg, dim=2, preconditioner="jacobi"), dtype=torch.float64,
            relabel=relabel, device=CPU)
        assert s.mg is None and s.A.data_i is None  # CG through K0
        iters, u, w = _port_steps(s)
        runs[relabel] = (len(s.A.offsets), integrals(s, u), iters, u, w)
    assert runs["lex"][0] == 2 * 2 + 1 < runs[None][0]
    for m_lex, m_leaf in zip(runs["lex"][1], runs[None][1]):
        assert abs(m_lex - m_leaf) < 1e-8 * max(1.0, abs(m_leaf))
    js = jmono.MonodomainSolver.build(
        _cfg(jcfg, dim=2, preconditioner="jacobi"), relabel=None)
    j_iters, ju, jw = _jax_steps(js)
    _, _, t_iters, tu, tw = runs[None]
    assert t_iters == j_iters
    assert np.abs(tu.numpy() - ju).max() <= 1e-10
    assert np.abs(tw.numpy() - jw).max() <= 1e-10


def test_main_runs_on_cpu(capsys):
    tmono.main(["--device", "cpu", "--dtype", "float64", "--dim", "2",
                "--refinements", "3", "--dt", "5e-5", "--final-time",
                "5e-4"])
    out = capsys.readouterr().out
    assert "step    10" in out and "max u" in out
