"""The port's 2D high-order monodomain against the JAX package's, on the CPU.

The 2D monodomain at p = 4 and 5 (nb = 15, 21) is the path that runs K5's
last shape: the JAX package's rule gives its Pallas K5 the boundary blocks
of every level there and leaves the volume and face blocks to XLA, and the
port's ``ops/sipg_kernels.kernel_blocks`` makes the same split.  The JAX
side runs as ``tests/conftest.py`` sets it up (CPU, x64), through its XLA
branch (no TPU); the port at f64 on the CPU, where its K5 wrapper runs the
plain version.  For each degree and numbering (``relabel="lex"``, the
benchmark's, and ``relabel=None``, the command line's), at the command
line's defaults (dt 1e-4, stimulus radius 0.1) and ``n_refinements`` 3-4:

* every level's band to 1e-12 relative, K5's wrapper called on every
  level and K3's and K4's on none;
* one BDF1 and three BDF2 steps on the multigrid path: the same CG
  iterations per step, u and w within 1e-10, max u at quadrature in
  (0.01, 2.0).

And the p = 4 fine band built by two lane slabs
(``build_banded_groups(lanes=)``, K5 on each slab's boundary table, the
einsums on its volume and face tables) equals the whole build's lanes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import polydeal_tpu.config as jcfg  # noqa: E402
import polydeal_tpu.models.monodomain as jmono  # noqa: E402
from polydeal_tpu_torch import config as tcfg  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models import monodomain as tmono  # noqa: E402
from polydeal_tpu_torch.models.profile_sipg import (  # noqa: E402
    mono_handlers,
)
from polydeal_tpu_torch.ops import sipg_kernels as tk  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
N_BDF2 = 3
# (degree, numbering, n_refinements): lex at p = 4 on 4 levels (4-256
# polytopes), the rest on 3 (4-64)
CASES = [(4, "lex", 4), (4, None, 3), (5, "lex", 3), (5, None, 3)]


def _cfg(mod, degree, n_ref):
    """The command line's configuration at ``degree`` and ``n_ref``."""
    return mod.MonodomainConfig(dim=2, n_refinements=n_ref, degree=degree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("degree,relabel,n_ref", CASES)
def test_mono2d_matches_jax(degree, relabel, n_ref, monkeypatch):
    assert tk.kernel_blocks("dgp", 2, degree, torch.float64) == {"boundary"}
    calls = {"boundary": 0}

    def boundary(*a, **kw):
        calls["boundary"] += 1
        return tk.boundary_blocks(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("K3/K4 called where the rule gives the einsums")

    monkeypatch.setattr(tsipg, "boundary_blocks", boundary)
    monkeypatch.setattr(tsipg, "volume_blocks", refuse)
    monkeypatch.setattr(tsipg, "face_group_blocks", refuse)
    ts = tmono.MonodomainSolver.build(_cfg(tcfg, degree, n_ref),
                                      dtype=torch.float64, relabel=relabel,
                                      device=CPU)
    js = jmono.MonodomainSolver.build(_cfg(jcfg, degree, n_ref),
                                      relabel=relabel)
    assert ts.handler.n_basis == (degree + 1) * (degree + 2) // 2
    assert calls["boundary"] == len(ts.mg.ells) == len(js.mg.ells)
    assert [e.n_block_rows for e in ts.mg.ells] == [
        4**k for k in range(1, n_ref + 1)]
    for a, b in zip(js.mg.ells, ts.mg.ells):
        assert np.array_equal(a.offsets, b.offsets)
        assert _rel(a.data, b.data.numpy()) <= 1e-12
    if relabel == "lex":  # 2 dim + 1 offsets on the fine level
        assert len(ts.mg.ells[-1].offsets) == 5

    u, w = js.initial_state()
    dt = js.cfg.dt
    u1, w1, it1 = jax.jit(lambda a, b, c: js.step(a, b, c, 0.0, True))(u, u,
                                                                       w)
    ju, _, jw, its = js.steps_scan(u1, u, w1, dt, N_BDF2)
    j_iters = [int(it1)] + [int(i) for i in np.asarray(its)]

    tu, tw = ts.initial_state()
    t1, tw1, tit1 = ts.step(tu, tu, tw, 0.0, True)
    tuf, _, twf, tits = ts.steps_scan(t1, tu, tw1, dt, N_BDF2)
    assert [tit1] + tits == j_iters
    assert all(2 <= i <= 5 for i in j_iters)
    assert np.abs(tuf.numpy() - np.asarray(ju)).max() <= 1e-10
    assert np.abs(twf.numpy() - np.asarray(jw)).max() <= 1e-10
    assert 0.01 < float(ts.u_at_quad(tuf).max()) < 2.0


def test_mono2d_fine_band_by_slab():
    h = mono_handlers(_cfg(tcfg, 4, 4))[-1]
    offs = tmg.band_offsets(h)
    whole = tsipg.assemble_sipg_banded_direct(
        h, tsipg.build_banded_groups(h, offs, torch.float64, device=CPU),
        offs)
    per = h.n_poly // 2
    for r in range(2):
        g = tsipg.build_banded_groups(h, offs, torch.float64, device=CPU,
                                      lanes=(r * per, (r + 1) * per))
        part = tsipg.assemble_sipg_banded_direct(h, g, offs)
        assert _rel(whole.data[..., r * per:(r + 1) * per],
                    part.data.numpy()) <= 1e-12
