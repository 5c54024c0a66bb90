"""The slice end to end: the port's flagship R3MG solve against the JAX
package's, plus its embeddings and transfers.

At hyper_cube(3, 8), p=1, f64 on the CPU both packages build levels
[8, 64, 512] with grid shapes detected and 7 band offsets, and must take
the same number of CG iterations to solutions equal to 1e-9.  The JAX side
runs as its tests run it: ``use_pallas=False``, ``fused_smoother=False``,
``coarse_solver='inv'``.  (A JAX bf16 multigrid is not run on the CPU:
its emulated bf16 compiles pathologically slowly.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.solvers import (  # noqa: E402
    Transfer,
    build_embedding,
    build_multigrid,
    build_rtree_hierarchy,
    detect_grid_shapes,
)
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.models.flagship import (  # noqa: E402
    setup_flagship,
    solve_flagship,
)
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
N = 8


@pytest.fixture(scope="module")
def jax_flagship():
    """The flagship configuration on the JAX package at n=8, f64."""
    mesh = pd.hyper_cube(3, N)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    lv0 = max(1, agg.n_levels - 1 - 3)  # trim 3
    handlers, parents = build_rtree_hierarchy(
        mesh, agg, list(range(lv0, agg.n_levels - 1)), degree=1,
        relabel="lex")
    gs = detect_grid_shapes(handlers, parents)
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
    res = mg.solve_cg(b, rtol=1e-8, maxiter=100, fmg=True)
    return dict(handlers=handlers, grid_shapes=gs, offsets=offs,
                b=np.asarray(b), x=np.asarray(res.x),
                iterations=int(res.iterations),
                v_cycle=np.asarray(mg.v_cycle(b)))


def _port_flagship(**kw):
    fs = setup_flagship(n=N, device=CPU, dtype=torch.float64,
                        precond_dtype=None, **kw)
    return fs, solve_flagship(fs)


def _check_slice(ref, fs, res):
    assert fs.level_sizes == [h.n_poly for h in ref["handlers"]]
    assert fs.level_sizes == [8, 64, 512]
    assert fs.grid_shapes == ref["grid_shapes"] is not None
    assert np.array_equal(fs.band_offsets, ref["offsets"])
    assert len(fs.band_offsets) == 7
    assert np.abs(fs.b.numpy() - ref["b"]).max() <= 1e-12 * np.abs(
        ref["b"]).max()
    assert res.iterations == ref["iterations"] == 10
    assert np.abs(res.x.numpy() - ref["x"]).max() <= 1e-9
    assert float(res.residual) <= 1e-8 * float(fs.b.norm())
    vc = fs.mg.v_cycle(fs.b).numpy()  # one preconditioner application
    assert np.abs(vc - ref["v_cycle"]).max() <= 1e-12 * np.abs(vc).max()


def test_flagship_slice_matches_jax(jax_flagship):
    fs, res = _port_flagship()
    assert all(e.data_i is None for e in fs.mg.ells)  # all below threshold
    _check_slice(jax_flagship, fs, res)


def test_flagship_slice_imajor_path_matches_jax(jax_flagship, monkeypatch):
    """Threshold 0: every level carries the i-major copy (the fine level
    only that), so the whole V-cycle runs the plain versions of K1 and K2
    -- the same path that launches the kernels on a card."""
    monkeypatch.setattr(tmg, "IMAJOR_MIN_P", 0)
    fs, res = _port_flagship()
    assert all(e.data_i is not None for e in fs.mg.ells)
    assert fs.mg.ells[-1].data.shape[-1] == 0  # o-major copy dropped
    assert all(fs.mg._fused_ok(e, fs.b) for e in fs.mg.ells[1:])
    _check_slice(jax_flagship, fs, res)


def test_coarse_lu_matches_inv():
    _, r_inv = _port_flagship()
    _, r_lu = _port_flagship(coarse_solver="lu")
    assert r_lu.iterations == r_inv.iterations
    assert float((r_lu.x - r_inv.x).abs().max()) <= 1e-9


@pytest.mark.parametrize("precond", ["float32", "bfloat16"])
def test_low_precision_band_copies_converge(precond):
    """precond_dtype lowers only the smoother's band copies; CG stays f64
    and still reaches the tolerance, at a few extra iterations at most."""
    _, ref = _port_flagship()
    fs = setup_flagship(n=N, device=CPU, dtype=torch.float64,
                        precond_dtype=getattr(torch, precond))
    assert all(e.dtype == getattr(torch, precond) for e in fs.mg.lo_ells)
    res = solve_flagship(fs)
    assert float(res.residual) <= 1e-8 * float(fs.b.norm())
    assert res.iterations <= ref.iterations + 4


def _hierarchy(kind):
    """(jax handlers, parents, grid shapes, port handlers) for the three
    transfer paths: grid reshape, uniform contiguous children, gather."""
    if kind == "gather":
        m = pd.distort_random(pd.hyper_cube(2, 16), 0.15, seed=4)
        t = tpd.distort_random(tpd.hyper_cube(2, 16), 0.15, seed=4)
    else:
        m, t = pd.hyper_cube(3, N), tpd.hyper_cube(3, N)
    relabel = None if kind == "uniform" else "lex"
    agg = RTreeAgglomerator.build(m.cell_centers())
    levels = list(range(1, agg.n_levels - 1))
    ha, pa = build_rtree_hierarchy(m, agg, levels, degree=1, relabel=relabel)
    hb, _ = tmg.build_rtree_hierarchy(
        t, tpd.agglomeration.RTreeAgglomerator.build(t.cell_centers()),
        levels, degree=1, relabel=relabel)
    gs = detect_grid_shapes(ha, pa) if kind == "grid" else None
    if kind == "grid":
        assert gs is not None
    return ha, pa, gs, hb


@pytest.mark.parametrize("kind", ["grid", "uniform", "gather"])
def test_embedding_and_transfers_match_jax(kind):
    ha, pa, gs, hb = _hierarchy(kind)
    rng = np.random.default_rng(1)
    for l in range(len(pa)):
        E = np.asarray(build_embedding(ha[l], ha[l + 1], pa[l]))
        Et = tmg.build_embedding(hb[l], hb[l + 1], pa[l], device=CPU)
        assert np.abs(Et.numpy() - E).max() <= 1e-12 * np.abs(E).max()
        g = None if gs is None else gs[l]
        tj = Transfer(E=jnp.asarray(E), parent=pa[l],
                      n_coarse=ha[l].n_poly, grid_shape=g)
        nb = ha[l].n_basis
        uc = rng.standard_normal((nb, ha[l].n_poly))
        rf = rng.standard_normal((nb, ha[l + 1].n_poly))
        p_ref = np.asarray(tj.prolong_t(jnp.asarray(uc)))
        r_ref = np.asarray(tj.restrict_t(jnp.asarray(rf)))
        for tt in (tmg.Transfer(E=Et, parent=pa[l], n_coarse=hb[l].n_poly,
                                grid_shape=g),
                   interop.transfer_from_arrays(E, pa[l], ha[l].n_poly, g,
                                                device=CPU)):
            assert bool(tt._uniform_C) == (kind == "uniform")
            got_p = tt.prolong_t(torch.from_numpy(uc)).numpy()
            got_r = tt.restrict_t(torch.from_numpy(rf)).numpy()
            assert np.abs(got_p - p_ref).max() <= 1e-12 * np.abs(p_ref).max()
            assert np.abs(got_r - r_ref).max() <= 1e-12 * np.abs(r_ref).max()
