"""The port's smoothed-aggregation AMG against the JAX package's, at f64 on
the CPU: the host setup (strength graph, aggregation labels, tentative
prolongator, Galerkin levels) EXACTLY equal; the device solve through
``interop.amg_from_arrays`` on the JAX hierarchy (the same CG iterations,
x to 1e-10); ``build_amg`` end to end (the same iterations); the
reference's R3MG-beats-AMG comparison on the port; the two model arms
(``solve_poisson(solver="amg")``, diffusion-reaction's partition arm) at
the JAX tests' sizes (the same iterations, L2/H1 to 1e-8 relative); input
validation.  The JAX side shares one problem per file."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly import sipg as jsipg  # noqa: E402
from polydeal_tpu.models import diffusion_reaction as jdr  # noqa: E402
from polydeal_tpu.models import poisson as jpoisson  # noqa: E402
from polydeal_tpu.solvers import amg as jamg  # noqa: E402
from polydeal_tpu.solvers import multigrid as jmg  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.agglomeration import (  # noqa: E402
    RTreeAgglomerator as TRTreeAgglomerator,
)
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models import diffusion_reaction as tdr  # noqa: E402
from polydeal_tpu_torch.models import poisson as tpoisson  # noqa: E402
from polydeal_tpu_torch.solvers import amg as tamg  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-8


def _rel(a, b):
    return abs(a - b) / abs(a)


@pytest.fixture(scope="module")
def problem():
    """The JAX tests' 2D p=1 SIPG system at n=16 on the R-tree hierarchy,
    in both packages."""
    n = 16
    m, t = pd.hyper_cube(2, n), tpd.hyper_cube(2, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    levels = list(range(1, agg.n_levels - 1))
    ha, pa = jmg.build_rtree_hierarchy(m, agg, levels, degree=1)
    hb, pb = tmg.build_rtree_hierarchy(
        t, TRTreeAgglomerator.build(t.cell_centers()), levels, degree=1)
    ju = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    tu = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    Aj = jsipg.assemble_sipg_matrix(ha[-1])
    bj = jsipg.assemble_rhs(ha[-1], lambda x: 2 * jnp.pi**2 * ju(x), ju)
    At = tsipg.assemble_sipg_matrix(hb[-1], device=CPU)
    bt = tsipg.assemble_rhs(hb[-1], lambda x: 2 * math.pi**2 * tu(x), tu,
                            device=CPU)
    amg_j = jamg.build_amg(Aj, nullspace=jamg.block_nullspace(ha[-1]),
                           coarse_max=100)
    return dict(ha=ha, pa=pa, hb=hb, pb=pb, Aj=Aj, bj=bj, At=At, bt=bt,
                amg_j=amg_j)


def test_host_setup_equals_jax(problem):
    """Strength graph, aggregation labels, tentative prolongator and the
    coarse candidates of the first coarsening, then every level's
    operator and prolongator: equal to the JAX package's."""
    Aj, At, ah = problem["Aj"], problem["At"], problem["hb"][-1]
    Mj, Mt = jamg._to_csr(Aj), tamg._to_csr(At)
    assert np.array_equal(Mj.indptr, Mt.indptr)
    assert np.array_equal(Mj.indices, Mt.indices)
    assert np.array_equal(Mj.data, Mt.data)
    nb = At.n_basis
    ip_j, ix_j = jamg._strength_graph(Mj, nb, 0.02)
    ip_t, ix_t = tamg._strength_graph(Mt, nb, 0.02)
    assert np.array_equal(ip_j, ip_t) and np.array_equal(ix_j, ix_t)
    n = Mt.shape[0] // nb
    lab_j = jamg._aggregate(ip_j, ix_j, n)
    lab_t = tamg._aggregate(ip_t, ix_t, n)
    assert np.array_equal(lab_j, lab_t)
    B = tamg.block_nullspace(ah)
    assert np.array_equal(B, jamg.block_nullspace(problem["ha"][-1]))
    n_agg = int(lab_t.max()) + 1
    Pj, Bcj = jamg._tentative(np.repeat(lab_j, nb), B, n_agg)
    Pt, Bct = tamg._tentative(np.repeat(lab_t, nb), B, n_agg)
    for a in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(Pj, a), getattr(Pt, a)), a
    assert np.array_equal(Bcj, Bct)

    # the built hierarchy, level by level
    amg_j = problem["amg_j"]
    amg_t = tamg.build_amg(At, nullspace=B, coarse_max=100)
    assert amg_t.n_levels == amg_j.n_levels >= 3
    assert amg_t.los == amg_j.los and amg_t.his == amg_j.his
    for l in range(amg_j.n_levels):
        a, b = amg_j.As[l], amg_t.As[l]
        assert np.array_equal(a.rows, b.rows) and np.array_equal(a.cols,
                                                                 b.cols)
        assert np.abs(np.asarray(a.data) - b.data.numpy()).max() <= \
            1e-13 * np.abs(np.asarray(a.data)).max()
        assert np.array_equal(np.asarray(amg_j.dinvs[l]),
                              amg_t.dinvs[l].numpy())
        if l:
            for pj, pt in ((amg_j.Ps[l], amg_t.Ps[l]),
                           (amg_j.Pts[l], amg_t.Pts[l])):
                assert np.array_equal(pj.rows, pt.rows)
                assert np.array_equal(pj.cols, pt.cols)
                assert np.array_equal(np.asarray(pj.data), pt.data.numpy())
    assert np.array_equal(np.asarray(amg_j.coarse_inv),
                          amg_t.coarse_inv.numpy())


def _coo(m):
    return None if m is None else (np.asarray(m.data), m.rows, m.cols,
                                   m.n_block_rows, m.n_block_cols)


def test_solve_through_interop_matches_jax(problem):
    """The JAX hierarchy carried over as arrays: the port's V-cycle and
    CG give JAX's iterations and x to 1e-10."""
    amg_j = problem["amg_j"]
    amg_t = interop.amg_from_arrays(
        [_coo(m) for m in amg_j.As], [_coo(m) for m in amg_j.Ps],
        [_coo(m) for m in amg_j.Pts],
        [np.asarray(d) for d in amg_j.dinvs], amg_j.los, amg_j.his,
        np.asarray(amg_j.coarse_inv), amg_j.chebyshev_degree,
        amg_j.n_smooth, device=CPU)
    ra = amg_j.solve_cg(problem["bj"], rtol=1e-9)
    rb = amg_t.solve_cg(problem["bt"], rtol=1e-9)
    assert rb.iterations == int(ra.iterations) > 1
    xa = np.asarray(ra.x)
    assert np.abs(rb.x.numpy() - xa).max() <= 1e-10 * np.abs(xa).max()
    # one V-cycle on a seeded vector
    v = np.random.default_rng(2).standard_normal(xa.shape[0])
    za = np.asarray(amg_j.v_cycle(jnp.asarray(v)))
    zb = amg_t.v_cycle(torch.as_tensor(v)).numpy()
    assert np.abs(za - zb).max() <= 1e-12 * np.abs(za).max()


def test_build_amg_solve_matches_jax(problem):
    """``build_amg`` end to end on the port's own assembly: JAX's
    iterations, x to 1e-10; constants-only candidates converge too."""
    amg_t = tamg.build_amg(problem["At"],
                           nullspace=tamg.block_nullspace(problem["hb"][-1]),
                           coarse_max=100)
    ra = problem["amg_j"].solve_cg(problem["bj"], rtol=1e-9)
    rb = amg_t.solve_cg(problem["bt"], rtol=1e-9)
    assert rb.iterations == int(ra.iterations)
    xa = np.asarray(ra.x)
    assert np.abs(rb.x.numpy() - xa).max() <= 1e-10 * np.abs(xa).max()
    ns = tamg.constant_nullspace(problem["hb"][-1])
    assert np.array_equal(ns, jamg.constant_nullspace(problem["ha"][-1]))
    assert np.all(ns.reshape(-1, problem["At"].n_basis)[:, 1:] == 0)
    rc = tamg.build_amg(problem["At"], nullspace=ns,
                        coarse_max=64).solve_cg(problem["bt"], rtol=1e-9)
    assert float(rc.residual) <= 1e-9 * float(problem["bt"].norm()) * 1.01


def test_r3mg_beats_amg(problem):
    """The reference's headline comparison (agglo_amg.cc:1473-1530) on the
    port: R3MG needs fewer CG iterations than SA-AMG on the same system,
    and both reach the same solution."""
    hb, pb, At, bt = problem["hb"], problem["pb"], problem["At"], \
        problem["bt"]
    r_mg = tmg.build_multigrid(hb, pb, At, device=CPU).solve_cg(bt,
                                                               rtol=1e-9)
    r_amg = tamg.build_amg(At, nullspace=tamg.block_nullspace(hb[-1]),
                           coarse_max=100).solve_cg(bt, rtol=1e-9)
    assert r_mg.iterations < r_amg.iterations
    assert float((r_mg.x - r_amg.x).abs().max()) <= 1e-7


@pytest.mark.parametrize("kw", [
    dict(dim=2, n=16),
    dict(dim=3, n=8),
], ids=["2d-n16", "3d-n8"])
def test_poisson_amg_arm_matches_jax(kw):
    a = jpoisson.solve_poisson(solver="amg", verbose=False, **kw)
    b = tpoisson.solve_poisson(solver="amg", verbose=False, device=CPU, **kw)
    assert a["iterations"] == b["iterations"]
    assert _rel(a["l2"], b["l2"]) <= TOL and _rel(a["h1"], b["h1"]) <= TOL
    assert b["amg"] is not None and b["mg"] is None


@pytest.mark.parametrize("n", [16, 32])
def test_diffusion_reaction_partition_arm_matches_jax(n):
    a = jdr.solve_diffusion_reaction(dim=2, n=n, strategy="metis",
                                     verbose=False)
    b = tdr.solve_diffusion_reaction(dim=2, n=n, strategy="metis",
                                     verbose=False, device=CPU)
    assert a["n_dofs"] == b["n_dofs"] and a["iterations"] == b["iterations"]
    assert _rel(a["l2"], b["l2"]) <= TOL


def test_amg_input_validation(problem):
    At, ah = problem["At"], problem["hb"][-1]
    with pytest.raises(ValueError):
        tamg.build_amg(At, nullspace=np.ones(7))
    with pytest.raises(ValueError):
        tamg.build_amg(At, nullspace=np.ones((ah.n_dofs, ah.n_basis + 1)))


def test_aggregate_fallback_matches_native(monkeypatch):
    """The numpy aggregation loop gives the native library's labels."""
    import scipy.sparse as sp

    from polydeal_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    n = 300
    ij = rng.integers(0, n, size=(2, 1500))
    g = sp.csr_matrix((np.ones(ij.shape[1]), (ij[0], ij[1])), shape=(n, n))
    g = (g + g.T).tocsr()
    g.setdiag(0)
    g.eliminate_zeros()
    lab = tamg._aggregate(g.indptr, g.indices, n)
    monkeypatch.setattr(native, "sa_aggregate", lambda *a: None)
    assert np.array_equal(lab, tamg._aggregate(g.indptr, g.indices, n))
