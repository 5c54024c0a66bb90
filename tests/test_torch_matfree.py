"""The port's matrix-free SIPG operators and matrix-free fine level against
the JAX package's.

``polydeal_tpu_torch/assembly/matfree.py`` is the counterpart of
``polydeal_tpu/assembly/matfree.py`` (no Pallas kernel: plain einsums and
segment sums in both).  The cases of ``tests/test_matfree.py`` run through
both packages on the same handlers (the port's handler is a jax-free copy
that ``tests/test_torch_host.py`` holds equal), f64, on the CPU:

* the operator's geometry equals the JAX operator's exactly (carried over
  by ``interop.matfree_geometry_from_arrays``);
* the apply (2D p=1, p=2, 3D p=1), the diagonal, the mass action and the
  operator on polytopes that touch no boundary: the port against the JAX
  operator to 1e-11 (1e-12 for the mass), and against the port's own
  assembled matrix to 1e-11 (segment sums in another order);
* the matrix-free fine level under assembled coarse levels (2D n=16 p=2,
  ``build_multigrid(matfree_fine=True)``) with ``level_assembly='tables'``
  and ``'banded'``: JAX's iterations exactly, the solution to 1e-8, and
  within 2 iterations of the fully assembled MG-CG.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import agglomerate_by_partition  # noqa: E402
from polydeal_tpu.assembly import assemble_rhs  # noqa: E402
from polydeal_tpu.assembly import assemble_sipg_matrix  # noqa: E402
from polydeal_tpu.assembly import matfree as jmf  # noqa: E402
from polydeal_tpu.assembly import mass_matrix  # noqa: E402
from polydeal_tpu.solvers import build_multigrid  # noqa: E402
from polydeal_tpu.solvers import build_structured_hierarchy  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.assembly import matfree as tmf  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64


def handlers(dim=2, n=4, degree=1, distort=0.15, n_agglo=4):
    """(JAX handler, port handler) of test_matfree.py's make_handler."""
    m0 = pd.hyper_cube(dim, n)
    m = pd.distort_random(m0, distort, seed=5) if distort else m0
    t0 = tpd.hyper_cube(dim, n)
    t = tpd.distort_random(t0, distort, seed=5) if distort else t0
    c2p = agglomerate_by_partition(m0.cell_centers(), m0.neighbors, n_agglo)
    return (pd.AgglomerationHandler(m, c2p, degree=degree),
            tpd.AgglomerationHandler(t, c2p, degree=degree))


def test_geometry_equals_jax():
    ha, hb = handlers(dim=3, degree=1)
    gj = jmf.MatrixFreeLaplace(ha, dtype=jnp.float64).geom
    gt = tmf.MatrixFreeLaplace(hb, dtype=F64, device=CPU).geom
    conv = interop.matfree_geometry_from_arrays(
        {f.name: getattr(gj, f.name) for f in dataclasses.fields(gj)},
        device=CPU)
    for f in dataclasses.fields(gt):
        a, b = getattr(gt, f.name), getattr(conv, f.name)
        assert type(a) is type(b), f.name
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype == F64 and torch.equal(a, b), f.name
        else:
            assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1)])
def test_apply_matches_jax_and_assembled(dim, degree):
    ha, hb = handlers(dim=dim, degree=degree)
    jop = jmf.MatrixFreeLaplace(ha, dtype=jnp.float64)
    top = tmf.MatrixFreeLaplace(hb, dtype=F64, device=CPU)
    A = tsipg.assemble_sipg_matrix(hb, device=CPU)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.normal(size=ha.n_dofs)
        y = top.apply(torch.from_numpy(x))
        assert y.dtype == F64
        assert np.allclose(np.asarray(jop.apply(jnp.asarray(x))), y.numpy(),
                           atol=1e-11)
        assert np.allclose(A.matvec(torch.from_numpy(x)).numpy(), y.numpy(),
                           atol=1e-11)


def test_diagonal_matches_jax_and_assembled():
    ha, hb = handlers(dim=2, degree=2)
    d = tmf.MatrixFreeLaplace(hb, dtype=F64, device=CPU).diagonal()
    assert np.allclose(
        np.asarray(jmf.MatrixFreeLaplace(ha, dtype=jnp.float64).diagonal()),
        d.numpy(), atol=1e-11)
    assert np.allclose(np.asarray(assemble_sipg_matrix(ha).diagonal()),
                       d.numpy(), atol=1e-11)


def test_mass_matches_jax():
    ha, hb = handlers(dim=2, degree=1)
    x = np.random.default_rng(1).normal(size=ha.n_dofs)
    y = tmf.MatrixFreeMass(hb, dtype=F64, device=CPU).apply(
        torch.from_numpy(x))
    assert np.allclose(np.asarray(jmf.MatrixFreeMass(
        ha, dtype=jnp.float64).apply(jnp.asarray(x))), y.numpy(), atol=1e-12)
    assert np.allclose(np.asarray(mass_matrix(ha).matvec(jnp.asarray(x))),
                       y.numpy(), atol=1e-12)


def test_no_boundary_faces_subset():
    """Polytopes that touch no boundary (a 3x3 agglomeration)."""
    ha, hb = handlers(dim=2, n=6, n_agglo=9, distort=0.0)
    x = np.ones(ha.n_dofs)
    y = tmf.MatrixFreeLaplace(hb, dtype=F64, device=CPU).apply(
        torch.from_numpy(x))
    assert np.allclose(np.asarray(jmf.MatrixFreeLaplace(
        ha, dtype=jnp.float64).apply(jnp.asarray(x))), y.numpy(), atol=1e-11)
    assert np.allclose(np.asarray(assemble_sipg_matrix(ha).matvec(
        jnp.asarray(x))), y.numpy(), atol=1e-11)


N_MG = 16


@pytest.fixture(scope="module")
def mg_problem():
    """test_matfree.py's matrix-free fine level (2D n=16 p=2): the JAX
    package's matrix-free and assembled MG-CG solves, and the rhs both
    packages take."""
    mesh = pd.hyper_cube(2, N_MG)
    hs, parents, gs = build_structured_hierarchy(mesh, N_MG, degree=2)
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    b = assemble_rhs(hs[-1], lambda x: 2 * jnp.pi**2 * u_ex(x), u_ex)
    mg_f = build_multigrid(hs, parents, None, grid_shapes=gs,
                           matfree_fine=True)
    res_f = mg_f.solve_cg(b, rtol=1e-10)
    res_a = build_multigrid(hs, parents, assemble_sipg_matrix(hs[-1]),
                            grid_shapes=gs).solve_cg(b, rtol=1e-10)
    return dict(b=np.array(b), x=np.array(res_f.x),
                iterations=int(res_f.iterations),
                iterations_assembled=int(res_a.iterations))


@pytest.mark.parametrize("level_assembly", ["tables", "banded"])
def test_matfree_fine_level_mg_matches_jax(mg_problem, level_assembly):
    hs, parents, gs = tmg.build_structured_hierarchy(
        tpd.hyper_cube(2, N_MG), N_MG, degree=2)
    mg = tmg.build_multigrid(hs, parents, None, grid_shapes=gs,
                             matfree_fine=True, level_assembly=level_assembly,
                             device=CPU)
    assert isinstance(mg.ells[-1], tmg.MatrixFreeLevel)
    assert mg.ells[-1].dtype == F64 and not mg._is_t(mg.n_levels - 1)
    assert all(mg._is_t(lv) for lv in range(mg.n_levels - 1))
    res = mg.solve_cg(torch.from_numpy(mg_problem["b"]), rtol=1e-10)
    assert res.iterations == mg_problem["iterations"]
    assert abs(res.iterations - mg_problem["iterations_assembled"]) <= 2
    assert np.allclose(res.x.numpy(), mg_problem["x"], atol=1e-8)


def test_matfree_fine_needs_direct_mode():
    hs, parents, gs = tmg.build_structured_hierarchy(
        tpd.hyper_cube(2, 4), 4, degree=1)
    with pytest.raises(ValueError, match="direct"):
        tmg.build_multigrid(hs, parents, None, grid_shapes=gs,
                            matfree_fine=True, mode="galerkin", device=CPU)
