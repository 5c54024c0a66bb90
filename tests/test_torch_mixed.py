"""The port's multi-field machinery against the JAX package's, at f64 on
the CPU, on the Stokes-Darcy system at n = 8 (three fields, every face
class): ``SystemSpace`` pack/unpack; ``MixedOperator`` finalize (the same
blocks at the same rows and columns), matvec, block_apply, to_dense and
block_jacobi (1e-12 relative); a JAX operator carried over by
``interop.mixed_operator_from_arrays``; the block builders on random
tables; ``build_field_block_multigrid`` with re-discretised levels
(``level_ops``), Galerkin levels, and the deflated Neumann block (its
levels to 1e-12, one V-cycle to 1e-9).  The JAX system is built once per
file."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.assembly import mixed as jmixed  # noqa: E402
from polydeal_tpu.models import darcy_stokes as jds  # noqa: E402
from polydeal_tpu.solvers import multigrid as jmg  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.assembly import mixed as tmixed  # noqa: E402
from polydeal_tpu_torch.fem.system import Field  # noqa: E402
from polydeal_tpu_torch.models import darcy_stokes as tds  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

CPU = torch.device("cpu")
N, BLOCK = 8, 2


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def systems():
    sj, _ = jds.run(N, BLOCK)
    st, _ = tds.run(N, BLOCK, device=CPU)
    return sj, st


def _vec(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def test_system_space_pack_unpack(systems):
    sj, st = systems
    a, b = sj.space, st.space
    assert a.n_dofs == b.n_dofs
    v = _vec(a.n_dofs)
    for name in ("u", "pS", "pD"):
        assert a.offset(name) == b.offset(name)
        assert a.dof_slice(name) == b.dof_slice(name)
        assert np.array_equal(a.local_poly(name), b.local_poly(name))
        _close(a.unpack(jnp.asarray(v), name),
               b.unpack(torch.as_tensor(v), name), 0)
    parts = {n: torch.as_tensor(_vec(f.n_dofs, i))
             for i, (n, f) in enumerate(b.fields.items())}
    _close(a.pack({n: jnp.asarray(p.numpy()) for n, p in parts.items()}),
           b.pack(parts), 0)
    with pytest.raises(ValueError):
        Field("bad", b.fields["u"].basis, 1, np.array([3, 1]))


def test_mixed_operator_matches_jax(systems):
    sj, st = systems
    ma, mb = sj.op.finalize(), st.op.finalize()
    assert list(ma) == list(mb)
    for key in ma:
        ra, ca, da = ma[key]
        rb, cb, db = mb[key]
        assert np.array_equal(ra, rb) and np.array_equal(ca, cb), key
        _close(da, db, 1e-12)
    _close(sj.rhs, st.rhs, 1e-12)
    v = _vec(st.space.n_dofs, 2)
    _close(sj.op.matvec(jnp.asarray(v)), st.op.matvec(torch.as_tensor(v)),
           1e-12)
    for test, trial in (("pS", "u"), ("pD", "u"), ("pD", "pS"),
                        ("u", "pD")):
        f = st.space.fields[trial]
        xb = _vec(f.n_dofs, 3).reshape(f.n_polys, f.block)
        _close(sj.op.block_apply(test, trial, jnp.asarray(xb)),
               st.op.block_apply(test, trial, torch.as_tensor(xb)), 1e-12)
    _close(sj.op.to_dense(), st.op.to_dense(), 1e-12)
    _close(sj.op.block_jacobi()(jnp.asarray(v)),
           st.op.block_jacobi()(torch.as_tensor(v)), 1e-10)


def test_interop_operator(systems):
    """A JAX operator's merged blocks carried into the port multiply as
    the JAX operator does."""
    sj, st = systems
    merged = {k: (r, c, np.asarray(d))
              for k, (r, c, d) in sj.op.finalize().items()}
    op = interop.mixed_operator_from_arrays(st.space, merged, device=CPU)
    v = _vec(st.space.n_dofs, 4)
    _close(sj.op.matvec(jnp.asarray(v)), op.matvec(torch.as_tensor(v)),
           1e-13)


def test_block_builders_match_jax():
    """Every face-block builder on seeded random tables (two spaces of
    different sizes, with and without the upwind term)."""
    rng = np.random.default_rng(9)
    f, q, nbv, nbp, dim = 5, 4, 6, 3, 2

    def r(*s):
        return rng.standard_normal(s)

    Bv = [r(f, q, nbv), r(f, q, nbv)]
    Gv = [r(f, q, nbv, dim), r(f, q, nbv, dim)]
    Bp = [r(f, q, nbp), r(f, q, 1)]
    w, n, beta, g = rng.uniform(0.1, 1, (f, q)), r(f, q, dim), \
        r(f, q, dim), r(f, q, dim)
    sv, sp = rng.uniform(1, 2, f), rng.uniform(1, 2, f)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    for bt in (None, beta):
        a = jmixed.stokes_interior_blocks(
            [J(x) for x in Bv], [J(x) for x in Gv], [J(x) for x in Bp], J(w),
            J(n), J(sv), J(sp), 0.1, beta=None if bt is None else J(bt))
        b = tmixed.stokes_interior_blocks(
            [T(x) for x in Bv], [T(x) for x in Gv], [T(x) for x in Bp], T(w),
            T(n), T(sv), T(sp), 0.1, beta=None if bt is None else T(bt))
        assert list(a) == list(b)
        for k in a:
            _close(a[k], b[k], 1e-13)
        a = jmixed.stokes_boundary_blocks(J(Bv[0]), J(Gv[0]), J(Bp[0]), J(w),
                                          J(n), J(sv), 0.1,
                                          None if bt is None else J(bt))
        b = tmixed.stokes_boundary_blocks(T(Bv[0]), T(Gv[0]), T(Bp[0]), T(w),
                                          T(n), T(sv), 0.1,
                                          None if bt is None else T(bt))
        for k in a:
            _close(a[k], b[k], 1e-13)
        a = jmixed.stokes_boundary_rhs(J(Bv[0]), J(Gv[0]), J(Bp[0]), J(w),
                                       J(n), J(sv), 0.1, J(g),
                                       None if bt is None else J(bt))
        b = tmixed.stokes_boundary_rhs(T(Bv[0]), T(Gv[0]), T(Bp[0]), T(w),
                                       T(n), T(sv), 0.1, T(g),
                                       None if bt is None else T(bt))
        for x, y in zip(a, b):
            _close(x, y, 1e-13)
    a = jmixed.scalar_interior_blocks([J(x) for x in Bv], [J(x) for x in Gv],
                                      J(w), J(n), J(sv), kappa=2.0)
    b = tmixed.scalar_interior_blocks([T(x) for x in Bv], [T(x) for x in Gv],
                                      T(w), T(n), T(sv), kappa=2.0)
    for k in a:
        _close(a[k], b[k], 1e-13)
    a = jmixed.bjs_interface_blocks(J(Bv[0]), J(Bp[0]), J(w), J(n), 0.3)
    b = tmixed.bjs_interface_blocks(T(Bv[0]), T(Bp[0]), T(w), T(n), 0.3)
    for k in a:
        _close(a[k], b[k], 1e-13)


def _field_mgs(systems, name, level_ops):
    sj, st = systems
    deg = st.space.fields[name].basis.degree
    ha, pa = jds.block_hierarchy(pd.hyper_cube(2, N), N, BLOCK, deg)
    hb, pb = tds.block_hierarchy(tpd.hyper_cube(2, N), N, BLOCK, deg)
    lo_a = lo_b = None
    if level_ops:
        # the coarse systems on the hierarchy's own levels (the JAX
        # package's y = 1/2 split, which the coarse domain ids reproduce)
        doms = tds.coarse_domain_ids(st.meta["domain_id"], pb)
        lo_a = [(s.space, s.op) for s in (
            jds.build_darcy_stokes(h, d) for h, d in zip(ha[:-1], doms[:-1]))
        ] + [(sj.space, sj.op)]
        lo_b = []
        for h, d in zip(hb[:-1], doms[:-1]):
            s = tds.build_darcy_stokes(h, d, device=CPU)
            lo_b.append((s.space, s.op))
        lo_b.append((st.space, st.op))
    mga = jmg.build_field_block_multigrid(sj.space, sj.op, name, ha, pa,
                                          chebyshev_degree=5,
                                          level_ops=lo_a)
    mgb = tmg.build_field_block_multigrid(st.space, st.op, name, hb, pb,
                                          chebyshev_degree=5,
                                          level_ops=lo_b)
    return mga, mgb


@pytest.mark.parametrize("name,level_ops", [
    ("u", True), ("u", False), ("pD", True)],
    ids=["u-level-ops", "u-galerkin", "pD-deflated"])
def test_field_block_multigrid_matches_jax(systems, name, level_ops):
    mga, mgb = _field_mgs(systems, name, level_ops)
    assert mga.n_levels == mgb.n_levels
    for l in range(mga.n_levels):
        _close(mga.matrices[l].to_dense(), mgb.ells[l].to_dense(), 1e-12)
    if name == "pD":
        # the Neumann block's coarsest level is deflated: nonsingular
        w = np.linalg.eigvalsh(mgb.ells[0].to_dense().numpy())
        assert w[0] > 1e-8 * w[-1]
        n0 = mgb.ells[0].n_block_rows
        assert len(mgb.ells[0].offsets) == 2 * n0 - 1  # dense: every pair
    n = mgb.ells[-1].shape[0]
    v = _vec(n, 5)
    _close(mga.v_cycle(jnp.asarray(v)), mgb.v_cycle(torch.as_tensor(v)),
           1e-9)


def test_field_block_multigrid_checks_basis(systems):
    _, st = systems
    hb, pb = tds.block_hierarchy(tpd.hyper_cube(2, N), N, BLOCK, 1)
    with pytest.raises(ValueError):
        tmg.build_field_block_multigrid(st.space, st.op, "u", hb, pb)
