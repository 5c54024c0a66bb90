"""The port's general block-COO path against the JAX package's, at f64 on
the CPU: ``BlockMatrix`` (every method) and ``BlockELL`` on seeded blocks
to 1e-14; the table assembly (``assemble_sipg_matrix``, ``assemble_rhs``,
``mass_matrix``, ``project``) on a distorted 2D and a 3D R-tree handler to
1e-13, with the exactness invariants; ``galerkin_coarsen`` and the flat
transfers; ``TensorDGQ``, ``compute_global_error`` and the fine-grid
interpolation.  The JAX side runs as its own tests run it on the CPU (no
Pallas kernel is on this path).  The multigrid on these levels:
tests/test_torch_coo_multigrid.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu import postprocess as jpost  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly import sipg as jsipg  # noqa: E402
from polydeal_tpu.fem import basis as jbasis  # noqa: E402
from polydeal_tpu.solvers import multigrid as jmg  # noqa: E402
from polydeal_tpu.sparse import BlockMatrix as JBlockMatrix  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch import postprocess as tpost  # noqa: E402
from polydeal_tpu_torch.agglomeration import (  # noqa: E402
    RTreeAgglomerator as TRTreeAgglomerator,
)
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.fem import basis as tbasis  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402
from polydeal_tpu_torch.sparse import (  # noqa: E402
    BlockBanded,
    BlockELL,
    BlockMatrix,
)

CPU = torch.device("cpu")


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


# ---- BlockMatrix / BlockELL on seeded blocks -----------------------------

def _seeded(seed=0, P=12, nb=3, nnz=60, ncols=None):
    """Seeded blocks with duplicated (row, col) entries, and a diagonal."""
    rng = np.random.default_rng(seed)
    ncols = ncols or P
    rows = np.concatenate([np.arange(min(P, ncols)),
                           rng.integers(0, P, nnz)])
    cols = np.concatenate([np.arange(min(P, ncols)),
                           rng.integers(0, ncols, nnz)])
    data = rng.normal(size=(rows.shape[0], nb, nb))
    a = JBlockMatrix.from_blocks(rows, cols, jnp.asarray(data), P, ncols)
    b = BlockMatrix.from_blocks(rows, cols, torch.from_numpy(data), P, ncols)
    return a, b, rng


def test_block_matrix_from_blocks_and_products():
    a, b, rng = _seeded()
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols)
    assert (a.n_block_rows, a.n_block_cols) == (b.n_block_rows,
                                                b.n_block_cols)
    assert a.shape == b.shape and a.n_basis == b.n_basis
    _close(a.data, b.data, 1e-14)
    x = rng.normal(size=a.shape[1])
    _close(a.matvec(jnp.asarray(x)), b.matvec(torch.from_numpy(x)), 1e-14)
    xb = x.reshape(-1, 3)
    _close(a @ jnp.asarray(xb), b @ torch.from_numpy(xb), 1e-14)
    _close(a.diag_blocks(), b.diag_blocks(), 1e-14)
    _close(a.diagonal(), b.diagonal(), 1e-14)
    _close(a.to_dense(), b.to_dense(), 1e-14)
    for ta, tb in ((a.transpose(), b.transpose()), (a.T, b.T)):
        assert np.array_equal(ta.rows, tb.rows)
        assert np.array_equal(ta.cols, tb.cols)
        _close(ta.data, tb.data, 1e-14)
    _close(a.scale(-2.5).data, b.scale(-2.5).data, 1e-14)
    a2, b2, _ = _seeded(seed=1)
    sa, sb = a.add(a2), b.add(b2)
    assert np.array_equal(sa.rows, sb.rows)
    assert np.array_equal(sa.cols, sb.cols)
    _close(sa.data, sb.data, 1e-14)
    # rectangular
    ar, br, _ = _seeded(seed=2, P=7, ncols=11)
    _close(ar.to_dense(), br.to_dense(), 1e-14)
    xr = rng.normal(size=ar.shape[1])
    _close(ar.matvec(jnp.asarray(xr)), br.matvec(torch.from_numpy(xr)),
           1e-14)
    # carried across from the JAX arrays
    c = interop.block_matrix_from_arrays(
        np.asarray(a.data), a.rows, a.cols, a.n_block_rows, a.n_block_cols,
        device=CPU)
    _close(a.to_dense(), c.to_dense(), 0.0)


def test_block_matrix_layouts():
    a, b, rng = _seeded(seed=3, P=20, nnz=50)
    assert np.array_equal(a.banded_offsets(), b.banded_offsets())
    ja, jd = a.to_banded(), a.to_banded_device()
    ta, td = b.to_banded(), b.to_banded_device()
    for j, t in ((ja, ta), (jd, td)):
        assert isinstance(t, BlockBanded)
        assert np.array_equal(j.offsets, t.offsets)
        _close(j.data, t.data, 1e-14)
    x = rng.normal(size=a.shape[1])
    _close(a.matvec(jnp.asarray(x)), td.matvec(torch.from_numpy(x)), 1e-14)
    # the banded layout the kernels take, unchanged
    ti = td.with_imajor()
    _close(a.matvec(jnp.asarray(x)), ti.matvec(torch.from_numpy(x)), 1e-14)
    n_off = len(b.banded_offsets())
    assert b.to_banded(max_offsets=n_off - 1) is None
    assert b.to_banded_device(max_offsets=n_off - 1) is None
    ea, eb = a.to_ell(), b.to_ell()
    assert isinstance(eb, BlockELL)
    assert np.array_equal(ea.cols, eb.cols)
    assert ea.n_block_rows == eb.n_block_rows and ea.shape == eb.shape
    _close(ea.data, eb.data, 1e-14)
    _close(ea.matvec(jnp.asarray(x)), eb.matvec(torch.from_numpy(x)), 1e-14)
    _close(ea.diagonal(), eb.diagonal(), 1e-14)
    ec = interop.ell_from_arrays(np.asarray(ea.data), ea.cols,
                                 ea.n_block_cols, device=CPU)
    _close(eb.matvec(torch.from_numpy(x)), ec.matvec(torch.from_numpy(x)), 0.0)


def test_block_matrix_reductions_deterministic():
    """The merge and the SpMV's row sum are order-fixed segment sums: two
    runs agree bitwise."""
    _, b, rng = _seeded(seed=4, P=30, nnz=400)
    _, b2, _ = _seeded(seed=4, P=30, nnz=400)
    assert torch.equal(b.data, b2.data)
    x = torch.from_numpy(rng.normal(size=b.shape[1]))
    assert torch.equal(b.matvec(x), b2.matvec(x))


# ---- the table assembly --------------------------------------------------

def _handlers(kind, degree):
    if kind == "distorted2d":
        mk = lambda m: m.distort_random(m.hyper_cube(2, 8), 0.15, seed=4)
        level = 2
    else:
        mk = lambda m: m.hyper_cube(3, 4)
        level = 1
    m, t = mk(pd), mk(tpd)
    c2p = RTreeAgglomerator.build(m.cell_centers()).extract_agglomerates(
        level)
    return (pd.AgglomerationHandler(m, c2p, degree=degree),
            tpd.AgglomerationHandler(t, c2p, degree=degree))


def _fns(dim):
    def ju(x):
        return jnp.prod(jnp.sin(jnp.pi * x), axis=-1)

    def tu(x):
        return torch.prod(torch.sin(math.pi * x), dim=-1)

    return (ju, lambda x: dim * jnp.pi**2 * ju(x),
            tu, lambda x: dim * math.pi**2 * tu(x))


@pytest.mark.parametrize("kind,degree", [("distorted2d", 2), ("cube3d", 1),
                                         ("cube3d", 2)])
def test_table_assembly_matches_jax(kind, degree):
    ha, hb = _handlers(kind, degree)
    ju, jf, tu, tf = _fns(ha.dim)
    A = jsipg.assemble_sipg_matrix(ha)
    B = tsipg.assemble_sipg_matrix(hb, device=CPU)
    assert np.array_equal(A.rows, B.rows) and np.array_equal(A.cols, B.cols)
    _close(A.data, B.data, 1e-13)
    _close(jsipg.assemble_rhs(ha, jf, ju), tsipg.assemble_rhs(
        hb, tf, tu, device=CPU), 1e-13)
    _close(jsipg.mass_matrix(ha).data, tsipg.mass_matrix(hb, device=CPU).data,
           1e-13)
    coeff_j = lambda x: 1.0 + x[..., 0]
    coeff_t = lambda x: 1.0 + x[..., 0]
    _close(jsipg.mass_matrix(ha, coeff_j).data,
           tsipg.mass_matrix(hb, coeff_t, device=CPU).data, 1e-13)
    _close(jsipg.project(ha, ju), tsipg.project(hb, tu, device=CPU), 1e-13)
    # Neumann faces and the orthogonal penalty length
    fb = ha.faces.boundary()
    ids = [0] if fb.boundary_id is not None else None
    gn_j = lambda x, n: x[..., 0] + n[..., 0]
    gn_t = lambda x, n: x[..., 0] + n[..., 0]
    _close(jsipg.assemble_rhs(ha, jf, ju, dirichlet_ids=ids,
                              neumann_fn=gn_j),
           tsipg.assemble_rhs(hb, tf, tu, dirichlet_ids=ids,
                              neumann_fn=gn_t, device=CPU), 1e-13)
    fa = jsipg.build_face_tables(ha, h_scale="orthogonal")
    fbt = tsipg.build_face_tables(hb, h_scale="orthogonal", device=CPU)
    _close(fa[0].h_f, fbt[0].h_f, 1e-14)
    _close(jsipg.assemble_sipg_matrix(ha, faces=fa).data,
           tsipg.assemble_sipg_matrix(hb, faces=fbt, device=CPU).data, 1e-13)


@pytest.mark.parametrize("kind", ["distorted2d", "cube3d"])
def test_table_assembly_exactness(kind):
    """project reproduces linears (p=1) and quadratics (p=2) to 1e-13, and
    SIPG without its boundary terms annihilates linears: the jump and
    average terms vanish, so v^T A v = int |grad v|^2 over the unit cube
    (x -> 1, x + y -> 2, 1 -> 0; the reference's
    poisson_sanity_check_01.output), to 1e-13."""
    for degree, fn in ((1, lambda x: 1.0 + 2 * x[..., 0] - x[..., 1]),
                       (2, lambda x: 0.5 + x[..., 0] * x[..., 1]
                        - 3 * x[..., 1] ** 2)):
        _, h = _handlers(kind, degree)
        u = tsipg.project(h, fn, device=CPU)
        l2, _ = tpost.compute_global_error(h, u, fn)
        assert float(l2) < 1e-13
    _, h = _handlers(kind, 1)
    A = tsipg.assemble_sipg_matrix(h, include_boundary=False, device=CPU)
    for fn, expected in ((lambda x: x[..., 0], 1.0),
                         (lambda x: x[..., 0] + x[..., 1], 2.0),
                         (lambda x: torch.ones_like(x[..., 0]), 0.0)):
        v = tsipg.project(h, fn, device=CPU)
        assert abs(float(v @ A.matvec(v)) - expected) < 1e-13


# ---- multigrid: Galerkin, flat transfers, ELL levels, schedules ----------

def _hierarchy(dim=2, n=16, degree=1, start=1):
    m, t = pd.hyper_cube(dim, n), tpd.hyper_cube(dim, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    levels = list(range(start, agg.n_levels - 1))
    ha, pa = jmg.build_rtree_hierarchy(m, agg, levels, degree=degree)
    hb, pb = tmg.build_rtree_hierarchy(
        t, TRTreeAgglomerator.build(t.cell_centers()), levels, degree=degree)
    return ha, pa, hb, pb


def _system(ha, hb):
    ju, jf, tu, tf = _fns(ha.dim)
    return (jsipg.assemble_sipg_matrix(ha), jsipg.assemble_rhs(ha, jf, ju),
            tsipg.assemble_sipg_matrix(hb, device=CPU),
            tsipg.assemble_rhs(hb, tf, tu, device=CPU))


def test_galerkin_coarsen_matches_jax():
    ha, pa, hb, pb = _hierarchy(n=8)
    A, _, B, _ = _system(ha[-1], hb[-1])
    Ej = jmg.build_embedding(ha[-2], ha[-1], pa[-1])
    Et = tmg.build_embedding(hb[-2], hb[-1], pb[-1], device=CPU)
    _close(Ej, Et, 1e-14)
    Ac = jmg.galerkin_coarsen(A, Ej, pa[-1], ha[-2].n_poly)
    Bc = tmg.galerkin_coarsen(B, Et, pb[-1], hb[-2].n_poly)
    assert np.array_equal(Ac.rows, Bc.rows)
    assert np.array_equal(Ac.cols, Bc.cols)
    _close(Ac.data, Bc.data, 1e-13)


@pytest.mark.parametrize("permute", [False, True])
def test_flat_transfers(permute):
    """The flat prolong/restrict against the JAX package's, on the R-tree
    parent map (uniform contiguous children: the reshape path) and on that
    map with the fine ids renumbered (the gather path); restrict the
    transpose of prolong, and the transposed forms equal to the flat
    ones."""
    ha, pa, hb, pb = _hierarchy(n=8, degree=2)
    rng = np.random.default_rng(7)
    perm = rng.permutation(ha[-1].n_poly)
    parent = np.asarray(pa[-1])
    if permute:
        parent = parent[np.argsort(perm)]  # fine ids renumbered
    E = rng.normal(size=(parent.shape[0], 6, 6))
    tj = jmg.Transfer(E=jnp.asarray(E), parent=parent,
                      n_coarse=ha[-2].n_poly)
    tt = tmg.Transfer(E=torch.from_numpy(E), parent=parent,
                      n_coarse=hb[-2].n_poly)
    assert (tt._uniform_C == 0) == permute
    u = rng.normal(size=ha[-2].n_dofs)
    v = rng.normal(size=parent.shape[0] * 6)
    pu = tt.prolong(torch.from_numpy(u))
    rv = tt.restrict(torch.from_numpy(v))
    _close(tj.prolong(jnp.asarray(u)), pu, 1e-14)
    _close(tj.restrict(jnp.asarray(v)), rv, 1e-14)
    assert abs(float(torch.dot(torch.from_numpy(v), pu))
               - float(torch.dot(rv, torch.from_numpy(u)))) < 1e-12
    ut = torch.from_numpy(u).reshape(-1, 6).T
    vt = torch.from_numpy(v).reshape(-1, 6).T
    _close(pu.reshape(-1, 6).T, tt.prolong_t(ut), 1e-14)
    _close(rv.reshape(-1, 6).T, tt.restrict_t(vt), 1e-14)


# ---- basis and post-processing -------------------------------------------

@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 3), (3, 2)])
def test_tensor_dgq(dim, degree):
    rng = np.random.default_rng(dim + degree)
    ref = jbasis.make_basis("dgq", dim, degree)
    port = tbasis.make_basis("dgq", dim, degree)
    assert isinstance(port, tbasis.TensorDGQ)
    assert port.n_basis == ref.n_basis
    assert np.array_equal(port.exponents, ref.exponents)
    pts = rng.random((5, 7, dim))
    pts_t = rng.random((3, dim, 9))
    _close(ref.eval(jnp.asarray(pts)), port.eval(torch.from_numpy(pts)),
           1e-13)
    _close(ref.grad(jnp.asarray(pts)), port.grad(torch.from_numpy(pts)),
           1e-13)
    _close(ref.eval_t(jnp.asarray(pts_t)),
           port.eval_t(torch.from_numpy(pts_t)), 1e-13)
    _close(ref.grad_t(jnp.asarray(pts_t)),
           port.grad_t(torch.from_numpy(pts_t)), 1e-13)
    assert np.array_equal(jbasis._gauss_lobatto_01(degree + 1),
                          tbasis._gauss_lobatto_01(degree + 1))


def test_global_error_and_interpolation():
    ha, hb = _handlers("distorted2d", 2)
    ju, _, tu, _ = _fns(2)

    def jg(x):
        return jnp.stack([jnp.pi * jnp.cos(jnp.pi * x[..., 0])
                          * jnp.sin(jnp.pi * x[..., 1]),
                          jnp.pi * jnp.sin(jnp.pi * x[..., 0])
                          * jnp.cos(jnp.pi * x[..., 1])], axis=-1)

    def tg(x):
        return torch.stack([math.pi * torch.cos(math.pi * x[..., 0])
                            * torch.sin(math.pi * x[..., 1]),
                            math.pi * torch.sin(math.pi * x[..., 0])
                            * torch.cos(math.pi * x[..., 1])], dim=-1)

    u = np.random.default_rng(5).normal(size=ha.n_dofs)
    ej = jpost.compute_global_error(ha, jnp.asarray(u), ju, jg)
    et = tpost.compute_global_error(hb, torch.from_numpy(u), tu, tg)
    for a, b in zip(ej, et):
        _close(a, b, 1e-13)
    for fam in ("dgq", "dgp"):
        _close(jpost.interpolate_to_fine_grid(ha, jnp.asarray(u),
                                              family=fam),
               tpost.interpolate_to_fine_grid(hb, torch.from_numpy(u),
                                              family=fam), 1e-13)
    u3 = np.random.default_rng(6).normal(size=3 * ha.n_dofs)
    _close(jpost.interpolate_to_fine_grid(ha, jnp.asarray(u3), degree=1,
                                          n_components=3),
           tpost.interpolate_to_fine_grid(hb, torch.from_numpy(u3), degree=1,
                                          n_components=3), 1e-13)


def test_interpolate_field_to_fine_grid():
    """One field of a two-field layout on its subdomain (half the
    polytopes), zero elsewhere, against the JAX package's function given
    the same field description."""
    ha, hb = _handlers("distorted2d", 1)
    polys = np.arange(0, ha.n_poly, 2)
    ub = np.random.default_rng(8).normal(size=(polys.size, 2, ha.n_basis))

    class Field:
        def __init__(self, basis):
            self.polys, self.n_components, self.basis = polys, 2, basis

    class Space:
        def __init__(self, basis, arr):
            self.fields = {"v": Field(basis)}
            self._arr = arr

        def unpack(self, x, name):
            return self._arr

    oj = jpost.interpolate_field_to_fine_grid(
        Space(ha.basis, jnp.asarray(ub)), ha, None, "v")
    ot = tpost.interpolate_field_to_fine_grid(
        Space(hb.basis, torch.from_numpy(ub)), hb, None, "v")
    _close(oj, ot, 1e-13)
