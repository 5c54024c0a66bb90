"""The packed wide-offset path of the port against the JAX package's.

Without the lex relabel the R-tree's leaf-rank numbering gives many band
offsets while each lane touches at most 2 dim + 1; the packed format
(``ops/packed.py``, ``sparse.BlockPacked``) then serves the SpMV (K6) and
the fused Chebyshev steps (K7).  Checked here on the CPU:

* the port's jax-free ``build_pack_plan`` equals the JAX package's exactly;
* K6's and K7's plain versions against the JAX Pallas kernels in interpret
  mode on the same pack (carried over by ``interop.packed_from_arrays``):
  f32 to 1e-5 relative to the largest output entry (sums in another
  order), f64 to 1e-12;
* ``BlockBanded.to_packed`` equals the JAX ``to_packed`` exactly (it is a
  selection), with its far tail, ``to_banded`` and ``diagonal_t``;
* the direct packed assembly against the JAX one, f64, 1e-12;
* the slice: the ``relabel=None`` flagship at n=8, f64, packed levels,
  against the JAX package's with the same iterations and solutions equal
  to 1e-9.  The JAX package packs only levels with P % 128 == 0 even with
  ``pack=True``, so the two may pack different levels: results are
  compared, and the port's own layout is asserted;
* the port's one packing rule (``multigrid.level_pack_plan``), the same on
  every device; the tests lower ``multigrid.PACK_MIN_P`` to pack small
  levels.

The CUDA kernels against their plain versions need a card and skip here.
"""

from types import SimpleNamespace

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
from polydeal_tpu.ops.fused_cheb import (  # noqa: E402
    packed_cheb_step_t,
    packed_residual_t,
)
from polydeal_tpu.ops.packed import (  # noqa: E402
    build_pack_plan,
    packed_matvec_t,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_multigrid,
    build_rtree_hierarchy,
)
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models.flagship import (  # noqa: E402
    setup_flagship,
    solve_flagship,
)
from polydeal_tpu_torch.ops import fused_cheb as tfc  # noqa: E402
from polydeal_tpu_torch.ops import packed as tpk  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402
from polydeal_tpu_torch.sparse import BlockBanded, BlockPacked  # noqa: E402

CPU = torch.device("cpu")
# (dim, n): R-tree leaf levels (one cell per polytope, leaf-rank order),
# P a multiple of 128 as the JAX kernel needs
LEAVES = [(2, 16), (3, 8)]


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def _leaf(dim, n):
    """(jax handler, port handler, offsets, jax f64 band, port f64 tables)
    of the leaf level in leaf-rank order."""
    m, t = pd.hyper_cube(dim, n), tpd.hyper_cube(dim, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    c2p = agg.extract_agglomerates(agg.n_levels - 1)
    ha = pd.AgglomerationHandler(m, c2p, degree=1)
    hb = tpd.AgglomerationHandler(t, c2p, degree=1)
    ft = ha.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    A = assemble_sipg_banded_direct(
        ha, build_banded_groups(ha, offs, jnp.float64), offsets=offs,
        use_pallas=False)
    gb = tsipg.build_banded_groups(hb, offs, torch.float64, device=CPU)
    return ha, hb, offs, A, gb


def _plan(h, offs, near_limit):
    ft = h.faces
    interior = ~ft.is_boundary
    return ft.poly_in[interior], ft.poly_out[interior], dict(
        P=h.n_poly, nb=h.n_basis, offsets=offs, near_limit=near_limit)


@pytest.fixture(scope="module", params=LEAVES, ids=lambda c: f"{c[0]}d")
def leaf(request):
    """The leaf band, its full-colouring JAX pack and the same pack in the
    port; wide: K well below the offset count."""
    ha, hb, offs, A, gb = _leaf(*request.param)
    src, dst, kw = _plan(ha, offs, -1)
    plan, oid, frows, fcols = build_pack_plan(src, dst, **kw)
    assert plan.K <= 2 * ha.dim + 1 < len(plan.offsets)
    Ap = A.to_packed(plan, jnp.asarray(oid), frows, fcols)
    tp = interop.packed_from_arrays(Ap.data_i, Ap.oid, plan.offsets,
                                    plan.slots, plan.nb, device=CPU)
    return dict(ha=ha, hb=hb, offs=offs, A=A, gb=gb, plan=plan, oid=oid,
                Ap=Ap, tp=tp)


@pytest.mark.parametrize("near_limit", [-1, 16, None])
@pytest.mark.parametrize("dim,n", [(2, 16), (3, 4)])
def test_pack_plan_equals_jax(dim, n, near_limit):
    m = pd.hyper_cube(dim, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    h = pd.AgglomerationHandler(m, agg.extract_agglomerates(
        agg.n_levels - 1), degree=1)
    ft = h.faces
    interior = ~ft.is_boundary
    offs = np.unique(np.concatenate([
        ft.poly_out[interior] - ft.poly_in[interior],
        ft.poly_in[interior] - ft.poly_out[interior], [0]])).astype(np.int64)
    src, dst, kw = _plan(h, offs, near_limit)
    pa, oa, ra, ca = build_pack_plan(src, dst, **kw)
    pb, ob, rb, cb = tpk.build_pack_plan(src, dst, **kw)
    assert pa.offsets == pb.offsets and pa.slots == pb.slots
    assert (pa.P, pa.nb, pa.K, pa.R_pad) == (pb.P, pb.nb, pb.K, pb.R_pad)
    for a, b in ((oa, ob), (ra, rb), (ca, cb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if near_limit == 16:
        assert rb.size > 0  # the far tail is exercised


def _vecs(nb, P, seed):
    rng = np.random.default_rng(seed)
    x, b, d = (rng.standard_normal((nb, P)) for _ in range(3))
    return x, b, d, 1.0 + rng.random((nb, P))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_k6_plain_matches_jax_kernel(leaf, dtype, tol):
    plan, Ap, tp = leaf["plan"], leaf["Ap"], leaf["tp"]
    x = _vecs(plan.nb, plan.P, 1)[0]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = packed_matvec_t(Ap.data_i.astype(jdt), Ap.oid, plan,
                          jnp.asarray(x, dtype=jdt), interpret=True)
    di, xt = tp.data_i.to(tdt), torch.from_numpy(x).to(tdt)
    got = tpk.packed_matvec_t_ref(di, tp.oid, tp.offsets_t, plan.nb, xt)
    assert got.dtype == tdt
    _close(ref, got.numpy(), tol)
    _close(ref, tp.astype(tdt).matvec_t(xt).numpy(), tol)  # the wrapper


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_k7_plain_matches_jax_kernel(leaf, dtype, tol):
    """step0, step and residual against the JAX fused kernel in interpret
    mode."""
    plan, Ap, tp = leaf["plan"], leaf["Ap"], leaf["tp"]
    x, b, d, dinv = _vecs(plan.nb, plan.P, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, dtype=jdt)
    T = lambda a: torch.from_numpy(a).to(tdt)
    dj, dt = Ap.data_i.astype(jdt), tp.data_i.to(tdt)
    args = (tp.oid, tp.offsets_t, plan.nb)
    c1, c2 = 0.37, 1.21
    for dv in (d, None):
        rx, rd = packed_cheb_step_t(dj, Ap.oid, plan, J(x),
                                    None if dv is None else J(dv), J(b),
                                    J(dinv), c1, c2, interpret=True)
        gx, gd = tfc.packed_cheb_step_t_ref(
            dt, *args, T(x), None if dv is None else T(dv), T(b), T(dinv),
            c1, c2)
        _close(rx, gx.numpy(), tol)
        _close(rd, gd.numpy(), tol)
    rr = packed_residual_t(dj, Ap.oid, plan, J(x), J(b), interpret=True)
    _close(rr, tfc.packed_residual_t_ref(dt, *args, T(x), T(b)).numpy(),
           tol)


def test_masked_slot_adds_exact_zero():
    """An inactive slot, and a column outside [0, P), add nothing, even
    where the stored block is not zero (the gather clamps such columns to
    real lanes, so an unmasked product would show)."""
    nb, P = 2, 8
    offsets = torch.tensor([-1, 0, 3], dtype=torch.int32)
    oid = torch.tensor([[1] * P, [-1, 0, 0, 2, 2, 2, 2, 2]],
                       dtype=torch.int32)  # lane 0: no block in slot 1
    data_i = torch.ones(nb * 16, P, dtype=torch.float64)
    x = torch.arange(nb * P, dtype=torch.float64).reshape(nb, P)
    y = tpk.packed_matvec_t_ref(data_i, oid, offsets, nb, x)
    # lane p: diagonal block (all ones) times x[:, p], plus slot 1's
    # offset; lanes 5-7 with +3 leave [0, P) and add nothing
    diag = x.sum(0)
    want = diag.clone()
    want[1:3] += x[:, 0:2].sum(0)
    want[3:5] += x[:, 6:8].sum(0)
    assert torch.equal(y, want.expand(nb, P))


@pytest.mark.parametrize("near_limit", [-1, 8])
def test_to_packed_equals_jax(leaf, near_limit):
    """A selection, so exact; with near_limit=8 part of the band goes to the
    far block-COO tail, whose product must still match the dense band."""
    ha, A, offs = leaf["ha"], leaf["A"], leaf["offs"]
    src, dst, kw = _plan(ha, offs, near_limit)
    plan, oid, frows, fcols = build_pack_plan(src, dst, **kw)
    ref = A.to_packed(plan, jnp.asarray(oid), frows, fcols)
    band = interop.banded_from_arrays(A.data, offs, A.n_block_cols,
                                      device=CPU)
    got = band.to_packed(plan, torch.as_tensor(oid), frows, fcols)
    assert isinstance(got, BlockPacked) and got.plan == plan
    assert np.array_equal(np.asarray(ref.data_i), got.data_i.numpy())
    assert (ref.far_data is None) == (got.far_data is None)
    if near_limit > 0:
        assert got.far_data is not None
        assert np.array_equal(np.asarray(ref.far_data),
                              got.far_data.numpy())
        assert not got.fused_cheb_ok()
    x = torch.from_numpy(_vecs(plan.nb, plan.P, 3)[0])
    _close(band.matvec_t(x).numpy(), got.matvec_t(x).numpy(), 1e-12)
    assert torch.equal(got.diagonal_t(), band.diagonal_t())
    assert torch.equal(got.diagonal(), band.diagonal())
    if near_limit < 0:
        assert got.fused_cheb_ok()
        back = got.to_banded()
        assert np.array_equal(back.offsets, band.offsets)
        assert torch.equal(back.data, band.data)
        s, d = got.sparsity_pairs()
        p2, o2, _, _ = tpk.build_pack_plan(s, d, **kw)
        assert (p2.offsets, p2.slots) == (plan.offsets, plan.slots)
        assert np.array_equal(o2, oid)
    else:
        with pytest.raises(ValueError):
            got.to_banded()


def test_direct_packed_assembly_matches_jax(leaf):
    ha, hb, offs, gb = leaf["ha"], leaf["hb"], leaf["offs"], leaf["gb"]
    plan, oid = leaf["plan"], leaf["oid"]
    ref = assemble_sipg_banded_direct(
        ha, build_banded_groups(ha, offs, jnp.float64), offsets=offs,
        use_pallas=False, pack_plan=plan, pack_oid=jnp.asarray(oid))
    got = tsipg.assemble_sipg_banded_direct(
        hb, gb, offsets=offs, pack_plan=plan, pack_oid=torch.as_tensor(oid))
    assert isinstance(got, BlockPacked) and got.far_data is None
    assert got.data_i.shape == (plan.nb * plan.R_pad, plan.P)
    _close(np.asarray(ref.data_i), got.data_i.numpy(), 1e-12)


N = 8


@pytest.fixture(scope="module")
def jax_packed_flagship():
    """bench.py's BENCH_RELABEL=none flagship on the JAX package at n=8,
    f64: the fine level assembled packed, pack=True, K6 in interpret
    mode, unfused smoothing."""
    mesh = pd.hyper_cube(3, N)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    lv0 = max(1, agg.n_levels - 1 - 3)  # trim 3
    handlers, parents = build_rtree_hierarchy(
        mesh, agg, list(range(lv0, agg.n_levels - 1)), degree=1,
        relabel=None)
    ah = handlers[-1]
    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    plan, oid, _, _ = build_pack_plan(
        ft.poly_in[interior], ft.poly_out[interior], ah.n_poly, ah.n_basis,
        offsets=offs, near_limit=-1)
    groups = build_banded_groups(ah, offs, jnp.float64)
    A0 = assemble_sipg_banded_direct(ah, groups, offsets=offs,
                                     use_pallas=False, pack_plan=plan,
                                     pack_oid=jnp.asarray(oid))
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    b = assemble_rhs_direct(ah, groups, lambda x: 3 * jnp.pi**2 * u_ex(x),
                            u_ex)
    mg = build_multigrid(handlers, parents, A0, dtype=jnp.float64,
                         grid_shapes=None, chebyshev_degree=5, n_smooth=1,
                         smoothing_range=20.0, level_assembly="banded",
                         coarse_solver="inv", pack=True,
                         fused_smoother=False)
    res = mg.solve_cg(b, rtol=1e-8, maxiter=100, fmg=True)
    return dict(sizes=[h.n_poly for h in handlers], offsets=offs,
                b=np.asarray(b), x=np.asarray(res.x),
                iterations=int(res.iterations))


def test_packed_flagship_slice_matches_jax(jax_packed_flagship, monkeypatch):
    ref = jax_packed_flagship
    monkeypatch.setattr(tmg, "PACK_MIN_P", 0)  # pack the n=8 levels too
    fs = setup_flagship(n=N, device=CPU, dtype=torch.float64,
                        precond_dtype=None, relabel=None)
    res = solve_flagship(fs)
    assert fs.format == "packed" and fs.relabel is None
    assert fs.grid_shapes is None
    assert fs.level_sizes == ref["sizes"] == [8, 64, 512]
    assert np.array_equal(fs.band_offsets, ref["offsets"])
    assert len(fs.band_offsets) > 9  # wide: the packed path
    ells = fs.mg.ells
    assert not isinstance(ells[0], BlockPacked)  # the coarse solve's level
    assert all(isinstance(e, BlockPacked) for e in ells[1:])
    assert all(fs.mg._fused_ok(e, fs.b) for e in ells[1:])
    assert np.abs(fs.b.numpy() - ref["b"]).max() <= 1e-12 * np.abs(
        ref["b"]).max()
    assert res.iterations == ref["iterations"]
    assert np.abs(res.x.numpy() - ref["x"]).max() <= 1e-9
    assert float(res.residual) <= 1e-8 * float(fs.b.norm())


def _level(P, steps, dim=2):
    """A stand-in level whose interior faces join lanes p and p + o for
    each step o (nb=1), and its zero band."""
    src = np.concatenate([np.arange(P - o) for o in steps])
    dst = np.concatenate([np.arange(o, P) for o in steps])
    faces = SimpleNamespace(poly_in=src, poly_out=dst,
                            is_boundary=np.zeros(src.size, bool))
    offs = np.unique(np.concatenate([dst - src, src - dst, [0]]))
    band = BlockBanded(data=torch.zeros(len(offs), 1, 1, P,
                                        dtype=torch.float64),
                       offsets=offs, n_block_cols=P)
    return SimpleNamespace(n_poly=P, dim=dim, n_basis=1, faces=faces), band


@pytest.mark.parametrize("case", ["small", "wide", "narrow", "tight"])
def test_level_pack_rule(case, monkeypatch):
    """One rule on every device: below PACK_MIN_P polytopes a band stays;
    a wide one (the 2D leaf-rank level, 17 offsets, K=5) packs, with no far
    tail, and a pack passes through; a narrow one (<= 2 dim + 3 offsets, a
    lex grid) stays without a plan being built; one whose lanes touch
    nearly every offset (K + 2 >= n_off) stays."""
    if case in ("small", "wide"):
        _, h, offs, A, _ = _leaf(2, 16)
        band = interop.banded_from_arrays(A.data, offs, A.n_block_cols,
                                          device=CPU)
    else:
        h, band = _level(256, (1, 16)) if case == "narrow" else _level(
            64, (1, 2, 3, 4, 5))
    if case != "small":
        monkeypatch.setattr(tmg, "PACK_MIN_P", 0)
    if case == "narrow":
        assert len(band.offsets) == 5

        def no_plan(*a, **k):
            raise AssertionError("a plan was built for a narrow band")

        monkeypatch.setattr(tmg, "build_pack_plan", no_plan)
    got = tmg.maybe_pack_level(h, band)
    if case != "wide":
        assert got is band and tmg.level_pack_plan(h, band.offsets) is None
        return
    assert isinstance(got, BlockPacked) and got.far_data is None
    plan, oid = tmg.level_pack_plan(h, band.offsets)
    assert got.plan == plan and np.array_equal(got.oid.numpy(), oid)
    assert tmg.maybe_pack_level(h, got) is got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_kernels_match_plain(leaf, dtype):
    """K6 and K7 on the card against their plain versions (1e-5 relative
    in f32, 1e-12 in f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6/K7 have no CPU mode")
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    tp = leaf["tp"]
    di, oid, offs = tp.data_i.to(dev, tdt), tp.oid.to(dev), tp.offsets_t.to(
        dev)
    nb = tp.n_basis
    x, b, d, dinv = (torch.from_numpy(a).to(dev, tdt)
                     for a in _vecs(nb, tp.n_block_rows, 4))
    C = lambda t: t.cpu().numpy()
    _close(C(tpk.packed_matvec_t_ref(di, oid, offs, nb, x)),
           C(tpk.packed_matvec_t(di, oid, offs, nb, x)), tol)
    for dv in (d, None):
        for r, g in zip(
                tfc.packed_cheb_step_t_ref(di, oid, offs, nb, x, dv, b, dinv,
                                           0.37, 1.21),
                tfc.packed_cheb_step_t(di, oid, offs, nb, x, dv, b, dinv,
                                       0.37, 1.21)):
            _close(C(r), C(g), tol)
    _close(C(tfc.packed_residual_t_ref(di, oid, offs, nb, x, b)),
           C(tfc.packed_residual_t(di, oid, offs, nb, x, b)), tol)
