"""bf16 smoothing vectors (``vector_dtype=torch.bfloat16``) in the port
against the JAX package.

In the JAX package only the packed SpMV (K6, and K6 halo on a shard's slab)
reads bf16 x inside its kernel (``polydeal_tpu/ops/packed.py:294``, ``:333``;
f32 accumulation, ``:209``); every other wrapper casts bf16 vectors to f32
before its Pallas call and the result back.  The port mirrors that: K6 and
K6 halo have a bf16-x instantiation (``csrc/packed_bf16.cu``), K0, K1, K1
halo, K2, fused K0, K7 and their halo entries cast around their launches.
Checked here on the CPU (plain versions; the kernels against them run on
the card in ``chip_smoke.py`` phase 11):

* K6 and K6 halo with bf16 x (f32 and bf16 packs) against the JAX Pallas
  kernels in interpret mode on the 3D n=8 leaf pack (P = 512 lanes, K = 7
  slots), to 1 bf16 ulp of each output, plus 1e-5 of the largest entry
  where terms cancel (f32 sums in another order before the one rounding
  to bf16);
* the casts of K1, K0, K1 halo, K2, K2 halo, K7 and K7 halo against the
  JAX wrappers on bf16 vectors, and fused K0 against JAX's K2 on the same
  band, to the same bound;
* the ``Multigrid`` wiring of ``tests/test_multigrid.py`` (``lo_dinvs``
  dtypes, packed levels reusing the f32 operator object) and the
  ``ShardedBandedSystem`` wiring of ``tests/test_sharding.py`` (``lo_vec``,
  smoother band copies) on 2 gloo ranks, whose bf16 sharded solve is held
  to the unsharded one;
* one small bf16-vector MG-CG solve (2D n=8 p=1, f32 operator) against the
  JAX package's: the same iterations (10 in both on this CPU; the f32 solve
  takes 9), and solutions within 1e-4 of each other relative to the
  largest entry (both stop at rtol 1e-6 through differently rounded bf16
  preconditioners).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly import assemble_rhs  # noqa: E402
from polydeal_tpu.assembly import assemble_sipg_matrix  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.ops import banded as jbd  # noqa: E402
from polydeal_tpu.ops import fused_cheb as jfc  # noqa: E402
from polydeal_tpu.ops import packed as jpk  # noqa: E402
from polydeal_tpu.solvers import build_multigrid  # noqa: E402
from polydeal_tpu.solvers import build_structured_hierarchy  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.agglomeration import (  # noqa: E402
    RTreeAgglomerator as TRTreeAgglomerator,
)
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.models.sharded import spawn  # noqa: E402
from polydeal_tpu_torch.ops import banded as tbd  # noqa: E402
from polydeal_tpu_torch.ops import fused_cheb as tfc  # noqa: E402
from polydeal_tpu_torch.ops import packed as tpk  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402
from polydeal_tpu_torch.sparse import BlockPacked  # noqa: E402

CPU = torch.device("cpu")
BF16 = torch.bfloat16
C1, C2 = 0.37, 1.21


def _bf16_ulp(v):
    """The bf16 spacing at |v| (8 significant bits), elementwise."""
    a = np.abs(np.asarray(v, np.float64))
    return np.exp2(np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7)


def assert_within_ulp(ref, got):
    """``got`` (a bf16 tensor) within 1 bf16 ulp of ``ref`` elementwise,
    plus 1e-5 of the largest entry: the two f32 sums, in another order,
    may differ by that much before their one rounding to bf16 (the f32
    bound of the other parity tests), which shows where terms cancel."""
    assert got.dtype == BF16
    r = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    g = got.float().numpy().astype(np.float64)
    assert r.shape == g.shape
    tol = _bf16_ulp(np.maximum(np.abs(r), np.abs(g))) + 1e-5 * np.abs(r).max()
    assert (np.abs(r - g) <= tol).all()


def _J(a, dt=jnp.bfloat16):
    return jnp.asarray(np.asarray(a, np.float32), dt)


def _T(a, dt=BF16):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


def _vecs(nb, P, seed):
    rng = np.random.default_rng(seed)
    x, b, d = (rng.standard_normal((nb, P)) for _ in range(3))
    return x, b, d, 1.0 + rng.random((nb, P))


# ---- K6 and K6 halo with bf16 x ------------------------------------------


@pytest.fixture(scope="module")
def leaf_pack():
    """The 3D n=8 leaf band (leaf-rank order, 19 offsets) packed twice:
    fully coloured (K6; P = 512, K = 7) and with near_limit=128 for a
    halo of T = 128 (K6 halo; the far tail is the caller's)."""
    m = pd.hyper_cube(3, 8)
    agg = RTreeAgglomerator.build(m.cell_centers())
    ha = pd.AgglomerationHandler(m, agg.extract_agglomerates(
        agg.n_levels - 1), degree=1)
    ft = ha.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    A = assemble_sipg_banded_direct(
        ha, build_banded_groups(ha, offs, jnp.float64), offsets=offs,
        use_pallas=False)
    out = {}
    for key, near in (("full", -1), ("halo", 128)):
        plan, oid, fr, fc = jpk.build_pack_plan(
            ft.poly_in[interior], ft.poly_out[interior], ha.n_poly,
            ha.n_basis, offsets=offs, near_limit=near)
        Ap = A.to_packed(plan, jnp.asarray(oid), fr, fc)
        tp = interop.packed_from_arrays(Ap.data_i, Ap.oid, plan.offsets,
                                        plan.slots, plan.nb, device=CPU)
        out[key] = (plan, Ap, tp)
    plan = out["full"][0]
    assert (plan.P, plan.K) == (512, 7)
    return out


@pytest.mark.parametrize("band", ["float32", "bfloat16"])
def test_k6_bf16_x_plain_matches_jax(leaf_pack, band):
    plan, Ap, tp = leaf_pack["full"]
    x = _vecs(plan.nb, plan.P, 1)[0]
    dj = Ap.data_i.astype(getattr(jnp, band))
    ref = jpk.packed_matvec_t(dj, Ap.oid, plan, _J(x), interpret=True)
    assert ref.dtype == jnp.bfloat16
    di = tp.data_i.to(getattr(torch, band))
    got = tpk.packed_matvec_t_ref(di, tp.oid, tp.offsets_t, plan.nb, _T(x))
    assert_within_ulp(ref, got)
    # the wrapper on a CPU tensor, and BlockPacked's product, as they are
    assert torch.equal(got, tpk.packed_matvec_t(di, tp.oid, tp.offsets_t,
                                                plan.nb, _T(x)))
    if band == "float32":
        assert torch.equal(got, tp.matvec_t(_T(x)))


@pytest.mark.parametrize("band", ["float32", "bfloat16"])
def test_k6_halo_bf16_x_plain_matches_jax(leaf_pack, band):
    plan, Ap, tp = leaf_pack["halo"]
    T = 128
    rng = np.random.default_rng(2)
    x_ext = rng.standard_normal((plan.nb, plan.P + 2 * T))
    dj = Ap.data_i.astype(getattr(jnp, band))
    ref = jpk.packed_matvec_t_halo(dj, Ap.oid, plan, _J(x_ext), tile=T,
                                   interpret=True)
    got = tpk.packed_matvec_t_halo_ref(
        tp.data_i.to(getattr(torch, band)), tp.oid, tp.offsets_t, plan.nb,
        _T(x_ext), tile=T)
    assert_within_ulp(ref, got)


# ---- the other wrappers' casts -------------------------------------------

NB, P, T = 4, 512, 128
OFFSETS = np.array([-128, -37, -1, 0, 3, 64, 101, 128])


@pytest.fixture(scope="module")
def band():
    """A random o-major band [n_off, nb, nb, P] (zero blocks where a column
    leaves [0, P)), its i-major copy, and the same in JAX."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((len(OFFSETS), NB, NB, P)).astype(np.float32)
    for k, o in enumerate(OFFSETS):
        p = np.arange(P)
        data[k][:, :, (p + o < 0) | (p + o >= P)] = 0.0
    tb = tmg.BlockBanded(torch.from_numpy(data), OFFSETS, P).with_imajor()
    return dict(data=data, tb=tb, data_i=tb.data_i.numpy())


def test_k1_k0_casts_match_jax(band):
    x = _vecs(NB, P, 3)[0]
    tb = band["tb"]
    ref = jbd.banded_matvec_t_imajor(jnp.asarray(band["data_i"]), OFFSETS,
                                     NB, _J(x), interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = tbd.banded_matvec_t_imajor(tb.data_i, tb.offsets_t, NB, _T(x))
    assert_within_ulp(ref, got)
    ref0 = jbd.banded_matvec_t_pallas(jnp.asarray(band["data"]), OFFSETS,
                                      _J(x), interpret=True)
    got0 = tbd.banded_matvec_t_omajor(tb.data, tb.offsets_t, _T(x))
    assert_within_ulp(ref0, got0)
    # the casts reach the plain versions on the f32 vector, as the kernels
    f32 = tbd.banded_matvec_t_imajor_ref(tb.data_i, tb.offsets_t, NB,
                                         _T(x).float())
    assert torch.equal(got, f32.to(BF16))


def test_k1_halo_cast_matches_jax(band):
    rng = np.random.default_rng(4)
    x_ext = rng.standard_normal((NB, P + 2 * T))
    tb = band["tb"]
    ref = jbd.banded_matvec_t_halo(jnp.asarray(band["data_i"]), OFFSETS, NB,
                                   _J(x_ext), tile=T, interpret=True)
    got = tbd.banded_matvec_t_halo(tb.data_i, tb.offsets_t, NB, _T(x_ext),
                                   tile=T)
    assert_within_ulp(ref, got)


def test_k2_and_fused_k0_casts_match_jax(band):
    """K2 (step0, step, residual) against the JAX wrapper; fused K0 on the
    o-major band against the same JAX step (the JAX package has no fused
    o-major kernel)."""
    x, b, d, dinv = _vecs(NB, P, 5)
    tb = band["tb"]
    di = jnp.asarray(band["data_i"])
    for dv in (d, None):
        jd = None if dv is None else _J(dv)
        rx, rd = jfc.banded_cheb_step_t(di, OFFSETS, NB, _J(x), jd, _J(b),
                                        _J(dinv), C1, C2, interpret=True)
        td = None if dv is None else _T(dv)
        for step in (
                lambda: tfc.banded_cheb_step_t(
                    tb.data_i, tb.offsets_t, NB, _T(x), td, _T(b),
                    _T(dinv), C1, C2),
                lambda: tfc.banded_cheb_step_t_omajor(
                    tb.data, tb.offsets_t, _T(x), td, _T(b), _T(dinv), C1,
                    C2)):
            gx, gd = step()
            assert_within_ulp(rx, gx)
            assert_within_ulp(rd, gd)
    rr = jfc.banded_residual_t(di, OFFSETS, NB, _J(x), _J(b), interpret=True)
    assert_within_ulp(rr, tfc.banded_residual_t(tb.data_i, tb.offsets_t, NB,
                                                _T(x), _T(b)))
    assert_within_ulp(rr, tfc.banded_residual_t_omajor(
        tb.data, tb.offsets_t, _T(x), _T(b)))


def test_k2_halo_cast_matches_jax(band):
    rng = np.random.default_rng(6)
    x_ext = rng.standard_normal((NB, P + 2 * T))
    _, b, d, dinv = _vecs(NB, P, 7)
    tb = band["tb"]
    di = jnp.asarray(band["data_i"])
    rx, rd = jfc.banded_cheb_step_t_halo(di, OFFSETS, NB, _J(x_ext), _J(d),
                                         _J(b), _J(dinv), C1, C2, tile=T,
                                         interpret=True)
    gx, gd = tfc.banded_cheb_step_t_halo(tb.data_i, tb.offsets_t, NB,
                                         _T(x_ext), _T(d), _T(b), _T(dinv),
                                         C1, C2, tile=T)
    assert_within_ulp(rx, gx)
    assert_within_ulp(rd, gd)
    rr = jfc.banded_residual_t_halo(di, OFFSETS, NB, _J(x_ext), _J(b),
                                    tile=T, interpret=True)
    assert_within_ulp(rr, tfc.banded_residual_t_halo(
        tb.data_i, tb.offsets_t, NB, _T(x_ext), _T(b), tile=T))


def test_k7_casts_match_jax(leaf_pack):
    """K7 (step, residual) and K7 halo on bf16 vectors."""
    plan, Ap, tp = leaf_pack["full"]
    x, b, d, dinv = _vecs(plan.nb, plan.P, 8)
    dj = Ap.data_i.astype(jnp.float32)
    dt = tp.data_i.float()
    args = (tp.oid, tp.offsets_t, plan.nb)
    rx, rd = jfc.packed_cheb_step_t(dj, Ap.oid, plan, _J(x), _J(d), _J(b),
                                    _J(dinv), C1, C2, interpret=True)
    gx, gd = tfc.packed_cheb_step_t(dt, *args, _T(x), _T(d), _T(b), _T(dinv),
                                    C1, C2)
    assert_within_ulp(rx, gx)
    assert_within_ulp(rd, gd)
    rr = jfc.packed_residual_t(dj, Ap.oid, plan, _J(x), _J(b),
                               interpret=True)
    assert_within_ulp(rr, tfc.packed_residual_t(dt, *args, _T(x), _T(b)))
    plan, Ap, tp = leaf_pack["halo"]
    x_ext = np.random.default_rng(9).standard_normal(
        (plan.nb, plan.P + 2 * T))
    dj, dt = Ap.data_i.astype(jnp.float32), tp.data_i.float()
    args = (tp.oid, tp.offsets_t, plan.nb)
    rx, rd = jfc.packed_cheb_step_t_halo(dj, Ap.oid, plan, _J(x_ext), None,
                                         _J(b), _J(dinv), C1, C2, tile=T,
                                         interpret=True)
    gx, gd = tfc.packed_cheb_step_t_halo(dt, *args, _T(x_ext), None, _T(b),
                                         _T(dinv), C1, C2, tile=T)
    assert_within_ulp(rx, gx)
    assert_within_ulp(rd, gd)
    rr = jfc.packed_residual_t_halo(dj, Ap.oid, plan, _J(x_ext), _J(b),
                                    tile=T, interpret=True)
    assert_within_ulp(rr, tfc.packed_residual_t_halo(dt, *args, _T(x_ext),
                                                     _T(b), tile=T))


# ---- Multigrid and ShardedBandedSystem wiring ----------------------------


@pytest.mark.parametrize("pack", [False, True])
def test_multigrid_bf16_wiring(monkeypatch, pack):
    """tests/test_multigrid.py's bf16 wiring: precond_dtype alone lowers
    the band copies only; vector_dtype lowers the smoothing vectors
    (lo_dinvs); a packed level reuses its f32 operator object."""
    if pack:
        monkeypatch.setattr(tmg, "PACK_MIN_P", 0)
    n = 8
    mesh = tpd.hyper_cube(2, n)
    agg = TRTreeAgglomerator.build(mesh.cell_centers())
    hs, parents = tmg.build_rtree_hierarchy(
        mesh, agg, list(range(1, agg.n_levels - 1)), degree=1,
        relabel=None if pack else "lex")
    ah = hs[-1]
    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    A = tsipg.assemble_sipg_banded_direct(
        ah, tsipg.build_banded_groups(ah, offs, torch.float32, device=CPU),
        offsets=offs)
    gs = None if pack else tmg.detect_grid_shapes(hs, parents)
    kw = dict(grid_shapes=gs, dtype=torch.float32, level_assembly="banded",
              precond_dtype=BF16, device=CPU)
    mg = tmg.build_multigrid(hs, parents, A, **kw)
    assert mg.lo_ells is not None
    assert mg.lo_dinvs[-1].dtype == mg.dinvs_t[-1].dtype == torch.float32
    if pack:
        assert isinstance(mg.ells[-1], BlockPacked)
        assert mg.lo_ells[-1] is mg.ells[-1]
    else:
        assert mg.lo_ells[-1].dtype == BF16
    mgv = tmg.build_multigrid(hs, parents, A, vector_dtype=BF16, **kw)
    assert all(d.dtype == BF16 for d in mgv.lo_dinvs[1:])
    if pack:
        assert mgv.lo_ells[-1] is mgv.ells[-1]
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        ah.n_dofs)).float()
    res = mgv.solve_cg(b, rtol=1e-6, maxiter=200)
    assert res.x.dtype == torch.float32 and bool(torch.isfinite(res.x).all())
    assert res.iterations < 200
    # bf16 vectors reach an f64 band only through precond_dtype
    A64 = tmg.BlockBanded(A.data.double(), A.offsets, A.n_block_cols)
    with pytest.raises(ValueError, match="vector_dtype"):
        tmg.build_multigrid(hs, parents, A64, grid_shapes=gs,
                            dtype=torch.float64, level_assembly="banded",
                            vector_dtype=BF16, device=CPU)


_BF16_CASE = dict(n=8, dtype="float32", precond_dtype="bfloat16",
                  vector_dtype="bfloat16", rtol=1e-6)
SHARDED_CASES = {
    "lex bf16": dict(_BF16_CASE, hierarchy="rtree", relabel="lex"),
    "packed bf16": dict(_BF16_CASE, hierarchy="rtree", relabel=None,
                        pack_min_p=0),
    "lex precond only": dict(_BF16_CASE, hierarchy="rtree", relabel="lex",
                             vector_dtype=None),
}


@pytest.fixture(scope="module")
def sharded():
    """Rank 0's result per case on 2 fresh gloo ranks."""
    return dict(zip(SHARDED_CASES, spawn(2, list(SHARDED_CASES.values()),
                                         device="cpu", timeout=240.0)))


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_bf16_wiring_and_solve(sharded, case):
    """tests/test_sharding.py's wiring (lo_vec: bf16 with vector_dtype, the
    operator's dtype without; smoother band copies where the level keeps
    one), and the 2-rank solve against the unsharded no-FMG one: iterations
    within 1, solutions within 1e-4 of each other relative to the largest
    entry."""
    r = sharded[case]
    want = "bfloat16" if SHARDED_CASES[case]["vector_dtype"] else "float32"
    assert r["n_dev"] == 2 and r["lo_vec"] == want
    if case.startswith("lex"):
        assert any(r["has_lo"])  # the bf16 band copies
    else:
        assert not any(r["has_lo"])  # packs keep their f32 band
    assert abs(r["iterations"] - r["unsharded_iterations"]) <= 1
    assert r["iterations"] < 100
    x, xu = r["x"], r["x_unsharded"]
    assert np.abs(x - xu).max() <= 1e-4 * np.abs(xu).max()


def test_small_bf16_solve_matches_jax():
    n = 8
    hs, parents, gs = build_structured_hierarchy(pd.hyper_cube(2, n), n,
                                                 degree=1)
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    b = assemble_rhs(hs[-1], lambda x: 2 * jnp.pi**2 * u_ex(x), u_ex,
                     dtype=jnp.float32)
    kw = dict(chebyshev_degree=5, n_smooth=1, coarse_solver="inv")
    rj = build_multigrid(hs, parents, assemble_sipg_matrix(
        hs[-1], dtype=jnp.float32), grid_shapes=gs, dtype=jnp.float32,
        vector_dtype=jnp.bfloat16, **kw).solve_cg(b, rtol=1e-6, maxiter=200)
    ths, tparents, tgs = tmg.build_structured_hierarchy(
        tpd.hyper_cube(2, n), n, degree=1)
    mg = tmg.build_multigrid(
        ths, tparents, tsipg.assemble_sipg_matrix(
            ths[-1], dtype=torch.float32, device=CPU), grid_shapes=tgs,
        dtype=torch.float32, vector_dtype=BF16, device=CPU, **kw)
    assert all(d.dtype == BF16 for d in mg.lo_dinvs[1:])
    rt = mg.solve_cg(torch.from_numpy(np.array(b)), rtol=1e-6, maxiter=200)
    assert rt.iterations == int(rj.iterations) == 10
    xj = np.asarray(rj.x, np.float64)
    assert np.abs(rt.x.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
