"""K3-K5 (volume, face group and boundary SIPG blocks) of the port.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's Pallas kernels in interpret mode, on f32
tables that the JAX package builds (``build_banded_groups``) and the port
takes over through ``interop``, to 2e-5 relative to the largest entry (the
bound the JAX package holds its own Pallas path to, tests/test_ops.py:182:
f32 sums in another order).  The JAX kernels need P padded to a multiple
of 128; their outputs are sliced back.  The port's whole direct assembly is
held to the JAX package's interpret-mode assembly the same way.  Cases: a
structured 2D level (C = 1, P = 256) and R-tree levels with C > 1 and P
not a multiple of 128, at p = 1 and 2 in 2D (p = 3 structured only) and
p = 1 in 3D; K5 alone, and the whole assembly, also at 2D p = 4 and 5,
where the JAX package's rule runs its Pallas K5 and leaves the volume and
face blocks to XLA's einsums (the port's ``kernel_blocks`` makes the same
split).  The test of the CUDA kernels against the plain versions needs a
card and skips without one.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    _pad_lane_tables,
    assemble_sipg_banded_direct,
    build_banded_groups,
    default_penalty_constant,
)
from polydeal_tpu.ops.sipg_kernels import (  # noqa: E402
    boundary_blocks_pallas,
    face_group_blocks_pallas,
    volume_blocks_pallas,
)
from polydeal_tpu.solvers import build_structured_hierarchy  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.ops import sipg_kernels as tk  # noqa: E402

CPU = torch.device("cpu")
TOL = 2e-5

# (mesh, degree): structured levels have C = 1, R-tree ones C > 1 and P not
# a multiple of 128.  p = 3 runs on the structured level only: the R-tree
# level's many offsets each compile a JAX interpret kernel (~2 min at p = 3).
CASES = [("structured2d", 1), ("structured2d", 2), ("structured2d", 3),
         ("rtree2d", 1), ("rtree2d", 2), ("rtree3d", 1)]
# 2D p = 4 and 5 (nb = 15, 21; q = 5, 6 points a boundary face slot): K5
# alone is built there, as the JAX package gives only the boundary blocks
# to its Pallas kernels
HIGH_CASES = [("structured2d", 4), ("structured2d", 5), ("rtree2d", 4),
              ("rtree2d", 5)]


@functools.lru_cache(maxsize=None)
def _level(mesh: str, degree: int):
    """(JAX handler, port handler, offsets, JAX f32 tables, the same tables
    as port tensors)."""
    if mesh == "structured2d":
        m, t = pd.hyper_cube(2, 16), tpd.hyper_cube(2, 16)
        hs, _, _ = build_structured_hierarchy(m, 16, degree=degree)
        ha = hs[-1]
        c2p = np.asarray(ha.cell2poly)
    else:
        dim, n = (2, 10) if mesh == "rtree2d" else (3, 4)
        m, t = pd.hyper_cube(dim, n), tpd.hyper_cube(dim, n)
        agg = RTreeAgglomerator.build(m.cell_centers())
        c2p = agg.extract_agglomerates(agg.n_levels - 2)
        ha = pd.AgglomerationHandler(m, c2p, degree=degree)
    hb = tpd.AgglomerationHandler(t, c2p, degree=degree)
    ft = ha.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    ga = build_banded_groups(ha, offs, jnp.float32)
    C = max(g["w"].shape[0] for g in ga["groups"].values())
    if mesh == "structured2d":
        assert C == 1
    else:
        assert C > 1 and ga["vol"]["w"].shape[0] > 1
        assert ha.n_poly % 128 != 0
    return ha, hb, offs, ga, interop.groups_from_arrays(ga, device=CPU)


def _padded(ha, ga):
    P = ha.n_poly
    return _pad_lane_tables(ga, -(-P // 128) * 128 - P)


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(ref - got).max() <= tol * scale


@pytest.mark.parametrize("mesh,degree", CASES)
def test_volume_blocks_match_jax_kernel(mesh, degree):
    ha, _, _, ga, gb = _level(mesh, degree)
    tab_p, ext_p, _ = _padded(ha, ga)
    ref = volume_blocks_pallas(tab_p["vol"], ext_p, degree, ha.dim,
                               interpret=True)[:, :ha.n_poly]
    got = tk.volume_blocks(gb["vol"], gb["ext_t"], degree, ha.dim)
    assert got.dtype == torch.float32
    _close(ref, got.numpy())


@pytest.mark.parametrize("mesh,degree", CASES)
def test_face_group_blocks_match_jax_kernel(mesh, degree):
    ha, _, _, ga, gb = _level(mesh, degree)
    tab_p, ext_p, lo_p = _padded(ha, ga)
    pc = default_penalty_constant(degree, ha.dim)
    for o, g in tab_p["groups"].items():
        ref = face_group_blocks_pallas(g, ext_p, lo_p, o, degree, ha.dim, pc,
                                       interpret=True)
        got = tk.face_group_blocks(gb["groups"][o], gb["ext_t"], gb["lo_t"],
                                   o, degree, ha.dim, pc)
        assert len(got) == 4
        for r, m in zip(ref, got):
            _close(r[:, :ha.n_poly], m.numpy())


@pytest.mark.parametrize("mesh,degree", CASES + HIGH_CASES)
def test_boundary_blocks_match_jax_kernel(mesh, degree):
    ha, _, _, ga, gb = _level(mesh, degree)
    tab_p, ext_p, _ = _padded(ha, ga)
    pc = default_penalty_constant(degree, ha.dim)
    ref = boundary_blocks_pallas(tab_p["bdry"], ext_p, degree, ha.dim, pc,
                                 interpret=True)[:, :ha.n_poly]
    got = tk.boundary_blocks(gb["bdry"], gb["ext_t"], degree, ha.dim, pc)
    _close(ref, got.numpy())


@pytest.mark.parametrize("mesh,degree", CASES + [("rtree2d", 4)])
def test_direct_assembly_matches_jax_kernels(mesh, degree):
    """The port's whole direct assembly (both layouts) against the JAX
    package's assembly through its Pallas kernels in interpret mode (at 2D
    p = 4: its Pallas K5 and its einsums for the volume and face
    blocks)."""
    ha, hb, offs, ga, gb = _level(mesh, degree)
    assert tk.kernel_blocks("dgp", ha.dim, degree, torch.float32) == (
        {"boundary"} if degree >= 4 else {"volume", "face", "boundary"})
    A = assemble_sipg_banded_direct(ha, ga, offsets=offs, interpret=True,
                                    use_pallas=False)
    B = tsipg.assemble_sipg_banded_direct(hb, gb, offsets=offs)
    assert np.array_equal(B.offsets, A.offsets)
    assert B.data.dtype == torch.float32
    _close(A.data, B.data.numpy())
    Bi = tsipg.assemble_sipg_banded_direct(hb, gb, offsets=offs,
                                           layout="imajor")
    _close(A.with_imajor().data_i, Bi.data_i.numpy())


# The symmetry K3 and K4 accumulate by (csrc/sipg.cu): the volume block is
# symmetric, and K4's four blocks are one symmetric 2nb x 2nb matrix (m21 =
# m12^T, m11 and m22 symmetric), in the plain versions and in the JAX
# package's Pallas kernels alike, on f64 tables of real levels.
SYM_CASES = [("rtree3d", 1), ("rtree2d", 2)]
SYM_TOL = 1e-14


@functools.lru_cache(maxsize=None)
def _level64(mesh: str, degree: int):
    """(JAX f64 tables, the same as port tensors) of ``_level``'s level."""
    ha, _, offs, _, _ = _level(mesh, degree)
    ga = build_banded_groups(ha, offs, jnp.float64)
    return ga, interop.groups_from_arrays(ga, device=CPU)


def _square(m, nb):
    """[nb * nb, P] block rows -> [nb, nb, P] (row i * nb + j)."""
    return np.asarray(m, np.float64).reshape(nb, nb, -1)


def _assert_transposed(a, b, scale):
    assert np.abs(a - b.transpose(1, 0, 2)).max() <= SYM_TOL * scale


@pytest.mark.parametrize("mesh,degree", SYM_CASES)
def test_face_blocks_are_one_symmetric_matrix(mesh, degree):
    ha = _level(mesh, degree)[0]
    ga, gb = _level64(mesh, degree)
    nb, P = ha.basis.n_basis, ha.n_poly
    pc = default_penalty_constant(degree, ha.dim)
    o = min(ga["groups"])
    ref = tk.face_group_blocks_ref(gb["groups"][o], gb["ext_t"], gb["lo_t"],
                                   o, degree, ha.dim, pc)
    assert ref[0].dtype == torch.float64
    tab_p, ext_p, lo_p = _padded(ha, ga)
    jx = face_group_blocks_pallas(tab_p["groups"][o], ext_p, lo_p, o, degree,
                                  ha.dim, pc, interpret=True)
    for blocks in (ref, [np.asarray(b)[:, :P] for b in jx]):
        m11, m12, m21, m22 = (_square(b, nb) for b in blocks)
        scale = max(np.abs(m).max() for m in (m11, m12, m21, m22))
        assert scale > 0
        _assert_transposed(m21, m12, scale)
        _assert_transposed(m11, m11, scale)
        _assert_transposed(m22, m22, scale)


@pytest.mark.parametrize("mesh,degree", SYM_CASES)
def test_volume_blocks_are_symmetric(mesh, degree):
    ha = _level(mesh, degree)[0]
    ga, gb = _level64(mesh, degree)
    nb, P = ha.basis.n_basis, ha.n_poly
    ref = tk.volume_blocks_ref(gb["vol"], gb["ext_t"], degree, ha.dim)
    assert ref.dtype == torch.float64
    tab_p, ext_p, _ = _padded(ha, ga)
    jx = volume_blocks_pallas(tab_p["vol"], ext_p, degree, ha.dim,
                              interpret=True)[:, :P]
    for K in (ref, jx):
        K = _square(K, nb)
        _assert_transposed(K, K, np.abs(K).max())


def _tables(C, Q, dim, P, dtype=torch.float32):
    rng = np.random.default_rng(1)
    t = lambda *s: torch.as_tensor(rng.random(s), dtype=dtype)
    group = dict(pts_in=t(C, Q, dim, P), n=t(C, Q, dim, P) - 0.5,
                 w=t(C, Q, P), h_f=0.5 + t(C, P))
    return group, 0.5 + t(dim, P), t(dim, P)


def test_kernel_arg_checks():
    """What the CUDA wrappers reject before any launch."""
    g, ext, lo = _tables(2, 4, 3, 64)
    assert tk._check("k", 1, 3, {"w": (g["w"], (2, 4, 64))}) == torch.float32
    with pytest.raises(ValueError):  # degree the kernels were not built for
        tk._check("k", 4, 3, {"w": (g["w"], (2, 4, 64))})
    # K5 alone is built at 2D p = 4-5
    for degree in (4, 5):
        assert tk._check("k", degree, 2, {"w": (g["w"], (2, 4, 64))},
                         kind="boundary") == torch.float32
        for kind in ("volume", "face"):
            with pytest.raises(ValueError):
                tk._check("k", degree, 2, {"w": (g["w"], (2, 4, 64))},
                          kind=kind)
    with pytest.raises(ValueError):
        tk._check("k", 6, 2, {"w": (g["w"], (2, 4, 64))}, kind="boundary")
    with pytest.raises(ValueError):  # 1D
        tk._check("k", 1, 1, {"w": (g["w"], (2, 4, 64))})
    with pytest.raises(TypeError):  # bf16 tables
        tk._check("k", 1, 3, {"w": (g["w"].bfloat16(), (2, 4, 64))})
    with pytest.raises(ValueError):  # mixed dtypes
        tk._check("k", 1, 3, {"w": (g["w"], (2, 4, 64)),
                              "ext": (ext.double(), (3, 64))})
    with pytest.raises(ValueError):  # wrong shape
        tk._check("k", 1, 3, {"pts": (g["pts_in"], (2, 4, 2, 64))})
    with pytest.raises(ValueError):  # not contiguous
        tk._check("k", 1, 3, {"ext": (ext.T.contiguous().T, (3, 64))})
    with pytest.raises(RuntimeError):  # no kernel for this device
        tk._on_card("volume_blocks", torch.empty(0, device="meta"))
    assert not tk._on_card("volume_blocks", ext)


def test_tables_are_contiguous():
    """``build_banded_groups`` hands the kernels contiguous tables."""
    hb = _level("rtree2d", 1)[1]
    offs = _level("rtree2d", 1)[2]
    tabs = tsipg.build_banded_groups(hb, offs, torch.float32, device=CPU)
    leaves = [tabs["ext_t"], tabs["lo_t"], *tabs["vol"].values(),
              *tabs["bdry"].values()]
    for g in tabs["groups"].values():
        leaves += list(g.values())
    assert all(t.is_contiguous() for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_kernels_match_plain(dtype):
    """K3-K5 on the card against their plain versions (2e-5 relative in
    f32, 1e-12 in f64), at C > 1, P not a multiple of the block, p = 1-3,
    and at coarse shapes whose launch plans split a lane's points over
    blocks; two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3-K5 have no CPU mode")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 1e-12
    # (C, Q, P): lanes that fill the card (S = 1), and the coarse levels'
    # shapes, whose points split over blocks (S > 1) and a second pass; K5
    # alone at 2D p = 4-5
    shapes = {(3, 1): [(3, 4, 1000), (512, 8, 512), (64, 4, 512)],
              (3, 2): [(3, 4, 1000), (64, 9, 100)], (2, 3): [(3, 4, 1000)],
              (2, 4): [(3, 4, 1000), (64, 5, 100)], (2, 5): [(3, 4, 1000)]}
    for (dim, degree), (C, Q, P) in ((k, s) for k, v in shapes.items()
                                     for s in v):
        kinds = tk.kernel_blocks("dgp", dim, degree, dt)
        if (C, Q, P) != (3, 4, 1000):
            assert max(tk.sipg_launch_plan(
                P, C, Q, tk.sipg_form(kind, dim, degree, dt)).S
                for kind in kinds) > 1
        g, ext, lo = _tables(C, Q, dim, P, dt)
        g = {k: v.to(dev) for k, v in g.items()}
        ext, lo = ext.to(dev), lo.to(dev)
        vol = dict(pts=g["pts_in"], w=g["w"])
        C = lambda t: t.cpu().numpy()
        _close(C(tk.boundary_blocks_ref(g, ext, degree, dim, 40.0)),
               C(tk.boundary_blocks(g, ext, degree, dim, 40.0)), tol)
        assert torch.equal(tk.boundary_blocks(g, ext, degree, dim, 40.0),
                           tk.boundary_blocks(g, ext, degree, dim, 40.0))
        if kinds == {"boundary"}:
            with pytest.raises(ValueError):
                tk.volume_blocks(vol, ext, degree, dim)
            continue
        _close(C(tk.volume_blocks_ref(vol, ext, degree, dim)),
               C(tk.volume_blocks(vol, ext, degree, dim)), tol)
        for r, m in zip(tk.face_group_blocks_ref(g, ext, lo, 7, degree, dim,
                                                 40.0),
                        tk.face_group_blocks(g, ext, lo, 7, degree, dim,
                                             40.0)):
            _close(C(r), C(m), tol)
        # no atomics: two launches give the same bits
        assert torch.equal(tk.volume_blocks(vol, ext, degree, dim),
                           tk.volume_blocks(vol, ext, degree, dim))
        assert all(torch.equal(a, b) for a, b in zip(
            tk.face_group_blocks(g, ext, lo, 7, degree, dim, 40.0),
            tk.face_group_blocks(g, ext, lo, 7, degree, dim, 40.0)))
