"""K1 (the i-major banded SpMV) and K1 halo: the block sizes the kernels
have a specialised build for, the plain versions at each of them, and the
CUDA kernel against its plain version; K1, K2 and their halo entries at an
nb without a specialised build (their runtime-nb build,
``csrc/banded_any_nb.cu``).

K1 runs by a launch plan that the kernel library chooses
(``csrc/banded_matvec.cu`` ``k1_plan``, reported by ``ops/banded.k1_plan``):
W lanes a thread (K2's rule: wide where P, x's row stride and the halo are
multiples of W and the operands 16-byte aligned, else 1) and S offset
groups a block (S > 1 where P / W threads leave the card short: the groups
sum contiguous offset ranges and meet in shared memory in group order).

On the CPU: ``imajor_band`` takes an nb with no specialised build, and the
wrappers of K1, K1 halo and K2 return their plain versions' bits there;
every nb the P_k bases give at dim 2-3, p 1-3 has a specialised build;
K1's plain version equals K1 halo's on a zero-padded x_ext at
each built nb (f64, 1e-12 relative to the largest entry: two gathers of
the same sum); on CPU tensors the wrapper runs the plain version and
launches nothing.  The JAX parity of the plain versions is
``tests/test_torch_ops.py`` and ``tests/test_torch_halo.py``.

On a card (``-m cuda``; the file imports no JAX, so it runs there with
``--noconftest``): K1 against its plain version at every built nb and
every (band, vector) dtype pair of the C interface, with an S > 1 plan;
P not a multiple of W and a misaligned x (W = 1); halo slabs with S > 1
and S = 1; the plans at the main path's shapes; two launches bitwise
equal; the runtime-nb build at nb 5, 8, 27 and 35 (K1, K2's three modes,
every dtype pair) and K1 / K2 halo at nb = 8, each against its plain
version and bitwise over two launches.  Tolerances: 1e-5 relative for f32
vectors (f32 sums in another order), 1e-12 for f64.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.fem.basis import make_basis  # noqa: E402
from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.ops import banded as bd  # noqa: E402
from polydeal_tpu_torch.ops import fused_cheb as fc  # noqa: E402

# aligned (multiples of 4 and 8) and unaligned offsets, both signs
OFFSETS = (-70, -64, -9, -1, 0, 1, 8, 13, 64, 67)
# (band dtype, vector dtype): the pairs of the C interface (PD_DISPATCH)
PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("float64", "float64"), ("float32", "float64"),
         ("bfloat16", "float64")]
TOL = {"float32": 1e-5, "float64": 1e-12}


def _band(nb, P, offsets=OFFSETS, seed=0, dtype=torch.float64,
          vdtype=torch.float64, device="cpu"):
    """A seeded band [nb * R_pad, P] (R_pad = n_off * nb rounded up to 8;
    padding rows hold junk that must never be read), its int32 offsets and
    x [nb, P]."""
    rng = np.random.default_rng(seed)
    R_pad = -(-len(offsets) * nb // 8) * 8
    data_i = torch.from_numpy(rng.standard_normal((nb * R_pad, P)))
    x = torch.from_numpy(rng.standard_normal((nb, P)))
    offs = torch.tensor(offsets, dtype=torch.int32, device=device)
    return data_i.to(device, dtype), offs, x.to(device, vdtype)


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _cheb(nb, P, seed, dtype=torch.float64, device="cpu"):
    """Seeded b, d and dinv [nb, P] of a Chebyshev step."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((nb, P))).to(
        device, dtype) for _ in range(3))


@pytest.mark.parametrize("nb", [1, 2, 5, 8, 9, 27])
def test_unbuilt_nb_is_refused(nb):
    """These nb (TensorDGQ's 8, 9, 27 among them) have no specialised
    K1/K2 build; no longer refused: ``imajor_band`` takes them (their
    runtime-nb build launches on a card), and on CPU tensors the wrappers
    of K1, K1 halo and K2 (step and residual) return their plain versions'
    bits and launch nothing.  K0's o-major band takes them too."""
    P = 64
    data_i, offs, x = _band(nb, P, seed=nb)
    kb = bd.imajor_band(data_i, offs, nb)
    assert (kb.nb, kb.P, kb.n_off) == (nb, P, len(OFFSETS))
    T = max(abs(o) for o in OFFSETS)
    x_ext = torch.nn.functional.pad(x, (T, T))
    b, d, dinv = _cheb(nb, P, seed=nb + 1)
    before = dict(_build.launches)
    assert torch.equal(bd.banded_matvec_t_imajor(data_i, offs, nb, x),
                       bd.banded_matvec_t_imajor_ref(data_i, offs, nb, x))
    assert torch.equal(
        bd.banded_matvec_t_halo(data_i, offs, nb, x_ext, tile=T),
        bd.banded_matvec_t_halo_ref(data_i, offs, nb, x_ext, tile=T))
    got = fc.banded_cheb_step_t(data_i, offs, nb, x, d, b, dinv, 0.3, 0.7)
    want = fc.banded_cheb_step_t_ref(data_i, offs, nb, x, d, b, dinv, 0.3,
                                     0.7)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(fc.banded_residual_t(data_i, offs, nb, x, b),
                       fc.banded_residual_t_ref(data_i, offs, nb, x, b))
    assert _build.launches == before
    data = torch.zeros(len(OFFSETS), nb, nb, 64)
    assert bd.omajor_band(data, offs).nb == nb


def test_built_nb_covers_the_bases():
    """Every nb a P_k basis gives at dim 2-3, p 1-3 has a K1/K2 build."""
    want = {math.comb(p + dim, dim) for dim in (2, 3) for p in (1, 2, 3)}
    got = {make_basis("dgp", dim, p).n_basis for dim in (2, 3)
           for p in (1, 2, 3)}
    assert got == want == set(bd.KERNEL_NB)


# The runtime-nb build's plan (ops/banded.any_nb_plan, csrc/banded_any_nb.cu
# plan_of) at the shapes its paths give it: (nb, n_off, P, ldx, halo, data
# dtype, vector dtype) -> (W, S, rows R, row chunks a block CB).  Phase 16's
# fine bands (TensorDGQ Q1 n=64, Q2 and P_4 n=32; f32, their bf16 smoothing
# copies and f64) whole and as slab 1 of a 4-way cut, phase 17's (the 2D
# monodomain at p = 4 and 5, lex): the whole f32 bands take 8 rows a thread
# but Q2's (32768 lanes, nb 27: too few threads), the whole bands keep S =
# 1, the few-lane slabs split the offsets.
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
ANY_NB_PLANS = [
    ((8, 7, 262144, None, 0, F32, F32), (4, 1, 8, 1)),
    ((8, 7, 262144, None, 0, BF16, F32), (8, 1, 4, 2)),
    ((8, 7, 262144, None, 0, F64, F64), (2, 1, 4, 2)),
    ((27, 7, 32768, None, 0, F32, F32), (4, 1, 2, 2)),
    ((27, 7, 32768, None, 0, BF16, F32), (8, 2, 4, 2)),
    ((27, 7, 32768, None, 0, F64, F64), (2, 1, 4, 2)),
    ((35, 7, 32768, None, 0, F32, F32), (4, 1, 8, 2)),
    ((35, 7, 32768, None, 0, F64, F64), (2, 1, 4, 2)),
    ((8, 7, 65536, 65536 + 8192, 4096, F32, F32), (4, 1, 2, 2)),
    ((8, 7, 65536, 65536 + 8192, 4096, F64, F64), (2, 1, 4, 2)),
    ((27, 7, 8192, 8192 + 2048, 1024, F32, F32), (4, 2, 2, 2)),
    ((27, 7, 8192, 8192 + 2048, 1024, F64, F64), (2, 2, 4, 2)),
    ((35, 7, 8192, 8192 + 2048, 1024, F32, F32), (4, 1, 2, 2)),
    ((35, 7, 8192, 8192 + 2048, 1024, F64, F64), (2, 1, 4, 2)),
    ((15, 5, 262144, None, 0, F32, F32), (4, 1, 8, 2)),
    ((15, 5, 262144, None, 0, BF16, F32), (8, 1, 4, 2)),
    ((15, 5, 262144, None, 0, F64, F64), (2, 1, 4, 2)),
    ((21, 5, 65536, None, 0, F32, F32), (4, 1, 8, 2)),
    ((21, 5, 65536, None, 0, BF16, F32), (8, 1, 4, 2)),
    ((21, 5, 65536, None, 0, F64, F64), (2, 1, 4, 2)),
]


@pytest.mark.parametrize("args,want", ANY_NB_PLANS)
def test_any_nb_plan_at_the_paths_shapes(args, want):
    """The runtime-nb plan at phase 16's and 17's shapes, and what every
    plan must hold: R W accumulators within 384 bytes, CB S row chunks
    and groups a block leaving at least a warp of lanes-threads, the
    groups' partial sums within 48 KB, the grid covering every lane and
    row."""
    nb, n_off, P, ldx, halo, ddt, vdt = args
    pl = bd.any_nb_plan(nb, n_off, P, ddt, vdt, ldx=ldx, halo=halo)
    assert (pl.W, pl.S, pl.rows, pl.chunks) == want
    vsz = torch.empty((), dtype=vdt).element_size()
    assert pl.rows * pl.W * vsz <= 384 and pl.rows <= nb
    Lt = pl.threads // (pl.chunks * pl.S)
    assert Lt >= 32 and pl.S <= n_off
    assert pl.smem <= 48 * 1024
    lane_tiles = -(-(-(-P // pl.W)) // Lt)
    assert pl.blocks == lane_tiles * -(-(-(-nb // pl.rows)) // pl.chunks)


def test_any_nb_plan_fallbacks():
    """One lane a thread where P, ldx or the halo is no multiple of W or
    an operand is misaligned; rows a thread at most nb; S at most 4 and
    2 S <= n_off."""
    assert bd.any_nb_plan(15, 5, 4099, F32, F32).W == 1
    assert bd.any_nb_plan(15, 5, 4096, F32, F32, aligned=False).W == 1
    assert bd.any_nb_plan(15, 5, 4096, F64, F64, ldx=4096 + 6,
                          halo=3).W == 1
    assert bd.any_nb_plan(1, 3, 64, F64, F64).rows == 1
    assert bd.any_nb_plan(3, 3, 64, F64, F64).rows == 2
    assert bd.any_nb_plan(8, 1, 64, F32, F32).S == 1  # 2 S > n_off
    few = bd.any_nb_plan(8, 3, 64, F32, F32)
    assert few.S == 2 and few.chunks == 2
    assert bd.any_nb_plan(8, 31, 64, F32, F32).S == 4


@pytest.mark.parametrize("nb", bd.KERNEL_NB)
def test_plain_product_equals_halo_plain(nb):
    """K1's plain version equals K1 halo's on x_ext = x zero-padded by T =
    max |offset| lanes; on CPU tensors the wrapper returns the plain
    version's bits and launches nothing."""
    P = 200
    data_i, offs, x = _band(nb, P, seed=nb)
    T = max(abs(o) for o in OFFSETS)
    x_ext = torch.nn.functional.pad(x, (T, T))
    y = bd.banded_matvec_t_imajor_ref(data_i, offs, nb, x)
    assert _rel(bd.banded_matvec_t_halo_ref(data_i, offs, nb, x_ext,
                                            tile=T), y) <= 1e-12
    before = dict(_build.launches)
    assert torch.equal(bd.banded_matvec_t_imajor(data_i, offs, nb, x), y)
    assert torch.equal(bd.banded_matvec_t_halo(data_i, offs, nb, x_ext,
                                               tile=T),
                       bd.banded_matvec_t_halo_ref(data_i, offs, nb, x_ext,
                                                   tile=T))
    assert _build.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


def _check(data_i, offs, nb, x, vdt, halo=None):
    """K1 (K1 halo with ``halo``) against its plain version, and a second
    launch bitwise equal to the first; returns the plan."""
    kb = bd.imajor_band(data_i, offs, nb)
    if halo is None:
        got = bd.banded_matvec_t_imajor(data_i, offs, nb, x, band=kb)
        again = bd.banded_matvec_t_imajor(data_i, offs, nb, x, band=kb)
        want = bd.banded_matvec_t_imajor_ref(data_i, offs, nb, x)
    else:
        got = bd.banded_matvec_t_halo(data_i, offs, nb, x, tile=halo,
                                      band=kb)
        again = bd.banded_matvec_t_halo(data_i, offs, nb, x, tile=halo,
                                        band=kb)
        want = bd.banded_matvec_t_halo_ref(data_i, offs, nb, x, tile=halo)
    assert got.dtype == x.dtype
    assert _rel(got, want) <= TOL[vdt]
    assert torch.equal(got, again)
    return bd.k1_plan(kb, x, halo)


@pytest.mark.cuda
@pytest.mark.parametrize("ddt,vdt", PAIRS)
@pytest.mark.parametrize("nb", bd.KERNEL_NB)
def test_cuda_k1_every_nb_and_dtype(cuda, nb, ddt, vdt):
    """Every built nb and dtype pair at 8192 lanes: W lanes a thread and
    the offsets split over S > 1 groups."""
    data_i, offs, x = _band(nb, 8192, seed=nb, dtype=getattr(torch, ddt),
                            vdtype=getattr(torch, vdt), device=cuda)
    plan = _check(data_i, offs, nb, x, vdt)
    assert plan.W > 1 and plan.S > 1


@pytest.mark.cuda
@pytest.mark.parametrize("ddt,vdt", PAIRS)
def test_cuda_k1_one_lane_a_thread(cuda, ddt, vdt):
    """P not a multiple of W, and an x view 4 bytes off 16-byte alignment:
    one lane a thread (W = 1)."""
    nb = 4
    data_i, offs, x = _band(nb, 4099, dtype=getattr(torch, ddt),
                            vdtype=getattr(torch, vdt), device=cuda)
    assert _check(data_i, offs, nb, x, vdt).W == 1
    data_i, offs, x = _band(nb, 4096, dtype=getattr(torch, ddt),
                            vdtype=getattr(torch, vdt), device=cuda)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xv = buf[1:].view(nb, 4096)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0
    assert _check(data_i, offs, nb, xv, vdt).W == 1


@pytest.mark.cuda
@pytest.mark.parametrize("per,S", [(8192, 4), (262144, 1)])
@pytest.mark.parametrize("vdt", ["float32", "float64"])
def test_cuda_k1_halo(cuda, per, S, vdt):
    """K1 halo on a slab of ``per`` lanes with the lex flagship's 7
    offsets of the 64^3 grid and a halo of T = 4096 lanes whose values
    differ from the interior's: S = 4 at 8192 lanes (the 32768-lane level
    cut four ways), S = 1 at 262144."""
    nb, T = 4, 4096
    offsets = (-4096, -64, -1, 0, 1, 64, 4096)
    t = getattr(torch, vdt)
    data_i, offs, _ = _band(nb, per, offsets, dtype=t, vdtype=t,
                            device=cuda)
    x_ext = torch.randn(nb, per + 2 * T, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3)).to(cuda,
                                                                       t)
    plan = _check(data_i, offs, nb, x_ext, vdt, halo=T)
    assert (plan.W, plan.S) == (16 // t.itemsize, S)


@pytest.mark.cuda
@pytest.mark.parametrize("P,n_off,ddt,vdt,W,S", [
    (262144, 7, "float32", "float32", 4, 1),  # lex flagship fine
    (262144, 7, "bfloat16", "float32", 8, 2),
    (32768, 7, "float32", "float32", 4, 4),  # lex 32768-lane level
    (32768, 31, "float32", "float32", 4, 8),  # COO 32768-lane level
    (32768, 31, "float64", "float64", 2, 4),
    (262144, 37, "float64", "float64", 2, 1),  # COO fine level
])
def test_cuda_k1_plan(cuda, P, n_off, ddt, vdt, W, S):
    """The library's plan at the main path's shapes (nb = 4): S doubles
    (to 8 at most, while 2 S <= n_off) until P / W * S threads reach
    65536."""
    data_i = torch.empty(4 * (-(-n_off * 4 // 8) * 8), P,
                         dtype=getattr(torch, ddt), device=cuda)
    offs = torch.arange(n_off, dtype=torch.int32, device=cuda)
    x = torch.zeros(4, P, dtype=getattr(torch, vdt), device=cuda)
    plan = bd.k1_plan(bd.imajor_band(data_i, offs, 4), x)
    assert (plan.W, plan.S, plan.threads) == (W, S, 256)
    assert plan.blocks == -(-P // W // (256 // S))


def _check_k2(data_i, offs, nb, x, b, d, dinv, vdt, halo=None):
    """K2's three modes (K2 halo's with ``halo``, x being x_ext) against
    their plain versions, each launched twice, bitwise."""
    kw = {} if halo is None else {"tile": halo}
    sfx = "" if halo is None else "_halo"
    step, residual = (getattr(fc, f"banded_cheb_step_t{sfx}"),
                      getattr(fc, f"banded_residual_t{sfx}"))
    step_ref, residual_ref = (getattr(fc, f"banded_cheb_step_t{sfx}_ref"),
                              getattr(fc, f"banded_residual_t{sfx}_ref"))
    kb = bd.imajor_band(data_i, offs, nb)
    for dv in (None, d):
        args = (data_i, offs, nb, x, dv, b, dinv, 0.3, 0.7)
        got = step(*args, band=kb, **kw)
        again = step(*args, band=kb, **kw)
        want = step_ref(*args, **kw)
        for g, a, w in zip(got, again, want):
            assert _rel(g, w) <= TOL[vdt]
            assert torch.equal(g, a)
    got = residual(data_i, offs, nb, x, b, band=kb, **kw)
    assert _rel(got, residual_ref(data_i, offs, nb, x, b, **kw)) <= TOL[vdt]
    assert torch.equal(got, residual(data_i, offs, nb, x, b, band=kb, **kw))


@pytest.mark.cuda
def test_cuda_library_refuses_unbuilt_nb(cuda):
    """The nb the library once refused (no specialised build) run its
    runtime-nb build: at nb 5, 8, 27 and 35 and every dtype pair, K1 and
    K2's three modes against their plain versions, two launches bitwise
    equal, each launch counted under the ``_any_nb`` counters; the C plan
    entry reports the plan ``any_nb_plan`` states."""
    P = 8192
    for nb in (5, 8, 27, 35):
        for ddt, vdt in PAIRS:
            data_i, offs, x = _band(nb, P, seed=nb,
                                    dtype=getattr(torch, ddt),
                                    vdtype=getattr(torch, vdt), device=cuda)
            b, d, dinv = _cheb(nb, P, nb + 1, getattr(torch, vdt), cuda)
            _build.reset_launches()
            plan = _check(data_i, offs, nb, x, vdt)
            _check_k2(data_i, offs, nb, x, b, d, dinv, vdt)
            assert plan == bd.any_nb_plan(nb, len(offs), P, data_i.dtype,
                                          x.dtype)
            assert _build.launches["banded_matvec_imajor_any_nb"] == 2
            assert _build.launches["banded_fused_cheb_any_nb"] == 6
            assert _build.launches["banded_matvec_imajor"] == 0
            assert _build.launches["banded_fused_cheb"] == 0


@pytest.mark.cuda
def test_cuda_any_nb_plan_is_the_python_plan(cuda):
    """The library's runtime-nb plan (``pd_banded_matvec_plan``) is
    ``any_nb_plan``'s at every shape of ``ANY_NB_PLANS``."""
    for (nb, n_off, P, ldx, halo, ddt, vdt), _ in ANY_NB_PLANS:
        R_pad = -(-n_off * nb // 8) * 8
        data_i = torch.empty(nb * R_pad, P, dtype=ddt, device=cuda)
        offs = torch.zeros(n_off, dtype=torch.int32, device=cuda)
        x = torch.empty(nb, ldx or P, dtype=vdt, device=cuda)
        got = bd.k1_plan(bd.imajor_band(data_i, offs, nb), x, halo or None)
        assert got == bd.any_nb_plan(nb, n_off, P, ddt, vdt, ldx=ldx,
                                     halo=halo)
        del data_i, x


@pytest.mark.cuda
@pytest.mark.parametrize("ddt,vdt", PAIRS)
@pytest.mark.parametrize("nb,P", [(15, 4099), (21, 4096), (15, 65536),
                                  (35, 32768)])
def test_cuda_any_nb_partial_chunks(cuda, nb, P, ddt, vdt):
    """Block sizes whose last row chunk is partial (the 2D P_4 and P_5
    ones, 3D P_4's): one lane a thread (P = 4099), offset groups (4096
    lanes), 2 and (f32, 32768 lanes) 8 rows a thread; K1 and K2's three
    modes against their plain versions, bitwise over two launches."""
    offsets = (-64, -1, 0, 1, 64)
    data_i, offs, x = _band(nb, P, offsets, seed=nb,
                            dtype=getattr(torch, ddt),
                            vdtype=getattr(torch, vdt), device=cuda)
    b, d, dinv = _cheb(nb, P, nb + 2, getattr(torch, vdt), cuda)
    plan = _check(data_i, offs, nb, x, vdt)
    _check_k2(data_i, offs, nb, x, b, d, dinv, vdt)
    assert plan == bd.any_nb_plan(nb, len(offsets), P, data_i.dtype,
                                  x.dtype)
    assert -(-nb // plan.rows) * plan.rows > nb  # a partial last chunk


@pytest.mark.cuda
@pytest.mark.parametrize("vdt", ["float32", "float64"])
def test_cuda_any_nb_halo(cuda, vdt):
    """K1 halo and K2 halo at nb = 8 (TensorDGQ Q1 in 3D) on a slab of
    8192 lanes with a halo of T = 4096 lanes whose values differ from the
    interior's, against their plain versions, bitwise over two
    launches."""
    nb, per, T = 8, 8192, 4096
    offsets = (-4096, -64, -1, 0, 1, 64, 4096)
    t = getattr(torch, vdt)
    data_i, offs, _ = _band(nb, per, offsets, dtype=t, vdtype=t,
                            device=cuda)
    x_ext = torch.randn(nb, per + 2 * T, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(5)).to(cuda,
                                                                       t)
    b, d, dinv = _cheb(nb, per, 6, t, cuda)
    _build.reset_launches()
    plan = _check(data_i, offs, nb, x_ext, vdt, halo=T)
    _check_k2(data_i, offs, nb, x_ext, b, d, dinv, vdt, halo=T)
    assert plan == bd.any_nb_plan(nb, len(offsets), per, t, t,
                                  ldx=per + 2 * T, halo=T)
    assert _build.launches["banded_matvec_halo_any_nb"] == 2
    assert _build.launches["banded_fused_halo_any_nb"] == 6
    # the C entry launches at an nb the specialised builds lack
    lib = _build.load_library()
    y = torch.empty(nb, per, dtype=t, device=cuda)
    assert lib.pd_banded_matvec_halo(
        data_i.data_ptr(), _build.DTYPE_CODES[t], x_ext.data_ptr(),
        _build.DTYPE_CODES[t], offs.data_ptr(), len(offsets), nb,
        data_i.shape[0] // nb, per, per + 2 * T, T, y.data_ptr(),
        _build.stream_handle(y.device)) == 0
    assert torch.equal(y, bd.banded_matvec_t_halo(data_i, offs, nb, x_ext,
                                                  tile=T))
