"""The halo kernels' plain versions against the JAX package's halo entry
points, and the wrappers' checks.

K1, K2, K6 and K7 halo compute on one shard's lane slab: x comes in as
``x_ext`` [nb, per + 2T] whose T lanes on each side belong to the
neighbouring shards.  Checked here on the CPU, at per=256, T=128, with
asymmetric offsets that reach the halo's ends and a halo whose values
differ from the interior's:

* K1 halo's plain version against ``banded_matvec_t_halo`` in interpret
  mode (f32: that JAX kernel computes in f32 only; at f64 the product is
  held to K2 halo's residual mode with b = 0, which keeps f64);
* K2 halo's step0, step and residual against ``banded_cheb_step_t_halo``
  and ``banded_residual_t_halo``, f32 and f64;
* K6 halo's and K7 halo's against ``packed_matvec_t_halo``,
  ``packed_cheb_step_t_halo`` and ``packed_residual_t_halo`` on the 2D
  leaf-rank pack split at near_limit=32, whose far block-COO tail the
  caller folds into b (b_eff = b - A_far x); and that this fold makes the
  slab step equal to the whole pack's step;
* the wrappers' refusals (a wrong x_ext width, an offset beyond T) and
  their dispatch to the plain versions on a CPU tensor.

Tolerances: f32 1e-5 and f64 1e-12, relative to the largest output entry
(sums in another order).  The CUDA kernels against their plain versions
need a card and skip here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.ops.banded import banded_matvec_t_halo  # noqa: E402
from polydeal_tpu.ops.fused_cheb import (  # noqa: E402
    banded_cheb_step_t_halo,
    banded_residual_t_halo,
    packed_cheb_step_t_halo,
    packed_residual_t_halo,
)
from polydeal_tpu.ops.packed import (  # noqa: E402
    build_pack_plan,
    packed_matvec_t_halo,
)
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.ops import banded as tbd  # noqa: E402
from polydeal_tpu_torch.ops import fused_cheb as tfc  # noqa: E402
from polydeal_tpu_torch.ops import packed as tpk  # noqa: E402

PER, T = 256, 128
NB = 4
# asymmetric, reaching both ends of the halo
OFFSETS = np.array([-128, -37, -1, 0, 3, 64, 101, 128])
TOL = {"float32": 1e-5, "float64": 1e-12}
C1, C2 = 0.37, 1.21


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def _vecs(nb, seed):
    """x_ext (halo lanes drawn around 5, the interior around 0), b, d and
    dinv."""
    rng = np.random.default_rng(seed)
    x_ext = rng.standard_normal((nb, PER + 2 * T))
    x_ext[:, :T] += 5.0
    x_ext[:, -T:] -= 5.0
    b, d = (rng.standard_normal((nb, PER)) for _ in range(2))
    return x_ext, b, d, 1.0 + rng.random((nb, PER))


def _band():
    """A random i-major slab [nb * R_pad, per] (R_pad padded to 8 as the
    JAX package pads it, padding rows zero)."""
    n_off = len(OFFSETS)
    R_pad = -(-n_off * NB // 8) * 8
    rng = np.random.default_rng(0)
    d = rng.standard_normal((NB, R_pad, PER))
    d[:, n_off * NB:] = 0.0
    return d.reshape(NB * R_pad, PER)


@pytest.fixture(scope="module")
def pack():
    """The 2D n=16 leaf-rank band packed with near_limit=32: the plan's
    offsets fit the halo, the rest (|o| up to 86) is a far block-COO
    tail."""
    mesh = pd.hyper_cube(2, 16)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    ah = pd.AgglomerationHandler(mesh, agg.extract_agglomerates(
        agg.n_levels - 1), degree=1)
    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    A = assemble_sipg_banded_direct(
        ah, build_banded_groups(ah, offs, jnp.float64), offsets=offs,
        use_pallas=False)
    plan, oid, frows, fcols = build_pack_plan(
        ft.poly_in[interior], ft.poly_out[interior], ah.n_poly, ah.n_basis,
        offsets=offs, near_limit=32)
    assert ah.n_poly == PER and max(abs(o) for o in offs) > 32
    assert max(abs(o) for o in plan.offsets) <= 32 and frows.size > 0
    Ap = A.to_packed(plan, jnp.asarray(oid), frows, fcols)
    tp = interop.packed_from_arrays(
        Ap.data_i, Ap.oid, plan.offsets, plan.slots, plan.nb,
        np.asarray(Ap.far_data), frows, fcols, device=torch.device("cpu"))
    return dict(plan=plan, Ap=Ap, tp=tp)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_halo_plain_matches_jax(dtype):
    data = _band()
    x_ext = _vecs(NB, 1)[0]
    tdt = getattr(torch, dtype)
    offs_t = torch.as_tensor(OFFSETS, dtype=torch.int32)
    got = tbd.banded_matvec_t_halo_ref(torch.from_numpy(data).to(tdt), offs_t,
                                       NB, torch.from_numpy(x_ext).to(tdt),
                                       tile=T)
    assert got.dtype == tdt and got.shape == (NB, PER)
    jdt = getattr(jnp, dtype)
    if dtype == "float32":
        ref = banded_matvec_t_halo(jnp.asarray(data, jdt), OFFSETS, NB,
                                   jnp.asarray(x_ext, jdt), tile=T,
                                   interpret=True)
    else:  # y = -(0 - A x) through the f64 fused kernel
        ref = -banded_residual_t_halo(
            jnp.asarray(data), OFFSETS, NB, jnp.asarray(x_ext),
            jnp.zeros((NB, PER)), tile=T, interpret=True)
    _close(ref, got.numpy(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k2_halo_plain_matches_jax(dtype):
    """step (with d), step0 (d = None) and the residual."""
    data = _band()
    x_ext, b, d, dinv = _vecs(NB, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, dtype=jdt)
    Tt = lambda a: torch.from_numpy(a).to(tdt)
    offs_t = torch.as_tensor(OFFSETS, dtype=torch.int32)
    for dv in (d, None):
        rx, rd = banded_cheb_step_t_halo(
            J(data), OFFSETS, NB, J(x_ext), None if dv is None else J(dv),
            J(b), J(dinv), C1, C2, tile=T, interpret=True)
        gx, gd = tfc.banded_cheb_step_t_halo_ref(
            Tt(data), offs_t, NB, Tt(x_ext), None if dv is None else Tt(dv),
            Tt(b), Tt(dinv), C1, C2, tile=T)
        assert gx.dtype == gd.dtype == tdt
        _close(rx, gx.numpy(), TOL[dtype])
        _close(rd, gd.numpy(), TOL[dtype])
    rr = banded_residual_t_halo(J(data), OFFSETS, NB, J(x_ext), J(b),
                                tile=T, interpret=True)
    gr = tfc.banded_residual_t_halo_ref(Tt(data), offs_t, NB, Tt(x_ext),
                                        Tt(b), tile=T)
    _close(rr, gr.numpy(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k6_k7_halo_plain_match_jax(pack, dtype):
    """K6 halo, then K7 halo's step, step0 and residual with b_eff = b -
    A_far x, against the JAX package's on the same pack."""
    plan, Ap, tp = pack["plan"], pack["Ap"], pack["tp"]
    nb = plan.nb
    x_ext, b, d, dinv = _vecs(nb, 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, dtype=jdt)
    Tt = lambda a: torch.from_numpy(np.asarray(a)).to(tdt)
    dj, dt = Ap.data_i.astype(jdt), tp.data_i.to(tdt)
    args = (tp.oid, tp.offsets_t, nb)
    ry = packed_matvec_t_halo(dj, Ap.oid, plan, J(x_ext), tile=T,
                              interpret=True)
    gy = tpk.packed_matvec_t_halo_ref(dt, *args, Tt(x_ext), tile=T)
    assert gy.dtype == tdt
    _close(ry, gy.numpy(), TOL[dtype])
    b_eff = Tt(b) - tp.far_matvec_t(Tt(x_ext)[:, T:T + PER].contiguous())
    for dv in (d, None):
        rx, rd = packed_cheb_step_t_halo(
            dj, Ap.oid, plan, J(x_ext), None if dv is None else J(dv),
            J(b_eff.numpy()), J(dinv), C1, C2, tile=T, interpret=True)
        gx, gd = tfc.packed_cheb_step_t_halo_ref(
            dt, *args, Tt(x_ext), None if dv is None else Tt(dv), b_eff,
            Tt(dinv), C1, C2, tile=T)
        _close(rx, gx.numpy(), TOL[dtype])
        _close(rd, gd.numpy(), TOL[dtype])
    rr = packed_residual_t_halo(dj, Ap.oid, plan, J(x_ext), J(b), tile=T,
                                interpret=True)
    gr = tfc.packed_residual_t_halo_ref(dt, *args, Tt(x_ext), Tt(b), tile=T)
    _close(rr, gr.numpy(), TOL[dtype])


def test_k7_halo_with_b_eff_is_the_whole_step(pack):
    """At one shard the ring halo wraps onto the slab's own ends; the pack
    stores zero blocks where a column leaves [0, P), so K7 halo with b_eff
    = b - A_far x equals the whole pack's unfused step (near + far), and
    its residual minus A_far x the whole residual."""
    tp = pack["tp"]
    nb = tp.n_basis
    _, b, d, dinv = (torch.from_numpy(a) for a in _vecs(nb, 4))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((nb, PER)))
    x_ext = torch.cat([x[:, -T:], x, x[:, :T]], dim=1)
    args = (tp.data_i, tp.oid, tp.offsets_t, nb)
    far = tp.far_matvec_t(x)
    gx, gd = tfc.packed_cheb_step_t_halo(*args, x_ext, d, b - far, dinv, C1,
                                         C2, tile=T)
    dn = C1 * d + C2 * (dinv * (b - tp.matvec_t(x)))
    _close((x + dn).numpy(), gx.numpy(), 1e-12)
    _close(dn.numpy(), gd.numpy(), 1e-12)
    r = tfc.packed_residual_t_halo(*args, x_ext, b, tile=T) - far
    _close((b - tp.matvec_t(x)).numpy(), r.numpy(), 1e-12)


def test_bf16_band_halo_matches_f32_of_rounded_band():
    """The smoother's bf16 slab with f32 vectors: the same as the f32
    product of the bf16-rounded slab."""
    data = torch.from_numpy(_band()).to(torch.bfloat16)
    x_ext, b, d, dinv = (torch.from_numpy(a).float() for a in _vecs(NB, 6))
    offs_t = torch.as_tensor(OFFSETS, dtype=torch.int32)
    y = tbd.banded_matvec_t_halo(data, offs_t, NB, x_ext, tile=T)
    assert y.dtype == torch.float32
    ref = tbd.banded_matvec_t_halo_ref(data.float(), offs_t, NB, x_ext,
                                       tile=T)
    assert torch.equal(y, ref)
    gx, _ = tfc.banded_cheb_step_t_halo(data, offs_t, NB, x_ext, d, b, dinv,
                                        C1, C2, tile=T)
    rx, _ = tfc.banded_cheb_step_t_halo_ref(data.float(), offs_t, NB, x_ext,
                                            d, b, dinv, C1, C2, tile=T)
    assert torch.equal(gx, rx)


def test_halo_wrappers_refuse_and_dispatch(pack):
    """A wrong x_ext width and an offset beyond T raise, in every wrapper
    and plain version; on CPU tensors the wrappers run the plain versions
    (bit for bit) and launch nothing."""
    tp = pack["tp"]
    nb = tp.n_basis
    data = torch.from_numpy(_band())
    offs_t = torch.as_tensor(OFFSETS, dtype=torch.int32)
    x_ext, b, d, dinv = (torch.from_numpy(a) for a in _vecs(NB, 7))
    xp, bp, dp, ip = (torch.from_numpy(a) for a in _vecs(nb, 8))
    banded = {
        "k1": lambda f, x, t: f(data, offs_t, NB, x, tile=t),
        "k2": lambda f, x, t: f(data, offs_t, NB, x, d, b, dinv, C1, C2,
                                tile=t),
        "k2r": lambda f, x, t: f(data, offs_t, NB, x, b, tile=t),
    }
    packed = {
        "k6": lambda f, x, t: f(tp.data_i, tp.oid, tp.offsets_t, nb, x,
                                tile=t),
        "k7": lambda f, x, t: f(tp.data_i, tp.oid, tp.offsets_t, nb, x, dp,
                                bp, ip, C1, C2, tile=t),
        "k7r": lambda f, x, t: f(tp.data_i, tp.oid, tp.offsets_t, nb, x, bp,
                                 tile=t),
    }
    fns = {
        "k1": (tbd.banded_matvec_t_halo, tbd.banded_matvec_t_halo_ref),
        "k2": (tfc.banded_cheb_step_t_halo, tfc.banded_cheb_step_t_halo_ref),
        "k2r": (tfc.banded_residual_t_halo,
                tfc.banded_residual_t_halo_ref),
        "k6": (tpk.packed_matvec_t_halo, tpk.packed_matvec_t_halo_ref),
        "k7": (tfc.packed_cheb_step_t_halo, tfc.packed_cheb_step_t_halo_ref),
        "k7r": (tfc.packed_residual_t_halo,
                tfc.packed_residual_t_halo_ref),
    }
    before = dict(_build.launches)
    for name, call in {**banded, **packed}.items():
        x = x_ext if name in banded else xp
        for f in fns[name]:
            with pytest.raises(ValueError, match="x_ext"):
                call(f, x[:, 1:], T)  # one lane short
            # a halo narrower than the largest offset (128 banded, 32
            # packed), x_ext cut to its width
            t = T - 1 if name in banded else 16
            with pytest.raises(ValueError, match="beyond the halo"):
                call(f, x[:, T - t:x.shape[1] - (T - t)], t)
        got, ref = call(fns[name][0], x, T), call(fns[name][1], x, T)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)
    assert _build.launches == before


def _cuda_cases(pack):
    """(dtype, wrapper, plain version, args) of every halo kernel mode on
    the card, f32 and f64."""
    dev = torch.device("cuda")
    tp = pack["tp"]
    nb = tp.n_basis
    out = []
    for dtype in ("float32", "float64"):
        tdt = getattr(torch, dtype)
        data = torch.from_numpy(_band()).to(dev, tdt)
        offs = torch.as_tensor(OFFSETS, dtype=torch.int32, device=dev)
        x_ext, b, d, dinv = (torch.from_numpy(a).to(dev, tdt)
                             for a in _vecs(NB, 9))
        band = (data, offs, NB)
        out += [
            (dtype, tbd.banded_matvec_t_halo, tbd.banded_matvec_t_halo_ref,
             (*band, x_ext)),
            (dtype, tfc.banded_residual_t_halo,
             tfc.banded_residual_t_halo_ref, (*band, x_ext, b)),
        ] + [(dtype, tfc.banded_cheb_step_t_halo,
              tfc.banded_cheb_step_t_halo_ref,
              (*band, x_ext, dv, b, dinv, C1, C2)) for dv in (d, None)]
        pk = (tp.data_i.to(dev, tdt), tp.oid.to(dev), tp.offsets_t.to(dev),
              nb)
        x_ext, b, d, dinv = (torch.from_numpy(a).to(dev, tdt)
                             for a in _vecs(nb, 10))
        out += [
            (dtype, tpk.packed_matvec_t_halo, tpk.packed_matvec_t_halo_ref,
             (*pk, x_ext)),
            (dtype, tfc.packed_residual_t_halo,
             tfc.packed_residual_t_halo_ref, (*pk, x_ext, b)),
        ] + [(dtype, tfc.packed_cheb_step_t_halo,
              tfc.packed_cheb_step_t_halo_ref,
              (*pk, x_ext, dv, b, dinv, C1, C2)) for dv in (d, None)]
    return out


@pytest.mark.cuda
def test_cuda_halo_kernels_match_plain(pack):
    """K1, K2, K6 and K7 halo (every mode) on the card against their plain
    versions (1e-5 relative in f32, 1e-12 in f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the halo kernels have no CPU mode")
    for dtype, fn, ref, a in _cuda_cases(pack):
        got, want = fn(*a, tile=T), ref(*a, tile=T)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            _close(r.cpu().numpy(), g.cpu().numpy(), TOL[dtype])
