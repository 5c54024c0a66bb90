"""Fused K0 (the Chebyshev step and residual on the o-major band) and the
dispatch that sends every banded level's smoothing through one fused
launch.

On the CPU the port's ``banded_cheb_step_t_omajor`` and
``banded_residual_t_omajor`` run their plain versions (K0's plain product,
then the update).  Checked here:

* the plain versions against the JAX package's K2 (``banded_cheb_step_t``,
  ``banded_residual_t``, interpret mode) on the i-major copy of the same
  band made by the JAX ``BlockBanded.with_imajor()``: P in {384, 512}, nb
  in {4, 10}, the lex 7 offsets and a set whose far offsets exceed the JAX
  kernel's lane tile; f32 and bf16 bands (f32 vectors; both packages see
  the same bf16 values) to 1e-5 relative to the largest entry (f32 sums in
  another order), f64 to 1e-12.  Band entries whose column leaves [0, P)
  are zero (the band contract: the JAX kernel rolls far offsets);
* ``Multigrid._cycle`` on CPU bands without the i-major copy smooths and
  takes residuals through the fused o-major wrappers, never through
  ``ChebyshevSmoother``'s unfused branch, and gives that branch's V-cycle;
* the checks a launch makes on the vectors, and that a band off the card
  raises rather than run a plain version.

The CUDA kernels against their plain versions (fused K0 at 64 and 4096
lanes; the redesigned K2 at a P that is not a multiple of its lane width,
at nb=10 and on a small level) need a card and skip here.  Only the JAX parity test imports jax,
so on a card without it they run as
``python -m pytest --noconftest -m cuda tests/test_torch_fused_omajor.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch import sparse as tsparse  # noqa: E402
from polydeal_tpu_torch.models.flagship import setup_flagship  # noqa: E402
from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.ops.banded import (  # noqa: E402
    launch_band,
    omajor_band,
)
from polydeal_tpu_torch.ops.fused_cheb import (  # noqa: E402
    banded_cheb_step_t as t_step,
    banded_cheb_step_t_omajor,
    banded_cheb_step_t_omajor_ref,
    banded_cheb_step_t_ref,
    banded_residual_t as t_residual,
    banded_residual_t_omajor,
    banded_residual_t_omajor_ref,
    banded_residual_t_ref,
)

CPU = torch.device("cpu")
LEX512 = (-64, -8, -1, 0, 1, 8, 64)
FAR = (-200, -17, -1, 0, 1, 17, 200)  # |200| > the JAX lane tile at P=384
# (P, nb, offsets): both offset sets with both nb
CASES = [(512, 4, LEX512), (512, 10, LEX512), (384, 4, FAR), (384, 10, FAR)]
TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
C1, C2 = 0.37, 1.21


def _band(P, nb, offsets, seed):
    """A random o-major band, zero where p + o leaves [0, P), and x, b, d,
    dinv [nb, P]."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), nb, nb, P))
    for k, o in enumerate(offsets):
        if o < 0:
            data[k, :, :, :-o] = 0
        if o > 0:
            data[k, :, :, P - o:] = 0
    vecs = [rng.standard_normal((nb, P)) for _ in range(3)]
    vecs.append(1.0 + rng.random((nb, P)))  # dinv
    return data, vecs


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def _offs_t(offsets, device=CPU):
    return torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                           device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("P,nb,offsets", CASES)
def test_fused_omajor_plain_matches_jax_kernel(P, nb, offsets, dtype):
    """step0, step and residual of the o-major plain versions against the
    JAX fused kernel on the JAX i-major copy of the same band."""
    jnp = pytest.importorskip("jax.numpy")
    from polydeal_tpu.ops.banded import pick_tile
    from polydeal_tpu.ops.fused_cheb import (banded_cheb_step_t,
                                             banded_residual_t)
    from polydeal_tpu.sparse import BlockBanded as JBand

    data, (x, b, d, dinv) = _band(P, nb, offsets, seed=P + nb)
    vdt = "float64" if dtype == "float64" else "float32"
    d_t = torch.from_numpy(data).to(getattr(torch, dtype))
    # both packages see the SAME band values (bf16 rounded once, by torch)
    jdata = jnp.asarray(d_t.double().numpy(), dtype=getattr(jnp, dtype))
    jband = JBand(jdata, np.asarray(offsets), P).with_imajor()
    if offsets == FAR:  # the JAX kernel's far-offset path is exercised
        tile = pick_tile(P, jband.data_i.shape[0],
                         jband.data_i.dtype.itemsize)
        assert max(abs(o) for o in offsets) > tile
    J = lambda a: jnp.asarray(a, dtype=getattr(jnp, vdt))
    T = lambda a: torch.from_numpy(a).to(getattr(torch, vdt))
    offs, tol = _offs_t(offsets), TOL[dtype]
    for dv in (d, None):
        rx, rd = banded_cheb_step_t(jband.data_i, offsets, nb, J(x),
                                    None if dv is None else J(dv), J(b),
                                    J(dinv), C1, C2, interpret=True)
        gx, gd = banded_cheb_step_t_omajor(d_t, offs, T(x),
                                           None if dv is None else T(dv),
                                           T(b), T(dinv), C1, C2)
        assert gx.dtype == gd.dtype == getattr(torch, vdt)
        _close(rx, gx.numpy(), tol)
        _close(rd, gd.numpy(), tol)
    rr = banded_residual_t(jband.data_i, offsets, nb, J(x), J(b),
                           interpret=True)
    _close(rr, banded_residual_t_omajor(d_t, offs, T(x), T(b)).numpy(), tol)


def test_cycle_smooths_through_fused_k0(monkeypatch):
    """n=8 flagship levels 64 and 512 (no i-major copy): every smoothing
    step and residual of a V-cycle goes through the fused o-major wrappers
    (degree 5, one sweep: 4 + 5 steps and 1 residual per level) and none
    through a plain product; the result is the unfused branch's."""
    fs = setup_flagship(n=8, device=CPU, dtype=torch.float64,
                        precond_dtype=None)
    mg = fs.mg
    assert all(e.data_i is None for e in mg.ells)
    assert all(mg._fused_ok(e, fs.b) for e in mg.ells[1:])
    calls = {"step0": 0, "step": 0, "residual": 0, "product": 0}

    def step(data, offsets, xt, dvec, b, dinv, c1, c2, band):
        calls["step0" if dvec is None else "step"] += 1
        return banded_cheb_step_t_omajor(data, offsets, xt, dvec, b, dinv,
                                         c1, c2, band=band)

    def residual(data, offsets, xt, b, band):
        calls["residual"] += 1
        return banded_residual_t_omajor(data, offsets, xt, b, band=band)

    plain_product = tsparse.banded_matvec_t_omajor

    def product(*args, **kw):
        calls["product"] += 1
        return plain_product(*args, **kw)

    monkeypatch.setattr(tsparse, "banded_cheb_step_t_omajor", step)
    monkeypatch.setattr(tsparse, "banded_residual_t_omajor", residual)
    monkeypatch.setattr(tsparse, "banded_matvec_t_omajor", product)
    fused = mg.v_cycle(fs.b)
    assert (mg.chebyshev_degree, mg.n_smooth) == (5, 1)
    # per level: the pre-smoother starts from zero (no launch), then 4
    # steps; the post-smoother 1 first step and 4 steps; 1 residual
    levels = mg.n_levels - 1
    assert calls == {"step0": levels, "step": 8 * levels,
                     "residual": levels, "product": 0}
    # the unfused branch: one product and the update in elementwise ops
    monkeypatch.setattr(tsparse.BlockBanded, "fused_cheb_ok",
                        lambda self: False)
    unfused = mg.v_cycle(fs.b)
    assert calls["product"] > 0
    assert float((fused - unfused).abs().max()) <= 1e-14 * float(
        unfused.abs().max())


def test_fused_launch_checks():
    """What a fused launch checks per call on its vectors (the band was
    checked once, by ``omajor_band``), and that a band off the card raises
    instead of running the plain version."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((7, 4, 4, 256)))
    x, b, d, dinv = (torch.from_numpy(rng.standard_normal((4, 256)))
                     for _ in range(4))
    band = omajor_band(data, _offs_t(LEX512))
    assert (band.n_off, band.nb, band.P) == (7, 4, 256)
    assert band.vec_code((x, b, d, dinv)) == _build.DTYPE_CODES[torch.float64]
    with pytest.raises(ValueError):  # b of another shape
        band.vec_code((x, b[:, :128].contiguous(), d, dinv))
    with pytest.raises(ValueError):  # non-contiguous dinv
        band.vec_code((x, b, d, dinv.T.contiguous().T))
    with pytest.raises(ValueError):  # vectors of two dtypes
        band.vec_code((x, b.float(), d, dinv))
    with pytest.raises(TypeError):  # f64 band, f32 vectors
        band.vec_code((x.float(), b.float()))
    with pytest.raises(RuntimeError):  # no kernel for a CPU band
        launch_band(band, True, (x, b), ())
    with pytest.raises(ValueError):  # offsets do not match the band
        omajor_band(data, _offs_t(LEX512[:5]))


def _cuda_case(P, nb, offsets, dtype, seed):
    dev = torch.device("cuda")
    data, vecs = _band(P, nb, offsets, seed)
    vdt = torch.float64 if dtype == "float64" else torch.float32
    d_t = torch.from_numpy(data).to(dev, getattr(torch, dtype))
    return d_t, [torch.from_numpy(v).to(dev, vdt) for v in vecs], \
        _offs_t(offsets, dev)


def _check_modes(kernel, plain, tol):
    """Compare (step, step0, residual) of a kernel wrapper triple with its
    plain versions on the card."""
    C = lambda t: t.cpu().numpy()
    for (kf, pf) in zip(kernel, plain):
        got, ref = kf(), pf()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            _close(C(r), C(g), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_fused_k0_matches_plain(dtype):
    """Fused K0, all three modes, against its plain version at 64 lanes
    (one partly filled block) and at 4096 lanes with far offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: fused K0 has no CPU mode")
    for P, nb, offsets in [(64, 4, (-16, -4, -1, 0, 1, 4, 16)),
                           (4096, 4, FAR), (4096, 10, (-256, -16, -1, 0, 1,
                                                       16, 256))]:
        data, (x, b, d, dinv), offs = _cuda_case(P, nb, offsets, dtype, 9)
        _check_modes(
            [lambda: banded_cheb_step_t_omajor(data, offs, x, d, b, dinv, C1,
                                               C2),
             lambda: banded_cheb_step_t_omajor(data, offs, x, None, b, dinv,
                                               C1, C2),
             lambda: banded_residual_t_omajor(data, offs, x, b)],
            [lambda: banded_cheb_step_t_omajor_ref(data, offs, x, d, b, dinv,
                                                   C1, C2),
             lambda: banded_cheb_step_t_omajor_ref(data, offs, x, None, b,
                                                   dinv, C1, C2),
             lambda: banded_residual_t_omajor_ref(data, offs, x, b)],
            TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_k2_wide_and_tail_match_plain(dtype):
    """The redesigned K2, all three modes, against its plain version: P
    not a multiple of its lane width (one lane per thread), nb=10 on the
    wide path, and a level too small for the wide path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 has no CPU mode")
    for P, nb in [(131075, 4), (131072, 10), (4100, 4)]:
        data, (x, b, d, dinv), offs = _cuda_case(P, nb, FAR, dtype, 11)
        di = tsparse.BlockBanded(data, np.asarray(FAR), P).with_imajor(
            drop_omajor=True).data_i
        del data
        _check_modes(
            [lambda: t_step(di, offs, nb, x, d, b, dinv, C1, C2),
             lambda: t_step(di, offs, nb, x, None, b, dinv, C1, C2),
             lambda: t_residual(di, offs, nb, x, b)],
            [lambda: banded_cheb_step_t_ref(di, offs, nb, x, d, b, dinv, C1,
                                            C2),
             lambda: banded_cheb_step_t_ref(di, offs, nb, x, None, b, dinv,
                                            C1, C2),
             lambda: banded_residual_t_ref(di, offs, nb, x, b)],
            TOL[dtype])
