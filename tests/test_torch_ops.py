"""K1 (banded SpMV) and K2 (fused Chebyshev step / residual) of the port.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's Pallas kernels in interpret mode (f32 and
bf16 bands, rtol 1e-5 against the largest output entry: f32 sums in
another order) and, at f64, against the JAX roll+einsum SpMV
(``BlockBanded.matvec_t``) to 1e-12 (JAX's i-major kernel returns f32 even
for f64 input).  The test of the CUDA kernels against the plain versions
needs a card and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polydeal_tpu.ops.banded import banded_matvec_t_imajor  # noqa: E402
from polydeal_tpu.ops.fused_cheb import (  # noqa: E402
    banded_cheb_step_t,
    banded_residual_t,
)
from polydeal_tpu.sparse import BlockBanded  # noqa: E402
from polydeal_tpu_torch.ops import (  # noqa: E402
    banded_cheb_step_t as t_step,
    banded_cheb_step_t_ref,
    banded_matvec_t_imajor as t_matvec,
    banded_matvec_t_imajor_ref,
    banded_residual_t as t_residual,
    banded_residual_t_ref,
)
from polydeal_tpu_torch.ops.banded import check_kernel_args  # noqa: E402

# |o| > 128 exceeds the JAX kernel's lane tile (its far-offset path)
OFFSETS = np.array([-200, -17, -1, 0, 1, 17, 200])


def _band(nb, P, seed=0):
    """A random band in both layouts, zero where p + o leaves [0, P) (the
    band contract), with R_pad > n_off * nb (padding rows hold junk that
    must never be read)."""
    rng = np.random.default_rng(seed)
    n_off = len(OFFSETS)
    data = rng.standard_normal((n_off, nb, nb, P))
    for k, o in enumerate(OFFSETS):
        if o < 0:
            data[k, :, :, :-o] = 0
        if o > 0:
            data[k, :, :, P - o:] = 0
    R = n_off * nb
    R_pad = -(-R // 8) * 8
    assert R_pad > R
    di = np.transpose(data, (1, 0, 2, 3)).reshape(nb, R, P)
    junk = rng.standard_normal((nb, R_pad - R, P))
    data_i = np.concatenate([di, junk], axis=1).reshape(nb * R_pad, P)
    vecs = [rng.standard_normal((nb, P)) for _ in range(3)]
    vecs.append(1.0 + rng.random((nb, P)))  # dinv
    return data, data_i, vecs


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


SHAPES = [(4, 256), (4, 384), (10, 256), (10, 384)]
OFFS_T = torch.as_tensor(OFFSETS, dtype=torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb,P", SHAPES)
def test_k1_plain_matches_jax_kernel(nb, P, dtype):
    _, data_i, (x, _, _, _) = _band(nb, P)
    # bf16: both packages see the SAME bf16 values (rounded once, by torch)
    di_t = torch.from_numpy(data_i).to(getattr(torch, dtype))
    di_j = jnp.asarray(di_t.float().numpy(), dtype=getattr(jnp, dtype))
    xj = jnp.asarray(x, dtype=jnp.float32)
    ref = banded_matvec_t_imajor(di_j, OFFSETS, nb, xj, interpret=True)
    got = t_matvec(di_t, OFFS_T, nb, torch.from_numpy(x).float())
    assert got.dtype == torch.float32
    _close(ref, got.numpy(), 1e-5)


@pytest.mark.parametrize("nb,P", SHAPES)
def test_k1_plain_matches_jax_f64(nb, P):
    data, data_i, (x, _, _, _) = _band(nb, P)
    ref = BlockBanded(jnp.asarray(data), OFFSETS, P).matvec_t(jnp.asarray(x))
    got = t_matvec(torch.from_numpy(data_i), OFFS_T, nb, torch.from_numpy(x))
    assert got.dtype == torch.float64
    _close(ref, got.numpy(), 1e-12)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("nb,P", SHAPES)
def test_k2_plain_matches_jax_kernel(nb, P, dtype, tol):
    """All three modes (step0, step, residual) against the JAX fused kernel
    in interpret mode (which accumulates in f64 for f64 vectors)."""
    _, data_i, (x, b, d, dinv) = _band(nb, P, seed=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, dtype=jdt)
    T = lambda a: torch.from_numpy(a).to(tdt)
    c1, c2 = 0.37, 1.21
    for dv in (d, None):
        rx, rd = banded_cheb_step_t(J(data_i), OFFSETS, nb, J(x),
                                    None if dv is None else J(dv), J(b),
                                    J(dinv), c1, c2, interpret=True)
        gx, gd = t_step(T(data_i), OFFS_T, nb, T(x),
                        None if dv is None else T(dv), T(b), T(dinv), c1, c2)
        _close(rx, gx.numpy(), tol)
        _close(rd, gd.numpy(), tol)
    rr = banded_residual_t(J(data_i), OFFSETS, nb, J(x), J(b),
                           interpret=True)
    _close(rr, t_residual(T(data_i), OFFS_T, nb, T(x), T(b)).numpy(), tol)


def test_kernel_arg_checks():
    """What the CUDA wrappers reject before any launch."""
    _, data_i, (x, _, _, _) = _band(4, 256)
    di, xt = torch.from_numpy(data_i), torch.from_numpy(x)
    n_off, R_pad, P = check_kernel_args(di, OFFS_T, 4, (xt,))
    assert (n_off, R_pad, P) == (7, 32, 256)
    with pytest.raises(TypeError):  # offsets must be int32
        check_kernel_args(di, OFFS_T.long(), 4, (xt,))
    with pytest.raises(ValueError):  # non-contiguous vector
        check_kernel_args(di, OFFS_T, 4, (xt.T.contiguous().T,))
    with pytest.raises(TypeError):  # f64 band, f32 vectors
        check_kernel_args(di, OFFS_T, 4, (xt.float(),))
    with pytest.raises(ValueError):  # R_pad < n_off * nb
        check_kernel_args(di[: 4 * 20], OFFS_T, 4, (xt,))
    with pytest.raises(ValueError):  # wrong vector shape
        check_kernel_args(di, OFFS_T, 4, (xt[:, :128].contiguous(),))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_kernels_match_plain(dtype):
    """K1 and K2 on the card against their plain versions (1e-5 relative
    for f32/bf16 bands, 1e-12 for f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1/K2 have no CPU mode")
    dev = torch.device("cuda")
    nb, P = 4, 4096
    _, data_i, (x, b, d, dinv) = _band(nb, P, seed=5)
    vdt = torch.float64 if dtype == "float64" else torch.float32
    tol = 1e-12 if dtype == "float64" else 1e-5
    di = torch.from_numpy(data_i).to(dev, getattr(torch, dtype))
    x, b, d, dinv = (torch.from_numpy(a).to(dev, vdt) for a in (x, b, d,
                                                                dinv))
    offs = OFFS_T.to(dev)
    C = lambda t: t.cpu().numpy()
    _close(C(banded_matvec_t_imajor_ref(di, offs, nb, x)),
           C(t_matvec(di, offs, nb, x)), tol)
    for dv in (d, None):
        for r, g in zip(banded_cheb_step_t_ref(di, offs, nb, x, dv, b, dinv,
                                               0.37, 1.21),
                        t_step(di, offs, nb, x, dv, b, dinv, 0.37, 1.21)):
            _close(C(r), C(g), tol)
    _close(C(banded_residual_t_ref(di, offs, nb, x, b)),
           C(t_residual(di, offs, nb, x, b)), tol)
