"""K0, the o-major banded SpMV of the port, against the JAX package.

On the CPU the port's wrapper ``banded_matvec_t_omajor`` runs its plain
PyTorch version.  Checked here:

* the plain version against the JAX Pallas kernel ``banded_matvec_t_pallas``
  in interpret mode (which needs P % 128 == 0): P in {512, 4096}, nb in
  {4, 10}, the lex 7 offsets, the two offset sets of ``test_ops.py`` and a
  19-offset set reaching 220 lanes; f32 and bf16 bands (both packages see
  the same bf16 values), 1e-5 relative to the largest output entry (f32
  sums in another order).  The bands are random everywhere, so the zero
  halo outside [0, P) is checked as well;
* at f64, on real assembled levels (64 and 512 lanes, lex and leaf-rank
  numbering), against the JAX package's roll+einsum path
  (``BlockBanded.matvec_t`` without ``data_i``) to 1e-13, and against the
  port's former roll+einsum product to 1e-14;
* ``BlockBanded.matvec_t`` on a CPU band without ``data_i`` reaches the K0
  wrapper with the o-major band as it is and a contiguous x;
* the argument checks the CUDA wrapper makes before a launch.

The CUDA kernel against its plain version needs a card and skips here.
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
from polydeal_tpu.ops.banded import banded_matvec_t_pallas  # noqa: E402
from polydeal_tpu.solvers import build_rtree_hierarchy  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch import sparse as tsparse  # noqa: E402
from polydeal_tpu_torch.ops.banded import (  # noqa: E402
    banded_matvec_t_omajor,
    banded_matvec_t_omajor_ref,
    check_omajor_args,
)

CPU = torch.device("cpu")


def _lex7(P):
    m = round(P ** (1 / 3))
    return (-m * m, -m, -1, 0, 1, m, m * m)


FAR19 = (-220, -100, -56, -40, -12, -7, -3, -2, -1, 0, 1, 2, 3, 7, 12, 40,
         56, 100, 220)
# (P, nb, offsets): every P with both nb, every offset set at least once
CASES = [
    (512, 4, _lex7(512)),
    (512, 10, (-32, -1, 0, 1, 32)),
    (512, 10, FAR19),
    (4096, 4, (-40, -7, -1, 0, 1, 7, 40)),
    (4096, 4, FAR19),
    (4096, 10, _lex7(4096)),
]


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def _offs_t(offsets):
    return torch.as_tensor(np.asarray(offsets), dtype=torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,nb,offsets", CASES)
def test_k0_plain_matches_jax_kernel(P, nb, offsets, dtype):
    rng = np.random.default_rng(P + nb + len(offsets))
    data = rng.standard_normal((len(offsets), nb, nb, P))
    x = rng.standard_normal((nb, P)).astype(np.float32)
    d_t = torch.from_numpy(data).to(getattr(torch, dtype))
    d_j = jnp.asarray(d_t.float().numpy(), dtype=getattr(jnp, dtype))
    ref = banded_matvec_t_pallas(d_j, np.asarray(offsets), jnp.asarray(x),
                                 interpret=True)
    got = banded_matvec_t_omajor(d_t, _offs_t(offsets), torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(ref, got.numpy(), 1e-5)


@pytest.fixture(scope="module", params=["lex", None])
def real_levels(request):
    """The JAX package's f64 SIPG bands of the R-tree levels of
    hyper_cube(3, 8) (64 and 512 lanes), numbered lex or by leaf rank."""
    mesh = pd.hyper_cube(3, 8)
    agg = RTreeAgglomerator.build(mesh.cell_centers())
    handlers, _ = build_rtree_hierarchy(
        mesh, agg, list(range(1, agg.n_levels - 1)), degree=1,
        relabel=request.param)
    out = []
    for h in handlers[1:]:
        ft = h.faces
        interior = ~ft.is_boundary
        diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
        offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
        A = assemble_sipg_banded_direct(
            h, build_banded_groups(h, offs, jnp.float64), offsets=offs,
            use_pallas=False)
        out.append(A)
    assert [A.n_block_rows for A in out] == [64, 512]
    return out


def _former_roll(band, xt):
    """The port's product before K0: one roll and one einsum per offset."""
    y = torch.zeros_like(xt)
    for k, o in enumerate(band.offsets):
        xs = torch.roll(xt, -int(o), dims=1) if o != 0 else xt
        y = y + torch.einsum("ijp,jp->ip", band.data[k].to(xt.dtype), xs)
    return y


def test_k0_plain_matches_jax_roll_f64(real_levels):
    rng = np.random.default_rng(7)
    for A in real_levels:
        nb, P = A.n_basis, A.n_block_rows
        band = interop.banded_from_arrays(np.asarray(A.data), A.offsets, P,
                                          device=CPU)
        assert band.data_i is None
        x = rng.standard_normal((nb, P))
        ref = np.asarray(A.matvec_t(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        got = band.matvec_t(xt)
        assert got.dtype == torch.float64
        _close(ref, got.numpy(), 1e-13)
        # the real band stores zero blocks wherever p + o leaves [0, P), so
        # the zero halo and the former roll agree
        _close(_former_roll(band, xt).numpy(), got.numpy(), 1e-14)


def test_matvec_t_dispatches_to_k0(monkeypatch):
    """A CPU band without the i-major copy multiplies through the K0
    wrapper, with its o-major band as it is (bf16 stays bf16), a
    contiguous x and no kernel arguments (a CPU band launches nothing); a
    band with the copy does not."""
    calls = []

    def spy(data, offsets, xt, band):
        assert band is None
        calls.append((data, offsets, xt))
        return banded_matvec_t_omajor(data, offsets, xt, band=band)

    monkeypatch.setattr(tsparse, "banded_matvec_t_omajor", spy)
    rng = np.random.default_rng(3)
    nb, P, offs = 4, 64, np.array([-16, -4, -1, 0, 1, 4, 16])
    data = torch.from_numpy(rng.standard_normal((7, nb, nb, P))).to(
        torch.bfloat16)
    band = tsparse.BlockBanded(data, offs, P)
    x = torch.from_numpy(rng.standard_normal(nb * P)).float()
    y = band.matvec(x)  # hands matvec_t the transposed view of x
    assert len(calls) == 1
    d, o, xt = calls[0]
    assert d is band.data and d.dtype == torch.bfloat16
    assert o is band.offsets_t and o.dtype == torch.int32
    assert xt.is_contiguous() and xt.dtype == torch.float32
    want = banded_matvec_t_omajor_ref(data, band.offsets_t,
                                      x.reshape(P, nb).T.contiguous())
    assert torch.equal(y, want.T.reshape(-1))
    band.with_imajor().matvec(x)
    assert len(calls) == 1


def test_k0_arg_checks():
    """What the CUDA wrapper rejects before any launch."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((7, 4, 4, 256)))
    xt = torch.from_numpy(rng.standard_normal((4, 256)))
    offs = _offs_t(_lex7(512))
    assert check_omajor_args(data, offs, xt) == (7, 4, 256)
    with pytest.raises(ValueError):  # not [n_off, nb, nb, P]
        check_omajor_args(data[:, :, :3], offs, xt)
    with pytest.raises(ValueError):  # non-contiguous band
        check_omajor_args(data.transpose(1, 2), offs, xt)
    with pytest.raises(TypeError):  # offsets must be int32
        check_omajor_args(data, offs.long(), xt)
    with pytest.raises(ValueError):  # one offset per band row
        check_omajor_args(data, offs[:5], xt)
    with pytest.raises(TypeError):  # f64 band, f32 vector
        check_omajor_args(data, offs, xt.float())
    with pytest.raises(ValueError):  # wrong vector shape
        check_omajor_args(data, offs, xt[:, :128].contiguous())
    n = 48 * 1024 // 4 + 1  # one offset more than shared memory holds
    with pytest.raises(ValueError):
        check_omajor_args(torch.zeros((n, 1, 1, 1)),
                          torch.zeros(n, dtype=torch.int32),
                          torch.zeros((1, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_k0_matches_plain(dtype):
    """K0 on the card against its plain version (1e-5 relative for f32 and
    bf16 bands, 1e-12 for f64), at 64 lanes (one partly filled block) and
    at 4096 lanes with far offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K0 has no CPU mode")
    dev = torch.device("cuda")
    vdt = torch.float64 if dtype == "float64" else torch.float32
    tol = 1e-12 if dtype == "float64" else 1e-5
    rng = np.random.default_rng(5)
    for P, nb, offsets in [(64, 4, (-16, -4, -1, 0, 1, 4, 16))] + CASES[3:]:
        data = torch.from_numpy(
            rng.standard_normal((len(offsets), nb, nb, P))).to(
                dev, getattr(torch, dtype))
        x = torch.from_numpy(rng.standard_normal((nb, P))).to(dev, vdt)
        offs = _offs_t(offsets).to(dev)
        _close(banded_matvec_t_omajor_ref(data, offs, x).cpu().numpy(),
               banded_matvec_t_omajor(data, offs, x).cpu().numpy(), tol)
