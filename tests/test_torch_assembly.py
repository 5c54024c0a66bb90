"""The port's direct banded SIPG assembly and rhs against the JAX package's
einsum branch (``use_pallas=False``), at f64 to 1e-12 relative, on R-tree
levels with several fine faces per polytope pair (C > 1), p = 1 and 2.
Also carries JAX bands and tables into the port through ``interop``.
"""

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
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-12

# (dim, n, R-tree extraction level): every level has C > 1 fine faces on
# some polytope interfaces
CASES = [(2, 16, 2), (3, 8, 1)]


def _levels(dim, n, level, degree):
    m, t = pd.hyper_cube(dim, n), tpd.hyper_cube(dim, n)
    c2p = RTreeAgglomerator.build(m.cell_centers()).extract_agglomerates(
        level)
    ha = pd.AgglomerationHandler(m, c2p, degree=degree)
    hb = tpd.AgglomerationHandler(t, c2p, degree=degree)
    ft = ha.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    ga = build_banded_groups(ha, offs, jnp.float64)
    assert max(g["w"].shape[0] for g in ga["groups"].values()) > 1  # C > 1
    gb = tsipg.build_banded_groups(hb, offs, torch.float64, device=CPU)
    return ha, hb, offs, ga, gb


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


@pytest.mark.parametrize("layout", ["omajor", "imajor"])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("dim,n,level", CASES)
def test_banded_direct_matches_jax(dim, n, level, degree, layout):
    ha, hb, offs, ga, gb = _levels(dim, n, level, degree)
    A = assemble_sipg_banded_direct(ha, ga, offsets=offs, use_pallas=False,
                                    layout=layout)
    B = tsipg.assemble_sipg_banded_direct(hb, gb, offsets=offs,
                                          layout=layout)
    assert np.array_equal(B.offsets, A.offsets)
    assert B.n_block_rows == A.n_block_rows
    if layout == "imajor":
        assert B.data.shape[-1] == 0
        _close(A.data_i, B.data_i.numpy())
    else:
        assert B.data_i is None
        _close(A.data, B.data.numpy())


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("dim,n,level", CASES)
def test_rhs_direct_matches_jax(dim, n, level, degree):
    ha, hb, _, ga, gb = _levels(dim, n, level, degree)
    u_j = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    f_j = lambda x: dim * jnp.pi**2 * u_j(x)
    u_t = lambda x: torch.prod(torch.sin(np.pi * x), dim=-1)
    f_t = lambda x: dim * np.pi**2 * u_t(x)
    ref = assemble_rhs_direct(ha, ga, f_j, u_j)
    got = tsipg.assemble_rhs_direct(hb, gb, f_t, u_t)
    _close(ref, got.numpy())


@pytest.mark.parametrize("degree", [1, 2])
def test_interop_band_and_tables(degree):
    """A JAX band (both layouts) multiplies identically in the port's SpMV,
    and the JAX tables assemble the same band in the port."""
    ha, hb, offs, ga, _ = _levels(2, 16, 2, degree)
    A = assemble_sipg_banded_direct(ha, ga, offsets=offs, use_pallas=False)
    Ai = A.with_imajor()
    x = np.random.default_rng(0).standard_normal((ha.n_basis, ha.n_poly))
    ref = np.asarray(A.matvec_t(jnp.asarray(x)))
    for kw in ({}, {"data_i": np.asarray(Ai.data_i)}):
        B = interop.banded_from_arrays(np.asarray(A.data), A.offsets,
                                       A.n_block_cols, device=CPU, **kw)
        assert (B.data_i is None) == (not kw)
        _close(ref, B.matvec_t(torch.from_numpy(x)).numpy())
    gb = interop.groups_from_arrays(ga, device=CPU)
    B = tsipg.assemble_sipg_banded_direct(hb, gb, offsets=offs)
    _close(A.data, B.data.numpy())
