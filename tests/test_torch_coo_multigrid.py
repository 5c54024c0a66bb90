"""The port's multigrid on the general block-COO path against the JAX
package's, at f64 on the CPU: a block-ELL level (a hierarchy whose fine
polytopes are renumbered by a seeded permutation: > 96 band offsets) on
the flat V-cycle, with and without a lane path on its transfer;
``mode="galerkin"``; per-level Chebyshev schedules; ``vector_dtype``.  The
JAX side runs as its own tests run it on the CPU: its smoothing is
unfused there, the port's fused one runs the plain versions, so the
iterations are equal and the solutions agree to rounding."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly import sipg as jsipg  # noqa: E402
from polydeal_tpu.solvers import multigrid as jmg  # noqa: E402
from polydeal_tpu_torch.agglomeration import (  # noqa: E402
    RTreeAgglomerator as TRTreeAgglomerator,
)
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402
from polydeal_tpu_torch.sparse import BlockBanded, BlockELL  # noqa: E402

CPU = torch.device("cpu")


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


def _hierarchy(dim=2, n=16, degree=1, start=1):
    m, t = pd.hyper_cube(dim, n), tpd.hyper_cube(dim, n)
    agg = RTreeAgglomerator.build(m.cell_centers())
    levels = list(range(start, agg.n_levels - 1))
    ha, pa = jmg.build_rtree_hierarchy(m, agg, levels, degree=degree)
    hb, pb = tmg.build_rtree_hierarchy(
        t, TRTreeAgglomerator.build(t.cell_centers()), levels, degree=degree)
    return ha, pa, hb, pb


def _system(ha, hb):
    dim = ha.dim
    ju = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    tu = lambda x: torch.prod(torch.sin(math.pi * x), dim=-1)
    return (jsipg.assemble_sipg_matrix(ha),
            jsipg.assemble_rhs(ha, lambda x: dim * jnp.pi**2 * ju(x), ju),
            tsipg.assemble_sipg_matrix(hb, device=CPU),
            tsipg.assemble_rhs(hb, lambda x: dim * math.pi**2 * tu(x), tu,
                               device=CPU))


@pytest.fixture(scope="module")
def permuted():
    """2D n=16 R-tree hierarchy (levels 16-256) with the fine polytopes
    renumbered by a seeded permutation (parents remapped): the fine band
    has > 96 offsets.  The JAX package's solves (zero and FMG start) run
    once for every case."""
    ha, pa, hb, pb = _hierarchy(n=16, start=2)
    perm = np.random.default_rng(3).permutation(ha[-1].n_poly)
    c2p = perm[ha[-1].cell2poly]
    parent = np.asarray(pa[-1])[np.argsort(perm)]
    ha = ha[:-1] + [pd.AgglomerationHandler(ha[-1].mesh, c2p, degree=1)]
    hb = hb[:-1] + [tpd.AgglomerationHandler(hb[-1].mesh, c2p, degree=1)]
    pa, pb = pa[:-1] + [parent], pb[:-1] + [parent]
    A, bj, B, bt = _system(ha[-1], hb[-1])
    mj = jmg.build_multigrid(ha, pa, A)
    refs = [mj.solve_cg(bj, rtol=1e-9, fmg=f) for f in (False, True)]
    return hb, pb, B, bt, [(int(r.iterations), np.asarray(r.x))
                           for r in refs]


@pytest.mark.parametrize("fmg", [False, True])
def test_multigrid_with_ell_level(permuted, fmg):
    """A permuted fine level goes to block-ELL and runs the flat V-cycle;
    the banded level below it receives its residual flat and switches to
    the transposed layout beneath.  The layout changes no arithmetic: the
    JAX package's iterations, solutions to 1e-10, from a zero and an FMG
    start."""
    hb, pb, B, bt, refs = permuted
    assert B.banded_offsets().shape[0] > tmg.MAX_BAND_OFFSETS
    mt = tmg.build_multigrid(hb, pb, B, device=CPU)
    assert isinstance(mt.ells[-1], BlockELL)
    assert all(isinstance(e, BlockBanded) for e in mt.ells[:-1])
    assert [mt._is_t(lv) for lv in range(mt.n_levels)] == (
        [True] * (mt.n_levels - 1) + [False])
    its, x = refs[int(fmg)]
    rt = mt.solve_cg(bt, rtol=1e-9, fmg=fmg)
    assert rt.iterations == its > 0
    _close(x, rt.x, 1e-10)


@pytest.fixture(scope="module")
def small():
    """2D n=8 R-tree hierarchy (levels 4-64) and its Poisson system."""
    ha, pa, hb, pb = _hierarchy(n=8)
    return (ha, pa, hb, pb) + _system(ha[-1], hb[-1])


def test_multigrid_galerkin_mode(small):
    ha, pa, hb, pb, A, bj, B, bt = small
    rj = jmg.build_multigrid(ha, pa, A, mode="galerkin").solve_cg(
        bj, rtol=1e-9)
    mt = tmg.build_multigrid(hb, pb, B, mode="galerkin", device=CPU)
    rt = mt.solve_cg(bt, rtol=1e-9)
    assert rt.iterations == int(rj.iterations)
    _close(rj.x, rt.x, 1e-10)
    with pytest.raises(ValueError):
        tmg.build_multigrid(hb, pb, B, mode="other", device=CPU)


def test_per_level_smoother_schedule(small):
    """Tuple schedules (coarsest first) as in the JAX package's
    test_per_level_smoother_schedule: the same iterations and solution as
    the JAX package, and a schedule of the wrong length raises."""
    ha, pa, hb, pb, A, bj, B, bt = small
    n_lv = len(ha)
    sched = tuple([2] * (n_lv - 1) + [5])
    ones = tuple([1] * n_lv)
    rj = jmg.build_multigrid(ha, pa, A, chebyshev_degree=sched,
                             n_smooth=ones).solve_cg(bj, rtol=1e-9)
    mt = tmg.build_multigrid(hb, pb, B, chebyshev_degree=sched,
                             n_smooth=ones, device=CPU)
    assert mt.level_degree(n_lv - 1) == 5 and mt.level_degree(1) == 2
    rt = mt.solve_cg(bt, rtol=1e-9)
    assert rt.iterations == int(rj.iterations)
    _close(rj.x, rt.x, 1e-10)
    with pytest.raises(ValueError):
        tmg.build_multigrid(hb, pb, B, chebyshev_degree=(5, 2), device=CPU)


def test_vector_dtype(small):
    """f32 band copies and f32 smoothing vectors under an f64 operator
    (the JAX package's own executable vector_dtype case): the same
    iterations; vectors narrower than a smoothing band raise."""
    ha, pa, hb, pb, A, bj, B, bt = small
    rj = jmg.build_multigrid(ha, pa, A, precond_dtype=jnp.float32,
                             vector_dtype=jnp.float32).solve_cg(bj,
                                                                rtol=1e-9)
    mt = tmg.build_multigrid(hb, pb, B, precond_dtype=torch.float32,
                             vector_dtype=torch.float32, device=CPU)
    assert mt.lo_dinvs[-1].dtype == torch.float32
    assert mt.dinvs_t[-1].dtype == torch.float64
    rt = mt.solve_cg(bt, rtol=1e-9)
    assert rt.iterations == int(rj.iterations)
    _close(rj.x, rt.x, 1e-7)
    with pytest.raises(ValueError):
        tmg.build_multigrid(hb, pb, B, vector_dtype=torch.float32,
                            device=CPU)
