"""The port's flat block-COO sharded solve against the JAX package's.

``polydeal_tpu_torch.parallel.sharding.ShardedSystem`` runs one process per
shard on ``torch.distributed`` (gloo here), every level as row-sharded
block-COO read through ``to_block_matrix``.  The problems are
``tests/test_sharding.py``'s: the 2D R-tree Poisson problem (table
assembly, f64) at n=8 and n=16.  One spawn of fresh processes per world
size (1, 2 and 4) runs every case of that size:

* ``cg``: CG with no preconditioner (rtol 1e-10) against the host CG,
  within 1e-8;
* ``mg``: MG-CG (rtol 1e-9) against the JAX package's ``ShardedSystem`` on
  a mesh of as many devices: the same iterations, x within 1e-9; the L2
  error below 0.06; the halo metadata of the fine level;
* ``mg_cheb5``: ``chebyshev_degree=5, n_smooth=2`` against the port's host
  MG-CG: iterations within one, x within 1e-8.

In-process: ``shard_block_matrix``'s padding rebuilds A densely within
1e-13 and equals the JAX package's sharding of the same matrix (its arrays
handed over by ``interop.sharded_matrix_from_arrays``); ``to_block_matrix``
of a band, a pack with a far tail and a block-ELL level reproduces the
dense matrix exactly.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly import assemble_rhs, assemble_sipg_matrix  # noqa
from polydeal_tpu.parallel import (  # noqa: E402
    ShardedSystem as JShardedSystem,
    make_mesh,
    shard_block_matrix as jshard_block_matrix,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_multigrid,
    build_rtree_hierarchy,
)
from polydeal_tpu_torch.interop import sharded_matrix_from_arrays  # noqa: E402
from polydeal_tpu_torch.models.sharded import flat_problem, spawn  # noqa: E402
from polydeal_tpu_torch.ops.packed import build_pack_plan  # noqa: E402
from polydeal_tpu_torch.parallel import shard_block_matrix  # noqa: E402
from polydeal_tpu_torch.sparse import BlockBanded  # noqa: E402

CPU = torch.device("cpu")
WORLDS = (1, 2, 4)
CASES = {
    "cg": dict(kind="flat", n=8, rtol=1e-10, maxiter=3000,
               precondition=False),
    "mg": dict(kind="flat", n=16, rtol=1e-9),
    "mg_cheb5": dict(kind="flat", n=16, rtol=1e-9, chebyshev_degree=5,
                     n_smooth=2),
}


def setup_problem(n):
    """tests/test_sharding.py's problem on the JAX package: (A, b, mg)."""
    m0 = pd.hyper_cube(2, n)
    agg = RTreeAgglomerator.build(m0.cell_centers())
    handlers, parents = build_rtree_hierarchy(
        m0, agg, list(range(1, agg.n_levels - 1)), degree=1)
    hf = handlers[-1]
    A = assemble_sipg_matrix(hf)
    u_ex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
    b = assemble_rhs(hf, lambda x: 2 * jnp.pi**2 * u_ex(x), u_ex)
    return A, b, build_multigrid(handlers, parents, A)


@pytest.fixture(scope="module")
def jax_mg():
    """The JAX package's sharded MG-CG on the n=16 problem at each world
    size: (x, iterations)."""
    A, b, mg = setup_problem(16)
    out = {}
    for n in WORLDS:
        x, k, _ = JShardedSystem.from_multigrid(mg, make_mesh(n)).solve_cg(b)
        out[n] = (np.asarray(x), k)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request):
    world = request.param
    return world, dict(zip(CASES, spawn(world, list(CASES.values()),
                                        device="cpu", timeout=240.0)))


def test_sharded_cg_matches_host(ranks):
    world, res = ranks
    r = res["cg"]
    assert r["n_dev"] == world
    assert np.abs(r["x"] - r["x_host"]).max() <= 1e-8


def test_sharded_mg_matches_jax(ranks, jax_mg):
    world, res = ranks
    r = res["mg"]
    x, k = jax_mg[world]
    assert r["iterations"] == k
    assert np.abs(r["x"] - x).max() <= 1e-9
    assert r["l2"] < 0.06


def test_sharded_mg_matches_host_mg(ranks):
    world, res = ranks
    r = res["mg_cheb5"]
    assert abs(r["iterations"] - r["host_iterations"]) <= 1
    assert np.abs(r["x"] - r["x_host"]).max() <= 1e-8


def test_halo_comm_volume(ranks):
    """The rows one SpMV ships are the halo's, far below the whole vector,
    and the nested R-tree hierarchy's transfers need no communication."""
    world, res = ranks
    fine = res["mg"]["fine"]
    halo = sum(fine["n_sends"])
    if world == 1:
        assert halo == 0 and fine["deltas"] == ()
    else:
        assert 0 < halo < fine["n_rows_pad"] // 3
    assert fine["nested_transfer"]


@pytest.fixture(scope="module")
def problems():
    """The n=8 problem in both packages: (JAX A, port A, port mg)."""
    jA, _, _ = setup_problem(8)
    _, A, _, mg = flat_problem(8, device=CPU)
    return jA, A, mg


def _dense_of_shards(SA):
    nb = SA.n_basis
    per, n = SA.rows_per_shard, SA.n_dev
    dense = np.zeros((SA.n_rows_pad * nb, SA.n_rows_pad * nb))
    data = SA.data.numpy().reshape(n, -1, nb, nb)
    lrows = SA.lrows.reshape(n, -1)
    cols = SA.cols.reshape(n, -1)
    for d in range(n):
        for k in range(data.shape[1]):
            r, c = d * per + lrows[d, k], cols[d, k]
            dense[r * nb:(r + 1) * nb, c * nb:(c + 1) * nb] += data[d, k]
    return dense


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_shard_block_matrix_padding(problems, n_dev):
    jA, A, _ = problems
    SA = shard_block_matrix(A, n_dev)
    assert SA.n_rows_pad % n_dev == 0
    ref = A.to_dense().numpy()
    dense = _dense_of_shards(SA)
    assert np.abs(dense[:ref.shape[0], :ref.shape[1]] - ref).max() <= 1e-13
    # the JAX package's sharding of its own matrix: the same layout
    J = jshard_block_matrix(jA, n_dev)
    JS = sharded_matrix_from_arrays(
        np.asarray(J.data), np.asarray(J.lrows), np.asarray(J.cols),
        J.rows_per_shard, J.n_rows_pad, J.n_dev, device=CPU)
    assert (JS.rows_per_shard, JS.n_rows_pad) == (SA.rows_per_shard,
                                                  SA.n_rows_pad)
    assert np.array_equal(JS.lrows, SA.lrows)
    assert np.array_equal(JS.cols, SA.cols)
    assert (JS.data - SA.data).abs().max() <= 1e-12 * SA.data.abs().max()


def test_to_block_matrix_of_levels(problems):
    """A band (o-major, and i-major only), a pack with a far tail and a
    block-ELL level: ``to_block_matrix`` reproduces the dense matrix
    exactly, and drops every all-zero block."""
    _, A, mg = problems
    ref = A.to_dense()
    band = A.to_banded()
    for e in (band, band.with_imajor(drop_omajor=True)):
        M = e.to_block_matrix()
        assert torch.equal(M.to_dense(), ref)
        assert np.array_equal(M.rows, A.rows)
        assert np.array_equal(M.cols, A.cols)
    off = A.rows != A.cols
    plan, oid, frows, fcols = build_pack_plan(
        A.rows[off], A.cols[off], A.n_block_rows, A.n_basis, near_limit=4)
    assert frows.size
    pk = band.to_packed(plan, torch.as_tensor(oid), frows, fcols)
    assert torch.equal(pk.to_block_matrix().to_dense(), ref)
    ell = A.to_ell()
    assert torch.equal(ell.to_block_matrix().to_dense(), ref)
    # the multigrid's own levels
    for e in mg.ells:
        d = (e.to_dense() if isinstance(e, BlockBanded)
             else e.to_block_matrix().to_dense())
        assert torch.equal(e.to_block_matrix().to_dense(), d)
    nz = band.to_block_matrix().data.flatten(1).abs().amax(dim=1)
    assert bool((nz > 0).all())
    assert math.isfinite(float(nz.max()))
