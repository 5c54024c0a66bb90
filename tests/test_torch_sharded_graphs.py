"""The sharded solves as one device program: both sharded systems' CG run
as the captured loop runs it, on gloo ranks, and the far block-COO tails'
fixed-order sums.

On a card, ``ShardedBandedSystem`` and the flat block-COO ``ShardedSystem``
solve as captured programs (``solvers/graphs.CGLoop``) at every world size
on NCCL, the halo exchanges and all-reduces inside them.  A solve runs
``cg_init`` once and then masked ``cg_body`` iterations in a WHILE loop on
the device, every rank as many as its ``active`` flag asks for, so the
programs compute what these functions compute.  Here, on 2 and 4 gloo ranks (one spawn of fresh
processes per world size, every case inside it; ``models/sharded
.masked_case``), each rank runs that CG eagerly: ``cg_init``, masked bodies
to the stop, then three blind bodies.  For:

* ``ShardedBandedSystem`` of the n=8 flagship (f64): the structured
  hierarchy, the lex R-tree one, and ``relabel=None`` with every level
  packed (``pack_min_p=0``), which 4 ranks repack with a far tail;
* the flat ``ShardedSystem`` on the 2D n=8 R-tree problem (f64),

every rank's result and iterations are bitwise those of its eager
``solve_cg_local(capture=False)``, every blind body leaves the state
bitwise as it was, every rank saw the same ``active`` flags (so every rank
runs the same bodies the same number of times), and ``capture=True``
raises on gloo.  x takes the JAX package's sharded iterations to within
1e-9 of its solution (``ShardedBandedSystem`` / ``ShardedSystem`` on a
mesh of as many devices; the packed case against the 4-device solve, the
arm with the far tail, at both world sizes).

In-process: the far tails (``BlockPacked.far_matvec_t`` and
``ShardedBandedSystem._far_matvec``) reduce through a ``SegmentSum`` that
equals a dense product of the tail (f64, 1e-14) and repeats bitwise, on a
tail whose rows repeat; with unequal shares over 4 ranks each rank sums
only its own entries.  On a card (``-m cuda``; this module imports no
JAX at its top, so it runs there with ``--noconftest``): both systems at
world size 1 captured against eager, and the far tails bitwise equal run to
run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.models.sharded import (  # noqa: E402
    BLIND,
    flat_problem,
    packed_problem,
    spawn,
)
from polydeal_tpu_torch.models.flagship import setup_flagship  # noqa: E402
from polydeal_tpu_torch.parallel.banded import (  # noqa: E402
    ShardedBandedSystem,
)
from polydeal_tpu_torch.parallel.sharding import ShardedSystem  # noqa: E402

CPU = torch.device("cpu")
N = 8
RTOL = 1e-9
WORLDS = (2, 4)
_F64 = dict(kind="masked", system="banded", n=N, dtype="float64",
            precond_dtype=None, rtol=RTOL)
CASES = {
    "structured": dict(_F64, hierarchy="structured"),
    "lex": dict(_F64, hierarchy="rtree", relabel="lex"),
    "packed": dict(_F64, hierarchy="rtree", relabel=None, pack_min_p=0),
    "flat": dict(kind="masked", system="flat", n=N, rtol=RTOL),
}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request):
    """(world size, rank 0's result per case): one spawn of fresh gloo
    processes per world size."""
    world = request.param
    return world, dict(zip(CASES, spawn(world, list(CASES.values()),
                                        device="cpu", timeout=240.0)))


@pytest.fixture(scope="module")
def jax_sharded():
    """(x, iterations) of the JAX package's sharded solve per (case, world
    size); the packed case's at 4 devices only (where its plan reaches
    beyond a shard)."""
    # the JAX problems of the sharded parity tests (imported here, so
    # that this module imports no JAX for the card's -m cuda run)
    from test_torch_sharded import _jax_problem
    from test_torch_sharding import setup_problem

    from polydeal_tpu.parallel import ShardedSystem as JShardedSystem
    from polydeal_tpu.parallel import make_mesh
    from polydeal_tpu.parallel.banded import (
        ShardedBandedSystem as JShardedBandedSystem,
    )

    out = {}
    for kind in ("structured", "lex", "packed"):
        mg, b = _jax_problem(kind)
        for n in ((4,) if kind == "packed" else WORLDS):
            x, k, _ = JShardedBandedSystem.from_multigrid(
                mg, make_mesh(n)).solve_cg(b, rtol=RTOL, maxiter=100)
            out[kind, n] = (np.asarray(x), int(k))
    _, b, mg = setup_problem(N)
    for n in WORLDS:
        x, k, _ = JShardedSystem.from_multigrid(mg, make_mesh(n)).solve_cg(
            b, rtol=RTOL, maxiter=100)
        out["flat", n] = (np.asarray(x), int(k))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_masked_bodies_match_eager(ranks, case):
    """On every rank: the loop's x and iterations bitwise the eager
    solve's, blind bodies no-ops, the same flags as every other rank
    (``active`` after the start and each of k bodies, then the blind
    ones), ``capture=True`` raising on gloo."""
    world, res = ranks
    r = res[case]
    assert r["n_dev"] == world and len(r["ranks"]) == world
    k = r["ranks"][0]["k"]
    assert k > 1
    want = [True] * k + [False] * (1 + BLIND)
    for rk in r["ranks"]:
        assert rk["k"] == rk["k_eager"] == k
        assert rk["x_equal"]
        assert rk["unchanged"] == [True] * BLIND
        assert rk["flags"] == want
        assert rk["raised"]
    if case == "packed" and world == 4:
        # the far-tail arm: the fine pack repacked with a far tail
        assert r["meta"][-1][0] == "packed" and r["meta"][-1][3]


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_sharded(ranks, jax_sharded, case):
    world, res = ranks
    x, k = jax_sharded[case, 4 if case == "packed" else world]
    r = res[case]
    assert r["ranks"][0]["k"] == k
    assert np.abs(r["x"] - x).max() <= 1e-9


# ---- the far tails' fixed-order sums -----------------------------------

def _far_tail(device):
    """(pack with a far tail, the world-size-1 sharded system of its
    hierarchy, a seeded x [nb, P] in f64)."""
    _, _, mg = packed_problem(device, lambda P: 4)
    ell = mg.ells[-1]
    ss = ShardedBandedSystem.from_multigrid(mg)
    gen = np.random.default_rng(15)
    xt = torch.as_tensor(gen.standard_normal((ell.n_basis,
                                              ell.n_block_rows)),
                         device=device)
    return ell, ss, xt


def _dense_tail(ell, xt):
    """[nb, P]: the tail's product by a host scatter-add of its blocks."""
    data = ell.far_data.cpu().numpy()
    x = xt.T.cpu().numpy()
    y = np.zeros_like(x)
    np.add.at(y, np.asarray(ell.far_rows),
              np.einsum("kij,kj->ki", data, x[np.asarray(ell.far_cols)]))
    return y.T


def test_far_tails_are_fixed_order_sums():
    ell, ss, xt = _far_tail(CPU)
    rows = np.asarray(ell.far_rows)
    assert np.unique(rows).size < rows.size  # rows repeat
    lv, pl_ = ss.levels[-1], ss.params[-1]
    assert lv.kind == "packed" and lv.has_far
    ref = _dense_tail(ell, xt)
    scale = np.abs(ref).max()
    for fn in (lambda: ell.far_matvec_t(xt),
               lambda: ss._far_matvec(lv, pl_, xt)):
        y = fn()
        assert np.abs(y.numpy() - ref).max() <= 1e-14 * scale
        assert torch.equal(fn(), y)


def test_far_tail_unequal_shares():
    """Four ranks with tail shares of 7, 3, 1 and 0 entries: each rank
    keeps only its own entries (one zero entry where it has none), its
    ``SegmentSum`` is as wide as its most repeated local row (not the
    padding to the largest share), and each rank's sum, fed the lanes its
    exchange plan ships to it, equals the dense product of its rows of the
    tail (f64, 1e-14)."""
    from polydeal_tpu_torch.parallel.banded import _SLevel

    n_dev, per, nb = 4, 6, 2
    rows = np.array([0, 0, 0, 2, 2, 5, 1, 8, 8, 11, 13])
    cols = np.array([12, 18, 23, 20, 7, 14, 19, 0, 21, 3, 5])
    gen = np.random.default_rng(15)
    blocks = torch.as_tensor(gen.standard_normal((rows.size, nb, nb)))
    x = gen.standard_normal((n_dev * per, nb))
    levels, params = [], []
    for rank in range(n_dev):
        lv = _SLevel(kind="packed", per=per, T=1, lo=0.0, hi=1.0, nb=nb)
        pl_ = dict(data_i=torch.zeros((1, nb, nb), dtype=torch.float64))
        ShardedBandedSystem._build_far(lv, pl_, rows, cols,
                                       lambda idx: blocks[idx], per, n_dev,
                                       rank)
        levels.append(lv)
        params.append(pl_)
    for rank, (lv, pl_) in enumerate(zip(levels, params)):
        mine = rows // per == rank
        k = int(mine.sum())
        assert k == (7, 3, 1, 0)[rank]
        assert pl_["fdata"].shape[0] == max(k, 1)
        local = rows[mine] - rank * per
        widest = np.bincount(local).max() if k else 1
        assert pl_["frow_sum"].shape == (per, widest)
        segs = [x[rank * per:(rank + 1) * per]]
        for t, delta in enumerate(lv.deltas):
            src = (rank - delta) % n_dev
            segs.append(x[src * per + params[src][f"fsend{t}"].numpy()])
        xg = torch.as_tensor(np.concatenate(segs))
        y = pl_["frow_sum"](torch.einsum("kij,kj->ki", pl_["fdata"],
                                         xg[pl_["fcols"]]))
        ref = np.zeros((per, nb))
        np.add.at(ref, local, np.einsum("kij,kj->ki", blocks[mine].numpy(),
                                        x[cols[mine]]))
        assert np.abs(y.numpy() - ref).max() <= 1e-14 * max(
            np.abs(ref).max(), 1.0)


# ---- on a card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_far_tails_repeat_bitwise(cuda):
    ell, ss, xt = _far_tail(cuda)
    lv, pl_ = ss.levels[-1], ss.params[-1]
    ref = _dense_tail(ell, xt)
    for fn in (lambda: ell.far_matvec_t(xt),
               lambda: ss._far_matvec(lv, pl_, xt)):
        y = fn()
        assert all(torch.equal(fn(), y) for _ in range(5))
        assert np.abs(y.cpu().numpy() - ref).max() <= 1e-14 * np.abs(
            ref).max()


def _captured_and_eager(ss, b, rtol):
    xe, ke, _ = ss.solve_cg_local(b, rtol=rtol, maxiter=100, capture=False)
    xg, kg, _ = ss.solve_cg_local(b, rtol=rtol, maxiter=100)
    xa, ka, ra = ss.solve_cg_async(b, rtol=rtol, maxiter=100)
    assert ka.device.type == "cuda" and ra.device.type == "cuda"
    assert ke == kg == int(ka) > 1
    assert torch.equal(xg, xa)
    assert float((xg - xe).abs().max()) <= 1e-12 * float(xe.abs().max())
    loop = ss._compiled(rtol, 100, True, b.dtype)[0]
    assert loop.last["replays"] == ke and loop.last["host_reads"] == 1


@pytest.mark.cuda
def test_cuda_world_size_1_captured_matches_eager(cuda):
    """Both systems with no process group: the captured solve (the
    default) against ``capture=False``, f64: the same iterations, x within
    1e-12 (bitwise unless a product takes another cuBLAS algorithm in the
    graph); the packed hierarchy's far tail captured too."""
    _, _, b, mg = flat_problem(N, device=cuda)
    ss = ShardedSystem.from_multigrid(mg)
    assert ss.graph_ok(b)
    _captured_and_eager(ss, b, RTOL)
    _, b, mg = packed_problem(cuda, lambda P: 4)
    ss = ShardedBandedSystem.from_multigrid(mg)
    assert ss.levels[-1].has_far and ss.graph_ok(b)
    _captured_and_eager(ss, b, RTOL)
    fs = setup_flagship(n=N, device=cuda, dtype=torch.float64,
                        precond_dtype=None, hierarchy="structured")
    _captured_and_eager(ShardedBandedSystem.from_multigrid(fs.mg), fs.b,
                        RTOL)
