"""Shard-local setup of the port: every rank builds only its lane slabs of
the sharded levels, and the multi-rank dry run.

``ShardedBandedSystem.setup_local`` builds the tables and bands of a
sharded level one lane slab at a time (``build_banded_groups(lanes=)``,
K3-K5 on the lanes the slab needs, their plain versions here), its Jacobi
diagonal, transfer blocks and eigenvalue estimate by a
sharded power iteration; the levels below stay a whole ``Multigrid``.  One
spawn of fresh gloo processes per world size (2 and 4) runs, at
hyper_cube(3, 8), p=1, f64:

* ``structured``: ``bench_sharded``'s hierarchy (levels 8/64/512);
* ``packed``: the R-tree hierarchy without the relabel, its levels packed
  (``PACK_MIN_P`` lowered to 0); at 4 ranks their plans reach beyond a
  slab, so they are repacked with a far block-COO tail;
* ``dryrun``: ``models/sharded.dryrun``, the counterpart of the repo's
  ``__graft_entry__.dryrun_multichip`` (raises on a failed hold).

Each rank's shard-local system must hold no tensor with its level's
global lane count and build no host table as big as the whole level's,
equal (bitwise) the share ``from_multigrid`` takes of the whole setup,
estimate the same eigenvalues within 1e-12 and solve in the same
iterations to within 1e-9, as the JAX package's ``ShardedBandedSystem``
of its shard-local ``build_multigrid(device_mesh=)`` does on a mesh of as
many devices.  In one process: slab bands at 2 and 4 slabs equal the
global band and the JAX package's shard-local band; a slab's largest host
table is the level's largest over (per + 2 min(h, per)) of its P lanes (h
the largest offset), and on a level whose offsets reach beyond a slab no
larger than the slab's own share.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_rhs_direct as j_rhs,
    assemble_sipg_banded_direct as j_assemble,
    build_banded_groups as j_groups,
)
from polydeal_tpu.parallel import make_mesh  # noqa: E402
from polydeal_tpu.parallel.banded import (  # noqa: E402
    ShardedBandedSystem as JShardedBandedSystem,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_multigrid as j_build_multigrid,
    build_structured_hierarchy as j_structured,
)
from polydeal_tpu_torch.models.flagship import (  # noqa: E402
    flagship_hierarchy,
)
from polydeal_tpu_torch.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu_torch.assembly import sipg  # noqa: E402
from polydeal_tpu_torch.mesh import hyper_cube  # noqa: E402
from polydeal_tpu_torch.models.sharded import spawn  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid  # noqa: E402

CPU = torch.device("cpu")
WORLDS = (2, 4)
_F64 = dict(kind="local", n=8, dtype="float64", precond_dtype=None,
            rtol=1e-9)
CASES = {
    "structured": dict(_F64, hierarchy="structured"),
    "packed": dict(_F64, hierarchy="rtree", relabel=None, pack_min_p=0),
    "dryrun": dict(kind="dryrun"),
}
LOCAL = ("structured", "packed")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request):
    world = request.param
    return world, dict(zip(CASES, spawn(world, list(CASES.values()),
                                        device="cpu", timeout=240.0)))


@pytest.mark.parametrize("case", LOCAL)
def test_residency(ranks, case):
    """No tensor of a sharded level on a rank has the level's global lane
    count: bands, diagonals and transfers are all slabs; and no slab build
    makes a host table as big as the whole level's largest."""
    world, res = ranks
    r = res[case]
    assert r["n_dev"] == world
    assert r["meta"], "no level was sharded"
    assert r["global_lanes"] == []
    assert len(r["table_bytes"]) == len(r["meta"])
    assert all(slab < whole for slab, whole in r["table_bytes"])


@pytest.mark.parametrize("case", LOCAL)
def test_parity_with_global_setup(ranks, case):
    """The shard-local system is the share from_multigrid takes of the
    whole setup: the same levels, slabs bitwise equal, the same rhs slab,
    the same iterations and the solution within 1e-9."""
    _, res = ranks
    r = res[case]
    assert r["meta"] == r["meta_global"]
    assert all(r["slabs_equal"])
    assert r["dinv_diff"] == 0.0
    assert r["b_diff"] == 0.0
    assert r["iterations"] == r["iterations_global"]
    assert r["residual"] <= 1e-9 * r["bnorm"]
    assert r["max_abs_diff"] <= 1e-9


@pytest.mark.parametrize("case", LOCAL)
def test_sharded_lambda_max(ranks, case):
    """The sharded power iteration's eigenvalue estimates equal
    Multigrid.setup's within 1e-12 (f64)."""
    _, res = ranks
    assert max(res[case]["lam_rel"]) <= 1e-12


def test_packed_levels(ranks):
    world, res = ranks
    meta = res["packed"]["meta"]
    assert [m[0] for m in meta] == ["packed"] * len(meta)
    if world == 4:
        # the plans reach beyond a slab: repacked with a far tail
        assert all(m[3] and m[4] for m in meta)


def test_dryrun(ranks):
    """The dry run's packed fine level carries a far tail beyond one rank
    and its sharded solve is the host solve's; so is the flat block-COO
    one (dryrun raises on a failed hold)."""
    world, res = ranks
    r = res["dryrun"]
    assert r["n_dev"] == world
    assert r["fine_has_far"]
    assert r["iterations"] == r["host_iterations"]
    assert r["max_abs_diff"] <= 1e-9
    assert r["residual"] <= 1e-8 * r["bnorm"]
    assert r["flat_iterations"] == r["flat_host_iterations"]
    assert r["flat_max_abs_diff"] <= 1e-4
    assert r["flat_halo_rows"] > 0
    fine = r["comm"][-1]
    assert fine["kind"] == "packed" and fine["far_bytes"] > 0


def _level(kind):
    """(port handler, its band offsets) of a fine level: the structured
    hyper_cube(3, 8) hierarchy, the R-tree one of hyper_cube(2, 16)
    without the relabel (offsets up to 86), or the ``packed`` case's
    hyper_cube(3, 8) R-tree level without the relabel (offsets up to 220
    over 512 lanes)."""
    if kind == "structured":
        hs, _, _ = multigrid.build_structured_hierarchy(hyper_cube(3, 8), 8,
                                                        degree=1)
    elif kind == "packed":
        hs, _, _ = flagship_hierarchy(8, 1, "rtree", None)
    else:
        m = hyper_cube(2, 16)
        agg = RTreeAgglomerator.build(m.cell_centers())
        hs, _ = multigrid.build_rtree_hierarchy(
            m, agg, list(range(1, agg.n_levels - 1)), degree=1)
    return hs[-1], multigrid.band_offsets(hs[-1])


def _slab_bands(ah, offs, n_slabs):
    per = ah.n_poly // n_slabs
    out = []
    for r in range(n_slabs):
        g = sipg.build_banded_groups(ah, offs, torch.float64, device=CPU,
                                     lanes=(r * per, (r + 1) * per))
        out.append((dict(sipg.last_setup_stats),
                    sipg.assemble_sipg_banded_direct(ah, g, offs)))
    return out


@pytest.mark.parametrize("kind", ["structured", "rtree", "packed"])
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slab_bands_equal_global(kind, n_slabs):
    """Each slab's band equals the global band's lanes bitwise, and its
    rhs the global rhs's; every slab boundary is crossed by faces, whose
    m21 and m22 land in the next slab (through its group's lanes left of
    the slab) and whose m11 and m12 need the next slab's boxes (its out
    lanes)."""
    ah, offs = _level(kind)
    P = ah.n_poly
    per = P // n_slabs
    A = sipg.assemble_sipg_banded_direct(
        ah, sipg.build_banded_groups(ah, offs, torch.float64, device=CPU),
        offs)
    ft = ah.faces
    it = ~ft.is_boundary
    for r, (_, As) in enumerate(_slab_bands(ah, offs, n_slabs)):
        lanes = slice(r * per, (r + 1) * per)
        assert torch.equal(As.data, A.data[..., lanes])
        if r:
            cross = (ft.poly_in[it] < r * per) & (ft.poly_out[it] >= r * per)
            assert cross.any()


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slab_bands_match_jax(n_slabs):
    """The port's slab bands against the JAX package's shard-local band
    (``build_banded_groups(device_mesh=)``, lane-sharded over a mesh of as
    many devices) of the structured hyper_cube(3, 8) level, f64, 1e-12."""
    hs, _, _ = j_structured(pd.hyper_cube(3, 8), 8, degree=1)
    jah = hs[-1]
    ah, offs = _level("structured")
    dm = make_mesh(n_slabs)
    g = j_groups(jah, offs, jnp.float64, device_mesh=dm)
    JA = jax.jit(lambda t: j_assemble(jah, t, offsets=offs,
                                      use_pallas=False))(g)
    jd = np.asarray(JA.data)
    per = ah.n_poly // n_slabs
    scale = np.abs(jd).max()
    for r, (_, As) in enumerate(_slab_bands(ah, offs, n_slabs)):
        got = As.data.numpy()
        assert np.abs(got - jd[..., r * per:(r + 1) * per]).max() <= (
            1e-12 * scale)


def _table_bytes(g):
    """The largest of the tables of ``build_banded_groups``'s dict."""
    tensors = [g["vol"]["pts"], g["vol"]["w"], g["ext_t"], g["lo_t"]]
    for grp in list(g["groups"].values()) + [g["bdry"]]:
        tensors += [t for t in grp.values()
                    if torch.is_tensor(t) and t.is_floating_point()]
    return max(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slab_host_bytes(n_slabs):
    """A slab build makes no host table of the global lane count: the
    widest is the largest offset h's face group, per + 2 min(h, per) lanes
    (the faces into the slab and their out boxes), and the largest is at
    most the largest global table's share of those lanes, and of per + h."""
    ah, offs = _level("structured")
    P = ah.n_poly
    g = sipg.build_banded_groups(ah, offs, torch.float64, device=CPU)
    assert sipg.last_setup_stats["n_dev"] == 1
    biggest = _table_bytes(g)
    assert sipg.last_setup_stats["max_host_slab_bytes"] == biggest
    assert sipg.last_setup_stats["max_lanes"] == P
    per = P // n_slabs
    h = int(offs.max())
    for r in range(n_slabs):
        gs = sipg.build_banded_groups(ah, offs, torch.float64, device=CPU,
                                      lanes=(r * per, (r + 1) * per))
        stats = sipg.last_setup_stats
        assert stats["n_dev"] == n_slabs
        assert stats["max_lanes"] == per + 2 * min(h, per)
        assert stats["max_host_slab_bytes"] == _table_bytes(gs)
        assert stats["max_host_slab_bytes"] <= (
            biggest // P * stats["max_lanes"])
        assert stats["max_host_slab_bytes"] <= biggest // P * (per + h)


def test_slab_host_bytes_far_tail():
    """On the ``packed`` case's level at 4 slabs the offsets reach beyond a
    slab (h = 220 > per = 128), yet each slab's largest host table is no
    larger than the slab's share of the largest global one: a face group
    holds only the lanes of its faces into the slab where those are few."""
    ah, offs = _level("packed")
    P, n_slabs = ah.n_poly, 4
    per = P // n_slabs
    assert int(offs.max()) > per
    biggest = _table_bytes(sipg.build_banded_groups(ah, offs, torch.float64,
                                                    device=CPU))
    for r in range(n_slabs):
        gs = sipg.build_banded_groups(ah, offs, torch.float64, device=CPU,
                                      lanes=(r * per, (r + 1) * per))
        stats = sipg.last_setup_stats
        assert stats["max_host_slab_bytes"] == _table_bytes(gs)
        assert stats["max_host_slab_bytes"] <= biggest // P * per
        assert stats["max_lanes"] < P


@pytest.fixture(scope="module")
def jax_local():
    """Per device count: the JAX package's shard-local build of the
    ``structured`` case (``build_banded_groups`` and ``build_multigrid``
    with ``device_mesh=``, the flagship's smoother and coarse solve), its
    ``ShardedBandedSystem`` solved from zero: (x, iterations)."""
    out = {}
    hs, parents, gs = j_structured(pd.hyper_cube(3, 8), 8, degree=1,
                                   coarsest_side=2)
    ah = hs[-1]
    offs = multigrid.band_offsets(_level("structured")[0])
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)  # noqa: E731
    for n in WORLDS:
        dm = make_mesh(n)
        g = j_groups(ah, offs, jnp.float64, device_mesh=dm)
        A = jax.jit(lambda t: j_assemble(ah, t, offsets=offs,
                                         use_pallas=False))(g)
        b = jax.jit(lambda t: j_rhs(ah, t, lambda x: 3 * jnp.pi**2 * u_ex(x),
                                    u_ex))(g)
        mg = j_build_multigrid(hs, parents, A, dtype=jnp.float64,
                               grid_shapes=gs, chebyshev_degree=5,
                               n_smooth=1, smoothing_range=20.0,
                               level_assembly="banded", coarse_solver="inv",
                               fused_smoother=False, device_mesh=dm)
        x, k, _ = JShardedBandedSystem.from_multigrid(mg, dm).solve_cg(
            b, rtol=_F64["rtol"], maxiter=100)
        out[n] = (np.asarray(x), int(k))
    return out


def test_local_solve_matches_jax(ranks, jax_local):
    """The port's shard-local solve of the ``structured`` case takes the
    JAX package's shard-local iterations at the same device count, to a
    solution within 1e-9 (f64)."""
    world, res = ranks
    r = res["structured"]
    x, k = jax_local[world]
    assert r["iterations"] == k
    assert np.abs(r["x"] - x).max() <= 1e-9
