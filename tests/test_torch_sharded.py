"""The sharded solve of the port against its unsharded solve and the JAX
package's, on the CPU.

``polydeal_tpu_torch.parallel.banded.ShardedBandedSystem`` runs one process
per shard on ``torch.distributed`` (gloo here).  At hyper_cube(3, 8), p=1,
f64, rtol 1e-9, each of four problems is solved by every rank of a group
of 1, 2 and 4 (one spawn of fresh processes per group size, every check of
that size inside it):

* ``structured``: ``bench_sharded``'s hierarchy (levels 8/64/512, 7
  offsets, grid transfers);
* ``lex``: the flagship's R-tree hierarchy with the lex relabel;
* ``packed``: the R-tree hierarchy without the relabel, the 64- and
  512-lane levels packed (``PACK_MIN_P`` lowered to 0); at 4 ranks their
  plans reach beyond a shard, so they are repacked with a far block-COO
  tail;
* ``packed512``: the same with only the 512-lane level packed, the layout
  the JAX package's ``pack=True`` gives (it packs P % 128 == 0 levels).

Each sharded solve must take the port's unsharded iteration count and the
JAX package's, to solutions within 1e-9 of both; one V-cycle must equal
the unsharded one.  The sharded levels' metadata (kind, per, T, has_far,
deltas, n_sends) and ``comm_bytes_per_spmv()`` must equal the JAX
``ShardedBandedSystem`` of the same multigrid on a mesh of as many
devices, and one JAX sharded solve (2 devices) must agree with the port's.
The structured hierarchy's unsharded f64 solve must match the JAX
package's: the same iterations, the solution to 1e-13.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.assembly.sipg import (  # noqa: E402
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    build_banded_groups,
)
from polydeal_tpu.ops.packed import build_pack_plan  # noqa: E402
from polydeal_tpu.parallel import make_mesh  # noqa: E402
from polydeal_tpu.parallel.banded import (  # noqa: E402
    ShardedBandedSystem as JShardedBandedSystem,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_multigrid,
    build_rtree_hierarchy,
    build_structured_hierarchy,
    detect_grid_shapes,
)
from polydeal_tpu_torch.models.flagship import setup_flagship  # noqa: E402
from polydeal_tpu_torch.models.sharded import spawn  # noqa: E402

CPU = torch.device("cpu")
N = 8
RTOL = 1e-9
WORLDS = (1, 2, 4)
_F64 = dict(n=N, dtype="float64", precond_dtype=None, rtol=RTOL)
CASES = {
    "structured": dict(_F64, hierarchy="structured"),
    "lex": dict(_F64, hierarchy="rtree", relabel="lex"),
    "packed": dict(_F64, hierarchy="rtree", relabel=None, pack_min_p=0),
    "packed512": dict(_F64, hierarchy="rtree", relabel=None,
                      pack_min_p=512),
}
JAX_OF = {"structured": "structured", "lex": "lex", "packed": "packed",
          "packed512": "packed"}


def _jax_problem(kind):
    """The flagship system of ``kind`` on the JAX package, f64, as its
    tests run it (no Pallas on the CPU, unfused smoothing)."""
    mesh = pd.hyper_cube(3, N)
    if kind == "structured":
        handlers, parents, gs = build_structured_hierarchy(
            mesh, N, degree=1, coarsest_side=max(2, N >> 3))
    else:
        agg = RTreeAgglomerator.build(mesh.cell_centers())
        relabel = "lex" if kind == "lex" else None
        handlers, parents = build_rtree_hierarchy(
            mesh, agg, list(range(max(1, agg.n_levels - 4),
                                  agg.n_levels - 1)), degree=1,
            relabel=relabel)
        gs = detect_grid_shapes(handlers, parents) if relabel else None
    ah = handlers[-1]
    ft = ah.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
    plan = oid = None
    if kind == "packed":
        plan, oid, _, _ = build_pack_plan(
            ft.poly_in[interior], ft.poly_out[interior], ah.n_poly,
            ah.n_basis, offsets=offs, near_limit=-1)
        oid = jnp.asarray(oid)
    groups = build_banded_groups(ah, offs, jnp.float64)
    A0 = assemble_sipg_banded_direct(ah, groups, offsets=offs,
                                     use_pallas=False, pack_plan=plan,
                                     pack_oid=oid)
    u_ex = lambda x: jnp.prod(jnp.sin(jnp.pi * x), axis=-1)
    b = assemble_rhs_direct(ah, groups, lambda x: 3 * jnp.pi**2 * u_ex(x),
                            u_ex)
    mg = build_multigrid(handlers, parents, A0, dtype=jnp.float64,
                         grid_shapes=gs, chebyshev_degree=5, n_smooth=1,
                         smoothing_range=20.0, level_assembly="banded",
                         coarse_solver="inv", fused_smoother=False,
                         pack=kind == "packed")
    return mg, b


def _meta(ss):
    return [(lv.kind, lv.per, lv.T, lv.has_far, tuple(lv.deltas),
             tuple(lv.n_sends)) for lv in ss.levels]


@pytest.fixture(scope="module")
def jax_ref():
    """Per JAX problem: the host solve from zero and, per device count, the
    sharded system's level metadata and comm bytes; plus one sharded solve
    on 2 devices (structured)."""
    out = {}
    for kind in ("structured", "lex", "packed"):
        mg, b = _jax_problem(kind)
        res = mg.solve_cg(b, rtol=RTOL, maxiter=100)
        ref = dict(x=np.asarray(res.x), iterations=int(res.iterations),
                   meta={}, comm={})
        for n in WORLDS:
            ss = JShardedBandedSystem.from_multigrid(mg, make_mesh(n))
            ref["meta"][n], ref["comm"][n] = (_meta(ss),
                                              ss.comm_bytes_per_spmv())
            if kind == "structured" and n == 2:
                x, k, _ = ss.solve_cg(b, rtol=RTOL, maxiter=100)
                ref["sharded2"] = (np.asarray(x), k)
        out[kind] = ref
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request):
    """(world size, rank 0's result per case): one spawn of fresh gloo
    processes per world size."""
    world = request.param
    return world, dict(zip(CASES, spawn(world, list(CASES.values()),
                                        timeout=240.0)))


def test_structured_flagship_matches_jax(jax_ref):
    """The port's structured hierarchy end to end (its levels, band and
    multigrid) against the JAX package's, f64, no FMG: same iterations,
    solution to 1e-13."""
    ref = jax_ref["structured"]
    fs = setup_flagship(n=N, device=CPU, dtype=torch.float64,
                        precond_dtype=None, hierarchy="structured")
    assert fs.level_sizes == [8, 64, 512] and fs.format == "banded"
    assert fs.relabel == "lex"
    assert fs.grid_shapes == [(4, 4, 4), (8, 8, 8)]
    assert len(fs.band_offsets) == 7
    res = fs.mg.solve_cg(fs.b, rtol=RTOL, maxiter=100)
    assert res.iterations == ref["iterations"]
    assert np.abs(res.x.numpy() - ref["x"]).max() <= 1e-13


def test_structured_refuses_another_numbering():
    """The structured hierarchy is numbered lexicographically: asking it
    for the leaf-rank numbering raises instead of being ignored."""
    with pytest.raises(ValueError, match="lexicographically"):
        setup_flagship(n=4, device=CPU, hierarchy="structured", relabel=None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_matches_unsharded_and_jax(ranks, jax_ref, case):
    world, results = ranks
    r, ref = results[case], jax_ref[JAX_OF[case]]
    assert r["n_dev"] == world
    assert r["iterations"] == r["unsharded_iterations"] == ref["iterations"]
    assert r["residual"] <= RTOL * r["bnorm"]
    assert r["max_abs_diff"] <= 1e-9
    assert np.abs(r["x"] - ref["x"]).max() <= 1e-9
    vc, vu = r["v_cycle"], r["v_cycle_unsharded"]
    assert np.abs(vc - vu).max() <= 1e-12 * np.abs(vu).max()
    kinds = [m[0] for m in r["meta"]]
    if case == "packed":
        assert kinds == ["packed", "packed"]  # the 64- and 512-lane levels
    elif case == "packed512":
        assert kinds[-1] == "packed" and "packed" not in kinds[:-1]
    else:
        assert set(kinds) == {"banded"}
    if world == 2 and case == "structured":
        # the JAX package's ShardedBandedSystem on 2 devices
        x, k = ref["sharded2"]
        assert k == r["iterations"]
        assert np.abs(x - r["x"]).max() <= 1e-9
    if world == 4 and case.startswith("packed"):
        # the plans reach beyond a shard: repacked with a far tail
        assert r["meta"][-1][3] and r["meta"][-1][4]
        assert r["fine_max_offset"] > r["meta"][-1][1]


@pytest.mark.parametrize("case", ["structured", "lex", "packed512"])
def test_level_metadata_matches_jax(ranks, jax_ref, case):
    world, results = ranks
    r, ref = results[case], jax_ref[JAX_OF[case]]
    assert r["meta"] == ref["meta"][world]
    assert r["comm"] == ref["comm"][world]

