"""The port's jax-free host copies against the JAX package's originals.

Mesh, R-tree, handler arrays, the lex-relabelled and the structured
hierarchies, grid-shape detection, the slot-padded banded tables, the
sharded solve's halo send lists, the monodomain configuration, the
partitioners and graph repair, the simplex meshes and the quality metrics
must be EXACTLY equal: the port's host modules are copies that differ only
in their imports.  Also checks that the port imports neither jax nor the
JAX package.
"""

import dataclasses

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu.config as jcfg  # noqa: E402
import polydeal_tpu.metrics as jmetrics  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
import polydeal_tpu_torch.config as tcfg  # noqa: E402
import polydeal_tpu_torch.metrics as tmetrics  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.agglomeration import graph as jgraph  # noqa: E402
from polydeal_tpu.agglomeration import partition as jpart  # noqa: E402
from polydeal_tpu.mesh import simplex as jsimplex  # noqa: E402
from polydeal_tpu.assembly.sipg import build_banded_groups  # noqa: E402
from polydeal_tpu.parallel.sharding import (  # noqa: E402
    build_halo_exchange,
)
from polydeal_tpu.solvers import (  # noqa: E402
    build_rtree_hierarchy,
    build_structured_hierarchy,
    detect_grid_shapes,
)
from polydeal_tpu_torch.agglomeration import (  # noqa: E402
    RTreeAgglomerator as TRTreeAgglomerator,
)
from polydeal_tpu_torch.agglomeration import graph as tgraph  # noqa: E402
from polydeal_tpu_torch.agglomeration import partition as tpart  # noqa: E402
from polydeal_tpu_torch.mesh import simplex as tsimplex  # noqa: E402
from polydeal_tpu_torch.assembly.sipg import (  # noqa: E402
    build_banded_groups as t_build_banded_groups,
)
from polydeal_tpu_torch.parallel import sharding as tsh  # noqa: E402
from polydeal_tpu_torch.solvers import multigrid as tmg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {
    "cube3d_8": lambda m: m.hyper_cube(3, 8),
    "square2d_16": lambda m: m.hyper_cube(2, 16),
    "distorted2d_8": lambda m: m.distort_random(m.hyper_cube(2, 8), 0.15,
                                                seed=4),
}


def _meshes(name):
    return MESHES[name](pd), MESHES[name](tpd)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_equal(name):
    m, t = _meshes(name)
    assert _eq(m.vertices, t.vertices) and _eq(m.cells, t.cells)
    assert _eq(m.neighbors, t.neighbors)
    assert _eq(m.cell_centers(), t.cell_centers())
    for a, b in zip(m.volume_quadrature(2), t.volume_quadrature(2)):
        assert _eq(a, b)
    for a, b in zip(m.face_quadrature(2), t.face_quadrature(2)):
        assert _eq(a, b)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rtree_equal(name):
    m, t = _meshes(name)
    a = RTreeAgglomerator.build(m.cell_centers())
    b = TRTreeAgglomerator.build(t.cell_centers())
    assert a.n_levels == b.n_levels
    for lv in range(a.n_levels + 1):  # past the leaves clamps
        assert _eq(a.extract_agglomerates(lv), b.extract_agglomerates(lv))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_handler_equal(name, degree):
    m, t = _meshes(name)
    c2p = RTreeAgglomerator.build(m.cell_centers()).extract_agglomerates(2)
    ha = pd.AgglomerationHandler(m, c2p, degree=degree)
    hb = tpd.AgglomerationHandler(t, c2p, degree=degree)
    assert ha.n_poly == hb.n_poly and ha.n_basis == hb.n_basis
    for attr in ("cell2poly", "poly2cells", "poly_n_cells", "bbox_lo",
                 "bbox_hi", "extents", "diameters", "volumes",
                 "cell_qpoints_real", "cell_qpoints_unit", "cell_qweights"):
        assert _eq(getattr(ha, attr), getattr(hb, attr)), attr
    for attr in ("poly_in", "poly_out", "points_real", "points_in",
                 "points_out", "weights", "normals", "h_f", "boundary_id"):
        assert _eq(getattr(ha.faces, attr), getattr(hb.faces, attr)), attr


def _hierarchies(name, degree=1):
    m, t = _meshes(name)
    agg = RTreeAgglomerator.build(m.cell_centers())
    tagg = TRTreeAgglomerator.build(t.cell_centers())
    levels = list(range(1, agg.n_levels - 1))
    ha, pa = build_rtree_hierarchy(m, agg, levels, degree=degree,
                                   relabel="lex")
    hb, pb = tmg.build_rtree_hierarchy(t, tagg, levels, degree=degree,
                                       relabel="lex")
    return ha, pa, hb, pb


@pytest.mark.parametrize("name", sorted(MESHES))
def test_hierarchy_and_grid_shapes_equal(name):
    ha, pa, hb, pb = _hierarchies(name)
    assert len(ha) == len(hb) and len(pa) == len(pb)
    for a, b in zip(ha, hb):
        assert _eq(a.cell2poly, b.cell2poly)
    for a, b in zip(pa, pb):
        assert _eq(a, b)
    ga, gb = detect_grid_shapes(ha, pa), tmg.detect_grid_shapes(hb, pb)
    assert ga == gb
    if name != "distorted2d_8":
        assert ga is not None  # lex levels of a uniform grid are grids


@pytest.mark.parametrize("dim,n,side", [(2, 16, 2), (3, 8, 2), (3, 8, 4)])
def test_structured_hierarchy_equal(dim, n, side):
    m, t = pd.hyper_cube(dim, n), tpd.hyper_cube(dim, n)
    ha, pa, ga = build_structured_hierarchy(m, n, degree=1,
                                            coarsest_side=side)
    hb, pb, gb = tmg.build_structured_hierarchy(t, n, degree=1,
                                                coarsest_side=side)
    assert len(ha) == len(hb) and len(pa) == len(pb) and ga == gb
    for a, b in zip(ha, hb):
        assert _eq(a.cell2poly, b.cell2poly)
        assert a.n_poly == b.n_poly and a.n_basis == b.n_basis
    for a, b in zip(pa, pb):
        assert _eq(a, b)
    with pytest.raises(ValueError):
        tmg.build_structured_hierarchy(t, n // 2)  # not the mesh's side


@pytest.mark.parametrize("n_dev,per,nnz", [(2, 32, 40), (4, 16, 24),
                                           (8, 8, 12)])
def test_halo_exchange_equal(n_dev, per, nnz):
    """Seeded column sets, local and remote, padded with local columns as
    the sharded far tail pads them."""
    rng = np.random.default_rng(n_dev)
    cols = rng.integers(0, n_dev * per, size=(n_dev, nnz))
    cols[:, -3:] = (np.arange(n_dev) * per)[:, None]
    a, b = build_halo_exchange(cols, per, n_dev), tsh.build_halo_exchange(
        cols, per, n_dev)
    assert _eq(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]
    assert len(a[3]) == len(b[3]) and all(_eq(x, y)
                                          for x, y in zip(a[3], b[3]))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_banded_groups_equal(name):
    ha, _, hb, _ = _hierarchies(name)
    for a, b in zip(ha, hb):
        ft = a.faces
        interior = ~ft.is_boundary
        diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
        offs = np.unique(np.concatenate([diffs, -diffs, np.zeros(1, int)]))
        ga = build_banded_groups(a, offs, jnp.float64)
        gb = t_build_banded_groups(b, offs, torch.float64,
                                   device=torch.device("cpu"))
        assert sorted(ga["groups"]) == sorted(gb["groups"])
        assert (ga["bdry"] is None) == (gb["bdry"] is None)
        pairs = [(ga["vol"], gb["vol"]), (ga["bdry"] or {}, gb["bdry"] or {})]
        pairs += [(ga["groups"][o], gb["groups"][o]) for o in ga["groups"]]
        pairs += [({"e": ga["ext_t"], "l": ga["lo_t"]},
                   {"e": gb["ext_t"], "l": gb["lo_t"]})]
        for da, db in pairs:
            assert sorted(da) == sorted(db)
            for k in da:
                assert _eq(np.asarray(da[k]), db[k].numpy()), k


@pytest.mark.parametrize("strategy", ["rcb", "greedy", "multilevel"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_partition_equal(name, strategy):
    """Partition labels, with and without the connectivity repair, and the
    graph helpers on them."""
    m, t = _meshes(name)
    n_parts = max(m.n_cells // 7, 2)
    for repair in (False, True):
        a = jpart.agglomerate_by_partition(m.cell_centers(), m.neighbors,
                                           n_parts, strategy, repair)
        b = tpart.agglomerate_by_partition(t.cell_centers(), t.neighbors,
                                           n_parts, strategy, repair)
        assert _eq(a, b)
    # a deliberately disconnected labelling, repaired
    lab = (np.arange(m.n_cells) % 3).astype(np.int32)
    assert _eq(jgraph.split_disconnected(lab, m.neighbors),
               tgraph.split_disconnected(lab, t.neighbors))
    assert _eq(jgraph.compact_labels(lab[::-1] * 5),
               tgraph.compact_labels(lab[::-1] * 5))
    cells = np.flatnonzero(lab == 1)
    ca = jgraph.connected_components(cells, m.neighbors)
    cb = tgraph.connected_components(cells, t.neighbors)
    assert len(ca) == len(cb) and all(_eq(x, y) for x, y in zip(ca, cb))
    assert (jgraph.adjacency_matrix(m.n_cells, m.neighbors)
            != tgraph.adjacency_matrix(t.n_cells, t.neighbors)).nnz == 0


@pytest.mark.parametrize("dim,n", [(2, 4), (3, 2)])
def test_simplex_equal(dim, n):
    """Simplex connectivity and quadrature, and the handler taking a
    SimplexMesh as the JAX one does."""
    a = jsimplex.triangulated_hyper_cube(dim, n)
    b = tsimplex.triangulated_hyper_cube(dim, n)
    assert _eq(a.vertices, b.vertices) and _eq(a.cells, b.cells)
    assert _eq(a.neighbors, b.neighbors)
    assert _eq(a.face_vertex_ids(), b.face_vertex_ids())
    assert _eq(a.boundary_vertex_mask(), b.boundary_vertex_mask())
    assert _eq(a.cell_measures(), b.cell_measures())
    for x, y in zip(a.volume_quadrature(2), b.volume_quadrature(2)):
        assert _eq(x, y)
    for x, y in zip(a.face_quadrature(2), b.face_quadrature(2)):
        assert _eq(x, y)
    c2p = jpart.agglomerate_by_partition(a.cell_centers(), a.neighbors, 4)
    ha = pd.AgglomerationHandler(a, c2p, degree=1)
    hb = tpd.AgglomerationHandler(b, c2p, degree=1)
    for attr in ("bbox_lo", "extents", "cell_qpoints_unit",
                 "cell_qweights"):
        assert _eq(getattr(ha, attr), getattr(hb, attr)), attr
    for attr in ("poly_in", "poly_out", "points_in", "weights", "normals"):
        assert _eq(getattr(ha.faces, attr), getattr(hb.faces, attr)), attr


@pytest.mark.parametrize("name", ["square2d_16", "distorted2d_8",
                                  "cube3d_8"])
def test_metrics_equal(name):
    """The quality metrics (sampled; exact in 2D) and the face-orthogonal
    penalty lengths."""
    m, t = _meshes(name)
    c2p = RTreeAgglomerator.build(m.cell_centers()).extract_agglomerates(2)
    ha = pd.AgglomerationHandler(m, c2p, degree=1)
    hb = tpd.AgglomerationHandler(t, c2p, degree=1)
    methods = ("sampled", "exact") if m.dim == 2 else ("sampled",)
    for method in methods:
        qa = jmetrics.compute_quality_metrics(ha, method)
        qb = tmetrics.compute_quality_metrics(hb, method)
        assert sorted(qa) == sorted(qb)
        for k in qa:
            assert _eq(qa[k], qb[k]), (method, k)
        assert _eq(jmetrics.face_h_orthogonal(ha, method),
                   tmetrics.face_h_orthogonal(hb, method))
    assert (jmetrics.compute_h_orthogonal(ha)
            == tmetrics.compute_h_orthogonal(hb))


def test_config_copy_equal():
    """Every config class has the same fields and defaults, and both
    packages read each other's text."""
    for name in jcfg.__all__:
        a, b = getattr(jcfg, name), getattr(tcfg, name)
        if dataclasses.is_dataclass(a):
            assert ([(f.name, f.type) for f in dataclasses.fields(a)]
                    == [(f.name, f.type) for f in dataclasses.fields(b)])
            assert jcfg.to_text(a()) == tcfg.to_text(b())
    text = jcfg.to_text(jcfg.MonodomainConfig(dim=3, degree=2))
    assert tcfg.to_text(tcfg.from_text(text)) == text


def test_port_never_imports_jax():
    """``import polydeal_tpu_torch`` plus a full small flagship solve, a
    packed one without the relabel, two monodomain steps, a sharded solve
    (one shard, structured hierarchy), the COO path's Poisson solves (R3MG
    and block-Jacobi CG) and a diffusion-reaction convergence study leave
    jax and the JAX package out of sys.modules."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import polydeal_tpu_torch\n"
        "import polydeal_tpu_torch.interop\n"
        "import polydeal_tpu_torch.models.profile_flagship\n"
        "import polydeal_tpu_torch.ops.packed\n"
        "import polydeal_tpu_torch.config\n"
        "import polydeal_tpu_torch.checkpoint\n"
        "from polydeal_tpu_torch.models.monodomain import (\n"
        "    MonodomainConfig, MonodomainSolver)\n"
        "from polydeal_tpu_torch.sparse import BlockPacked\n"
        "from polydeal_tpu_torch.solvers import multigrid\n"
        "from polydeal_tpu_torch.models.flagship import (setup_flagship,\n"
        "                                                solve_flagship)\n"
        "fs = setup_flagship(n=4, device=torch.device('cpu'),\n"
        "                    dtype=torch.float64, precond_dtype=None)\n"
        "res = solve_flagship(fs)\n"
        "assert res.iterations > 0\n"
        "multigrid.PACK_MIN_P = 0\n"
        "fs = setup_flagship(n=8, device=torch.device('cpu'),\n"
        "                    dtype=torch.float64, precond_dtype=None,\n"
        "                    relabel=None)\n"
        "assert isinstance(fs.mg.ells[-1], BlockPacked)\n"
        "assert solve_flagship(fs).iterations > 0\n"
        "s = MonodomainSolver.build(MonodomainConfig(n_refinements=3),\n"
        "                           device=torch.device('cpu'))\n"
        "assert len(s.run(n_steps=2)[2]) == 2\n"
        "import polydeal_tpu_torch.parallel\n"
        "from polydeal_tpu_torch.models.sharded import setup_sharded\n"
        "sh = setup_sharded(n=4, device=torch.device('cpu'),\n"
        "                   dtype=torch.float64, precond_dtype=None)\n"
        "assert sh.ss.solve_cg(sh.b)[1] > 0\n"
        "import polydeal_tpu_torch.agglomeration, polydeal_tpu_torch.metrics\n"
        "import polydeal_tpu_torch.mesh, polydeal_tpu_torch.postprocess\n"
        "import polydeal_tpu_torch.models.benchmarks\n"
        "import polydeal_tpu_torch.models.metrics_study\n"
        "import polydeal_tpu_torch.utils.timer\n"
        "from polydeal_tpu_torch.models.poisson import solve_poisson\n"
        "from polydeal_tpu_torch.models.diffusion_reaction import (\n"
        "    convergence_study)\n"
        "cpu = torch.device('cpu')\n"
        "assert solve_poisson(dim=2, n=8, verbose=False,\n"
        "                     device=cpu)['iterations'] > 0\n"
        "assert solve_poisson(dim=2, n=8, strategy='metis', solver='cg',\n"
        "                     verbose=False, device=cpu)['iterations'] > 0\n"
        "assert len(convergence_study(sizes=(4, 8), verbose=False,\n"
        "                             device=cpu)[1]) == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'polydeal_tpu')]\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_amg_host_setup_equals_jax():
    """SA-AMG's host setup (strength graph, native and fallback
    aggregation, tentative prolongator with its batched QR) on a seeded
    random SPD block matrix: EXACTLY the JAX package's."""
    import scipy.sparse as sp

    from polydeal_tpu.solvers import amg as jamg
    from polydeal_tpu_torch.solvers import amg as tamg

    rng = np.random.default_rng(11)
    n, nb = 120, 3
    ij = rng.integers(0, n, size=(2, 400))
    g = sp.csr_matrix((np.ones(ij.shape[1]), (ij[0], ij[1])), shape=(n, n))
    g = ((g + g.T) > 0).astype(np.float64)
    blocks = sp.kron(g, np.ones((nb, nb))) * sp.csr_matrix(
        rng.uniform(-1, 0, (n * nb, n * nb)))
    M = (blocks + blocks.T + sp.identity(n * nb) * (4 * nb * 6.0)).tocsr()
    a = jamg._strength_graph(M, nb, 0.02)
    b = tamg._strength_graph(M, nb, 0.02)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    la, lb = jamg._aggregate(*a, n), tamg._aggregate(*b, n)
    assert np.array_equal(la, lb)
    B = np.tile(np.eye(nb), (n, 1))
    Pa, Ba = jamg._tentative(np.repeat(la, nb), B, int(la.max()) + 1)
    Pb, Bb = tamg._tentative(np.repeat(lb, nb), B, int(lb.max()) + 1)
    for attr in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(Pa, attr), getattr(Pb, attr))
    assert np.array_equal(Ba, Bb)
    assert jamg._power_lambda_max(M) == tamg._power_lambda_max(M)
