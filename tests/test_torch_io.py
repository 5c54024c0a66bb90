"""The port's io, accessor and gmsh reader against the JAX package's.

``polydeal_tpu_torch/io.py``, ``accessor.py`` and ``mesh/gmsh_io.py`` are
jax-free copies of the JAX package's modules (host work only), with two
reference faults not copied:

* the binary gmsh readers walk the file by its section headers and skip
  element types the mesh does not use, as the ASCII readers do (the JAX
  package's raise on a 9-node quad; checked below);
* ``write_vtu`` refuses an array whose length is not the count of cells or
  vertices it writes (the JAX piston's ``--vtu`` hands it per-cell nodal
  values as point data, with the path and the mesh swapped).

Checked here: the io cases of ``tests/test_postprocess_io.py`` with files
byte-identical to the JAX package's on the same inputs; the cases of
``tests/test_gmsh.py`` (ASCII v2.2, boundary ids, binary v2.2 and v4.1)
through both readers, an unstructured v4.1 ASCII grid solved to the SIPG
linear-exactness invariant (the reference's t3 grid is not in the repo);
the accessor cases of ``tests/test_accessor_checkpoint.py`` through both
packages' accessors.
"""

import os
import struct
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import polydeal_tpu as pd  # noqa: E402
import polydeal_tpu_torch as tpd  # noqa: E402
from polydeal_tpu import io as jio  # noqa: E402
from polydeal_tpu.accessor import Polytope as JPolytope  # noqa: E402
from polydeal_tpu.accessor import polytope_iterators as jiter  # noqa: E402
from polydeal_tpu.agglomeration import RTreeAgglomerator  # noqa: E402
from polydeal_tpu.agglomeration import agglomerate_by_partition  # noqa: E402
from polydeal_tpu.assembly import assemble_sipg_matrix  # noqa: E402
from polydeal_tpu.mesh.gmsh_io import read_msh as jread  # noqa: E402
from polydeal_tpu_torch import interop  # noqa: E402
from polydeal_tpu_torch import io as tio  # noqa: E402
from polydeal_tpu_torch.accessor import Polytope as TPolytope  # noqa: E402
from polydeal_tpu_torch.accessor import polytope_iterators as titer  # noqa: E402,E501
from polydeal_tpu_torch.assembly import sipg as tsipg  # noqa: E402
from polydeal_tpu_torch.mesh.gmsh_io import read_msh as tread  # noqa: E402
from polydeal_tpu_torch.postprocess import compute_global_error  # noqa: E402
from polydeal_tpu_torch.solvers import (  # noqa: E402
    block_jacobi_preconditioner,
    cg_solve,
)

CPU = torch.device("cpu")


def quad_handlers(n=4, degree=1):
    """(JAX, port) handlers of test_postprocess_io.py's 2x2 quadrants."""
    m, t = pd.hyper_cube(2, n), tpd.hyper_cube(2, n)
    centers = m.cell_centers()
    c2p = (centers[:, 0] > 0.5).astype(np.int32) + 2 * (centers[:, 1] > 0.5)
    return (pd.AgglomerationHandler(m, c2p, degree=degree),
            tpd.AgglomerationHandler(t, c2p, degree=degree))


def _same_file(tmp_path, name, write_jax, write_port):
    """Both packages write ``name``; the files are byte-identical.  Returns
    (the port's return value, the file's text)."""
    pj, pt = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    rj = write_jax(str(pj))
    rt = write_port(str(pt))
    assert rj == rt
    assert pj.read_bytes() == pt.read_bytes()
    return rt, pt.read_text()


# ---- io --------------------------------------------------------------------


def test_export_polygon_csv(tmp_path):
    ha, hb = quad_handlers(4)
    n, text = _same_file(tmp_path, "poly.csv",
                         lambda p: jio.export_polygon_csv(ha, p),
                         lambda p: tio.export_polygon_csv(hb, p))
    lines = text.strip().splitlines()
    assert lines[0] == "poly,x0,y0,x1,y1"
    # 4 quadrants x perimeter 2 / fine edge 0.25 = 8 segments each
    assert n == 32 and len(lines) == 33


def test_write_svg(tmp_path):
    m = pd.distort_random(pd.hyper_cube(2, 6), 0.1, seed=3)
    t = tpd.distort_random(tpd.hyper_cube(2, 6), 0.1, seed=3)
    c2p = agglomerate_by_partition(m.cell_centers(), m.neighbors, 5)
    ha = pd.AgglomerationHandler(m, c2p, degree=1)
    hb = tpd.AgglomerationHandler(t, c2p, degree=1)
    n, text = _same_file(tmp_path, "grid.svg",
                         lambda p: jio.write_svg(ha, p),
                         lambda p: tio.write_svg(hb, p))
    assert n == 5 and text.startswith("<svg") and "<polygon" in text


def test_write_matrix_market(tmp_path):
    """The port's BlockMatrix carrying the JAX matrix's arrays writes the
    same file; the port's own assembled matrix reads back to its dense
    form."""
    ha, hb = quad_handlers(2)
    A = assemble_sipg_matrix(ha)
    Ab = interop.block_matrix_from_arrays(A.data, A.rows, A.cols,
                                          A.n_block_rows, A.n_block_cols,
                                          device=CPU)
    _same_file(tmp_path, "A.mtx", lambda p: jio.write_matrix_market(A, p),
               lambda p: tio.write_matrix_market(Ab, p))
    At = tsipg.assemble_sipg_matrix(hb, device=CPU)
    path = tmp_path / "At.mtx"
    n = tio.write_matrix_market(At, str(path))
    lines = path.read_text().splitlines()
    assert lines[0].startswith("%%MatrixMarket")
    rows, cols, nnz = map(int, lines[1].split())
    assert rows == hb.n_dofs and nnz == n
    dense = np.zeros((rows, cols))
    for ln in lines[2:]:
        r, c, v = ln.split()
        dense[int(r) - 1, int(c) - 1] = float(v)
    assert np.allclose(dense, At.to_dense().numpy(), atol=1e-12)


def test_write_vtu(tmp_path):
    m = pd.distort_random(pd.hyper_cube(2, 4), 0.1, seed=1)
    t = tpd.distort_random(tpd.hyper_cube(2, 4), 0.1, seed=1)
    c2p = RTreeAgglomerator.build(m.cell_centers()).extract_agglomerates(1)
    _, text = _same_file(
        tmp_path, "mesh.vtu",
        lambda p: jio.write_vtu(m, p, cell_data={"poly": c2p.astype(float)}),
        lambda p: tio.write_vtu(t, p, cell_data={"poly": c2p.astype(float)}))
    assert "<VTKFile" in text and 'Name="poly"' in text
    assert text.count("</DataArray>") >= 5


def test_write_vtu_3d(tmp_path):
    m, t = pd.hyper_cube(3, 2), tpd.hyper_cube(3, 2)
    pts = np.arange(t.n_vertices, dtype=float)
    _, text = _same_file(
        tmp_path, "mesh3.vtu",
        lambda p: jio.write_vtu(m, p, cell_data={"id": np.arange(8.0)},
                                point_data={"v": pts}),
        lambda p: tio.write_vtu(t, p, cell_data={"id": np.arange(8.0)},
                                point_data={"v": pts}))
    assert "12" in text  # hexahedron type


def test_write_vtu_refuses_wrong_lengths(tmp_path):
    """Per-cell nodal values [n_cells, 8] as point data, the JAX piston's
    ``--vtu`` call: refused, as is a cell array of the vertex count."""
    t = tpd.hyper_cube(3, 2)
    path = str(tmp_path / "bad.vtu")
    with pytest.raises(ValueError, match="point data"):
        tio.write_vtu(t, path, point_data={"u": np.zeros((t.n_cells, 8))})
    with pytest.raises(ValueError, match="cell data"):
        tio.write_vtu(t, path, cell_data={"u": np.zeros(t.n_vertices)})
    assert not os.path.exists(path)


# ---- gmsh ------------------------------------------------------------------

V2_QUAD = textwrap.dedent("""\
    $MeshFormat
    2.2 0 8
    $EndMeshFormat
    $Nodes
    9
    1 0 0 0
    2 0.5 0 0
    3 1 0 0
    4 0 0.5 0
    5 0.5 0.5 0
    6 1 0.5 0
    7 0 1 0
    8 0.5 1 0
    9 1 1 0
    $EndNodes
    $Elements
    4
    1 3 2 0 1 1 2 5 4
    2 3 2 0 1 2 3 6 5
    3 3 2 0 1 4 5 8 7
    4 3 2 0 1 5 6 9 8
    $EndElements
    """)

V2_IDS = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
9
1 0 0 0
2 0.5 0 0
3 1 0 0
4 0 0.5 0
5 0.5 0.5 0
6 1 0.5 0
7 0 1 0
8 0.5 1 0
9 1 1 0
$EndNodes
$Elements
8
1 1 2 7 0 1 2
2 1 2 7 0 2 3
3 1 2 9 0 1 4
4 1 2 9 0 4 7
5 3 2 1 0 1 2 5 4
6 3 2 1 0 2 3 6 5
7 3 2 1 0 4 5 8 7
8 3 2 1 0 5 6 9 8
$EndElements
"""

_COORDS = [(0, 0), (.5, 0), (1, 0), (0, .5), (.5, .5), (1, .5), (0, 1),
           (.5, 1), (1, 1)]
_QUADS = ((5, (1, 2, 5, 4)), (6, (2, 3, 6, 5)), (7, (4, 5, 8, 7)),
          (8, (5, 6, 9, 8)))


def _same_mesh(ma, mb):
    assert type(ma).__name__ == type(mb).__name__
    assert ma.dim == mb.dim
    assert np.array_equal(ma.vertices, mb.vertices)
    assert np.array_equal(ma.cells, mb.cells)
    assert np.array_equal(ma.boundary_id_array(), mb.boundary_id_array())


def _sides(mesh):
    """Boundary ids by side of the unit square."""
    bids = mesh.boundary_id_array()
    centers = mesh.vertices[mesh.face_vertex_ids()].mean(axis=2)
    got = {}
    for c, f in zip(*np.where(mesh.neighbors < 0)):
        x, y = centers[c, f]
        side = ("bottom" if y < 1e-9 else "top" if y > 1 - 1e-9
                else "left" if x < 1e-9 else "right")
        got.setdefault(side, set()).add(int(bids[c, f]))
    return got


def test_read_v2_quads(tmp_path):
    p = tmp_path / "m.msh"
    p.write_text(V2_QUAD)
    m = tread(str(p))
    _same_mesh(jread(str(p)), m)
    assert m.n_cells == 4 and m.n_vertices == 9
    assert np.allclose(m.cell_measures(2).sum(), 1.0, atol=1e-13)
    assert (m.neighbors < 0).sum() == 8


def test_boundary_ids_from_physical_groups(tmp_path):
    p = tmp_path / "square_ids.msh"
    p.write_text(V2_IDS)
    m = tread(str(p))
    _same_mesh(jread(str(p)), m)
    got = _sides(m)
    assert got["bottom"] == {7} and got["left"] == {9}
    assert got["top"] == {0} and got["right"] == {0}


def _write_v2_binary(path, extra=()):
    """test_gmsh.py's binary v2.2 grid (4 quads, the boundary-id lines),
    plus ``extra`` element blocks (type, [(tag, nodes)])."""
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n2.2 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n$Nodes\n9\n")
        for tag, (x, y) in enumerate(_COORDS, start=1):
            f.write(struct.pack("<iddd", tag, x, y, 0.0))
        n_el = 8 + sum(len(els) for _, els in extra)
        f.write(f"\n$EndNodes\n$Elements\n{n_el}\n".encode())
        f.write(struct.pack("<iii", 1, 4, 2))
        for tag, phys, a, b in ((1, 7, 1, 2), (2, 7, 2, 3),
                                (3, 9, 1, 4), (4, 9, 4, 7)):
            f.write(struct.pack("<iiiii", tag, phys, 0, a, b))
        for etype, els in extra:
            f.write(struct.pack("<iii", etype, len(els), 2))
            for tag, nodes in els:
                f.write(struct.pack(f"<iii{len(nodes)}i", tag, 1, 0, *nodes))
        f.write(struct.pack("<iii", 3, 4, 2))
        for tag, conn in _QUADS:
            f.write(struct.pack("<iii", tag, 1, 0))
            f.write(struct.pack("<iiii", *conn))
        f.write(b"\n$EndElements\n")


def _write_v41_binary(path, extra=()):
    """test_gmsh.py's binary v4.1 grid (entity physical tags carry the
    boundary ids), plus ``extra`` element blocks on the surface, and a
    $PhysicalNames section (skipped)."""
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n4.1 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n$PhysicalNames\n2\n1 7 \"bottom\"\n"
                b"1 9 \"left\"\n$EndPhysicalNames\n$Entities\n")
        f.write(struct.pack("<qqqq", 0, 2, 1, 0))
        for tag, phys in ((1, 7), (2, 9)):
            f.write(struct.pack("<i", tag))
            f.write(struct.pack("<dddddd", 0, 0, 0, 1, 1, 0))
            f.write(struct.pack("<q", 1))
            f.write(struct.pack("<i", phys))
            f.write(struct.pack("<q", 0))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<dddddd", 0, 0, 0, 1, 1, 0))
        f.write(struct.pack("<q", 0))
        f.write(struct.pack("<q", 0))
        f.write(b"\n$EndEntities\n$Nodes\n")
        f.write(struct.pack("<qqqq", 1, 9, 1, 9))
        f.write(struct.pack("<iii", 2, 1, 0))
        f.write(struct.pack("<q", 9))
        for tag in range(1, 10):
            f.write(struct.pack("<q", tag))
        for x, y in _COORDS:
            f.write(struct.pack("<ddd", x, y, 0.0))
        n_el = 8 + sum(len(els) for _, els in extra)
        f.write(b"\n$EndNodes\n$Elements\n")
        f.write(struct.pack("<qqqq", 3 + len(extra), n_el, 1, n_el))
        f.write(struct.pack("<iii", 1, 1, 1))
        f.write(struct.pack("<q", 2))
        f.write(struct.pack("<qqq", 1, 1, 2))
        f.write(struct.pack("<qqq", 2, 2, 3))
        f.write(struct.pack("<iii", 1, 2, 1))
        f.write(struct.pack("<q", 2))
        f.write(struct.pack("<qqq", 3, 1, 4))
        f.write(struct.pack("<qqq", 4, 4, 7))
        for etype, els in extra:
            f.write(struct.pack("<iii", 2, 1, etype))
            f.write(struct.pack("<q", len(els)))
            for tag, nodes in els:
                f.write(struct.pack(f"<q{len(nodes)}q", tag, *nodes))
        f.write(struct.pack("<iii", 2, 1, 3))
        f.write(struct.pack("<q", 4))
        for tag, conn in _QUADS:
            f.write(struct.pack("<qqqqq", tag, *conn))
        f.write(b"\n$EndElements\n")


# a 9-node quad (gmsh type 10) over the whole square: a type the ASCII
# readers skip, on which the JAX package's binary readers raise
QUAD9 = [(10, [(9, (1, 3, 9, 7, 2, 6, 8, 4, 5))])]


@pytest.mark.parametrize("writer", [_write_v2_binary, _write_v41_binary],
                         ids=["v2", "v41"])
def test_read_binary_formats(tmp_path, writer):
    """Binary v2.2 and v4.1 give the ASCII file's mesh and boundary ids,
    through both packages' readers."""
    pa = tmp_path / "ascii.msh"
    pa.write_text(V2_QUAD)
    ma = tread(str(pa))
    pb = tmp_path / "bin.msh"
    writer(str(pb))
    mb = tread(str(pb))
    _same_mesh(jread(str(pb)), mb)
    assert mb.n_cells == 4 and mb.n_vertices == 9
    assert np.allclose(mb.vertices, ma.vertices)
    assert np.array_equal(mb.cells, ma.cells)
    got = _sides(mb)
    assert got["bottom"] == {7} and got["left"] == {9}


@pytest.mark.parametrize("writer", [_write_v2_binary, _write_v41_binary],
                         ids=["v2", "v41"])
def test_binary_skips_unused_element_types(tmp_path, writer):
    """A 9-node quad block in a binary file: skipped as the ASCII reader
    skips it (the JAX package's binary readers raise on it)."""
    plain, extra = tmp_path / "plain.msh", tmp_path / "quad9.msh"
    writer(str(plain))
    writer(str(extra), extra=QUAD9)
    _same_mesh(tread(str(plain)), tread(str(extra)))
    with pytest.raises(ValueError, match="unsupported element type 10"):
        jread(str(extra))


def _write_v41_ascii(path, mesh):
    """A 2D quad FineMesh as an ASCII v4.1 file (one surface entity, gmsh's
    counterclockwise corner order)."""
    nv, nc = mesh.n_vertices, mesh.n_cells
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat",
             "$Entities", "0 0 1 0", "1 0 0 0 1 1 0 0 0", "$EndEntities",
             "$Nodes", f"1 {nv} 1 {nv}", f"2 1 0 {nv}"]
    lines += [str(k + 1) for k in range(nv)]
    lines += [f"{float(x)!r} {float(y)!r} 0" for x, y in mesh.vertices]
    lines += ["$EndNodes", "$Elements", f"1 {nc} 1 {nc}", f"2 1 3 {nc}"]
    for c, cell in enumerate(mesh.cells):
        q = [cell[k] + 1 for k in (0, 1, 3, 2)]
        lines.append(f"{c + 1} " + " ".join(str(v) for v in q))
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_read_v41_and_solve_unstructured(tmp_path):
    """An unstructured (randomly distorted) quad grid through ASCII v4.1,
    read by both packages, agglomerated and solved in the port: SIPG
    reproduces a linear solution on general quads (the exactness invariant
    test_gmsh.py holds the reference's t3 grid to)."""
    src = tpd.distort_random(tpd.hyper_cube(2, 7), 0.2, seed=3)
    p = str(tmp_path / "distorted.msh")
    _write_v41_ascii(p, src)
    m = tread(p)
    _same_mesh(jread(p), m)
    assert np.allclose(m.vertices, src.vertices)
    assert np.array_equal(m.cells, src.cells)
    c2p = agglomerate_by_partition(m.cell_centers(), m.neighbors, 10,
                                   strategy="greedy")
    ah = tpd.AgglomerationHandler(m, c2p, degree=1, n_quad=3)
    u_ex = lambda x: 2.0 * x[..., 0] - x[..., 1] + 0.25
    A = tsipg.assemble_sipg_matrix(ah, device=CPU)
    b = tsipg.assemble_rhs(ah, lambda x: torch.zeros_like(x[..., 0]), u_ex,
                           device=CPU)
    res = cg_solve(A.matvec, b, M=block_jacobi_preconditioner(
        A.diag_blocks()), rtol=1e-13, maxiter=5000)
    l2, _ = compute_global_error(ah, res.x, u_ex)
    assert float(l2) < 1e-10, float(l2)


# ---- accessor --------------------------------------------------------------


def test_polytope_iterator_protocol():
    """Both accessors on the 2x2 quadrants agree, and the port's meets
    test_accessor_checkpoint.py's assertions."""
    ha, hb = quad_handlers()
    polys = list(titer(hb))
    jpolys = list(jiter(ha))
    assert len(polys) == len(jpolys) == 4
    for p, q in zip(polys, jpolys):
        assert p.id() == q.id() and p.n_faces() == q.n_faces()
        assert p.at_boundary() == q.at_boundary()
        for f in range(p.n_faces()):
            assert (p.neighbor(f) is None) == (q.neighbor(f) is None)
            assert p.at_boundary(f) == q.at_boundary(f)
            if p.neighbor(f) is not None:
                assert p.neighbor(f).id() == q.neighbor(f).id()
                assert (p.neighbor_of_agglomerated_neighbor(f)
                        == q.neighbor_of_agglomerated_neighbor(f))
        for name in ("diameter", "volume", "measure", "n_background_cells"):
            assert getattr(p, name)() == getattr(q, name)()
        assert np.array_equal(p.get_dof_indices(), q.get_dof_indices())
        assert np.array_equal(p.cells(), q.cells())
        for a, b in zip(p.get_bounding_box(), q.get_bounding_box()):
            assert np.array_equal(a, b)
    p0 = polys[0]
    assert p0.id() == 0 and p0.n_faces() == 3 and p0.at_boundary()
    for p in polys:
        for f in range(p.n_faces()):
            q = p.neighbor(f)
            if q is not None:
                assert q.neighbor(
                    p.neighbor_of_agglomerated_neighbor(f)).id() == p.id()
    assert p0.diameter() == pytest.approx(np.sqrt(0.5))
    assert p0.volume() == pytest.approx(0.25)
    assert p0.measure() == pytest.approx(0.25)
    assert p0.n_background_cells() == 4
    assert np.array_equal(p0.get_dof_indices(), np.arange(3))
    lo, hi = p0.get_bounding_box()
    assert np.allclose(hi - lo, 0.5)


def test_polytope_children():
    m, t = pd.hyper_cube(2, 8), tpd.hyper_cube(2, 8)
    agg = RTreeAgglomerator.build(m.cell_centers())
    c2p = agg.extract_agglomerates(1)
    parent = agg.hierarchy(1, 2)
    ch = TPolytope(tpd.AgglomerationHandler(t, c2p, degree=1), 0).children(
        parent)
    assert np.array_equal(ch, JPolytope(pd.AgglomerationHandler(
        m, c2p, degree=1), 0).children(parent))
    assert ch.shape[0] == 4 and (parent[ch] == 0).all()
