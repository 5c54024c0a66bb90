"""Export utilities: VTU, polygon CSV, MatrixMarket, SVG grid dumps.

A jax-free copy of ``polydeal_tpu/io.py`` (host work only; the files are
byte-identical to the JAX package's, ``tests/test_torch_io.py``): the
rebuild of the reference's I/O layer (reference include/poly_utils.h:
861-891 ``export_polygon_to_csv_file``, :905-925
``write_to_matrix_market_format``; VTU/PVTU output in the examples, e.g.
examples/poisson.cc:1003-1056; SVG grid dumps colored by agglomerate,
examples/poisson.cc:617-629) without deal.II's DataOut/GridOut: plain
writers over the array data model.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "export_polygon_csv",
    "write_matrix_market",
    "write_vtu",
    "write_svg",
]


def export_polygon_csv(handler, path: str):
    """Write the boundary fine-face segments of every polytope to CSV.

    Format per row: ``poly_id, x0, y0, x1, y1`` (2D) — each row is one
    fine-face segment of a polytopal boundary, like the reference's
    polygon CSV dumps (meshes/csvs/polygonrtree_*.csv).
    """
    if handler.dim != 2:
        raise NotImplementedError("CSV polygon export is 2D")
    mesh = handler.mesh
    ft = handler.faces
    # endpoint vertices of each face's fine edge: reconstruct from the
    # face quadrature extremes is lossy; use cell faces' vertex ids
    fv = mesh.face_vertex_ids()  # [n_c, 4, 2]
    nb = mesh.neighbors
    c2p = handler.cell2poly
    rows = []
    for c in range(mesh.n_cells):
        for f in range(4):
            n = nb[c, f]
            if n >= 0 and c2p[n] == c2p[c]:
                continue  # internal to a polytope
            v0, v1 = fv[c, f]
            p0, p1 = mesh.vertices[v0], mesh.vertices[v1]
            rows.append((int(c2p[c]), p0[0], p0[1], p1[0], p1[1]))
    with open(path, "w") as fh:
        fh.write("poly,x0,y0,x1,y1\n")
        for r in rows:
            fh.write(f"{r[0]},{r[1]:.16g},{r[2]:.16g},{r[3]:.16g},{r[4]:.16g}\n")
    return len(rows)


def write_svg(handler, path: str, width: int = 800):
    """SVG dump of the 2D agglomerated grid, cells colored by polytope —
    the analogue of the reference's ``GridOut::write_svg`` with
    coloring by agglomerate (reference examples/poisson.cc:617-629).

    Fine-cell edges are drawn thin, polytopal boundaries (edges whose two
    cells belong to different polytopes, or domain boundary) thick."""
    if handler.dim != 2:
        raise NotImplementedError("SVG grid export is 2D")
    mesh = handler.mesh
    c2p = np.asarray(handler.cell2poly)
    verts = np.asarray(mesh.vertices, dtype=float)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    ext = np.maximum(hi - lo, 1e-300)
    scale = (width - 20) / ext.max()
    H = int(ext[1] * scale) + 20

    def xy(p):
        # flip y: SVG's origin is top-left
        return (10 + (p[0] - lo[0]) * scale, H - 10 - (p[1] - lo[1]) * scale)

    # deterministic distinguishable colors per polytope (golden-angle hue)
    def color(pid):
        h = (pid * 0.618033988749895) % 1.0
        i = int(h * 6)
        f = h * 6 - i
        v, p_, q, t = 255, int(255 * 0.45), int(255 * (1 - 0.55 * f)), \
            int(255 * (0.45 + 0.55 * f))
        rgb = [(v, t, p_), (q, v, p_), (p_, v, t),
               (p_, q, v), (t, p_, v), (v, p_, q)][i % 6]
        return f"rgb({rgb[0]},{rgb[1]},{rgb[2]})"

    fv = mesh.face_vertex_ids()  # [n_c, 4, 2]
    nbs = mesh.neighbors
    cells = np.asarray(mesh.cells)
    with open(path, "w") as fh:
        fh.write(f'<svg xmlns="http://www.w3.org/2000/svg" '
                 f'width="{width}" height="{H}">\n')
        # fill each fine cell with its polytope color (vertex order
        # 0,1,3,2 walks the quad boundary)
        for c in range(mesh.n_cells):
            pts = [xy(verts[cells[c, k]]) for k in (0, 1, 3, 2)]
            d = " ".join(f"{x:.2f},{y:.2f}" for x, y in pts)
            fh.write(f'<polygon points="{d}" fill="{color(int(c2p[c]))}" '
                     'stroke="rgb(120,120,120)" stroke-width="0.3"/>\n')
        # thick polytopal boundaries
        for c in range(mesh.n_cells):
            for f in range(4):
                n = nbs[c, f]
                if n >= 0 and c2p[n] == c2p[c]:
                    continue
                if 0 <= n < c:
                    continue  # draw each interface once
                (x0, y0), (x1, y1) = (xy(verts[v]) for v in fv[c, f])
                fh.write(f'<line x1="{x0:.2f}" y1="{y0:.2f}" '
                         f'x2="{x1:.2f}" y2="{y1:.2f}" '
                         'stroke="black" stroke-width="1.6"/>\n')
        fh.write("</svg>\n")
    return handler.n_poly


def write_matrix_market(A, path: str):
    """Write a ``sparse.BlockMatrix`` in MatrixMarket coordinate format
    (reference poly_utils.h:905-925).  Its blocks are copied to a host
    array once; no device work."""
    data = A.data.detach().cpu().numpy()
    nb_r, nb_c = data.shape[1], data.shape[2]
    n_rows, n_cols = A.shape
    entries = []
    for k in range(data.shape[0]):
        r0, c0 = A.rows[k] * nb_r, A.cols[k] * nb_c
        blk = data[k]
        for i in range(nb_r):
            for j in range(nb_c):
                v = blk[i, j]
                if v != 0.0:
                    entries.append((r0 + i + 1, c0 + j + 1, v))
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate real general\n")
        fh.write(f"{n_rows} {n_cols} {len(entries)}\n")
        for r, c, v in entries:
            fh.write(f"{r} {c} {v:.16e}\n")
    return len(entries)


def write_vtu(mesh, path: str, point_data=None, cell_data=None):
    """Minimal VTU (XML unstructured grid, ascii) writer for quads/hexes.

    cell_data: dict name -> [n_cells] array (e.g. polytope ids, per-cell
    solution means); point_data: dict name -> [n_vertices] array.  An
    array of another length raises (the file would not match its
    mesh).
    """
    dim = mesh.dim
    n_c, n_v = mesh.n_cells, mesh.n_vertices
    for data, n, what in ((cell_data, n_c, "cell"),
                          (point_data, n_v, "point")):
        for name, a in (data or {}).items():
            if np.asarray(a).size != n:
                raise ValueError(f"{what} data {name!r} has "
                                 f"{np.asarray(a).size} values for {n} "
                                 f"{what}s")
    # VTK ordering: quad 0,1,3,2 ; hexahedron 0,1,3,2,4,5,7,6
    if dim == 2:
        order, vtk_type = [0, 1, 3, 2], 9
    else:
        order, vtk_type = [0, 1, 3, 2, 4, 5, 7, 6], 12
    pts3 = np.zeros((n_v, 3))
    pts3[:, :dim] = mesh.vertices
    conn = mesh.cells[:, order]

    def arr(a, fmt="%.9g"):
        return " ".join(fmt % v for v in np.asarray(a).ravel())

    with open(path, "w") as fh:
        fh.write('<?xml version="1.0"?>\n')
        fh.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        fh.write(f'<Piece NumberOfPoints="{n_v}" NumberOfCells="{n_c}">\n')
        fh.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                 'format="ascii">\n')
        fh.write(arr(pts3))
        fh.write("\n</DataArray></Points>\n<Cells>\n")
        fh.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        fh.write(arr(conn, "%d"))
        fh.write('\n</DataArray>\n<DataArray type="Int64" Name="offsets" '
                 'format="ascii">\n')
        fh.write(arr(np.arange(1, n_c + 1) * len(order), "%d"))
        fh.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" '
                 'format="ascii">\n')
        fh.write(arr(np.full(n_c, vtk_type), "%d"))
        fh.write("\n</DataArray>\n</Cells>\n")
        if cell_data:
            fh.write("<CellData>\n")
            for name, a in cell_data.items():
                fh.write(f'<DataArray type="Float64" Name="{name}" '
                         'format="ascii">\n')
                fh.write(arr(a))
                fh.write("\n</DataArray>\n")
            fh.write("</CellData>\n")
        if point_data:
            fh.write("<PointData>\n")
            for name, a in point_data.items():
                fh.write(f'<DataArray type="Float64" Name="{name}" '
                         'format="ascii">\n')
                fh.write(arr(a))
                fh.write("\n</DataArray>\n")
            fh.write("</PointData>\n")
        fh.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
