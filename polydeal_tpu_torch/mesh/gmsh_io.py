"""Minimal gmsh .msh reader (formats 2.2 and 4.1, ASCII and BINARY).

A jax-free copy of ``polydeal_tpu/mesh/gmsh_io.py`` whose binary readers
differ on purpose: they walk the file section by section from its headers
(``$Name`` ... ``$EndName``), where the JAX package finds section markers
by a raw byte search that a binary payload could match, and they skip
element types the mesh does not use as the ASCII readers do (striding over
them by gmsh's node counts), where the JAX package raises on most.

The reference consumes small gmsh grids in its tests/examples
(test/polydeal/t2.msh, t3.msh, input_grids/square.msh, the 3D piston
mesh) through deal.II ``GridIn``, which also accepts gmsh's binary
encodings.  Supports the element types the framework meshes cover:
quad(3), hexahedron(5), triangle(2), tetrahedron(4).

Boundary ids: codimension-1 elements (lines in 2D; triangles/quads in
3D) are matched by node set against the mesh's boundary faces and their
physical tag (v2.2 first tag; v4.1 entity physical tag from $Entities,
falling back to the entity tag) becomes the face boundary id — the
deal.II `GridIn` boundary-id semantics the reference relies on for
per-id boundary conditions (examples/3D_piston.cc).

Node ordering translation: gmsh quads/hexes are corner-cycled
(0,1,2,3 counterclockwise); our FineMesh uses the bit convention
(0=(0,0), 1=(1,0), 2=(0,1), 3=(1,1)) — remapped on read.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_msh"]

# gmsh element type -> (n_nodes, our mesh kind)
_LINE, _TRI, _QUAD, _TET, _HEX = 1, 2, 3, 4, 5
_N_NODES = {_LINE: 2, _TRI: 3, _QUAD: 4, _TET: 4, _HEX: 8}
# gmsh corner cycle -> bit-convention order
_REORDER = {
    _QUAD: [0, 1, 3, 2],
    _HEX: [0, 1, 3, 2, 4, 5, 7, 6],
    _TRI: [0, 1, 2],
    _TET: [0, 1, 2, 3],
}
_DIM = {_LINE: 1, _TRI: 2, _QUAD: 2, _TET: 3, _HEX: 3}


def read_msh(path: str):
    """Returns a FineMesh (quads/hexes) or SimplexMesh (tris/tets), with
    face boundary ids populated from codim-1 physical groups."""
    with open(path, "rb") as fh:
        raw = fh.read()
    # the first section, $MeshFormat: "version file_type data_size";
    # file_type 1 = binary
    c = _Cursor(raw)
    if c.header() != "MeshFormat":
        raise ValueError("a gmsh file starts with $MeshFormat")
    fmt = c.line().split()
    version = float(fmt[0])
    binary = int(fmt[1]) == 1
    if binary:
        nodes, elements = _read_bin(raw, version)
    else:
        lines = raw.decode()
        lines = lines.split("\n")
        if version >= 4.0:
            nodes, elements = _read_v4(lines)
        else:
            nodes, elements = _read_v2(lines)

    # decide element family: prefer the highest-dimensional type present
    for types, simplex in (((_HEX,), False), ((_TET,), True),
                           ((_QUAD,), False), ((_TRI,), True)):
        cells = [conn for t, conn, _tag in elements if t in types]
        if cells:
            etype = types[0]
            break
    else:
        raise ValueError("no supported volume elements in mesh")

    conn = np.asarray(cells, dtype=np.int64)[:, _REORDER[etype]]
    dim = _DIM[etype]
    # gmsh node ids may be sparse: compact them
    used = np.unique(conn)
    remap = np.full(used.max() + 1, -1, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    verts = nodes[used][:, :dim]

    # codim-1 facets with tags -> boundary-id lookup by node set
    facet_types = {2: (_LINE,), 3: (_QUAD, _TRI)}[dim]
    facet_ids = {}
    for t, cn, tag in elements:
        if t in facet_types and tag is not None:
            ids = np.asarray(cn, dtype=np.int64)
            if (ids <= used.max()).all() and (remap[ids] >= 0).all():
                facet_ids[tuple(sorted(remap[ids].tolist()))] = int(tag)

    if etype in (_TRI, _TET):
        from polydeal_tpu_torch.mesh.simplex import SimplexMesh

        mesh = SimplexMesh(dim=dim, vertices=verts,
                           cells=remap[conn].astype(np.int32))
    else:
        from polydeal_tpu_torch.mesh.fine_mesh import FineMesh

        mesh = FineMesh(dim=dim, vertices=verts,
                        cells=remap[conn].astype(np.int32))
    if facet_ids and hasattr(mesh, "face_vertex_ids"):
        fv = mesh.face_vertex_ids()  # [n_c, n_faces, nvf]
        on_b = mesh.neighbors < 0
        out = np.full(on_b.shape, -1, dtype=np.int32)
        bc, bf = np.where(on_b)
        for c, f in zip(bc, bf):
            out[c, f] = facet_ids.get(
                tuple(sorted(fv[c, f].tolist())), 0)
        mesh.face_boundary_id = out
    return mesh


def _read_v2(lines):
    i = lines.index("$Nodes") + 1
    n_nodes = int(lines[i])
    nodes = np.zeros((n_nodes + 1, 3))
    for k in range(n_nodes):
        parts = lines[i + 1 + k].split()
        nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
    i = lines.index("$Elements") + 1
    n_el = int(lines[i])
    elements = []
    for k in range(n_el):
        parts = lines[i + 1 + k].split()
        etype = int(parts[1])
        if etype not in _N_NODES:
            continue
        n_tags = int(parts[2])
        tag = int(parts[3]) if n_tags >= 1 else None
        conn = [int(v) for v in parts[3 + n_tags:]]
        elements.append((etype, conn, tag))
    return nodes, elements


def _read_v4(lines):
    # $Entities: map (dim, entityTag) -> first physical tag (if any)
    phys = {}
    if "$Entities" in lines:
        j = lines.index("$Entities") + 1
        npt, ncv, nsf, nvl = (int(x) for x in lines[j].split())
        j += 1
        counts = (npt, ncv, nsf, nvl)
        for edim in range(4):
            for _ in range(counts[edim]):
                parts = lines[j].split()
                j += 1
                tag = int(parts[0])
                # points: tag x y z numPhys ...; others: tag 6 bbox floats
                base = 4 if edim == 0 else 7
                if len(parts) > base:
                    n_phys = int(parts[base])
                    if n_phys >= 1:
                        phys[(edim, tag)] = int(parts[base + 1])

    i = lines.index("$Nodes") + 1
    hdr = lines[i].split()
    n_blocks = int(hdr[0])
    max_tag = int(hdr[3])
    nodes = np.zeros((max_tag + 1, 3))
    i += 1
    for _ in range(n_blocks):
        bh = lines[i].split()
        count = int(bh[3])
        i += 1
        tags = [int(lines[i + k]) for k in range(count)]
        i += count
        for k in range(count):
            nodes[tags[k]] = [float(x) for x in lines[i + k].split()[:3]]
        i += count
    j = lines.index("$Elements") + 1
    eh = lines[j].split()
    n_blocks = int(eh[0])
    j += 1
    elements = []
    for _ in range(n_blocks):
        bh = lines[j].split()
        edim, etag, etype, count = (int(x) for x in bh[:4])
        tag = phys.get((edim, etag), etag)
        j += 1
        for k in range(count):
            if etype in _N_NODES:
                parts = lines[j + k].split()
                elements.append((etype, [int(v) for v in parts[1:]], tag))
        j += count
    return nodes, elements


# ---------------------------------------------------------------------------
# binary payload parsing.  gmsh binary files keep ASCII section headers
# ($Nodes ... $EndNodes) around little-endian binary payloads; the file is
# walked from header to header, each known payload parsed to its end and
# each other section skipped line by line to its $End line.  The
# endianness-check int written after the format line is verified.

# nodes per element of every gmsh element type (the gmsh reference manual's
# list): a binary block of a type the mesh does not use is strided over
_GMSH_NODES = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9, 11: 10,
    12: 27, 13: 18, 14: 14, 15: 1, 16: 8, 17: 20, 18: 15, 19: 13, 20: 9,
    21: 10, 22: 12, 23: 15, 24: 15, 25: 21, 26: 4, 27: 5, 28: 6, 29: 20,
    30: 35, 31: 56, 92: 64, 93: 125,
}


class _Cursor:
    def __init__(self, raw: bytes, pos: int = 0):
        self.raw, self.pos = raw, pos

    def line(self) -> bytes:
        end = self.raw.find(b"\n", self.pos)
        end = len(self.raw) if end < 0 else end
        out = self.raw[self.pos:end].rstrip(b"\r")
        self.pos = min(end + 1, len(self.raw))
        return out

    def header(self) -> str | None:
        """The next section's name (the text after ``$``), skipping the
        blank lines before it; None at the end of the file."""
        while self.pos < len(self.raw):
            ln = self.line().strip()
            if not ln:
                continue
            if not ln.startswith(b"$"):
                raise ValueError(f"expected a gmsh section header, got "
                                 f"{ln[:40]!r}")
            return ln[1:].decode()
        return None

    def end(self, name: str) -> None:
        """Consume the section's ``$End`` line (after its payload)."""
        ln = self.line().strip()
        while not ln and self.pos < len(self.raw):
            ln = self.line().strip()
        if ln != b"$End" + name.encode():
            raise ValueError(f"section ${name} does not end with $End{name}"
                             f" (got {ln[:40]!r})")

    def skip(self, name: str) -> None:
        """Skip a section's lines up to its ``$End`` line."""
        stop = b"$End" + name.encode()
        while self.pos < len(self.raw):
            if self.line().strip() == stop:
                return
        raise ValueError(f"section ${name} has no $End{name}")

    def ints(self, n, size=4):
        dt = np.dtype("<i4") if size == 4 else np.dtype("<i8")
        out = np.frombuffer(self.raw, dt, count=n, offset=self.pos)
        self.pos += n * size
        return out.astype(np.int64)

    def doubles(self, n):
        out = np.frombuffer(self.raw, np.dtype("<f8"), count=n,
                            offset=self.pos)
        self.pos += n * 8
        return out


def _n_nodes(etype: int, version: str) -> int:
    n = _GMSH_NODES.get(etype)
    if n is None:
        raise ValueError(f"element type {etype} of binary {version} mesh has "
                         "no known node count (cannot stride over it)")
    return n


def _read_bin(raw: bytes, version: float):
    """Nodes and elements of a binary v2.2 or v4.1 file, walking its
    sections in order from the one after $MeshFormat."""
    c = _Cursor(raw)
    c.header()  # $MeshFormat
    c.line()  # "version 1 data_size"
    one = c.ints(1)[0]
    if one != 1:
        raise ValueError(
            "big-endian gmsh binary files are not supported "
            f"(endianness marker {one})")
    c.end("MeshFormat")
    v4 = version >= 4.0
    phys, nodes, elements = {}, None, None
    while (name := c.header()) is not None:
        if name == "Entities" and v4:
            phys = _v4_entities(c)
        elif name == "Nodes":
            nodes = _v4_nodes(c) if v4 else _v2_nodes(c)
        elif name == "Elements":
            elements = _v4_elements(c, phys) if v4 else _v2_elements(c)
        else:
            c.skip(name)
            continue
        c.end(name)
    if nodes is None or elements is None:
        raise ValueError("binary gmsh file without $Nodes or $Elements")
    return nodes, elements


def _v2_nodes(c: _Cursor):
    """Binary v2.2 nodes: int32 tag + 3 float64 each."""
    n_nodes = int(c.line())
    rec = np.frombuffer(c.raw, np.dtype([("tag", "<i4"), ("xyz", "<f8", 3)]),
                        count=n_nodes, offset=c.pos)
    c.pos += n_nodes * (4 + 24)
    nodes = np.zeros((int(rec["tag"].max()) + 1, 3))
    nodes[rec["tag"]] = rec["xyz"]
    return nodes


def _v2_elements(c: _Cursor):
    """Binary v2.2 elements, grouped by (type, count, n_tags) int32
    headers; types the mesh does not use are skipped."""
    n_el = int(c.line())
    elements = []
    read = 0
    while read < n_el:
        etype, count, n_tags = (int(v) for v in c.ints(3))
        stride = 1 + n_tags + _n_nodes(etype, "v2")
        block = c.ints(count * stride).reshape(count, stride)
        if etype in _N_NODES:
            for row in block:
                tag = int(row[1]) if n_tags >= 1 else None
                elements.append((etype, row[1 + n_tags:].tolist(), tag))
        read += count
    return elements


def _v4_entities(c: _Cursor) -> dict:
    """Binary v4.1 entities: (dim, entity tag) -> its first physical tag."""
    phys = {}
    counts = c.ints(4, 8)
    for edim in range(4):
        for _ in range(int(counts[edim])):
            tag = int(c.ints(1)[0])
            c.doubles(3 if edim == 0 else 6)
            n_phys = int(c.ints(1, 8)[0])
            ptags = c.ints(n_phys)
            if n_phys >= 1:
                phys[(edim, tag)] = int(ptags[0])
            if edim > 0:
                n_bnd = int(c.ints(1, 8)[0])
                c.ints(n_bnd)
    return phys


def _v4_nodes(c: _Cursor):
    """Binary v4.1 nodes: size_t(8) counts and tags, int32 block
    headers; a parametric block carries dim more coordinates a node."""
    n_blocks, _n_nodes_all, _mn, max_tag = (int(v) for v in c.ints(4, 8))
    nodes = np.zeros((max_tag + 1, 3))
    for _ in range(n_blocks):
        edim, _etag, parametric = (int(v) for v in c.ints(3))
        count = int(c.ints(1, 8)[0])
        tags = c.ints(count, 8)
        n_c = 3 + (edim if parametric else 0)
        nodes[tags] = c.doubles(n_c * count).reshape(count, n_c)[:, :3]
    return nodes


def _v4_elements(c: _Cursor, phys: dict):
    """Binary v4.1 elements: size_t(8) counts, tags and nodes, int32 block
    headers; types the mesh does not use are skipped."""
    n_blocks = int(c.ints(1, 8)[0])
    c.ints(3, 8)  # numElements, min, max
    elements = []
    for _ in range(n_blocks):
        edim, etag, etype = (int(v) for v in c.ints(3))
        count = int(c.ints(1, 8)[0])
        n_nod = _n_nodes(etype, "v4")
        block = c.ints(count * (1 + n_nod), 8).reshape(count, 1 + n_nod)
        tag = phys.get((edim, etag), etag)
        if etype in _N_NODES:
            for row in block:
                elements.append((etype, row[1:].tolist(), tag))
    return elements
