"""Simplex (triangle/tetrahedron) background meshes.

Parity with the reference's simplex paths (FE_SimplexDGP assembly in
poisson.cc's ``#define HEX`` alternative, simplex_agglomerated_multigrid.cc):
an affine simplex mesh implementing the same protocol as
:class:`~polydeal_tpu.mesh.fine_mesh.FineMesh`, so AgglomerationHandler and
the whole polytopal DG stack work on simplices unchanged — the polytopal
space lives on bounding boxes regardless of fine-cell shape.

Reference simplex: {x >= 0, sum(x) <= 1}; face i (0 <= i <= dim) is
opposite vertex i, with face dim being the "diagonal" face {sum x = 1}
in our ordering (vertices: v0 = origin, v_i = e_i).

Port note: a jax-free copy of ``polydeal_tpu/mesh/simplex.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from math import factorial

import numpy as np

__all__ = ["SimplexMesh", "triangulated_hyper_cube"]


def _simplex_faces(dim: int):
    """Local vertex lists of each face: face i omits vertex i."""
    return [[v for v in range(dim + 1) if v != i] for i in range(dim + 1)]


@dataclass
class SimplexMesh:
    """Affine simplex mesh (triangles dim=2, tets dim=3)."""

    dim: int
    vertices: np.ndarray  # [n_v, dim]
    cells: np.ndarray  # [n_c, dim+1] vertex ids
    _neighbors: np.ndarray | None = field(default=None, repr=False)

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_faces_per_cell(self) -> int:
        return self.dim + 1

    # ---- connectivity --------------------------------------------------
    def face_vertex_ids(self) -> np.ndarray:
        faces = _simplex_faces(self.dim)
        return np.stack([self.cells[:, f] for f in faces], axis=1)

    @property
    def neighbors(self) -> np.ndarray:
        if self._neighbors is None:
            from polydeal_tpu_torch import native

            local = np.asarray(_simplex_faces(self.dim), dtype=np.int32)
            nb = native.face_neighbors(self.cells.astype(np.int32), local)
            if nb is None:
                fv = np.sort(self.face_vertex_ids().reshape(-1, self.dim), axis=1)
                order = np.lexsort(fv.T[::-1])
                s = fv[order]
                eq = np.all(s[:-1] == s[1:], axis=1)
                nb = np.full(fv.shape[0], -1, dtype=np.int64)
                a, b = order[:-1][eq], order[1:][eq]
                nfc = self.n_faces_per_cell
                nb[a] = b // nfc
                nb[b] = a // nfc
                nb = nb.reshape(self.n_cells, nfc)
            self._neighbors = nb
        return self._neighbors

    # ---- geometry (affine: constant Jacobian per cell) -----------------
    def cell_vertices(self) -> np.ndarray:
        return self.vertices[self.cells]

    def jacobian(self) -> np.ndarray:
        """[n_c, dim, dim]: columns v_i - v_0."""
        cv = self.cell_vertices()
        return np.stack([cv[:, i + 1] - cv[:, 0] for i in range(self.dim)],
                        axis=-1)

    def map_points(self, unit_pts: np.ndarray) -> np.ndarray:
        cv = self.cell_vertices()
        J = self.jacobian()
        up = np.atleast_2d(unit_pts)
        return cv[:, None, 0, :] + np.einsum("cde,qe->cqd", J, up)

    def cell_measures(self, *_args) -> np.ndarray:
        return np.abs(np.linalg.det(self.jacobian())) / factorial(self.dim)

    def cell_centers(self) -> np.ndarray:
        return self.cell_vertices().mean(axis=1)

    def volume_quadrature(self, n1d: int):
        """Composite GM rule per cell (points real, weights JxW).

        ``n1d`` selects the GM index s = n1d - 1 (degree 2 n1d - 1 >=
        the tensor-Gauss exactness used on quads)."""
        from polydeal_tpu_torch.fem.quadrature import grundmann_moeller

        up, uw = grundmann_moeller(self.dim, max(n1d - 1, 1))
        pts = self.map_points(up)
        detJ = np.abs(np.linalg.det(self.jacobian()))
        # GM weights sum to the unit-simplex measure 1/dim!, so
        # jxw sums to detJ/dim! = the cell measure
        jxw = detJ[:, None] * uw[None, :]
        return pts, jxw

    def face_quadrature(self, n1d: int):
        """Composite rule per (cell, face) with outward unit normals."""
        from polydeal_tpu_torch.fem.quadrature import grundmann_moeller, tensor_gauss

        dim = self.dim
        if dim == 2:
            # face = segment: 1D Gauss on the edge
            t, w = tensor_gauss(1, n1d)
            t = t[:, 0]
            qf = t.shape[0]
        else:
            t2, w = grundmann_moeller(2, max(n1d - 1, 1))
            w = w * 2.0  # normalize to unit-triangle measure 1/2 -> weights
            qf = w.shape[0]
        faces = _simplex_faces(dim)
        cv = self.cell_vertices()
        n_c = self.n_cells
        pts = np.empty((n_c, dim + 1, qf, dim))
        jxw = np.empty((n_c, dim + 1, qf))
        normals = np.empty((n_c, dim + 1, qf, dim))
        centers = self.cell_centers()
        for fi, f in enumerate(faces):
            V = cv[:, f, :]  # [n_c, dim, dim] face vertices
            if dim == 2:
                a, b = V[:, 0], V[:, 1]
                pts[:, fi] = a[:, None, :] + (b - a)[:, None, :] * t[None, :, None]
                length = np.linalg.norm(b - a, axis=-1)
                # unit Gauss weights on [0,1] sum to 1 -> JxW = length * w
                jxw[:, fi] = length[:, None] * w[None, :]
                tang = b - a
                nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=-1)
            else:
                a, b, c = V[:, 0], V[:, 1], V[:, 2]
                # barycentric param over the GM points of the unit triangle
                from polydeal_tpu_torch.fem.quadrature import grundmann_moeller as gm

                up2, w2 = gm(2, max(n1d - 1, 1))
                l1, l2 = up2[:, 0], up2[:, 1]
                l0 = 1.0 - l1 - l2
                pts[:, fi] = (
                    a[:, None, :] * l0[None, :, None]
                    + b[:, None, :] * l1[None, :, None]
                    + c[:, None, :] * l2[None, :, None]
                )
                cross = np.cross(b - a, c - a)
                area2 = np.linalg.norm(cross, axis=-1)  # 2x triangle area
                # GM weights sum to 1/2 (unit triangle measure)
                jxw[:, fi] = area2[:, None] * w2[None, :]
                nrm = cross
            mag = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.maximum(mag, 1e-300)
            # orient outward: away from the cell center
            fcen = pts[:, fi].mean(axis=1)
            sign = np.sign(np.einsum("cd,cd->c", nrm, fcen - centers))
            normals[:, fi] = nrm[:, None, :] * sign[:, None, None]
        return pts, jxw, normals

    def boundary_vertex_mask(self) -> np.ndarray:
        fv = self.face_vertex_ids()
        on_b = self.neighbors < 0
        mask = np.zeros(self.n_vertices, dtype=bool)
        mask[np.unique(fv[on_b])] = True
        return mask


def triangulated_hyper_cube(dim: int, n: int, lo: float = 0.0,
                            hi: float = 1.0) -> SimplexMesh:
    """Structured simplex grid: each quad split into 2 triangles, each hex
    into 6 tetrahedra (Kuhn/Freudenthal triangulation — conforming)."""
    from polydeal_tpu_torch.mesh.fine_mesh import hyper_cube

    quad = hyper_cube(dim, n, lo, hi)
    cells = []
    if dim == 2:
        for c in quad.cells:
            v = c  # bit order: 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)
            cells.append([v[0], v[1], v[3]])
            cells.append([v[0], v[3], v[2]])
    elif dim == 3:
        # Kuhn: 6 tets per cube along vertex 0 -> vertex 7 diagonal, one
        # per permutation of axis traversal order
        for c in quad.cells:
            for perm in itertools.permutations(range(3)):
                path = [0]
                acc = 0
                for ax in perm:
                    acc |= 1 << ax
                    path.append(acc)
                cells.append([c[p] for p in path])
    else:
        raise ValueError("dim must be 2 or 3")
    return SimplexMesh(dim=dim, vertices=quad.vertices.copy(),
                       cells=np.asarray(cells, dtype=np.int32))
