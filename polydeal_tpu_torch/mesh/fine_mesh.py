"""Array-based fine ("background") mesh of quads/hexes.

This replaces the deal.II ``Triangulation`` + ``GridTools::Cache`` substrate
of the reference (cf. reference include/agglomeration_handler.h:247-452).
Everything is a flat numpy array built once on the host; the jitted TPU
compute path only ever sees the materialized quadrature/connectivity arrays
derived from it.

Vertex convention: cell vertex ``v`` (0 <= v < 2^dim) sits at the unit-cell
corner whose coordinate ``d`` is bit ``d`` of ``v`` — e.g. in 2D
v0=(0,0), v1=(1,0), v2=(0,1), v3=(1,1) (deal.II's ordering).

Face convention: face ``f = 2*axis + side`` is the set {x_axis = side}
(deal.II numbers faces the same way: 2*d for the "low" face in direction d).

Port note: a jax-free copy of ``polydeal_tpu/mesh/fine_mesh.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

__all__ = ["FineMesh", "hyper_cube", "hyper_rectangle", "distort_random"]


def _det(J: np.ndarray) -> np.ndarray:
    """Determinant of [..., d, d] for d in {1,2,3} without linalg overhead."""
    d = J.shape[-1]
    if d == 1:
        return J[..., 0, 0]
    if d == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    if d == 3:
        return (
            J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
        )
    raise ValueError(f"unsupported dim {d}")


def _cofactor(J: np.ndarray) -> np.ndarray:
    """Cofactor matrix cof(J) = det(J) J^{-T} for d in {1,2,3}."""
    d = J.shape[-1]
    C = np.empty_like(J)
    if d == 1:
        C[..., 0, 0] = 1.0
        return C
    if d == 2:
        C[..., 0, 0] = J[..., 1, 1]
        C[..., 0, 1] = -J[..., 1, 0]
        C[..., 1, 0] = -J[..., 0, 1]
        C[..., 1, 1] = J[..., 0, 0]
        return C
    if d == 3:
        for i in range(3):
            for j in range(3):
                rows = [r for r in range(3) if r != i]
                cols = [c for c in range(3) if c != j]
                minor = (
                    J[..., rows[0], cols[0]] * J[..., rows[1], cols[1]]
                    - J[..., rows[0], cols[1]] * J[..., rows[1], cols[0]]
                )
                C[..., i, j] = ((-1) ** (i + j)) * minor
        return C
    raise ValueError(f"unsupported dim {d}")


def _multilinear_shapes(unit_pts: np.ndarray, dim: int):
    """Multilinear (Q1) shape values/gradients at unit points.

    unit_pts: [q, dim] -> values [q, 2^dim], grads [q, 2^dim, dim].
    """
    q = unit_pts.shape[0]
    nv = 1 << dim
    vals = np.ones((q, nv))
    grads = np.zeros((q, nv, dim))
    for v in range(nv):
        factors = np.empty((q, dim))
        for d in range(dim):
            x = unit_pts[:, d]
            factors[:, d] = x if (v >> d) & 1 else 1.0 - x
        vals[:, v] = np.prod(factors, axis=1)
        for e in range(dim):
            g = 1.0 if (v >> e) & 1 else -1.0
            prod = np.ones(q) * g
            for d in range(dim):
                if d != e:
                    prod = prod * factors[:, d]
            grads[:, v, e] = prod
    return vals, grads


@dataclass
class FineMesh:
    """Fine background mesh: quads (dim=2) or hexes (dim=3).

    ``face_boundary_id`` (optional) assigns an integer id to every
    boundary (cell, face) — the analogue of deal.II boundary ids the
    reference uses for per-id Dirichlet/Neumann conditions
    (reference include/utils.h:1647-1659, examples/3D_piston.cc).
    Interior faces carry -1; unset means all-0 boundary.
    """

    dim: int
    vertices: np.ndarray  # [n_vertices, dim] float64
    cells: np.ndarray  # [n_cells, 2^dim] int32 vertex ids
    _neighbors: np.ndarray | None = field(default=None, repr=False)
    face_boundary_id: np.ndarray | None = field(default=None, repr=False)
    # quadrature caches keyed by n1d: every AgglomerationHandler level of
    # a hierarchy shares the same background rules — recomputing them per
    # level made 10^6-cell setup minutes-slow
    _vq_cache: dict = field(default_factory=dict, repr=False, compare=False)
    _fq_cache: dict = field(default_factory=dict, repr=False, compare=False)

    def boundary_id_array(self) -> np.ndarray:
        """[n_cells, 2*dim] int32: boundary id per face, -1 interior."""
        interior = self.neighbors >= 0
        if self.face_boundary_id is not None:
            out = np.asarray(self.face_boundary_id, dtype=np.int32).copy()
            out[interior] = -1
            return out
        out = np.where(interior, -1, 0).astype(np.int32)
        return out

    def mark_boundary(self, fn) -> "FineMesh":
        """Assign boundary ids from a predicate on face centers:
        ``fn(centers [k, dim], normals [k, dim]) -> ids [k]``.  Returns
        self (ids stored in place) — the colorize-style hook of deal.II
        GridGenerator."""
        fv = self.face_vertex_ids()  # [n_c, 2*dim, nvf]
        centers = self.vertices[fv].mean(axis=2)  # [n_c, 2*dim, dim]
        on_b = self.neighbors < 0
        ids = np.full(on_b.shape, -1, dtype=np.int32)
        if on_b.any():
            # cheap outward normal estimate: face center minus cell center
            cc = self.cell_centers()[:, None, :]
            nrm = centers - cc
            nrm = nrm / np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-300)
            ids[on_b] = np.asarray(
                fn(centers[on_b], nrm[on_b]), dtype=np.int32)
        self.face_boundary_id = ids
        return self

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_faces_per_cell(self) -> int:
        return 2 * self.dim

    # ---- connectivity -------------------------------------------------

    def face_vertex_ids(self) -> np.ndarray:
        """Vertex ids of every (cell, face): [n_cells, 2*dim, 2^(dim-1)]."""
        dim = self.dim
        nv_face = 1 << (dim - 1)
        out = np.empty((self.n_cells, 2 * dim, nv_face), dtype=self.cells.dtype)
        for axis in range(dim):
            for side in range(2):
                local = [v for v in range(1 << dim) if ((v >> axis) & 1) == side]
                out[:, 2 * axis + side, :] = self.cells[:, local]
        return out

    @property
    def neighbors(self) -> np.ndarray:
        """[n_cells, 2*dim] neighbor cell index across each face, -1 = boundary.

        Computed by sorting the (sorted) vertex tuples of all faces and
        pairing equal consecutive rows — the array analogue of deal.II's
        face identification.
        """
        if self._neighbors is None:
            from polydeal_tpu_torch import native

            local = np.array(
                [[v for v in range(1 << self.dim) if ((v >> axis) & 1) == side]
                 for axis in range(self.dim) for side in range(2)],
                dtype=np.int32,
            )
            nb = native.face_neighbors(self.cells, local)
            if nb is not None:
                self._neighbors = nb
                return self._neighbors
            fv = np.sort(self.face_vertex_ids().reshape(-1, 1 << (self.dim - 1)), axis=1)
            order = np.lexsort(fv.T[::-1])
            s = fv[order]
            eq = np.all(s[:-1] == s[1:], axis=1)
            nb = np.full(fv.shape[0], -1, dtype=np.int64)
            a, b = order[:-1][eq], order[1:][eq]
            nb[a] = b // (2 * self.dim)
            nb[b] = a // (2 * self.dim)
            self._neighbors = nb.reshape(self.n_cells, 2 * self.dim)
        return self._neighbors

    # ---- geometry ------------------------------------------------------

    def cell_vertices(self) -> np.ndarray:
        # cached: the fancy-indexed [n_cells, 2^dim, dim] copy costs ~1 s
        # per call at 10^6 cells and is requested by every setup stage
        cv = self._vq_cache.get("_cell_vertices")
        if cv is None:
            cv = self.vertices[self.cells]
            self._vq_cache["_cell_vertices"] = cv
        return cv

    def map_points(self, unit_pts: np.ndarray) -> np.ndarray:
        """Map unit points into every cell: [n_cells, q, dim]."""
        vals, _ = _multilinear_shapes(np.atleast_2d(unit_pts), self.dim)
        return np.einsum("qv,cvd->cqd", vals, self.cell_vertices(),
                         optimize=True)

    def jacobians(self, unit_pts: np.ndarray) -> np.ndarray:
        """Jacobian dx/dx̂ at unit points: [n_cells, q, dim, dim]."""
        _, grads = _multilinear_shapes(np.atleast_2d(unit_pts), self.dim)
        return np.einsum("qve,cvd->cqde", grads, self.cell_vertices(),
                         optimize=True)

    def volume_quadrature(self, n1d: int):
        """Composite Gauss rule per cell.

        Returns (points [n_cells, Q, dim] real coords, weights [n_cells, Q]
        carrying |det J|·w — i.e. JxW, cf. reference
        source/agglomeration_handler.cc:622-707 where fine-cell JxW is
        folded into the agglomerated quadrature weights).
        """
        from polydeal_tpu_torch.fem.quadrature import tensor_gauss

        if n1d in self._vq_cache:
            return self._vq_cache[n1d]
        up, uw = tensor_gauss(self.dim, n1d)
        pts = self.map_points(up)
        J = self.jacobians(up)
        jxw = np.abs(_det(J)) * uw[None, :]
        self._vq_cache[n1d] = (pts, jxw)
        return pts, jxw

    def face_quadrature(self, n1d: int):
        """Composite Gauss rule per (cell, face), with outward normals.

        Returns (points [n_cells, 2*dim, Qf, dim],
                 jxw    [n_cells, 2*dim, Qf],
                 normals[n_cells, 2*dim, Qf, dim]) — normals are unit
        outward w.r.t. the cell.  Surface measure and normal direction come
        from the cofactor identity n·dS = cof(J)·n̂ dŜ.
        """
        from polydeal_tpu_torch.fem.quadrature import face_quadrature, embed_face_points

        if n1d in self._fq_cache:
            return self._fq_cache[n1d]
        fp, fw = face_quadrature(self.dim, n1d)
        qf = fp.shape[0]
        pts = np.empty((self.n_cells, 2 * self.dim, qf, self.dim))
        jxw = np.empty((self.n_cells, 2 * self.dim, qf))
        normals = np.empty((self.n_cells, 2 * self.dim, qf, self.dim))
        for axis in range(self.dim):
            for side in range(2):
                f = 2 * axis + side
                up = embed_face_points(fp, axis, side)
                pts[:, f] = self.map_points(up)
                J = self.jacobians(up)  # [c, q, d, d]
                n_ref = np.zeros(self.dim)
                n_ref[axis] = 2.0 * side - 1.0
                nvec = np.einsum("cqde,e->cqd", _cofactor(J), n_ref)
                mag = np.linalg.norm(nvec, axis=-1)
                jxw[:, f] = mag * fw[None, :]
                normals[:, f] = nvec / np.maximum(mag, 1e-300)[..., None]
        self._fq_cache[n1d] = (pts, jxw, normals)
        return pts, jxw, normals

    def cell_measures(self, n1d: int = 2) -> np.ndarray:
        _, jxw = self.volume_quadrature(n1d)
        return jxw.sum(axis=1)

    def cell_centers(self) -> np.ndarray:
        return self.cell_vertices().mean(axis=1)

    def boundary_vertex_mask(self) -> np.ndarray:
        """True for vertices lying on a boundary face."""
        fv = self.face_vertex_ids()
        on_b = self.neighbors < 0  # [n_cells, 2*dim]
        mask = np.zeros(self.n_vertices, dtype=bool)
        mask[np.unique(fv[on_b])] = True
        return mask


def hyper_rectangle(dim: int, n_per_dim, lo=None, hi=None) -> FineMesh:
    """Structured grid of n_per_dim[d] cells per direction on [lo, hi]."""
    if np.isscalar(n_per_dim):
        n_per_dim = [int(n_per_dim)] * dim
    n = list(n_per_dim)
    lo = np.zeros(dim) if lo is None else np.asarray(lo, dtype=np.float64)
    hi = np.ones(dim) if hi is None else np.asarray(hi, dtype=np.float64)
    axes = [np.linspace(lo[d], hi[d], n[d] + 1) for d in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([g.ravel() for g in grids], axis=-1)

    # vertex index strides (x fastest in our bit convention is arbitrary;
    # we use index (i0,...,i_{dim-1}) with last axis fastest in ravel)
    vshape = [n[d] + 1 for d in range(dim)]
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * vshape[d + 1]

    ranges = [np.arange(n[d]) for d in range(dim)]
    idx = np.meshgrid(*ranges, indexing="ij")
    base = sum(idx[d].ravel() * strides[d] for d in range(dim))  # [n_cells]
    nv = 1 << dim
    offsets = np.empty(nv, dtype=np.int64)
    for v in range(nv):
        offsets[v] = sum(((v >> d) & 1) * strides[d] for d in range(dim))
    cells = base[:, None] + offsets[None, :]
    return FineMesh(dim=dim, vertices=verts, cells=cells.astype(np.int32))


def hyper_cube(dim: int, n: int, lo: float = 0.0, hi: float = 1.0) -> FineMesh:
    """n^dim structured cells on [lo, hi]^dim (GridGenerator::hyper_cube +
    refine analogue)."""
    return hyper_rectangle(dim, n, lo=[lo] * dim, hi=[hi] * dim)


def distort_random(mesh: FineMesh, factor: float, seed: int = 0,
                   keep_boundary: bool = True) -> FineMesh:
    """Randomly move vertices by ``factor`` × (min incident edge length).

    Mirrors deal.II ``GridTools::distort_random`` used by the reference's
    distorted-grid exactness tests (test/polydeal/exact_solutions.cc,
    continuous_face_distorted_grid.cc).
    """
    rng = np.random.default_rng(seed)
    dim = mesh.dim
    # min incident edge length per vertex: use cell edges along each axis
    min_len = np.full(mesh.n_vertices, np.inf)
    cv = mesh.cells
    for axis in range(dim):
        for v in range(1 << dim):
            if not (v >> axis) & 1:
                w = v | (1 << axis)
                a, b = cv[:, v], cv[:, w]
                ln = np.linalg.norm(mesh.vertices[a] - mesh.vertices[b], axis=1)
                np.minimum.at(min_len, a, ln)
                np.minimum.at(min_len, b, ln)
    shift = rng.uniform(-1.0, 1.0, size=mesh.vertices.shape)
    shift *= factor * min_len[:, None]
    if keep_boundary:
        shift[mesh.boundary_vertex_mask()] = 0.0
    return FineMesh(dim=dim, vertices=mesh.vertices + shift, cells=mesh.cells)
