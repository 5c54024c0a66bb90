"""AgglomerationHandler — the polytopal mesh, as arrays.

TPU-native rebuild of the reference's central class (reference
include/agglomeration_handler.h, source/agglomeration_handler.cc).  The
reference stores the polytopal mesh in hp-DoFHandler bookkeeping
(master/slave cells, PolytopeCache maps, FEValues caches) and rebuilds
FEValues per polytope inside the assembly loop; here *everything* is
materialized once at setup into static-shape arrays that feed batched
einsum/Pallas kernels:

  * ``cell2poly``           <- master_slave_relationships (handler.h:688)
  * ``poly2cells`` (padded) <- master2slaves
  * ``bbox_lo/hi``          <- bboxes + MappingBox (mapping is 2 affine ops)
  * ``vol_points/weights``  <- agglomerated_quadrature
                               (agglomeration_handler.cc:622-707): unit
                               points in each polytope's bbox; weights carry
                               the fine-cell JxW, so MappingBox's
                               "JxW = weight" rule (mapping_box.cc:421-431)
                               holds by construction.
  * ``FaceTable``           <- PolytopeCache.interface + reinit_master/
                               reinit_interface (agglomeration_handler.cc:
                               1103-1243,785-906): one row per *fine* face
                               on a polytopal interface, with quadrature in
                               both neighbors' bbox coordinates and outward
                               normals.  The ghost value exchange
                               (exchange_interface_values, :531-618) has no
                               equivalent on a single device.

DoF numbering is trivial by design: polytope ``i`` owns the contiguous
block [i*n_b, (i+1)*n_b) (the reference reaches the same count through the
hp FE_Nothing trick, agglomeration_handler.cc:711-725).

Port note: a jax-free copy of ``polydeal_tpu/handler.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from polydeal_tpu_torch.fem.basis import make_basis
from polydeal_tpu_torch.mesh.fine_mesh import FineMesh

__all__ = ["FaceTable", "PolytopalFaces", "AgglomerationHandler"]


@dataclass
class FaceTable:
    """Flat table of interface fine-faces (the assembly-facing view).

    Each row is one fine face lying on a polytopal interface or on the
    domain boundary.  ``poly_out == -1`` marks boundary rows.  Normals
    point outward from ``poly_in``; for interior rows ``poly_in`` is always
    the smaller polytope id — the reference's visit-once rule
    ``polytope->id() < neighbor->id()`` (poly_utils.h:2089).
    """

    poly_in: np.ndarray  # [n_f] int32
    poly_out: np.ndarray  # [n_f] int32, -1 = boundary
    points_real: np.ndarray  # [n_f, Qf, dim]
    points_in: np.ndarray  # [n_f, Qf, dim] unit coords in poly_in bbox
    points_out: np.ndarray  # [n_f, Qf, dim] unit coords in poly_out bbox
    weights: np.ndarray  # [n_f, Qf] surface JxW
    normals: np.ndarray  # [n_f, Qf, dim] unit, outward from poly_in
    h_f: np.ndarray  # [n_f] penalty length scale: diameter of poly_in
    boundary_id: np.ndarray | None = None  # [n_f] int32, -1 interior

    @property
    def n_faces(self) -> int:
        return self.poly_in.shape[0]

    @property
    def is_boundary(self) -> np.ndarray:
        return self.poly_out < 0

    def interior(self) -> "FaceTable":
        return self._select(~self.is_boundary)

    def boundary(self) -> "FaceTable":
        return self._select(self.is_boundary)

    def _select(self, mask: np.ndarray) -> "FaceTable":
        return FaceTable(
            poly_in=self.poly_in[mask],
            poly_out=self.poly_out[mask],
            points_real=self.points_real[mask],
            points_in=self.points_in[mask],
            points_out=self.points_out[mask],
            weights=self.weights[mask],
            normals=self.normals[mask],
            h_f=self.h_f[mask],
            boundary_id=None if self.boundary_id is None
            else self.boundary_id[mask],
        )


@dataclass
class PolytopalFaces:
    """Grouped polytopal faces (the accessor-facing view).

    Mirrors what ``AgglomerationAccessor::n_faces()/neighbor(f)`` expose
    (reference agglomeration_accessor.h:324-422): each polytope has one
    face per distinct neighboring polytope plus one face per connected
    group of boundary fine-faces (we group all boundary fragments of a
    polytope into a single face).
    """

    # for each polytope: list of neighbor polytope ids (-1 = boundary face)
    neighbors: list  # list[np.ndarray]

    def n_faces(self, p: int) -> int:
        return len(self.neighbors[p])

    def neighbor(self, p: int, f: int) -> int:
        return int(self.neighbors[p][f])

    def at_boundary(self, p: int, f: int) -> bool:
        return self.neighbors[p][f] < 0


class AgglomerationHandler:
    """Polytopal mesh over a fine background mesh.

    Parameters
    ----------
    mesh : FineMesh
    cell2poly : [n_cells] int labels (0..n_poly-1, each label nonempty)
    degree : DG polynomial degree p
    family : basis family, 'dgp' (modal Legendre, default) or 'dgq'
    n_quad : 1D Gauss points per fine cell (default p+1, matching the
        reference's QGauss(degree+1), cf. examples/poisson.cc)
    """

    def __init__(
        self,
        mesh: FineMesh,
        cell2poly: np.ndarray,
        degree: int = 1,
        family: str = "dgp",
        n_quad: int | None = None,
    ):
        self.mesh = mesh
        self.cell2poly = np.asarray(cell2poly, dtype=np.int32)
        if self.cell2poly.shape[0] != mesh.n_cells:
            raise ValueError("cell2poly must have one entry per fine cell")
        self.degree = degree
        self.family = family
        self.basis = make_basis(family, mesh.dim, degree)
        self.n_quad = n_quad if n_quad is not None else degree + 1

        self.n_poly = int(self.cell2poly.max()) + 1
        self._build_poly2cells()
        self._build_bboxes()
        self._build_volume_quadrature()
        self._build_face_table()
        self._poly_faces: PolytopalFaces | None = None

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def n_basis(self) -> int:
        return self.basis.n_basis

    @property
    def n_dofs(self) -> int:
        return self.n_poly * self.n_basis

    # ------------------------------------------------------------------
    def _build_poly2cells(self):
        from polydeal_tpu_torch.utils.grouping import padded_group_lists

        members, counts = padded_group_lists(self.cell2poly, self.n_poly)
        if (counts == 0).any():
            raise ValueError("empty polytope label present")
        self.poly_n_cells = counts
        self.poly2cells = members

    def _build_bboxes(self):
        """Axis-aligned bbox of each polytope = hull of member cell vertices
        (reference create_bounding_box, agglomeration_handler.cc:476-491)."""
        dim = self.dim
        verts = self.mesh.cell_vertices()  # [n_c, 2^dim, dim]
        cmin = verts.min(axis=1)
        cmax = verts.max(axis=1)
        lo = np.full((self.n_poly, dim), np.inf)
        hi = np.full((self.n_poly, dim), -np.inf)
        np.minimum.at(lo, self.cell2poly, cmin)
        np.maximum.at(hi, self.cell2poly, cmax)
        self.bbox_lo = lo
        self.bbox_hi = hi
        self.extents = hi - lo
        # polytope "diameter" = bbox diagonal norm
        # (reference agglomeration_accessor.h:583-600)
        self.diameters = np.linalg.norm(self.extents, axis=1)
        self.volumes = np.prod(self.extents, axis=1)  # bbox volume (accessor)

    def to_unit(self, poly_ids: np.ndarray, pts_real: np.ndarray) -> np.ndarray:
        """Pull real points back into each polytope's unit bbox coords.

        This *is* MappingBox (reference mapping_box.cc:923-970): a single
        vectorized affine op.
        """
        lo = self.bbox_lo[poly_ids]
        ext = self.extents[poly_ids]
        return (pts_real - lo[..., None, :]) / ext[..., None, :]

    def _build_volume_quadrature(self):
        """Materialize the composite (agglomerated) quadrature, cell-wise.

        TPU layout decision: the reference materializes one composite rule
        *per polytope* (agglomerated_quadrature); we instead keep the rule
        flat per *fine cell* — [n_cells, q] with unit points expressed in
        the owning polytope's bbox.  Volume integrals then become a dense
        per-cell einsum + segment-sum by ``cell2poly`` — zero padding, no
        ragged shapes, identical mathematics (the per-polytope view is
        still available via :attr:`vol_points` / :attr:`vol_weights`).
        """
        pts_c, jxw_c = self.mesh.volume_quadrature(self.n_quad)  # [n_c,q,d],[n_c,q]
        self.cell_qpoints_real = pts_c
        self.cell_qweights = jxw_c
        self.cell_qpoints_unit = self.to_unit(self.cell2poly, pts_c)
        self._vol_padded = None

    def _padded_volume(self):
        if self._vol_padded is None:
            q = self.cell_qpoints_real.shape[1]
            max_cells = self.poly2cells.shape[1]
            gather = self.poly2cells
            safe = np.maximum(gather, 0)
            pts = self.cell_qpoints_real[safe].reshape(
                self.n_poly, max_cells * q, self.dim)
            unit = self.cell_qpoints_unit[safe].reshape(
                self.n_poly, max_cells * q, self.dim)
            wts = self.cell_qweights[safe].reshape(self.n_poly, max_cells * q)
            mask = (gather >= 0)[:, :, None].repeat(q, axis=2).reshape(self.n_poly, -1)
            wts = np.where(mask, wts, 0.0)
            unit = np.where(mask[:, :, None], unit, 0.5)
            self._vol_padded = (unit, wts, pts)
        return self._vol_padded

    @property
    def vol_points(self):
        """Padded per-polytope unit quadrature points [n_poly, Q, dim]."""
        return self._padded_volume()[0]

    @property
    def vol_weights(self):
        """Padded per-polytope JxW weights [n_poly, Q] (0 on padding)."""
        return self._padded_volume()[1]

    @property
    def vol_points_real(self):
        return self._padded_volume()[2]

    def _build_face_table(self):
        """Build the flat interface fine-face table.

        The array recast of setup_master_neighbor_connectivity (reference
        agglomeration_handler.cc:1253-1645) + reinit_master's quadrature
        assembly (:1103-1243): classify every fine face by the polytopes of
        its two cells, keep boundary faces and interior faces once (from
        the smaller-id side), and materialize quadrature/normals.
        """
        mesh = self.mesh
        nb = mesh.neighbors  # [n_c, 2*dim]
        c2p = self.cell2poly
        n_c, nf = nb.shape

        pts, jxw, normals = mesh.face_quadrature(self.n_quad)

        cell_idx = np.repeat(np.arange(n_c), nf)
        face_idx = np.tile(np.arange(nf), n_c)
        nbr = nb.ravel()
        p_in = c2p[cell_idx]
        p_out = np.where(nbr >= 0, c2p[np.maximum(nbr, 0)], -1)

        keep = (nbr < 0) | ((p_in != p_out) & (p_in < p_out))
        cell_idx, face_idx = cell_idx[keep], face_idx[keep]
        p_in, p_out = p_in[keep], p_out[keep]

        f_pts = pts[cell_idx, face_idx]  # [n_f, Qf, dim]
        f_jxw = jxw[cell_idx, face_idx]
        f_nrm = normals[cell_idx, face_idx]

        unit_in = self.to_unit(p_in, f_pts)
        unit_out = self.to_unit(np.maximum(p_out, 0), f_pts)

        bids = mesh.boundary_id_array() if hasattr(mesh, "boundary_id_array") \
            else None
        self.faces = FaceTable(
            poly_in=p_in.astype(np.int32),
            poly_out=p_out.astype(np.int32),
            points_real=f_pts,
            points_in=unit_in,
            points_out=unit_out,
            weights=f_jxw,
            normals=f_nrm,
            h_f=self.diameters[p_in],
            boundary_id=None if bids is None
            else bids[cell_idx, face_idx].astype(np.int32),
        )

    # ------------------------------------------------------------------
    @property
    def poly_faces(self) -> PolytopalFaces:
        """Grouped polytopal faces for accessor-level queries/tests."""
        if self._poly_faces is None:
            ft = self.faces
            neighbors = [[] for _ in range(self.n_poly)]
            # interior faces: both sides see each other
            pairs = np.stack([ft.poly_in, ft.poly_out], axis=1)
            interior = pairs[pairs[:, 1] >= 0]
            uniq = np.unique(interior, axis=0) if interior.size else np.empty((0, 2), int)
            for a, b in uniq:
                neighbors[a].append(b)
                neighbors[b].append(a)
            # one boundary face per polytope that touches the boundary
            bdry_polys = np.unique(ft.poly_in[ft.poly_out < 0])
            for p in bdry_polys:
                neighbors[int(p)].append(-1)
            self._poly_faces = PolytopalFaces(
                neighbors=[np.asarray(sorted(v, key=lambda x: (x < 0, x)), dtype=np.int64)
                           for v in neighbors]
            )
        return self._poly_faces

    def n_faces(self, p: int) -> int:
        return self.poly_faces.n_faces(p)

    def dof_indices(self, p: int) -> np.ndarray:
        nb = self.n_basis
        return np.arange(p * nb, (p + 1) * nb)

    def sparsity_block_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of nonzero n_b×n_b blocks: diagonal + DG flux
        couplings (reference create_agglomeration_sparsity_pattern,
        agglomeration_handler.cc:910-1022)."""
        ft = self.faces.interior()
        pairs = np.unique(np.stack([ft.poly_in, ft.poly_out], axis=1), axis=0) \
            if ft.n_faces else np.empty((0, 2), dtype=np.int64)
        rows = np.concatenate([np.arange(self.n_poly), pairs[:, 0], pairs[:, 1]])
        cols = np.concatenate([np.arange(self.n_poly), pairs[:, 1], pairs[:, 0]])
        return rows.astype(np.int64), cols.astype(np.int64)
