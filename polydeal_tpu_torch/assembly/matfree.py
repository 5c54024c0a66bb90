"""Matrix-free SIPG operators on torch tensors.

Counterpart of ``polydeal_tpu/assembly/matfree.py`` (the reference's
``Utils::MatrixFreeOperators::LaplaceOperatorDG`` / ``MonodomainOperatorDG``,
include/utils.h:375-1821): the operator action v = A u without an
assembled matrix.  The action is three einsum pipelines (cells, interior
faces, boundary faces) over *geometry only* -- quadrature points, weights,
normals -- with the basis recomputed from the Legendre recurrence at every
apply, so the operator holds O(geometry) memory, not O(nb^2) per block.
The JAX package computes these einsums in XLA outside any kernel; here
they are plain torch, and the reductions onto polytopes go through
``utils/segment.SegmentSum`` (one fixed summation order on a device, no
``index_add_``).

The diagonal (for Chebyshev/Jacobi smoothing, reference utils.h:796-814)
falls out of the same tables: diag = sum_q w (G_ii)^2 and the face terms.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from polydeal_tpu_torch.assembly.sipg import default_penalty_constant
from polydeal_tpu_torch.handler import AgglomerationHandler
from polydeal_tpu_torch.utils.segment import SegmentSum

__all__ = ["PolyReducer", "MatrixFreeLaplace", "MatrixFreeMass"]


@dataclass
class _Geometry:
    """Geometry feeding the on-the-fly operator: tensors on the device, the
    index arrays on the host (static numpy, as in the JAX package)."""

    # cells
    cell_pts: torch.Tensor  # [n_c, q, dim] unit coords in owning bbox
    cell_w: torch.Tensor  # [n_c, q]
    cell_ext: torch.Tensor  # [n_c, dim] owning bbox extents
    cell2poly: np.ndarray
    poly2cells: np.ndarray  # padded [P, C]
    # interior faces
    fi_pts_in: torch.Tensor
    fi_pts_out: torch.Tensor
    fi_w: torch.Tensor
    fi_n: torch.Tensor
    fi_hf: torch.Tensor
    fi_ext_in: torch.Tensor
    fi_ext_out: torch.Tensor
    fi_in: np.ndarray
    fi_out: np.ndarray
    # boundary faces
    fb_pts: torch.Tensor
    fb_w: torch.Tensor
    fb_n: torch.Tensor
    fb_hf: torch.Tensor
    fb_ext: torch.Tensor
    fb_in: np.ndarray


class PolyReducer:
    """Reduction of per-entity [n_e, nb] contributions onto polytopes: one
    ``SegmentSum`` (a padded gather map, built once) per index array."""

    def __init__(self, n_poly: int, device):
        self.n_poly = n_poly
        self.device = device
        self._cache = {}

    def __call__(self, contrib: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        # keyed by id, the entry holding the array: a collected array's id
        # could be reused and return a stale map
        key = id(idx)
        if key not in self._cache:
            self._cache[key] = (idx, SegmentSum(idx, self.n_poly,
                                                self.device))
        return self._cache[key][1](contrib)


class MatrixFreeLaplace:
    """v = A u for the SIPG Laplacian, basis evaluated on the fly, in
    ``dtype`` on ``device`` (every boundary face Dirichlet, as the JAX
    operator)."""

    def __init__(self, ah: AgglomerationHandler, penalty_constant=None,
                 dtype=torch.float32, *, device):
        self.ah = ah
        self.basis = ah.basis
        self.n_poly = ah.n_poly
        self.n_basis = ah.n_basis
        self.dtype = dtype
        self.device = torch.device(device)
        self.penalty_constant = (
            penalty_constant
            if penalty_constant is not None
            else default_penalty_constant(ah.degree, ah.dim)
        )
        self.reduce = PolyReducer(ah.n_poly, self.device)
        fi, fb = ah.faces.interior(), ah.faces.boundary()

        def a(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        self.geom = _Geometry(
            cell_pts=a(ah.cell_qpoints_unit),
            cell_w=a(ah.cell_qweights),
            cell_ext=a(ah.extents[ah.cell2poly]),
            cell2poly=ah.cell2poly,
            poly2cells=ah.poly2cells,
            fi_pts_in=a(fi.points_in),
            fi_pts_out=a(fi.points_out),
            fi_w=a(fi.weights),
            fi_n=a(fi.normals),
            fi_hf=a(fi.h_f),
            fi_ext_in=a(ah.extents[fi.poly_in]),
            fi_ext_out=a(ah.extents[fi.poly_out]),
            fi_in=fi.poly_in,
            fi_out=fi.poly_out,
            fb_pts=a(fb.points_in),
            fb_w=a(fb.weights),
            fb_n=a(fb.normals),
            fb_hf=a(fb.h_f),
            fb_ext=a(ah.extents[fb.poly_in]),
            fb_in=fb.poly_in,
        )
        g = self.geom
        # the gathers' device indices, made once
        self._idx = {k: torch.as_tensor(np.asarray(getattr(g, k)),
                                        dtype=torch.long, device=self.device)
                     for k in ("cell2poly", "fi_in", "fi_out", "fb_in")}

    def _tables(self, pts, ext):
        """(B [n, q, nb], G [n, q, nb, dim]): the basis and its physical
        gradient at unit points ``pts`` of bboxes with extents ``ext``."""
        B = self.basis.eval(pts).to(self.dtype)
        G = self.basis.grad(pts).to(self.dtype) / ext[:, None, None, :]
        return B, G

    # ------------------------------------------------------------------
    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """One operator application (the reference's vmult,
        utils.h:445-473); ``u`` is taken in the operator's dtype and the
        result is in it."""
        g = self.geom
        ix = self._idx
        ub = u.to(self.dtype).reshape(self.n_poly, self.n_basis)

        # --- cells: sum_q w (grad u . grad phi_i)
        _, Gc = self._tables(g.cell_pts, g.cell_ext)  # [n_c, q, nb, dim]
        u_c = ub[ix["cell2poly"]]  # [n_c, nb]
        gu = torch.einsum("cqid,ci->cqd", Gc, u_c)
        yc = torch.einsum("cqid,cqd,cq->ci", Gc, gu, g.cell_w)
        y = self.reduce(yc, g.cell2poly)

        # --- interior faces (both sides in one pass)
        if g.fi_in.shape[0] > 0:
            B0, G0 = self._tables(g.fi_pts_in, g.fi_ext_in)
            B1, G1 = self._tables(g.fi_pts_out, g.fi_ext_out)
            gn0 = torch.einsum("fqid,fqd->fqi", G0, g.fi_n)
            gn1 = torch.einsum("fqid,fqd->fqi", G1, g.fi_n)
            u0 = ub[ix["fi_in"]]
            u1 = ub[ix["fi_out"]]
            gamma = (self.penalty_constant / g.fi_hf)[:, None]
            # values and fluxes of u at the quadrature points
            v0 = torch.einsum("fqi,fi->fq", B0, u0)
            v1 = torch.einsum("fqi,fi->fq", B1, u1)
            dn0 = torch.einsum("fqi,fi->fq", gn0, u0)
            dn1 = torch.einsum("fqi,fi->fq", gn1, u1)
            jump = v0 - v1
            avg_dn = 0.5 * (dn0 + dn1)
            w = g.fi_w
            # y0_i += w (-avg_dn phi0_i - jump gn0_i / 2 + gamma jump phi0_i)
            y0 = (torch.einsum("fqi,fq->fi", B0, w * (-avg_dn + gamma * jump))
                  - 0.5 * torch.einsum("fqi,fq->fi", gn0, w * jump))
            # y1_i += w (avg_dn phi1_i - jump gn1_i / 2 - gamma jump phi1_i)
            y1 = (torch.einsum("fqi,fq->fi", B1, w * (avg_dn - gamma * jump))
                  - 0.5 * torch.einsum("fqi,fq->fi", gn1, w * jump))
            y = y + self.reduce(y0, g.fi_in)
            y = y + self.reduce(y1, g.fi_out)

        # --- boundary faces
        if g.fb_in.shape[0] > 0:
            Bb, Gb = self._tables(g.fb_pts, g.fb_ext)
            gnb = torch.einsum("fqid,fqd->fqi", Gb, g.fb_n)
            uB = ub[ix["fb_in"]]
            vb = torch.einsum("fqi,fi->fq", Bb, uB)
            dnb = torch.einsum("fqi,fi->fq", gnb, uB)
            gamma = (self.penalty_constant / g.fb_hf)[:, None]
            w = g.fb_w
            yb = (torch.einsum("fqi,fq->fi", Bb, w * (-dnb + gamma * vb))
                  - torch.einsum("fqi,fq->fi", gnb, w * vb))
            y = y + self.reduce(yb, g.fb_in)

        return y.reshape(-1)

    def __call__(self, u):
        return self.apply(u)

    def diagonal(self) -> torch.Tensor:
        """Exact operator diagonal for point-Jacobi/Chebyshev smoothing (the
        reference uses the basis-vector trick, utils.h:796-814; here it is a
        direct reduction)."""
        g = self.geom
        _, Gc = self._tables(g.cell_pts, g.cell_ext)
        dc = torch.einsum("cqid,cqid,cq->ci", Gc, Gc, g.cell_w)
        d = self.reduce(dc, g.cell2poly)
        if g.fi_in.shape[0] > 0:
            B0, G0 = self._tables(g.fi_pts_in, g.fi_ext_in)
            B1, G1 = self._tables(g.fi_pts_out, g.fi_ext_out)
            gn0 = torch.einsum("fqid,fqd->fqi", G0, g.fi_n)
            gn1 = torch.einsum("fqid,fqd->fqi", G1, g.fi_n)
            gamma = (self.penalty_constant / g.fi_hf)[:, None]
            w = g.fi_w
            d0 = torch.einsum("fqi,fqi,fq->fi", B0,
                              -gn0 + gamma[..., None] * B0, w)
            d1 = torch.einsum("fqi,fqi,fq->fi", B1,
                              gn1 + gamma[..., None] * B1, w)
            d = d + self.reduce(d0, g.fi_in)
            d = d + self.reduce(d1, g.fi_out)
        if g.fb_in.shape[0] > 0:
            Bb, Gb = self._tables(g.fb_pts, g.fb_ext)
            gnb = torch.einsum("fqid,fqd->fqi", Gb, g.fb_n)
            gamma = (self.penalty_constant / g.fb_hf)[:, None]
            db = torch.einsum("fqi,fqi,fq->fi", Bb,
                              -2.0 * gnb + gamma[..., None] * Bb, g.fb_w)
            d = d + self.reduce(db, g.fb_in)
        return d.reshape(-1)


class MatrixFreeMass:
    """v = M u (times an optional coefficient), the mass action of the
    monodomain operator's chi C_m / dt term (reference
    utils.h:1499-1559)."""

    def __init__(self, ah: AgglomerationHandler, coeff_fn=None,
                 dtype=torch.float32, *, device):
        self.ah = ah
        self.n_poly, self.n_basis = ah.n_poly, ah.n_basis
        self.dtype = dtype
        self.device = torch.device(device)
        self.pts = torch.as_tensor(ah.cell_qpoints_unit, dtype=dtype,
                                   device=self.device)
        w = torch.as_tensor(ah.cell_qweights, dtype=dtype, device=self.device)
        if coeff_fn is not None:
            w = w * coeff_fn(torch.as_tensor(ah.cell_qpoints_real,
                                             dtype=dtype, device=self.device))
        self.w = w
        self.cell2poly = ah.cell2poly
        self._c2p = torch.as_tensor(ah.cell2poly, dtype=torch.long,
                                    device=self.device)
        self.reduce = PolyReducer(ah.n_poly, self.device)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        B = self.ah.basis.eval(self.pts).to(self.dtype)
        ub = u.to(self.dtype).reshape(self.n_poly, self.n_basis)[self._c2p]
        vq = torch.einsum("cqi,ci->cq", B, ub)
        yc = torch.einsum("cqi,cq,cq->ci", B, vq, self.w)
        return self.reduce(yc, self.cell2poly).reshape(-1)

    def __call__(self, u):
        return self.apply(u)
