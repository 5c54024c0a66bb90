"""Mixed / multi-domain DG assembly on torch tensors.

Counterpart of ``polydeal_tpu/assembly/mixed.py``, the array machinery of
the coupled-flow models (the reference's examples/darcy_stokes.cc and
examples/oseen.cc): block operators between the
:class:`~polydeal_tpu_torch.fem.system.Field`s of a system, which live on
different subdomains with different bases, assembled from batched einsums
over face and volume tables.  Each face class (Stokes-Stokes,
Darcy-Darcy, interface, boundary) is one static index selection at setup
and one einsum batch.  Every reduction (merging duplicate blocks, the
product's sum by row, the rhs) goes through
``utils/segment.SegmentSum``: one fixed order on a device, so a GMRES
count does not move from run to run.

Sign conventions follow the reference (darcy_stokes.cc:1019-1664,
oseen.cc:824-1240): jump [v] = v_in - v_out, average {v} = (v_in +
v_out)/2, the normal outward from the "in" side.
"""

from __future__ import annotations

import numpy as np
import torch

from polydeal_tpu_torch.handler import FaceTable
from polydeal_tpu_torch.utils.segment import SegmentSum, segment_sum

__all__ = [
    "swap_sides",
    "face_side_tables",
    "MixedOperator",
    "MixedRhs",
    "expand_vector_blocks",
    "stokes_interior_blocks",
    "stokes_boundary_blocks",
    "stokes_boundary_rhs",
    "scalar_interior_blocks",
    "bjs_interface_blocks",
]


def swap_sides(ft: FaceTable, diameters: np.ndarray,
               mask: np.ndarray) -> FaceTable:
    """Swap in/out on the masked rows (flipping their normals), e.g. so
    that side 0 is always the Stokes side of a Stokes-Darcy interface face
    (darcy_stokes.cc:1569-1572)."""
    m = np.asarray(mask, dtype=bool)
    pin = np.where(m, ft.poly_out, ft.poly_in)
    pout = np.where(m, ft.poly_in, ft.poly_out)
    sgn = np.where(m, -1.0, 1.0)[:, None, None]
    return FaceTable(
        poly_in=pin.astype(ft.poly_in.dtype),
        poly_out=pout.astype(ft.poly_out.dtype),
        points_real=ft.points_real,
        points_in=np.where(m[:, None, None], ft.points_out, ft.points_in),
        points_out=np.where(m[:, None, None], ft.points_in, ft.points_out),
        weights=ft.weights,
        normals=ft.normals * sgn,
        h_f=diameters[pin],
    )


def face_side_tables(basis, ft: FaceTable, side: int, extents, dtype, *,
                     device):
    """(B [f, q, nb], G real gradients [f, q, nb, dim]) of ``basis`` on
    one side of the face rows ``ft``."""
    pts = ft.points_in if side == 0 else ft.points_out
    poly = ft.poly_in if side == 0 else ft.poly_out
    pts = torch.as_tensor(pts, dtype=dtype, device=device)
    B = basis.eval(pts).to(dtype)
    G = basis.grad(pts).to(dtype)
    ext = torch.as_tensor(extents[np.maximum(poly, 0)], dtype=dtype,
                          device=device)
    return B, G / ext[:, None, None, :]


class MixedOperator:
    """Block operator between the fields of a :class:`SystemSpace`.

    Entries accumulate as (field-local block rows, cols, dense values)
    triplets per (test, trial) field pair; duplicates merge in
    :meth:`finalize`.  :meth:`matvec` is the solve's product (a gather,
    batched block products and a deterministic sum by row per pair);
    :meth:`to_dense` serves the direct solve (the reference's UMFPACK
    path, darcy_stokes.cc:1688-1696)."""

    def __init__(self, space):
        self.space = space
        self._entries = {}  # (test, trial) -> list[(rows, cols, vals)]
        self._merged = None
        self._plans = None  # (test, trial) -> (cols tensor, SegmentSum)

    def add(self, test: str, trial: str, rows, cols, vals: torch.Tensor):
        """rows/cols are FIELD-LOCAL polytope indices (host numpy); vals
        is [n, block_test, block_trial]."""
        if vals.dim() != 3:
            raise ValueError(f"blocks must be 3-d, got {tuple(vals.shape)}")
        ft, fl = self.space.fields[test], self.space.fields[trial]
        if vals.shape[1] != ft.block or vals.shape[2] != fl.block:
            raise ValueError(
                f"({test}, {trial}) blocks {tuple(vals.shape)} do not fit "
                f"blocks {ft.block} x {fl.block}")
        self._entries.setdefault((test, trial), []).append(
            (np.asarray(rows, dtype=np.int64),
             np.asarray(cols, dtype=np.int64), vals))
        self._merged = None
        self._plans = None

    def finalize(self) -> dict:
        """Merge duplicate (row, col) blocks per field pair:
        {(test, trial): (rows, cols, data)}, rows/cols sorted host
        arrays."""
        if self._merged is not None:
            return self._merged
        merged = {}
        for key, ent in self._entries.items():
            rows = np.concatenate([e[0] for e in ent])
            cols = np.concatenate([e[1] for e in ent])
            vals = torch.cat([e[2] for e in ent], dim=0)
            ncols = self.space.fields[key[1]].n_polys
            k = rows * ncols + cols
            uniq, inv = np.unique(k, return_inverse=True)
            data = segment_sum(vals, inv.reshape(-1), uniq.shape[0])
            merged[key] = ((uniq // ncols), (uniq % ncols), data)
        self._merged = merged
        return merged

    def _plan(self, key):
        """The pair's column gather and row sum, made once."""
        if self._plans is None:
            self._plans = {}
        if key not in self._plans:
            rows, cols, data = self.finalize()[key]
            n_rows = self.space.fields[key[0]].n_polys
            self._plans[key] = (
                torch.as_tensor(cols, device=data.device),
                SegmentSum(rows, n_rows, data.device))
        return self._plans[key]

    def _pair_apply(self, key, xb: torch.Tensor) -> torch.Tensor:
        data = self.finalize()[key][2]
        cols_t, row_sum = self._plan(key)
        return row_sum(torch.einsum("kij,kj->ki", data, xb[cols_t]))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        sp = self.space
        out = {}
        for (test, trial) in self.finalize():
            fl = sp.fields[trial]
            xb = x[sp.dof_slice(trial)].reshape(fl.n_polys, fl.block)
            yb = self._pair_apply((test, trial), xb)
            out[test] = yb if test not in out else out[test] + yb
        parts = {}
        for name, f in sp.fields.items():
            parts[name] = out.get(name, x.new_zeros((f.n_polys, f.block)))
        return sp.pack(parts)

    def block_apply(self, test: str, trial: str,
                    xb: torch.Tensor) -> torch.Tensor:
        """y = A[test, trial] @ x_trial on field-local block vectors
        ([n_polys_trial, block_trial] -> [n_polys_test, block_test]); zero
        when the pair never assembled (the coupling terms of the
        block-triangular preconditioners)."""
        ft = self.space.fields[test]
        if (test, trial) not in self.finalize():
            return xb.new_zeros((ft.n_polys, ft.block))
        return self._pair_apply((test, trial), xb)

    def diag_blocks(self, name: str) -> torch.Tensor:
        """[n_polys, block, block] per-polytope diagonal blocks of the
        (name, name) pair (zero where absent)."""
        f = self.space.fields[name]
        merged = self.finalize()
        ref = next(iter(merged.values()))[2]
        D = ref.new_zeros((f.n_polys, f.block, f.block))
        if (name, name) in merged:
            rows, cols, data = merged[(name, name)]
            d = np.nonzero(rows == cols)[0]
            # the merged pairs are unique: one block per diagonal entry
            D[torch.as_tensor(rows[d], device=data.device)] = data[
                torch.as_tensor(d, device=data.device)]
        return D

    def block_jacobi(self):
        """Field-wise block-Jacobi preconditioner: each field's
        per-polytope diagonal block inverted (zero blocks replaced by the
        identity)."""
        sp = self.space
        invs = {}
        for name, f in sp.fields.items():
            D = self.diag_blocks(name)
            eye = torch.eye(f.block, dtype=D.dtype, device=D.device)
            nz = D.abs().sum((1, 2), keepdim=True) > 0
            invs[name] = torch.linalg.inv(torch.where(nz, D, eye[None]))

        def apply(r):
            parts = {}
            for name, f in sp.fields.items():
                rb = r[sp.dof_slice(name)].reshape(f.n_polys, f.block)
                parts[name] = torch.einsum("pij,pj->pi",
                                           invs[name].to(r.dtype), rb)
            return sp.pack(parts)

        return apply

    def to_dense(self) -> torch.Tensor:
        sp = self.space
        merged = self.finalize()
        data0 = next(iter(merged.values()))[2]
        out = data0.new_zeros((sp.n_dofs, sp.n_dofs))
        for (test, trial), (rows, cols, data) in merged.items():
            ft, fl = sp.fields[test], sp.fields[trial]
            blk = data.new_zeros((ft.n_polys, fl.n_polys, ft.block, fl.block))
            # the merged pairs are unique: a plain scatter
            blk[torch.as_tensor(rows, device=data.device),
                torch.as_tensor(cols, device=data.device)] = data
            out[sp.dof_slice(test), sp.dof_slice(trial)] = blk.permute(
                0, 2, 1, 3).reshape(ft.n_dofs, fl.n_dofs)
        return out


class MixedRhs:
    """Per-field rhs accumulator (field-local rows, block values)."""

    def __init__(self, space):
        self.space = space
        self._entries = {name: [] for name in space.fields}

    def add(self, field: str, rows, vals: torch.Tensor):
        self._entries[field].append((np.asarray(rows, dtype=np.int64), vals))

    def finalize(self, dtype=torch.float64, *, device) -> torch.Tensor:
        parts = {}
        for name, f in self.space.fields.items():
            acc = torch.zeros((f.n_polys, f.block), dtype=dtype,
                              device=device)
            for rows, vals in self._entries[name]:
                acc = acc + segment_sum(vals.reshape(vals.shape[0], f.block),
                                        rows, f.n_polys)
            parts[name] = acc
        return self.space.pack(parts)


def expand_vector_blocks(scalar_blocks: torch.Tensor, dim: int):
    """[f, i, j] scalar blocks -> [f, dim*i, dim*j] = blocks (x) I_dim
    (vector components decouple)."""
    f, ni, nj = scalar_blocks.shape
    eye = torch.eye(dim, dtype=scalar_blocks.dtype,
                    device=scalar_blocks.device)
    out = torch.einsum("fij,de->fdiej", scalar_blocks, eye)
    return out.reshape(f, dim * ni, dim * nj)


def _vec(shape4: torch.Tensor) -> torch.Tensor:
    """[f, d, i, e, j] -> [f, d*i, e*j]."""
    f, d, i, e, j = shape4.shape
    return shape4.reshape(f, d * i, e * j)


def _mm(a, b, w):
    return torch.einsum("fqi,fqj,fq->fij", a, b, w)


def stokes_interior_blocks(Bv, Gv, Bp, w, n, sigma_v, sigma_p, nu,
                           beta=None):
    """All 16 SIPG face blocks of a velocity-pressure DG pair on one
    interior face set (darcy_stokes.cc:1190-1412):

      nu [v].({grad u}n) - nu [u].({grad v}n) + sigma_v [v].[u]
      + {p}[v].n - {q}[u].n + sigma_p [p][q]  (- (beta.n) v_down.[u])

    Per side s: Bv[s] [f,q,nbv], Gv[s] [f,q,nbv,dim], Bp[s] [f,q,nbp]; w
    [f,q]; n [f,q,dim] outward from side 0; sigma_v/sigma_p [f]; optional
    beta [f,q,dim] adds the upwind convective term (oseen.cc:1086-1240).
    Returns {(('v', s), ('v', t)): [f, dim*nbv, dim*nbv], ...}."""
    dim = n.shape[-1]
    jsign = (1.0, -1.0)  # [v] = v0 - v1, {v} = (v0 + v1)/2
    Gn = [torch.einsum("fqid,fqd->fqi", Gv[s], n) for s in (0, 1)]
    sv = sigma_v[:, None]
    sp_ = sigma_p[:, None]
    if beta is not None:
        bn = torch.einsum("fqd,fqd->fq", beta, n)
        # downwind side: inflow (beta.n < 0) -> side 0, else side 1, with
        # the reference's sign pattern (oseen.cc:1027-1063)
        inflow = bn < 0
        one = torch.ones_like(bn)
        down_sign = [torch.where(inflow, one, -one),
                     torch.where(inflow, -one, one)]
    out = {}
    for s in (0, 1):
        for t in (0, 1):
            ji, jj = jsign[s], jsign[t]
            m = (-nu * 0.5 * ji * _mm(Bv[s], Gn[t], w)
                 - nu * 0.5 * jj * _mm(Gn[s], Bv[t], w)
                 + ji * jj * _mm(Bv[s], Bv[t], w * sv))
            if beta is not None:
                m = m - jj * _mm(Bv[s], Bv[t], w * bn * down_sign[s])
            out[(("v", s), ("v", t))] = expand_vector_blocks(m, dim)
            out[(("p", s), ("p", t))] = ji * jj * _mm(Bp[s], Bp[t], w * sp_)
            # + {p}[v].n : test v side s, trial p side t
            vp = 0.5 * ji * torch.einsum("fqi,fqj,fqd,fq->fdij",
                                         Bv[s], Bp[t], n, w)
            f_, d_, i_, j_ = vp.shape
            out[(("v", s), ("p", t))] = vp.reshape(f_, d_ * i_, j_)
            # - {q}[u].n : test p side s, trial v side t
            pv = -0.5 * jj * torch.einsum("fqi,fqj,fqd,fq->fidj",
                                          Bp[s], Bv[t], n, w)
            fp_, ip_, dp_, jp_ = pv.shape
            out[(("p", s), ("v", t))] = pv.reshape(fp_, ip_, dp_ * jp_)
    return out


def stokes_boundary_blocks(Bv, Gv, Bp, w, n, sigma_v, nu, beta=None):
    """Boundary (Nitsche weak-Dirichlet) blocks: one side, jump = average
    = own value (darcy_stokes.cc:1019-1101; oseen's upwind boundary,
    oseen.cc:845-870)."""
    dim = n.shape[-1]
    Gn = torch.einsum("fqid,fqd->fqi", Gv, n)
    sv = sigma_v[:, None]
    m = (-nu * _mm(Bv, Gn, w) - nu * _mm(Gn, Bv, w) + _mm(Bv, Bv, w * sv))
    if beta is not None:
        bn = torch.einsum("fqd,fqd->fq", beta, n)
        inflow = (bn < 0).to(w.dtype)
        m = m - _mm(Bv, Bv, w * bn * inflow)
    out = {("v", "v"): expand_vector_blocks(m, dim)}
    vp = torch.einsum("fqi,fqj,fqd,fq->fdij", Bv, Bp, n, w)
    f_, d_, i_, j_ = vp.shape
    out[("v", "p")] = vp.reshape(f_, d_ * i_, j_)
    pv = -torch.einsum("fqi,fqj,fqd,fq->fidj", Bp, Bv, n, w)
    out[("p", "v")] = pv.reshape(f_, j_, d_ * i_)
    return out


def stokes_boundary_rhs(Bv, Gv, Bp, w, n, sigma_v, nu, g, beta=None):
    """Dirichlet-data rhs on the velocity boundary, test-v and test-p
    parts (darcy_stokes.cc:1083-1100; oseen.cc:896-910); g [f, q, dim]."""
    Gn = torch.einsum("fqid,fqd->fqi", Gv, n)
    sv = sigma_v[:, None]
    rv = (-nu * torch.einsum("fqi,fqd,fq->fdi", Gn, g, w)
          + torch.einsum("fqi,fqd,fq->fdi", Bv, g, w * sv))
    if beta is not None:
        bn = torch.einsum("fqd,fqd->fq", beta, n)
        inflow = (bn < 0).to(w.dtype)
        rv = rv - torch.einsum("fqi,fqd,fq->fdi", Bv, g, w * bn * inflow)
    gn = torch.einsum("fqd,fqd->fq", g, n)
    rp = -torch.einsum("fqi,fq,fq->fi", Bp, gn, w)
    f_, d_, i_ = rv.shape
    return rv.reshape(f_, d_ * i_), rp


def scalar_interior_blocks(B, G, w, n, sigma, kappa=1.0):
    """Scalar SIPG face blocks (the Darcy pressure,
    darcy_stokes.cc:1415-1546): {(s, t): [f, nb, nb]} with
    - [q]({K grad p}.n) - [p]({K grad q}.n) + sigma [p][q]."""
    jsign = (1.0, -1.0)
    Gn = [kappa * torch.einsum("fqid,fqd->fqi", G[s], n) for s in (0, 1)]
    sg = sigma[:, None]
    out = {}
    for s in (0, 1):
        for t in (0, 1):
            ji, jj = jsign[s], jsign[t]
            out[(s, t)] = (-0.5 * ji * _mm(B[s], Gn[t], w)
                           - 0.5 * jj * _mm(Gn[s], B[t], w)
                           + ji * jj * _mm(B[s], B[t], w * sg))
    return out


def bjs_interface_blocks(Bv, BpD, w, n, nu_over_G):
    """Beavers-Joseph-Saffman interface blocks (darcy_stokes.cc:51-101,
    1548-1664); side 0 = Stokes velocity, side 1 = Darcy pressure, n from
    Stokes into Darcy:

        + p_D (v.n)  - q_D (u.n)  + (nu/G) u_tau . v_tau

    (tangential projector form u_tau = u - (u.n) n).  Returns
    {('v','p'): [f, dim*nbv, nbpD], ('p','v'): ..., ('v','v'): ...}."""
    dim = n.shape[-1]
    f_ = Bv.shape[0]
    vp = torch.einsum("fqi,fqj,fqd,fq->fdij", Bv, BpD, n, w)
    fdij = vp.shape
    out = {("v", "p"): vp.reshape(f_, dim * fdij[2], fdij[3])}
    pv = -torch.einsum("fqi,fqj,fqd,fq->fidj", BpD, Bv, n, w)
    out[("p", "v")] = pv.reshape(f_, fdij[3], dim * fdij[2])
    eye = torch.eye(dim, dtype=n.dtype, device=n.device)
    T = eye[None, None] - torch.einsum("fqd,fqe->fqde", n, n)
    vv = nu_over_G * torch.einsum("fqde,fqi,fqj,fq->fdiej", T, Bv, Bv, w)
    out[("v", "v")] = _vec(vv)
    return out
