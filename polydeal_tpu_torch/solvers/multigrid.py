"""Polytopal (agglomerated) multigrid, the R3MG method, on torch tensors.

Counterpart of ``polydeal_tpu/solvers/multigrid.py`` on the flagship's
path: every level is a ``BlockBanded`` re-assembled directly on its own
polytopes (``mode='direct'``, ``level_assembly='banded'``), transfers are
one dense n_b x n_b embedding block per fine polytope, smoothing is
degree-k Chebyshev with point Jacobi, and the coarsest level is solved
directly.  The whole V-cycle runs in the transposed [nb, P] layout.

Levels with at least :data:`IMAJOR_MIN_P` polytopes carry the i-major
band copy, so their SpMVs run K1 and their smoothing steps and residuals
run K2 (ops/); smaller levels run K0 and fused K0 over the o-major band,
where the JAX package leaves the product and the update to XLA.  Every
smoothing step is one fused launch.  A level whose band has
many more offsets than a lane touches (the R-tree numbering without the
relabel) is packed (:func:`maybe_pack_level`, ``sparse.BlockPacked``) and
runs K6 and K7 instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from polydeal_tpu_torch.fem.quadrature import tensor_gauss
from polydeal_tpu_torch.handler import AgglomerationHandler
from polydeal_tpu_torch.solvers.cg import CGResult, cg_solve
from polydeal_tpu_torch.solvers.chebyshev import (
    ChebyshevSmoother,
    estimate_lambda_max,
)
from polydeal_tpu_torch.ops.packed import build_pack_plan
from polydeal_tpu_torch.sparse import BlockBanded, BlockPacked
from polydeal_tpu_torch.utils.grouping import padded_group_lists

__all__ = [
    "IMAJOR_MIN_P",
    "PACK_MIN_P",
    "build_embedding",
    "Transfer",
    "relabel_band_minimizing",
    "detect_grid_shapes",
    "build_rtree_hierarchy",
    "build_structured_hierarchy",
    "Multigrid",
    "level_pack_plan",
    "maybe_pack_level",
    "build_multigrid",
]

# Levels with at least this many polytopes get the i-major band copy and
# run the kernels; the threshold is the JAX package's (multigrid.py:691-696)
# so both packages lay out the same levels alike.  Its P % 128 rule is a
# TPU tiling constraint and has no counterpart here.
IMAJOR_MIN_P = 32768

# Levels with fewer polytopes stay banded whatever their width
# (:func:`level_pack_plan`): the JAX package's threshold
# (multigrid.py:944-988) without its TPU tiling rules, on every device,
# so the CPU lays a hierarchy out as the card does.
PACK_MIN_P = 4096


def build_embedding(
    coarse: AgglomerationHandler,
    fine: AgglomerationHandler,
    parent: np.ndarray,
    dtype=torch.float64,
    *,
    device,
) -> torch.Tensor:
    """E [n_fine_poly, n_b, n_b]: coefficients of each coarse basis
    function expressed in the child's basis (exact polynomial embedding);
    prolong: u_f[c] = E[c] @ u_c[parent[c]].

    The reference-cell mass matrix of the child basis is geometry-
    independent, so it is inverted once on the host in f64 (a batched
    device solve returned NaN at nb=20 on the TPU)."""
    basis = fine.basis
    pts_np, wts_np = tensor_gauss(fine.dim, fine.degree + 1)
    Bc = basis.eval(torch.from_numpy(pts_np)).numpy()  # host f64
    Mnp = np.einsum("qi,qk,q->ik", Bc, Bc, wts_np)
    Minv = torch.as_tensor(np.linalg.inv(Mnp), dtype=dtype, device=device)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    pts, wts = dev(pts_np), dev(wts_np)
    # affine child-unit -> parent-unit map
    s = dev(fine.extents[np.arange(fine.n_poly)]
            / coarse.extents[parent])  # [Pf, dim]
    o = dev((fine.bbox_lo - coarse.bbox_lo[parent])
            / coarse.extents[parent])
    parent_pts = o[:, None, :] + s[:, None, :] * pts[None, :, :]

    B_child = basis.eval(pts)  # [Q, nb]
    B_par = basis.eval(parent_pts)  # [Pf, Q, nb]
    R = torch.einsum("qi,pqj,q->pij", B_child, B_par, wts)
    return torch.einsum("ik,pkj->pij", Minv, R)


@dataclass
class Transfer:
    """Two-level transfer: fine polytopes -> coarse parents, in the
    transposed [nb, P] layout, on one of three paths:

    * ``grid_shape`` (fine-level block grid, lex order): prolongation
      repeats each coarse block to its 2^dim children, restriction is a
      reshape-sum;
    * uniform contiguous children (parent == arange // C): broadcast and
      reshape-sum;
    * otherwise a lane gather of the parent, and a masked gather-sum of
      the padded children."""

    E: torch.Tensor  # [P_f, nb, nb]
    parent: np.ndarray  # [P_f]
    n_coarse: int
    grid_shape: tuple | None = None
    children: np.ndarray = field(init=False, repr=False)  # [P_c, C], -1 pad
    _uniform_C: int = field(init=False, repr=False)
    _Et: torch.Tensor = field(init=False, repr=False)  # [nb, nb, P_f]

    def __post_init__(self):
        parent = np.asarray(self.parent)
        ch, counts = padded_group_lists(parent, self.n_coarse)
        self.children = ch
        C = int(counts[0]) if counts.size else 0
        uniform = (C > 0 and (counts == C).all() and np.array_equal(
            parent, np.arange(parent.shape[0]) // C))
        self._uniform_C = C if uniform else 0
        self._Et = self.E.permute(1, 2, 0).contiguous()
        if not uniform and self.grid_shape is None:
            dev = self.E.device
            self._parent_t = torch.as_tensor(parent, dtype=torch.long,
                                             device=dev)
            self._children_t = torch.as_tensor(
                np.maximum(ch, 0).reshape(-1), dtype=torch.long, device=dev)
            self._cmask_t = torch.as_tensor(ch >= 0, dtype=self.E.dtype,
                                            device=dev)

    def prolong_t(self, uct: torch.Tensor) -> torch.Tensor:
        """[nb, P_c] -> [nb, P_f]."""
        nb = self.E.shape[-1]
        if self.grid_shape is not None:
            g = self.grid_shape  # fine block grid, lex (axis 0 slowest)
            u = uct.reshape((nb,) + tuple(s // 2 for s in g))
            for ax in range(len(g)):  # each coarse block to its children
                u = torch.repeat_interleave(u, 2, dim=1 + ax)
            rep = u.reshape(nb, -1)
        elif self._uniform_C:
            C = self._uniform_C
            rep = uct[:, :, None].expand(nb, self.n_coarse, C).reshape(nb, -1)
        else:
            rep = uct[:, self._parent_t]  # lane gather
        return torch.einsum("ijp,jp->ip", self._Et, rep)

    def restrict_t(self, rft: torch.Tensor) -> torch.Tensor:
        """[nb, P_f] -> [nb, P_c]."""
        nb = self.E.shape[-1]
        t = torch.einsum("ijp,ip->jp", self._Et, rft)  # [nb, P_f]
        if self.grid_shape is not None:
            g = self.grid_shape
            t = t.reshape((nb,) + tuple(v for s in g for v in (s // 2, 2)))
            t = t.sum(dim=tuple(2 + 2 * ax for ax in range(len(g))))
            return t.reshape(nb, -1)
        if self._uniform_C:
            return t.reshape(nb, self.n_coarse, self._uniform_C).sum(dim=2)
        g = t[:, self._children_t].reshape(nb, *self.children.shape)
        return (g * self._cmask_t[None]).sum(dim=2)


def relabel_band_minimizing(c2p: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Relabel polytope ids to a pseudo-lexicographic (sliced) order of
    their centroids, minimizing the number of distinct banded-SpMV offsets
    (numpy copy of the JAX package's function; see there)."""
    from polydeal_tpu_torch.agglomeration.rtree import str_tile

    c2p = np.asarray(c2p)
    n_poly = int(c2p.max()) + 1
    counts = np.bincount(c2p, minlength=n_poly).astype(np.float64)
    cent = np.stack([
        np.bincount(c2p, weights=centers[:, d], minlength=n_poly) / counts
        for d in range(centers.shape[1])
    ], axis=1)
    rank = str_tile(cent, n_poly)  # one polytope per group = a permutation
    return rank[c2p].astype(np.int32)


def detect_grid_shapes(handlers, parents) -> list | None:
    """Grid-reshape-compatible transfers of a relabeled hierarchy: entry l
    is the fine-level grid of transfer l, or None when any level's parent
    map is not the canonical 2x grid coarsening (numpy copy of the JAX
    package's function)."""
    dim = handlers[0].dim
    shapes = []
    for l, parent in enumerate(parents):
        P_f = handlers[l + 1].n_poly
        P_c = handlers[l].n_poly
        m = round(P_f ** (1.0 / dim))
        if m**dim != P_f or m % 2 or (m // 2) ** dim != P_c:
            return None
        ids = np.arange(P_f)
        coords = []
        rem = ids
        for d in range(dim):
            stride = m ** (dim - 1 - d)
            coords.append(rem // stride)
            rem = rem % stride
        pat = np.zeros(P_f, dtype=np.int64)
        for d in range(dim):
            pat = pat * (m // 2) + coords[d] // 2
        if not np.array_equal(np.asarray(parent), pat):
            return None
        shapes.append((m,) * dim)
    return shapes


def build_rtree_hierarchy(
    mesh,
    rtree,
    extraction_levels: list[int],
    degree: int = 1,
    family: str = "dgp",
    include_fine_dg: bool = True,
    n_quad: int | None = None,
    relabel: str | None = None,
):
    """Handlers + parent maps for a chain of R-tree extraction levels
    (coarse to fine; numpy copy of the JAX package's function).  With
    ``include_fine_dg`` the trivial agglomeration (one cell per polytope,
    numbered by STR leaf rank) is appended as the finest level;
    ``relabel='lex'`` renumbers every level in sliced-lexicographic
    centroid order.  Returns (handlers, parents): parents[l] maps
    level-(l+1) polytopes to level-l polytopes."""
    levels = sorted(extraction_levels)
    c2ps = [rtree.extract_agglomerates(l) for l in levels]
    if include_fine_dg:
        c2ps.append(rtree.extract_agglomerates(rtree.n_levels - 1))
    if relabel == "lex":
        centers = np.asarray(mesh.cell_centers())
        c2ps = [relabel_band_minimizing(c2p, centers) for c2p in c2ps]
    elif relabel is not None:
        raise ValueError(f"unknown relabel scheme: {relabel!r}")
    handlers = [
        AgglomerationHandler(mesh, c2p, degree=degree, family=family,
                             n_quad=n_quad)
        for c2p in c2ps
    ]
    parents = []
    for l in range(len(c2ps) - 1):
        fine_c2p, coarse_c2p = c2ps[l + 1], c2ps[l]
        n_f = int(fine_c2p.max()) + 1
        parent = np.full(n_f, -1, dtype=np.int64)
        parent[fine_c2p] = coarse_c2p  # every cell agrees: nested hierarchy
        if not (parent >= 0).all():
            raise ValueError("hierarchy is not nested")
        parents.append(parent)
    return handlers, parents


def build_structured_hierarchy(
    mesh,
    n: int,
    degree: int = 1,
    family: str = "dgp",
    coarsest_side: int = 2,
    n_quad: int | None = None,
):
    """Structured fast path: lexicographic block agglomeration on a
    hyper_cube mesh (n cells per side, power of two), every level in
    lexicographic order (2 dim + 1 band offsets) with grid-reshape
    transfers (numpy copy of the JAX package's function).  Levels have
    side coarsest_side, 2 coarsest_side, ..., n.  Returns (handlers,
    parents, grid_shapes)."""
    dim = mesh.dim
    if n & (n - 1) or n < 2:
        raise ValueError("n must be a power of two")
    if mesh.n_cells != n**dim:
        raise ValueError(f"mesh has {mesh.n_cells} cells, not {n}^{dim}")
    sides = []
    s = coarsest_side
    while s <= n:
        sides.append(s)
        s *= 2
    # cell coords in lex order (axis 0 slowest)
    ids = np.arange(n**dim)
    coords = []
    rem = ids
    for d in range(dim):
        stride = n ** (dim - 1 - d)
        coords.append(rem // stride)
        rem = rem % stride
    coords = np.stack(coords, axis=1)  # [n_cells, dim]

    c2ps = []
    for m in sides:
        b = n // m
        bc = coords // b  # block coords
        lex = np.zeros(ids.shape[0], dtype=np.int64)
        for d in range(dim):
            lex = lex * m + bc[:, d]
        c2ps.append(lex.astype(np.int32))
    handlers = [
        AgglomerationHandler(mesh, c2p, degree=degree, family=family,
                             n_quad=n_quad)
        for c2p in c2ps
    ]
    parents = []
    grid_shapes = []
    for li in range(len(sides) - 1):
        m = sides[li + 1]  # fine side
        pf = np.arange(m**dim)
        fc = []
        rem = pf
        for d in range(dim):
            stride = m ** (dim - 1 - d)
            fc.append(rem // stride)
            rem = rem % stride
        par = np.zeros(m**dim, dtype=np.int64)
        for d in range(dim):
            par = par * (m // 2) + fc[d] // 2
        parents.append(par)
        grid_shapes.append((m,) * dim)
    return handlers, parents, grid_shapes


def _with_imajor_if_big(e: BlockBanded,
                        drop_omajor: bool = False) -> BlockBanded:
    """The level's band with the i-major copy attached when the level
    has at least :data:`IMAJOR_MIN_P` polytopes; the one place that
    decides which banded levels run K1/K2 (the others run K0 and fused K0;
    a packed level runs K6/K7)."""
    if (isinstance(e, BlockBanded) and e.data_i is None
            and e.n_block_rows >= IMAJOR_MIN_P):
        return e.with_imajor(drop_omajor=drop_omajor)
    return e


@dataclass
class Multigrid:
    """V-cycle over directly re-assembled banded or packed levels;
    ``ells[0]`` is the coarsest (always banded).  Chebyshev(degree) +
    point-Jacobi smoothing on every level, a direct solve at the bottom,
    wrapped as a CG preconditioner (the reference's flagship composition,
    agglo_amg.cc:1278-1414)."""

    ells: list  # BlockBanded or BlockPacked, coarse -> fine
    transfers: list  # transfers[l]: level l <- l+1
    n_smooth: int = 5
    chebyshev_degree: int = 3
    # (Ainv,): explicit dense inverse, one matmul; (LU, pivots): LU solve
    coarse_lu: tuple = ()
    dinvs_t: list = field(default_factory=list)  # [nb, P] per level
    los: list = field(default_factory=list)  # smoothing interval, floats
    his: list = field(default_factory=list)
    # low-precision band copies for the smoother's SpMVs only
    # (precond_dtype); vectors stay in the operator dtype.  A packed level
    # keeps its operator object there: no low-precision copy
    lo_ells: list | None = None

    @classmethod
    def setup(
        cls,
        matrices: list,
        transfers: list,
        chebyshev_degree: int = 3,
        n_smooth: int = 5,
        smoothing_range: float = 15.0,
        precond_dtype=None,
        coarse_solver: str = "lu",
    ) -> "Multigrid":
        """Eigenvalue estimates, Jacobi diagonals and the coarse solve.
        The smoothing intervals become Python floats here, once, so the
        V-cycle never waits on the device for them."""
        ells = [_with_imajor_if_big(A) for A in matrices]
        lams = []
        for Ae in ells[1:]:
            inv = 1.0 / Ae.diagonal()
            lams.append(estimate_lambda_max(
                Ae.matvec, lambda r, inv=inv: inv * r, Ae.shape[0], iters=25,
                dtype=Ae.dtype, device=inv.device))
        A0 = ells[0].to_dense()
        if coarse_solver == "inv":
            coarse_lu = (torch.linalg.inv(A0),)
        elif coarse_solver == "lu":
            coarse_lu = tuple(torch.linalg.lu_factor(A0))
        else:
            raise ValueError(f"unknown coarse solver: {coarse_solver!r}")
        lo_ells = None
        if precond_dtype is not None:
            lo_ells = [e if isinstance(e, BlockPacked)
                       else _with_imajor_if_big(BlockBanded(
                           e.data.to(precond_dtype), e.offsets,
                           e.n_block_cols,
                           None if e.data_i is None
                           else e.data_i.to(precond_dtype)))
                       for e in ells]
        return cls(
            ells=ells,
            transfers=transfers,
            n_smooth=n_smooth,
            chebyshev_degree=chebyshev_degree,
            coarse_lu=coarse_lu,
            dinvs_t=[None] + [1.0 / Ae.diagonal_t() for Ae in ells[1:]],
            los=[None] + [lam / smoothing_range for lam in lams],
            his=[None] + [1.2 * lam for lam in lams],
            lo_ells=lo_ells,
        )

    @property
    def n_levels(self) -> int:
        return len(self.ells)

    def _to_t(self, level: int, b_flat: torch.Tensor) -> torch.Tensor:
        return b_flat.reshape(-1, self.ells[level].n_basis).T.contiguous()

    @staticmethod
    def _fused_ok(A, b: torch.Tensor) -> bool:
        """Fused smoothing and residuals for f32 and f64 vectors: K2 on
        every level that carries the i-major copy, fused K0 on every other
        banded level, K7 on every packed level without a far tail."""
        return A.fused_cheb_ok() and b.dtype in (torch.float32,
                                                 torch.float64)

    def _residual(self, A, x, b):
        """r = b - A x, through K2, fused K0 or K7 where the level allows
        it."""
        if self._fused_ok(A, b):
            return A.residual_t(x, b)
        return b - A.matvec_t(x)

    def _cycle(self, level: int, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle from ``level`` down; b and the result are [nb, P]."""
        if level == 0:
            M = self.coarse_lu
            bl = b.to(M[0].dtype).T.reshape(-1)
            if len(M) == 1:  # explicit inverse: one matmul
                x = M[0] @ bl
            else:
                x = torch.linalg.lu_solve(M[0], M[1], bl[:, None])[:, 0]
            return x.reshape(-1, b.shape[0]).T.to(b.dtype)
        A = (self.lo_ells if self.lo_ells is not None else self.ells)[level]
        b = b.contiguous()
        dinv = self.dinvs_t[level]
        step_fn = None
        if self._fused_ok(A, b):
            # b is bound by closure: every sm(b, ...) call below passes the
            # same level rhs
            step_fn = (lambda xx, dd, c1, c2: A.cheb_step_t(
                xx, dd, b, dinv, c1, c2))
        sm = ChebyshevSmoother(A=A.matvec_t, Minv=lambda r: dinv * r,
                               lo=self.los[level], hi=self.his[level],
                               degree=self.chebyshev_degree,
                               step_fn=step_fn)
        x = torch.zeros_like(b)
        first = True
        for _ in range(self.n_smooth):
            x = sm(b, x, x_is_zero=first)  # pre-smooth starts from zero
            first = False
        r = self._residual(A, x, b)
        t = self.transfers[level - 1]
        xc = self._cycle(level - 1, t.restrict_t(r))
        x = (x + t.prolong_t(xc)).to(b.dtype)
        for _ in range(self.n_smooth):
            x = sm(b, x)
        return x

    def fmg_guess(self, b: torch.Tensor) -> torch.Tensor:
        """Full-multigrid initial guess: restrict b to every level, solve
        the coarsest directly, then prolong upward with one V-cycle defect
        correction per level.  ``b`` is the fine level's [nb, P] rhs."""
        top = self.n_levels - 1
        bs = [None] * self.n_levels
        bs[top] = b
        for level in range(top, 0, -1):
            bs[level - 1] = self.transfers[level - 1].restrict_t(bs[level])
        x = self._cycle(0, bs[0])
        for level in range(1, self.n_levels):
            bl = bs[level]
            x = self.transfers[level - 1].prolong_t(x).to(bl.dtype)
            # the residual uses the TRUE (full-precision) level operator
            r = self._residual(self.ells[level], x, bl)
            x = x + self._cycle(level, r).to(x.dtype)
        return x

    def v_cycle(self, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle on the flat fine-level vector (a CG
        preconditioner); the result has ``b``'s dtype."""
        top = self.n_levels - 1
        return self._cycle(top, self._to_t(top, b)).to(b.dtype).T.reshape(-1)

    def solve_cg(self, b: torch.Tensor, rtol: float = 1e-9,
                 maxiter: int = 200, fmg: bool = False) -> CGResult:
        """MG-preconditioned CG on the flat rhs ``b``, run in the [nb, P]
        layout; ``fmg=True`` starts from :meth:`fmg_guess`."""
        top = self.n_levels - 1
        bt = self._to_t(top, b)
        x0 = self.fmg_guess(bt) if fmg else None
        res = cg_solve(self.ells[top].matvec_t, bt, x0=x0,
                       M=lambda r: self._cycle(top, r).to(r.dtype),
                       rtol=rtol, maxiter=maxiter)
        return CGResult(x=res.x.T.reshape(-1), iterations=res.iterations,
                        residual=res.residual)


def level_pack_plan(h: AgglomerationHandler, offsets):
    """(plan, oid) of the level's packed format when it pays, else None;
    the one rule for every level (the fine one included) on every device.

    An ordering without the relabel gives ~6 dim band offsets while each
    lane touches <= 2 dim + 1, so the dense band streams ~n_off/K times
    the data a product needs.  A level is packed when it has at least
    :data:`PACK_MIN_P` polytopes, more than 2 dim + 3 offsets (checked
    before any plan is built) and a plan of K + 2 < n_off slots.  The plan
    colours every offset into the slots (``near_limit=-1``): the kernels
    load x at any offset, so there is no far tail."""
    n_off = len(offsets)
    if h.n_poly < PACK_MIN_P or n_off <= 2 * h.dim + 3:
        return None
    ft = h.faces
    interior = ~ft.is_boundary
    plan, oid, _, _ = build_pack_plan(
        ft.poly_in[interior], ft.poly_out[interior], h.n_poly, h.n_basis,
        offsets=offsets, near_limit=-1)
    if plan.K + 2 >= n_off:
        return None  # the lanes touch most offsets: the band is as tight
    return plan, oid


def maybe_pack_level(h: AgglomerationHandler, A):
    """The level's band in the packed format (``sparse.BlockPacked``) where
    :func:`level_pack_plan` says so; anything else passes through."""
    pp = (level_pack_plan(h, A.offsets) if isinstance(A, BlockBanded)
          else None)
    if pp is None:
        return A
    plan, oid = pp
    return A.to_packed(plan, torch.as_tensor(oid, device=A.data.device))


def build_multigrid(
    handlers: list,
    parents: list,
    A_fine,
    chebyshev_degree: int = 3,
    n_smooth: int = 5,
    smoothing_range: float = 20.0,
    grid_shapes: list | None = None,
    precond_dtype=None,
    dtype=torch.float64,
    coarse_solver: str = "lu",
    *,
    device,
) -> Multigrid:
    """The R3MG preconditioner from a handler chain (coarse to fine) and
    the finest-level band (or pack): SIPG re-assembled directly on every
    coarser level (the JAX package's ``mode='direct'``, ``level_assembly=
    'banded'``), so the penalty scales with each level's h.  Every level
    but the coarsest goes through :func:`maybe_pack_level`; a fine level
    that arrives packed passes through."""
    from polydeal_tpu_torch.assembly.sipg import (
        assemble_sipg_banded_direct,
        build_banded_groups,
    )

    matrices = []
    for li, h in enumerate(handlers[:-1]):
        ft = h.faces
        interior = ~ft.is_boundary
        diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
        offs = np.unique(np.concatenate(
            [diffs, -diffs, np.zeros(1, dtype=np.int64)]))
        groups = build_banded_groups(h, offs, dtype, device=device)
        A_l = assemble_sipg_banded_direct(h, groups, offsets=offs)
        del groups
        # the coarsest level stays banded: its direct solve needs to_dense
        matrices.append(A_l if li == 0 else maybe_pack_level(h, A_l))
    # the fine level is read only through the kernels' layout when it has
    # one, so its o-major copy goes
    matrices.append(_with_imajor_if_big(
        maybe_pack_level(handlers[-1], A_fine), drop_omajor=True))
    transfers = [
        Transfer(E=build_embedding(handlers[l], handlers[l + 1], parents[l],
                                   dtype=dtype, device=device),
                 parent=parents[l], n_coarse=handlers[l].n_poly,
                 grid_shape=None if grid_shapes is None else grid_shapes[l])
        for l in range(len(handlers) - 1)
    ]
    return Multigrid.setup(matrices, transfers,
                           chebyshev_degree=chebyshev_degree,
                           n_smooth=n_smooth, smoothing_range=smoothing_range,
                           precond_dtype=precond_dtype,
                           coarse_solver=coarse_solver)
