"""Polytopal (agglomerated) multigrid, the R3MG method, on torch tensors.

Counterpart of ``polydeal_tpu/solvers/multigrid.py``.  Levels are
re-assembled directly on their own polytopes (``mode='direct'``: into the
band with ``level_assembly='banded'``, or by the table path into a
block-COO ``BlockMatrix`` with ``'tables'``) or Galerkin-coarsened from the
fine matrix (``mode='galerkin'``); transfers are one dense n_b x n_b
embedding block per fine polytope, smoothing is degree-k Chebyshev with
point Jacobi (per-level schedules allowed), and the coarsest level is
solved directly.  ``Multigrid.setup`` turns a ``BlockMatrix`` level into a
band (at most 96 offsets) or a block-ELL matrix.  The V-cycle runs in the
transposed [nb, P] layout on every level that has it (banded and packed
levels whose transfer has a lane path) and flat elsewhere (block-ELL
levels), switching layouts at the boundaries.

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
from polydeal_tpu_torch.solvers.cg import CGResult, cg_finish, cg_solve
from polydeal_tpu_torch.solvers.graphs import CGLoop
from polydeal_tpu_torch.solvers.lu import lu_solve, pivot_permutation
from polydeal_tpu_torch.solvers.chebyshev import (
    ChebyshevSmoother,
    estimate_lambda_max,
)
from polydeal_tpu_torch.ops.packed import build_pack_plan
from polydeal_tpu_torch.sparse import (
    BlockBanded,
    BlockELL,
    BlockMatrix,
    BlockPacked,
)
from polydeal_tpu_torch.utils.grouping import padded_group_lists

__all__ = [
    "IMAJOR_MIN_P",
    "PACK_MIN_P",
    "MAX_BAND_OFFSETS",
    "build_embedding",
    "galerkin_coarsen",
    "Transfer",
    "relabel_band_minimizing",
    "detect_grid_shapes",
    "build_rtree_hierarchy",
    "build_structured_hierarchy",
    "MatrixFreeLevel",
    "Multigrid",
    "band_offsets",
    "level_pack_plan",
    "level_pack",
    "maybe_pack_level",
    "uniform_children",
    "banded_direct_levels",
    "level_transfers",
    "build_multigrid",
    "build_field_block_multigrid",
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

# A BlockMatrix level with at most this many band offsets is banded, a
# wider one goes to block-ELL (the JAX package's Multigrid.setup rule).
MAX_BAND_OFFSETS = 96


def build_embedding(
    coarse: AgglomerationHandler,
    fine: AgglomerationHandler,
    parent: np.ndarray,
    dtype=torch.float64,
    *,
    device,
    lanes=None,
) -> torch.Tensor:
    """E [n_fine_poly, n_b, n_b]: coefficients of each coarse basis
    function expressed in the child's basis (exact polynomial embedding);
    prolong: u_f[c] = E[c] @ u_c[parent[c]].  ``lanes=(lo, hi)``: the
    blocks of fine polytopes [lo, hi) only (a shard's slab).

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
    idx = np.arange(fine.n_poly) if lanes is None else np.arange(*lanes)
    par = np.asarray(parent)[idx]
    # affine child-unit -> parent-unit map
    s = dev(fine.extents[idx] / coarse.extents[par])  # [Pf, dim]
    o = dev((fine.bbox_lo[idx] - coarse.bbox_lo[par])
            / coarse.extents[par])
    parent_pts = o[:, None, :] + s[:, None, :] * pts[None, :, :]

    B_child = basis.eval(pts)  # [Q, nb]
    B_par = basis.eval(parent_pts)  # [Pf, Q, nb]
    R = torch.einsum("qi,pqj,q->pij", B_child, B_par, wts)
    return torch.einsum("ik,pkj->pij", Minv, R)


def galerkin_coarsen(A_fine: BlockMatrix, E: torch.Tensor, parent: np.ndarray,
                     n_coarse: int) -> BlockMatrix:
    """A_c = P^T A_f P through the one-parent-per-row structure of P: one
    triple product per fine block, merged by parent pair (a deterministic
    segment sum)."""
    parent = np.asarray(parent)
    dev = A_fine.data.device
    r = torch.as_tensor(A_fine.rows, device=dev)
    c = torch.as_tensor(A_fine.cols, device=dev)
    data_c = torch.einsum("kia,kij,kjb->kab", E[r], A_fine.data, E[c])
    return BlockMatrix.from_blocks(parent[A_fine.rows], parent[A_fine.cols],
                                   data_c, n_coarse)


def uniform_children(parent: np.ndarray, n_coarse: int) -> int:
    """C when every coarse polytope has C contiguous children (parent ==
    arange // C), else 0: the transfer's broadcast/reshape-sum path."""
    parent = np.asarray(parent)
    _, counts = padded_group_lists(parent, n_coarse)
    C = int(counts[0]) if counts.size else 0
    uniform = (C > 0 and (counts == C).all() and np.array_equal(
        parent, np.arange(parent.shape[0]) // C))
    return C if uniform else 0


@dataclass
class Transfer:
    """Two-level transfer: fine polytopes -> coarse parents, in the
    transposed [nb, P] layout, on one of three lane paths:

    * ``grid_shape`` (fine-level block grid, lex order): prolongation
      repeats each coarse block to its 2^dim children, restriction is a
      reshape-sum;
    * uniform contiguous children (parent == arange // C): broadcast and
      reshape-sum;
    * otherwise a lane gather of the parent, and a masked gather-sum of
      the padded children.

    :meth:`prolong`/:meth:`restrict` are the flat [P * nb] forms, which the
    V-cycle runs on a level without the transposed layout (block-ELL)."""

    E: torch.Tensor  # [P_f, nb, nb]
    parent: np.ndarray  # [P_f]
    n_coarse: int
    grid_shape: tuple | None = None
    children: np.ndarray = field(init=False, repr=False)  # [P_c, C], -1 pad
    _uniform_C: int = field(init=False, repr=False)
    _Et: torch.Tensor = field(init=False, repr=False)  # [nb, nb, P_f]

    def __post_init__(self):
        parent = np.asarray(self.parent)
        ch, _ = padded_group_lists(parent, self.n_coarse)
        self.children = ch
        self._uniform_C = uniform_children(parent, self.n_coarse)
        uniform = self._uniform_C > 0
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

    def prolong(self, u_c: torch.Tensor) -> torch.Tensor:
        """Flat [P_c * nb] -> [P_f * nb]."""
        nb = self.E.shape[-1]
        if self._uniform_C or self.grid_shape is not None:
            uct = u_c.reshape(self.n_coarse, nb).T
            return self.prolong_t(uct).T.reshape(-1)
        uc = u_c.reshape(self.n_coarse, nb)
        return torch.einsum("pij,pj->pi", self.E,
                            uc[self._parent_t]).reshape(-1)

    def restrict(self, r_f: torch.Tensor) -> torch.Tensor:
        """Flat [P_f * nb] -> [P_c * nb]: the transpose of
        :meth:`prolong`."""
        nb = self.E.shape[-1]
        if self._uniform_C or self.grid_shape is not None:
            return self.restrict_t(r_f.reshape(-1, nb).T).T.reshape(-1)
        contrib = torch.einsum("pij,pi->pj", self.E, r_f.reshape(-1, nb))
        g = contrib[self._children_t].reshape(*self.children.shape, nb)
        return torch.einsum("pc,pcj->pj", self._cmask_t.to(g.dtype),
                            g).reshape(-1)


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


def _level_operator(A):
    """The solver layout of a level: a BlockMatrix becomes a band when it
    has at most :data:`MAX_BAND_OFFSETS` offsets (the o-major copy dropped
    where the i-major one is attached: only the kernels read it), else a
    block-ELL matrix; a band or pack passes through."""
    if not isinstance(A, BlockMatrix):
        return _with_imajor_if_big(A)
    e = A.to_banded_device(max_offsets=MAX_BAND_OFFSETS)
    if e is None:
        return A.to_ell()
    return _with_imajor_if_big(e, drop_omajor=True)


def _schedule(v, n_levels: int, name: str):
    """An int, or a per-level tuple (coarsest first, one entry a level;
    entry 0 is unused: the coarsest level is solved directly)."""
    if isinstance(v, int):
        return v
    v = tuple(int(x) for x in v)
    if len(v) != n_levels:
        raise ValueError(
            f"{name} schedule has {len(v)} entries for {n_levels} levels")
    return v


# the smoothing vectors' dtypes: f32 and f64 run the fused smoothers; bf16
# sweeps run the composed smoother (the JAX package's _fused_ok refuses
# them too), K6 reading bf16 x and the banded products casting it to f32
_VECTOR_DTYPES = (torch.float32, torch.float64)


def promote_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` in the wider of its dtype and ``dtype`` (a transfer's), where
    the smoothing vectors run narrower (vector_dtype), as the JAX package's
    einsums promote."""
    if v.dtype == dtype:
        return v
    return v.to(torch.promote_types(v.dtype, dtype))


class MatrixFreeLevel:
    """A matrix-free operator as the finest MG level (the reference's
    flagship composition: a MatrixFree finest operator over matrix-based
    coarse levels, examples/agglo_amg.cc:1105-1110).

    It has ``matvec``, ``diagonal``, ``n_basis``, ``shape`` and ``dtype``
    (carried by the diagonal), and no ``matvec_t`` or ``fused_cheb_ok``:
    the V-cycle runs it flat, smooths it with the composed Chebyshev
    recurrence and switches to the transposed layout below it."""

    def __init__(self, op, diag: torch.Tensor):
        self.op = op  # e.g. assembly.matfree.MatrixFreeLaplace
        self.diag = diag  # [n] flat, on the operator's device

    @property
    def n_basis(self) -> int:
        return self.op.n_basis

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def shape(self):
        n = self.op.n_poly * self.op.n_basis
        return (n, n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.apply(x)

    def diagonal(self) -> torch.Tensor:
        return self.diag


@dataclass
class Multigrid:
    """V-cycle over banded, packed or block-ELL levels; ``ells[0]`` is the
    coarsest.  Chebyshev(degree) + point-Jacobi smoothing on every level,
    a direct solve at the bottom, wrapped as a CG preconditioner (the
    reference's flagship composition, agglo_amg.cc:1278-1414)."""

    ells: list  # BlockBanded, BlockPacked or BlockELL, coarse -> fine
    transfers: list  # transfers[l]: level l <- l+1
    # an int for every level, or a per-level tuple (coarsest first; entry
    # 0 unused)
    n_smooth: int | tuple = 5
    chebyshev_degree: int | tuple = 3
    # (Ainv,): explicit dense inverse, one matmul; (LU, pivots): LU solve
    coarse_lu: tuple = ()
    dinvs_t: list = field(default_factory=list)  # [nb, P] (flat: [n])
    los: list = field(default_factory=list)  # smoothing interval, floats
    his: list = field(default_factory=list)
    # low-precision band copies for the smoother's SpMVs only
    # (precond_dtype); a packed level keeps its operator object there: no
    # low-precision copy.  lo_dinvs carries the smoothing vectors' dtype
    # (vector_dtype; the operator's by default): the cycle casts a level's
    # rhs to it
    lo_ells: list | None = None
    lo_dinvs: list | None = None
    # captured solves (solvers/graphs): CGLoops by (rtol, maxiter, dtype),
    # (start program, its flat rhs buffer) by (rtol, maxiter, dtype, fmg);
    # the levels, transfers
    # and smoothing intervals are baked into them, so they hold only while
    # those stay as they are
    _loops: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)
    _starts: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)
    # the coarse LU's pivots as a row permutation (solvers/lu), made at
    # the first coarse solve
    _coarse_perm: object = field(default=None, init=False, repr=False,
                                 compare=False)

    @classmethod
    def setup(
        cls,
        matrices: list,
        transfers: list,
        chebyshev_degree: int | tuple = 3,
        n_smooth: int | tuple = 5,
        smoothing_range: float = 15.0,
        precond_dtype=None,
        vector_dtype=None,
        coarse_solver: str = "lu",
        fine_op=None,
    ) -> "Multigrid":
        """Solver layouts, eigenvalue estimates, Jacobi diagonals and the
        coarse solve.  ``matrices`` (coarse to fine) are bands, packs or
        BlockMatrix levels (see :func:`_level_operator`).  The smoothing
        intervals become Python floats here, once, so the V-cycle never
        waits on the device for them.

        ``fine_op`` (a matrix-free operator with ``apply`` and
        ``diagonal``, e.g. ``assembly.matfree.MatrixFreeLaplace``) is the
        finest level, a :class:`MatrixFreeLevel` after the assembled
        ``matrices``, which are then the coarse levels only; per-level
        schedules count it.

        ``precond_dtype`` makes low-precision band copies for the
        smoother's products (a packed or matrix-free level keeps its own
        operator there); ``vector_dtype`` (bf16, f32 or f64) runs the
        smoothing vectors in that type, and needs every smoothing band to
        be no wider than the vectors, bf16 ones counting as f32 (the
        kernels multiply an f64 band by f64 vectors only, and bf16 vectors
        reach them as f32, or K6 reads them as they are): with an f64
        operator, pass ``precond_dtype`` as well."""
        n_lv = len(matrices) + (fine_op is not None)
        chebyshev_degree = _schedule(chebyshev_degree, n_lv,
                                     "chebyshev_degree")
        n_smooth = _schedule(n_smooth, n_lv, "n_smooth")
        ells = [_level_operator(A) for A in matrices]
        if fine_op is not None:
            ells.append(MatrixFreeLevel(fine_op, fine_op.diagonal()))
        lams = []
        for Ae in ells[1:]:
            inv = 1.0 / Ae.diagonal()
            lams.append(estimate_lambda_max(
                Ae.matvec, lambda r, inv=inv: inv * r, Ae.shape[0], iters=25,
                dtype=Ae.dtype, device=inv.device))
        A0 = (matrices[0] if isinstance(matrices[0], BlockMatrix)
              else ells[0]).to_dense()
        if coarse_solver == "inv":
            coarse_lu = (torch.linalg.inv(A0),)
        elif coarse_solver == "lu":
            coarse_lu = tuple(torch.linalg.lu_factor(A0))
        else:
            raise ValueError(f"unknown coarse solver: {coarse_solver!r}")
        dinvs = [None] + [1.0 / (Ae.diagonal_t() if hasattr(Ae, "diagonal_t")
                                 else Ae.diagonal()) for Ae in ells[1:]]
        lo_ells = lo_dinvs = None
        if precond_dtype is not None:
            # matrix-free levels stay as they are; packed levels reuse the
            # f32 operator object (no band copy), as in the JAX package
            lo_ells = [BlockELL(e.data.to(precond_dtype), e.cols,
                                e.n_block_cols) if isinstance(e, BlockELL)
                       else e if isinstance(e, (BlockPacked,
                                                MatrixFreeLevel))
                       else _with_imajor_if_big(BlockBanded(
                           e.data.to(precond_dtype), e.offsets,
                           e.n_block_cols,
                           None if e.data_i is None
                           else e.data_i.to(precond_dtype)))
                       for e in ells]
        elif vector_dtype is not None:
            lo_ells = list(ells)
        if lo_ells is not None:
            vdt = vector_dtype
            if vdt is not None and (
                    vdt not in _VECTOR_DTYPES + (torch.bfloat16,) or any(
                        torch.finfo(e.dtype).bits
                        > max(torch.finfo(vdt).bits, 32)
                        for e in lo_ells[1:])):
                raise ValueError(
                    f"vector_dtype {vdt} needs bf16, f32 or f64 vectors "
                    "and smoothing bands no wider (pass precond_dtype)")
            lo_dinvs = [None] + [d if vdt is None else d.to(vdt)
                                 for d in dinvs[1:]]
        return cls(
            ells=ells,
            transfers=transfers,
            n_smooth=n_smooth,
            chebyshev_degree=chebyshev_degree,
            coarse_lu=coarse_lu,
            dinvs_t=dinvs,
            los=[None] + [lam / smoothing_range for lam in lams],
            his=[None] + [1.2 * lam for lam in lams],
            lo_ells=lo_ells,
            lo_dinvs=lo_dinvs,
        )

    @property
    def n_levels(self) -> int:
        return len(self.ells)

    def level_degree(self, level: int) -> int:
        d = self.chebyshev_degree
        return d[level] if isinstance(d, tuple) else d

    def level_smooth(self, level: int) -> int:
        n = self.n_smooth
        return n[level] if isinstance(n, tuple) else n

    def _is_t(self, level: int) -> bool:
        """Whether the level runs in the transposed [nb, P] layout (its
        operator has it; a block-ELL or matrix-free level runs flat)."""
        return hasattr(self.ells[level], "matvec_t")

    def _to_t(self, level: int, b_flat: torch.Tensor) -> torch.Tensor:
        return b_flat.reshape(-1, self.ells[level].n_basis).T.contiguous()

    @staticmethod
    def _fused_ok(A, b: torch.Tensor) -> bool:
        """Fused smoothing and residuals (in the transposed layout) for f32
        and f64 vectors: K2 on every level that carries the i-major copy,
        fused K0 on every other banded level, K7 on every packed level
        without a far tail; no block-ELL or matrix-free level, and no
        bf16 sweep."""
        return (hasattr(A, "fused_cheb_ok") and A.fused_cheb_ok()
                and b.dtype in _VECTOR_DTYPES)

    def _residual(self, A, x, b):
        """r = b - A x, through K2, fused K0 or K7 where the level allows
        it."""
        if b.dim() == 2 and self._fused_ok(A, b):
            return A.residual_t(x, b)
        mv = A.matvec_t if b.dim() == 2 else A.matvec
        return b - mv(x)

    def _restrict(self, level: int, r: torch.Tensor) -> torch.Tensor:
        """Level ``level``'s residual to level - 1, in that level's
        layout."""
        t = self.transfers[level - 1]
        r = promote_to(r, t.E.dtype)
        down_t = self._is_t(level - 1)
        if r.dim() == 2:
            return t.restrict_t(r) if down_t else t.restrict(
                r.T.reshape(-1))
        rc = t.restrict(r)
        return self._to_t(level - 1, rc) if down_t else rc

    def _prolong(self, level: int, xc: torch.Tensor,
                 to_t: bool) -> torch.Tensor:
        """Level ``level - 1``'s ``xc`` up to ``level``, transposed when
        ``to_t``."""
        t = self.transfers[level - 1]
        xc = promote_to(xc, t.E.dtype)
        if to_t:
            return (t.prolong_t(xc) if xc.dim() == 2
                    else self._to_t(level, t.prolong(xc.reshape(-1))))
        return t.prolong(xc.T.reshape(-1) if xc.dim() == 2 else xc)

    def _cycle(self, level: int, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle from ``level`` down; b and the result are [nb, P]
        where the level runs transposed, flat otherwise."""
        if level == 0:
            M = self.coarse_lu
            bl = b.to(M[0].dtype)
            if b.dim() == 2:
                bl = bl.T.reshape(-1)
            if len(M) == 1:  # explicit inverse: one matmul
                x = M[0] @ bl
            else:
                if self._coarse_perm is None:
                    self._coarse_perm = pivot_permutation(M)
                x = lu_solve(M[0], self._coarse_perm, bl)
            if b.dim() == 2:
                x = x.reshape(-1, b.shape[0]).T
            return x.to(b.dtype)
        use_lo = self.lo_ells is not None
        A = (self.lo_ells if use_lo else self.ells)[level]
        dinv = (self.lo_dinvs if use_lo else self.dinvs_t)[level]
        # the smoothing vectors run in lo_dinvs' dtype (vector_dtype)
        b = (b.to(dinv.dtype) if use_lo else b).contiguous()
        is_t = b.dim() == 2
        if not is_t and dinv.dim() == 2:
            dinv = dinv.T.reshape(-1)
        step_fn = None
        if is_t and self._fused_ok(A, b):
            # b is bound by closure: every sm(b, ...) call below passes the
            # same level rhs
            step_fn = (lambda xx, dd, c1, c2: A.cheb_step_t(
                xx, dd, b, dinv, c1, c2))
        sm = ChebyshevSmoother(A=A.matvec_t if is_t else A.matvec,
                               Minv=lambda r: dinv * r,
                               lo=self.los[level], hi=self.his[level],
                               degree=self.level_degree(level),
                               step_fn=step_fn)
        ns = self.level_smooth(level)
        x = torch.zeros_like(b)
        first = True
        for _ in range(ns):
            x = sm(b, x, x_is_zero=first)  # pre-smooth starts from zero
            first = False
        r = self._residual(A, x, b)
        xc = self._cycle(level - 1, self._restrict(level, r))
        # the transfer may upcast the correction: back to the smoothing
        # dtype, so the post-smoothing runs in it too
        x = (x + self._prolong(level, xc, is_t)).to(b.dtype)
        for _ in range(ns):
            x = sm(b, x)
        return x

    def fmg_guess(self, b: torch.Tensor) -> torch.Tensor:
        """Full-multigrid initial guess: restrict b to every level, solve
        the coarsest directly, then prolong upward with one V-cycle defect
        correction per level.  ``b`` is in the fine level's layout."""
        top = self.n_levels - 1
        bs = [None] * self.n_levels
        bs[top] = b
        for level in range(top, 0, -1):
            bs[level - 1] = self._restrict(level, bs[level])
        x = self._cycle(0, bs[0])
        for level in range(1, self.n_levels):
            bl = bs[level]
            x = self._prolong(level, x, bl.dim() == 2).to(bl.dtype)
            # the residual uses the TRUE (full-precision) level operator
            r = self._residual(self.ells[level], x, bl)
            x = x + self._cycle(level, r).to(x.dtype)
        return x

    def v_cycle(self, b: torch.Tensor) -> torch.Tensor:
        """One V-cycle on the flat fine-level vector (a CG
        preconditioner); the result has ``b``'s dtype."""
        top = self.n_levels - 1
        if self._is_t(top):
            return self._cycle(top, self._to_t(top, b)).to(
                b.dtype).T.reshape(-1)
        return self._cycle(top, b).to(b.dtype)

    def graph_ok(self) -> bool:
        """Whether :meth:`solve_cg` on the card runs as captured programs
        (``solvers/graphs``): every level and smoother copy one of the
        solver layouts (``BlockBanded``, ``BlockPacked``, ``BlockELL``, a
        ``BlockMatrix``, a ``MatrixFreeLevel``), an explicit-inverse or LU
        coarse solve, and bf16, f32 or f64 smoothing vectors."""
        kinds = (BlockBanded, BlockPacked, BlockELL, BlockMatrix,
                 MatrixFreeLevel)
        ops = list(self.ells) + list(self.lo_ells or [])
        return (all(isinstance(e, kinds) for e in ops)
                and len(self.coarse_lu) in (1, 2)
                and all(d.dtype in _VECTOR_DTYPES + (torch.bfloat16,)
                        for d in (self.lo_dinvs or [None])[1:]))

    def _fine_layout(self):
        """(operator, preconditioner, in, out) of the CG this hierarchy
        preconditions: in the [nb, P] layout where the fine level has it
        (``in``/``out`` map a flat vector to it and back), else flat."""
        top = self.n_levels - 1
        M = lambda r: self._cycle(top, r).to(r.dtype)
        if self._is_t(top):
            return (self.ells[top].matvec_t, M,
                    lambda v: self._to_t(top, v),
                    lambda x: x.T.reshape(-1))
        return self.ells[top].matvec, M, lambda v: v, lambda x: x

    def cg_loop(self, rtol: float, maxiter: int, dtype) -> CGLoop:
        """The captured CG of this hierarchy for ``(rtol, maxiter,
        dtype)`` (made at first use): the fine operator, one V-cycle as M,
        in the fine level's layout (:meth:`_fine_layout`).  Callers with
        their own right-hand side (the monodomain step) add start programs
        to it."""
        key = (rtol, maxiter, dtype)
        loop = self._loops.get(key)
        if loop is None:
            if not self.graph_ok():
                raise ValueError("this hierarchy's levels are not all in "
                                 "the solver layouts: no captured solve")
            A, M, to_in, _ = self._fine_layout()
            like = to_in(torch.zeros(self.ells[-1].shape[0], dtype=dtype,
                                     device=self.coarse_lu[0].device))
            loop = self._loops[key] = CGLoop(A, M, like, rtol=rtol,
                                             maxiter=maxiter)
        return loop

    def solve_cg(self, b: torch.Tensor, rtol: float = 1e-9,
                 maxiter: int = 200, fmg: bool = False,
                 capture: bool | None = None) -> CGResult:
        """MG-preconditioned CG on the flat rhs ``b``, in the [nb, P]
        layout where the fine level has it (:meth:`_fine_layout`);
        ``fmg=True`` starts from :meth:`fmg_guess`.

        On the card a hierarchy that :meth:`graph_ok` admits solves as
        captured programs (the counterpart of the JAX package's one
        jitted program): the FMG start and ``cg_init`` as one, a CG
        iteration with one V-cycle as another in a WHILE loop on the
        device, all one device program and one host read a solve,
        cached by ``(rtol, maxiter, b.dtype)`` and ``fmg``.
        ``capture=False`` runs the eager loop instead (the comparison
        and per-kernel profiling); ``capture=True`` raises where graphs
        cannot run.  The CPU runs the eager loop."""
        if capture is None:
            capture = b.device.type == "cuda" and self.graph_ok()
        A, M, to_in, to_out = self._fine_layout()
        if capture:
            loop = self.cg_loop(rtol, maxiter, b.dtype)
            key = (rtol, maxiter, b.dtype, fmg)
            if key not in self._starts:
                b_in = torch.zeros_like(b)
                self._starts[key] = (loop.start_program(
                    lambda: to_in(b_in), self.fmg_guess if fmg else None),
                    b_in)
            start, b_in = self._starts[key]
            b_in.copy_(b)
            n = loop.run(start)
            x, res = cg_finish(loop.state)
            return CGResult(x=to_out(x).clone(), iterations=n, residual=res)
        bt = to_in(b)
        res = cg_solve(A, bt, x0=self.fmg_guess(bt) if fmg else None, M=M,
                       rtol=rtol, maxiter=maxiter)
        return CGResult(x=to_out(res.x), iterations=res.iterations,
                        residual=res.residual)


def band_offsets(h: AgglomerationHandler) -> np.ndarray:
    """The sorted band offsets of a level (poly_out - poly_in of its
    interior faces, both signs, and 0), from its face table."""
    ft = h.faces
    interior = ~ft.is_boundary
    diffs = (ft.poly_out - ft.poly_in)[interior].astype(np.int64)
    return np.unique(np.concatenate([diffs, -diffs,
                                     np.zeros(1, dtype=np.int64)]))


def level_pack_plan(h: AgglomerationHandler, offsets):
    """(plan, oid) of the level's packed format when it pays (the rule of
    :func:`level_pack` with ``pack=None``), else None."""
    pp = level_pack(h, offsets)
    return None if pp is None else pp[:2]


def level_pack(h: AgglomerationHandler, offsets, pack: bool | None = None,
               near_limit: int | None = None):
    """(plan, oid, far_rows, far_cols) of the level's packed format when it
    is to be packed, else None; the one rule for every level (the fine one
    included) on every device.

    An ordering without the relabel gives ~6 dim band offsets while each
    lane touches <= 2 dim + 1, so the dense band streams ~n_off/K times
    the data a product needs.  With ``pack=None`` a level is packed when it
    has at least :data:`PACK_MIN_P` polytopes, more than 2 dim + 3 offsets
    (checked before any plan is built) and a plan of K + 2 < n_off slots.
    ``pack=True`` packs every level whose polytope count is a multiple of
    128 (the JAX package's forced rule), ``pack=False`` none.  The plan
    colours every offset into the slots (``near_limit=None``: the kernels
    load x at any offset, so there is no far tail); a ``near_limit`` splits
    the offsets beyond it off into a far block-COO tail."""
    n_off = len(offsets)
    if pack is False:
        return None
    if pack is None and (h.n_poly < PACK_MIN_P or n_off <= 2 * h.dim + 3):
        return None
    if pack and h.n_poly % 128 != 0:
        return None
    ft = h.faces
    interior = ~ft.is_boundary
    plan, oid, frows, fcols = build_pack_plan(
        ft.poly_in[interior], ft.poly_out[interior], h.n_poly, h.n_basis,
        offsets=offsets, near_limit=-1 if near_limit is None else near_limit)
    if pack is None and plan.K + 2 >= n_off:
        return None  # the lanes touch most offsets: the band is as tight
    return plan, oid, frows, fcols


def maybe_pack_level(h: AgglomerationHandler, A, pack: bool | None = None,
                     near_limit: int | None = None):
    """The level's band in the packed format (``sparse.BlockPacked``) where
    :func:`level_pack_plan` says so; anything else passes through."""
    pp = (level_pack(h, A.offsets, pack, near_limit)
          if isinstance(A, BlockBanded) else None)
    if pp is None:
        return A
    plan, oid, frows, fcols = pp
    return A.to_packed(plan, torch.as_tensor(oid, device=A.data.device),
                       frows if frows.size else None,
                       fcols if fcols.size else None)


def banded_direct_levels(handlers: list, dtype=torch.float64, *, device,
                         pack: bool | None = None,
                         pack_near_limit: int | None = None) -> list:
    """The levels of ``handlers`` (coarsest first) assembled straight into
    the band through K3-K5, every one but the coarsest through
    :func:`maybe_pack_level` with ``pack`` and ``pack_near_limit``: the
    coarse levels of :func:`build_multigrid` with
    ``level_assembly='banded'``."""
    from polydeal_tpu_torch.assembly.sipg import (
        assemble_sipg_banded_direct,
        build_banded_groups,
    )

    matrices = []
    for li, h in enumerate(handlers):
        offs = band_offsets(h)
        groups = build_banded_groups(h, offs, dtype, device=device)
        A_l = assemble_sipg_banded_direct(h, groups, offsets=offs)
        del groups
        # the coarsest level stays banded: its direct solve needs to_dense
        matrices.append(A_l if li == 0 else maybe_pack_level(
            h, A_l, pack, pack_near_limit))
    return matrices


def level_transfers(handlers: list, parents: list, Es: list,
                    grid_shapes: list | None = None) -> list:
    """The ``Transfer`` into each level from the one below, from the
    embeddings ``Es`` (one a level pair, coarsest first)."""
    return [Transfer(E=E, parent=parents[l], n_coarse=handlers[l].n_poly,
                     grid_shape=None if grid_shapes is None
                     else grid_shapes[l])
            for l, E in enumerate(Es)]


def build_multigrid(
    handlers: list,
    parents: list,
    A_fine,
    chebyshev_degree: int | tuple = 3,
    n_smooth: int | tuple = 5,
    smoothing_range: float = 20.0,
    mode: str = "direct",
    grid_shapes: list | None = None,
    precond_dtype=None,
    vector_dtype=None,
    dtype=torch.float64,
    level_assembly: str = "tables",
    coarse_solver: str = "lu",
    matfree_fine: bool = False,
    pack: bool | None = None,
    pack_near_limit: int | None = None,
    *,
    device,
) -> Multigrid:
    """The R3MG preconditioner from a handler chain (coarse to fine) and
    the finest-level matrix.

    ``matfree_fine=True`` makes the finest level a matrix-free operator
    (``assembly.matfree.MatrixFreeLaplace`` in ``dtype``, geometry-only
    memory) over the assembled coarse levels: the reference's flagship
    composition (examples/agglo_amg.cc:1105-1110,
    multigrid_amg.h:309-398).  It needs ``mode='direct'``, with either
    level assembly, and ``A_fine`` may be None.

    ``mode='direct'`` re-assembles SIPG on every coarser level, so the
    penalty scales with each level's h: by the table path into a
    BlockMatrix (``level_assembly='tables'``; ``A_fine`` a BlockMatrix,
    every level banded or block-ELL by ``Multigrid.setup``), or straight
    into the band through K3-K5 (``'banded'``; ``A_fine`` a band or pack,
    every level but the coarsest through :func:`maybe_pack_level` with
    ``pack`` and ``pack_near_limit``, the fine level's o-major copy dropped
    where it runs the kernels).
    ``mode='galerkin'`` coarsens the BlockMatrix ``A_fine`` algebraically,
    A_l = P^T A_{l+1} P (the reference's AmgProjector scheme)."""
    from polydeal_tpu_torch.assembly.sipg import assemble_sipg_matrix

    fine_op = None
    if matfree_fine:
        if mode != "direct":
            raise ValueError("matfree_fine needs mode='direct'")
        from polydeal_tpu_torch.assembly.matfree import MatrixFreeLaplace

        fine_op = MatrixFreeLaplace(handlers[-1], dtype=dtype, device=device)
    Es = [build_embedding(handlers[l], handlers[l + 1], parents[l],
                          dtype=dtype, device=device)
          for l in range(len(handlers) - 1)]
    if mode == "direct" and level_assembly == "banded":
        matrices = banded_direct_levels(handlers[:-1], dtype, device=device,
                                        pack=pack,
                                        pack_near_limit=pack_near_limit)
        # the fine level is read only through the kernels' layout when it
        # has one, so its o-major copy goes
        if fine_op is None:
            matrices.append(_with_imajor_if_big(
                maybe_pack_level(handlers[-1], A_fine, pack,
                                 pack_near_limit), drop_omajor=True))
    elif mode == "direct" and level_assembly == "tables":
        matrices = [assemble_sipg_matrix(h, dtype=dtype, device=device)
                    for h in handlers[:-1]]
        if fine_op is None:
            matrices.append(A_fine)
    elif mode == "direct":
        raise ValueError(f"unknown level assembly: {level_assembly!r}")
    elif mode == "galerkin":
        matrices = [A_fine]
        for l in range(len(handlers) - 2, -1, -1):
            matrices.insert(0, galerkin_coarsen(matrices[0], Es[l],
                                                parents[l],
                                                handlers[l].n_poly))
    else:
        raise ValueError(f"unknown multigrid mode: {mode}")
    return Multigrid.setup(matrices,
                           level_transfers(handlers, parents, Es, grid_shapes),
                           chebyshev_degree=chebyshev_degree,
                           n_smooth=n_smooth, smoothing_range=smoothing_range,
                           precond_dtype=precond_dtype,
                           vector_dtype=vector_dtype,
                           coarse_solver=coarse_solver, fine_op=fine_op)


def _field_block_matrix(space, op, name, ah, dtype):
    """(BlockMatrix, active mask): the (name, name) diagonal block of
    ``op`` scattered onto ``ah``'s whole polytope set, identity-extended
    (scaled by the mean diagonal) outside the field's subdomain."""
    f = space.fields[name]
    rows_l, cols_l, data = op.finalize()[(name, name)]
    gp = np.asarray(f.polys)
    rows, cols = gp[rows_l], gp[cols_l]
    data = data.to(dtype)
    act = np.zeros(ah.n_poly, dtype=bool)
    act[gp] = True
    ext = np.nonzero(~act)[0]
    blocks, r_all, c_all = [data], [rows], [cols]
    if ext.size:
        diag = data[torch.as_tensor(np.nonzero(rows_l == cols_l)[0],
                                    device=data.device)]
        scale = torch.diagonal(diag, dim1=1, dim2=2).sum(-1).mean() / f.block
        eye = scale * torch.eye(f.block, dtype=dtype, device=data.device)
        blocks.append(eye.expand(ext.size, f.block, f.block))
        r_all.append(ext)
        c_all.append(ext)
    return BlockMatrix.from_blocks(
        np.concatenate(r_all), np.concatenate(c_all),
        torch.cat(blocks, dim=0), ah.n_poly), act


def build_field_block_multigrid(
    space,
    op,
    name: str,
    handlers: list,
    parents: list,
    chebyshev_degree: int | tuple = 3,
    n_smooth: int | tuple = 5,
    smoothing_range: float = 20.0,
    dtype=torch.float64,
    coarse_solver: str = "lu",
    level_ops: list | None = None,
) -> Multigrid:
    """R3MG built from the coupled operator's ACTUAL (``name``, ``name``)
    diagonal block (counterpart of the JAX package's function): the
    field's block of the assembled ``MixedOperator`` (with its interface
    terms and the subdomain's true boundary conditions) scattered onto the
    full polytope set of a degree-matched hierarchy, polytopes outside the
    subdomain given scaled identity blocks, and Galerkin-coarsened through
    the exact embeddings, expanded to blockdiag(E, ..., E) for a vector
    field's component-major blocks.  With ``level_ops`` [(space_l, op_l)]
    aligned with ``handlers`` (the fine pair last), each level's block is
    extracted from a system re-assembled on that level instead
    (level-correct SIPG penalties).

    A block whose subdomain has no Dirichlet boundary (darcy_stokes' pD
    block) is singular on the per-component constants: its coarsest matrix
    is deflated, A_0 + sigma Z Z^T with Z the normalised constants of each
    component on the field's coarse polytopes, after an f64 ``eigvalsh``
    on the host finds w[0] < 1e-10 w[-1].  The level is then a dense
    BlockMatrix.  The device is the operator's."""
    f = space.fields[name]
    ah = handlers[-1]
    nb = ah.n_basis
    d = f.n_components
    if f.basis.n_basis != nb:
        raise ValueError(f"hierarchy basis ({nb}) must match field "
                         f"'{name}' ({f.basis.n_basis})")
    device = op.finalize()[(name, name)][2].device

    Es = []
    for l in range(len(handlers) - 1):
        E = build_embedding(handlers[l], handlers[l + 1], parents[l],
                            dtype=dtype, device=device)
        if d > 1:  # component-major block expansion
            eye = torch.eye(d, dtype=dtype, device=device)
            E = torch.einsum("de,pij->pdiej", eye, E).reshape(
                E.shape[0], d * nb, d * nb)
        Es.append(E)

    if level_ops is not None:
        if len(level_ops) != len(handlers):
            raise ValueError(f"{len(level_ops)} level systems for "
                             f"{len(handlers)} levels")
        mats = []
        for l, (sp_l, op_l) in enumerate(level_ops):
            A_l, act = _field_block_matrix(sp_l, op_l, name, handlers[l],
                                           dtype)
            mats.append(A_l)
    else:
        A_fine, act = _field_block_matrix(space, op, name, ah, dtype)
        mats = [A_fine]
        for l in range(len(handlers) - 2, -1, -1):
            mats.insert(0, galerkin_coarsen(mats[0], Es[l], parents[l],
                                            handlers[l].n_poly))

    # Neumann-block coarse deflation, decided on the host in f64 (an f32
    # copy of the spectrum would flip the test)
    n0 = handlers[0].n_poly
    bs = f.block
    D0 = mats[0].to_dense().cpu().numpy().astype(np.float64)
    w = np.linalg.eigvalsh(0.5 * (D0 + D0.T))
    if w[0] < 1e-10 * w[-1]:
        # the field's coarsest polytopes (the subdomain is hierarchy-
        # aligned: every coarse polytope is wholly in or out)
        a = act
        for l in range(len(handlers) - 2, -1, -1):
            ac = np.zeros(handlers[l].n_poly, dtype=bool)
            ac[np.asarray(parents[l])[np.nonzero(a)[0]]] = True
            a = ac
        # coefficients of the constant function 1 in the shared basis
        basis = handlers[0].basis
        pts, wts = tensor_gauss(handlers[0].dim, handlers[0].degree + 1)
        B = basis.eval(torch.as_tensor(pts, dtype=torch.float64)).numpy()
        c0 = np.linalg.solve(np.einsum("qi,qj,q->ij", B, B, wts), B.T @ wts)
        Z = np.zeros((n0, d, nb, d))
        for comp in range(d):
            Z[a, comp, :, comp] = c0
        Z = Z.reshape(n0 * bs, d)
        Z /= np.linalg.norm(Z, axis=0, keepdims=True)
        sigma = np.trace(D0) / D0.shape[0]
        D = D0 + sigma * (Z @ Z.T)
        ri = np.repeat(np.arange(n0), n0)
        ci = np.tile(np.arange(n0), n0)
        data0 = torch.as_tensor(
            D.reshape(n0, bs, n0, bs).transpose(0, 2, 1, 3).reshape(
                n0 * n0, bs, bs), dtype=dtype, device=device)
        mats[0] = BlockMatrix.from_blocks(ri, ci, data0, n0)

    transfers = [
        Transfer(E=Es[l], parent=parents[l], n_coarse=handlers[l].n_poly)
        for l in range(len(handlers) - 1)
    ]
    return Multigrid.setup(mats, transfers, chebyshev_degree=chebyshev_degree,
                           n_smooth=n_smooth, smoothing_range=smoothing_range,
                           coarse_solver=coarse_solver)
