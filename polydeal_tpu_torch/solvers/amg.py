"""Smoothed-aggregation algebraic multigrid (the AMG comparison arm), on
torch tensors.

Counterpart of ``polydeal_tpu/solvers/amg.py``: the reference compares its
polytopal multigrid (R3MG) against Trilinos ML/AMG on the same assembled
SIPG system (examples/agglo_amg.cc:1473-1530); this is the same algorithm
family, Vanek-style smoothed aggregation built from the assembled matrix
alone.

- **Setup on the host** (numpy/scipy, a jax-free copy of the JAX
  package's): the strength graph of the block graph, greedy aggregation
  (``native.sa_aggregate``, with the numpy fallback), the tentative
  prolongator from near-null-space candidates (batched QR per aggregate),
  prolongator smoothing, the Galerkin triple products and the power
  estimate of lambda_max(D^-1 A).
- **Solve on the device**: every level's operator and prolongator is a
  :class:`~polydeal_tpu_torch.sparse.BlockMatrix` (gather, block products
  and a deterministic segment sum; no kernel, as in the JAX package, where
  these are XLA gathers and segment sums), smoothing is the shared
  :class:`ChebyshevSmoother` with point Jacobi, the coarse solve an
  explicit dense inverse, and CG runs around the V-cycle: on the card as
  captured programs (``solvers/graphs.CGLoop``), the counterpart of the
  JAX package's jitted ``_amg_solve_cg``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from polydeal_tpu_torch.solvers.cg import CGResult, cg_finish, cg_solve
from polydeal_tpu_torch.solvers.chebyshev import ChebyshevSmoother
from polydeal_tpu_torch.solvers.graphs import CGLoop
from polydeal_tpu_torch.sparse import BlockMatrix

__all__ = ["AMG", "build_amg", "constant_nullspace", "block_nullspace"]


def constant_nullspace(ah) -> np.ndarray:
    """[n_dofs, 1] coefficients of the constant function 1 in the
    handler's basis (the near-null-space of the SIPG Laplacian), by the
    least-squares fit of 1 at seeded sample points."""
    nb = ah.n_basis
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.05, 0.95, size=(2 * nb + 4, ah.dim))
    Bm = ah.basis.eval(torch.as_tensor(pts)).numpy()  # [n_pts, nb]
    v, *_ = np.linalg.lstsq(Bm, np.ones(Bm.shape[0]), rcond=None)
    v[np.abs(v) < 1e-10 * np.max(np.abs(v))] = 0.0
    return np.tile(v, ah.n_poly)[:, None]


def block_nullspace(ah) -> np.ndarray:
    """[n_dofs, n_basis] per-block identity candidates: the coarse space
    keeps every modal component per aggregate."""
    nb = ah.n_basis
    return np.tile(np.eye(nb), (ah.n_poly, 1))


def _strength_graph(M, nb: int, theta: float):
    """CSR (indptr, indices) of the strong off-diagonal block connections
    of a scipy CSR matrix viewed in nb x nb blocks:
    ||A_ij||_F >= theta * sqrt(||A_ii||_F ||A_jj||_F)."""
    import scipy.sparse as sp

    bsr = M.tobsr((nb, nb))
    n = M.shape[0] // nb
    fro = np.linalg.norm(bsr.data.reshape(bsr.data.shape[0], -1), axis=1)
    indptr, indices = bsr.indptr, bsr.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices
    diag = np.zeros(n)
    on_diag = rows == cols
    diag[rows[on_diag]] = fro[on_diag]
    off = ~on_diag
    keep = fro[off] >= theta * np.sqrt(
        np.maximum(diag[rows[off]] * diag[cols[off]], 1e-300))
    g = sp.csr_matrix(
        (np.ones(int(keep.sum())), (rows[off][keep], cols[off][keep])),
        shape=(n, n))
    g = (g + g.T).tocsr()  # symmetrize
    return g.indptr, g.indices


def _aggregate(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Vanek greedy aggregation on the strength graph -> label per node:
    untouched nodes whose strong neighbourhood is untouched seed an
    aggregate with it; the rest join an adjacent aggregate; leftovers form
    their own.  Native C++ where the library is built, else the numpy
    loop of the same semantics."""
    from polydeal_tpu_torch import native

    lab = native.sa_aggregate(indptr, indices)
    if lab is not None:
        return lab
    label = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for i in range(n):
        if label[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.all(label[nbrs] == -1):
            label[i] = n_agg
            label[nbrs] = n_agg
            n_agg += 1
    for i in range(n):
        if label[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        tagged = nbrs[label[nbrs] != -1]
        if tagged.size:
            label[i] = label[tagged[0]]
    for i in range(n):
        if label[i] == -1:
            label[i] = n_agg
            n_agg += 1
    return label


def _tentative(full_label: np.ndarray, B: np.ndarray, n_agg: int):
    """Tentative prolongator from the candidates: per aggregate, the
    reduced QR of its rows of B (batched over aggregates, padded).
    Returns (P_hat CSR [N, n_agg*nc], B_coarse [n_agg*nc, nc])."""
    import scipy.sparse as sp

    N, nc = B.shape
    order = np.argsort(full_label, kind="stable")
    counts = np.bincount(full_label, minlength=n_agg)
    m_max = int(counts.max())
    starts = np.zeros(n_agg + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    ar = np.arange(m_max)
    mask = ar[None, :] < counts[:, None]
    flat_pos = np.minimum(starts[:-1, None] + ar[None, :], N - 1)
    pad = order[flat_pos]
    Bp = B[pad] * mask[:, :, None]  # [n_agg, m_max, nc]
    Q, R = np.linalg.qr(Bp)
    rows = pad[mask].repeat(nc)
    cols = ((np.arange(n_agg) * nc)[:, None, None]
            + np.arange(nc)[None, None, :])
    cols = np.broadcast_to(cols, Q.shape)[mask].reshape(-1)
    vals = Q[mask].reshape(-1)
    P_hat = sp.csr_matrix((vals, (rows, cols)), shape=(N, n_agg * nc))
    B_coarse = R.reshape(n_agg * nc, nc)
    return P_hat, B_coarse


def _csr_to_block(M, bs: int, dtype, device) -> BlockMatrix:
    """BlockMatrix (bs x bs blocks) on ``device`` from a scipy CSR."""
    bsr = M.tobsr((bs, bs))
    rows = np.repeat(np.arange(M.shape[0] // bs), np.diff(bsr.indptr))
    return BlockMatrix.from_blocks(
        rows, bsr.indices,
        torch.as_tensor(bsr.data, dtype=dtype, device=device),
        n_block_rows=M.shape[0] // bs, n_block_cols=M.shape[1] // bs)


@dataclass
class AMG:
    """Device-side SA-AMG V-cycle (build with :func:`build_amg`).  Levels
    run coarse -> fine like ``Multigrid``; ``Ps[l]`` prolongates level l
    <- level l-1 (None at l=0) and [los[l], his[l]] is the Chebyshev
    interval of the Jacobi-preconditioned spectrum."""

    As: list
    Ps: list
    Pts: list
    dinvs: list
    los: list
    his: list
    coarse_inv: torch.Tensor
    chebyshev_degree: int = 3
    n_smooth: int = 1
    # captured solves: (CGLoop, start program, its rhs buffer) by (rtol,
    # maxiter, dtype); the levels are baked into them
    _loops: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    @property
    def n_levels(self) -> int:
        return len(self.As)

    def _smoother(self, level):
        A, dinv = self.As[level], self.dinvs[level]
        return ChebyshevSmoother(
            A=A.matvec, Minv=lambda r: dinv * r,
            lo=self.los[level], hi=self.his[level],
            degree=self.chebyshev_degree)

    def _cycle(self, level: int, b: torch.Tensor) -> torch.Tensor:
        if level == 0:
            return (self.coarse_inv @ b.to(self.coarse_inv.dtype)).to(b.dtype)
        sm = self._smoother(level)
        x = torch.zeros_like(b)
        for _ in range(self.n_smooth):
            x = sm(b, x)
        r = b - self.As[level].matvec(x)
        rc = self.Pts[level].matvec(r)
        x = x + self.Ps[level].matvec(self._cycle(level - 1, rc))
        for _ in range(self.n_smooth):
            x = sm(b, x)
        return x

    def v_cycle(self, b: torch.Tensor) -> torch.Tensor:
        return self._cycle(self.n_levels - 1, b)

    def solve_cg(self, b: torch.Tensor, rtol: float = 1e-9,
                 maxiter: int = 300,
                 capture: bool | None = None) -> CGResult:
        """CG preconditioned by one V-cycle (the JAX package's jitted
        ``_amg_solve_cg``).  On the card (``capture=None``) as captured
        programs (``solvers/graphs.CGLoop``: the start, then one iteration
        in a WHILE loop on the device, made at the first solve of each
        ``(rtol, maxiter, dtype)`` and launched by later ones; one host
        read a solve); ``capture=False`` runs the eager loop,
        ``capture=True`` off CUDA raises."""
        if capture is None:
            capture = b.device.type == "cuda"
        if not capture:
            return cg_solve(self.As[-1].matvec, b, M=self.v_cycle,
                            rtol=rtol, maxiter=maxiter)
        key = (rtol, maxiter, b.dtype)
        if key not in self._loops:
            loop = CGLoop(self.As[-1].matvec, self.v_cycle, b, rtol=rtol,
                          maxiter=maxiter)
            b_in = torch.zeros_like(b)
            self._loops[key] = (loop, loop.start_program(lambda: b_in),
                                b_in)
        loop, start, b_in = self._loops[key]
        b_in.copy_(b)
        n = loop.run(start)
        x, res = cg_finish(loop.state)
        return CGResult(x=x.clone(), iterations=n, residual=res)


def build_amg(
    A: BlockMatrix,
    nullspace: np.ndarray | None = None,
    theta: float = 0.02,
    omega_scale: float = 4.0 / 3.0,
    coarse_max: int = 800,
    max_levels: int = 12,
    chebyshev_degree: int = 4,
    n_smooth: int = 2,
    smoothing_range: float = 15.0,
) -> AMG:
    """SA-AMG from an assembled block matrix, on ``A``'s device (the
    Trilinos-ML preconditioner the reference benchmarks against: smoothed
    aggregation, Chebyshev smoothing, drop tolerance ``theta``).
    ``nullspace`` is [n_dofs] or [n_dofs, nc] (default all-ones; use
    :func:`constant_nullspace` / :func:`block_nullspace` for modal
    spaces)."""
    import scipy.sparse as sp

    dtype, device = A.data.dtype, A.data.device
    M = _to_csr(A)
    if nullspace is None:
        B = np.ones((M.shape[0], 1))
    else:
        B = np.asarray(nullspace, dtype=np.float64)
        if B.ndim == 1:
            B = B[:, None]
    if B.shape[0] != M.shape[0]:
        raise ValueError(
            f"nullspace has {B.shape[0]} rows for {M.shape[0]} dofs")
    nc = B.shape[1]
    if nc > A.n_basis:
        raise ValueError(
            f"{nc} candidates exceed the fine block size {A.n_basis}")

    host_As, host_Ps = [M], []
    host_lams = []  # lambda_max(D^-1 A) per coarsened level, for Chebyshev
    nb_cur = A.n_basis
    while host_As[-1].shape[0] > coarse_max and len(host_As) < max_levels:
        Mcur = host_As[-1]
        n_nodes = Mcur.shape[0] // nb_cur
        indptr, indices = _strength_graph(Mcur, nb_cur, theta)
        label = _aggregate(indptr, indices, n_nodes)
        n_agg = int(label.max()) + 1
        if n_agg >= n_nodes:  # aggregation stalled (diagonal matrix)
            break
        P_hat, B = _tentative(np.repeat(label, nb_cur), B, n_agg)
        # smooth: P = (I - omega D^-1 A) P_hat, omega = omega_scale / lam
        DA = sp.diags(1.0 / Mcur.diagonal()) @ Mcur
        lam = _power_lambda_max(DA)
        host_lams.append(lam)
        P = (P_hat - (omega_scale / lam) * (DA @ P_hat)).tocsr()
        Mc = (P.T @ Mcur @ P).tocsr()
        Mc.eliminate_zeros()
        host_As.append(Mc)
        host_Ps.append(P)
        nb_cur = nc  # every coarser level has nc dofs per aggregate

    As, Ps, Pts, dinvs, los, his = [], [], [], [], [], []
    n_lv = len(host_As)
    coarse_inv = None
    for l in range(n_lv):
        h = n_lv - 1 - l  # host level index (0 = fine)
        hA = host_As[h]
        # the fine level keeps the assembled BlockMatrix
        As.append(A if l == n_lv - 1
                  else _csr_to_block(hA, nc, dtype, device))
        dinvs.append(torch.as_tensor(1.0 / hA.diagonal(), dtype=dtype,
                                     device=device))
        if l == 0:
            # the coarsest level is solved directly: its interval is a
            # placeholder that keeps the lists aligned
            los.append(0.0)
            his.append(1.0)
            Ps.append(None)
            Pts.append(None)
            coarse_inv = torch.as_tensor(
                np.linalg.inv(np.asarray(hA.todense())), dtype=dtype,
                device=device)
        else:
            lam = host_lams[h]
            los.append(float(lam) / smoothing_range)
            his.append(float(lam) * 1.1)
            hP = host_Ps[n_lv - 1 - l]
            Ps.append(_csr_to_block(hP, 1, dtype, device))
            Pts.append(_csr_to_block(hP.T.tocsr(), 1, dtype, device))
    return AMG(As, Ps, Pts, dinvs, los, his, coarse_inv,
               chebyshev_degree=chebyshev_degree, n_smooth=n_smooth)


def _to_csr(A: BlockMatrix):
    """A BlockMatrix as a scipy CSR in float64."""
    import scipy.sparse as sp

    nb = A.n_basis
    data = A.data.detach().cpu().numpy().astype(np.float64)
    order = np.lexsort((A.cols, A.rows))  # BSR needs row-sorted entries
    rows, cols, data = A.rows[order], A.cols[order], data[order]
    indptr = np.searchsorted(rows, np.arange(A.n_block_rows + 1))
    return sp.bsr_matrix(
        (data, cols, indptr),
        shape=(A.n_block_rows * nb, A.n_block_cols * nb)).tocsr()


def _power_lambda_max(M, iters: int = 30) -> float:
    n = M.shape[0]
    v = np.sin(np.arange(1, n + 1, dtype=np.float64))
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = M @ v
        lam = float(np.linalg.norm(w))
        v = w / max(lam, 1e-300)
    return lam
