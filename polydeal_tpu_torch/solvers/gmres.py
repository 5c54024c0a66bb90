"""Restarted flexible GMRES on torch tensors: the Krylov solver of the
nonsymmetric coupled systems (Stokes-Darcy, Oseen).

Counterpart of ``polydeal_tpu/solvers/gmres.py`` ``gmres_solve``:
right-preconditioned GMRES(restart) that stores the Z basis (flexible in
the FGMRES sense), orthogonalises with classical Gram-Schmidt and one
reorthogonalisation pass (CGS2), rotates with Givens and back-substitutes
with a 1e-30 guard on the diagonal.  The JAX version is one
``lax.while_loop`` over restart cycles, each an Arnoldi ``fori_loop``;
here a cycle is three functions on a :class:`GMRESState` of device
tensors, each of one fixed shape whatever the step, so that one captured
program serves every step:

* :func:`gmres_cycle_start`: ``r = b - A x``, ``beta``, ``V[0]``, ``g =
  beta e0``, the step counter ``j`` reset;
* :func:`gmres_step`: one Arnoldi step where ``active``, else the state
  bitwise unchanged (every write is ``torch.where(active, new, old)`` on
  the rows the step owns).  CGS2 runs against the whole ``V`` (its rows
  past ``j`` are zero, as in the JAX loop); the rotations of the earlier
  steps reach the new Hessenberg column as one product with their
  accumulated ``(m+1) x (m+1)`` rotation ``Q`` (the JAX loop applies them
  one by one), so a step launches the same work for every ``j``.  It ends
  with the condition of the state it returns, ``|g[j+1]| > tol and j+1 <
  m``;
* :func:`gmres_cycle_end`: the back-substitution over the ``j`` steps
  taken (JAX's ``done_at``), one triangular solve on the square top of
  ``H`` whose rows past ``j``, or with a diagonal under the guard, are
  ``e_i`` against ``g_i = 0`` (JAX's ``y_i = 0``); then ``x += y Z``,
  ``total``, ``res = |g[j]|`` and ``go``, the outer loop's condition.

Rotations, ``g`` and ``H`` stay in the vectors' dtype, as in JAX.  A cycle
ends at the first step whose residual |g[j+1]| meets rtol * |b|: the
iteration count is the JAX package's ``done_at`` sum, and x differs from
the JAX result (which runs the rest of the cycle) within the solver
tolerance.  Nothing indexes by a host integer: ``j`` stays on the device.

:func:`gmres_solve` runs the three functions eagerly (one host read of
``active`` a step and of ``go`` a cycle), or, on the card,
``solvers/graphs.GMRESLoop`` runs them as captured programs in two WHILE
loops on the device, the steps' inside the cycles': one host read a
solve.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import torch

__all__ = ["gmres_solve", "timed_gmres", "GMRESResult", "GMRESState",
           "gmres_init", "gmres_reset", "gmres_cycle_start", "gmres_step",
           "gmres_cycle_end"]


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # total inner iterations
    residual: float  # |g| at the end of the last cycle
    # host seconds a model's entry point reports (synchronised): building
    # its preconditioner, and the solve (a captured solve's capture in it)
    setup_s: float = 0.0
    solve_s: float = 0.0


class GMRESState(NamedTuple):
    """The solve's state, all on the vectors' device and updated in place:
    the bases ``V`` [m+1, n] and ``Z`` [m, n], the Hessenberg matrix ``H``
    [m+1, m] (rotated), the accumulated rotation ``Q`` [m+1, m+1], ``g``
    [m+1], ``x``; 0-dim ``tol``, ``j`` (steps of this cycle, int64),
    ``active`` (the cycle's condition), ``total`` (steps of every cycle),
    ``res`` and ``go`` (the outer loop's condition)."""

    x: torch.Tensor
    V: torch.Tensor
    Z: torch.Tensor
    H: torch.Tensor
    Q: torch.Tensor
    g: torch.Tensor
    tol: torch.Tensor
    j: torch.Tensor
    active: torch.Tensor
    total: torch.Tensor
    res: torch.Tensor
    go: torch.Tensor


def _givens(a: torch.Tensor, b: torch.Tensor):
    r = torch.hypot(a, b)
    pos = r > 0
    safe = torch.where(pos, r, torch.ones_like(r))
    return (torch.where(pos, a / safe, torch.ones_like(a)),
            torch.where(pos, b / safe, torch.zeros_like(b)))


def gmres_init(b: torch.Tensor, restart: int) -> GMRESState:
    """A zero state for GMRES(``restart``) on vectors like ``b``."""
    m, n = restart, b.shape[0]

    def zeros(*shape, dtype=b.dtype):
        return torch.zeros(shape, dtype=dtype, device=b.device)

    return GMRESState(
        x=torch.zeros_like(b), V=zeros(m + 1, n), Z=zeros(m, n),
        H=zeros(m + 1, m), Q=zeros(m + 1, m + 1), g=zeros(m + 1),
        tol=zeros(), j=zeros(dtype=torch.int64),
        active=zeros(dtype=torch.bool), total=zeros(dtype=torch.int64),
        res=zeros(), go=zeros(dtype=torch.bool))


def gmres_reset(st: GMRESState, b: torch.Tensor, x0: torch.Tensor | None,
                rtol: float, max_restarts: int) -> None:
    """Start a solve of A x = b on ``st``: x = x0 (zero when None), tol =
    rtol |b|, no steps, res = inf and ``go``; no host read."""
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.tol.copy_(rtol * torch.linalg.vector_norm(b))
    st.total.zero_()
    st.res.fill_(math.inf)
    st.go.copy_((st.res > st.tol) & (max_restarts * st.Z.shape[0] > 0))


def gmres_cycle_start(A: Callable, b: torch.Tensor, st: GMRESState) -> None:
    """Begin a restart cycle at the state's x."""
    r = b - A(st.x)
    beta = torch.linalg.vector_norm(r)
    st.V.zero_()
    st.V[0].copy_(r / torch.where(beta > 0, beta, torch.ones_like(beta)))
    st.Z.zero_()
    st.H.zero_()
    st.Q.zero_()
    st.Q.diagonal().fill_(1.0)
    st.g.zero_()
    st.g[0].copy_(beta)
    st.j.zero_()
    st.active.copy_(st.go)


def gmres_step(A: Callable, M: Callable | None, st: GMRESState) -> None:
    """One masked Arnoldi step (see the module docstring)."""
    M = M or (lambda v: v)
    V, act = st.V, st.active
    m = st.Z.shape[0]
    jc = st.j.clamp(max=m - 1).reshape(1)  # j == m only when inactive
    j1 = jc + 1
    both = torch.cat([jc, j1])
    z = M(V.index_select(0, jc)[0]).to(V.dtype)
    w = A(z)
    h = V @ w
    w = w - h @ V
    h2 = V @ w
    w = w - h2 @ V
    h = h + h2
    hj1 = torch.linalg.vector_norm(w)
    v_new = w / torch.where(hj1 > 0, hj1, torch.ones_like(hj1))
    # the earlier rotations, then this step's on rows j and j+1
    col = st.Q @ h.index_copy(0, j1, hj1.reshape(1))
    a, bb = col.index_select(0, both)
    c, s = _givens(a, bb)
    col = col.index_copy(0, both, torch.stack([c * a + s * bb,
                                               torch.zeros_like(a)]))
    q = st.Q.index_select(0, both)
    gj = st.g.index_select(0, jc)
    g_new = torch.cat([c * gj, -s * gj])

    def put(t, dim, idx, new):
        t.index_copy_(dim, idx, torch.where(act, new, t.index_select(dim,
                                                                     idx)))

    put(V, 0, j1, v_new[None])
    put(st.Z, 0, jc, z[None])
    put(st.H, 1, jc, col[:, None])
    put(st.Q, 0, both, torch.stack([c * q[0] + s * q[1],
                                    -s * q[0] + c * q[1]]))
    put(st.g, 0, both, g_new)
    going = act & (g_new[1].abs() > st.tol) & (j1[0] < m)
    st.j.add_(act.to(st.j.dtype))
    st.active.copy_(going)


def gmres_cycle_end(st: GMRESState, max_restarts: int) -> None:
    """End the cycle after its ``j`` steps: x updated, ``total``, ``res``
    and ``go``."""
    m = st.Z.shape[0]
    k = st.j
    Hm = st.H[:m]
    i = torch.arange(m, device=Hm.device)
    keep = (i < k) & (Hm.diagonal().abs() > 1e-30)
    eye = torch.eye(m, dtype=Hm.dtype, device=Hm.device)
    T = torch.where(keep[:, None], Hm, eye)
    rhs = torch.where(keep, st.g[:m], torch.zeros_like(st.g[:m]))
    y = torch.linalg.solve_triangular(T, rhs[:, None], upper=True)[:, 0]
    st.x.add_(y @ st.Z)
    st.total.add_(k)
    st.res.copy_(st.g.index_select(0, k.reshape(1))[0].abs())
    st.go.copy_((st.res > st.tol) & (st.total < max_restarts * m))


def gmres_solve(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    restart: int = 50,
    rtol: float = 1e-8,
    max_restarts: int = 40,
    capture: bool | None = None,
) -> GMRESResult:
    """Right-preconditioned GMRES(restart) on A x = b; ``M`` is applied as
    A M(v) and may vary from step to step (the Z basis is stored).

    ``capture`` (default: whether ``b`` is on a CUDA device) runs the
    solve as captured programs (``solvers/graphs.GMRESLoop``, made for
    this call; a capture that fails raises, and ``True`` off CUDA raises);
    ``False`` runs the cycle functions eagerly."""
    if capture is None:
        capture = b.device.type == "cuda"
    if capture:
        from polydeal_tpu_torch.solvers.graphs import GMRESLoop

        return GMRESLoop(A, M, b, restart=restart, rtol=rtol,
                         max_restarts=max_restarts).solve(b, x0)
    st = gmres_init(b, restart)
    gmres_reset(st, b, x0, rtol, max_restarts)
    while bool(st.go):
        gmres_cycle_start(A, b, st)
        while bool(st.active):
            gmres_step(A, M, st)
        gmres_cycle_end(st, max_restarts)
    return GMRESResult(x=st.x, iterations=int(st.total),
                       residual=float(st.res))


def timed_gmres(A: Callable, b: torch.Tensor, make_M: Callable,
                **kw) -> GMRESResult:
    """``M = make_M()`` (a preconditioner's setup), then
    :func:`gmres_solve` ``(A, b, M=M, **kw)``: the result with the host
    seconds of each (``setup_s``, ``solve_s``), read after a synchronise
    of ``b``'s device."""
    sync = (torch.cuda.synchronize if b.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    M = make_M()
    sync()
    t1 = time.perf_counter()
    res = gmres_solve(A, b, M=M, **kw)
    sync()
    return res._replace(setup_s=t1 - t0, solve_s=time.perf_counter() - t1)
