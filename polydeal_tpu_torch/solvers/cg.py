"""Preconditioned conjugate gradients on torch tensors.

Counterpart of ``polydeal_tpu/solvers/cg.py`` ``cg_solve`` and its point
and block Jacobi preconditioners.  The JAX version is one
``lax.while_loop``; here that loop is three functions on device tensors:

* :func:`cg_init`: the initial state and ``tol = max(rtol |b|, atol)``;
* :func:`cg_body`: one iteration, masked by the state's ``active`` (the
  JAX loop's ``cond``: ``|r| > tol and k < maxiter``), so that a body run
  after convergence leaves ``(x, r, p, rz, k, active)`` bitwise as they
  were.  It ends with the ``cond`` of the state it returns (where the JAX
  loop evaluates it, before the next body), so that a caller learns from
  one body whether the next one is needed;
* :func:`cg_finish`: x and the final |r|.

:func:`cg_solve` runs the body eagerly with one host read of ``active`` an
iteration (on any device).  ``solvers/graphs.CGLoop`` captures the same
body and runs it in a WHILE loop on the device: one program and one host
read a solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["cg_solve", "cg_init", "cg_body", "cg_finish", "CGResult",
           "CGState", "block_jacobi_preconditioner", "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # final |r|_2 (0-dim, on the device)


class CGState(NamedTuple):
    """The loop state, all on the vectors' device: ``k`` int32 and
    ``active`` bool, 0-dim."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    k: torch.Tensor
    active: torch.Tensor


def jacobi_preconditioner(diagonal: torch.Tensor) -> Callable:
    inv = 1.0 / diagonal
    return lambda r: inv * r


def block_jacobi_preconditioner(diag_blocks: torch.Tensor) -> Callable:
    """M^{-1} from the n_b x n_b diagonal blocks [P, nb, nb] (inverted
    once), applied to a flat vector."""
    n_poly, nb, _ = diag_blocks.shape
    inv = torch.linalg.inv(diag_blocks)

    def apply(r):
        rb = r.reshape(n_poly, nb)
        return torch.einsum("pij,pj->pi", inv, rb).reshape(-1)

    return apply


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm_of(dot: Callable | None) -> Callable:
    if dot is None:
        return torch.linalg.vector_norm
    return lambda v: torch.sqrt(dot(v, v))


def _cond(r, k, tol, maxiter: int, norm) -> torch.Tensor:
    return (norm(r) > tol) & (k < maxiter)


def cg_init(A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
            M: Callable | None = None, rtol: float = 1e-9,
            atol: float = 0.0, maxiter: int = 1000,
            dot: Callable | None = None) -> tuple[CGState, torch.Tensor]:
    """(the state before the first iteration, tol), with no host read."""
    M = M or (lambda r: r)
    norm = _norm_of(dot)
    dot = dot or _dot
    if x0 is None:  # zero guess: r0 = b, no operator apply needed
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    z = M(r)
    rz = dot(r, z)
    tol = torch.clamp(rtol * norm(b), min=atol)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return CGState(x, r, z, rz, k, _cond(r, k, tol, maxiter, norm)), tol


def cg_body(A: Callable, M: Callable | None, st: CGState,
            tol: torch.Tensor, maxiter: int,
            dot: Callable | None = None) -> CGState:
    """One CG iteration where ``st.active``, else the state unchanged
    (``torch.where``, bitwise); the result's ``active`` is the loop
    condition of the result."""
    M = M or (lambda r: r)
    norm = _norm_of(dot)
    dot = dot or _dot
    x, r, p, rz, k, active = st
    Ap = A(p)
    alpha = rz / dot(p, Ap)
    x1 = x + alpha * p
    r1 = r - alpha * Ap
    z = M(r1)
    rz1 = dot(r1, z)
    beta = rz1 / rz
    p1 = z + beta * p
    x = torch.where(active, x1, x)
    r = torch.where(active, r1, r)
    p = torch.where(active, p1, p)
    rz = torch.where(active, rz1, rz)
    k = k + active.to(k.dtype)
    return CGState(x, r, p, rz, k, _cond(r, k, tol, maxiter, norm))


def cg_finish(st: CGState, dot: Callable | None = None):
    """(x, |r|) of a finished state."""
    return st.x, _norm_of(dot)(st.r)


def cg_solve(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    M: Callable | None = None,
    rtol: float = 1e-9,
    atol: float = 0.0,
    maxiter: int = 1000,
    dot: Callable | None = None,
) -> CGResult:
    """Preconditioned CG on A x = b; A and M are linear callables.

    Stops when |r| <= max(rtol*|b|, atol), or after ``maxiter``
    iterations.  ``dot`` replaces the inner product (a sharded solve's
    all-reduced one, on each rank's part of the vectors); the norms are
    then sqrt(dot(v, v)).  Runs :func:`cg_body` eagerly: one host read of
    the loop condition an iteration."""
    st, tol = cg_init(A, b, x0, M, rtol, atol, maxiter, dot)
    while bool(st.active):
        st = cg_body(A, M, st, tol, maxiter, dot)
    x, res = cg_finish(st, dot)
    return CGResult(x=x, iterations=int(st.k), residual=res)
