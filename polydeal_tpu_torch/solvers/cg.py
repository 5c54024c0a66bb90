"""Preconditioned conjugate gradients on torch tensors.

Counterpart of ``polydeal_tpu/solvers/cg.py`` ``cg_solve`` and its point
and block Jacobi preconditioners.  The JAX version is one
``lax.while_loop``; here it is a Python loop whose only host
synchronisation per iteration is the norm test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["cg_solve", "CGResult", "block_jacobi_preconditioner",
           "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # final |r|_2 (0-dim, on the device)


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
    then sqrt(dot(v, v))."""
    if M is None:
        M = lambda r: r
    if dot is None:
        dot, norm = _dot, torch.linalg.vector_norm
    else:
        norm = lambda v: torch.sqrt(dot(v, v))
    if x0 is None:  # zero guess: r0 = b, no operator apply needed
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    tol = max(rtol * float(norm(b)), atol)
    k = 0
    while k < maxiter and float(norm(r)) > tol:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x=x, iterations=k, residual=norm(r))
