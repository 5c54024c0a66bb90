"""Restarted flexible GMRES on torch tensors: the Krylov solver of the
nonsymmetric coupled systems (Stokes-Darcy, Oseen).

Counterpart of ``polydeal_tpu/solvers/gmres.py`` ``gmres_solve``:
right-preconditioned GMRES(restart) that stores the Z basis (flexible in
the FGMRES sense), orthogonalises with classical Gram-Schmidt and one
reorthogonalisation pass (CGS2), rotates with Givens and back-substitutes
with a 1e-30 guard on the diagonal.  The JAX version runs every restart
cycle to its end in one ``fori_loop``; here the Hessenberg column comes to
the host once an inner step (the one host synchronisation), the rotations
and the stopping test run there in float64, and a cycle ends at the first
inner step whose residual |g[j+1]| meets rtol * |b|.  The iteration count
is the JAX package's ``done_at`` sum; x then differs from the JAX result
(which runs the rest of the cycle) within the solver tolerance.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["gmres_solve", "GMRESResult"]


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iterations: int  # total inner iterations
    residual: float  # |g| at the end of the last cycle


def _givens(a: float, b: float) -> tuple[float, float]:
    r = math.hypot(a, b)
    if r > 0:
        return a / r, b / r
    return 1.0, 0.0


def gmres_solve(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    restart: int = 50,
    rtol: float = 1e-8,
    max_restarts: int = 40,
) -> GMRESResult:
    """Right-preconditioned GMRES(restart) on A x = b; ``M`` is applied as
    A M(v) and may vary from step to step (the Z basis is stored)."""
    if M is None:
        M = lambda v: v
    n = b.shape[0]
    m = restart
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    tol = rtol * float(torch.linalg.vector_norm(b))
    total = 0
    res = math.inf
    while res > tol and total < max_restarts * m:
        r = b - A(x)
        beta = float(torch.linalg.vector_norm(r))
        V = b.new_zeros((m + 1, n))
        Z = b.new_zeros((m, n))
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        V[0] = r / (beta if beta > 0 else 1.0)
        done_at = m
        for j in range(m):
            z = M(V[j])
            w = A(z)
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - h @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            h = h + h2
            hj1 = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.where(hj1 > 0, hj1, torch.ones_like(hj1))
            Z[j] = z
            col = np.zeros(m + 1)
            col[:j + 1] = h.cpu().numpy()  # the step's one synchronisation
            col[j + 1] = float(hj1)
            for i in range(j):
                hi, hi1 = col[i], col[i + 1]
                col[i] = cs[i] * hi + sn[i] * hi1
                col[i + 1] = -sn[i] * hi + cs[i] * hi1
            ci, si = _givens(col[j], col[j + 1])
            col[j] = ci * col[j] + si * col[j + 1]
            col[j + 1] = 0.0
            cs[j], sn[j] = ci, si
            gj = g[j]
            g[j] = ci * gj
            g[j + 1] = -si * gj
            H[:, j] = col
            if abs(g[j + 1]) <= tol:
                done_at = j + 1
                break
        k = done_at
        y = np.zeros(k)
        for i in range(k - 1, -1, -1):
            num = g[i] - H[i, :k] @ y
            y[i] = num / H[i, i] if abs(H[i, i]) > 1e-30 else 0.0
        x = x + torch.as_tensor(y, dtype=b.dtype, device=b.device) @ Z[:k]
        res = abs(g[k])
        total += done_at
    return GMRESResult(x=x, iterations=total, residual=res)
