"""Chebyshev polynomial smoother with point-Jacobi preconditioning.

Counterpart of ``polydeal_tpu/solvers/chebyshev.py``: a fixed-degree
preconditioned Chebyshev semi-iteration (the reference smooths with deal.II
``PreconditionChebyshev``).  The smoothing interval arrives as Python
floats, so the recurrence scalars never touch the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["estimate_lambda_max", "ChebyshevSmoother"]


def estimate_lambda_max(A: Callable, Minv: Callable, n: int, iters: int = 20,
                        dtype=torch.float64, *, device) -> float:
    """Power iteration estimate of lambda_max(M^{-1} A), from the same
    deterministic ``sin`` start vector as the JAX package."""
    v = torch.sin(torch.arange(1, n + 1, dtype=dtype, device=device))
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = Minv(A(v))
        v = w / torch.linalg.vector_norm(w)
    w = Minv(A(v))
    return float(torch.dot(v, w))


@dataclass
class ChebyshevSmoother:
    """Degree-k Chebyshev iteration targeting the interval [lo, hi] of the
    preconditioned spectrum (standard three-term recurrence).

    ``step_fn(x, d, c1, c2) -> (x', d')`` is an optional FUSED step
    implementing ``d' = c1*d + c2*Minv(b - A x); x' = x + d'`` with b bound
    by the caller (kernel K2, fused K0 or K7, ops/fused_cheb.py);
    ``d=None`` marks the first step (c1 unused).

    ``x_is_zero=True`` skips the first operator apply (A 0 = 0): the
    pre-smoother always starts from zero."""

    A: Callable
    Minv: Callable
    lo: float
    hi: float
    degree: int = 3
    step_fn: Callable | None = None

    def __call__(self, b: torch.Tensor, x: torch.Tensor,
                 x_is_zero: bool = False) -> torch.Tensor:
        theta = 0.5 * (self.hi + self.lo)
        delta = 0.5 * (self.hi - self.lo)
        sigma = theta / delta

        if self.step_fn is not None:
            if x_is_zero:  # d = Minv(b)/theta, x = 0 + d: elementwise only
                d = self.Minv(b) * (1.0 / theta)
                x = d
            else:
                x, d = self.step_fn(x, None, 0.0, 1.0 / theta)
            rho_old = 1.0 / sigma
            for _ in range(self.degree - 1):
                rho = 1.0 / (2.0 * sigma - rho_old)
                x, d = self.step_fn(x, d, rho * rho_old, 2.0 * rho / delta)
                rho_old = rho
            return x

        r = b if x_is_zero else b - self.A(x)
        z = self.Minv(r)
        d = z * (1.0 / theta)
        x = x + d if not x_is_zero else d
        rho_old = 1.0 / sigma
        for _ in range(self.degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = b - self.A(x)
            z = self.Minv(r)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * z
            x = x + d
            rho_old = rho
        return x
