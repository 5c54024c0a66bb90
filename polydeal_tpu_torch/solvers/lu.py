"""The direct solve of a coarsest level from ``torch.linalg.lu_factor``'s
factors: the multigrid's (``solvers/multigrid``) and the flat sharded
system's (``parallel/sharding``), as the JAX package's ``lu_solve`` on
the kept factors.

It permutes the right-hand side by the pivots and runs the two
triangular solves (cuBLAS trsm on the card).  ``torch.linalg.lu_solve``
would compute the same to rounding, but its cuSOLVER getrs allocates
stream-ordered memory inside a capture, and a WHILE body of a device
loop (``solvers/graphs``) refuses memory nodes.
"""

from __future__ import annotations

import torch

__all__ = ["pivot_permutation", "lu_solve"]


def pivot_permutation(lu: tuple) -> torch.Tensor:
    """The pivots of ``lu = torch.linalg.lu_factor(A)`` as a row
    permutation: ``b[perm] = P^T b`` for A = P L U."""
    P, _, _ = torch.lu_unpack(*lu, unpack_data=False)
    return P.argmax(dim=0)


def lu_solve(LU: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """A^{-1} b for a vector ``b``, from the packed factors ``LU`` and
    :func:`pivot_permutation`'s ``perm``."""
    y = torch.linalg.solve_triangular(LU, b[perm][:, None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[:, 0]
