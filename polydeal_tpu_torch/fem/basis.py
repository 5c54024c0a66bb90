"""Discontinuous polynomial basis on the unit reference cell [0,1]^dim,
on torch tensors.

Counterpart of ``polydeal_tpu/fem/basis.py``: :class:`LegendreDGP`, the
complete polynomial space P_p spanned by products of shifted Legendre
polynomials, L2-orthonormal on [0,1]^dim, first function constant (the
reference's ``FE_AggloDGP``).  Exponent tables stay numpy; evaluation
runs on whatever device and dtype the points tensor has.  ``TensorDGQ``
is not ported yet.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from math import comb

import numpy as np
import torch

__all__ = ["LegendreDGP", "make_basis"]


def _legendre_1d_all(x: torch.Tensor, degree: int):
    """Orthonormal shifted Legendre values/derivatives on [0,1].

    Returns (vals, ders), each of shape x.shape + (degree+1,).
    L_k(x) = sqrt(2k+1) * P_k(2x-1), by the exact three-term recurrence.
    """
    t = 2.0 * x - 1.0
    vals = [torch.ones_like(x)]
    ders = [torch.zeros_like(x)]  # dP_k/dt
    if degree >= 1:
        vals.append(t)
        ders.append(torch.ones_like(x))
    for k in range(1, degree):
        # (k+1) P_{k+1} = (2k+1) t P_k - k P_{k-1}
        vals.append(((2 * k + 1) * t * vals[k] - k * vals[k - 1]) / (k + 1))
        # P'_{k+1}(t) = P'_{k-1}(t) + (2k+1) P_k(t)
        ders.append(ders[k - 1] + (2 * k + 1) * vals[k])
    scale = torch.as_tensor(np.sqrt(2.0 * np.arange(degree + 1) + 1.0),
                            dtype=x.dtype, device=x.device)
    V = torch.stack(vals, dim=-1) * scale
    # d/dx = 2 d/dt
    D = torch.stack(ders, dim=-1) * (2.0 * scale)
    return V, D


def _complete_exponents(dim: int, degree: int) -> np.ndarray:
    """Multi-indices alpha with |alpha| <= degree, graded ordering; the
    first index is (0,...,0), so basis function 0 is the constant mode."""
    exps = []
    for total in range(degree + 1):
        for alpha in itertools.product(range(total + 1), repeat=dim):
            if sum(alpha) == total:
                exps.append(alpha)
    return np.asarray(exps, dtype=np.int32)


@dataclass(frozen=True)
class LegendreDGP:
    """Complete polynomial space P_p, orthonormal modal Legendre basis."""

    dim: int
    degree: int

    @property
    def exponents(self) -> np.ndarray:
        return _complete_exponents(self.dim, self.degree)

    @property
    def n_basis(self) -> int:
        return comb(self.degree + self.dim, self.dim)

    def _index(self, d: int, device) -> torch.Tensor:
        return torch.as_tensor(self.exponents[:, d], dtype=torch.long,
                               device=device)

    def eval(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim] -> values [..., n_basis]."""
        V, _ = _legendre_1d_all(points, self.degree)  # [..., dim, deg+1]
        out = torch.ones(V.shape[:-2] + (self.n_basis,), dtype=V.dtype,
                         device=V.device)
        for d in range(self.dim):
            out = out * V[..., d, :][..., self._index(d, V.device)]
        return out

    def grad(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim] -> gradients [..., n_basis, dim]."""
        V, D = _legendre_1d_all(points, self.degree)
        comps = []
        for e in range(self.dim):
            g = torch.ones(V.shape[:-2] + (self.n_basis,), dtype=V.dtype,
                           device=V.device)
            for d in range(self.dim):
                tab = D if d == e else V
                g = g * tab[..., d, :][..., self._index(d, V.device)]
            comps.append(g)
        return torch.stack(comps, dim=-1)

    # -- entity-LAST (transposed) evaluation: points [..., dim, P] ----
    def _tables_t(self, points: torch.Tensor):
        """Per-dim LISTS of [..., P] value/derivative tensors."""
        deg = self.degree
        scale = np.sqrt(2.0 * np.arange(deg + 1) + 1.0)
        vals, ders = [], []
        for d in range(self.dim):
            x = points[..., d, :]
            t = 2.0 * x - 1.0
            v = [torch.ones_like(x)]
            dv = [torch.zeros_like(x)]
            if deg >= 1:
                v.append(t)
                dv.append(torch.ones_like(x))
            for k in range(1, deg):
                v.append(((2 * k + 1) * t * v[k] - k * v[k - 1]) / (k + 1))
                dv.append(dv[k - 1] + (2 * k + 1) * v[k])
            vals.append([v[k] * float(scale[k]) for k in range(deg + 1)])
            ders.append([dv[k] * float(2.0 * scale[k])
                         for k in range(deg + 1)])
        return vals, ders

    def eval_t(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim, P] -> [..., nb, P], lane axis P minor."""
        vals, _ = self._tables_t(points)
        E = self.exponents
        out = []
        for i in range(E.shape[0]):
            g = vals[0][E[i, 0]]
            for d in range(1, self.dim):
                g = g * vals[d][E[i, d]]
            out.append(g)
        return torch.stack(out, dim=-2)

    def grad_t(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim, P] -> [..., nb, dim, P]."""
        vals, ders = self._tables_t(points)
        E = self.exponents
        rows = []
        for i in range(E.shape[0]):
            comps = []
            for e in range(self.dim):
                g = None
                for d in range(self.dim):
                    tab = ders if d == e else vals
                    t = tab[d][E[i, d]]
                    g = t if g is None else g * t
                comps.append(g)
            rows.append(torch.stack(comps, dim=-2))  # [..., dim, P]
        return torch.stack(rows, dim=-3)  # [..., nb, dim, P]


def make_basis(family: str, dim: int, degree: int) -> LegendreDGP:
    family = family.lower()
    if family in ("dgp", "agglodgp", "legendre", "fe_agglodgp"):
        return LegendreDGP(dim, degree)
    raise NotImplementedError(
        f"basis family {family!r} is not ported yet (only 'dgp')")
