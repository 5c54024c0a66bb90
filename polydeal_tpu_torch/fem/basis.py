"""Discontinuous polynomial basis on the unit reference cell [0,1]^dim,
on torch tensors.

Counterpart of ``polydeal_tpu/fem/basis.py``: :class:`LegendreDGP`, the
complete polynomial space P_p spanned by products of shifted Legendre
polynomials, L2-orthonormal on [0,1]^dim, first function constant (the
reference's ``FE_AggloDGP``), and :class:`TensorDGQ`, the tensor space
Q_p with a nodal Lagrange basis on Gauss-Lobatto points (the reference's
``FE_DGQ``).  Exponent and coefficient tables stay numpy; evaluation runs
on whatever device and dtype the points tensor has.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from math import comb

import numpy as np
import torch

__all__ = ["LegendreDGP", "TensorDGQ", "make_basis"]


_CONSTS: dict = {}


def _const(key: tuple, make, dtype, device) -> torch.Tensor:
    """The host table ``make()`` as a ``dtype`` tensor on ``device``, made
    once a key: an evaluation then copies nothing from the host, which a
    captured CUDA graph could not hold."""
    k = key + (dtype, torch.device(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.as_tensor(make(), dtype=dtype, device=device)
    return t


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
    scale = _const(("legendre_scale", degree),
                   lambda: np.sqrt(2.0 * np.arange(degree + 1) + 1.0),
                   x.dtype, x.device)
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


def _tensor_exponents(dim: int, degree: int) -> np.ndarray:
    """All multi-indices with max entry <= degree (Q_p space)."""
    exps = list(itertools.product(range(degree + 1), repeat=dim))
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
        return _const((type(self).__name__, self.dim, self.degree, d),
                      lambda: self.exponents[:, d], torch.long, device)

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


def _gauss_lobatto_01(n: int) -> np.ndarray:
    """n Gauss-Lobatto points on [0,1] (n >= 2), or midpoint for n == 1."""
    if n == 1:
        return np.array([0.5])
    if n == 2:
        return np.array([0.0, 1.0])
    # interior points are roots of P'_{n-1}
    c = np.zeros(n)
    c[-1] = 1.0
    dleg = np.polynomial.legendre.Legendre(c).deriv()
    interior = np.sort(dleg.roots())
    pts = np.concatenate([[-1.0], interior, [1.0]])
    return 0.5 * (pts + 1.0)


@dataclass(frozen=True)
class TensorDGQ:
    """Tensor space Q_p, nodal Lagrange basis on Gauss-Lobatto points."""

    dim: int
    degree: int
    _coeffs: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        nodes = _gauss_lobatto_01(self.degree + 1)
        # monomial coefficients of each 1D Lagrange polynomial: the
        # columns of inv(Vandermonde), [power, node]
        V = np.vander(nodes, N=self.degree + 1, increasing=True)
        object.__setattr__(self, "_coeffs", np.linalg.inv(V))

    @property
    def exponents(self) -> np.ndarray:
        return _tensor_exponents(self.dim, self.degree)

    @property
    def n_basis(self) -> int:
        return (self.degree + 1) ** self.dim

    def _lagrange_1d_all(self, x: torch.Tensor):
        """1D Lagrange values/derivatives at x: x.shape + (deg+1,)."""
        n = self.degree + 1
        powers = torch.stack([x**k for k in range(n)], dim=-1)
        dpowers = torch.stack(
            [k * x ** max(k - 1, 0) if k > 0 else torch.zeros_like(x)
             for k in range(n)], dim=-1)
        C = _const(("dgq_coeffs", self.degree), lambda: self._coeffs,
                   x.dtype, x.device)
        return powers @ C, dpowers @ C

    def _index(self, d: int, device) -> torch.Tensor:
        return _const((type(self).__name__, self.dim, self.degree, d),
                      lambda: self.exponents[:, d], torch.long, device)

    def eval(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim] -> values [..., n_basis]."""
        V, _ = self._lagrange_1d_all(points)  # [..., dim, n1d]
        out = torch.ones(V.shape[:-2] + (self.n_basis,), dtype=V.dtype,
                         device=V.device)
        for d in range(self.dim):
            out = out * V[..., d, :][..., self._index(d, V.device)]
        return out

    def grad(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim] -> gradients [..., n_basis, dim]."""
        V, D = self._lagrange_1d_all(points)
        comps = []
        for e in range(self.dim):
            g = torch.ones(V.shape[:-2] + (self.n_basis,), dtype=V.dtype,
                           device=V.device)
            for d in range(self.dim):
                tab = D if d == e else V
                g = g * tab[..., d, :][..., self._index(d, V.device)]
            comps.append(g)
        return torch.stack(comps, dim=-1)

    def eval_t(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim, P] -> [..., nb, P]."""
        return self.eval(points.movedim(-2, -1)).movedim(-2, -1)

    def grad_t(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., dim, P] -> [..., nb, dim, P]."""
        return self.grad(points.movedim(-2, -1)).movedim(-3, -1)


def make_basis(family: str, dim: int, degree: int):
    family = family.lower()
    if family in ("dgp", "agglodgp", "legendre", "fe_agglodgp"):
        return LegendreDGP(dim, degree)
    if family in ("dgq", "fe_dgq"):
        return TensorDGQ(dim, degree)
    raise ValueError(f"unknown basis family: {family}")
