"""Quadrature rules on the unit reference cell [0,1]^dim.

TPU-first design note: rules are plain numpy arrays computed once on the
host at setup time; everything downstream consumes them as static-shape
constants baked into jitted programs.  The reference reaches the same data
through deal.II QGauss objects (cf. reference
source/agglomeration_handler.cc:210-265 ``initialize_fe_values``).

Port note: a jax-free copy of ``polydeal_tpu/fem/quadrature.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def gauss_legendre_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss–Legendre rule on [0, 1] (exact for degree 2n-1)."""
    if n < 1:
        raise ValueError("need at least one quadrature point")
    pts, wts = np.polynomial.legendre.leggauss(n)
    # map [-1, 1] -> [0, 1]
    return (0.5 * (pts + 1.0)), (0.5 * wts)


@lru_cache(maxsize=None)
def tensor_gauss(dim: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product Gauss rule on [0,1]^dim.

    Returns (points [n^dim, dim], weights [n^dim]).  Point ordering is
    lexicographic with the *first* coordinate varying slowest.
    """
    p1, w1 = gauss_legendre_1d(n)
    pts = np.array(list(itertools.product(p1, repeat=dim)), dtype=np.float64)
    wts = np.array(
        [np.prod(c) for c in itertools.product(w1, repeat=dim)], dtype=np.float64
    )
    if dim == 0:
        pts = np.zeros((1, 0))
        wts = np.ones((1,))
    return pts, wts


@lru_cache(maxsize=None)
def face_quadrature(dim: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(dim-1)-dimensional tensor Gauss rule for a face of [0,1]^dim."""
    return tensor_gauss(dim - 1, n)


@lru_cache(maxsize=None)
def grundmann_moeller(dim: int, s: int) -> tuple[np.ndarray, np.ndarray]:
    """Grundmann–Möller simplex rule of degree 2s+1 on the unit simplex
    {x >= 0, sum x <= 1}.  Exact for polynomials of degree <= 2s+1;
    weights sum to the simplex volume 1/dim!.

    Replaces deal.II's QGaussSimplex in the reference's simplex paths.
    """
    import math

    vol = 1.0 / math.factorial(dim)
    pts_list, wts_list = [], []
    d = 2 * s + 1
    for i in range(s + 1):
        w = (
            (-1) ** i
            * 2.0 ** (-2 * s)
            * (d + dim - 2 * i) ** d
            / (math.factorial(i) * math.factorial(d + dim - i))
        )
        # all compositions of s - i into dim+1 parts
        for comp in _compositions(s - i, dim + 1):
            bary = np.array([(2 * c + 1) / (d + dim - 2 * i) for c in comp])
            pts_list.append(bary[1:])  # drop the first barycentric coord
            wts_list.append(w)
    pts = np.asarray(pts_list, dtype=np.float64)
    wts = np.asarray(wts_list, dtype=np.float64)
    wts = wts * (vol / wts.sum())  # normalize (GM weights sum to volume)
    return pts, wts


def _compositions(n: int, k: int):
    """All k-tuples of nonnegative ints summing to n."""
    if k == 1:
        yield (n,)
        return
    for first in range(n + 1):
        for rest in _compositions(n - first, k - 1):
            yield (first,) + rest


def embed_face_points(face_pts: np.ndarray, axis: int, side: int) -> np.ndarray:
    """Embed (dim-1)-dim face quadrature points into the unit cell.

    The reference cell [0,1]^dim has 2*dim faces; face ``2*axis + side``
    is the hyperplane {x_axis = side}.  ``face_pts`` has shape [q, dim-1];
    the result has shape [q, dim] with the remaining coordinates filled in
    order.
    """
    q, dm1 = face_pts.shape
    dim = dm1 + 1
    out = np.empty((q, dim), dtype=face_pts.dtype)
    other = [a for a in range(dim) if a != axis]
    out[:, axis] = float(side)
    for k, a in enumerate(other):
        out[:, a] = face_pts[:, k]
    return out
