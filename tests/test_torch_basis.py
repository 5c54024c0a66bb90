"""The port's LegendreDGP basis against the JAX package's, at f64.

``eval``, ``grad``, ``eval_t`` and ``grad_t`` run the same recurrences in
the same order, so they agree to round-off: tolerance 1e-14.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polydeal_tpu.fem.basis import LegendreDGP  # noqa: E402
from polydeal_tpu_torch.fem.basis import (  # noqa: E402
    LegendreDGP as TLegendreDGP,
)

TOL = 1e-14


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_basis_matches_jax(dim, degree):
    ref, port = LegendreDGP(dim, degree), TLegendreDGP(dim, degree)
    assert port.n_basis == ref.n_basis
    assert np.array_equal(port.exponents, ref.exponents)
    rng = np.random.default_rng(10 * dim + degree)
    pts = rng.random((5, 7, dim))  # [..., dim]
    pts_t = rng.random((3, 4, dim, 9))  # [..., dim, P]
    cases = [
        (ref.eval(jnp.asarray(pts)), port.eval(torch.from_numpy(pts))),
        (ref.grad(jnp.asarray(pts)), port.grad(torch.from_numpy(pts))),
        (ref.eval_t(jnp.asarray(pts_t)), port.eval_t(torch.from_numpy(pts_t))),
        (ref.grad_t(jnp.asarray(pts_t)), port.grad_t(torch.from_numpy(pts_t))),
    ]
    for a, b in cases:
        a = np.asarray(a)
        assert b.dtype == torch.float64 and tuple(b.shape) == a.shape
        assert np.abs(a - b.numpy()).max() <= TOL * max(np.abs(a).max(), 1)


def test_unported_family_raises():
    """Both families are ported (TensorDGQ since the COO slice); a family
    the JAX package does not know raises as there."""
    from polydeal_tpu_torch.fem.basis import TensorDGQ, make_basis

    assert isinstance(make_basis("dgp", 2, 1), TLegendreDGP)
    assert isinstance(make_basis("dgq", 2, 1), TensorDGQ)
    with pytest.raises(ValueError):
        make_basis("fe_nothing", 2, 1)
