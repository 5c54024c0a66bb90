"""The coarsest level's direct solve (``solvers/lu``): the pivots as a row
permutation and two triangular solves on ``torch.linalg.lu_factor``'s
factors, against ``torch.linalg.lu_solve`` on the same factors (f64,
seeded systems with pivoting; 1e-13 relative, rounding), and the
multigrid's coarse solve through it against the JAX package's
``lu_solve`` (``polydeal_tpu/solvers/multigrid.py``) on the same system.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.solvers.lu import (  # noqa: E402
    lu_solve, pivot_permutation)


def _system(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + np.diag(rng.uniform(0.5, 2.0, n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("n, seed", [(1, 0), (7, 1), (48, 2), (130, 3)])
def test_triangular_solves_match_lu_solve(n, seed):
    A, b = _system(n, seed)
    At, bt = torch.tensor(A), torch.tensor(b)
    lu = torch.linalg.lu_factor(At)
    perm = pivot_permutation(lu)
    assert sorted(perm.tolist()) == list(range(n))
    x = lu_solve(lu[0], perm, bt)
    ref = torch.linalg.lu_solve(*lu, bt[:, None])[:, 0]
    assert x.shape == (n,) and x.dtype == torch.float64
    assert float((x - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    assert float((At @ x - bt).abs().max()) <= 1e-12 * float(bt.abs().max())


def test_pivots_permute_rows():
    """b[perm] is P^T b for A = P L U (a system that must pivot)."""
    A = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 2.0], [3.0, 0.0, 0.0]],
                     dtype=torch.float64)
    lu = torch.linalg.lu_factor(A)
    P, L, U = torch.lu_unpack(*lu)
    b = torch.arange(3, dtype=torch.float64)
    assert torch.equal(b[pivot_permutation(lu)], P.T @ b)
    assert torch.allclose(lu_solve(lu[0], pivot_permutation(lu), b),
                          torch.linalg.solve(A, b), rtol=0, atol=1e-15)


def test_matches_jax_lu_solve():
    import jax
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    jax.config.update("jax_enable_x64", True)
    A, b = _system(64, 5)
    jl = jsl.lu_factor(jnp.asarray(A))
    ref = np.asarray(jsl.lu_solve(jl, jnp.asarray(b)))
    lu = torch.linalg.lu_factor(torch.tensor(A))
    x = lu_solve(lu[0], pivot_permutation(lu), torch.tensor(b)).numpy()
    assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()
