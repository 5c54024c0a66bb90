"""The port's restarted flexible GMRES against the JAX package's, at f64 on
the CPU, on a seeded nonsymmetric system: the same iteration count (the
JAX ``done_at`` sum) and x within 1e-8 relative, with and without a
preconditioner, with restarts and from a given x0; a flexible
(step-varying) preconditioner; the jax-free import check of the slice's
modules."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polydeal_tpu.solvers.gmres import gmres_solve as jgmres  # noqa: E402
from polydeal_tpu_torch.solvers.gmres import gmres_solve  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8


def _system(n=60, seed=3):
    """Nonsymmetric, well conditioned: a shifted random matrix with a
    convection-like skew part."""
    rng = np.random.default_rng(seed)
    A = (np.diag(2.0 + rng.uniform(0, 1, n))
         + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
         + np.diag(0.8 * np.ones(n - 1), 1) - np.diag(0.2 * np.ones(n - 1),
                                                       -1))
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    return A, b, x0


@pytest.mark.parametrize("case", [
    dict(),
    dict(precond=True),
    dict(restart=8),
    dict(restart=8, precond=True),
    dict(x0=True),
    dict(x0=True, restart=5),
], ids=["plain", "jacobi", "restart8", "restart8-jacobi", "x0",
        "x0-restart5"])
def test_gmres_matches_jax(case):
    A, b, x0 = _system()
    restart = case.get("restart", 50)
    dinv = 1.0 / np.diag(A)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Mj = (lambda v: jnp.asarray(dinv) * v) if case.get("precond") else None
    Mt = ((lambda v: torch.as_tensor(dinv) * v) if case.get("precond")
          else None)
    kw = dict(restart=restart, rtol=1e-10, max_restarts=40)
    ra = jgmres(lambda v: Aj @ v, bj, M=Mj,
                x0=jnp.asarray(x0) if case.get("x0") else None, **kw)
    rb = gmres_solve(lambda v: At @ v, bt, M=Mt,
                     x0=torch.as_tensor(x0) if case.get("x0") else None,
                     **kw)
    assert rb.iterations == int(ra.iterations)
    if restart < 50:
        assert rb.iterations > restart  # the case restarts
    xa = np.asarray(ra.x)
    assert np.abs(rb.x.numpy() - xa).max() <= TOL * np.abs(xa).max()
    assert rb.residual <= 1e-10 * np.linalg.norm(b)
    assert np.linalg.norm(b - A @ rb.x.numpy()) <= 1.01e-10 * np.linalg.norm(b)


def test_gmres_flexible_preconditioner():
    """A preconditioner that changes from step to step (an inner solve of
    varying accuracy): the stored Z basis keeps the solve exact."""
    A, b, _ = _system(seed=5)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    calls = [0]
    d = torch.as_tensor(np.diag(A).copy())

    def M(v):
        calls[0] += 1
        return v / d * (1.0 + 0.3 * ((calls[0] % 3) - 1))

    r = gmres_solve(lambda v: At @ v, bt, M=M, restart=30, rtol=1e-10)
    assert np.linalg.norm(b - A @ r.x.numpy()) <= 1.01e-10 * np.linalg.norm(b)
    assert r.iterations == calls[0]


def test_gmres_zero_rhs_and_exact_guess():
    """b = 0, and an exact x0: one inner step, as the JAX package counts
    it (the first cycle always runs), and x unchanged."""
    A, b, _ = _system(n=20)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    x = np.linalg.solve(A, b)
    for bb, x0, rtol in ((np.zeros(20), None, 1e-8), (b, x, 1e-6)):
        ra = jgmres(lambda v: Aj @ v, jnp.asarray(bb), rtol=rtol,
                    x0=None if x0 is None else jnp.asarray(x0))
        x0t = None if x0 is None else torch.as_tensor(x0)
        rb = gmres_solve(lambda v: At @ v, torch.as_tensor(bb), x0=x0t,
                         rtol=rtol)
        assert rb.iterations == int(ra.iterations) == 1
        assert np.abs(rb.x.numpy() - np.asarray(ra.x)).max() <= 1e-12 * max(
            1.0, np.abs(x).max())


def test_coupled_modules_import_no_jax():
    """The slice's modules (GMRES, SA-AMG, the mixed assembly, the coupled
    models, hp) and the interop helpers keep jax and the JAX package out
    of sys.modules."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import polydeal_tpu_torch.solvers.gmres\n"
        "import polydeal_tpu_torch.solvers.amg\n"
        "import polydeal_tpu_torch.fem.system\n"
        "import polydeal_tpu_torch.fem.hp\n"
        "import polydeal_tpu_torch.assembly.mixed\n"
        "import polydeal_tpu_torch.models.stokes\n"
        "import polydeal_tpu_torch.models.darcy_stokes\n"
        "import polydeal_tpu_torch.models.oseen\n"
        "import polydeal_tpu_torch.models.piston\n"
        "import polydeal_tpu_torch.interop\n"
        "from polydeal_tpu_torch.solvers import build_field_block_multigrid\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'polydeal_tpu')]\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
