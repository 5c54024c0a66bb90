"""The port's device-state GMRES (``gmres_init``, ``gmres_reset``,
``gmres_cycle_start``, ``gmres_step``, ``gmres_cycle_end``) against the
JAX package's ``gmres_solve``, at f64 on the CPU.

The captured loop (``solvers/graphs.GMRESLoop``, on a card only) replays
one program per step and queues steps ahead of what the host knows, so
the steps after a cycle's stop run masked.  Here the same functions run
on the CPU on that schedule at its worst, every cycle given all its
``restart`` steps and more: each step after the stop leaves every field
of the ``GMRESState`` bitwise as it was, and the result is
``gmres_solve``'s (the eager loop, one host read a step) bitwise; both
take the JAX package's iterations to x within 1e-8 relative, on
``tests/test_torch_gmres.py``'s seeded systems (with and without a
preconditioner, with restarts, from an x0, a zero rhs) and on the
darcy_stokes n=8 MG-GMRES (JAX's 49 iterations).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polydeal_tpu.solvers.gmres import gmres_solve as jgmres  # noqa: E402
from polydeal_tpu_torch.mesh import hyper_cube  # noqa: E402
from polydeal_tpu_torch.models import darcy_stokes as ds  # noqa: E402
from polydeal_tpu_torch.solvers.gmres import (  # noqa: E402
    gmres_cycle_end,
    gmres_cycle_start,
    gmres_init,
    gmres_reset,
    gmres_solve,
    gmres_step,
)

CPU = torch.device("cpu")


def _system(n=60, seed=3):
    """tests/test_torch_gmres.py's seeded nonsymmetric system."""
    rng = np.random.default_rng(seed)
    A = (np.diag(2.0 + rng.uniform(0, 1, n))
         + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
         + np.diag(0.8 * np.ones(n - 1), 1) - np.diag(0.2 * np.ones(n - 1),
                                                       -1))
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    return A, b, x0


def _blind(A, M, b, x0, restart, rtol, max_restarts, extra):
    """The solve on the captured loop's schedule at its worst: every
    cycle runs ``restart + extra`` steps, each one after the stop checked
    to leave the state bitwise unchanged.  Returns (state, steps run)."""
    st = gmres_init(b, restart)
    gmres_reset(st, b, x0, rtol, max_restarts)
    steps = 0
    while bool(st.go):
        gmres_cycle_start(A, b, st)
        for _ in range(restart + extra):
            before = [t.clone() for t in st] if not bool(st.active) else None
            gmres_step(A, M, st)
            steps += 1
            if before is not None:
                for name, p, q in zip(st._fields, before, st):
                    assert torch.equal(p, q), name
        assert not bool(st.active)
        gmres_cycle_end(st, max_restarts)
    return st, steps


@pytest.mark.parametrize("case", [
    dict(),
    dict(precond=True),
    dict(restart=8),
    dict(restart=8, precond=True),
    dict(x0=True),
    dict(x0=True, restart=5),
    dict(zero_b=True),
], ids=["plain", "jacobi", "restart8", "restart8-jacobi", "x0",
        "x0-restart5", "zero-rhs"])
def test_masked_steps_match_eager_and_jax(case):
    A, b, x0 = _system()
    if case.get("zero_b"):
        b = np.zeros_like(b)
    restart = case.get("restart", 50)
    dinv = 1.0 / np.diag(A)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Mt = ((lambda v: torch.as_tensor(dinv) * v) if case.get("precond")
          else None)
    x0t = torch.as_tensor(x0) if case.get("x0") else None
    kw = dict(restart=restart, rtol=1e-10, max_restarts=40)
    st, steps = _blind(lambda v: At @ v, Mt, bt, x0t, extra=3, **kw)
    eager = gmres_solve(lambda v: At @ v, bt, M=Mt, x0=x0t, capture=False,
                        **kw)
    assert int(st.total) == eager.iterations
    assert torch.equal(st.x, eager.x)
    assert float(st.res) == eager.residual
    assert steps > eager.iterations  # the schedule did run masked steps
    Mj = (lambda v: jnp.asarray(dinv) * v) if case.get("precond") else None
    ra = jgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=Mj,
                x0=jnp.asarray(x0) if case.get("x0") else None, **kw)
    assert eager.iterations == int(ra.iterations)
    if restart < 50:
        assert eager.iterations > restart  # the case restarts
    xa = np.asarray(ra.x)
    assert np.abs(eager.x.numpy() - xa).max() <= 1e-8 * max(
        np.abs(xa).max(), 1.0)


def test_masked_steps_through_the_darcy_preconditioner():
    """darcy_stokes n=8, MG-GMRES (block-triangular field V-cycles): steps
    after the stop, through the whole preconditioner on the stale row,
    leave the state bitwise unchanged; JAX's 49 iterations."""
    s, _ = ds.run(8, 2, device=CPU)
    M = ds.mg_block_preconditioner(s, hyper_cube(2, 8), 8, 2,
                                   ps_mode="mass+stab", structure="tri")
    A = ds._regularized(s)
    kw = dict(restart=200, rtol=1e-11, max_restarts=40)
    eager = gmres_solve(A, s.rhs, M=M, capture=False, **kw)
    assert eager.iterations == 49
    st = gmres_init(s.rhs, kw["restart"])
    gmres_reset(st, s.rhs, None, kw["rtol"], kw["max_restarts"])
    gmres_cycle_start(A, s.rhs, st)
    while bool(st.active):
        gmres_step(A, M, st)
    for _ in range(3):
        before = [t.clone() for t in st]
        gmres_step(A, M, st)
        assert all(torch.equal(p, q) for p, q in zip(before, st))
    gmres_cycle_end(st, kw["max_restarts"])
    assert not bool(st.go)
    assert int(st.total) == 49
    assert torch.equal(st.x, eager.x)
