"""The port's Poisson model against the JAX package's, at f64 on the CPU:
the BASELINE gate (the same L2/H1 errors, to 1e-8 relative, in 2D and 3D)
and the same CG iterations, on the R-tree + R3MG and the partition +
block-Jacobi CG arms, and the SA-AMG arm.  (Diffusion-reaction, the host
models and the timer: tests/test_torch_diffusion_reaction.py; each file
pays ~1 min of the JAX side's jit compiles.)"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu.models import poisson as jpoisson  # noqa: E402
from polydeal_tpu_torch.models import poisson as tpoisson  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-8


def _rel(a, b):
    return abs(a - b) / abs(a)


@pytest.mark.parametrize("kw", [
    dict(dim=2, n=16),  # rtree + mg
    dict(dim=2, n=8, degree=2, strategy="metis", solver="cg"),
    dict(dim=3, n=8),
], ids=["2d-rtree-mg", "2d-p2-metis-cg", "3d-rtree-mg"])
def test_solve_poisson_matches_jax(kw):
    a = jpoisson.solve_poisson(verbose=False, **kw)
    b = tpoisson.solve_poisson(verbose=False, device=CPU, **kw)
    for key in ("n_cells", "n_poly", "n_dofs", "iterations"):
        assert a[key] == b[key], key
    assert _rel(a["l2"], b["l2"]) <= TOL and _rel(a["h1"], b["h1"]) <= TOL
    assert b["residual"] <= 1e-9 * float(b["b"].norm()) * 1.01
    assert tuple(b["x"].shape) == (b["n_dofs"],)
    if kw.get("solver", "mg") == "mg" and kw.get("strategy",
                                                 "rtree") == "rtree":
        # every level banded from its BlockMatrix (the R-tree numbering
        # never needs more than 96 offsets at these sizes)
        assert [lv[1] for lv in b["levels"]] == ["banded"] * len(
            b["levels"])


def test_amg_arm_raises():
    """The SA-AMG arm (ROADMAP Queue 1 item 6) no longer raises: it solves
    as the JAX package's does (the same iterations, L2/H1 to 1e-8); an
    unknown solver still raises."""
    a = jpoisson.solve_poisson(dim=2, n=8, solver="amg", verbose=False)
    b = tpoisson.solve_poisson(dim=2, n=8, solver="amg", verbose=False,
                               device=CPU)
    assert a["iterations"] == b["iterations"]
    assert _rel(a["l2"], b["l2"]) <= TOL and _rel(a["h1"], b["h1"]) <= TOL
    with pytest.raises(ValueError, match="unknown solver"):
        tpoisson.solve_poisson(dim=2, n=4, solver="bogus", verbose=False,
                               device=CPU)
