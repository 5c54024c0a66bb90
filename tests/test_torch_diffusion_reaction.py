"""The port's diffusion-reaction model against the JAX package's, at f64
on the CPU: the convergence study's errors to 1e-8 relative and its rate
(the BASELINE gate); its partition arm (SA-AMG).  Also the host
models (the quality-metric table equal to the JAX package's, the
agglomeration timings) and the timer scopes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu.models import diffusion_reaction as jdr  # noqa: E402
from polydeal_tpu.models import metrics_study as jms  # noqa: E402
from polydeal_tpu_torch.models import benchmarks as tbench  # noqa: E402
from polydeal_tpu_torch.models import diffusion_reaction as tdr  # noqa: E402
from polydeal_tpu_torch.models import metrics_study as tms  # noqa: E402
from polydeal_tpu_torch.utils.timer import Timer  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-8


def _rel(a, b):
    return abs(a - b) / abs(a)


def test_convergence_study_matches_jax():
    """diffusion_reaction's convergence study: the same errors to 1e-8
    relative and the same rate."""
    ea, ra = jdr.convergence_study(dim=2, degree=1, sizes=(8, 16),
                                   verbose=False)
    eb, rb = tdr.convergence_study(dim=2, degree=1, sizes=(8, 16),
                                   verbose=False, device=CPU)
    assert all(_rel(a, b) <= TOL for a, b in zip(ea, eb))
    assert abs(ra[0] - rb[0]) <= 1e-6


def test_amg_arm_raises():
    """The partition arm solves with SA-AMG, as the JAX package's does
    (ROADMAP Queue 1 item 6, no longer raising): the same iterations and
    L2 to 1e-8; an unknown strategy still raises."""
    a = jdr.solve_diffusion_reaction(dim=2, n=8, strategy="metis",
                                     verbose=False)
    b = tdr.solve_diffusion_reaction(dim=2, n=8, strategy="metis",
                                     verbose=False, device=CPU)
    assert a["iterations"] == b["iterations"]
    assert _rel(a["l2"], b["l2"]) <= TOL
    with pytest.raises(ValueError, match="unknown strategy"):
        tdr.solve_diffusion_reaction(dim=2, n=4, strategy="bogus",
                                     verbose=False, device=CPU)


def test_host_models():
    """The quality-metric table equals the JAX package's; the
    agglomeration timings cover every phase."""
    a = jms.run(n=8, verbose=False)
    b = tms.run(n=8, verbose=False)
    assert sorted(a) == sorted(b)
    for name in a:
        for key, v in a[name].items():
            assert np.array_equal(np.asarray(v), np.asarray(b[name][key])), \
                (name, key)
    t = tbench.run(n=4, verbose=False)
    assert set(t.totals) == {"mesh build", "connectivity", "rtree build",
                             "rtree extract", "partition rcb",
                             "partition greedy", "handler (rtree)"}
    assert "handler (rtree)" in t.summary()


def test_timer_scope():
    t = Timer()
    for _ in range(2):
        with t.scope("a", sync=torch.zeros(1)):
            pass
    with t.scope("b", sync=CPU):
        pass
    assert t.counts == {"a": 2, "b": 1}
    assert all(v >= 0 for v in t.totals.values())
