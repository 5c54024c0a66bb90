"""The trace arithmetic of ``polydeal_tpu_torch.models.profile_flagship``.

The profile itself needs a card; its busy-time union and its reading of a
profiler trace are checked here on the CPU, and that it refuses to run
without a card.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.models import profile_flagship as pf  # noqa: E402


@pytest.mark.parametrize("intervals, lo, hi, want", [
    ([], 0.0, 10.0, 0.0),
    ([(1.0, 3.0), (5.0, 6.0)], 0.0, 10.0, 3.0),  # disjoint
    ([(1.0, 4.0), (2.0, 3.0), (3.5, 6.0)], 0.0, 10.0, 5.0),  # nested, chained
    ([(4.0, 5.0), (1.0, 2.0), (2.0, 3.0)], 0.0, 10.0, 3.0),  # unsorted, touching
    ([(-2.0, 1.0), (9.0, 12.0), (20.0, 30.0)], 0.0, 10.0, 2.0),  # clipped
])
def test_busy_us_is_the_union_length(intervals, lo, hi, want):
    assert pf.busy_us(intervals, lo, hi) == pytest.approx(want)


def test_trace_reading_on_cpu():
    """The traced range is found once, on the CPU side, and a CPU-only
    trace holds no device intervals."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(pf._LABEL):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = prof.events()
    lo, hi = pf.traced_span(events, pf._LABEL)
    assert hi > lo
    assert pf.device_intervals(events, pf._LABEL) == []
    with pytest.raises(RuntimeError):
        pf.traced_span(events, "no_such_range")


@pytest.mark.parametrize("argv", [[], ["--relabel", "none"],
                                  ["--model", "monodomain"]])
def test_profile_needs_a_card(argv, monkeypatch):
    """No CUDA device: every model's profile exits with a message and
    measures nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        pf.main(argv)


def test_setup_phases_report_first_use_apart(monkeypatch):
    """The flagship's and the monodomain's setup_phases carry the kernel
    library's build or load and CUDA's first use as entries of their own
    (0.0 off CUDA), and a CPU setup never loads the library."""
    from polydeal_tpu_torch.models.flagship import setup_flagship
    from polydeal_tpu_torch.models.monodomain import (MonodomainConfig,
                                                      MonodomainSolver)
    from polydeal_tpu_torch.ops import _build

    def no_load():
        raise AssertionError("a CPU setup loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", no_load)
    cpu = torch.device("cpu")
    fs = setup_flagship(n=4, device=cpu, dtype=torch.float64,
                        precond_dtype=None)
    ms = MonodomainSolver.build(MonodomainConfig(n_refinements=2),
                                device=cpu)
    for phases, clocked in (
            (fs.setup_phases, {"hierarchy", "groups", "assemble0",
                               "mg_setup"}),
            (ms.setup_phases, {"hierarchy", "transfers", "assembly",
                               "mg_setup", "tables"})):
        assert set(phases) == clocked | {"kernel_load", "cuda_init"}
        assert phases["kernel_load"] == phases["cuda_init"] == 0.0
