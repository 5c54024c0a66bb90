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


# --- models/profile_sipg.py: K3-K5 per level -----------------------------

from polydeal_tpu_torch.models import profile_sipg as ps  # noqa: E402


def test_sipg_work_counts_bytes_once():
    """The flagship's fine K3 call (p=1, 3D, C=1, q=8, 262144 lanes, f32):
    its points, weights, extents read once and its 16 rows written once;
    K4 writes four blocks."""
    nbytes, flops = ps.sipg_work("volume", 3, 1, 1, 8, 262144, 4)
    assert nbytes == (8 * 3 + 8 + 3 + 16) * 262144 * 4
    # a point: the basis and its gradients (54), w grad phi (12), the 10
    # distinct entries of the symmetric 4 x 4 block at three FMAs each
    assert flops == (54 + 12 + 10 * 6) * 8 * 262144
    fb, ff = ps.sipg_work("face", 3, 1, 1, 4, 262144, 4)
    assert fb == (2 * 4 * 3 + 4 + 1 + 2 * 3 + 4 * 16) * 262144 * 4
    # two sides of 82, the pull-back (12), w gamma and -w / 2 (3), both
    # sides' vectors (32), the 36 distinct entries of the 8 x 8 matrix at
    # two FMAs each
    assert ff == (2 * 82 + 12 + 3 + 32 + 36 * 4) * 4 * 262144
    t_ms, by = ps.bound(nbytes, flops, "float32")
    assert by == "bytes" and t_ms == pytest.approx(nbytes / ps.HBM_BPS * 1e3)


def test_ptxas_summary_names_the_sipg_kernels():
    log = "\n".join([
        "ptxas info    : Function properties for _ZN25_GLOBAL__N__x_7_sipg"
        "_cu_y13blocks_kernelINS_8FaceFormIfLi3ELi1EEEEEvNT_4ArgsEiiliiiPN"
        "S2_1TES6_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 124 registers, 8192 bytes smem",
        "ptxas info    : Function properties for _ZN25_GLOBAL__N__x_7_sipg"
        "_cu_y15partials_kernelINS_10VolumeFormIdLi2ELi3EEEEEvPKNT_1TEilPS4_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N__fa194aa6_9"
        "_banded_cu_7216cc4519banded_fused_kernelIfLi4ELi2EEEvPKT_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers"])
    assert ps.ptxas_summary(log) == [
        "blocks_kernel Face<f, 3, 1>: 124 registers; 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
        "partials_kernel Volume<d, 2, 3>: 32 registers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "banded_fused_kernel<fLi4ELi2E>: 40 registers; 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads"]


def test_level_calls_on_cpu():
    """A small monodomain hierarchy rebuilt as the solver builds it; each
    level's K3-K5 calls (plain versions on the CPU) give their blocks, one
    K4 call per face group, and the tables of each kind's calls."""
    from polydeal_tpu_torch.models.monodomain import bench_config

    hs = ps.mono_handlers(bench_config(2))
    assert [h.n_poly for h in hs] == sorted(h.n_poly for h in hs)
    h = hs[-1]
    t, pc = ps.level_tables(h, torch.float64, torch.device("cpu"))
    calls = ps.kernel_calls(t, pc, h.degree, h.dim)
    nb = h.n_basis
    assert len(calls["face"]) == len(t["groups"])
    assert ps.blocks(calls["volume"][0]()).shape == (nb * nb, h.n_poly)
    assert ps.blocks(calls["face"][0]()).shape == (4, nb * nb, h.n_poly)
    plain = ps.kernel_calls(t, pc, h.degree, h.dim, plain=True)
    assert torch.equal(ps.blocks(plain["boundary"][0]()),
                       ps.blocks(calls["boundary"][0]()))
    groups = ps.table_groups(t)
    assert groups["volume"] == [t["vol"]] and groups["boundary"] == [t["bdry"]]
    assert len(groups["face"]) == len(calls["face"])
