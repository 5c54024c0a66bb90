"""K0's launch plan (``ops/banded.omajor_plan``) and K0 on a card.

K0 and fused K0 (``csrc/banded_omajor.cu``) run one output (i, p) a
thread on a grid of (lane blocks, nb), by the plan ``omajor_plan`` gives
and every launch passes: the path (nb's own build, or the runtime-nb
loop), threads a block and the loads a batch issues together.
Checked here at every shape the main paths give K0 (the coupled models'
1024-lane fine bands, the lex and monodomain levels, the COO 4096-lane
band, the 2D monodomain's and TensorDGQ's levels under 32768 lanes): the
plan is valid, its grid covers nb x P, a few-lane band spreads over the
card, and each nb takes the build it should.  On a card (``-m cuda``; the
file imports no JAX, so it runs there with ``--noconftest``) K0's
product and fused K0's three modes are held to their plain versions at
the coupled and 2D shapes, two launches and the other path bitwise equal,
and the library refuses (-2) the plans it cannot run.
"""

import copy

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.ops import banded as bd  # noqa: E402
from polydeal_tpu_torch.ops import fused_cheb as fc  # noqa: E402

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
# (path, nb, P, band dtype): the shapes the main paths give K0
SHAPES = (
    [("darcy u", 12, 1024, F64), ("darcy pD", 3, 1024, F64),
     ("oseen", 6, 1024, F64), ("lex 4096", 4, 4096, F32),
     ("lex 4096 bf16 copy", 4, 4096, BF16), ("COO 4096", 4, 4096, F64),
     ("monodomain block-Jacobi", 4, 262144, F32)]
    + [("monodomain", 4, P, F32) for P in (64, 512, 4096)]
    + [(f"mono2d p{p}", nb, P, F32) for p, nb in ((4, 15), (5, 21))
       for P in (16, 64, 256, 1024, 4096, 16384)]
    + [(f"dgq {name}", nb, P, dt) for name, nb in (("Q1", 8), ("Q2", 27),
                                                   ("P4", 35))
       for P in (64, 512, 4096) for dt in (F32, BF16)])
SM = 132


def _ids():
    return [f"{s[0]}-{s[2]}-{str(s[3]).split('.')[-1]}" for s in SHAPES]


@pytest.mark.parametrize("path,nb,P,dtype", SHAPES, ids=_ids())
def test_plan_is_valid_and_covers_the_band(path, nb, P, dtype):
    """One output a thread: the build each nb takes, threads and blocks
    covering nb x P and spread over the card, the batch in its budget."""
    pl = bd.omajor_plan(nb, P, dtype)
    # the build: nb's own where it has one (27 and 35 do not) on a band of
    # few outputs, BATCHED; else the runtime-nb LOOP of 128-lane blocks
    few = nb * P < bd.K0_WIDE_OUTPUTS
    assert pl.build == (nb if nb in bd.K0_NB and few else 0)
    assert pl.path == (bd.K0_BATCHED if pl.build else bd.K0_LOOP)
    if not pl.build:
        assert pl.threads == bd.K0_LOOP_THREADS and pl.batch == 1
    # threads: a power of two from a warp to K0_MAX_THREADS
    assert bd.K0_MIN_THREADS <= pl.threads <= bd.K0_MAX_THREADS
    assert pl.threads & (pl.threads - 1) == 0
    # one output a thread: lane blocks x nb cover nb x P, no block empty
    lane_blocks = -(-P // pl.threads)
    assert pl.blocks == lane_blocks * nb
    assert lane_blocks * pl.threads >= P > (lane_blocks - 1) * pl.threads
    # the grid spreads over the card: a BATCHED launch halves its blocks
    # only while short of K0_FILL_BLOCKS, never below a warp
    if pl.build and pl.threads > bd.K0_MIN_THREADS:
        assert -(-P // (pl.threads // 2)) * nb >= bd.K0_FILL_BLOCKS
    if nb * P >= SM * bd.K0_LOOP_THREADS:
        assert pl.blocks >= SM
    # the batch's loaded values fit K0_BATCH_REGS registers
    pair = 4 if dtype == F64 else 2
    if pl.build:
        assert 1 <= pl.batch <= bd.K0_MAX_BATCH
        assert pl.batch == 1 or pl.batch * nb * pair <= bd.K0_BATCH_REGS
    else:
        assert pl.batch == 1


def test_large_levels_take_the_loop():
    """The levels bound by bytes (the 2D monodomain's 16384- and 4096-lane
    nb = 15 levels, its 4096-lane nb = 21 one, the monodomain's fine
    block-Jacobi operator) and nb = 27 take the LOOP; the 1024-lane coupled
    bands and the 4096-lane nb = 4 and 8 levels the BATCHED path."""
    for nb, P in ((15, 16384), (15, 4096), (21, 4096), (4, 262144),
                  (27, 512)):
        assert bd.omajor_plan(nb, P, F32).path == bd.K0_LOOP
    for nb, P in ((6, 1024), (12, 1024), (4, 4096), (8, 4096)):
        pl = bd.omajor_plan(nb, P, F64)
        assert (pl.build, pl.path) == (nb, bd.K0_BATCHED)


def test_coupled_bands_take_all_offsets_in_few_batches():
    """The 1024-lane coupled bands (5 offsets): oseen's nb = 6 and darcy's
    nb = 3 load every offset in one batch, darcy's nb = 12 in three; every
    one spreads over blocks of a warp."""
    for nb, batches in ((6, 1), (3, 1), (12, 3)):
        pl = bd.omajor_plan(nb, 1024, F64)
        assert -(-5 // pl.batch) == batches
        assert pl.threads == 32


def test_omajor_band_keeps_its_plan():
    """The band keeps its plan and passes its path, threads and batch
    after P with every launch."""
    data = torch.zeros(5, 6, 6, 1024, dtype=F64)
    offs = torch.tensor([-32, -1, 0, 1, 32], dtype=torch.int32)
    kb = bd.omajor_band(data, offs)
    pl = bd.omajor_plan(6, 1024, F64)
    assert kb.plan == pl
    assert kb.args[1:] == (5, 6, 1024, pl.path, pl.threads, pl.batch)
    with pytest.raises(ValueError):
        bd.omajor_plan(0, 1024, F64)


# ---- on a card ----------------------------------------------------------

# (nb, P, offsets, band dtype): the coupled bands, 2D monodomain levels
# (8192 lanes at nb = 15: the wide build) and TensorDGQ's
CUDA_CASES = [(6, 1024, (-32, -1, 0, 1, 32), F64),
              (12, 1024, (-32, -1, 0, 1, 32), F64),
              (3, 1024, (-32, -1, 0, 1, 32), F64),
              (15, 4096, (-64, -1, 0, 1, 64), F32),
              (15, 8192, (-128, -1, 0, 1, 128), F32),
              (21, 1024, (-32, -1, 0, 1, 32), F32),
              (27, 512, (-64, -8, -1, 0, 1, 8, 64), BF16),
              (4, 4096, (-256, -16, -1, 0, 1, 16, 256), BF16)]


def _cuda_band(nb, P, offsets, dtype, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randn(len(offsets), nb, nb, P, generator=gen, device=dev,
                       dtype=torch.float64)
    p = torch.arange(P, device=dev)
    for k, o in enumerate(offsets):  # zero where the column leaves [0, P)
        data[k, :, :, ((p + o) < 0) | ((p + o) >= P)] = 0.0
    vdt = F64 if dtype == F64 else F32
    x, b, d = (torch.randn(nb, P, generator=gen, device=dev, dtype=vdt)
               for _ in range(3))
    dinv = 1.0 + torch.rand(nb, P, generator=gen, device=dev, dtype=vdt)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    return data.to(dtype), offs, (x, b, d, dinv)


def _with_plan(kb, plan):
    """``kb`` launched by ``plan`` in place of its own."""
    other = copy.copy(kb)
    other.args = (*kb.args[:4], plan.path, plan.threads, plan.batch)
    other.plan = plan
    return other


def _other_path(kb, dtype):
    """The plan of the other path at kb's nb, where the library has one:
    the LOOP for a BATCHED band; BATCHED (the build's batch, 128 threads)
    for a LOOP band at an nb in K0_NB."""
    pl = kb.plan
    if pl.path == bd.K0_BATCHED:
        return pl._replace(build=0, path=bd.K0_LOOP,
                           threads=bd.K0_LOOP_THREADS, batch=1)
    if kb.nb not in bd.K0_NB:
        return None
    return bd.omajor_plan(kb.nb, 1, dtype)._replace(
        threads=bd.K0_MAX_THREADS, blocks=pl.blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,P,offsets,dtype", CUDA_CASES)
def test_cuda_k0_matches_plain_and_repeats(nb, P, offsets, dtype):
    """K0's product and fused K0's step0, step and residual against their
    plain versions (1e-5 relative to the largest entry for bf16 and f32
    bands, 1e-12 for f64), two launches bitwise equal, and equal bits by
    the other path (each sums o, then j, in the same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K0 has no CPU mode")
    data, offs, (x, b, d, dinv) = _cuda_band(nb, P, offsets, dtype, 3)
    kb = bd.omajor_band(data, offs)
    other = _other_path(kb, dtype)
    tol = 1e-12 if dtype == F64 else 1e-5
    calls = [
        (lambda k: bd.banded_matvec_t_omajor(data, offs, x, band=k),
         lambda: bd.banded_matvec_t_omajor_ref(data, offs, x)),
        (lambda k: fc.banded_cheb_step_t_omajor(data, offs, x, None, b, dinv,
                                                0.37, 1.21, band=k),
         lambda: fc.banded_cheb_step_t_omajor_ref(data, offs, x, None, b,
                                                  dinv, 0.37, 1.21)),
        (lambda k: fc.banded_cheb_step_t_omajor(data, offs, x, d, b, dinv,
                                                0.37, 1.21, band=k),
         lambda: fc.banded_cheb_step_t_omajor_ref(data, offs, x, d, b, dinv,
                                                  0.37, 1.21)),
        (lambda k: fc.banded_residual_t_omajor(data, offs, x, b, band=k),
         lambda: fc.banded_residual_t_omajor_ref(data, offs, x, b))]
    tup = lambda r: r if isinstance(r, tuple) else (r,)
    for kf, pf in calls:
        got, again, ref = tup(kf(kb)), tup(kf(kb)), tup(pf())
        by_other = got if other is None else tup(kf(_with_plan(kb, other)))
        torch.cuda.synchronize()
        for g, a, o, r in zip(got, again, by_other, ref):
            assert torch.equal(g, a) and torch.equal(g, o)
            assert float((g - r).abs().max()) <= tol * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nb,P,offsets,dtype", CUDA_CASES)
def test_cuda_refuses_plans_it_cannot_run(nb, P, offsets, dtype):
    """The library returns -2, and launches nothing, for a batch other
    than the path's, threads not a power of two in [32, 128], and BATCHED
    at an nb without its build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K0 has no CPU mode")
    data, offs, (x, *_) = _cuda_band(nb, P, offsets, dtype, 3)
    kb = bd.omajor_band(data, offs)
    bad = [kb.plan._replace(batch=kb.plan.batch + 1),
           kb.plan._replace(threads=48), kb.plan._replace(threads=256),
           kb.plan._replace(threads=16)]
    if nb not in bd.K0_NB:
        bad.append(kb.plan._replace(path=bd.K0_BATCHED))
    before = bd._build.launches["banded_matvec_omajor"]
    for plan in bad:
        with pytest.raises(RuntimeError, match=r": -2$"):
            bd.launch_product(_with_plan(kb, plan), x)
    assert bd._build.launches["banded_matvec_omajor"] == before
