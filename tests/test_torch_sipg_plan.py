"""The launch plan of K3-K5 (``ops/sipg_kernels.sipg_launch_plan``).

The plan decides how the CUDA kernels split a level's work: lanes a block
holds, entry ranks, point ranks G and blocks a lane S (a second pass sums
their partials from a workspace [S, E, P]).  It is pure: what it needs of
a form (distinct entries E, entry ranks, threads a block, element size)
the kernel library reports (``sipg_form``), and here :func:`_form` states
it: E = M (M + 1) / 2 for an M x M form (M = nb, 2 nb for K4), entry ranks
the least power of two that leaves a thread at most 64 f32 registers of
sums, 256 threads a block.  It is checked on the CPU at the (P, C, q) of
every level the flagship and the monodomain assemble at n = 64 (volume
q = 8, face and boundary q = 4 at p = 1; the p = 2 and 3 rules of the same
levels), at p = 1-3 in 2D and 3D, in f32 and f64: the blocks and ranks
cover a lane's C * q points exactly once, no rank is left without points,
the split fits the 256-thread block, and the workspace stays bounded.  On
a card (``-m cuda``; the file imports no JAX, so it runs there with
``--noconftest``) the library's forms are held to :func:`_form`, and K3-K5
to their plain versions where a coarse p = 2 or 3 level's plan splits a
lane's points over point ranks while entry ranks share staged values.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from polydeal_tpu_torch.ops import sipg_kernels as sk  # noqa: E402

# (P, C of the volume, face and boundary groups) of the levels of the
# R-tree hierarchy at n = 64 (lex): the flagship's 512-262144, the
# monodomain's 8-262144
LEVELS = [(262144, 1, 1, 3), (32768, 8, 4, 12), (4096, 64, 16, 48),
          (512, 512, 64, 192), (64, 4096, 256, 768), (8, 32768, 1024, 3072)]
KINDS = {"volume": 1, "face": 2, "boundary": 3}  # index into a LEVELS row
Q_POINTS = {1: (8, 4), 2: (27, 9), 3: (64, 16)}  # (volume, face) q at p
# K5 alone at 2D p = 4, 5: q of a boundary face slot
Q_BOUNDARY_HIGH = {4: 5, 5: 6}
THREADS = 256


# accumulator registers a thread holds (csrc/sipg.cu kMaxAccRegs); K5
# alone at 2D p = 4-5 takes at least HIGH_RANKS_F64 entry ranks in f64
ACC_REGS = 64
HIGH_RANKS_F64 = 8


def _form(kind, nb, dtype, degree=1):
    """The form ``csrc/sipg.cu`` reports for ``kind`` at ``nb`` (and
    ``degree``: K5 alone at 2D p = 4-5 has a split of its own in f64)."""
    M = 2 * nb if kind == "face" else nb
    E = M * (M + 1) // 2
    esz = torch.empty((), dtype=dtype).element_size()
    ranks = 1
    while -(-E // ranks) * esz > ACC_REGS * 4:
        ranks *= 2
    if degree >= 4 and esz == 8:
        ranks = max(ranks, HIGH_RANKS_F64)
    return sk.SipgForm(entries=E, ranks=ranks, threads=THREADS, esz=esz)


def _cases():
    for P, *Cs in LEVELS:
        for kind, k in KINDS.items():
            for degree in (1, 2, 3):
                for dim in (2, 3):
                    for dtype in (torch.float32, torch.float64):
                        q = Q_POINTS[degree][kind != "volume"]
                        yield P, Cs[k - 1], q, degree, dim, dtype, kind
        for degree, q in Q_BOUNDARY_HIGH.items():
            for dtype in (torch.float32, torch.float64):
                yield P, Cs[KINDS["boundary"] - 1], q, degree, 2, dtype, \
                    "boundary"


@pytest.mark.parametrize("P,C,q,degree,dim,dtype,kind", list(_cases()))
def test_plan_covers_points_and_fits_the_block(P, C, q, degree, dim, dtype,
                                               kind):
    nb = math.comb(degree + dim, dim)
    form = _form(kind, nb, dtype, degree)
    pl = sk.sipg_launch_plan(P, C, q, form)
    assert pl.entries == form.entries and pl.ranks == form.ranks
    # the block: lanes x entry ranks x point ranks threads, lanes a power
    # of two, at least a warp's worth unless the entry ranks or the level
    # leave less
    assert pl.lanes * pl.ranks * pl.G == THREADS
    assert pl.lanes & (pl.lanes - 1) == 0
    assert pl.lanes >= min(32, THREADS // pl.ranks,
                           1 << (P - 1).bit_length())
    if pl.lanes < 32 and pl.ranks <= 8:
        assert pl.G * pl.lanes >= 32  # a warp holds one entry rank
    # every point of a lane exactly once, no block row or rank empty
    N = C * q
    assert pl.N == N and 1 <= pl.S <= sk.MAX_S
    seen = []
    for s in range(pl.S):
        for g in range(pl.G):
            pts = pl.points(s, g)
            assert len(pts) >= 1
            seen.extend(pts)
    assert sorted(seen) == list(range(N))
    # the workspace of the second pass: only with S > 1, and bounded
    if pl.S == 1:
        assert pl.workspace is None
    else:
        assert pl.workspace == (pl.S, pl.entries, P)
        assert pl.S * pl.entries * P * form.esz <= sk.WORKSPACE_BYTES
    assert pl.grid == (-(-P // pl.lanes), pl.S)


def test_fine_level_runs_one_thread_a_lane():
    """At the fine level (C = 1) the lanes fill the card: G = S = 1, no
    second pass; K4 at p = 1 holds its 36 entries in one thread."""
    for kind, (C, q) in (("volume", (1, 8)), ("face", (1, 4)),
                         ("boundary", (3, 4))):
        pl = sk.sipg_launch_plan(262144, C, q, _form(kind, 4, torch.float32))
        assert (pl.G, pl.S, pl.ranks, pl.lanes) == (1, 1, 1, 256)
    assert sk.sipg_launch_plan(262144, 1, 4, _form(
        "face", 4, torch.float32)).entries == 36


@pytest.mark.parametrize("P,C", [(8, 32768), (64, 4096), (512, 512)])
def test_coarse_levels_fill_the_card(P, C):
    """Few lanes with long point loops: enough threads get points (two
    256-thread blocks an SM on 132 SMs), each rank at least MIN_POINTS."""
    pl = sk.sipg_launch_plan(P, C, 8, _form("volume", 4, torch.float32))
    assert pl.S > 1 and pl.G > 1
    assert P * pl.ranks * pl.G * pl.S >= sk.TARGET_BLOCKS * THREADS
    # K4 (36 entries) takes blocks rather than point ranks
    face = sk.sipg_launch_plan(P, C // 8, 4, _form("face", 4, torch.float32))
    assert face.S > 1 and (face.G == 1 or P < 32)
    assert min(len(pl.points(s, g)) for s in range(pl.S)
               for g in range(pl.G)) >= sk.MIN_POINTS


@pytest.mark.parametrize("degree,dtype", [(d, t) for d in (4, 5) for t in
                                          (torch.float32, torch.float64)])
def test_high_boundary_split(degree, dtype):
    """K5 alone at 2D p = 4 / 5 (120 / 231 entries) splits into 2 / 4
    entry ranks in f32 (at most 64 registers of accumulators a thread) and
    8 in f64, so its fine level runs 128 / 64 lanes a block in f32 (32 in
    f64), one point rank, one block a lane; one point's staged values of
    the block's lanes, double-buffered, fit STAGE_BYTES."""
    nb = math.comb(degree + 2, 2)
    form = _form("boundary", nb, dtype, degree)
    f64 = dtype == torch.float64
    ranks = HIGH_RANKS_F64 if f64 else {4: 2, 5: 4}[degree]
    assert (form.entries, form.ranks) == ({4: 120, 5: 231}[degree], ranks)
    assert -(-form.entries // form.ranks) * form.esz <= ACC_REGS * 4
    P = {4: 512**2, 5: 256**2}[degree]
    pl = sk.sipg_launch_plan(P, 2, Q_BOUNDARY_HIGH[degree], form)
    assert (pl.lanes, pl.G, pl.S) == (THREADS // form.ranks, 1, 1)
    assert 2 * pl.lanes * 3 * nb * form.esz <= sk.STAGE_BYTES


@pytest.mark.parametrize("kind,dim,degree,dtype,ranks", [
    ("volume", 3, 1, torch.float32, 1), ("face", 3, 1, torch.float32, 1),
    ("volume", 3, 2, torch.float32, 1), ("volume", 3, 2, torch.float64, 2),
    ("face", 3, 2, torch.float32, 4), ("face", 3, 2, torch.float64, 8),
    ("face", 3, 3, torch.float32, 16), ("face", 3, 3, torch.float64, 32),
    ("boundary", 3, 3, torch.float32, 4), ("boundary", 2, 3,
                                           torch.float64, 2)])
def test_low_degree_forms_keep_their_split(kind, dim, degree, dtype, ranks):
    """The p = 1-3 forms keep their split: a cap of 64 registers of
    accumulators a thread."""
    nb = math.comb(degree + dim, dim)
    assert _form(kind, nb, dtype, degree).ranks == ranks


def test_plan_rejects_unknown_kind():
    with pytest.raises(ValueError):
        sk.sipg_form("edge", 3, 1, torch.float32)


@pytest.mark.cuda
def test_cuda_forms_and_staged_point_ranks():
    """On a card: the library's forms are :func:`_form`'s for every kind,
    dtype, dim and degree; and K3-K5 agree with their plain versions
    evaluated in f64 on the same inputs (2e-5 relative in f32, 1e-12 in
    f64), two launches bitwise equal, at 8 lanes of 1024 cells at p = 2 and
    3 (3D), where the plans split a lane's points over point ranks (G > 1)
    and, with several entry ranks, stage the point values in shared
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3-K5 have no CPU mode")
    from polydeal_tpu_torch.models import profile_sipg as ps

    for kind in KINDS:
        for dtype in (torch.float32, torch.float64):
            for dim in (2, 3):
                for degree in (1, 2, 3):
                    nb = math.comb(degree + dim, dim)
                    assert sk.sipg_form(kind, dim, degree, dtype) == _form(
                        kind, nb, dtype)
            # K5 alone at 2D p = 4-5
            for degree in Q_BOUNDARY_HIGH:
                if kind == "boundary":
                    assert sk.sipg_form(kind, 2, degree, dtype) == _form(
                        kind, math.comb(degree + 2, 2), dtype, degree)
                else:
                    with pytest.raises(ValueError):
                        sk.sipg_form(kind, 2, degree, dtype)

    def f64(d):
        return {k: v.double() for k, v in d.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    staged_g = 0
    for name in ("p2 8 lanes", "p3 8 lanes"):
        dim, deg, P, vq, fq, bq, off = ps.SIPG_SHAPES[name]
        pc = 10.0 * (deg + dim) * (deg + 1)
        for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
            (vol, face, bdry), ext, lo = ps.sipg_tables(dev, dtype, dim, P,
                                                        (vq, fq, bq), gen)
            vol = dict(pts=vol["pts_in"], w=vol["w"])
            e64, l64 = ext.double(), lo.double()
            calls = {
                "volume": (lambda: sk.volume_blocks(vol, ext, deg, dim),
                           lambda: sk.volume_blocks_ref(f64(vol), e64, deg,
                                                        dim), vq),
                "face": (lambda: ps.blocks(sk.face_group_blocks(
                             face, ext, lo, off, deg, dim, pc)),
                         lambda: ps.blocks(sk.face_group_blocks_ref(
                             f64(face), e64, l64, off, deg, dim, pc)), fq),
                "boundary": (lambda: sk.boundary_blocks(bdry, ext, deg, dim,
                                                        pc),
                             lambda: sk.boundary_blocks_ref(f64(bdry), e64,
                                                            deg, dim, pc),
                             bq)}
            for kind, (kf, pf, (C, q)) in calls.items():
                pl = sk.sipg_launch_plan(P, C, q,
                                         sk.sipg_form(kind, dim, deg, dtype))
                staged_g += pl.G > 1 and pl.ranks > 1
                got, ref = kf(), pf()
                rel = float((got.double() - ref).abs().max()
                            / ref.abs().max())
                assert rel <= tol, (name, kind, dtype, rel)
                assert torch.equal(got, kf())
    assert staged_g > 0  # the staged path with point ranks ran
