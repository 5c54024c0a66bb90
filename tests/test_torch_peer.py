"""The peer exchanges of a sharded solve (``parallel/peer.PeerGroup``, the
kernels of ``csrc/peer.cu``).

On the CPU:
* the ctypes prototypes ``ops/_build.PEER_ENTRIES`` gives the C entries
  match their declarations in ``csrc/peer.cu``, read as text (the library
  builds only where nvcc is);
* where each segment lands in a slot (``_offsets``: both ring ends to one
  rank at one and two ranks, one each beyond), the slot size rule, the
  element size slots are sized by (``widest``) and the rule for a sharded
  solve as one device program (``programs_ok``);
* at 2 and 4 gloo ranks (one spawn of fresh processes per world size, f64
  and f32; ``models/sharded.peer_case``), every plain version to what a
  rank computes alone from every rank's seeded data, bitwise: the ring
  halo and the rows by delta (the far tails' and the flat system's
  layouts) are the rows ``parallel/sharding.exchange`` carries, the
  all-gather ``all_gather_into_tensor``'s stack, and the rank-ordered
  reduce (a dot and a vector), and each rank's rows of it, the explicit
  sum of the all-gathered partials in rank order; the reduces' bits are
  alike on every rank.

On a card (``-m cuda``; the file imports no JAX, so it runs there with
``--noconftest``): every peer kernel at one rank (a ring to itself)
bitwise against its plain version on the same tensors, f32 and f64, and a
CUDA exchange on a closed group raising; ``LoopProgram.close()`` right
after a launch; a process that exits with live device programs (a loop
program, a CG loop) exits 0.
"""

import ctypes
import os
import re
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polydeal_tpu_torch.models.sharded import spawn  # noqa: E402
from polydeal_tpu_torch.ops import _build  # noqa: E402
from polydeal_tpu_torch.parallel import peer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "polydeal_tpu_torch", "csrc", "peer.cu")

# C parameter and return types of the entries, as ctypes passes them
C_TYPES = {"void*": ctypes.c_void_p, "void**": ctypes.c_void_p,
           "const void*": ctypes.c_void_p,
           "const long long*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int}


def _declarations():
    """{name: ([parameter types], return type)} of the extern "C" entries
    of ``csrc/peer.cu``."""
    with open(SRC) as f:
        text = f.read()
    body = text[text.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(r"^(int) (pd_\w+)\(([^)]*)\)", body,
                                        re.M):
        types_ = []
        for p in params.split(","):
            p = " ".join(p.split())
            if p:
                types_.append(re.sub(r"\s*\w+$", "", p).replace(" *", "*"))
        out[name] = (types_, ret)
    return out


def test_every_peer_entry_has_a_prototype():
    assert set(_declarations()) == set(_build.PEER_ENTRIES)


@pytest.mark.parametrize("name", sorted(_build.PEER_ENTRIES))
def test_peer_prototype_matches_the_source(name):
    params, ret = _declarations()[name]
    args, res = _build.PEER_ENTRIES[name]
    assert [C_TYPES[p] for p in params] == args
    assert C_TYPES[ret] == res


def test_peer_launches_are_counted():
    for key in ("peer_put", "peer_all_gather", "peer_wait", "peer_reduce"):
        assert key in _build.launches


def test_source_limits_match_the_module():
    with open(SRC) as f:
        text = f.read()
    assert f"kMaxRanks = {peer.MAX_RANKS};" in text
    assert f"kMaxSegs = {peer.MAX_RANKS};" in text
    assert f"kDataOff = {peer.DATA_OFF};" in text


@pytest.mark.parametrize("n, want", [(1, [0, 40]), (2, [0, 40]),
                                     (4, [0, 0])])
def test_ring_ends_share_a_slot_where_they_go_to_one_rank(n, want):
    # the ring's two ends, +1 and -1: one rank at one and two ranks
    assert peer._offsets((1, -1), (40, 40), n) == want


def test_rows_by_delta_take_their_own_slots():
    assert peer._offsets((1, 2, 3), (8, 16, 24), 4) == [0, 0, 0]
    assert peer._offsets((0, 0, 0), (8, 16, 24), 1) == [0, 8, 24]


@pytest.mark.parametrize("payloads, want", [((), 256), ((8,), 256),
                                            ((256,), 256), ((257, 3), 512)])
def test_slot_bytes_round_up(payloads, want):
    assert peer.slot_bytes(*payloads) == want


@pytest.mark.parametrize("dtypes, want", [
    ((torch.float32, torch.bfloat16, torch.int64), 4),  # f32, bf16 copies
    ((torch.float64, torch.int32), 8),
    ((torch.bfloat16,), 2)])
def test_slots_sized_from_the_levels_widest_float(dtypes, want):
    # the sharded systems size a slot's elements by this (integer index
    # tables exchange nothing)
    params = {f"t{i}": torch.zeros(3, dtype=d) for i, d in enumerate(dtypes)}
    params["launch_args"] = (1, 2)
    assert peer.widest(params) == want


def _fake(device):
    return types.SimpleNamespace(device=torch.device(device))


@pytest.mark.parametrize("b, n_dev, group, want", [
    ("cuda", 1, None, True),
    ("cuda", 2, None, False),
    ("cuda", 2, "closed", False),
    ("cuda", 2, "open", True),
    ("cpu", 1, None, False),
    ("cpu", 2, "open", False)])
def test_one_device_program_rule(b, n_dev, group, want):
    pg = None if group is None else types.SimpleNamespace(
        open=group == "open", device=torch.device("cuda", 0))
    assert peer.programs_ok(_fake(b), n_dev, pg) is want


def test_cpu_group_runs_the_plain_versions():
    pg = peer.PeerGroup(None, "cpu", 64)
    assert not pg.open and pg.n == 1
    x = torch.arange(12.0).reshape(3, 4)
    lh, rh = pg.ring(x, 1)
    assert torch.equal(lh, x[:, 3:]) and torch.equal(rh, x[:, :1])
    assert torch.equal(pg.reduce(x[0].contiguous()), x[0])
    assert torch.equal(pg.all_gather(x), x[None])
    with pytest.raises(ValueError, match="peer group is on"):
        pg.ring(x.to("meta"), 1)


# ---- gloo ranks --------------------------------------------------------

CASES = (dict(kind="peer", C=4, per=24, T=5, m=7, dtype="float64"),
         dict(kind="peer", C=3, per=16, T=4, m=3, dtype="float32"))
CHECKS = ("ring", "rows_far", "rows_flat", "all_gather", "reduce_dot",
          "reduce_vector", "reduce_scatter")


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"{w}ranks")
def ranks(request):
    """(world size, rank 0's result per case): one spawn of fresh gloo
    processes per world size."""
    return request.param, spawn(request.param, list(CASES), device="cpu",
                                timeout=180.0)


@pytest.mark.parametrize("check", CHECKS)
def test_plain_exchange_is_bitwise_what_each_rank_expects(ranks, check):
    world, results = ranks
    for res in results:
        assert res["n_dev"] == world
        assert [r["ok"][check] for r in res["ranks"]] == [True] * world


def test_plain_reduce_bits_alike_on_every_rank(ranks):
    world, results = ranks
    for res in results:
        sums = [r["sums"] for r in res["ranks"]]
        assert len(sums) == world and all(s == sums[0] for s in sums)


# ---- on a card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the peer kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_peer_kernels_at_one_rank_match_plain(cuda, dtype):
    """Every exchange's kernels at one rank (a ring to itself) against its
    plain version on the same tensors, bitwise; a closed group raises."""
    from polydeal_tpu_torch.models.sharded import peer_case

    res = peer_case(dict(CASES[0], dtype=dtype), cuda, None)
    assert all(res["ranks"][0]["ok"].values()), res
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, 96), generator=gen, dtype=dt, device=cuda)
    idx = torch.randint(0, 96, (17,), generator=gen, device=cuda)
    pg = peer.PeerGroup(None, cuda, 8 * 4 * 96 * 2)
    before = dict(_build.launches)
    pairs = [(pg.ring(x, 9), pg.ring_plain(x, 9)),
             (pg.rows(x.T, [(0, idx), (0, idx[:5])]),
              pg.rows_plain(x.T, [(0, idx), (0, idx[:5])])),
             ([pg.all_gather(x)], [pg.all_gather_plain(x)]),
             ([pg.reduce(x[1].contiguous())], [pg.reduce_plain(x[1])]),
             ([pg.reduce_scatter(x.T.contiguous())],
              [pg.reduce_scatter_plain(x.T.contiguous())])]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    ran = {k: _build.launches[k] - before[k] for k in
           ("peer_put", "peer_all_gather", "peer_wait", "peer_reduce")}
    assert ran == dict(peer_put=4, peer_all_gather=1, peer_wait=3,
                       peer_reduce=2)
    assert pg.error()[0] == 0
    pg.close()
    with pytest.raises(RuntimeError, match="open PeerGroup"):
        pg.ring(x, 9)


def _counter_program(dev, n):
    from polydeal_tpu_torch.solvers import graphs

    pool = torch.cuda.graph_pool_handle()
    c = torch.zeros((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)

    def init(_):
        c.zero_()
        flag.copy_(c < n)

    def body(_):
        c.add_(1)
        flag.copy_(c < n)

    pi = graphs.capture(None, init, device=dev, pool=pool)
    pb = graphs.capture(None, body, device=dev, pool=pool)
    prog = graphs.LoopProgram(
        lambda ch: (ch.child(pi), ch.loop(flag, lambda b: b.child(pb),
                                          tests)), dev)
    return c, prog


@pytest.mark.cuda
def test_cuda_close_right_after_a_launch(cuda):
    c, prog = _counter_program(cuda, 200)
    prog.launch()
    prog.close()  # synchronises first: the loop has run to its end
    assert int(c) == 200 and prog.closed and prog.keep == []
    prog.close()
    with pytest.raises(RuntimeError, match="closed"):
        prog.launch()


EXIT_WITH_LIVE_PROGRAMS = """
import sys, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_torch_peer import _counter_program
from polydeal_tpu_torch.solvers.graphs import CGLoop
dev = torch.device("cuda", 0)
c, prog = _counter_program(dev, 50)
prog.launch()
A = lambda v: 2.0 * v
loop = CGLoop(A, None, torch.ones(64, dtype=torch.float64, device=dev),
              rtol=1e-10, maxiter=10)
b = torch.ones(64, dtype=torch.float64, device=dev)
print(loop.run(loop.start_program(lambda: b)), int(c))
"""


@pytest.mark.cuda
def test_cuda_exit_with_live_programs(cuda):
    """A process that leaves its device programs open exits 0 (the atexit
    hook closes them before CUDA goes)."""
    r = subprocess.run(
        [sys.executable, "-c", EXIT_WITH_LIVE_PROGRAMS.format(
            root=ROOT, tests=os.path.join(ROOT, "tests"))],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["1", "50"]
