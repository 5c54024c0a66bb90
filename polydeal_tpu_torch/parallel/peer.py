"""Exchanges between the ranks of a sharded solve by the port's own peer
kernels (``csrc/peer.cu``), each beside its plain version over
``torch.distributed``.

The JAX package's sharded CG is one program whose collectives (``ppermute``,
``psum``, ``all_gather``) run inside its ``lax.while_loop``.  NCCL's
operations across ranks cannot sit in a CUDA graph's WHILE body (their
event nodes and remote-sync kernels fail the instantiation), so on GPUs a
sharded system exchanges through a :class:`PeerGroup`: one device buffer a
rank, made by the kernel library with ``cudaMalloc``, whose IPC handle
every rank opens once at setup; the put kernel writes rows straight into
the peers' buffers over NVLink and publishes an epoch flag, the wait and
reduce kernels spin on the flags on the device (the protocol is in the
source's header).  Every exchange is a kernel node, so a solve on any
number of ranks is one device program (``solvers/graphs.CGLoop``) with one
host read.  NCCL stays for setup (the handles' swap).

The exchanges, each a method that takes CUDA tensors to the kernels and
CPU tensors to its plain version (``*_plain``: the same rows sent and
received by ``parallel/sharding.exchange`` and ``all_gather``, sums of the
gathered partials in rank order by an explicit loop; gloo's CPU ranks run
these, and so do the tests):

* :meth:`PeerGroup.ring`: the T lanes either side of a [C, per] slab from
  the ring neighbours (the banded levels' halo);
* :meth:`PeerGroup.rows`: rows by an index list to the rank ``delta``
  ahead, one list per delta (the far tails, the flat system's halo);
* :meth:`PeerGroup.reduce`: the sum over ranks in rank order 0 .. n-1
  (the dots), the same bits on every rank, run to run;
* :meth:`PeerGroup.reduce_scatter`: each rank's rows of that sum (the flat
  system's restriction);
* :meth:`PeerGroup.all_gather`: every rank's tensor, stacked in rank order
  (the coarse levels, the solution).

Every rank must run the same exchanges of a group in the same order (a
sharded solve is SPMD); a rank that does not makes the others' waits time
out and trap (60 s), failing the run.  A CUDA exchange on a closed group
raises: nothing falls back to NCCL.  :meth:`PeerGroup.close` frees the
buffers, every rank together: its owner (a sharded system's ``close()``)
calls it when done.  A group is freed only that way, never by the garbage
collector (a peer may still hold its mapping, so every rank must free
together); one that is dropped open stays until :func:`close_all`, which
``parallel/sharding.leave_group`` calls.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from polydeal_tpu_torch.ops import _build

__all__ = ["PeerGroup", "slot_bytes", "widest", "close_all",
           "programs_ok", "MAX_RANKS"]

MAX_RANKS = 16  # csrc/peer.cu kMaxRanks (and kMaxSegs)
DATA_OFF = 512  # csrc/peer.cu kDataOff: flags, then the counter, then data
ERR_WORDS = 8
# PeerGroups with buffers, in the order made (alike on every rank), held
# until closed: freeing is collective, so a dropped group waits for
# close_all
_OPEN = []


def slot_bytes(*payloads: int) -> int:
    """A slot (what one rank sends another in one exchange) that holds the
    largest of ``payloads`` bytes, rounded up to 256."""
    return -(-max(max(payloads, default=8), 8) // 256) * 256


def widest(params: dict) -> int:
    """The largest element size of the floating tensors in ``params`` (a
    sharded level's): the widest dtype its exchanged vectors carry."""
    return max(t.element_size() for t in params.values()
               if torch.is_tensor(t) and t.is_floating_point())


def close_all() -> None:
    """Close every open :class:`PeerGroup` (every rank calls it, with the
    same groups open)."""
    for pg in list(_OPEN):
        pg.close()


def programs_ok(b: torch.Tensor, n_dev: int, peer) -> bool:
    """The rule for a sharded solve as one device program: a CUDA vector
    and one rank (no exchange) or an open :class:`PeerGroup` on CUDA."""
    return b.device.type == "cuda" and (
        n_dev == 1 or (peer is not None and peer.open
                       and peer.device.type == "cuda"))


def _check(err: int, what: str) -> None:
    if err == -2:
        raise ValueError(f"{what}: arguments the peer kernels do not take "
                         f"(a payload larger than the group's slot, or a "
                         f"rank out of range)")
    if err != 0:
        msg = _build.load_library().pd_cuda_error_name(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _offsets(deltas, sizes, n: int) -> list:
    """Byte offset of each segment in its destination's slot for the
    sender: segments to one rank (deltas equal mod n) lie one after
    another in the order given.  The receiver of segment t, from the rank
    ``deltas[t]`` behind it, finds it at the same offset (every rank lists
    the same deltas and sizes)."""
    out, used = [], {}
    for d, b in zip(deltas, sizes):
        k = d % n
        out.append(used.get(k, 0))
        used[k] = out[-1] + b
    return out


class PeerGroup:
    """The exchanges of one sharded system over ``group`` (None: one
    rank), on ``device``, with slots of ``slot`` bytes (:func:`slot_bytes`
    of the largest payload one rank sends another in one exchange).  On a
    CUDA device it allocates and swaps the buffers (every rank of the
    group constructs it together); on the CPU it holds nothing and runs
    the plain versions."""

    def __init__(self, group, device, slot: int):
        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.slot = slot_bytes(slot)
        self.open = False
        self._base = self._err = None
        self._opened = []
        if dev.type == "cuda":
            if self.n > MAX_RANKS:
                raise ValueError(f"{self.n} ranks: the peer kernels take at "
                                 f"most {MAX_RANKS}")
            self._open_buffers()

    # ---- buffers -------------------------------------------------------
    @property
    def buffer_bytes(self) -> int:
        """The device buffer's size (flags, counter, two parities of n
        slots)."""
        return DATA_OFF + 2 * self.n * self.slot

    def _open_buffers(self) -> None:
        lib = self._lib = _build.load_library()
        with torch.cuda.device(self.device):
            base, host, dev = (ctypes.c_void_p() for _ in range(3))
            _check(lib.pd_peer_alloc(self.buffer_bytes, ctypes.byref(base)),
                   "allocating the peer buffer")
            self._base = base.value
            _check(lib.pd_peer_host_alloc(8 * ERR_WORDS, ctypes.byref(host),
                                          ctypes.byref(dev)),
                   "allocating the peer error words")
            self._err, self._err_dev = host.value, dev.value
            ptrs = [self._base]
            if self.n > 1:
                nbytes = lib.pd_peer_handle_bytes()
                h = ctypes.create_string_buffer(nbytes)
                _check(lib.pd_peer_handle(ctypes.c_void_p(self._base), h),
                       "getting the peer buffer's IPC handle")
                handles = [None] * self.n
                dist.all_gather_object(handles, h.raw, group=self.group)
                ptrs = []
                for r, raw in enumerate(handles):
                    if r == self.rank:
                        ptrs.append(self._base)
                        continue
                    p = ctypes.c_void_p()
                    _check(lib.pd_peer_open(
                        ctypes.create_string_buffer(raw, nbytes),
                        ctypes.byref(p)), f"opening rank {r}'s peer buffer")
                    self._opened.append(p.value)
                    ptrs.append(p.value)
            self._peers = (ctypes.c_void_p * self.n)(*ptrs)
        self.open = True
        _OPEN.append(self)
        self._barrier()

    def _barrier(self) -> None:
        if self.n > 1:
            kw = ({"device_ids": [self.device.index]}
                  if dist.get_backend(self.group) == "nccl" else {})
            dist.barrier(group=self.group, **kw)

    def error(self) -> list:
        """The error words a wait that timed out left (csrc/peer.cu): [1,
        epoch, rank waited for, its flag, this rank, ...], else zeros."""
        if self._err is None:
            return [0] * ERR_WORDS
        return list((ctypes.c_ulonglong * ERR_WORDS).from_address(self._err))

    def close(self) -> None:
        """Synchronise, barrier, close the opened handles, barrier again,
        free this rank's buffers.  Every rank of the group calls it; a CUDA
        exchange afterwards raises."""
        if not self.open:
            return
        self.open = False
        _OPEN.remove(self)
        lib, errs = self._lib, []
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            self._barrier()
            for p in self._opened:
                errs.append((lib.pd_peer_close(ctypes.c_void_p(p)),
                             "closing a peer's buffer"))
            self._opened = []
            self._barrier()
            errs.append((lib.pd_peer_free(ctypes.c_void_p(self._base)),
                         "freeing the peer buffer"))
            errs.append((lib.pd_peer_host_free(ctypes.c_void_p(self._err)),
                         "freeing the peer error words"))
        self._base = self._err = None
        for err, what in errs:  # every release made, then the first error
            _check(err, what)

    # ---- the kernels ---------------------------------------------------
    def _cuda(self, *ts) -> bool:
        """True for tensors on this group's CUDA device, False for CPU
        tensors (the plain versions); raises for anything else, and for a
        CUDA exchange on a group that is not open."""
        devs = {t.device for t in ts}
        if devs == {torch.device("cpu")}:
            return False
        if devs != {self.device}:
            raise ValueError(f"tensors on {devs}; this peer group is on "
                             f"{self.device}")
        if not self.open:
            raise RuntimeError(
                "an exchange across ranks on CUDA needs an open PeerGroup "
                "(this one is closed): there is no NCCL fallback")
        return True

    def _stream(self):
        return ctypes.c_void_p(_build.stream_handle(self.device))

    def _put(self, segs: list, esize: int) -> None:
        """segs: (src pointer, idx pointer or 0, A, B, sa, sb, destination
        rank, byte offset) each."""
        flat = [int(v) for s in segs for v in s]
        arr = (ctypes.c_longlong * max(len(flat), 1))(*flat)
        _check(self._lib.pd_peer_put(
            self._peers, ctypes.c_void_p(self._base), self.rank, self.n,
            self.slot, esize, arr, len(segs), self._stream()),
            "launching peer_put")
        _build.launches["peer_put"] += 1

    def _wait(self, segs: list) -> None:
        """segs: (source rank, byte offset, destination pointer, bytes)."""
        flat = [int(v) for s in segs for v in s]
        arr = (ctypes.c_longlong * max(len(flat), 1))(*flat)
        _check(self._lib.pd_peer_wait(
            ctypes.c_void_p(self._base), ctypes.c_void_p(self._err_dev),
            self.rank, self.n, self.slot, arr, len(segs), self._stream()),
            "launching peer_wait")
        _build.launches["peer_wait"] += 1

    def _reduce(self, out: torch.Tensor, count: int) -> None:
        code = {torch.float32: 0, torch.float64: 1}.get(out.dtype)
        if code is None:
            raise ValueError(f"peer_reduce sums f32 or f64, not {out.dtype}")
        _check(self._lib.pd_peer_reduce(
            ctypes.c_void_p(self._base), ctypes.c_void_p(self._err_dev),
            self.rank, self.n, self.slot, code,
            ctypes.c_void_p(out.data_ptr()), 0, count, self._stream()),
            "launching peer_reduce")
        _build.launches["peer_reduce"] += 1

    # ---- the exchanges -------------------------------------------------
    def ring(self, x: torch.Tensor, T: int):
        """(lh, rh), [C, T] each, of the slab x [C, per]: the last T lanes
        of the rank before this one and the first T of the rank after it
        (a ring: rank 0's left is rank n-1's end)."""
        if not self._cuda(x):
            return self.ring_plain(x, T)
        lh, rh = x.new_empty((x.shape[0], T)), x.new_empty((x.shape[0], T))
        puts, waits = self._ring_segs(x, T, lh, rh)
        self._put(puts, x.element_size())
        self._wait(waits)
        return lh, rh

    def _ring_segs(self, x, T: int, lh, rh):
        """(put segments, wait segments) of :meth:`ring` into lh, rh."""
        C, per = x.shape
        es, r, n = x.element_size(), self.rank, self.n
        size = C * T * es
        off = _offsets((1, -1), (size, size), n)
        sa, sb = x.stride()
        return ([(x.data_ptr() + (per - T) * sb * es, 0, C, T, sa, sb,
                  (r + 1) % n, off[0]),
                 (x.data_ptr(), 0, C, T, sa, sb, (r - 1) % n, off[1])],
                [((r - 1) % n, off[0], lh.data_ptr(), size),
                 ((r + 1) % n, off[1], rh.data_ptr(), size)])

    def ring_plain(self, x: torch.Tensor, T: int):
        from polydeal_tpu_torch.parallel.sharding import exchange

        per, n, r = x.shape[1], self.n, self.rank
        if n == 1:
            return x[:, per - T:].clone(), x[:, :T].clone()
        lh, rh = x.new_empty((x.shape[0], T)), x.new_empty((x.shape[0], T))
        exchange(self.group, [
            (x[:, per - T:].contiguous(), (r + 1) % n, lh, (r - 1) % n, 0),
            (x[:, :T].contiguous(), (r - 1) % n, rh, (r + 1) % n, 1)])
        return lh, rh

    def rows(self, x: torch.Tensor, sends: list) -> list:
        """For each (delta, idx) of ``sends``: this rank sends x[idx] (x
        [rows, C], any strides; idx int64 of m entries, the same m on every
        rank) to the rank delta ahead and receives the m rows the rank
        delta behind sends it, [m, C]; the received tensors in order."""
        if not self._cuda(x, *(i for _, i in sends)):
            return self.rows_plain(x, sends)
        es, r, n, C = x.element_size(), self.rank, self.n, x.shape[1]
        sizes = [i.numel() * C * es for _, i in sends]
        off = _offsets([d for d, _ in sends], sizes, n)
        sa, sb = x.stride()
        recvs = [x.new_empty((i.numel(), C)) for _, i in sends]
        self._put([(x.data_ptr(), i.data_ptr(), i.numel(), C, sa, sb,
                    (r + d) % n, o)
                   for (d, i), o in zip(sends, off)], es)
        self._wait([((r - d) % n, o, v.data_ptr(), b)
                    for (d, _), o, v, b in zip(sends, off, recvs, sizes)])
        return recvs

    def rows_plain(self, x: torch.Tensor, sends: list) -> list:
        from polydeal_tpu_torch.parallel.sharding import exchange

        n, r = self.n, self.rank
        bufs = [x[i].contiguous() for _, i in sends]
        if n == 1:
            return bufs
        recvs = [torch.empty_like(b) for b in bufs]
        exchange(self.group, [(b, (r + d) % n, v, (r - d) % n, t)
                              for t, ((d, _), b, v) in enumerate(
                                  zip(sends, bufs, recvs))])
        return recvs

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n, *x.shape]: every rank's x (contiguous), in rank order."""
        if not self._cuda(x):
            return self.all_gather_plain(x)
        if not x.is_contiguous():
            raise ValueError("all_gather takes a contiguous tensor")
        out = x.new_empty((self.n,) + tuple(x.shape))
        self._gather_put(x)
        size = x.numel() * x.element_size()
        self._wait([(s, 0, out[s].data_ptr(), size) for s in range(self.n)])
        return out

    def _gather_put(self, x: torch.Tensor) -> None:
        """All-gather's put: x into slot [this rank] of every rank."""
        _check(self._lib.pd_peer_all_gather(
            self._peers, ctypes.c_void_p(self._base), self.rank, self.n,
            self.slot, ctypes.c_void_p(x.data_ptr()),
            x.numel() * x.element_size(), self._stream()),
            "launching peer_all_gather")
        _build.launches["peer_all_gather"] += 1

    def all_gather_plain(self, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return x.unsqueeze(0).clone()
        out = x.new_empty((self.n * x.numel(),))
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(),
                                    group=self.group)
        return out.view((self.n,) + tuple(x.shape))

    def reduce(self, v: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of v (contiguous, f32 or f64), added in rank
        order 0, 1, ..., n-1: the same bits on every rank."""
        if not self._cuda(v):
            return self.reduce_plain(v)
        if not v.is_contiguous():
            raise ValueError("reduce takes a contiguous tensor")
        out = torch.empty_like(v)
        self._put([(v.data_ptr(), 0, 1, v.numel(), 0, 1, s, 0)
                   for s in range(self.n)], v.element_size())
        self._reduce(out, v.numel())
        return out

    def reduce_plain(self, v: torch.Tensor) -> torch.Tensor:
        return self._ordered_sum(self.all_gather_plain(v))

    @staticmethod
    def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p
        return acc

    def reduce_scatter(self, part: torch.Tensor) -> torch.Tensor:
        """This rank's k rows of the rank-ordered sum over ranks of part
        ([n k, ...], contiguous, f32 or f64): rank r sends rank s its rows
        [s k, (s + 1) k)."""
        if not self._cuda(part):
            return self.reduce_scatter_plain(part)
        if not part.is_contiguous() or part.shape[0] % self.n:
            raise ValueError("reduce_scatter takes a contiguous tensor of n "
                             "equal row blocks")
        k = part.shape[0] // self.n
        chunk = part[:k].numel()
        es = part.element_size()
        out = part.new_empty((k,) + tuple(part.shape[1:]))
        self._put([(part.data_ptr() + s * chunk * es, 0, 1, chunk, 0, 1, s,
                    0) for s in range(self.n)], es)
        self._reduce(out, chunk)
        return out

    def reduce_scatter_plain(self, part: torch.Tensor) -> torch.Tensor:
        k = part.shape[0] // self.n
        mine = slice(self.rank * k, (self.rank + 1) * k)
        return self._ordered_sum(self.all_gather_plain(part)[:, mine])
