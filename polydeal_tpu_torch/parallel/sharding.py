"""The flat block-COO sharded solve, its process groups and its static halo
metadata.

Counterpart of ``polydeal_tpu/parallel/sharding.py``.  A JAX device mesh
becomes a ``torch.distributed`` process group, one process (rank) per
shard: :func:`init_group` (the counterpart of ``make_mesh``) starts it with
NCCL on CUDA devices and gloo on the CPU, through a ``FileStore`` (no
network), with a timeout so that a rank that never arrives fails the run
instead of hanging it.  :func:`build_halo_exchange` is a jax-free copy of
the JAX package's host function (``tests/test_torch_sharded.py`` holds it
equal to the original).

:class:`ShardedSystem` is MG-CG over row-sharded block-COO levels, the
general path for any level format (``Multigrid.ells``' bands, packs and
block-ELL levels, read through their ``to_block_matrix``): block rows go in
``n_dev`` contiguous chunks, zero-padded to equal nonzero counts.  Every
rank runs the same eager Python over its own chunk, and the JAX program's
collectives become ``torch.distributed`` calls:

  * halo: one send/receive pair per neighbour distance ``deltas[t]``,
    carrying only the rows the other shard reads (the ``ppermute``s);
  * dot products: ``all_reduce`` (the ``psum``);
  * restriction: a gather over each coarse row's padded children where
    every parent is shard-local (``nested_transfer``), else a deterministic
    segment sum by parent, ``all_reduce`` and the rank's slice;
  * prolongation: the parent gather where nested, else
    ``all_gather_into_tensor`` first;
  * the coarse solve: an identity-padded dense LU, replicated on every
    rank, of the all-gathered coarse rhs.

It runs no kernel, as the JAX one runs none: gathers, einsums and
``utils/segment.SegmentSum``.  On the card its CG runs as captured
programs at world size 1 and on NCCL groups, the collectives inside them,
the counterpart of the JAX package's jitted ``shard_map`` with its
``while_loop``: at world size 1 one device program with the loop a WHILE
node (``solvers/graphs.CGLoop``), on more than one rank the host's loop
over the same programs (``HostFlagCGLoop``: NCCL's operations across
ranks cannot sit in a WHILE body); elsewhere (gloo, the CPU) eagerly, one host read of CG's
condition an iteration, as in ``solvers/cg.py``.
"""

from __future__ import annotations

import datetime
import gc
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from polydeal_tpu_torch.solvers.cg import cg_finish, cg_solve
from polydeal_tpu_torch.solvers.graphs import CGLoop, HostFlagCGLoop
from polydeal_tpu_torch.solvers.lu import lu_solve, pivot_permutation
from polydeal_tpu_torch.solvers.chebyshev import ChebyshevSmoother
from polydeal_tpu_torch.utils.grouping import padded_group_lists
from polydeal_tpu_torch.utils.segment import SegmentSum

__all__ = ["init_group", "leave_group", "build_halo_exchange", "exchange",
           "captures_collectives", "CapturedCG", "ShardedMatrix",
           "shard_block_matrix", "ShardedLevel", "ShardedSystem"]


def init_group(rank: int, world_size: int, *, device, store_path: str,
               timeout: float = 120.0):
    """Join the default process group as ``rank`` of ``world_size``: NCCL
    when ``device`` is a CUDA device (made this process's current device),
    gloo otherwise.  Every rank passes the same ``store_path`` (a file in a
    directory they share; it must not hold an earlier run's store).
    ``timeout`` seconds bound every collective.  Returns the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def leave_group() -> None:
    """Destroy the default process group that :func:`init_group` joined,
    once the captured programs are gone: NCCL's destroy waits for every
    CUDA graph that holds its operations, and a sharded system and its
    captured programs reference each other, so only the cycle collector
    frees them once the caller has dropped the system."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()


def build_halo_exchange(cols: np.ndarray, per: int, n_dev: int):
    """Static halo metadata from the sharded sparsity: which rows each shard
    ships to which neighbour, computed once on the host (the reference's
    ghost machinery, agglomeration_handler.cc:1026-1091, recast as static
    lists; one exchange per neighbour distance at SpMV time).

    cols: [n_dev, nnz_per] global block-column ids per shard.
    Returns (remapped_cols [n_dev, nnz_per], deltas, n_sends, sends):
    shard j sends its local rows ``sends[t][j]`` to shard (j + deltas[t])
    % n_dev, and a shard's remapped cols index [local rows | halo segment 0
    | halo segment 1 | ...]."""
    cols = np.asarray(cols)
    owner = cols // per
    # per-shard sorted unique remote cols, grouped by cyclic distance
    need = []
    deltas = set()
    for d in range(n_dev):
        remote = np.unique(cols[d][owner[d] != d])
        need.append(remote)
        # delta = (needer - owner) mod n_dev, matching the send routing
        # dst = (sender + delta) below
        deltas.update(((d - remote // per) % n_dev).tolist())
    deltas = tuple(sorted(int(x) for x in deltas))
    sends = []
    recv_maps = [{} for _ in range(n_dev)]  # global col -> halo slot
    halo_off = [per] * n_dev
    for delta in deltas:
        lists = []
        for j in range(n_dev):
            dst = (j + delta) % n_dev
            mine = need[dst][need[dst] // per == j]
            lists.append(np.sort(mine) - j * per)
        n_send = max((len(x) for x in lists), default=0)
        n_send = max(n_send, 1)
        send = np.zeros((n_dev, n_send), dtype=np.int32)
        for j in range(n_dev):
            send[j, : len(lists[j])] = lists[j]
            dst = (j + delta) % n_dev
            for pos, lr in enumerate(lists[j]):
                recv_maps[dst][j * per + int(lr)] = halo_off[dst] + pos
        for d in range(n_dev):
            halo_off[d] += n_send
        sends.append(send)
    remap = np.empty_like(cols, dtype=np.int32)
    for d in range(n_dev):
        local = owner[d] == d
        remap[d] = np.where(local, cols[d] - d * per, 0)
        for k in np.where(~local)[0]:
            remap[d, k] = recv_maps[d][int(cols[d, k])]
    return remap, deltas, tuple(s.shape[1] for s in sends), sends


def exchange(group, pairs) -> None:
    """One batch of point-to-point transfers over ``group``: (send tensor,
    destination rank, receive tensor, source rank, tag) each."""
    ops = []
    for send, dst, recv, src, tag in pairs:
        ops.append(dist.P2POp(dist.isend, send, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, recv, src, group, tag))
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def captures_collectives(group, n_dev: int) -> bool:
    """Whether a captured program may hold this group's collectives: one
    rank (none run), or an NCCL group (its kernels go into the graph;
    gloo's run on the host)."""
    return n_dev == 1 or dist.get_backend(group) == "nccl"


def _pad_rows(P_: int, n_dev: int) -> int:
    per = -(-P_ // n_dev)
    return per * n_dev


class CapturedCG:
    """MG-CG of a sharded system, eager or as captured programs: the
    dispatch both sharded systems share.  A subclass gives ``_local(b)``
    (this rank's share of a flat rhs), ``_rhs_like(dtype)`` (a zero vector
    of that share's shape), ``cg_ops``, ``_dot`` (the all-reduced inner
    product), ``_gather``, ``graph_ok`` and an empty ``_run_cache``."""

    def _compiled(self, rtol, maxiter, precondition, dtype):
        """(CGLoop, start program, rhs buffer) of the captured solve for
        ``(rtol, maxiter, precondition)`` and vectors of ``dtype``, made at
        first use: the counterpart of the JAX package's cache of jitted
        ``shard_map`` programs.  CG itself stays full-precision.  At world
        size 1 the loop is a WHILE node on the device (``CGLoop``: one host
        read a solve); on more than one rank NCCL's operations (the halo
        exchange, the all-reduces) cannot sit in a WHILE body, so the
        host runs the loop over the same programs (``HostFlagCGLoop``)."""
        key = (rtol, maxiter, precondition, dtype)
        if key not in self._run_cache:
            like = self._rhs_like(dtype)
            A, M = self.cg_ops(precondition)
            cls = CGLoop if self.n_dev == 1 else HostFlagCGLoop
            loop = cls(A, M, like, rtol=rtol, maxiter=maxiter,
                       dot=self._dot)
            b_in = torch.zeros_like(like)
            self._run_cache[key] = (loop, loop.start_program(lambda: b_in),
                                    b_in)
        return self._run_cache[key]

    def _solve_captured(self, b_loc, rtol, maxiter, precondition):
        """(x_loc, k, |r|, iterations) of the captured solve; the tensors
        new, on the device."""
        if not self.graph_ok(b_loc):
            raise ValueError(
                "captured sharded solves need a CUDA rhs, one rank or an "
                "NCCL group, and a system that graph_ok admits (world size "
                f"{self.n_dev}, {b_loc.device})")
        loop, start, b_in = self._compiled(rtol, maxiter, precondition,
                                           b_loc.dtype)
        b_in.copy_(b_loc)
        n = loop.run(start)
        x, res = cg_finish(loop.state, self._dot)
        return x.clone(), loop.state.k.clone(), res, n

    def _solve_eager(self, b_loc, rtol, maxiter, precondition):
        A, M = self.cg_ops(precondition)
        return cg_solve(A, b_loc, M=M, rtol=rtol, maxiter=maxiter,
                        dot=self._dot)

    def solve_cg_async(self, b, rtol: float = 1e-9, maxiter: int = 100,
                       precondition: bool = True):
        """Like :meth:`solve_cg_local`, but the iterations too as a device
        tensor: (this rank's share of x, k int32, |r|), 0-dim tensors on
        the vectors' device, with no host read of x or |r| (the JAX
        package's timing path).  On the card it runs the captured solve
        (:meth:`_compiled`), one device program whose CG loop runs on the
        device, with one host read (the iterations, for the launch
        counts), at any world size, and raises where ``graph_ok``
        refuses; on
        the CPU it runs the eager loop."""
        b_loc = self._local(b)
        if b_loc.device.type == "cuda":
            return self._solve_captured(b_loc, rtol, maxiter,
                                        precondition)[:3]
        x, k, res = self._solve_eager(b_loc, rtol, maxiter, precondition)
        return x, torch.tensor(k, dtype=torch.int32), res

    def solve_cg_local(self, b, rtol: float = 1e-9, maxiter: int = 100,
                       precondition: bool = True,
                       capture: bool | None = None):
        """Like :meth:`solve_cg` with no gather: (this rank's share of x,
        iterations, |r| as a 0-dim device tensor).  Where ``graph_ok``
        admits the solve it runs captured (:meth:`solve_cg_async`'s path;
        ``capture=False`` runs it eagerly, ``capture=True`` raises where it
        cannot be captured), else the port's ``cg_solve`` on the share with
        the all-reduced dot, its loop condition the one host read an
        iteration."""
        b_loc = self._local(b)
        if capture is None:
            capture = self.graph_ok(b_loc)
        if capture:
            x, _, res, n = self._solve_captured(b_loc, rtol, maxiter,
                                                precondition)
            return x, n, res
        return self._solve_eager(b_loc, rtol, maxiter, precondition)

    def solve_cg(self, b, rtol: float = 1e-9, maxiter: int = 100,
                 precondition: bool = True, capture: bool | None = None):
        """SPMD MG-CG from zero on a flat rhs (as ``_local`` takes it):
        (x flat global on every rank, iterations, residual); captured as
        :meth:`solve_cg_local` says."""
        x_loc, k, res = self.solve_cg_local(b, rtol, maxiter, precondition,
                                            capture)
        return self._gather(x_loc), k, float(res)


@dataclass
class ShardedMatrix:
    """Row-sharded block matrix, flat layout with equal per-shard counts.

    Arrays hold every shard, as the JAX package's global arrays do:
    [n_dev * nnz_per, ...], shard d's slice [d * nnz_per, (d + 1) *
    nnz_per).  ``lrows`` are row ids local to the shard, ``cols`` global
    block column ids; padding entries are zero blocks at local row 0 and a
    shard-local column, so they cause no halo traffic."""

    data: torch.Tensor  # [n_dev * nnz_per, nb, nb]
    lrows: np.ndarray  # [n_dev * nnz_per] int64, host
    cols: np.ndarray  # [n_dev * nnz_per] int64 global, host
    rows_per_shard: int
    n_rows_pad: int
    n_dev: int

    @property
    def n_basis(self) -> int:
        return self.data.shape[-1]

    @property
    def nnz_per(self) -> int:
        return self.data.shape[0] // self.n_dev


def shard_block_matrix(A, n_dev: int) -> ShardedMatrix:
    """Partition the block rows of the BlockMatrix ``A`` into ``n_dev``
    contiguous chunks, zero-padded to equal per-shard nonzero counts (zero
    blocks are harmless in the SpMV)."""
    P_pad = _pad_rows(A.n_block_rows, n_dev)
    per = P_pad // n_dev
    shard_of = np.minimum(A.rows // per, n_dev - 1)
    counts = np.bincount(shard_of, minlength=n_dev)
    nnz_per = int(counts.max()) if counts.size else 1
    src = np.zeros((n_dev, nnz_per), dtype=np.int64)
    live = np.zeros((n_dev, nnz_per), dtype=bool)
    lrows = np.zeros((n_dev, nnz_per), dtype=np.int64)
    cols = np.zeros((n_dev, nnz_per), dtype=np.int64)
    for d in range(n_dev):
        idx = np.where(shard_of == d)[0]
        k = idx.shape[0]
        src[d, :k] = idx
        live[d, :k] = True
        lrows[d, :k] = A.rows[idx] - d * per
        cols[d, :k] = A.cols[idx]
        cols[d, k:] = d * per  # padding: a shard-local column
    dev = A.data.device
    data = A.data[torch.as_tensor(src.reshape(-1), device=dev)]
    data = data.masked_fill(
        ~torch.as_tensor(live.reshape(-1, 1, 1), device=dev), 0)
    return ShardedMatrix(data=data, lrows=lrows.reshape(-1),
                         cols=cols.reshape(-1), rows_per_shard=per,
                         n_rows_pad=P_pad, n_dev=n_dev)


def _pad_vec(x: torch.Tensor, n_rows_pad: int, nb: int) -> torch.Tensor:
    """[n_rows_pad, nb]: the flat vector's blocks, zero rows after them."""
    xb = x.reshape(-1, nb)
    out = xb.new_zeros((n_rows_pad, nb))
    out[:xb.shape[0]] = xb
    return out


@dataclass
class ShardedLevel:
    """Static metadata of one MG level (this rank's tensors live in the
    system's ``params``)."""

    rows_per_shard: int
    n_rows_pad: int
    lo: float
    hi: float
    has_transfer: bool
    # halo exchange structure: shard j sends its rows params["send{t}"] to
    # shard (j + deltas[t]) % n_dev; the receiver's remapped cols index
    # [local rows | halo segment 0 | halo segment 1 | ...]
    deltas: tuple = ()
    n_sends: tuple = ()
    # transfers are shard-nested (the parent of every local fine row lives
    # in the local coarse chunk): restrict/prolong need no communication
    nested_transfer: bool = False


class ShardedSystem(CapturedCG):
    """Sharded multigrid-CG built from a port ``Multigrid``, one rank per
    shard (see the module docstring).

    Usage (every rank)::

        group = init_group(rank, world, device=dev, store_path=path)
        ss = ShardedSystem.from_multigrid(mg, group)
        x, iters, res = ss.solve_cg(b)
    """

    def __init__(self, group, levels, params, coarse_lu, n_true_rows: int,
                 nb: int, chebyshev_degree: int = 3, n_smooth: int = 5):
        self.group = group
        self.n_dev = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.levels = levels  # list[ShardedLevel], coarse -> fine
        self.params = params  # list[dict] of this rank's tensors
        self.coarse_lu = coarse_lu  # (LU, pivots), replicated
        self._coarse_perm = pivot_permutation(coarse_lu)
        # captured solves (_compiled), by (rtol, maxiter, precondition,
        # dtype)
        self._run_cache = {}
        self.n_true_rows = n_true_rows
        self.nb = nb
        self.chebyshev_degree = chebyshev_degree
        self.n_smooth = n_smooth

    # ------------------------------------------------------------------
    @classmethod
    def from_multigrid(cls, mg, group=None) -> "ShardedSystem":
        """This rank's share of ``mg`` (every level, as block-COO) over
        ``group`` (None: one shard).  Every rank passes the same
        multigrid."""
        n_dev = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        levels, params = [], []
        coarse_lu = None
        for li, ell in enumerate(mg.ells):
            A = ell.to_block_matrix()
            nb = A.n_basis
            dev = A.data.device
            SA = shard_block_matrix(A, n_dev)
            per, P_pad = SA.rows_per_shard, SA.n_rows_pad
            diag = A.diagonal().reshape(-1, nb)
            if li == 0:
                # the coarse direct solve, identity-padded, replicated
                full = torch.eye(P_pad * nb, dtype=A.data.dtype, device=dev)
                n0 = A.n_block_rows * nb
                full[:n0, :n0] = A.to_dense()
                coarse_lu = tuple(torch.linalg.lu_factor(full))
            del A
            dinv = diag.new_ones((P_pad, nb))
            dinv[:diag.shape[0]] = 1.0 / diag
            lo, hi = ((0.0, 1.0) if mg.los[li] is None
                      else (float(mg.los[li]), float(mg.his[li])))
            remap, deltas, n_sends, sends = build_halo_exchange(
                SA.cols.reshape(n_dev, -1), per, n_dev)
            levels.append(ShardedLevel(
                rows_per_shard=per, n_rows_pad=P_pad, lo=lo, hi=hi,
                has_transfer=False, deltas=deltas, n_sends=n_sends))
            k = SA.nnz_per
            mine = slice(rank * k, (rank + 1) * k)
            lrows = SA.lrows[mine]
            pl = dict(data=SA.data[mine].clone(),
                      row_sum=SegmentSum(lrows, per, dev),
                      cols=torch.as_tensor(remap[rank].astype(np.int64),
                                           device=dev),
                      dinv=dinv[rank * per:(rank + 1) * per].clone())
            for t, send in enumerate(sends):
                pl[f"send{t}"] = torch.as_tensor(send[rank].astype(np.int64),
                                                 device=dev)
            params.append(pl)
            del SA
        for li, t in enumerate(mg.transfers):
            cls._shard_transfer(t, levels[li], levels[li + 1],
                                params[li + 1], rank)
        # every level smooths as the finest: a per-level schedule collapses
        # to its finest entry (the JAX package's rule for this path)
        deg, ns = mg.chebyshev_degree, mg.n_smooth
        return cls(group, levels, params, coarse_lu,
                   n_true_rows=mg.ells[-1].n_block_rows,
                   nb=mg.ells[-1].n_basis,
                   chebyshev_degree=deg[-1] if isinstance(deg, tuple) else deg,
                   n_smooth=ns[-1] if isinstance(ns, tuple) else ns)

    @staticmethod
    def _shard_transfer(t, coarse: ShardedLevel, lvl: ShardedLevel,
                        pl: dict, rank: int) -> None:
        """This rank's part of the transfer ``t`` into ``lvl`` (the fine
        side): E blocks zero-padded to the padded rows, and the parent
        gather and children lists where the transfer is shard-nested, else
        the parent ids and their segment sum."""
        per_f, per_c = lvl.rows_per_shard, coarse.rows_per_shard
        E = t.E
        nb = E.shape[-1]
        dev = E.device
        mine = slice(rank * per_f, (rank + 1) * per_f)
        Ep = E.new_zeros((lvl.n_rows_pad, nb, nb))
        Ep[:E.shape[0]] = E
        parent = np.asarray(t.parent)
        par = np.zeros(lvl.n_rows_pad, dtype=np.int64)
        par[:parent.shape[0]] = parent
        # padded fine rows carry zero E blocks: they add zeros
        lvl.has_transfer = True
        pl["E"] = Ep[mine].clone()
        r = np.arange(parent.shape[0])
        nested = bool(((parent // per_c) == (r // per_f)).all())
        lvl.nested_transfer = nested
        if nested:
            shard = np.arange(lvl.n_rows_pad) // per_f
            ploc = np.clip(par - shard * per_c, 0, per_c - 1)
            pl["parent_local"] = torch.as_tensor(ploc[mine], device=dev)
            # the children of each local coarse row, as local fine rows
            lab = ploc + shard * per_c
            members, _ = padded_group_lists(lab, coarse.n_rows_pad)
            mask = members >= 0
            local = np.where(
                mask, members - (np.arange(coarse.n_rows_pad)
                                 // per_c)[:, None] * per_f, 0)
            cm = slice(rank * per_c, (rank + 1) * per_c)
            pl["children"] = torch.as_tensor(local[cm], device=dev)
            pl["children_mask"] = torch.as_tensor(mask[cm], dtype=E.dtype,
                                                  device=dev)
        else:
            pl["parent"] = torch.as_tensor(par[mine], device=dev)
            pl["parent_sum"] = SegmentSum(par[mine], coarse.n_rows_pad, dev)

    # ---- per-shard primitives (tensors below are this rank's) ---------
    def _halo_gather(self, lvl: ShardedLevel, pl: dict, x_loc):
        """[per + n_halo, nb]: the local rows, then the halo segments (one
        send/receive pair per neighbour distance, halo rows only)."""
        if not lvl.deltas:
            return x_loc
        n, r = self.n_dev, self.rank
        segs = [x_loc]
        for t, delta in enumerate(lvl.deltas):
            buf = x_loc[pl[f"send{t}"]].contiguous()
            recv = torch.empty_like(buf)
            exchange(self.group, [(buf, (r + delta) % n, recv,
                                   (r - delta) % n, t)])
            segs.append(recv)
        return torch.cat(segs, dim=0)

    def _matvec(self, pl: dict, lvl: ShardedLevel, x_loc):
        xg = self._halo_gather(lvl, pl, x_loc)
        y = torch.einsum("kij,kj->ki", pl["data"], xg[pl["cols"]])
        return pl["row_sum"](y)

    def _dot(self, a, b):
        d = torch.dot(a.reshape(-1), b.reshape(-1))
        if self.n_dev > 1:
            d = d.reshape(1)
            dist.all_reduce(d, op=dist.ReduceOp.SUM, group=self.group)
            d = d[0]
        return d

    def _smooth(self, lvl: ShardedLevel, pl: dict, b_loc, x_loc,
                x_is_zero: bool = False):
        dinv = pl["dinv"]
        sm = ChebyshevSmoother(A=lambda v: self._matvec(pl, lvl, v),
                               Minv=lambda r: dinv * r, lo=lvl.lo,
                               hi=lvl.hi, degree=self.chebyshev_degree)
        for s in range(self.n_smooth):
            x_loc = sm(b_loc, x_loc, x_is_zero=(x_is_zero and s == 0))
        return x_loc

    def _all_gather(self, x_loc):
        if self.n_dev == 1:
            return x_loc
        out = x_loc.new_empty((self.n_dev * x_loc.shape[0],)
                              + tuple(x_loc.shape[1:]))
        dist.all_gather_into_tensor(out, x_loc.contiguous(),
                                    group=self.group)
        return out

    def _restrict(self, pl: dict, fine: ShardedLevel, coarse: ShardedLevel,
                  r_loc):
        contrib = torch.einsum("pij,pi->pj", pl["E"], r_loc)
        if fine.nested_transfer:
            # parents are shard-local: a padded gather over each coarse
            # row's children, no communication
            return torch.einsum("cm,cmj->cj", pl["children_mask"],
                                contrib[pl["children"]])
        part = pl["parent_sum"](contrib)  # [n_rows_pad_c, nb]
        if self.n_dev > 1:
            dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.group)
        per_c = coarse.rows_per_shard
        return part[self.rank * per_c:(self.rank + 1) * per_c]

    def _prolong(self, pl: dict, fine: ShardedLevel, xc_loc):
        if fine.nested_transfer:
            return torch.einsum("pij,pj->pi", pl["E"],
                                xc_loc[pl["parent_local"]])
        xc_full = self._all_gather(xc_loc)
        return torch.einsum("pij,pj->pi", pl["E"], xc_full[pl["parent"]])

    def _coarse_solve(self, b_loc):
        """The replicated LU solve of the all-gathered coarse rhs on the
        kept factors (``solvers/lu``)."""
        b_full = self._all_gather(b_loc)
        x = lu_solve(self.coarse_lu[0], self._coarse_perm,
                     b_full.reshape(-1)).reshape(b_full.shape)
        n = b_loc.shape[0]
        return x[self.rank * n:(self.rank + 1) * n]

    def _v_cycle(self, level: int, b_loc):
        if level == 0:
            return self._coarse_solve(b_loc)
        lvl, pl = self.levels[level], self.params[level]
        x = self._smooth(lvl, pl, b_loc, torch.zeros_like(b_loc),
                         x_is_zero=True)
        r = b_loc - self._matvec(pl, lvl, x)
        rc = self._restrict(pl, lvl, self.levels[level - 1], r)
        x = x + self._prolong(pl, lvl, self._v_cycle(level - 1, rc))
        return self._smooth(lvl, pl, b_loc, x)

    # ------------------------------------------------------------------
    def _local(self, b):
        """This rank's rows [per, nb] of the flat global vector ``b``."""
        fine = self.levels[-1]
        per = fine.rows_per_shard
        return _pad_vec(b, fine.n_rows_pad, self.nb)[
            self.rank * per:(self.rank + 1) * per].contiguous()

    def cg_ops(self, precondition: bool = True):
        """(A, M) of the CG on this rank's rows [per, nb]: the fine SpMV
        and one V-cycle (None without ``precondition``), with
        :meth:`_dot` the all-reduced inner product; the eager and the
        captured solves run these."""
        fine, pl = self.levels[-1], self.params[-1]
        top = len(self.levels) - 1
        M = (lambda r: self._v_cycle(top, r)) if precondition else None
        return (lambda v: self._matvec(pl, fine, v)), M

    def graph_ok(self, b) -> bool:
        """Whether a solve of ``b`` runs as captured programs
        (:meth:`_compiled`): a CUDA vector, at world size 1 or on an NCCL
        group (the programs then hold the halo exchanges, the all-reduced
        dots, the coarse all-gather and the restriction's all-reduce).
        gloo and the CPU keep the eager loop."""
        return (b.device.type == "cuda"
                and captures_collectives(self.group, self.n_dev))

    def _rhs_like(self, dtype):
        """A zero vector of this rank's rows [per, nb] in ``dtype``."""
        return torch.zeros((self.levels[-1].rows_per_shard, self.nb),
                           dtype=dtype, device=self.params[-1]["data"].device)

    def _gather(self, x_loc):
        """The flat global vector [n_dofs] from every rank's rows."""
        return self._all_gather(x_loc).reshape(-1)[:self.n_true_rows
                                                   * self.nb]
