"""Sharded multigrid-CG over the banded / packed level layout, one process
per shard on ``torch.distributed``.

Counterpart of ``polydeal_tpu/parallel/banded.py`` ``ShardedBandedSystem``:
the JAX version is one ``shard_map`` program over a device mesh; here every
rank of a process group runs the same Python over its own slab, and the
mesh's collectives become the exchanges of the system's
``parallel/peer.PeerGroup``: the port's peer kernels between GPUs
(``csrc/peer.cu``), their plain versions over ``torch.distributed``
between gloo's CPU processes.

  * polytope lanes are split into ``n_dev`` contiguous slabs of ``per``
    lanes (lex and STR orderings are spatially coherent, so contiguous is
    local); rank r holds lanes [r per, (r + 1) per) of every sharded
    level's band, transfer blocks and Jacobi diagonal;
  * a shard's SpMV, Chebyshev step and residual read x through
    ``x_ext`` [nb, per + 2T]: its slab with the T lanes on each side that
    its ring neighbours own (one ring exchange of both directions per
    product), through the halo kernels (K1 and K2 halo on banded levels,
    K6 and K7 halo on packed ones, ``ops/``);
  * ring wrap-around at the global edges is exact only because a band
    stores zero blocks wherever a column leaves [0, P):
    :meth:`ShardedBandedSystem.from_multigrid` checks this once a level;
  * a packed level whose plan has offsets beyond a shard is repacked with
    a near/far split; the far block-COO tail is split by row owner and
    ships only the lanes each shard needs (one exchange for every neighbour
    distance, from ``parallel.sharding.build_halo_exchange``'s lists); the
    tail is plain torch in the vectors' dtype, as in ``BlockPacked``;
  * transfers between sharded levels need no communication (children of
    one parent never straddle a slab);
  * the dots are sums over ranks in rank order (the same bits on every
    rank);
  * below the sharded levels the V-cycle runs replicated: one all-gather
    of the coarse rhs, every rank runs the small bottom levels (a port
    ``Multigrid``), then takes its own slice.

At world size 1 every exchange is a plain slice and no collective runs:
the halo wraps onto the shard's own ends, as in the JAX package.  On the
card a solve runs as one device program at every world size (CUDA graphs
with a WHILE node, ``solvers/graphs.CGLoop``, one host read a solve): the
counterpart of the JAX package's jitted ``shard_map`` with its
``while_loop``; across ranks the program holds the peer kernels, and
without an open peer group a CUDA solve over more than one rank raises.
Smoothing and residuals use the smoother's band copy (bf16 where ``Multigrid`` keeps
one) and its vectors' dtype (``lo_vec``: bf16 where ``Multigrid`` was set
up with ``vector_dtype=torch.bfloat16``, so the halo exchanges carry bf16
and K6 halo reads bf16 x_ext), as the port's ``Multigrid._cycle`` does, so
the sharded and unsharded preconditioners match; CG runs on the
full-precision band.

Two setups give the same system.
:meth:`ShardedBandedSystem.from_multigrid` takes a whole ``Multigrid`` that
every rank has built; :meth:`ShardedBandedSystem.setup_local` builds on
each rank only its slabs of the sharded levels (the counterpart of
the JAX package's ``build_multigrid(device_mesh=)``): their tables and
bands one lane slab at a time through K3-K5
(``assembly.sipg.build_banded_groups(lanes=)``), their Jacobi diagonals,
transfer blocks and smoother copies, and their eigenvalue estimates by a
sharded power iteration; no rank holds a tensor of a sharded level with
the level's lane count.  Handlers stay global on the host, and the
replicated bottom is a whole ``Multigrid`` on every rank, as in the JAX
package.  Which levels are sharded is decided by one rule
(:func:`_sharded_prefix`) from host metadata before any assembly.

Usage (every rank)::

    group = init_group(rank, world, device=dev, store_path=path)
    ss = ShardedBandedSystem.from_multigrid(mg, group)
    ss = ShardedBandedSystem.setup_local(handlers, parents, group,
                                         device=dev, grid_shapes=gs)
    x, iters, res = ss.solve_cg(b)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from polydeal_tpu_torch.assembly.sipg import (
    assemble_rhs_direct,
    assemble_sipg_banded_direct,
    banded_pieces,
    build_banded_groups,
    last_setup_stats,
)
from polydeal_tpu_torch.ops.banded import banded_matvec_t_halo, imajor_band
from polydeal_tpu_torch.ops.fused_cheb import (
    banded_cheb_step_t_halo,
    banded_residual_t_halo,
    packed_cheb_step_t_halo,
    packed_residual_t_halo,
)
from polydeal_tpu_torch.ops.packed import (
    build_pack_plan,
    packed_band,
    packed_matvec_t_halo,
)
from polydeal_tpu_torch.parallel.peer import programs_ok, widest
from polydeal_tpu_torch.parallel.sharding import (
    CapturedCG,
    build_halo_exchange,
)
from polydeal_tpu_torch.solvers.chebyshev import ChebyshevSmoother
from polydeal_tpu_torch.solvers.multigrid import (
    Multigrid,
    _schedule,
    band_offsets,
    banded_direct_levels,
    build_embedding,
    level_pack,
    level_transfers,
    promote_to,
    uniform_children,
)
from polydeal_tpu_torch.sparse import (
    BlockBanded,
    BlockPacked,
    far_blocks,
    pack_blocks,
)
from polydeal_tpu_torch.utils.segment import SegmentSum

__all__ = ["ShardedBandedSystem"]


@dataclass
class _SLevel:
    """Static per-level metadata (host side), as the JAX package's."""

    kind: str  # 'packed' | 'banded'
    per: int  # lanes per shard
    T: int  # halo width: the largest |offset| (at least 1 when banded)
    lo: float
    hi: float
    plan: object | None = None  # PackPlan (packed kind)
    offsets: tuple | None = None  # (banded kind)
    nb: int = 0
    # far block-COO tail (packed kind only)
    has_far: bool = False
    deltas: tuple = ()
    n_sends: tuple = ()
    nnz_far_per: int = 0
    # transfer INTO this level from the coarser one (self = fine side)
    uniform_C: int = 0
    grid_shape_loc: tuple | None = None
    has_lo: bool = False  # a low-precision smoother copy is present
    deg: int = 3
    ns: int = 5


def _shard_ready(ell, per: int):
    """A pack whose plan holds offsets beyond a shard (|o| > per) repacked
    with an explicit near/far split (far tail -> block-COO halo exchange);
    anything else as it is."""
    if not isinstance(ell, BlockPacked):
        return ell
    if max(abs(o) for o in ell.plan.offsets) <= per:
        return ell
    if ell.far_data is not None:
        raise ValueError("cannot repack a pack that already has a far tail")
    src, dst = ell.sparsity_pairs()
    plan2, oid2, frows, fcols = build_pack_plan(
        src, dst, ell.n_block_rows, ell.plan.nb, near_limit=per)
    return ell.repack(plan2, torch.as_tensor(oid2, device=ell.oid.device),
                      frows, fcols)


def _tile_for(ell, per: int) -> int | None:
    """The level's halo width T (the JAX package's non-TPU rule: the
    largest |offset|, at least 1 for a band), or None when it exceeds the
    shard.  A pack's plan must already fit (:func:`_shard_ready`)."""
    if isinstance(ell, BlockPacked):
        T = max(abs(o) for o in ell.plan.offsets)
    else:
        T = max(int(np.abs(ell.offsets).max()) if ell.offsets.size else 1, 1)
    return T if T <= per else None


def _check_edge_blocks(ell) -> None:
    """Raise unless every stored block whose column leaves [0, P) is zero:
    the ring-wrapped halo reads the other end of the vector there."""
    P, nb = ell.n_block_rows, ell.n_basis
    if isinstance(ell, BlockPacked):
        plan = ell.plan
        D = ell.data_i.view(nb, plan.R_pad, P)[:, :plan.K * nb].view(
            nb, plan.K, nb, P)
        o = ell.oid.long()
        q = (torch.arange(P, device=o.device)
             + ell.offsets_t.long()[o.clamp(min=0)])
        ks, ps = torch.nonzero((o >= 0) & ((q < 0) | (q >= P)),
                               as_tuple=True)
        bad = int(torch.count_nonzero(D[:, ks, :, ps])) if ks.numel() else 0
    else:
        n_off = len(ell.offsets)
        if ell.data_i is not None:
            R_pad = ell.data_i.shape[0] // nb
            D = ell.data_i.view(nb, R_pad, P)[:, :n_off * nb].view(
                nb, n_off, nb, P)
        else:
            D = ell.data.permute(1, 0, 2, 3)  # [nb, n_off, nb, P]
        counts = []
        for k, off in enumerate(ell.offsets.tolist()):
            m = min(abs(off), P)
            if m:
                lanes = slice(P - m, P) if off > 0 else slice(0, m)
                counts.append(torch.count_nonzero(D[:, k, :, lanes]))
        bad = int(torch.stack(counts).sum()) if counts else 0
    if bad:
        raise ValueError(
            f"level P={P} stores {bad} nonzero entries in blocks whose "
            "column leaves [0, P): the ring halo would read the other end")


def _sharded_prefix(n_lv: int, n_dev: int, min_sharded_lanes: int,
                    lanes_of, tile_of, transfer_of) -> list:
    """The sharded levels, coarsest first: from the finest down while a
    level is banded or packed (``lanes_of(l)`` its lane count, None
    otherwise), its lanes divide into ``n_dev`` slabs of at least
    ``min_sharded_lanes`` / n_dev lanes, its halo width ``tile_of(l,
    per)`` (None when it exceeds the slab) fits, and the transfer into it
    (``transfer_of(l)``: its uniform child count and grid shape) coarsens
    inside a slab.  Level 0 is never sharded."""
    sharded = []
    for l in range(n_lv - 1, 0, -1):
        P_l = lanes_of(l)
        if P_l is None or P_l % n_dev != 0 or P_l < min_sharded_lanes:
            break
        per = P_l // n_dev
        if tile_of(l, per) is None:
            break
        C, grid_shape = transfer_of(l)
        if C:
            if per % C != 0:
                break
        elif grid_shape is not None:
            # the local fine grid (g0/n, g1, ...) must coarsen in-shard
            if grid_shape[0] % (2 * n_dev) != 0:
                break
        else:
            break  # general transfer: not localizable
        sharded.append(l)
    return sharded[::-1]


def _repacked_plan(h, pp, per: int):
    """(plan, oid, far_rows, far_cols) of a packed level for slabs of
    ``per`` lanes: the plan as it is when it reaches no further than a
    slab, else the sparsity repacked with a near/far split at ``per`` (as
    :func:`_shard_ready` repacks a pack), from the face table."""
    if max(abs(o) for o in pp[0].offsets) <= per:
        return pp
    ft = h.faces
    interior = ~ft.is_boundary
    return build_pack_plan(ft.poly_in[interior], ft.poly_out[interior],
                           h.n_poly, h.n_basis, near_limit=per)


class ShardedBandedSystem(CapturedCG):
    """SPMD MG-CG over banded/packed levels, one rank per shard (see the
    module docstring)."""

    def __init__(self, group, levels, params, rep_mg, nb, n_true_rows,
                 lo_vec=None):
        self.group = group
        self.n_dev = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.levels = levels  # list[_SLevel], COARSEST-sharded .. finest
        self.params = params  # list[dict] of this rank's slabs
        self.rep_mg = rep_mg  # Multigrid over the replicated bottom levels
        self.nb = nb
        self.n_true_rows = n_true_rows
        # the V-cycle's vector dtype (None: the operator's): the smoothing
        # vectors, and so the halo exchanges, run in it
        self.lo_vec = lo_vec
        # this rank's part of the fine rhs, and what each sharded level's
        # slab build made, where setup_local built the system
        self.b_local = None
        self.setup_stats = None
        # captured solves (_compiled), by (rtol, maxiter, precondition,
        # dtype)
        self._run_cache = {}
        # the largest payload one rank sends another in one exchange, in
        # the levels' widest dtype (no exchanged vector is wider; a wider
        # one raises): a level's ring halo (both ends, to one rank at two
        # ranks), its far tail's rows, the slab's gathers (the bottom's
        # rhs, the solution)
        es = max(widest(p) for p in params) * nb
        self._peer_group(params[-1]["dinv"].device, max(
            [2 * es * lv.T for lv in levels]
            + [es * max(lv.n_sends, default=1) for lv in levels]
            + [es * lv.per for lv in levels]))

    # ------------------------------------------------------------------
    @classmethod
    def from_multigrid(cls, mg: Multigrid, group=None,
                       min_sharded_lanes: int | None = None
                       ) -> "ShardedBandedSystem":
        """This rank's share of ``mg`` over ``group`` (None: one shard).
        Every rank passes the same multigrid; levels from the finest down
        are sharded while their lanes divide into ``n_dev`` slabs of at
        least ``min_sharded_lanes`` / n_dev lanes (default 4 per rank),
        hold their halo, and coarsen inside a slab."""
        n_dev = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        if min_sharded_lanes is None:
            min_sharded_lanes = 4 * n_dev

        # the sharded prefix (finest downward); packs whose plans reach
        # beyond a shard are repacked for the halo on the fly
        ready = {}

        def lanes_of(l):
            ell = mg.ells[l]
            return (ell.n_block_rows
                    if isinstance(ell, (BlockBanded, BlockPacked)) else None)

        def tile_of(l, per):
            ready[l] = _shard_ready(mg.ells[l], per)
            return _tile_for(ready[l], per)

        def transfer_of(l):
            t = mg.transfers[l - 1]
            return t._uniform_C, t.grid_shape

        sharded = _sharded_prefix(mg.n_levels, n_dev, min_sharded_lanes,
                                  lanes_of, tile_of, transfer_of)
        if not sharded:
            raise ValueError(
                "no level is shardable over this group (need banded/packed "
                "levels with n_dev-divisible lane counts)")
        k0 = sharded[0]  # levels [k0, n_lv) sharded; [0, k0) replicated

        levels, params = [], []
        for l in sharded:
            ell = ready[l]
            _check_edge_blocks(ell)
            per = ell.n_block_rows // n_dev
            lanes = slice(rank * per, (rank + 1) * per)
            t = mg.transfers[l - 1]
            lv = _SLevel(
                kind="packed" if isinstance(ell, BlockPacked) else "banded",
                per=per, T=_tile_for(ell, per),
                lo=float(mg.los[l]), hi=float(mg.his[l]), nb=ell.n_basis,
                uniform_C=t._uniform_C, deg=mg.level_degree(l),
                ns=mg.level_smooth(l))
            pl_ = {"offsets_t": ell.offsets_t}
            if isinstance(ell, BlockPacked):
                lv.plan = ell.plan
                pl_["data_i"] = ell.data_i[:, lanes].contiguous()
                pl_["oid"] = ell.oid[:, lanes].contiguous()
                if ell._has_far():
                    lv.has_far = True
                    cls._build_far(lv, pl_, np.asarray(ell.far_rows),
                                   np.asarray(ell.far_cols),
                                   lambda idx: ell.far_data[torch.as_tensor(
                                       idx, device=ell.far_data.device)],
                                   per, n_dev, rank)
            else:
                lv.offsets = tuple(int(o) for o in ell.offsets)
                pl_["data_i"] = (
                    ell.data_i[:, lanes] if ell.data_i is not None
                    else BlockBanded(ell.data[..., lanes], ell.offsets,
                                     per).with_imajor().data_i
                ).contiguous()
            # the Jacobi diagonal in the sweeps' dtype (lo_dinvs carries it)
            pl_["dinv"] = (mg.dinvs_t if mg.lo_dinvs is None
                           else mg.lo_dinvs)[l][:, lanes].contiguous()
            # the smoother's low-precision band copy, where Multigrid keeps
            # one (a packed level keeps its own band)
            if mg.lo_ells is not None:
                lo_e = mg.lo_ells[l]
                if lo_e.dtype != pl_["data_i"].dtype:
                    pl_["lo_data_i"] = (
                        lo_e.data_i[:, lanes].contiguous()
                        if getattr(lo_e, "data_i", None) is not None
                        else pl_["data_i"].to(lo_e.dtype))
                    lv.has_lo = True
            # transfer into this level, localized to the slab
            if t.grid_shape is not None:
                g = t.grid_shape
                lv.grid_shape_loc = (g[0] // n_dev,) + tuple(g[1:])
                lv.uniform_C = 0
            pl_["Et"] = t._Et[:, :, lanes].contiguous()
            levels.append(lv)
            params.append(pl_)

        # replicated bottom: a Multigrid over levels [0, k0), with the
        # smoother copies, so that it smooths as the unsharded cycle does
        def bottom(v):  # a per-level list or schedule, replicated levels
            return v[:k0] if isinstance(v, (list, tuple)) else v

        rep = Multigrid(
            ells=mg.ells[:k0],
            transfers=mg.transfers[:max(k0 - 1, 0)],
            n_smooth=bottom(mg.n_smooth),
            chebyshev_degree=bottom(mg.chebyshev_degree),
            coarse_lu=mg.coarse_lu,
            dinvs_t=mg.dinvs_t[:k0],
            los=mg.los[:k0],
            his=mg.his[:k0],
            lo_ells=(mg.lo_ells[:k0] if mg.lo_ells is not None else None),
            lo_dinvs=(mg.lo_dinvs[:k0] if mg.lo_dinvs is not None
                      else None),
        )
        fine = mg.ells[-1]
        return cls(group, levels, params, rep, nb=fine.n_basis,
                   n_true_rows=fine.n_block_rows,
                   lo_vec=(mg.lo_dinvs[-1].dtype if mg.lo_dinvs is not None
                           else None))

    @staticmethod
    def _build_far(lv: _SLevel, pl_: dict, rows: np.ndarray, cols: np.ndarray,
                   blocks_of, per: int, n_dev: int, rank: int):
        """This rank's rows of the far block-COO tail (``rows``/``cols``
        global, split by row owner; ``blocks_of(idx)`` gives the blocks of
        the tail entries ``idx``, which are this rank's) and its halo send
        lists for the remote columns; every rank computes every shard's
        lists, so that the exchange pairs up.  The exchange plan pads each
        share to the largest; this rank keeps only its own entries (at
        least one, zero where it has none)."""
        owner = rows // per
        counts = np.bincount(owner, minlength=n_dev)
        nnz_per = max(int(counts.max()), 1)
        flrows = np.zeros((n_dev, nnz_per), dtype=np.int64)
        fcols = np.zeros((n_dev, nnz_per), dtype=np.int64)
        for d in range(n_dev):
            idx = np.where(owner == d)[0]
            k = idx.shape[0]
            flrows[d, :k] = rows[idx] - d * per
            fcols[d, :k] = cols[idx]
            fcols[d, k:] = d * per  # padding: local col, zero data
        remap, deltas, n_sends, sends = build_halo_exchange(fcols, per, n_dev)
        lv.deltas, lv.n_sends = deltas, n_sends
        lv.nnz_far_per = nnz_per
        dev = pl_["data_i"].device
        mine = np.where(owner == rank)[0]
        k = max(mine.size, 1)
        fdata = pl_["data_i"].new_zeros((k, lv.nb, lv.nb))
        if mine.size:
            fdata[:] = blocks_of(mine)
        pl_["fdata"] = fdata
        # the tail's rows repeat (one entry per far offset): a fixed order
        # sum, not index_add_'s atomics, over this rank's entries only
        pl_["frow_sum"] = SegmentSum(flrows[rank, :mine.size], per, dev)
        pl_["fcols"] = torch.as_tensor(remap[rank, :k].astype(np.int64),
                                       device=dev)
        for t, send in enumerate(sends):
            pl_[f"fsend{t}"] = torch.as_tensor(send[rank].astype(np.int64),
                                               device=dev)

    @classmethod
    def setup_local(cls, handlers: list, parents: list, group=None, *,
                    device, grid_shapes: list | None = None,
                    dtype=torch.float64, precond_dtype=None,
                    chebyshev_degree: int | tuple = 3,
                    n_smooth: int | tuple = 5, smoothing_range: float = 20.0,
                    coarse_solver: str = "lu", rhs=None
                    ) -> "ShardedBandedSystem":
        """This rank's share of the system that ``from_multigrid`` makes of
        ``build_multigrid(handlers, parents, A_fine, level_assembly=
        "banded", ...)`` with these arguments (the fine level assembled as
        the coarser ones are), built shard-locally: the sharded levels
        (chosen by the same rule, from the face tables, the pack plans and
        the transfers' shapes) only as this rank's lane slabs -- tables and
        bands through K3-K5 on the lanes the slab needs
        (``build_banded_groups(lanes=)``; each level's ``last_setup_stats``
        kept in ``setup_stats``), packs from the host plan's oid
        columns of the slab, Jacobi diagonals, bf16 band copies where
        ``precond_dtype`` asks for them, transfer blocks of the slab, and
        each level's largest eigenvalue by a sharded power iteration from
        the slice of ``Multigrid.setup``'s start vector.  The levels below
        are a whole ``Multigrid`` on every rank.  ``rhs=(f_fn, g_fn)``
        assembles this rank's part of the fine rhs on its slab tables
        (kept as ``b_local``, flat)."""
        n_dev = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        n_lv = len(handlers)
        deg_s = _schedule(chebyshev_degree, n_lv, "chebyshev_degree")
        ns_s = _schedule(n_smooth, n_lv, "n_smooth")
        offs = [band_offsets(h) for h in handlers]
        # the coarsest level stays banded (its direct solve needs to_dense)
        packs = [None] + [level_pack(h, offs[l])
                          for l, h in enumerate(handlers) if l > 0]
        ready, tiles = {}, {}

        def tile_of(l, per):
            if packs[l] is None:
                T = max(int(np.abs(offs[l]).max()) if offs[l].size else 1,
                        1)
            else:
                ready[l] = _repacked_plan(handlers[l], packs[l], per)
                T = max(abs(o) for o in ready[l][0].offsets)
            tiles[l] = T if T <= per else None
            return tiles[l]

        def transfer_of(l):
            return (uniform_children(parents[l - 1], handlers[l - 1].n_poly),
                    None if grid_shapes is None else grid_shapes[l - 1])

        sharded = _sharded_prefix(n_lv, n_dev, 4 * n_dev,
                                  lambda l: handlers[l].n_poly, tile_of,
                                  transfer_of)
        if not sharded:
            raise ValueError(
                "no level is shardable over this group (need banded/packed "
                "levels with n_dev-divisible lane counts)")
        k0 = sharded[0]

        levels, params, stats, b_local = [], [], [], None
        for l in sharded:
            h = handlers[l]
            per = h.n_poly // n_dev
            lanes = (rank * per, (rank + 1) * per)
            C, gshape = transfer_of(l)
            lv = _SLevel(kind="banded" if packs[l] is None else "packed",
                         per=per, T=tiles[l], lo=0.0, hi=0.0,
                         nb=h.n_basis, uniform_C=C, deg=(
                             deg_s[l] if isinstance(deg_s, tuple)
                             else deg_s),
                         ns=ns_s[l] if isinstance(ns_s, tuple) else ns_s)
            tables = build_banded_groups(h, offs[l], dtype, device=device,
                                         lanes=lanes)
            stats.append(dict(last_setup_stats))
            if rhs is not None and l == n_lv - 1:
                b_local = assemble_rhs_direct(h, tables, *rhs)
            if lv.kind == "banded":
                lv.offsets = tuple(int(o) for o in offs[l])
                band = assemble_sipg_banded_direct(h, tables, offs[l],
                                                   layout="imajor")
                del tables
                pl_ = {"offsets_t": band.offsets_t, "data_i": band.data_i}
                diag_t = band.diagonal_t()
            else:
                pieces = banded_pieces(h, tables, offs[l])
                del tables
                by_off = {int(o): pc for o, pc in zip(offs[l], pieces)}
                plan, oid, frows, fcols = ready[l]
                lv.plan = plan
                oid_loc = torch.as_tensor(
                    np.ascontiguousarray(oid[:, lanes[0]:lanes[1]]),
                    device=device)
                pk = BlockPacked(pack_blocks(by_off.__getitem__, plan,
                                             oid_loc), oid_loc, plan)
                pl_ = {"offsets_t": pk.offsets_t, "data_i": pk.data_i,
                       "oid": pk.oid}
                diag_t = pk.diagonal_t()
                if frows.size:
                    lv.has_far = True
                    cls._build_far(lv, pl_, frows, fcols, lambda idx: (
                        far_blocks(by_off.__getitem__, frows[idx] - lanes[0],
                                   fcols[idx] - lanes[0])),
                        per, n_dev, rank)
                del pieces, by_off
            pl_["dinv"] = 1.0 / diag_t
            if precond_dtype is not None and lv.kind == "banded" and (
                    precond_dtype != pl_["data_i"].dtype):
                pl_["lo_data_i"] = pl_["data_i"].to(precond_dtype)
                lv.has_lo = True
            # the transfer into this level, localized to the slab
            if gshape is not None:
                lv.grid_shape_loc = (gshape[0] // n_dev,) + tuple(gshape[1:])
                lv.uniform_C = 0
            pl_["Et"] = build_embedding(
                handlers[l - 1], h, parents[l - 1], dtype=dtype,
                device=device, lanes=lanes).permute(1, 2, 0).contiguous()
            levels.append(lv)
            params.append(pl_)

        # the replicated bottom, built as build_multigrid builds it
        mats = banded_direct_levels(handlers[:k0], dtype, device=device)
        transfers = level_transfers(
            handlers, parents,
            [build_embedding(handlers[l], handlers[l + 1], parents[l],
                             dtype=dtype, device=device)
             for l in range(k0 - 1)], grid_shapes)

        def bottom(v):
            return v[:k0] if isinstance(v, tuple) else v

        rep = Multigrid.setup(mats, transfers,
                              chebyshev_degree=bottom(deg_s),
                              n_smooth=bottom(ns_s),
                              smoothing_range=smoothing_range,
                              precond_dtype=precond_dtype,
                              coarse_solver=coarse_solver)
        ss = cls(group, levels, params, rep, nb=handlers[-1].n_basis,
                 n_true_rows=handlers[-1].n_poly)
        for li, lv in enumerate(levels):
            lam = ss.lambda_max(li)
            lv.lo, lv.hi = lam / smoothing_range, 1.2 * lam
        ss.b_local, ss.setup_stats = b_local, stats
        return ss

    def lambda_max(self, li: int, iters: int = 25) -> float:
        """The largest eigenvalue of D^-1 A on sharded level ``li`` (an
        index into ``levels``) by the power iteration of
        ``solvers/chebyshev.estimate_lambda_max``: its ``sin`` start vector
        (this rank's slice of it) and iteration count, the products through
        the slab's halo SpMV on the full-precision band, the norms and the
        last dot all-reduced."""
        lv, pl_ = self.levels[li], self.params[li]
        dinv = pl_["dinv"]
        k0 = self.rank * lv.per * lv.nb
        v = torch.sin(torch.arange(k0 + 1, k0 + lv.per * lv.nb + 1,
                                   dtype=dinv.dtype, device=dinv.device))
        v = v.reshape(lv.per, lv.nb).T.contiguous()

        def norm(u):
            return torch.sqrt(self._dot(u, u))

        v = v / norm(v)
        for _ in range(iters):
            w = dinv * self._matvec(lv, pl_, v)
            v = w / norm(w)
        return float(self._dot(v, dinv * self._matvec(lv, pl_, v)))

    # ------------------------------------------------------------------
    def comm_bytes_per_spmv(self, dtype_bytes: int = 4) -> list:
        """Per-level bytes one SpMV sends from each rank: 2 ring sends of T
        halo lanes x nb rows (+ the far block-COO sends where present)."""
        out = []
        for lv in self.levels:
            ring = 2 * lv.T * (lv.nb or self.nb) * dtype_bytes
            far = (sum(lv.n_sends) * (lv.nb or self.nb) * dtype_bytes
                   if lv.has_far else 0)
            out.append(dict(kind=lv.kind, per=lv.per, T=lv.T,
                            ring_bytes=ring, far_bytes=far))
        return out

    # ---- per-shard primitives (tensors below are this rank's slabs) ----
    def _halo_x(self, lv: _SLevel, x_loc):
        """x_ext [nb, per + 2T]: the slab with its ring neighbours' T lanes
        on each side."""
        n, T, per = self.n_dev, lv.T, lv.per
        if n == 1 or T == 0:
            # the ring wraps onto the shard's own ends
            lh, rh = x_loc[:, per - T:], x_loc[:, :T]
        else:
            lh, rh = self.peer.ring(x_loc, T)
        return torch.cat([lh, x_loc, rh], dim=1)

    def _band(self, lv: _SLevel, pl_: dict, key: str, x):
        """The slab's kept kernel launch arguments (``ops/banded
        .KernelBand``) for ``pl_[key]``; None for a CPU vector."""
        if x.device.type == "cpu":
            return None
        kb = pl_.get("kb:" + key)
        if kb is None:
            kb = pl_["kb:" + key] = (
                packed_band(pl_[key], pl_["oid"], pl_["offsets_t"], lv.nb)
                if lv.kind == "packed"
                else imajor_band(pl_[key], pl_["offsets_t"], lv.nb))
        return kb

    def _key(self, lv: _SLevel, lo: bool) -> str:
        return "lo_data_i" if lo and lv.has_lo else "data_i"

    def _matvec(self, lv: _SLevel, pl_, x_loc, lo: bool = False):
        """y = A x on the slab: the near product through K1 or K6 halo,
        plus a pack's far tail."""
        x_ext = self._halo_x(lv, x_loc)
        key = self._key(lv, lo)
        band = self._band(lv, pl_, key, x_ext)
        if lv.kind == "banded":
            return banded_matvec_t_halo(pl_[key], pl_["offsets_t"], lv.nb,
                                        x_ext, tile=lv.T, band=band)
        y = packed_matvec_t_halo(pl_[key], pl_["oid"], pl_["offsets_t"],
                                 lv.nb, x_ext, tile=lv.T, band=band)
        if lv.has_far:
            y = y + self._far_matvec(lv, pl_, x_loc)
        return y

    def _far_matvec(self, lv: _SLevel, pl_, x_loc):
        """The far block-COO tail: ship only the lanes each shard needs
        (one exchange per neighbour distance), then gather, block products
        and a ``SegmentSum`` by local row, in the wider of the band's and
        the vectors' dtypes; the result in the vectors' (a bf16 sweep stays
        bf16)."""
        xb = x_loc.T  # [per, nb]
        recvs = (self.peer.rows(xb, [(d, pl_[f"fsend{t}"])
                                     for t, d in enumerate(lv.deltas)])
                 if lv.deltas else [])
        xg = torch.cat([xb, *recvs], dim=0)
        fdata = pl_["fdata"]
        ct = torch.promote_types(fdata.dtype, x_loc.dtype)
        prod = torch.einsum("kij,kj->ki", fdata.to(ct),
                            xg[pl_["fcols"]].to(ct))
        return pl_["frow_sum"](prod).T.to(x_loc.dtype)

    def _dot(self, a, b):
        d = torch.dot(a.reshape(-1), b.reshape(-1))
        if self.n_dev > 1:
            d = self.peer.reduce(d.reshape(1))[0]
        return d

    @staticmethod
    def _fused_on(b) -> bool:
        return b.dtype in (torch.float32, torch.float64)

    def _fused_step(self, lv: _SLevel, pl_, b_loc, dinv):
        """step_fn(x, d, c1, c2) for ChebyshevSmoother: the halo exchange,
        then one K2 or K7 halo launch (SpMV, Jacobi and the recurrence)."""
        key = self._key(lv, True)
        if lv.kind == "banded":
            def step_fn(x, d, c1, c2):
                x_ext = self._halo_x(lv, x)
                return banded_cheb_step_t_halo(
                    pl_[key], pl_["offsets_t"], lv.nb, x_ext, d, b_loc, dinv,
                    c1, c2, tile=lv.T, band=self._band(lv, pl_, key, x_ext))
        else:
            def step_fn(x, d, c1, c2):
                b_eff = b_loc
                if lv.has_far:
                    # the kernel's product covers the slots only: fold the
                    # far block-COO tail into b
                    b_eff = b_loc - self._far_matvec(lv, pl_, x)
                x_ext = self._halo_x(lv, x)
                return packed_cheb_step_t_halo(
                    pl_[key], pl_["oid"], pl_["offsets_t"], lv.nb, x_ext, d,
                    b_eff, dinv, c1, c2, tile=lv.T,
                    band=self._band(lv, pl_, key, x_ext))
        return step_fn

    def _smooth(self, lv: _SLevel, pl_, b_loc, x_loc, x_is_zero=False):
        dinv = pl_["dinv"]
        if dinv.dtype != b_loc.dtype:
            dinv = dinv.to(b_loc.dtype)  # keep the sweep's dtype
        sm = ChebyshevSmoother(
            A=lambda v: self._matvec(lv, pl_, v, lo=True),
            Minv=lambda r: dinv * r,
            lo=lv.lo, hi=lv.hi, degree=lv.deg,
            step_fn=(self._fused_step(lv, pl_, b_loc, dinv)
                     if self._fused_on(b_loc) else None))
        for s in range(lv.ns):
            x_loc = sm(b_loc, x_loc, x_is_zero=(x_is_zero and s == 0))
        return x_loc

    def _residual_loc(self, lv: _SLevel, pl_, b_loc, x_loc):
        """r = b - A x on the smoother's band, fused (K2 or K7 halo)."""
        if not self._fused_on(b_loc):
            return b_loc - self._matvec(lv, pl_, x_loc, lo=True)
        x_ext = self._halo_x(lv, x_loc)
        key = self._key(lv, True)
        band = self._band(lv, pl_, key, x_ext)
        if lv.kind == "banded":
            return banded_residual_t_halo(pl_[key], pl_["offsets_t"], lv.nb,
                                          x_ext, b_loc, tile=lv.T, band=band)
        r = packed_residual_t_halo(pl_[key], pl_["oid"], pl_["offsets_t"],
                                   lv.nb, x_ext, b_loc, tile=lv.T, band=band)
        if lv.has_far:
            r = r - self._far_matvec(lv, pl_, x_loc)
        return r

    def _restrict_loc(self, lv: _SLevel, pl_, r_loc):
        """Transfer fine -> coarse inside the slab."""
        nb = lv.nb
        t = torch.einsum("ijp,ip->jp", pl_["Et"], promote_to(
            r_loc, pl_["Et"].dtype))
        if lv.grid_shape_loc is not None:
            g = lv.grid_shape_loc
            shape = (nb,) + tuple(v for s in g for v in (s // 2, 2))
            t = t.reshape(shape).sum(dim=tuple(2 + 2 * ax
                                               for ax in range(len(g))))
            return t.reshape(nb, -1)
        C = lv.uniform_C
        return t.reshape(nb, lv.per // C, C).sum(dim=2)

    def _prolong_loc(self, lv: _SLevel, pl_, xc_loc):
        nb = lv.nb
        if lv.grid_shape_loc is not None:
            g = lv.grid_shape_loc
            u = xc_loc.reshape((nb,) + tuple(s // 2 for s in g))
            for ax in range(len(g)):
                u = torch.repeat_interleave(u, 2, dim=1 + ax)
            rep = u.reshape(nb, -1)
        else:
            C = lv.uniform_C
            rep = xc_loc[:, :, None].expand(nb, lv.per // C, C).reshape(nb,
                                                                        -1)
        return torch.einsum("ijp,jp->ip", pl_["Et"], promote_to(
            rep, pl_["Et"].dtype))

    def _cycle(self, li: int, b_loc):
        """V-cycle over the sharded levels; li indexes self.levels."""
        lv, pl_ = self.levels[li], self.params[li]
        if self.lo_vec is not None and b_loc.dtype != self.lo_vec:
            b_loc = b_loc.to(self.lo_vec)
        b_loc = b_loc.contiguous()
        x = torch.zeros_like(b_loc)
        # the pre-smoother starts from zero (A 0 = 0 exactly)
        x = self._smooth(lv, pl_, b_loc, x, x_is_zero=True)
        r = self._residual_loc(lv, pl_, b_loc, x)
        rc_loc = self._restrict_loc(lv, pl_, r).contiguous()
        if li > 0:
            xc = self._cycle(li - 1, rc_loc)
        else:
            # boundary: gather the (small) coarse rhs, run the replicated
            # bottom V-cycle on every rank, keep this rank's slice
            if self.n_dev == 1:
                rc_full = rc_loc
            else:
                # [n_dev, nb, per_c] by rank, then the lanes in rank order
                rc_full = self.peer.all_gather(rc_loc).permute(
                    1, 0, 2).reshape(rc_loc.shape[0], -1)
            xc_full = self.rep_mg._cycle(self.rep_mg.n_levels - 1, rc_full)
            per_c = rc_loc.shape[1]
            xc = xc_full[:, self.rank * per_c:(self.rank + 1) * per_c]
        # the transfer may upcast the correction: back to the sweep's dtype
        x = (x + self._prolong_loc(lv, pl_, xc)).to(b_loc.dtype)
        return self._smooth(lv, pl_, b_loc, x)

    # ---- layout between flat vectors and this rank's slab -------------
    def _local(self, b):
        """This rank's slab [nb, per] of a flat global vector (or of a flat
        local one, [per * nb])."""
        nb, per = self.nb, self.levels[-1].per
        b = b.reshape(-1, nb)
        if b.shape[0] == self.n_true_rows:
            b = b[self.rank * per:(self.rank + 1) * per]
        elif b.shape[0] != per:
            raise ValueError(f"vector of {b.shape[0]} blocks is neither "
                             f"global ({self.n_true_rows}) nor local ({per})")
        return b.T.contiguous()

    def _gather(self, x_loc):
        """The flat global vector from every rank's slab [nb, per]."""
        if self.n_dev > 1:
            x_loc = self.peer.all_gather(x_loc.contiguous()).permute(
                1, 0, 2).reshape(x_loc.shape[0], -1)
        return x_loc.T.reshape(-1)

    # ------------------------------------------------------------------
    def v_cycle(self, b):
        """One sharded V-cycle (the CG preconditioner) on a flat global
        rhs; returns the flat global result on every rank."""
        b_loc = self._local(b)
        y = self._cycle(len(self.levels) - 1, b_loc)
        return self._gather(y.to(b_loc.dtype))

    def cg_ops(self, precondition: bool = True):
        """(A, M) of the CG on this rank's slab [nb, per]: the fine SpMV on
        the full-precision band and one V-cycle (None without
        ``precondition``), its result in the vectors' dtype, with
        :meth:`_dot` the all-reduced inner product; the eager and the
        captured solves run these (CG itself stays full-precision)."""
        fine, fine_pl = self.levels[-1], self.params[-1]
        top = len(self.levels) - 1
        M = ((lambda r: self._cycle(top, r).to(r.dtype)) if precondition
             else None)
        return (lambda p: self._matvec(fine, fine_pl, p)), M

    def graph_ok(self, b) -> bool:
        """Whether a solve of ``b`` runs as one device program
        (:meth:`_compiled`): a CUDA vector, one rank or an open peer group
        (``parallel/peer.programs_ok``: the program then holds the peer
        kernels of the ring halos, the far tails, the dots and the
        bottom's gather), f32 or f64 smoothing vectors and a replicated
        bottom that ``Multigrid.graph_ok`` admits.  gloo and the CPU keep
        the eager loop."""
        return (programs_ok(b, self.n_dev, self.peer)
                and self.lo_vec in (None, torch.float32, torch.float64)
                and self.rep_mg.graph_ok())

    def _rhs_like(self, dtype):
        """A zero vector of this rank's slab [nb, per] in ``dtype``."""
        return torch.zeros((self.nb, self.levels[-1].per), dtype=dtype,
                           device=self.params[-1]["dinv"].device)
