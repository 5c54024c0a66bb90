"""Sharded multigrid-CG over the banded / packed level layout, one process
per shard on ``torch.distributed``.

Counterpart of ``polydeal_tpu/parallel/banded.py`` ``ShardedBandedSystem``:
the JAX version is one ``shard_map`` program over a device mesh; here every
rank of a process group runs the same Python over its own slab, and the
mesh's collectives become ``torch.distributed`` calls (NCCL between GPUs,
gloo between CPU processes; only calls both support).

  * polytope lanes are split into ``n_dev`` contiguous slabs of ``per``
    lanes (lex and STR orderings are spatially coherent, so contiguous is
    local); rank r holds lanes [r per, (r + 1) per) of every sharded
    level's band, transfer blocks and Jacobi diagonal;
  * a shard's SpMV, Chebyshev step and residual read x through
    ``x_ext`` [nb, per + 2T]: its slab with the T lanes on each side that
    its ring neighbours own (one ``batch_isend_irecv`` of both directions
    per product), through the halo kernels (K1 and K2 halo on banded
    levels, K6 and K7 halo on packed ones, ``ops/``);
  * ring wrap-around at the global edges is exact only because a band
    stores zero blocks wherever a column leaves [0, P):
    :meth:`ShardedBandedSystem.from_multigrid` checks this once a level;
  * a packed level whose plan has offsets beyond a shard is repacked with
    a near/far split; the far block-COO tail is split by row owner and
    ships only the lanes each shard needs (one exchange per neighbour
    distance, from ``parallel.sharding.build_halo_exchange``'s lists); the
    tail is plain torch in the vectors' dtype, as in ``BlockPacked``;
  * transfers between sharded levels need no communication (children of
    one parent never straddle a slab);
  * below the sharded levels the V-cycle runs replicated: one
    ``all_gather`` of the coarse rhs, every rank runs the small bottom
    levels (a port ``Multigrid``), then takes its own slice.

At world size 1 every exchange is a plain slice and no collective runs:
the halo wraps onto the shard's own ends, as in the JAX package.  Smoothing
and residuals use the smoother's band copy (bf16 where ``Multigrid`` keeps
one), as the port's ``Multigrid._cycle`` does, so the sharded and
unsharded preconditioners match; CG runs on the full-precision band.

Usage (every rank)::

    group = init_group(rank, world, device=dev, store_path=path)
    ss = ShardedBandedSystem.from_multigrid(mg, group)
    x, iters, res = ss.solve_cg(b)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

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
from polydeal_tpu_torch.parallel.sharding import build_halo_exchange
from polydeal_tpu_torch.solvers.cg import cg_solve
from polydeal_tpu_torch.solvers.chebyshev import ChebyshevSmoother
from polydeal_tpu_torch.solvers.multigrid import Multigrid
from polydeal_tpu_torch.sparse import BlockBanded, BlockPacked

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


class ShardedBandedSystem:
    """SPMD MG-CG over banded/packed levels, one rank per shard (see the
    module docstring)."""

    def __init__(self, group, levels, params, rep_mg, nb, n_true_rows):
        self.group = group
        self.n_dev = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.levels = levels  # list[_SLevel], COARSEST-sharded .. finest
        self.params = params  # list[dict] of this rank's slabs
        self.rep_mg = rep_mg  # Multigrid over the replicated bottom levels
        self.nb = nb
        self.n_true_rows = n_true_rows

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
        if mg.lo_dinvs is not None and any(
                lo.dtype != d.dtype for lo, d in zip(mg.lo_dinvs[1:],
                                                    mg.dinvs_t[1:])):
            raise NotImplementedError(
                "sharded smoothing vectors in another dtype (vector_dtype) "
                "are not ported yet")
        if min_sharded_lanes is None:
            min_sharded_lanes = 4 * n_dev

        # the sharded prefix (finest downward); packs whose plans reach
        # beyond a shard are repacked for the halo on the fly
        ready, sharded = {}, []
        for l in range(mg.n_levels - 1, 0, -1):
            ell = mg.ells[l]
            if not isinstance(ell, (BlockBanded, BlockPacked)):
                break
            P_l = ell.n_block_rows
            if P_l % n_dev != 0 or P_l < min_sharded_lanes:
                break
            per = P_l // n_dev
            ell = ready[l] = _shard_ready(ell, per)
            if _tile_for(ell, per) is None:
                break
            t = mg.transfers[l - 1]
            if t._uniform_C:
                if per % t._uniform_C != 0:
                    break
            elif t.grid_shape is not None:
                # the local fine grid (g0/n, g1, ...) must coarsen in-shard
                if t.grid_shape[0] % (2 * n_dev) != 0:
                    break
            else:
                break  # general transfer: not localizable
            sharded.append(l)
        sharded = sharded[::-1]  # coarsest-sharded .. finest
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
                    cls._build_far(lv, pl_, ell, per, n_dev, rank)
            else:
                lv.offsets = tuple(int(o) for o in ell.offsets)
                pl_["data_i"] = (
                    ell.data_i[:, lanes] if ell.data_i is not None
                    else BlockBanded(ell.data[..., lanes], ell.offsets,
                                     per).with_imajor().data_i
                ).contiguous()
            pl_["dinv"] = mg.dinvs_t[l][:, lanes].contiguous()
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
                   n_true_rows=fine.n_block_rows)

    @staticmethod
    def _build_far(lv: _SLevel, pl_: dict, ell: BlockPacked, per: int,
                   n_dev: int, rank: int):
        """This rank's rows of the far block-COO tail (split by row owner,
        zero-padded to the largest share) and its halo send lists for the
        remote columns; every rank computes every shard's lists, so that
        the exchange pairs up."""
        rows = np.asarray(ell.far_rows)
        cols = np.asarray(ell.far_cols)
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
        dev = ell.data_i.device
        mine = torch.as_tensor(np.where(owner == rank)[0], device=dev)
        fdata = ell.far_data.new_zeros((nnz_per,) + ell.far_data.shape[1:])
        fdata[:mine.numel()] = ell.far_data[mine]
        pl_["fdata"] = fdata
        pl_["flrows"] = torch.as_tensor(flrows[rank], device=dev)
        pl_["fcols"] = torch.as_tensor(remap[rank].astype(np.int64),
                                       device=dev)
        for t, send in enumerate(sends):
            pl_[f"fsend{t}"] = torch.as_tensor(send[rank].astype(np.int64),
                                               device=dev)

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
    def _exchange(self, pairs) -> None:
        """One batch of point-to-point transfers: (send tensor, destination
        rank, receive tensor, source rank, tag) each."""
        ops = []
        for send, dst, recv, src, tag in pairs:
            ops.append(dist.P2POp(dist.isend, send, dst, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, recv, src, self.group, tag))
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    def _halo_x(self, lv: _SLevel, x_loc):
        """x_ext [nb, per + 2T]: the slab with its ring neighbours' T lanes
        on each side."""
        n, T, per = self.n_dev, lv.T, lv.per
        if n == 1 or T == 0:
            # the ring wraps onto the shard's own ends
            lh, rh = x_loc[:, per - T:], x_loc[:, :T]
        else:
            r = self.rank
            lh = x_loc.new_empty((x_loc.shape[0], T))
            rh = x_loc.new_empty((x_loc.shape[0], T))
            self._exchange([
                (x_loc[:, per - T:].contiguous(), (r + 1) % n, lh,
                 (r - 1) % n, 0),
                (x_loc[:, :T].contiguous(), (r - 1) % n, rh, (r + 1) % n,
                 1)])
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
        and a scatter-add by local row, in the vectors' dtype."""
        n, r = self.n_dev, self.rank
        xb = x_loc.T  # [per, nb]
        segs = [xb]
        for t, delta in enumerate(lv.deltas):
            buf = xb[pl_[f"fsend{t}"]].contiguous()
            recv = torch.empty_like(buf)
            self._exchange([(buf, (r + delta) % n, recv, (r - delta) % n,
                             t)])
            segs.append(recv)
        xg = torch.cat(segs, dim=0)
        fdata = pl_["fdata"]
        prod = torch.einsum("kij,kj->ki", fdata.to(x_loc.dtype),
                            xg[pl_["fcols"]])
        yb = x_loc.new_zeros((lv.per, lv.nb))
        return yb.index_add_(0, pl_["flrows"], prod).T

    def _dot(self, a, b):
        d = torch.dot(a.reshape(-1), b.reshape(-1))
        if self.n_dev > 1:
            d = d.reshape(1)
            dist.all_reduce(d, op=dist.ReduceOp.SUM, group=self.group)
            d = d[0]
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
        t = torch.einsum("ijp,ip->jp", pl_["Et"], r_loc)
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
        return torch.einsum("ijp,jp->ip", pl_["Et"], rep)

    def _cycle(self, li: int, b_loc):
        """V-cycle over the sharded levels; li indexes self.levels."""
        lv, pl_ = self.levels[li], self.params[li]
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
                parts = [torch.empty_like(rc_loc) for _ in range(self.n_dev)]
                dist.all_gather(parts, rc_loc, group=self.group)
                rc_full = torch.cat(parts, dim=1)
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
            parts = [torch.empty_like(x_loc) for _ in range(self.n_dev)]
            dist.all_gather(parts, x_loc.contiguous(), group=self.group)
            x_loc = torch.cat(parts, dim=1)
        return x_loc.T.reshape(-1)

    # ------------------------------------------------------------------
    def v_cycle(self, b):
        """One sharded V-cycle (the CG preconditioner) on a flat global
        rhs; returns the flat global result on every rank."""
        b_loc = self._local(b)
        y = self._cycle(len(self.levels) - 1, b_loc)
        return self._gather(y.to(b_loc.dtype))

    def solve_cg(self, b, rtol: float = 1e-9, maxiter: int = 100,
                 precondition: bool = True):
        """SPMD MG-CG from zero on a flat rhs (global, or this rank's local
        part).  Returns (x flat global on every rank, iterations,
        residual)."""
        x_loc, k, res = self.solve_cg_local(b, rtol, maxiter, precondition)
        return self._gather(x_loc), k, float(res)

    def solve_cg_local(self, b, rtol: float = 1e-9, maxiter: int = 100,
                       precondition: bool = True):
        """Like :meth:`solve_cg` with no gather: (this rank's slab of x
        [nb, per], iterations, |r| as a 0-dim device tensor): the port's
        ``cg_solve`` on the slab with the all-reduced dot, its norm test
        the one host synchronisation an iteration."""
        fine, fine_pl = self.levels[-1], self.params[-1]
        top = len(self.levels) - 1
        # CG itself stays full-precision
        M = ((lambda r: self._cycle(top, r).to(r.dtype)) if precondition
             else None)
        return cg_solve(lambda p: self._matvec(fine, fine_pl, p),
                        self._local(b), M=M, rtol=rtol, maxiter=maxiter,
                        dot=self._dot)
