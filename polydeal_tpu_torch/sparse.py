"""Block-sparse matrices with dense n_b x n_b blocks, on torch tensors.

Counterpart of ``polydeal_tpu/sparse.py``: the general block-COO
``BlockMatrix`` (what the table assembly builds) and its block-ELL form
``BlockELL``, and the solver layouts ``BlockBanded`` and ``BlockPacked``.
Block indices stay host numpy arrays (they shape the program); the blocks
are a tensor on the device.  ``BlockMatrix``'s reductions (merging
duplicate blocks, the SpMV's sum by row) go through
``utils/segment.SegmentSum``: one fixed order on a device, no atomics.

In the banded layouts the polytope
axis P is last, every column access is a shift by a band offset, and the
zero blocks stored at rows lacking an offset annihilate what falls outside
the matrix.  Offsets stay a host numpy array (they shape the program), with
an int32 device copy for the kernels.

SpMV dispatch: a band with the i-major copy ``data_i`` multiplies through
K1 (``ops/banded.py``) and smooths through K2 (``ops/fused_cheb.py``), a
band without it through K0 over the o-major ``data`` and fused K0 (where
the JAX package leaves the product and the update to XLA); each launches
its CUDA kernel on a CUDA tensor and runs its plain version on a CPU
tensor.  A ``BlockPacked`` (the per-lane K-slot format of
``ops/packed.py``, for wide offset sets) multiplies through K6 and smooths
through K7.  Each keeps its validated launch arguments
(``ops/banded.KernelBand``) from its first launch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from polydeal_tpu_torch.ops.banded import (
    KernelBand,
    banded_matvec_t_imajor,
    banded_matvec_t_omajor,
    imajor_band,
    omajor_band,
)
from polydeal_tpu_torch.ops.fused_cheb import (
    banded_cheb_step_t,
    banded_cheb_step_t_omajor,
    banded_residual_t,
    banded_residual_t_omajor,
    packed_cheb_step_t,
    packed_residual_t,
)
from polydeal_tpu_torch.ops.packed import (
    PackPlan,
    packed_band,
    packed_matvec_t,
)

from polydeal_tpu_torch.utils.segment import SegmentSum

__all__ = ["BlockMatrix", "BlockELL", "BlockBanded", "BlockPacked",
           "far_blocks", "pack_blocks"]


@dataclass
class BlockMatrix:
    """Sorted block-COO matrix: data[k] sits at block (rows[k], cols[k])."""

    data: torch.Tensor  # [nnz, nb_r, nb_c]
    rows: np.ndarray  # [nnz] int64, host
    cols: np.ndarray  # [nnz] int64, host
    n_block_rows: int
    n_block_cols: int
    _row_sum: SegmentSum | None = field(init=False, repr=False,
                                        default=None, compare=False)

    @property
    def n_basis(self) -> int:
        return self.data.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_block_rows * self.data.shape[1],
                self.n_block_cols * self.data.shape[2])

    @classmethod
    def from_blocks(cls, rows, cols, data, n_block_rows, n_block_cols=None):
        """Build from possibly duplicated block entries: duplicates are
        merged (a deterministic segment sum) and the blocks sorted by
        (row, col) on the host."""
        if n_block_cols is None:
            n_block_cols = n_block_rows
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        key = rows * n_block_cols + cols
        uniq, inv = np.unique(key, return_inverse=True)
        merged = SegmentSum(inv.reshape(-1), uniq.shape[0], data.device)(data)
        return cls(data=merged, rows=(uniq // n_block_cols).astype(np.int64),
                   cols=(uniq % n_block_cols).astype(np.int64),
                   n_block_rows=n_block_rows, n_block_cols=n_block_cols)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with x flat [n_cols] or blocked [n_block_cols, nb]:
        gather, block products, a deterministic sum by row."""
        nb_c = self.data.shape[2]
        xb = x.reshape(self.n_block_cols, nb_c)
        if self._row_sum is None:
            self._row_sum = SegmentSum(self.rows, self.n_block_rows,
                                       self.data.device)
            self._cols_t = torch.as_tensor(self.cols, device=self.data.device)
        prod = torch.einsum("kij,kj->ki", self.data, xb[self._cols_t])
        yb = self._row_sum(prod)
        return yb.reshape(-1) if x.dim() == 1 else yb

    def __matmul__(self, x):
        return self.matvec(x)

    def diag_blocks(self) -> torch.Tensor:
        """[n_block_rows, nb, nb] diagonal blocks (zero if absent)."""
        idx = np.where(self.rows == self.cols)[0]
        out = self.data.new_zeros((self.n_block_rows,)
                                  + tuple(self.data.shape[1:]))
        dev = self.data.device
        out[torch.as_tensor(self.rows[idx], device=dev)] = self.data[
            torch.as_tensor(idx, device=dev)]
        return out

    def diagonal(self) -> torch.Tensor:
        """Flat main diagonal [n_rows]."""
        return torch.diagonal(self.diag_blocks(), dim1=1, dim2=2).reshape(-1)

    def to_dense(self) -> torch.Tensor:
        nb_r, nb_c = self.data.shape[1], self.data.shape[2]
        out = self.data.new_zeros((self.n_block_rows, self.n_block_cols,
                                   nb_r, nb_c))
        dev = self.data.device
        out.index_put_((torch.as_tensor(self.rows, device=dev),
                        torch.as_tensor(self.cols, device=dev)), self.data,
                       accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(self.n_block_rows * nb_r,
                                               self.n_block_cols * nb_c)

    def transpose(self) -> "BlockMatrix":
        order = np.lexsort((self.rows, self.cols))
        return BlockMatrix(
            data=self.data[torch.as_tensor(order, device=self.data.device)]
            .transpose(1, 2).contiguous(),
            rows=self.cols[order], cols=self.rows[order],
            n_block_rows=self.n_block_cols, n_block_cols=self.n_block_rows)

    @property
    def T(self) -> "BlockMatrix":
        return self.transpose()

    def scale(self, alpha) -> "BlockMatrix":
        return BlockMatrix(self.data * alpha, self.rows, self.cols,
                           self.n_block_rows, self.n_block_cols)

    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        """Structural sum (merges the sparsity patterns)."""
        if (self.n_block_rows, self.n_block_cols) != (other.n_block_rows,
                                                      other.n_block_cols):
            raise ValueError("block shapes differ")
        return BlockMatrix.from_blocks(
            np.concatenate([self.rows, other.rows]),
            np.concatenate([self.cols, other.cols]),
            torch.cat([self.data, other.data], dim=0),
            self.n_block_rows, self.n_block_cols)

    def banded_offsets(self) -> np.ndarray:
        return np.unique(self.cols - self.rows)

    def to_banded(self, max_offsets: int = 96) -> "BlockBanded | None":
        """The banded layout, scattered on the host; None when the matrix
        has more than ``max_offsets`` distinct column offsets (the caller
        falls back to :meth:`to_ell`)."""
        off = self.cols - self.rows
        uniq = np.unique(off)
        if uniq.shape[0] > max_offsets:
            return None
        nb = self.data.shape[-1]
        P = self.n_block_rows
        oidx = np.searchsorted(uniq, off)
        host = self.data.cpu().numpy()
        data = np.zeros((uniq.shape[0], nb, nb, P), dtype=host.dtype)
        data[oidx, :, :, self.rows] = host
        return BlockBanded(data=torch.as_tensor(data, device=self.data.device),
                           offsets=uniq.astype(np.int64),
                           n_block_cols=self.n_block_cols)

    def to_banded_device(self, max_offsets: int = 96) -> "BlockBanded | None":
        """The banded layout by one gather on the device through a static
        map (no host round trip, no scatter): banded[o, :, :, p] =
        data[src[o, p]] where offset o has a block at row p, else zero.
        None beyond ``max_offsets`` offsets, as :meth:`to_banded`."""
        off = self.cols - self.rows
        uniq = np.unique(off)
        if uniq.shape[0] > max_offsets:
            return None
        nb_r, nb_c = self.data.shape[1], self.data.shape[2]
        P = self.n_block_rows
        n_off = uniq.shape[0]
        oidx = np.searchsorted(uniq, off)
        src = np.zeros((n_off, P), dtype=np.int64)
        live = np.zeros((n_off, P), dtype=bool)
        src[oidx, self.rows] = np.arange(self.rows.shape[0])
        live[oidx, self.rows] = True
        dev = self.data.device
        g = self.data[torch.as_tensor(src.reshape(-1), device=dev)]
        g = g.masked_fill(~torch.as_tensor(live.reshape(-1, 1, 1),
                                           device=dev), 0)
        data = g.reshape(n_off, P, nb_r, nb_c).permute(0, 2, 3, 1).contiguous()
        return BlockBanded(data=data, offsets=uniq.astype(np.int64),
                           n_block_cols=self.n_block_cols)

    def to_ell(self) -> "BlockELL":
        """Block-ELL: K = the most blocks a row holds; padding blocks are
        zero and point at column 0."""
        counts = np.bincount(self.rows, minlength=self.n_block_rows)
        K = int(counts.max()) if counts.size else 1
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(self.rows.shape[0]) - starts[self.rows]
        cols = np.zeros((self.n_block_rows, K), dtype=np.int32)
        cols[self.rows, pos] = self.cols
        dev = self.data.device
        data = self.data.new_zeros((self.n_block_rows, K)
                                   + tuple(self.data.shape[1:]))
        data[torch.as_tensor(self.rows, device=dev),
             torch.as_tensor(pos, device=dev)] = self.data
        return BlockELL(data=data, cols=cols, n_block_cols=self.n_block_cols)


@dataclass
class BlockELL:
    """Block-ELL matrix: every row holds exactly K n_b x n_b blocks;
    padding blocks are zero and point at column 0.  The SpMV is a gather
    of a [P, K, nb] window of x and one einsum: no sum by row."""

    data: torch.Tensor  # [P, K, nb, nb]
    cols: np.ndarray  # [P, K] int32, host
    n_block_cols: int
    cols_t: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.cols_t = torch.as_tensor(np.asarray(self.cols, dtype=np.int64),
                                      device=self.data.device)

    @property
    def n_block_rows(self) -> int:
        return self.data.shape[0]

    @property
    def n_basis(self) -> int:
        return self.data.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def shape(self):
        return (self.data.shape[0] * self.data.shape[2],
                self.n_block_cols * self.data.shape[3])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        nb_c = self.data.shape[3]
        xb = x.reshape(self.n_block_cols, nb_c)
        yb = torch.einsum("pkij,pkj->pi", self.data, xb[self.cols_t])
        return yb.reshape(-1) if x.dim() == 1 else yb

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        P = self.cols.shape[0]
        is_diag = torch.as_tensor(self.cols == np.arange(P)[:, None],
                                  dtype=self.data.dtype,
                                  device=self.data.device)
        d = torch.diagonal(self.data, dim1=2, dim2=3)  # [P, K, nb]
        return (is_diag[:, :, None] * d).sum(dim=1).reshape(-1)


def _vec(v, dtype):
    """A smoother vector in the iterate's dtype, contiguous; as it is where
    it already is (``Tensor.to`` costs host time even as a no-op)."""
    if v is None:
        return None
    return (v if v.dtype == dtype else v.to(dtype)).contiguous()


@dataclass
class BlockBanded:
    """Banded block matrix: data[o, i, j, p] multiplies x[j, p + offsets[o]].

    ``data_i`` is the optional i-major copy [nb * R_pad, P] (rows (i, k, j),
    R_pad = n_off * nb rounded up to 8) that the kernels stream; the
    o-major ``data`` may then be a zero-length view (``drop_omajor``)."""

    data: torch.Tensor  # [n_off, nb, nb, P]
    offsets: np.ndarray  # [n_off] int64, sorted
    n_block_cols: int
    data_i: torch.Tensor | None = None
    offsets_t: torch.Tensor = field(init=False, repr=False)
    _kband: KernelBand | None = field(init=False, repr=False, default=None,
                                      compare=False)

    def __post_init__(self):
        self.offsets = np.asarray(self.offsets, dtype=np.int64)
        dev = (self.data_i if self.data_i is not None else self.data).device
        self.offsets_t = torch.as_tensor(self.offsets, dtype=torch.int32,
                                         device=dev)

    def with_imajor(self, drop_omajor: bool = False) -> "BlockBanded":
        """Attach the i-major copy; ``drop_omajor=True`` replaces ``data``
        with a zero-length view (shape metadata kept, bytes freed)."""
        n_off, nb = self.data.shape[0], self.data.shape[1]
        R = n_off * nb
        R_pad = -(-R // 8) * 8
        di = self.data.permute(1, 0, 2, 3).reshape(nb, R, -1)
        if R_pad != R:
            di = torch.nn.functional.pad(di, (0, 0, 0, R_pad - R))
        keep = self.data[..., :0] if drop_omajor else self.data
        return BlockBanded(keep, self.offsets, self.n_block_cols,
                           di.reshape(nb * R_pad, -1).contiguous())

    def _omajor_dropped(self) -> bool:
        return self.data.shape[-1] == 0 and self.data_i is not None

    @property
    def n_block_rows(self) -> int:
        if self._omajor_dropped():
            return self.data_i.shape[-1]
        return self.data.shape[-1]

    @property
    def n_basis(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return (self.data_i if self.data_i is not None else self.data).dtype

    @property
    def shape(self):
        nb = self.n_basis
        return (self.n_block_rows * nb, self.n_block_cols * nb)

    def _band(self, xt) -> KernelBand | None:
        """The kernels' launch arguments of the layout this band runs
        (i-major where ``data_i`` exists), validated at the first launch
        and kept; None for a CPU vector (plain versions)."""
        if xt.device.type == "cpu":
            return None
        if self._kband is None:
            self._kband = (
                imajor_band(self.data_i, self.offsets_t, self.n_basis)
                if self.data_i is not None
                else omajor_band(self.data, self.offsets_t))
        return self._kband

    def matvec_t(self, xt: torch.Tensor) -> torch.Tensor:
        """Transposed-layout SpMV (K1, or K0 without ``data_i``): xt
        [nb, P] -> [nb, P]."""
        xt = xt.contiguous()
        band = self._band(xt)
        if self.data_i is not None:
            return banded_matvec_t_imajor(self.data_i, self.offsets_t,
                                          self.n_basis, xt, band=band)
        return banded_matvec_t_omajor(self.data, self.offsets_t, xt,
                                      band=band)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        nb = self.n_basis
        xt = x.reshape(self.n_block_rows, nb).T
        y = self.matvec_t(xt)
        return y.T.reshape(-1) if x.dim() == 1 else y.T

    def fused_cheb_ok(self) -> bool:
        """Every band smooths fused: K2 on the i-major copy, fused K0 on
        the o-major band."""
        return True

    def cheb_step_t(self, xt, dvec, b, dinv, c1: float, c2: float):
        """Fused Chebyshev step (K2, or fused K0 without ``data_i``):
        d' = c1*d + c2*dinv*(b - A x); x' = x + d'.  ``dvec=None`` is the
        first step."""
        t = xt.dtype
        xt = xt.contiguous()
        band = self._band(xt)
        if self.data_i is not None:
            return banded_cheb_step_t(self.data_i, self.offsets_t,
                                      self.n_basis, xt, _vec(dvec, t),
                                      _vec(b, t), _vec(dinv, t), c1, c2,
                                      band=band)
        return banded_cheb_step_t_omajor(self.data, self.offsets_t, xt,
                                         _vec(dvec, t), _vec(b, t),
                                         _vec(dinv, t), c1, c2, band=band)

    def residual_t(self, xt, b):
        """Fused r = b - A x (K2, or fused K0 without ``data_i``) in the
        transposed layout."""
        xt = xt.contiguous()
        b = _vec(b, xt.dtype)
        band = self._band(xt)
        if self.data_i is not None:
            return banded_residual_t(self.data_i, self.offsets_t,
                                     self.n_basis, xt, b, band=band)
        return banded_residual_t_omajor(self.data, self.offsets_t, xt, b,
                                        band=band)

    def to_dense(self) -> torch.Tensor:
        """Dense matrix (small/coarse levels only; needs the o-major
        copy)."""
        P, nb = self.n_block_rows, self.n_basis
        out = torch.zeros((P, nb, P, nb), dtype=self.data.dtype,
                          device=self.data.device)
        for k, o in enumerate(self.offsets):
            o = int(o)
            p = torch.arange(max(0, -o), min(P, P - o),
                             device=self.data.device)
            if p.numel():
                out[p, :, p + o, :] += self.data[k][:, :, p].permute(2, 0, 1)
        return out.reshape(P * nb, P * nb)

    def _k0(self) -> int | None:
        k0 = int(np.searchsorted(self.offsets, 0))
        if k0 >= self.offsets.shape[0] or self.offsets[k0] != 0:
            return None
        return k0

    def diagonal_t(self) -> torch.Tensor:
        """Diagonal in transposed layout [nb, P]."""
        k0, nb = self._k0(), self.n_basis
        src = self.data_i if self._omajor_dropped() else self.data
        if k0 is None:
            return torch.zeros((nb, self.n_block_rows), dtype=src.dtype,
                               device=src.device)
        if self._omajor_dropped():
            # the i-major rows (i, k0, i)
            R_pad = self.data_i.shape[0] // nb
            return torch.stack([self.data_i[i * R_pad + k0 * nb + i]
                                for i in range(nb)], dim=0)
        return torch.stack([self.data[k0, i, i, :] for i in range(nb)], dim=0)

    def diagonal(self) -> torch.Tensor:
        """Flat main diagonal [P * nb]."""
        return self.diagonal_t().T.reshape(-1)

    def diag_blocks(self) -> torch.Tensor:
        """[P, nb, nb] diagonal blocks (block-Jacobi input), a view."""
        k0, nb, P = self._k0(), self.n_basis, self.n_block_rows
        src = self.data_i if self._omajor_dropped() else self.data
        if k0 is None:
            return torch.zeros((P, nb, nb), dtype=src.dtype,
                               device=src.device)
        if self._omajor_dropped():  # the i-major rows (i, k0, j)
            R_pad = self.data_i.shape[0] // nb
            blk = self.data_i.reshape(nb, R_pad, P)
            return blk[:, k0 * nb:(k0 + 1) * nb].permute(2, 0, 1)
        return self.data[k0].permute(2, 0, 1)

    def add_to_diagonal_band(self, blocks_t: torch.Tensor) -> "BlockBanded":
        """New BlockBanded with ``blocks_t`` [nb, nb, P] added to the
        offset-0 band row (e.g. a scaled mass matrix); any i-major copy is
        stale after the update, so the result has none."""
        k0 = self._k0()
        if k0 is None:
            raise ValueError("band has no diagonal row")
        if self._omajor_dropped():
            raise ValueError("add_to_diagonal_band needs the o-major band")
        data = self.data.clone(memory_format=torch.contiguous_format)
        data[k0] += blocks_t.to(data.dtype)
        return BlockBanded(data, self.offsets, self.n_block_cols)

    def to_packed(self, plan: PackPlan, oid: torch.Tensor, far_rows=None,
                  far_cols=None) -> "BlockPacked":
        """Pack the wide band into the per-lane K-slot format
        (``ops/packed.py``); ``oid`` [K, P] int32 is on the band's device
        and ``far_rows``/``far_cols`` (from ``build_pack_plan``) are the
        block-COO tail, extracted in their (offset, row) order.  A masked
        selection per slot (offsets in one slot are conflict-free: at most
        one is active per lane); needs the o-major ``data``."""
        if self._omajor_dropped():
            raise ValueError("to_packed needs the o-major band")

        def row(o):
            b_idx = int(np.searchsorted(self.offsets, o))
            if b_idx >= self.offsets.shape[0] or self.offsets[b_idx] != o:
                raise ValueError(f"plan offset {o} not in the band")
            return self.data[b_idx]

        return BlockPacked(data_i=pack_blocks(row, plan, oid), oid=oid,
                           plan=plan,
                           far_data=far_blocks(row, far_rows, far_cols),
                           far_rows=far_rows, far_cols=far_cols)


def far_blocks(block_of, far_rows, far_cols) -> torch.Tensor | None:
    """The far block-COO tail's blocks [n_far, nb, nb], in the (offset,
    row) order of ``far_rows``/``far_cols`` (``build_pack_plan``'s): row r
    of offset o is ``block_of(o)`` [nb, nb, P] at lane r.  None without a
    tail."""
    if far_rows is None or not far_rows.size:
        return None
    foffs = far_cols - far_rows
    chunks = []
    for o in np.unique(foffs):
        blk = block_of(int(o))
        rows = torch.as_tensor(far_rows[foffs == o], device=blk.device)
        chunks.append(blk[:, :, rows].permute(2, 0, 1))
    return torch.cat(chunks, dim=0)


def pack_blocks(block_of, plan: PackPlan, oid: torch.Tensor) -> torch.Tensor:
    """The packed ``data_i`` [nb * R_pad, P]: slot k at lane p holds
    ``block_of(offset)`` [nb, nb, P] of the offset ``oid[k, p]`` names
    (offsets in one slot are conflict-free: at most one is active per
    lane), zero where the slot is empty; rows (i, k, j), each i-slab
    zero-padded to R_pad rows."""
    packed_k = []
    for k in range(plan.K):
        acc = None
        for o_idx in plan.slots[k]:
            blk = block_of(plan.offsets[o_idx])
            acc = torch.where((oid[k] == o_idx)[None, None, :], blk,
                              blk.new_zeros(()) if acc is None else acc)
        packed_k.append(acc)
    nb, _, P = packed_k[0].shape
    pad = plan.R_pad - plan.K * nb
    slabs = []
    for i in range(nb):
        slabs += [pk[i] for pk in packed_k]
        if pad:
            slabs.append(packed_k[0].new_zeros((pad, P)))
    return torch.cat(slabs, dim=0)


@dataclass
class BlockPacked:
    """Per-lane packed banded block matrix (see ``ops/packed.py``).

    ``data_i`` [nb * R_pad, P] i-major packed slabs; ``oid`` [K, P] int32
    on the same device (which offset each slot holds per lane, -1 = none);
    ``plan`` the host colouring; ``far_data`` [n_far, nb, nb] with host
    ``far_rows``/``far_cols`` the block-COO tail of offsets split off the
    slots (none under the single-device full colouring)."""

    data_i: torch.Tensor
    oid: torch.Tensor
    plan: PackPlan
    far_data: torch.Tensor | None = None
    far_rows: np.ndarray | None = None
    far_cols: np.ndarray | None = None
    offsets_t: torch.Tensor = field(init=False, repr=False)
    _kband: KernelBand | None = field(init=False, repr=False, default=None,
                                      compare=False)

    def __post_init__(self):
        dev = self.data_i.device
        self.offsets_t = torch.as_tensor(self.plan.offsets,
                                         dtype=torch.int32, device=dev)
        if self._has_far():
            self._far_rows_t = torch.as_tensor(self.far_rows, device=dev)
            self._far_cols_t = torch.as_tensor(self.far_cols, device=dev)

    def _has_far(self) -> bool:
        return self.far_data is not None and self.far_rows.size > 0

    @property
    def n_basis(self) -> int:
        return self.plan.nb

    @property
    def n_block_rows(self) -> int:
        return self.data_i.shape[-1]

    @property
    def n_block_cols(self) -> int:
        return self.data_i.shape[-1]

    @property
    def shape(self):
        n = self.n_basis * self.n_block_rows
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.data_i.dtype

    def astype(self, dtype) -> "BlockPacked":
        fd = None if self.far_data is None else self.far_data.to(dtype)
        return BlockPacked(self.data_i.to(dtype), self.oid, self.plan, fd,
                           self.far_rows, self.far_cols)

    def _band(self, xt) -> KernelBand | None:
        """The kernels' launch arguments, validated at the first launch
        and kept; None for a CPU vector (plain versions)."""
        if xt.device.type == "cpu":
            return None
        if self._kband is None:
            self._kband = packed_band(self.data_i, self.oid, self.offsets_t,
                                      self.n_basis)
        return self._kband

    def matvec_t(self, xt: torch.Tensor) -> torch.Tensor:
        """Transposed-layout SpMV (K6, plus the far tail): [nb, P] ->
        [nb, P]."""
        xt = xt.contiguous()
        y = packed_matvec_t(self.data_i, self.oid, self.offsets_t,
                            self.n_basis, xt, band=self._band(xt))
        if self._has_far():
            y = y + self.far_matvec_t(xt)
        return y

    def far_matvec_t(self, xt: torch.Tensor) -> torch.Tensor:
        """The far block-COO tail's product alone, [nb, P] -> [nb, P] in
        ``xt``'s dtype (zero without a tail): gather, block products,
        scatter-add by row."""
        yb = torch.zeros((self.n_block_rows, self.n_basis), dtype=xt.dtype,
                         device=xt.device)
        if self._has_far():
            g = xt.T[self._far_cols_t]  # [n_far, nb]
            prod = torch.einsum("kij,kj->ki", self.far_data.to(xt.dtype), g)
            yb.index_add_(0, self._far_rows_t, prod)
        return yb.T

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xt = x.reshape(self.n_block_rows, self.n_basis).T
        y = self.matvec_t(xt)
        return y.T.reshape(-1) if x.dim() == 1 else y.T

    def fused_cheb_ok(self) -> bool:
        """Fused smoothing (K7) covers full-colouring packs only: a far
        block-COO tail would be missing from the kernel's A x."""
        return not self._has_far()

    def cheb_step_t(self, xt, dvec, b, dinv, c1: float, c2: float):
        """Fused Chebyshev step (K7); see :meth:`BlockBanded.cheb_step_t`."""
        t = xt.dtype
        xt = xt.contiguous()
        return packed_cheb_step_t(self.data_i, self.oid, self.offsets_t,
                                  self.n_basis, xt, _vec(dvec, t), _vec(b, t),
                                  _vec(dinv, t), c1, c2, band=self._band(xt))

    def residual_t(self, xt, b):
        """Fused r = b - A x (K7) in the transposed layout."""
        xt = xt.contiguous()
        return packed_residual_t(self.data_i, self.oid, self.offsets_t,
                                 self.n_basis, xt, _vec(b, xt.dtype),
                                 band=self._band(xt))

    def _slot_block(self, k: int) -> torch.Tensor:
        """[nb, nb, P]: the rows (i, k, j) of slot k."""
        nb, R_pad = self.n_basis, self.plan.R_pad
        return self.data_i.reshape(nb, R_pad, -1)[:, k * nb:(k + 1) * nb]

    def repack(self, plan2: PackPlan, oid2: torch.Tensor, far_rows=None,
               far_cols=None) -> "BlockPacked":
        """Re-slot under a new plan over the same sparsity (e.g. a near/far
        split for a shard's halo, ``parallel/banded.py``) without the dense
        band: each new slot row is a masked per-lane selection of the old
        slot row holding the same offset, and the far tail is read from the
        old rows directly, so memory stays O(pack).  Needs a
        full-colouring source (no far tail); ``oid2`` [K2, P] int32 on the
        pack's device."""
        if self._has_far():
            raise ValueError("repack needs a full-colouring source pack")
        old_slot = {self.plan.offsets[o]: k
                    for k, sl in enumerate(self.plan.slots) for o in sl}
        # the old slot of offset o holds o's block wherever o is active;
        # other lanes carry a sibling's, masked by the new oid
        block_of = lambda o: self._slot_block(old_slot[o])
        return BlockPacked(data_i=pack_blocks(block_of, plan2, oid2),
                           oid=oid2, plan=plan2,
                           far_data=far_blocks(block_of, far_rows, far_cols),
                           far_rows=far_rows, far_cols=far_cols)

    def to_banded(self) -> BlockBanded:
        """Exact unpack to the dense band (per-slot masked expansion)."""
        if self._has_far():
            raise ValueError("cannot unpack a pack with a far tail")
        plan = self.plan
        slot_of = {o: k for k, sl in enumerate(plan.slots) for o in sl}
        zero = torch.zeros((), dtype=self.dtype, device=self.data_i.device)
        rows = [torch.where((self.oid[slot_of[o]] == o)[None, None, :],
                            self._slot_block(slot_of[o]), zero)
                for o in range(len(plan.offsets))]
        return BlockBanded(data=torch.stack(rows, dim=0),
                           offsets=np.asarray(plan.offsets, dtype=np.int64),
                           n_block_cols=self.n_block_cols)

    def sparsity_pairs(self):
        """(src, dst) directed block pairs of this pack (host numpy),
        including any far tail, without the diagonal: enough to rebuild a
        plan."""
        oid = self.oid.cpu().numpy()
        offs = np.asarray(self.plan.offsets)
        ks, ps = np.nonzero(oid >= 0)
        src = ps.astype(np.int64)
        dst = src + offs[oid[ks, ps]]
        if self._has_far():
            src = np.concatenate([src, np.asarray(self.far_rows)])
            dst = np.concatenate([dst, np.asarray(self.far_cols)])
        keep = src != dst
        return src[keep], dst[keep]

    def diagonal_t(self) -> torch.Tensor:
        """[nb, P].  Offset 0 is on every lane, so it conflicts with every
        other offset and the colouring gives it a slot of its own."""
        plan = self.plan
        o0 = plan.offsets.index(0)
        (s0,) = [k for k, sl in enumerate(plan.slots) if o0 in sl]
        if plan.slots[s0] != (o0,):
            raise ValueError("offset 0 must be alone in its slot")
        blk = self._slot_block(s0)
        return torch.stack([blk[i, i] for i in range(self.n_basis)], dim=0)

    def diagonal(self) -> torch.Tensor:
        """Flat main diagonal [P * nb]."""
        return self.diagonal_t().T.reshape(-1)
