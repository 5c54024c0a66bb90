"""Banded block matrix with dense n_b x n_b blocks, on torch tensors.

Counterpart of ``polydeal_tpu/sparse.py`` ``BlockBanded``.  The polytope
axis P is last, every column access is a shift by a band offset, and the
zero blocks stored at rows lacking an offset annihilate what falls outside
the matrix.  Offsets stay a host numpy array (they shape the program), with
an int32 device copy for the kernels.

SpMV dispatch: a band with the i-major copy ``data_i`` multiplies through
K1 (``ops/banded.py``), which launches the CUDA kernel on a CUDA tensor and
runs its plain version on a CPU tensor; a band without it runs the plain
roll+einsum over the o-major ``data``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from polydeal_tpu_torch.ops.banded import banded_matvec_t_imajor
from polydeal_tpu_torch.ops.fused_cheb import (
    banded_cheb_step_t,
    banded_residual_t,
)

__all__ = ["BlockBanded"]


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

    def matvec_t(self, xt: torch.Tensor) -> torch.Tensor:
        """Transposed-layout SpMV: xt [nb, P] -> [nb, P]."""
        if self.data_i is not None:
            return banded_matvec_t_imajor(self.data_i, self.offsets_t,
                                          self.n_basis, xt.contiguous())
        y = torch.zeros_like(xt)
        for k, o in enumerate(self.offsets):
            xs = torch.roll(xt, -int(o), dims=1) if o != 0 else xt
            y = y + torch.einsum("ijp,jp->ip", self.data[k].to(xt.dtype), xs)
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        nb = self.n_basis
        xt = x.reshape(self.n_block_rows, nb).T
        y = self.matvec_t(xt)
        return y.T.reshape(-1) if x.dim() == 1 else y.T

    def fused_cheb_ok(self) -> bool:
        """Fused smoothing (K2) needs the i-major copy."""
        return self.data_i is not None

    def cheb_step_t(self, xt, dvec, b, dinv, c1: float, c2: float):
        """Fused Chebyshev step (K2): d' = c1*d + c2*dinv*(b - A x);
        x' = x + d'.  ``dvec=None`` is the first step."""
        t = xt.dtype

        def vec(v):
            return None if v is None else v.to(t).contiguous()

        return banded_cheb_step_t(self.data_i, self.offsets_t, self.n_basis,
                                  xt.contiguous(), vec(dvec), vec(b),
                                  vec(dinv), c1, c2)

    def residual_t(self, xt, b):
        """Fused r = b - A x (K2) in the transposed layout."""
        return banded_residual_t(self.data_i, self.offsets_t, self.n_basis,
                                 xt.contiguous(), b.to(xt.dtype).contiguous())

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
