"""K1: the i-major banded block SpMV, the hot op of CG and of the
eigenvalue estimates; K0: the same product over the o-major band.

K1 is the counterpart of ``polydeal_tpu/ops/banded.py``
``banded_matvec_t_imajor`` (Pallas kernel ``_banded_matvec_imajor_impl``),
K0 of ``banded_matvec_t_pallas`` (Pallas kernel ``_banded_matvec_impl``).
On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/banded.cu`` (and raises if it cannot); on a CPU tensor it runs its
plain PyTorch version (``*_ref``), which computes the same function.

Layout contracts (shared with the JAX package): K1 takes ``data_i``
[nb * R_pad, P] with rows ordered (i, k, j) and R_pad >= n_off * nb
(padding rows are never read); K0 takes ``data`` [n_off, nb, nb, P]; both
take ``xt`` [nb, P], and x reads zero outside [0, P).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from polydeal_tpu_torch.ops import _build

__all__ = ["banded_matvec_t_imajor", "banded_matvec_t_imajor_ref",
           "banded_matvec_t_omajor", "banded_matvec_t_omajor_ref"]

_VEC_DTYPES = (torch.float32, torch.float64)
# K0 stages its offset table in 48 KB of shared memory
_MAX_OFFSETS = 48 * 1024 // 4


def _host_offsets(offsets) -> list[int]:
    if isinstance(offsets, torch.Tensor):
        return [int(o) for o in offsets.tolist()]
    return [int(o) for o in np.asarray(offsets)]


def banded_matvec_t_imajor_ref(data_i: torch.Tensor, offsets, nb: int,
                               xt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1, accumulating in ``xt``'s dtype."""
    offs = _host_offsets(offsets)
    n_off = len(offs)
    P = data_i.shape[1]
    R_pad = data_i.shape[0] // nb
    acc = xt.dtype
    D = (data_i.reshape(nb, R_pad, P)[:, :n_off * nb]
         .reshape(nb, n_off, nb, P).to(acc))
    H = max([abs(o) for o in offs] + [0])
    xpad = F.pad(xt.to(acc), (H, H))  # zeros outside [0, P)
    Xg = torch.stack([xpad[:, H + o:H + o + P] for o in offs])
    return torch.einsum("ikjp,kjp->ip", D, Xg)


def check_kernel_args(data_i, offsets, nb, vecs, n_slots=None):
    """Validate what the CUDA kernels take; returns (n_off, R_pad, P).
    Each i-slab holds ``n_slots`` row blocks (default: one per offset; the
    packed format's K)."""
    dev = data_i.device
    if data_i.dim() != 2 or nb <= 0 or data_i.shape[0] % nb:
        raise ValueError(f"data_i {tuple(data_i.shape)} is not [nb*R_pad, P]"
                         f" for nb={nb}")
    if data_i.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"band dtype {data_i.dtype} not supported")
    if not isinstance(offsets, torch.Tensor) or offsets.dtype != torch.int32:
        raise TypeError("offsets must be an int32 tensor")
    P = data_i.shape[1]
    R_pad = data_i.shape[0] // nb
    n_off = offsets.numel()
    slots = n_off if n_slots is None else n_slots
    if R_pad < slots * nb:
        raise ValueError(f"R_pad={R_pad} < slots*nb={slots * nb}")
    vdt = vecs[0].dtype
    if vdt not in _VEC_DTYPES:
        raise TypeError(f"vector dtype {vdt} not supported (f32 or f64)")
    if vdt == torch.float32 and data_i.dtype == torch.float64:
        raise TypeError("f64 band needs f64 vectors")
    for t in (data_i, offsets, *vecs):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, band on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    for v in vecs:
        if tuple(v.shape) != (nb, P) or v.dtype != vdt:
            raise ValueError(f"vector {tuple(v.shape)} {v.dtype} is not "
                             f"[{nb}, {P}] {vdt}")
    return n_off, R_pad, P


def banded_matvec_t_imajor(data_i: torch.Tensor, offsets, nb: int,
                           xt: torch.Tensor) -> torch.Tensor:
    """y[i, p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j, p+off_k].

    ``offsets`` is an int32 tensor on the band's device (read by the
    kernel on the device); returns y [nb, P] in ``xt``'s dtype."""
    if xt.device.type == "cpu":
        return banded_matvec_t_imajor_ref(data_i, offsets, nb, xt)
    if xt.device.type != "cuda":
        raise RuntimeError(f"no K1 kernel for device {xt.device}")
    n_off, R_pad, P = check_kernel_args(data_i, offsets, nb, (xt,))
    y = torch.empty_like(xt)
    lib = _build.load_library()
    with torch.cuda.device(xt.device):
        rc = lib.pd_banded_matvec(
            data_i.data_ptr(), _build.DTYPE_CODES[data_i.dtype],
            xt.data_ptr(), _build.DTYPE_CODES[xt.dtype], offsets.data_ptr(),
            n_off, nb, R_pad, P, y.data_ptr(),
            _build.stream_handle(xt.device))
    if rc != 0:
        raise RuntimeError(f"K1 banded_matvec_imajor launch failed: {rc}")
    _build.launches["banded_matvec_imajor"] += 1
    return y


def banded_matvec_t_omajor_ref(data: torch.Tensor, offsets,
                               xt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K0: x zero-padded and gathered at each
    offset's shifted window (no roll, so lanes whose column leaves [0, P)
    read zero whatever the band stores there); accumulates in f64 for an
    f64 band and in f32 otherwise, and returns ``xt``'s dtype."""
    offs = _host_offsets(offsets)
    P = data.shape[-1]
    acc = torch.float64 if data.dtype == torch.float64 else torch.float32
    H = max([abs(o) for o in offs] + [0])
    xpad = F.pad(xt.to(acc), (H, H))  # zeros outside [0, P)
    Xg = torch.stack([xpad[:, H + o:H + o + P] for o in offs])
    return torch.einsum("oijp,ojp->ip", data.to(acc), Xg).to(xt.dtype)


def check_omajor_args(data, offsets, xt):
    """Validate what K0 takes, as :func:`check_kernel_args` does for K1;
    returns (n_off, nb, P)."""
    if data.dim() != 4 or data.shape[1] != data.shape[2]:
        raise ValueError(f"data {tuple(data.shape)} is not [n_off, nb, nb, "
                         f"P]")
    if not data.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    n_off, nb, _, P = data.shape
    # the o-major band viewed as n_off * nb rows per i-slab
    check_kernel_args(data.view(nb * n_off * nb, P), offsets, nb, (xt,))
    if offsets.numel() != n_off:
        raise ValueError(f"{offsets.numel()} offsets for {n_off} band rows")
    if n_off > _MAX_OFFSETS:
        raise ValueError(f"{n_off} offsets exceed K0's shared-memory table "
                         f"({_MAX_OFFSETS})")
    return n_off, nb, P


def banded_matvec_t_omajor(data: torch.Tensor, offsets,
                           xt: torch.Tensor) -> torch.Tensor:
    """y[i, p] = sum_o sum_j data[o, i, j, p] * x[j, p + offsets[o]] (K0).

    ``data`` [n_off, nb, nb, P] bf16, f32 or f64, contiguous; ``offsets``
    the band's int32 device table (``BlockBanded.offsets_t``); ``xt``
    [nb, P] f32 or f64.  Accumulates in f64 for f64 data, in f32
    otherwise; returns y [nb, P] in ``xt``'s dtype."""
    if xt.device.type == "cpu":
        return banded_matvec_t_omajor_ref(data, offsets, xt)
    if xt.device.type != "cuda":
        raise RuntimeError(f"no K0 kernel for device {xt.device}")
    n_off, nb, P = check_omajor_args(data, offsets, xt)
    y = torch.empty_like(xt)
    lib = _build.load_library()
    with torch.cuda.device(xt.device):
        rc = lib.pd_banded_matvec_omajor(
            data.data_ptr(), _build.DTYPE_CODES[data.dtype], xt.data_ptr(),
            _build.DTYPE_CODES[xt.dtype], offsets.data_ptr(), n_off, nb, P,
            y.data_ptr(), _build.stream_handle(xt.device))
    if rc != 0:
        raise RuntimeError(f"K0 banded_matvec_omajor launch failed: {rc}")
    _build.launches["banded_matvec_omajor"] += 1
    return y
