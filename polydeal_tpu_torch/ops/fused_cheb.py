"""K2 and K7: the fused Chebyshev step and residual, on the i-major band
(K2) and on the packed band (K7).

Counterpart of ``polydeal_tpu/ops/fused_cheb.py`` ``banded_cheb_step_t``,
``banded_residual_t`` (Pallas kernel ``_banded_fused_impl``) and
``packed_cheb_step_t``, ``packed_residual_t`` (``_packed_fused_impl``).
One kernel computes y = A x as K1 (or K6) does and consumes it in its
epilogue:

  step      (x, d) -> (x', d'):  d' = c1*d + c2*dinv*(b - y);  x' = x + d'
  step0     (x,)   -> (x', d'):  d' = c2*dinv*(b - y);         x' = x + d'
  residual  (x,)   -> b - y

On a CUDA tensor the wrappers launch the kernels of ``csrc/banded.cu`` and
``csrc/packed.cu`` (and raise if they cannot); on a CPU tensor they run the
plain PyTorch versions below.  Accumulation is in the vectors' dtype (f32,
or f64).
"""

from __future__ import annotations

import torch

from polydeal_tpu_torch.ops import _build
from polydeal_tpu_torch.ops.banded import (
    banded_matvec_t_imajor_ref,
    check_kernel_args,
)
from polydeal_tpu_torch.ops.packed import (
    check_packed_args,
    packed_matvec_t_ref,
)

__all__ = [
    "banded_cheb_step_t",
    "banded_residual_t",
    "banded_cheb_step_t_ref",
    "banded_residual_t_ref",
    "packed_cheb_step_t",
    "packed_residual_t",
    "packed_cheb_step_t_ref",
    "packed_residual_t_ref",
]

# mode codes of the C interface (enum Mode in csrc/banded.cu, packed.cu)
_MODES = {"residual": 0, "step0": 1, "step": 2}


def _cheb_update(r, xt, dvec, dinv, c1, c2):
    """(x', d') of one step from the residual r = b - A x."""
    d_new = c2 * (dinv * r)
    if dvec is not None:
        d_new = c1 * dvec + d_new
    return xt + d_new, d_new


def banded_cheb_step_t_ref(data_i, offsets, nb: int, xt, dvec, b, dinv,
                           c1: float, c2: float):
    """Plain version of the fused step; ``dvec=None`` is the first step."""
    r = b - banded_matvec_t_imajor_ref(data_i, offsets, nb, xt)
    return _cheb_update(r, xt, dvec, dinv, c1, c2)


def banded_residual_t_ref(data_i, offsets, nb: int, xt, b):
    """Plain version of the fused residual b - A x."""
    return b - banded_matvec_t_imajor_ref(data_i, offsets, nb, xt)


def packed_cheb_step_t_ref(data_i, oid, offsets, nb: int, xt, dvec, b,
                           dinv, c1: float, c2: float):
    """Plain version of K7's step; ``dvec=None`` is the first step."""
    r = b - packed_matvec_t_ref(data_i, oid, offsets, nb, xt)
    return _cheb_update(r, xt, dvec, dinv, c1, c2)


def packed_residual_t_ref(data_i, oid, offsets, nb: int, xt, b):
    """Plain version of K7's residual b - A x."""
    return b - packed_matvec_t_ref(data_i, oid, offsets, nb, xt)


def _launch(mode, data_i, offsets, nb, xt, b, dvec=None, dinv=None,
            c1=0.0, c2=0.0, oid=None):
    """Launch K2, or K7 when ``oid`` (the packed slot table) is given."""
    name = "K2" if oid is None else "K7"
    if xt.device.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {xt.device}")
    vecs = [t for t in (xt, b, dvec, dinv) if t is not None]
    if oid is None:
        n_off, R_pad, P = check_kernel_args(data_i, offsets, nb, vecs)
    else:
        n_off, K, R_pad, P = check_packed_args(data_i, oid, offsets, nb,
                                               vecs)
    out0 = torch.empty_like(xt)
    out1 = None if mode == "residual" else torch.empty_like(xt)
    ptr = lambda t: None if t is None else t.data_ptr()
    head = (data_i.data_ptr(), _build.DTYPE_CODES[data_i.dtype],
            xt.data_ptr(), _build.DTYPE_CODES[xt.dtype])
    tail = (R_pad, P, b.data_ptr(), ptr(dvec), ptr(dinv), float(c1),
            float(c2), _MODES[mode], out0.data_ptr(), ptr(out1),
            _build.stream_handle(xt.device))
    lib = _build.load_library()
    with torch.cuda.device(xt.device):
        if oid is None:
            rc = lib.pd_banded_fused(*head, offsets.data_ptr(), n_off, nb,
                                     *tail)
        else:
            rc = lib.pd_packed_fused(*head, oid.data_ptr(),
                                     offsets.data_ptr(), n_off, K, nb, *tail)
    if rc != 0:
        raise RuntimeError(f"{name} fused Chebyshev ({mode}) launch failed: "
                           f"{rc}")
    _build.launches["banded_fused_cheb" if oid is None
                    else "packed_fused_cheb"] += 1
    return out0 if out1 is None else (out0, out1)


def banded_cheb_step_t(data_i, offsets, nb: int, xt, dvec, b, dinv,
                       c1: float, c2: float):
    """One fused Chebyshev step; ``dvec=None`` is the first step (c1 is
    then unused).  Returns (x', d') in ``xt``'s dtype."""
    if xt.device.type == "cpu":
        return banded_cheb_step_t_ref(data_i, offsets, nb, xt, dvec, b, dinv,
                                      c1, c2)
    mode = "step0" if dvec is None else "step"
    return _launch(mode, data_i, offsets, nb, xt, b, dvec, dinv, c1, c2)


def banded_residual_t(data_i, offsets, nb: int, xt, b):
    """Fused r = b - A x."""
    if xt.device.type == "cpu":
        return banded_residual_t_ref(data_i, offsets, nb, xt, b)
    return _launch("residual", data_i, offsets, nb, xt, b)


def packed_cheb_step_t(data_i, oid, offsets, nb: int, xt, dvec, b, dinv,
                       c1: float, c2: float):
    """One fused Chebyshev step on the packed band (K7); ``dvec=None`` is
    the first step.  ``offsets`` is the plan's int32 offset table on the
    band's device.  Returns (x', d') in ``xt``'s dtype."""
    if xt.device.type == "cpu":
        return packed_cheb_step_t_ref(data_i, oid, offsets, nb, xt, dvec, b,
                                      dinv, c1, c2)
    mode = "step0" if dvec is None else "step"
    return _launch(mode, data_i, offsets, nb, xt, b, dvec, dinv, c1, c2,
                   oid=oid)


def packed_residual_t(data_i, oid, offsets, nb: int, xt, b):
    """Fused r = b - A x on the packed band (K7)."""
    if xt.device.type == "cpu":
        return packed_residual_t_ref(data_i, oid, offsets, nb, xt, b)
    return _launch("residual", data_i, offsets, nb, xt, b, oid=oid)
