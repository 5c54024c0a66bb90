"""K2, fused K0 and K7: the fused Chebyshev step and residual, on the
i-major band (K2), on the o-major band (fused K0) and on the packed band
(K7).

Counterpart of ``polydeal_tpu/ops/fused_cheb.py`` ``banded_cheb_step_t``,
``banded_residual_t`` (Pallas kernel ``_banded_fused_impl``) and
``packed_cheb_step_t``, ``packed_residual_t`` (``_packed_fused_impl``).
One kernel computes y = A x as K1 (K0, K6) does and consumes it in its
epilogue:

  step      (x, d) -> (x', d'):  d' = c1*d + c2*dinv*(b - y);  x' = x + d'
  step0     (x,)   -> (x', d'):  d' = c2*dinv*(b - y);         x' = x + d'
  residual  (x,)   -> b - y

The ``_omajor`` entry points compute K2's function on a band without the
i-major copy (the small multigrid levels), where the JAX package runs the
product and the update unfused; their plain versions are K0's plain
product followed by the same update.

The ``_halo`` entry points (K2 halo and K7 halo: the counterparts of
``banded_cheb_step_t_halo``, ``banded_residual_t_halo``,
``packed_cheb_step_t_halo`` and ``packed_residual_t_halo``) compute the same
on one shard's lane slab: x is read from ``x_ext`` [nb, per + 2T] (the
neighbouring shards' T lanes on each side, every |offset| <= T), the
update's own x at lanes [T, T + per); b, d, dinv and the outputs are the
slab's [nb, per].  A pack's far block-COO tail is not in K7's product: the
caller passes b_eff = b - A_far x to the step and subtracts A_far x from
the residual.

On a CUDA tensor the wrappers launch the kernels of ``csrc/banded.cu``
(K2, K2 halo; at an nb outside ``ops/banded.KERNEL_NB`` the runtime-nb
kernel of ``csrc/banded_any_nb.cu``), ``csrc/banded_omajor.cu`` (fused K0)
and ``csrc/packed.cu`` (K7, K7 halo), and raise if they cannot; on a CPU tensor they run the plain PyTorch versions below.  The
update runs in the vectors' dtype (f32, or f64); the product accumulates
in it for K2 and K7, and as K0 does (f64 for an f64 band, f32 otherwise)
for fused K0.  bf16 vectors are cast to f32 before the launch and the
results back to bf16, where the JAX package's wrappers cast (``_prep_x``,
``_scal_vecs``, ``polydeal_tpu/ops/fused_cheb.py:287-300``, ``:406``);
the V-cycle itself
runs bf16 sweeps through the composed smoother, as the JAX package's
``_fused_ok`` refuses them.  ``band=`` takes the band's validated launch
arguments where the caller keeps them (``ops/banded.KernelBand``).
"""

from __future__ import annotations

import torch

from polydeal_tpu_torch.ops.banded import (
    KernelBand,
    banded_matvec_t_halo_ref,
    banded_matvec_t_imajor_ref,
    banded_matvec_t_omajor_ref,
    imajor_band,
    launch_band,
    narrow_to,
    omajor_band,
    widen_bf16,
)
from polydeal_tpu_torch.ops.packed import (
    packed_band,
    packed_matvec_t_halo_ref,
    packed_matvec_t_ref,
)

__all__ = [
    "banded_cheb_step_t",
    "banded_residual_t",
    "banded_cheb_step_t_ref",
    "banded_residual_t_ref",
    "banded_cheb_step_t_omajor",
    "banded_residual_t_omajor",
    "banded_cheb_step_t_omajor_ref",
    "banded_residual_t_omajor_ref",
    "packed_cheb_step_t",
    "packed_residual_t",
    "packed_cheb_step_t_ref",
    "packed_residual_t_ref",
    "banded_cheb_step_t_halo",
    "banded_residual_t_halo",
    "banded_cheb_step_t_halo_ref",
    "banded_residual_t_halo_ref",
    "packed_cheb_step_t_halo",
    "packed_residual_t_halo",
    "packed_cheb_step_t_halo_ref",
    "packed_residual_t_halo_ref",
]

# mode codes of the C interface (enum Mode in csrc/banded.cu,
# banded_omajor.cu, packed.cu)
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


def banded_cheb_step_t_omajor_ref(data, offsets, xt, dvec, b, dinv,
                                  c1: float, c2: float):
    """Plain version of fused K0's step; ``dvec=None`` is the first step."""
    r = b - banded_matvec_t_omajor_ref(data, offsets, xt)
    return _cheb_update(r, xt, dvec, dinv, c1, c2)


def banded_residual_t_omajor_ref(data, offsets, xt, b):
    """Plain version of fused K0's residual b - A x."""
    return b - banded_matvec_t_omajor_ref(data, offsets, xt)


def packed_cheb_step_t_ref(data_i, oid, offsets, nb: int, xt, dvec, b,
                           dinv, c1: float, c2: float):
    """Plain version of K7's step; ``dvec=None`` is the first step."""
    r = b - packed_matvec_t_ref(data_i, oid, offsets, nb, xt)
    return _cheb_update(r, xt, dvec, dinv, c1, c2)


def packed_residual_t_ref(data_i, oid, offsets, nb: int, xt, b):
    """Plain version of K7's residual b - A x."""
    return b - packed_matvec_t_ref(data_i, oid, offsets, nb, xt)


def _launch(band: KernelBand, xt, b, dvec=None, dinv=None, c1=0.0, c2=0.0,
            step: bool = True, halo: int | None = None):
    """Launch the band's fused kernel: a step (x', d') or the residual;
    ``halo=T`` on a shard's slab, ``xt`` being its x_ext."""
    mode = "residual" if not step else "step0" if dvec is None else "step"
    out0 = torch.empty_like(b)
    out1 = torch.empty_like(b) if step else None
    vecs = [t for t in (xt, b, dvec, dinv) if t is not None]
    ptr = lambda t: None if t is None else t.data_ptr()
    launch_band(band, True, vecs,
                (b.data_ptr(), ptr(dvec), ptr(dinv), float(c1), float(c2),
                 _MODES[mode], out0.data_ptr(), ptr(out1)), halo)
    return (out0, out1) if step else out0


def banded_cheb_step_t(data_i, offsets, nb: int, xt, dvec, b, dinv,
                       c1: float, c2: float, *, band=None):
    """One fused Chebyshev step (K2); ``dvec=None`` is the first step (c1
    is then unused).  Returns (x', d') in ``xt``'s dtype."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(banded_cheb_step_t(
            data_i, offsets, nb, *widen_bf16(xt, dvec, b, dinv), c1, c2,
            band=band), xt.dtype)
    if xt.device.type == "cpu":
        return banded_cheb_step_t_ref(data_i, offsets, nb, xt, dvec, b, dinv,
                                      c1, c2)
    if band is None:
        band = imajor_band(data_i, offsets, nb)
    return _launch(band, xt, b, dvec, dinv, c1, c2)


def banded_residual_t(data_i, offsets, nb: int, xt, b, *, band=None):
    """Fused r = b - A x (K2)."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(banded_residual_t(
            data_i, offsets, nb, *widen_bf16(xt, b), band=band), xt.dtype)
    if xt.device.type == "cpu":
        return banded_residual_t_ref(data_i, offsets, nb, xt, b)
    if band is None:
        band = imajor_band(data_i, offsets, nb)
    return _launch(band, xt, b, step=False)


def banded_cheb_step_t_omajor(data, offsets, xt, dvec, b, dinv, c1: float,
                              c2: float, *, band=None):
    """One fused Chebyshev step on the o-major band [n_off, nb, nb, P]
    (fused K0); ``dvec=None`` is the first step.  Returns (x', d') in
    ``xt``'s dtype."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(banded_cheb_step_t_omajor(
            data, offsets, *widen_bf16(xt, dvec, b, dinv), c1, c2, band=band),
            xt.dtype)
    if xt.device.type == "cpu":
        return banded_cheb_step_t_omajor_ref(data, offsets, xt, dvec, b, dinv,
                                             c1, c2)
    if band is None:
        band = omajor_band(data, offsets)
    return _launch(band, xt, b, dvec, dinv, c1, c2)


def banded_residual_t_omajor(data, offsets, xt, b, *, band=None):
    """Fused r = b - A x on the o-major band (fused K0)."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(banded_residual_t_omajor(
            data, offsets, *widen_bf16(xt, b), band=band), xt.dtype)
    if xt.device.type == "cpu":
        return banded_residual_t_omajor_ref(data, offsets, xt, b)
    if band is None:
        band = omajor_band(data, offsets)
    return _launch(band, xt, b, step=False)


def packed_cheb_step_t(data_i, oid, offsets, nb: int, xt, dvec, b, dinv,
                       c1: float, c2: float, *, band=None):
    """One fused Chebyshev step on the packed band (K7); ``dvec=None`` is
    the first step.  ``offsets`` is the plan's int32 offset table on the
    band's device.  Returns (x', d') in ``xt``'s dtype."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(packed_cheb_step_t(
            data_i, oid, offsets, nb, *widen_bf16(xt, dvec, b, dinv), c1, c2,
            band=band), xt.dtype)
    if xt.device.type == "cpu":
        return packed_cheb_step_t_ref(data_i, oid, offsets, nb, xt, dvec, b,
                                      dinv, c1, c2)
    if band is None:
        band = packed_band(data_i, oid, offsets, nb)
    return _launch(band, xt, b, dvec, dinv, c1, c2)


def packed_residual_t(data_i, oid, offsets, nb: int, xt, b, *, band=None):
    """Fused r = b - A x on the packed band (K7)."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(packed_residual_t(
            data_i, oid, offsets, nb, *widen_bf16(xt, b), band=band), xt.dtype)
    if xt.device.type == "cpu":
        return packed_residual_t_ref(data_i, oid, offsets, nb, xt, b)
    if band is None:
        band = packed_band(data_i, oid, offsets, nb)
    return _launch(band, xt, b, step=False)


def banded_cheb_step_t_halo_ref(data_i, offsets, nb: int, x_ext, dvec, b,
                                dinv, c1: float, c2: float, *, tile: int):
    """Plain version of K2 halo's step; ``dvec=None`` is the first step."""
    r = b - banded_matvec_t_halo_ref(data_i, offsets, nb, x_ext, tile=tile)
    xt = x_ext[:, tile:tile + b.shape[-1]]
    return _cheb_update(r, xt, dvec, dinv, c1, c2)


def banded_residual_t_halo_ref(data_i, offsets, nb: int, x_ext, b, *,
                               tile: int):
    """Plain version of K2 halo's residual b - A x."""
    return b - banded_matvec_t_halo_ref(data_i, offsets, nb, x_ext,
                                        tile=tile)


def packed_cheb_step_t_halo_ref(data_i, oid, offsets, nb: int, x_ext, dvec,
                                b, dinv, c1: float, c2: float, *, tile: int):
    """Plain version of K7 halo's step (``b`` is b_eff where the pack has a
    far tail); ``dvec=None`` is the first step."""
    r = b - packed_matvec_t_halo_ref(data_i, oid, offsets, nb, x_ext,
                                     tile=tile)
    xt = x_ext[:, tile:tile + b.shape[-1]]
    return _cheb_update(r, xt, dvec, dinv, c1, c2)


def packed_residual_t_halo_ref(data_i, oid, offsets, nb: int, x_ext, b, *,
                               tile: int):
    """Plain version of K7 halo's residual b - A_near x."""
    return b - packed_matvec_t_halo_ref(data_i, oid, offsets, nb, x_ext,
                                        tile=tile)


def banded_cheb_step_t_halo(data_i, offsets, nb: int, x_ext, dvec, b, dinv,
                            c1: float, c2: float, *, tile: int, band=None):
    """One fused Chebyshev step on a shard's i-major slab (K2 halo);
    ``dvec=None`` is the first step.  Returns (x', d') [nb, per] in
    ``b``'s dtype."""
    if x_ext.dtype == torch.bfloat16:
        return narrow_to(banded_cheb_step_t_halo(
            data_i, offsets, nb, *widen_bf16(x_ext, dvec, b, dinv), c1, c2,
            tile=tile, band=band), b.dtype)
    if x_ext.device.type == "cpu":
        return banded_cheb_step_t_halo_ref(data_i, offsets, nb, x_ext, dvec,
                                           b, dinv, c1, c2, tile=tile)
    if band is None:
        band = imajor_band(data_i, offsets, nb)
    return _launch(band, x_ext, b, dvec, dinv, c1, c2, halo=tile)


def banded_residual_t_halo(data_i, offsets, nb: int, x_ext, b, *, tile: int,
                           band=None):
    """Fused r = b - A x on a shard's i-major slab (K2 halo)."""
    if x_ext.dtype == torch.bfloat16:
        return narrow_to(banded_residual_t_halo(
            data_i, offsets, nb, *widen_bf16(x_ext, b), tile=tile,
            band=band), b.dtype)
    if x_ext.device.type == "cpu":
        return banded_residual_t_halo_ref(data_i, offsets, nb, x_ext, b,
                                          tile=tile)
    if band is None:
        band = imajor_band(data_i, offsets, nb)
    return _launch(band, x_ext, b, step=False, halo=tile)


def packed_cheb_step_t_halo(data_i, oid, offsets, nb: int, x_ext, dvec, b,
                            dinv, c1: float, c2: float, *, tile: int,
                            band=None):
    """One fused Chebyshev step on a shard's packed slab (K7 halo).  With a
    far block-COO tail, ``b`` must be b_eff = b - A_far x: the kernel's
    product covers the slots only.  Returns (x', d') [nb, per]."""
    if x_ext.dtype == torch.bfloat16:
        return narrow_to(packed_cheb_step_t_halo(
            data_i, oid, offsets, nb, *widen_bf16(x_ext, dvec, b, dinv), c1,
            c2, tile=tile, band=band), b.dtype)
    if x_ext.device.type == "cpu":
        return packed_cheb_step_t_halo_ref(data_i, oid, offsets, nb, x_ext,
                                           dvec, b, dinv, c1, c2, tile=tile)
    if band is None:
        band = packed_band(data_i, oid, offsets, nb)
    return _launch(band, x_ext, b, dvec, dinv, c1, c2, halo=tile)


def packed_residual_t_halo(data_i, oid, offsets, nb: int, x_ext, b, *,
                           tile: int, band=None):
    """Fused r = b - A_near x on a shard's packed slab (K7 halo); the
    caller subtracts a far tail's A_far x."""
    if x_ext.dtype == torch.bfloat16:
        return narrow_to(packed_residual_t_halo(
            data_i, oid, offsets, nb, *widen_bf16(x_ext, b), tile=tile,
            band=band), b.dtype)
    if x_ext.device.type == "cpu":
        return packed_residual_t_halo_ref(data_i, oid, offsets, nb, x_ext, b,
                                          tile=tile)
    if band is None:
        band = packed_band(data_i, oid, offsets, nb)
    return _launch(band, x_ext, b, step=False, halo=tile)
