"""K1: the i-major banded block SpMV, the hot op of CG and of the
eigenvalue estimates; K0: the same product over the o-major band.

K1 is the counterpart of ``polydeal_tpu/ops/banded.py``
``banded_matvec_t_imajor`` (Pallas kernel ``_banded_matvec_imajor_impl``),
K0 of ``banded_matvec_t_pallas`` (Pallas kernel ``_banded_matvec_impl``),
and K1 halo (:func:`banded_matvec_t_halo`) of ``banded_matvec_t_halo``:
K1 on one shard's lane slab, x read from ``x_ext`` [nb, per + 2T], whose T
lanes on each side are the neighbouring shards' (``parallel/banded.py``).
On a CUDA tensor each wrapper launches its hand-written kernel
(K1 and K1 halo ``csrc/banded_matvec.cu``, at an nb outside
:data:`KERNEL_NB` its runtime-nb kernel ``csrc/banded_any_nb.cu``; K0
``csrc/banded_omajor.cu``; it raises if it cannot); on a CPU tensor it
runs its plain PyTorch version (``*_ref``), which computes the same
function.  K1 runs by a launch plan (lanes a thread W, offset groups a
block S) that the library chooses; :func:`k1_plan` reports it.  K0's plan
(its path, threads a block, the loads a batch) is :func:`omajor_plan`,
kept on the band's :class:`KernelBand` and passed with every launch; the
library refuses a plan it cannot run.

bf16 vectors: K1, K0 and K1 halo take them through an explicit cast to
f32 before the launch and back to bf16 after it (:func:`widen_bf16`,
:func:`narrow_to`), where the JAX package's wrappers cast around their
Pallas calls (``polydeal_tpu/ops/banded.py:158-169``, ``:251-254``,
``:287-291``); the launch still happens and counts.  The packed product
K6 alone reads bf16 x in the kernel (``ops/packed.py``).

Layout contracts (shared with the JAX package): K1 takes ``data_i``
[nb * R_pad, P] with rows ordered (i, k, j) and R_pad >= n_off * nb
(padding rows are never read) and any nb >= 1; K0 takes
``data`` [n_off, nb, nb, P]; both take ``xt`` [nb, P], and x reads zero
outside [0, P).

The launch path: a band's unchanging arguments are validated once into a
:class:`KernelBand`, which ``BlockBanded`` and ``BlockPacked`` keep and pass
as ``band=``, so a launch checks only its vectors.  Kernels launch on the
current device's current stream; a tensor on another device raises (no
device switch).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from polydeal_tpu_torch.ops import _build

__all__ = ["banded_matvec_t_imajor", "banded_matvec_t_imajor_ref",
           "banded_matvec_t_omajor", "banded_matvec_t_omajor_ref",
           "banded_matvec_t_halo", "banded_matvec_t_halo_ref",
           "KernelBand", "imajor_band", "omajor_band", "band_layout",
           "launch_band", "launch_product", "halo_check", "KERNEL_NB",
           "K1Plan", "k1_plan", "any_nb_plan", "K0_NB", "K0Plan",
           "omajor_plan", "widen_bf16", "narrow_to"]

_VEC_DTYPES = (torch.float32, torch.float64)
# the offsets K0's entries accept: 48 KB of int32 (no band comes near it)
_MAX_OFFSETS = 48 * 1024 // 4
# the block sizes K1 and K2 have a specialised build for (PD_NB_DISPATCH,
# csrc/banded_common.cuh): (p + dim choose dim) for dim 2-3, p 1-3.  Any
# other nb runs their runtime-nb build (csrc/banded_any_nb.cu), whose
# launches count apart (``_any_nb`` counters)
KERNEL_NB = (3, 4, 6, 10, 20)


def widen_bf16(*vecs):
    """The vectors with every bf16 one cast to f32 (None passes): what the
    JAX package's wrappers hand their Pallas kernels for bf16 x, b, d and
    dinv."""
    return tuple(v.to(torch.float32)
                 if v is not None and v.dtype == torch.bfloat16 else v
                 for v in vecs)


def narrow_to(out, dtype):
    """A result (a tensor or a tuple of them) cast to ``dtype``: bf16
    vectors get their bf16 result back after an f32 launch."""
    if isinstance(out, tuple):
        return tuple(o.to(dtype) for o in out)
    return out.to(dtype)


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


class KernelBand:
    """A band's unchanging launch arguments, validated once: the band's
    pointer and dtype code, the C entry's band arguments (offset table,
    n_off, nb, ...), P and the device.  Made by :func:`imajor_band`,
    :func:`omajor_band` or ``ops/packed.packed_band``; a ``BlockBanded`` or
    ``BlockPacked`` keeps its own from its first launch, so a launch checks
    only its vectors (:meth:`vec_code`).

    ``layout`` names the C entries and launch counters (``_ENTRIES``);
    ``offsets`` is the int32 offset table and ``keep`` any other tensor
    whose pointer ``args`` carries; ``max_off`` is the largest |offset|,
    read from ``offsets`` at the first halo launch; ``plan`` K0's launch
    plan (:func:`omajor_plan`) on an o-major band."""

    __slots__ = ("layout", "dtype", "nb", "P", "device", "head", "args",
                 "offsets", "keep", "n_off", "R_pad", "max_off", "plan")

    def __init__(self, layout, data, nb, P, n_off, R_pad, args, offsets,
                 keep=(), plan=None):
        self.layout, self.dtype, self.nb, self.P = layout, data.dtype, nb, P
        self.device = data.device
        self.head = (data.data_ptr(), _build.DTYPE_CODES[data.dtype])
        self.n_off, self.R_pad, self.args = n_off, R_pad, args
        self.offsets, self.keep, self.plan = offsets, keep, plan
        self.max_off = None

    def vec_code(self, vecs, ldx: int | None = None,
                 bf16: bool = False) -> int:
        """Check one launch's vectors -- one f32 or f64 dtype (f64 for an
        f64 band; with ``bf16``, K6's product, also bf16 on an f32 or bf16
        band, and a bf16 band only with bf16 vectors), [nb, P] (the first
        [nb, ldx] where ``ldx`` is given: a halo launch's x_ext),
        contiguous, on the band's device -- and return their dtype code."""
        vdt = vecs[0].dtype
        if vdt not in _VEC_DTYPES + ((torch.bfloat16,) if bf16 else ()):
            raise TypeError(f"vector dtype {vdt} not supported (f32 or f64"
                            f"{', or bf16' if bf16 else ''})")
        if self.dtype == torch.float64 and vdt != torch.float64:
            raise TypeError("f64 band needs f64 vectors")
        if (self.layout == "packed" and self.dtype == torch.bfloat16
                and vdt != torch.bfloat16):
            raise TypeError("a bf16 pack needs bf16 vectors (K6 only)")
        for n, v in enumerate(vecs):
            width = ldx if n == 0 and ldx is not None else self.P
            if v.device != self.device:
                raise ValueError(f"tensor on {v.device}, band on "
                                 f"{self.device}")
            if not v.is_contiguous():
                raise ValueError("kernel operands must be contiguous")
            if v.shape != (self.nb, width) or v.dtype != vdt:
                raise ValueError(f"vector {tuple(v.shape)} {v.dtype} is not "
                                 f"[{self.nb}, {width}] {vdt}")
        return _build.DTYPE_CODES[vdt]


# per layout, (C entry, launch counter, kernel) of the product and of the
# fused Chebyshev step / residual
_ENTRIES = {
    "imajor": (("pd_banded_matvec", "banded_matvec_imajor", "K1"),
               ("pd_banded_fused", "banded_fused_cheb", "K2")),
    "omajor": (("pd_banded_matvec_omajor", "banded_matvec_omajor", "K0"),
               ("pd_banded_fused_omajor", "banded_fused_omajor",
                "fused K0")),
    "packed": (("pd_packed_matvec", "packed_matvec", "K6"),
               ("pd_packed_fused", "packed_fused_cheb", "K7")),
}
# the same on a shard's slab (x_ext [nb, P + 2T]): K1, K2, K6 and K7 halo
_HALO_ENTRIES = {
    "imajor": (("pd_banded_matvec_halo", "banded_matvec_halo", "K1 halo"),
               ("pd_banded_fused_halo", "banded_fused_halo", "K2 halo")),
    "packed": (("pd_packed_matvec_halo", "packed_matvec_halo", "K6 halo"),
               ("pd_packed_fused_halo", "packed_fused_halo", "K7 halo")),
}


def band_layout(data_i, offsets, nb, n_slots=None) -> tuple[int, int, int]:
    """Validate a band [nb * R_pad, P] of ``n_slots`` row blocks per i-slab
    (default: one per offset; the packed format's K) and its int32 offset
    table: a supported dtype, on one device, contiguous.  Returns (n_off,
    R_pad, P)."""
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
    for t in (data_i, offsets):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, band on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return n_off, R_pad, P


def imajor_band(data_i, offsets, nb) -> KernelBand:
    """Validate an i-major band [nb * R_pad, P] for K1/K2
    (:func:`band_layout`; any nb >= 1)."""
    n_off, R_pad, P = band_layout(data_i, offsets, nb)
    return KernelBand("imajor", data_i, nb, P, n_off, R_pad,
                      (offsets.data_ptr(), n_off, nb, R_pad, P), offsets)


def check_kernel_args(data_i, offsets, nb, vecs):
    """Validate what K1/K2 take (:func:`imajor_band`, then the vectors);
    returns (n_off, R_pad, P)."""
    band = imajor_band(data_i, offsets, nb)
    band.vec_code(vecs)
    return band.n_off, band.R_pad, band.P


def halo_check(offsets, P: int, x_ext: torch.Tensor, tile: int,
               band: KernelBand | None = None) -> None:
    """Refuse what a halo product cannot compute, as the JAX package's
    ``_halo`` entry points do: ``x_ext`` not P + 2 ``tile`` lanes wide, or
    an offset beyond the halo (|o| > tile: a far offset on a shard).  The
    largest |offset| is read once into ``band``'s ``max_off`` where a band
    is given."""
    if x_ext.shape[-1] != P + 2 * tile:
        raise ValueError(f"x_ext has {x_ext.shape[-1]} lanes, not per + 2T "
                         f"= {P} + 2*{tile}")
    m = None if band is None else band.max_off
    if m is None:
        m = max([abs(o) for o in _host_offsets(offsets)] + [0])
        if band is not None:
            band.max_off = m
    if m > tile:
        raise ValueError(f"offset {m} beyond the halo width T={tile} (a far "
                         f"offset on a shard)")


class K1Plan(NamedTuple):
    """How K1 runs one launch (``k1_plan``): W lanes a thread, S offset
    groups a block (S > 1: the groups' partial sums meet in ``smem`` bytes
    of shared memory), ``threads`` a block, ``blocks`` blocks, ``rows``
    output rows a thread (nb in a specialised build, a chunk of R rows in
    the runtime-nb one, :func:`any_nb_plan`) and ``chunks`` row chunks a
    block (1 in a specialised build)."""

    W: int
    S: int
    threads: int
    blocks: int
    smem: int
    rows: int
    chunks: int


# csrc/banded_any_nb.cu's plan constants: threads a block, offset groups
# at most, the threads below which a launch takes offset groups, and those
# an f32 band with f32 vectors keeps at 8 rows a thread
ANY_NB_THREADS = 256
ANY_NB_MAX_GROUPS = 4
ANY_NB_FILL_THREADS = 32768
ANY_NB_MANY_THREADS = 40960


def _wide_lanes(data_esz: int, vec_esz: int, rows: int) -> int:
    """Lanes a thread of the wide path (``wide_lanes``,
    csrc/banded_common.cuh): one 16-byte band load a row, halved while the
    rows' accumulators would outgrow 384 bytes."""
    w = 16 // data_esz
    while w > 1 and rows * w * vec_esz > 96 * 4:
        w //= 2
    return w


def any_nb_plan(nb: int, n_off: int, P: int, data_dtype, vec_dtype,
                ldx: int | None = None, halo: int = 0,
                aligned: bool = True) -> K1Plan:
    """The plan of K1 and K2's runtime-nb build (``plan_of``,
    csrc/banded_any_nb.cu), stated in Python: R rows a thread, 4 for a
    bf16 band or f64 vectors; for an f32 band with f32 vectors 8 where the
    launch then has ANY_NB_MANY_THREADS threads, else 2; at most nb; W
    lanes a thread where P, ldx and halo allow it and the operands are
    ``aligned``; S offset groups doubling, to 4 at most and while 2 S <=
    n_off, while the launch has fewer than ANY_NB_FILL_THREADS threads
    (S times the P / W lanes-threads times the nb / R row chunks); CB = 2
    row chunks a block where there are two.  ``pd_banded_matvec_plan``
    reports the library's (:func:`k1_plan`)."""
    ldx = P if ldx is None else ldx
    desz = torch.empty((), dtype=data_dtype).element_size()
    vesz = torch.empty((), dtype=vec_dtype).element_size()
    cdiv = lambda a, b: -(-a // b)
    def lanes_w(R):
        w = _wide_lanes(desz, vesz, R)
        fits = w > 1 and aligned and P % w == ldx % w == halo % w == 0
        return w if fits else 1

    f32 = desz == vesz == 4
    R = 2 if f32 else 4
    if f32 and nb >= 8 and (cdiv(P, lanes_w(8)) * cdiv(nb, 8)
                            >= ANY_NB_MANY_THREADS):
        R = 8
    while R > nb:
        R //= 2
    W = lanes_w(R)
    lanes, chunks = cdiv(P, W), cdiv(nb, R)
    S = 1
    while (S < ANY_NB_MAX_GROUPS and 2 * S <= n_off
           and lanes * chunks * S < ANY_NB_FILL_THREADS):
        S *= 2
    CB = 2 if chunks >= 2 else 1
    Lt = ANY_NB_THREADS // (CB * S)
    return K1Plan(W=W, S=S, threads=ANY_NB_THREADS,
                  blocks=cdiv(lanes, Lt) * cdiv(chunks, CB),
                  smem=ANY_NB_THREADS * (S - 1) // S * R * W * vesz, rows=R,
                  chunks=CB)


def k1_plan(band: KernelBand, x: torch.Tensor,
            halo: int | None = None) -> K1Plan:
    """The plan K1 (``halo=T``: K1 halo, ``x`` the slab's x_ext) takes for
    ``band`` and ``x``, as the library's plan function chooses it for the
    launch (``pd_banded_matvec_plan``; a fresh output, aligned).  Needs
    the kernel library, so a card."""
    ldx = band.P if halo is None else band.P + 2 * halo
    out = (ctypes.c_longlong * 7)()
    rc = _build.load_library().pd_banded_matvec_plan(
        band.head[0], band.head[1], x.data_ptr(), _build.DTYPE_CODES[x.dtype],
        band.n_off, band.nb, band.P, ldx, halo or 0, None, out)
    if rc != 0:
        raise ValueError(f"no K1 plan for nb={band.nb}, {band.dtype} band, "
                         f"{x.dtype} vectors: {rc}")
    return K1Plan(*out)


def launch_band(band: KernelBand, fused: bool, vecs, tail,
                halo: int | None = None):
    """Launch the band's product (``fused=False``) or fused entry with the
    vector pointers and scalars ``tail`` after its band arguments; raises
    if the launch fails, counts it if not.  ``halo=T`` launches the halo
    entry, ``vecs[0]`` being the slab's x_ext [nb, P + 2T]."""
    entries = _ENTRIES if halo is None else _HALO_ENTRIES
    entry, counter, name = entries[band.layout][fused]
    if band.device.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {band.device}")
    extra = ()
    if halo is not None:
        halo_check(band.offsets, band.P, vecs[0], halo, band)
        extra = (band.P + 2 * halo, halo)
    # K6 (and K6 halo) reads bf16 x in the kernel
    vcode = band.vec_code(vecs, None if halo is None else extra[0],
                          bf16=band.layout == "packed" and not fused)
    lib = _build.load_library()
    rc = getattr(lib, entry)(*band.head, vecs[0].data_ptr(), vcode,
                             *band.args, *extra, *tail,
                             _build.stream_handle(band.device))
    if rc != 0:
        raise RuntimeError(f"{name} ({entry}) launch failed: {rc}")
    if vecs[0].dtype == torch.bfloat16:
        counter += "_bf16"  # K6's bf16-x instantiation counts apart
    elif band.layout == "imajor" and band.nb not in KERNEL_NB:
        counter += "_any_nb"  # K1/K2's runtime-nb build counts apart
    _build.launches[counter] += 1


def launch_product(band: KernelBand, xt: torch.Tensor,
                   halo: int | None = None) -> torch.Tensor:
    """y = A x through the band's product kernel (K1, K0 or K6; with
    ``halo=T`` K1 or K6 halo on the slab's x_ext)."""
    y = torch.empty((band.nb, band.P), dtype=xt.dtype, device=xt.device)
    launch_band(band, False, (xt,), (y.data_ptr(),), halo)
    return y


def banded_matvec_t_imajor(data_i: torch.Tensor, offsets, nb: int,
                           xt: torch.Tensor, *,
                           band: KernelBand | None = None) -> torch.Tensor:
    """y[i, p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j, p+off_k].

    ``offsets`` is an int32 tensor on the band's device (read by the
    kernel on the device); ``band`` this band's :func:`imajor_band`, if
    the caller keeps one.  Returns y [nb, P] in ``xt``'s dtype (bf16 x
    is cast to f32 for the launch and y back to bf16)."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(banded_matvec_t_imajor(
            data_i, offsets, nb, *widen_bf16(xt), band=band), xt.dtype)
    if xt.device.type == "cpu":
        return banded_matvec_t_imajor_ref(data_i, offsets, nb, xt)
    if band is None:
        band = imajor_band(data_i, offsets, nb)
    return launch_product(band, xt)


# K0's builds (csrc/banded_omajor.cu): the nb with a build of their own,
# registers of loaded values a batch and offsets a batch at most (the
# build's batch, kBatchRegs and kMaxBatch), threads a block at most and at
# least (kMaxThreads, kMinThreads); and K0's plan: the blocks below which
# a launch halves its blocks (two an SM on 132 SMs), the outputs nb * P
# from which a launch is bound by bytes and takes the loop, and the loop's
# threads a block
K0_NB = (3, 4, 6, 8, 12, 15, 21)
K0_BATCH_REGS = 128
K0_MAX_BATCH = 8
K0_MAX_THREADS = 128
K0_MIN_THREADS = 32
K0_FILL_BLOCKS = 264
K0_WIDE_OUTPUTS = 49152
K0_LOOP_THREADS = 128
# the paths a thread walks its sum by (enum Path)
K0_LOOP, K0_BATCHED = 0, 1


class K0Plan(NamedTuple):
    """How K0 (plain or fused) runs a band: ``build`` the nb of its
    specialised build (0: the runtime-nb build), ``path`` how a thread
    walks its sum (K0_LOOP, K0_BATCHED), ``threads`` (lanes) a block,
    ``blocks`` (lane blocks times nb: one output a thread) and ``batch``,
    the offsets whose loads a batch issues together (1 for the loop).
    Every launch passes path, threads and batch; the library returns -2
    for a plan it cannot run."""

    build: int
    path: int
    threads: int
    blocks: int
    batch: int


def omajor_plan(nb: int, P: int, data_dtype) -> K0Plan:
    """K0's plan, which every launch of csrc/banded_omajor.cu passes: at
    nb in :data:`K0_NB` below K0_WIDE_OUTPUTS outputs nb * P, nb's own
    build on the BATCHED path, batches of K0_BATCH_REGS registers of
    loaded (band entry, x value) pairs (4 registers a pair for an f64
    band, 2 otherwise; 1 to K0_MAX_BATCH offsets), K0_MAX_THREADS lanes a
    block, halved down to K0_MIN_THREADS while the grid has fewer than
    K0_FILL_BLOCKS blocks; else the runtime-nb LOOP, K0_LOOP_THREADS lanes
    a block."""
    if nb < 1:
        raise ValueError(f"nb={nb} < 1")
    cdiv = lambda a, b: -(-a // b)
    if nb in K0_NB and nb * P < K0_WIDE_OUTPUTS:
        pair = 4 if data_dtype == torch.float64 else 2
        batch = min(max(K0_BATCH_REGS // (nb * pair), 1), K0_MAX_BATCH)
        threads = K0_MAX_THREADS
        while (threads > K0_MIN_THREADS
               and cdiv(P, threads) * nb < K0_FILL_BLOCKS):
            threads //= 2
        return K0Plan(build=nb, path=K0_BATCHED, threads=threads,
                      blocks=cdiv(P, threads) * nb, batch=batch)
    return K0Plan(build=0, path=K0_LOOP, threads=K0_LOOP_THREADS,
                  blocks=cdiv(P, K0_LOOP_THREADS) * nb, batch=1)


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


def omajor_band(data, offsets) -> KernelBand:
    """Validate an o-major band [n_off, nb, nb, P] for K0 (plain or
    fused), as :func:`imajor_band` does for K1/K2."""
    if data.dim() != 4 or data.shape[1] != data.shape[2]:
        raise ValueError(f"data {tuple(data.shape)} is not [n_off, nb, nb, "
                         f"P]")
    if not data.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    n_off, nb, _, P = data.shape
    # the o-major band viewed as n_off * nb rows per i-slab
    band_layout(data.view(nb * n_off * nb, P), offsets, nb)
    if offsets.numel() != n_off:
        raise ValueError(f"{offsets.numel()} offsets for {n_off} band rows")
    if n_off > _MAX_OFFSETS:
        raise ValueError(f"{n_off} offsets exceed the {_MAX_OFFSETS} K0 "
                         f"takes")
    plan = omajor_plan(nb, P, data.dtype)
    return KernelBand("omajor", data, nb, P, n_off, n_off * nb,
                      (offsets.data_ptr(), n_off, nb, P, plan.path,
                       plan.threads, plan.batch), offsets, plan=plan)


def check_omajor_args(data, offsets, xt):
    """Validate what K0 takes (:func:`omajor_band`, then x); returns
    (n_off, nb, P)."""
    band = omajor_band(data, offsets)
    band.vec_code((xt,))
    return band.n_off, band.nb, band.P


def banded_matvec_t_omajor(data: torch.Tensor, offsets, xt: torch.Tensor,
                           *, band: KernelBand | None = None
                           ) -> torch.Tensor:
    """y[i, p] = sum_o sum_j data[o, i, j, p] * x[j, p + offsets[o]] (K0).

    ``data`` [n_off, nb, nb, P] bf16, f32 or f64, contiguous; ``offsets``
    the band's int32 device table (``BlockBanded.offsets_t``); ``xt``
    [nb, P] bf16, f32 or f64; ``band`` this band's :func:`omajor_band`, if
    the caller keeps one.  Accumulates in f64 for f64 data, in f32 otherwise;
    returns y [nb, P] in ``xt``'s dtype (bf16 x is cast to f32 for the
    launch and y back to bf16)."""
    if xt.dtype == torch.bfloat16:
        return narrow_to(banded_matvec_t_omajor(
            data, offsets, *widen_bf16(xt), band=band), xt.dtype)
    if xt.device.type == "cpu":
        return banded_matvec_t_omajor_ref(data, offsets, xt)
    if band is None:
        band = omajor_band(data, offsets)
    return launch_product(band, xt)


def banded_matvec_t_halo_ref(data_i: torch.Tensor, offsets, nb: int,
                             x_ext: torch.Tensor, *, tile: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of K1 halo, accumulating in ``x_ext``'s dtype:
    offset o reads the window x_ext[:, T + o : T + o + per] (no padding)."""
    P = data_i.shape[1]
    halo_check(offsets, P, x_ext, tile)
    offs = _host_offsets(offsets)
    n_off = len(offs)
    R_pad = data_i.shape[0] // nb
    acc = x_ext.dtype
    D = (data_i.reshape(nb, R_pad, P)[:, :n_off * nb]
         .reshape(nb, n_off, nb, P).to(acc))
    Xg = torch.stack([x_ext[:, tile + o:tile + o + P] for o in offs])
    return torch.einsum("ikjp,kjp->ip", D, Xg.to(acc))


def banded_matvec_t_halo(data_i: torch.Tensor, offsets, nb: int,
                         x_ext: torch.Tensor, *, tile: int,
                         band: KernelBand | None = None) -> torch.Tensor:
    """K1 on one shard's lane slab: y[i, p] = sum_k sum_j
    data_i[i*R_pad + k*nb + j, p] * x_ext[j, T + p + off_k], p in [0, per).

    ``x_ext`` [nb, per + 2T] carries the neighbouring shards' T lanes on
    each side; ``tile`` is T, and every |offset| must be <= T (raises
    otherwise, and on a wrong ``x_ext`` width).  ``band`` is the slab's
    :func:`imajor_band`, if the caller keeps one.  Returns y [nb, per] in
    ``x_ext``'s dtype (bf16 x_ext is cast to f32 for the launch and y back
    to bf16)."""
    if x_ext.dtype == torch.bfloat16:
        return narrow_to(banded_matvec_t_halo(
            data_i, offsets, nb, *widen_bf16(x_ext), tile=tile, band=band),
            x_ext.dtype)
    if x_ext.device.type == "cpu":
        return banded_matvec_t_halo_ref(data_i, offsets, nb, x_ext, tile=tile)
    if band is None:
        band = imajor_band(data_i, offsets, nb)
    return launch_product(band, x_ext, halo=tile)
