"""K3-K5: the SIPG assembly blocks of the banded direct assembly.

Counterpart of ``polydeal_tpu/ops/sipg_kernels.py`` (Pallas kernels
``_volume_impl``, ``_face_group_impl``, ``_boundary_impl``), with its entry
names.  On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/sipg.cu`` (and raises if it cannot); on a CPU tensor it runs the
plain PyTorch version beside it (``*_ref``), the einsums of the JAX
package's XLA branch, which compute the same function.

Inputs are the slot-padded, entity-last tables of
``assembly.sipg.build_banded_groups``: points and normals [C, q, dim, P],
weights [C, q, P], face diameters ``h_f`` [C, P], box extents ``ext_t`` and
origins ``lo_t`` [dim, P].  Padded slots carry zero weights, so they add
exact zeros.  Each block comes back as [nb * nb, P] (row i * nb + j), in
the tables' dtype.  The basis is the Legendre P_p basis of
``fem/basis.py`` (the only family ported).

:func:`sipg_launch_plan` decides how a kernel splits a level's work over
the card (lanes a block holds, point ranks G, blocks a lane S and the
workspace of the second pass).  It is pure: what it needs of a form (its
distinct entries, entry ranks, threads a block) it takes from
:func:`sipg_form`, which reads them from ``csrc/sipg.cu``; the kernel
checks the plan it is given.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from math import comb

import torch

from polydeal_tpu_torch.fem.basis import LegendreDGP
from polydeal_tpu_torch.ops import _build

__all__ = [
    "SipgForm", "sipg_form", "LaunchPlan", "sipg_launch_plan",
    "volume_blocks", "volume_blocks_ref",
    "face_group_blocks", "face_group_blocks_ref",
    "boundary_blocks", "boundary_blocks_ref",
]

_TABLE_DTYPES = (torch.float32, torch.float64)

# the plan gives this many blocks' threads points to sum (two blocks on
# each of the H100's 132 SMs) by point ranks; a level with fewer gets twice
# as many by blocks a lane (S), each rank keeping at least MIN_POINTS points
# and the second pass's workspace at most WORKSPACE_BYTES (so it stays in
# the 50 MB L2); these were chosen by timing the plans of the n = 64
# levels on an H100 (PERF.md).  At most STAGE_BYTES of point values are
# staged a block (p >= 2; the kernel sizes its chunk to them)
TARGET_BLOCKS = 2 * 132
MIN_POINTS = 4
WORKSPACE_BYTES = 8 << 20
# point ranks pay a sum through shared memory and the lane's set-up each;
# measured, that pays for K3 and K5 (10 entries at p = 1) and not for K4 (36),
# which takes more blocks a lane instead, unless the level has fewer lanes
# than a warp
RANKED_ENTRIES = 16
STAGE_BYTES = 96 * 1024
MAX_S = 65535  # gridDim.y
_KIND_CODES = {"volume": 0, "face": 1, "boundary": 2}


@dataclass(frozen=True)
class SipgForm:
    """What ``csrc/sipg.cu`` says of one form at one (dtype, dim, degree)
    (``pd_sipg_form_info``): its distinct entries, the entry ranks they
    split over, the threads of a block and the bytes of an element."""

    entries: int
    ranks: int
    threads: int
    esz: int


@functools.lru_cache(maxsize=None)
def sipg_form(kind: str, dim: int, degree: int, dtype) -> SipgForm:
    """The form of K3 (``kind`` "volume"), K4 ("face") or K5 ("boundary"),
    read from the kernel library."""
    if kind not in _KIND_CODES:
        raise ValueError(f"unknown SIPG kernel kind {kind!r}")
    info = (ctypes.c_longlong * 4)()
    rc = _build.load_library().pd_sipg_form_info(
        _build.DTYPE_CODES[dtype], dim, degree, _KIND_CODES[kind], info)
    if rc != 0:
        raise ValueError(f"no {kind} kernel built for {dtype}, dim={dim}, "
                         f"degree={degree}")
    return SipgForm(*info)


@dataclass(frozen=True)
class LaunchPlan:
    """How K3-K5 run one table of P lanes and N = C * Q points a lane.

    A block holds ``lanes`` lanes, ``ranks`` entry ranks (each accumulates
    its share of the ``entries`` distinct entries) and ``G`` point ranks;
    ``S`` blocks share a lane's points (S > 1 sums their partials in
    ``workspace`` [S, entries, P] by a second kernel)."""

    lanes: int
    ranks: int
    G: int
    S: int
    entries: int
    N: int
    P: int

    @property
    def workspace(self):
        """Shape of the second pass's workspace, or None (S = 1)."""
        return (self.S, self.entries, self.P) if self.S > 1 else None

    @property
    def grid(self):
        return (-(-self.P // self.lanes), self.S)

    def points(self, s: int, g: int) -> range:
        """The points that point rank ``g`` of block row ``s`` sums, as the
        kernel walks them."""
        n0, n1 = s * self.N // self.S, (s + 1) * self.N // self.S
        return range(n0 + g, n1, self.G)


def sipg_launch_plan(P: int, C: int, Q: int, form: SipgForm) -> LaunchPlan:
    """The launch plan of ``form`` (:func:`sipg_form`) for tables [C, Q, ...,
    P].

    Lanes run along a block's threads, at most threads / ranks and at least
    32 of them (fewer where the entry ranks leave less room, or where the
    level has fewer lanes: then a warp holds several point ranks).  Where
    the level has too few lanes to give TARGET_BLOCKS blocks' threads work,
    a lane's points go to more point ranks (fewer lanes a block; forms of
    at most RANKED_ENTRIES entries), and then to more blocks, while every
    rank keeps MIN_POINTS points and the workspace WORKSPACE_BYTES."""
    E, RE, T = form.entries, form.ranks, form.threads
    N = C * Q
    target = TARGET_BLOCKS * T
    lmax = T // RE
    lmin = min(32, lmax)
    if RE <= T // 32:  # a warp of L < 32 lanes holds one entry rank
        lmin = min(lmin, 1 << max(0, P - 1).bit_length())
    L = lmax
    while ((E <= RANKED_ENTRIES or P < 32) and L > lmin
           and P * RE * (lmax // L) < target
           and N >= MIN_POINTS * 2 * (lmax // L)):
        L //= 2
    G = lmax // L
    S = 1
    if P * RE * G < target:
        S = max(1, min(-(-2 * target // (P * RE * G)),
                       N // (G * MIN_POINTS),
                       WORKSPACE_BYTES // (E * P * form.esz), MAX_S))
    return LaunchPlan(lanes=L, ranks=RE, G=G, S=S, entries=E, N=N, P=P)


def _real_grad(basis, pts, ext):
    """Real gradients [C, q, nb, dim, P] at unit points [C, q, dim, P] in
    boxes of extents ``ext`` [dim, P]."""
    return basis.grad_t(pts) / ext[None, None, None]


def _blk(a, b, wgt):
    return torch.einsum("cqip,cqjp,cqp->ijp", a, b, wgt)


def volume_blocks_ref(vol: dict, ext_t: torch.Tensor, degree: int,
                      dim: int) -> torch.Tensor:
    """Plain version of K3: the stiffness block sum_c,q w grad phi_i .
    grad phi_j per lane."""
    G = _real_grad(LegendreDGP(dim, degree), vol["pts"], ext_t)
    K = torch.einsum("cqidp,cqjdp,cqp->ijp", G, G, vol["w"])
    return K.reshape(-1, K.shape[-1])


def face_group_blocks_ref(group: dict, ext_t: torch.Tensor,
                          lo_t: torch.Tensor, offset: int, degree: int,
                          dim: int, penalty_constant: float):
    """Plain version of K4: (m11, m12, m21, m22) of the face group between
    lanes p and p + offset.  The out-side unit points are the in-side
    physical points pulled back into the neighbour's box (its box
    parameters are lane rolls by -offset); wrapped lanes give finite points
    that vanish against zero weights."""
    basis = LegendreDGP(dim, degree)
    o = int(offset)
    lo_o = torch.roll(lo_t, -o, dims=1)
    ext_o = torch.roll(ext_t, -o, dims=1)
    pts0 = group["pts_in"]
    x = lo_t[None, None] + pts0 * ext_t[None, None]
    pts1 = (x - lo_o[None, None]) / ext_o[None, None]
    B0, B1 = basis.eval_t(pts0), basis.eval_t(pts1)
    n, w = group["n"], group["w"]
    gn0 = torch.einsum("cqidp,cqdp->cqip", _real_grad(basis, pts0, ext_t), n)
    gn1 = torch.einsum("cqidp,cqdp->cqip", _real_grad(basis, pts1, ext_o), n)
    wg = w * (penalty_constant / group["h_f"])[:, None, :]
    m11 = -0.5 * _blk(gn0, B0, w) - 0.5 * _blk(B0, gn0, w) + _blk(B0, B0, wg)
    m12 = 0.5 * _blk(gn0, B1, w) - 0.5 * _blk(B0, gn1, w) - _blk(B0, B1, wg)
    m21 = -0.5 * _blk(gn1, B0, w) + 0.5 * _blk(B1, gn0, w) - _blk(B1, B0, wg)
    m22 = 0.5 * _blk(gn1, B1, w) + 0.5 * _blk(B1, gn1, w) + _blk(B1, B1, wg)
    P = w.shape[-1]
    return tuple(m.reshape(-1, P) for m in (m11, m12, m21, m22))


def boundary_blocks_ref(group: dict, ext_t: torch.Tensor, degree: int,
                        dim: int, penalty_constant: float) -> torch.Tensor:
    """Plain version of K5: the Nitsche diagonal block sum w (-phi_i dn
    phi_j - dn phi_i phi_j + gamma phi_i phi_j), poly_utils.h:2065-2082."""
    basis = LegendreDGP(dim, degree)
    pts = group["pts_in"]
    B = basis.eval_t(pts)
    gn = torch.einsum("cqidp,cqdp->cqip", _real_grad(basis, pts, ext_t),
                      group["n"])
    w = group["w"]
    wg = w * (penalty_constant / group["h_f"])[:, None, :]
    M = -_blk(B, gn, w) - _blk(gn, B, w) + _blk(B, B, wg)
    return M.reshape(-1, M.shape[-1])


def _check(kernel: str, degree: int, dim: int, shaped: dict):
    """Validate what the CUDA kernels take: ``shaped`` maps an operand's
    name to (tensor, expected shape).  Returns the common dtype."""
    if dim not in (2, 3) or not 1 <= degree <= 3:
        raise ValueError(f"{kernel}: built for dim 2-3 and degree 1-3, "
                         f"not dim={dim}, degree={degree}")
    first = next(iter(shaped.values()))[0]
    dev, dt = first.device, first.dtype
    if dt not in _TABLE_DTYPES:
        raise TypeError(f"{kernel}: table dtype {dt} not supported (f32 or "
                        "f64)")
    for name, (t, shape) in shaped.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dt} on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return dt


def _on_card(kernel: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one (the kernel launches); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no {kernel} kernel for device {t.device}")
    return True


def _launch(kernel: str, fn, dev, *args) -> None:
    with torch.cuda.device(dev):
        rc = fn(*args, _build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {rc}")
    _build.launches[kernel] += 1


def _plan_args(kind: str, w: torch.Tensor, degree: int, dim: int):
    """(plan arguments of the C entry: L, G, S, bytes of staged values,
    workspace pointer; the workspace tensor, kept alive until the launch)
    for tables whose weights are ``w`` [C, Q, P]."""
    C, Q, P = w.shape
    pl = sipg_launch_plan(P, C, Q, sipg_form(kind, dim, degree, w.dtype))
    ws = (torch.empty(pl.workspace, dtype=w.dtype, device=w.device)
          if pl.workspace else None)
    return (pl.lanes, pl.G, pl.S, STAGE_BYTES,
            ws.data_ptr() if ws is not None else None), ws


def volume_blocks(vol: dict, ext_t: torch.Tensor, degree: int,
                  dim: int) -> torch.Tensor:
    """K3: stiffness diagonal blocks [nb * nb, P] over the padded volume
    group (``vol`` = {pts [C, q, dim, P], w [C, q, P]})."""
    w = vol["w"]
    if not _on_card("volume_blocks", w):
        return volume_blocks_ref(vol, ext_t, degree, dim)
    C, Q, P = w.shape
    dt = _check("volume_blocks", degree, dim, {
        "w": (w, (C, Q, P)), "pts": (vol["pts"], (C, Q, dim, P)),
        "ext_t": (ext_t, (dim, P))})
    nb = comb(degree + dim, dim)
    out = torch.empty((nb * nb, P), dtype=dt, device=w.device)
    plan, _ws = _plan_args("volume", w, degree, dim)
    lib = _build.load_library()
    _launch("volume_blocks", lib.pd_sipg_volume, w.device,
            _build.DTYPE_CODES[dt], dim, degree, vol["pts"].data_ptr(),
            w.data_ptr(), ext_t.data_ptr(), C, Q, P, *plan, out.data_ptr())
    return out


def face_group_blocks(group: dict, ext_t: torch.Tensor, lo_t: torch.Tensor,
                      offset: int, degree: int, dim: int,
                      penalty_constant: float):
    """K4: (m11, m12, m21, m22), each [nb * nb, P], of one face group
    (``group`` = {pts_in, n [C, q, dim, P], w [C, q, P], h_f [C, P]}) between
    lanes p and p + ``offset`` (> 0)."""
    w = group["w"]
    if not _on_card("face_group_blocks", w):
        return face_group_blocks_ref(group, ext_t, lo_t, offset, degree, dim,
                                     penalty_constant)
    C, Q, P = w.shape
    if not 0 < int(offset) < P:
        raise ValueError(f"face_group_blocks: offset {offset} outside "
                         f"(0, {P})")
    dt = _check("face_group_blocks", degree, dim, {
        "w": (w, (C, Q, P)), "pts_in": (group["pts_in"], (C, Q, dim, P)),
        "n": (group["n"], (C, Q, dim, P)), "h_f": (group["h_f"], (C, P)),
        "ext_t": (ext_t, (dim, P)), "lo_t": (lo_t, (dim, P))})
    nb = comb(degree + dim, dim)
    out = torch.empty((4, nb * nb, P), dtype=dt, device=w.device)
    plan, _ws = _plan_args("face", w, degree, dim)
    lib = _build.load_library()
    _launch("face_group_blocks", lib.pd_sipg_face, w.device,
            _build.DTYPE_CODES[dt], dim, degree, group["pts_in"].data_ptr(),
            group["n"].data_ptr(), w.data_ptr(), group["h_f"].data_ptr(),
            ext_t.data_ptr(), lo_t.data_ptr(), int(offset),
            float(penalty_constant), C, Q, P, *plan, out.data_ptr())
    return tuple(out.unbind(0))


def boundary_blocks(group: dict, ext_t: torch.Tensor, degree: int, dim: int,
                    penalty_constant: float) -> torch.Tensor:
    """K5: boundary Nitsche diagonal blocks [nb * nb, P] over the padded
    Dirichlet face group (keys as for :func:`face_group_blocks`)."""
    w = group["w"]
    if not _on_card("boundary_blocks", w):
        return boundary_blocks_ref(group, ext_t, degree, dim,
                                   penalty_constant)
    C, Q, P = w.shape
    dt = _check("boundary_blocks", degree, dim, {
        "w": (w, (C, Q, P)), "pts_in": (group["pts_in"], (C, Q, dim, P)),
        "n": (group["n"], (C, Q, dim, P)), "h_f": (group["h_f"], (C, P)),
        "ext_t": (ext_t, (dim, P))})
    nb = comb(degree + dim, dim)
    out = torch.empty((nb * nb, P), dtype=dt, device=w.device)
    plan, _ws = _plan_args("boundary", w, degree, dim)
    lib = _build.load_library()
    _launch("boundary_blocks", lib.pd_sipg_boundary, w.device,
            _build.DTYPE_CODES[dt], dim, degree, group["pts_in"].data_ptr(),
            group["n"].data_ptr(), w.data_ptr(), group["h_f"].data_ptr(),
            ext_t.data_ptr(), float(penalty_constant), C, Q, P, *plan,
            out.data_ptr())
    return out
