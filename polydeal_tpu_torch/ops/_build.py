"""Build and load the port's CUDA kernels (csrc/*.cu) as a plain C library.

``nvcc`` compiles every ``polydeal_tpu_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into
``polydeal_tpu_torch/_build/libpd_kernels_<hash>.so`` at first use; the
hash covers every source, every shared header (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged tree is
loaded as it is.  The library has a plain C interface
bound with ctypes: it builds in seconds, where a source that includes
PyTorch's headers takes minutes.

Also holds the launch counters: each kernel wrapper adds one to its
kernel's count where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

__all__ = ["load_library", "launches", "reset_launches", "last_build_log",
           "prepare_device", "stream_handle", "DTYPE_CODES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v"]

# dtype codes of the C interface (enum DType in csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

# launches per kernel since the last reset: K1 (csrc/banded_matvec.cu), K2
# (csrc/banded.cu), K0 and fused K0 (csrc/banded_omajor.cu), K3, K4, K5
# (csrc/sipg.cu) and K6, K7
# (csrc/packed.cu); the halo launches of K1, K2, K6 and K7 (on a shard's
# slab) count apart, and so do K6's and K6 halo's bf16-x launches (their
# own instantiation, csrc/packed_bf16.cu) and the launches of K1, K2 and
# their halo entries at an nb without a specialised build (``_any_nb``: the
# runtime-nb kernel, csrc/banded_any_nb.cu); set_condition
# (csrc/graph_loop.cu) counts the tests of a device loop's condition; the
# peer exchange kernels (csrc/peer.cu: put, all-gather's put, wait,
# reduce) count their launches on a sharded solve over several GPUs
launches = {"banded_matvec_imajor": 0, "banded_fused_cheb": 0,
            "banded_matvec_omajor": 0, "banded_fused_omajor": 0,
            "volume_blocks": 0, "face_group_blocks": 0,
            "boundary_blocks": 0, "packed_matvec": 0,
            "packed_fused_cheb": 0, "banded_matvec_halo": 0,
            "banded_fused_halo": 0, "packed_matvec_halo": 0,
            "packed_fused_halo": 0, "packed_matvec_bf16": 0,
            "packed_matvec_halo_bf16": 0, "banded_matvec_imajor_any_nb": 0,
            "banded_fused_cheb_any_nb": 0, "banded_matvec_halo_any_nb": 0,
            "banded_fused_halo_any_nb": 0, "set_condition": 0,
            "peer_put": 0, "peer_all_gather": 0, "peer_wait": 0,
            "peer_reduce": 0}

# the device loops' entries (csrc/graph_loop.cu): (argtypes, restype);
# graphs, nodes and executable graphs cross as pointers, a condition
# handle as an unsigned 64-bit integer
_vp, _i32, _u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
GRAPH_LOOP_ENTRIES = {
    "pd_cuda_error_name": ([_i32], ctypes.c_char_p),
    "pd_graph_create": ([_vp], _i32),
    "pd_graph_destroy": ([_vp], _i32),
    "pd_graph_condition": ([_vp, _vp], _i32),
    "pd_graph_add_child": ([_vp, _vp, _vp, _vp], _i32),
    "pd_graph_add_set_condition": ([_vp, _vp, _u64, _vp, _vp, _vp], _i32),
    "pd_graph_add_while": ([_vp, _vp, _u64, _vp, _vp], _i32),
    "pd_graph_instantiate": ([_vp, _vp], _i32),
    "pd_graph_launch": ([_vp, _vp], _i32),
    "pd_graph_exec_destroy": ([_vp], _i32),
}
# the peer exchange entries (csrc/peer.cu); sizes and offsets cross as
# 64-bit integers, host arrays of descriptors and pointers as pointers
_i64 = ctypes.c_longlong
PEER_ENTRIES = {
    "pd_peer_host_alloc": ([_i64, _vp, _vp], _i32),
    "pd_peer_host_free": ([_vp], _i32),
    "pd_peer_alloc": ([_i64, _vp], _i32),
    "pd_peer_free": ([_vp], _i32),
    "pd_peer_handle": ([_vp, _vp], _i32),
    "pd_peer_handle_bytes": ([], _i32),
    "pd_peer_open": ([_vp, _vp], _i32),
    "pd_peer_close": ([_vp], _i32),
    "pd_peer_put": ([_vp, _vp, _i32, _i32, _i64, _i32, _vp, _i32, _vp],
                    _i32),
    "pd_peer_all_gather": ([_vp, _vp, _i32, _i32, _i64, _vp, _i64, _vp],
                           _i32),
    "pd_peer_wait": ([_vp, _vp, _i32, _i32, _i64, _vp, _i32, _vp], _i32),
    "pd_peer_reduce": ([_vp, _vp, _i32, _i32, _i64, _i32, _vp, _i64, _i64,
                        _vp], _i32),
}

_lib = None
_log = ""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def last_build_log() -> str:
    """nvcc's output (ptxas register/spill report) of this process's
    build, or '' when the library was already built."""
    return _log


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build(srcs: list[str], so: str) -> str:
    """Compile each source in its own nvcc process, all at once, then
    link; returns nvcc's output.  Raises on any failure."""
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        outs, secs = [None] * len(procs), [0.0] * len(procs)

        def wait(k):  # each source's own seconds
            outs[k] = procs[k].communicate()[0]
            secs[k] = time.perf_counter() - t0

        waits = [threading.Thread(target=wait, args=(k,))
                 for k in range(len(procs))]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        log = "".join(f"== {os.path.basename(s)} ({t:.1f} s)\n{out}"
                      for s, t, out in zip(srcs, secs, outs))
        bad = [s for s, p in zip(srcs, procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"nvcc failed to build {bad}:\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {so}:\n{log}")
        os.replace(lib, so)  # atomic: concurrent builds race harmlessly
    return log


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _log
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs + _headers():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    so = os.path.join(_BUILD_DIR, f"libpd_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        _log = _build(srcs, so)
    lib = ctypes.CDLL(so)
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
    lib.pd_banded_matvec.argtypes = [vp, i32, vp, i32, vp, i32, i32, i32,
                                     i64, vp, vp]
    lib.pd_banded_fused.argtypes = [vp, i32, vp, i32, vp, i32, i32, i32, i64,
                                    vp, vp, vp, f64, f64, i32, vp, vp, vp]
    # K1's launch plan: (data, dtype, x, dtype, n_off, nb, P, ldx, halo, y,
    # long long[7] out)
    lib.pd_banded_matvec_plan.argtypes = [vp, i32, vp, i32, i32, i32, i64,
                                          i64, i64, vp, vp]
    # K0: as K1 without R_pad, the plan's path, threads and batch after P
    lib.pd_banded_matvec_omajor.argtypes = [vp, i32, vp, i32, vp, i32, i32,
                                            i64, i32, i32, i32, vp, vp]
    # fused K0: as K2 without R_pad, the plan after P
    lib.pd_banded_fused_omajor.argtypes = [vp, i32, vp, i32, vp, i32, i32,
                                           i64, i32, i32, i32, vp, vp, vp,
                                           f64, f64, i32, vp, vp, vp]
    # the empty kernel of K0's launch floor: (blocks, threads, stream)
    lib.pd_empty_kernel.argtypes = [i64, i32, vp]
    # the packed pair: as the banded one, with oid before the offsets and
    # K after n_off
    lib.pd_packed_matvec.argtypes = [vp, i32, vp, i32, vp, vp, i32, i32, i32,
                                     i32, i64, vp, vp]
    lib.pd_packed_fused.argtypes = [vp, i32, vp, i32, vp, vp, i32, i32, i32,
                                    i32, i64, vp, vp, vp, f64, f64, i32, vp,
                                    vp, vp]
    # the halo entries: as K1, K2, K6 and K7 with x's row stride ldx and
    # the halo width after P
    lib.pd_banded_matvec_halo.argtypes = [vp, i32, vp, i32, vp, i32, i32,
                                          i32, i64, i64, i64, vp, vp]
    lib.pd_banded_fused_halo.argtypes = [vp, i32, vp, i32, vp, i32, i32, i32,
                                         i64, i64, i64, vp, vp, vp, f64, f64,
                                         i32, vp, vp, vp]
    lib.pd_packed_matvec_halo.argtypes = [vp, i32, vp, i32, vp, vp, i32, i32,
                                          i32, i32, i64, i64, i64, vp, vp]
    lib.pd_packed_fused_halo.argtypes = [vp, i32, vp, i32, vp, vp, i32, i32,
                                         i32, i32, i64, i64, i64, vp, vp, vp,
                                         f64, f64, i32, vp, vp, vp]
    # (dtype, dim, degree, tables..., [offset,] [penalty,] C, Q, P, the
    #  launch plan (L, G, S, bytes of staged values, workspace), out,
    #  stream); the form's facts (dtype, dim, degree, kind, long long[4])
    plan = [i32, i32, i32, i64, vp]
    lib.pd_sipg_form_info.argtypes = [i32, i32, i32, i32, vp]
    lib.pd_sipg_volume.argtypes = [i32, i32, i32, vp, vp, vp, i32, i32, i64,
                                   *plan, vp, vp]
    lib.pd_sipg_boundary.argtypes = [i32, i32, i32, vp, vp, vp, vp, vp, f64,
                                     i32, i32, i64, *plan, vp, vp]
    lib.pd_sipg_face.argtypes = [i32, i32, i32, vp, vp, vp, vp, vp, vp, i64,
                                 f64, i32, i32, i64, *plan, vp, vp]
    for name, (args, res) in {**GRAPH_LOOP_ENTRIES, **PEER_ENTRIES}.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    for fn in (lib.pd_banded_matvec, lib.pd_banded_fused,
               lib.pd_banded_matvec_omajor, lib.pd_banded_fused_omajor,
               lib.pd_packed_matvec,
               lib.pd_packed_fused, lib.pd_sipg_volume, lib.pd_sipg_boundary,
               lib.pd_sipg_face, lib.pd_banded_matvec_halo,
               lib.pd_banded_fused_halo, lib.pd_packed_matvec_halo,
               lib.pd_packed_fused_halo, lib.pd_sipg_form_info,
               lib.pd_banded_matvec_plan, lib.pd_empty_kernel):
        fn.restype = i32
    _lib = lib
    return lib


def prepare_device(device) -> dict:
    """Seconds of what a CUDA device's first use costs, paid here so that
    no setup clock holds it: ``cuda_init`` (the context, and one tiny call
    each into cuBLAS and cuSOLVER) and ``kernel_load`` (building or
    loading this library).  On any other device both are 0.0 and nothing
    is loaded."""
    out = {"kernel_load": 0.0, "cuda_init": 0.0}
    dev = torch.device(device)
    if dev.type != "cuda":
        return out
    t0 = time.perf_counter()
    a = torch.eye(4, device=dev) + 1.0
    (a @ a).sum()  # cuBLAS
    torch.linalg.lu_factor(a)  # cuSOLVER
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    load_library()
    out.update(cuda_init=t1 - t0, kernel_load=time.perf_counter() - t1)
    return out


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a C pointer value.  The
    kernels launch on the current device, so ``device`` must be it: this
    raises rather than switch devices."""
    cur = torch._C._cuda_getDevice()
    if device.index != cur:
        raise RuntimeError(f"tensors on {device}, but the current device is "
                           f"cuda:{cur} (select it with torch.cuda.device)")
    return torch._C._cuda_getCurrentRawStream(cur)
