"""Build and load the port's CUDA kernels (csrc/*.cu) as a plain C library.

``nvcc`` compiles ``polydeal_tpu_torch/csrc/banded.cu`` for ``sm_90a`` into
``polydeal_tpu_torch/_build/libpd_banded_<hash>.so`` at first use; the
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  The library has a plain C interface
bound with ctypes: it builds in seconds, where a source that includes
PyTorch's headers takes minutes.

Also holds the launch counters: each kernel wrapper adds one to its
kernel's count where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

__all__ = ["load_library", "launches", "reset_launches", "last_build_log",
           "stream_handle", "DTYPE_CODES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "banded.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C interface (enum DType in csrc/banded.cu)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

# launches per kernel since the last reset (K1, K2 of csrc/banded.cu)
launches = {"banded_matvec_imajor": 0, "banded_fused_cheb": 0}

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


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _log
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libpd_banded_{key}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        _log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {_SRC}:\n{_log}")
        os.replace(tmp, so)  # atomic: concurrent builders race harmlessly
    lib = ctypes.CDLL(so)
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
    lib.pd_banded_matvec.argtypes = [vp, i32, vp, i32, vp, i32, i32, i32,
                                     i64, vp, vp]
    lib.pd_banded_matvec.restype = i32
    lib.pd_banded_fused.argtypes = [vp, i32, vp, i32, vp, i32, i32, i32, i64,
                                    vp, vp, vp, f64, f64, i32, vp, vp, vp]
    lib.pd_banded_fused.restype = i32
    _lib = lib
    return lib


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a C pointer value."""
    return torch.cuda.current_stream(device).cuda_stream
