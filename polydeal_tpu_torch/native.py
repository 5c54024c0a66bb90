"""ctypes bindings to the native host library (csrc/libpolydeal_host.so).

Builds on demand with ``make -C csrc`` if the shared object is missing and
a toolchain is available; every entry point has a pure-numpy fallback, so
the framework works without the native library (just slower host setup on
very large meshes).

Port note: a jax-free copy of ``polydeal_tpu/native.py``.  Every module of
the JAX package imports jax at load time, so the port cannot import
it where jax is absent.  Only imports differ;
tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

# the repo root: the host library lives in the ROOT csrc/ (shared with the
# JAX package), not in polydeal_tpu_torch/csrc/, which holds the CUDA sources
_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_HERE, "csrc", "libpolydeal_host.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_HERE, "csrc")],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.pd_face_neighbors.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int32,
        ctypes.c_int32, i64p,
    ]
    lib.pd_face_neighbors.restype = ctypes.c_int
    lib.pd_connected_components.argtypes = [
        i32p, i64p, ctypes.c_int64, ctypes.c_int32, i32p,
    ]
    lib.pd_connected_components.restype = ctypes.c_int
    lib.pd_greedy_partition.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p,
    ]
    lib.pd_greedy_partition.restype = ctypes.c_int
    lib.pd_str_tile.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p,
    ]
    lib.pd_str_tile.restype = ctypes.c_int
    lib.pd_str_leaf_order.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p,
    ]
    lib.pd_str_leaf_order.restype = ctypes.c_int
    if hasattr(lib, "pd_sa_aggregate"):  # stale .so without the symbol
        lib.pd_sa_aggregate.argtypes = [i64p, i64p, ctypes.c_int64, i32p]
        lib.pd_sa_aggregate.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def face_neighbors(cells: np.ndarray, face_vertices: np.ndarray):
    """[n_cells, 2*dim] neighbor matching, or None if lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    fv = np.ascontiguousarray(face_vertices, dtype=np.int32)
    n_cells, nv_cell = cells.shape
    nfc, nv_face = fv.shape
    out = np.empty(n_cells * nfc, dtype=np.int64)
    rc = lib.pd_face_neighbors(cells, n_cells, nv_cell, fv, nfc, nv_face, out)
    if rc != 0:
        return None
    return out.reshape(n_cells, nfc)


def connected_components_labels(labels: np.ndarray, neighbors: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    neighbors = np.ascontiguousarray(neighbors, dtype=np.int64)
    n, nf = neighbors.shape
    out = np.empty(n, dtype=np.int32)
    lib.pd_connected_components(labels, neighbors, n, nf, out)
    return out


def greedy_partition(neighbors: np.ndarray, n_parts: int):
    lib = _load()
    if lib is None:
        return None
    neighbors = np.ascontiguousarray(neighbors, dtype=np.int64)
    n, nf = neighbors.shape
    out = np.empty(n, dtype=np.int32)
    lib.pd_greedy_partition(neighbors, n, nf, n_parts, out)
    return out


def str_leaf_order(points: np.ndarray, fanout: int):
    lib = _load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = points.shape
    out = np.empty(n, dtype=np.int64)
    lib.pd_str_leaf_order(points, n, dim, fanout, out)
    return out


def sa_aggregate(indptr: np.ndarray, indices: np.ndarray):
    """Vanek greedy aggregation labels over a CSR strength graph, or
    None if the library (or symbol, for a stale build) is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "pd_sa_aggregate"):
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    n = indptr.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    n_agg = lib.pd_sa_aggregate(indptr, indices, n, out)
    if n_agg < 0:
        return None
    return out.astype(np.int64)


def str_tile(points: np.ndarray, n_groups: int):
    lib = _load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = points.shape
    out = np.empty(n, dtype=np.int64)
    lib.pd_str_tile(points, n, dim, n_groups, out)
    return out
