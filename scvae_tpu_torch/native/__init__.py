"""Native (C++) host-side kernels, loaded with ctypes.

The port's copy of ``densify.cpp``: the multi-threaded CSR row gather that
the streaming pipeline densifies its batches with.  The library is compiled
with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` on first use into
``build/native/`` at the repository root (again whenever the source is
newer), never at import.  A failed build or load raises ``RuntimeError``:
there is no slower fallback to take quietly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "densify.cpp")
_LIBRARY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "build", "native", "libdensify.so")
COMPILE = ("g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build_library() -> None:
    os.makedirs(os.path.dirname(_LIBRARY), exist_ok=True)
    partial = f"{_LIBRARY}.{os.getpid()}.tmp"
    try:
        subprocess.run([*COMPILE, _SOURCE, "-o", partial], check=True,
                       capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as error:
        detail = getattr(error, "stderr", None) or error
        raise RuntimeError(
            f"building the native densify from {_SOURCE} failed: {detail}"
        ) from error
    os.replace(partial, _LIBRARY)


def _stale() -> bool:
    return (not os.path.exists(_LIBRARY) or not os.path.exists(_SOURCE)
            or os.path.getmtime(_LIBRARY) < os.path.getmtime(_SOURCE))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build_library()
        try:
            lib = ctypes.CDLL(_LIBRARY)
        except OSError as error:
            raise RuntimeError(
                f"loading the native densify {_LIBRARY} failed: {error}"
            ) from error
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.csr_gather_dense_f32.argtypes = [
            p_f32, p_i32, p_i64, p_i64, ctypes.c_int64, ctypes.c_int64, p_f32,
        ]
        lib.csr_gather_dense_with_sums_f32.argtypes = [
            p_f32, p_i32, p_i64, p_i64, ctypes.c_int64, ctypes.c_int64, p_f32,
            p_f32,
        ]
        lib.csr_to_dense_f32.argtypes = [
            p_f32, p_i32, p_i64, ctypes.c_int64, ctypes.c_int64, p_f32,
        ]
        for function in (lib.csr_gather_dense_f32,
                         lib.csr_gather_dense_with_sums_f32,
                         lib.csr_to_dense_f32):
            function.restype = None
        _lib = lib
    return _lib


def _csr_arrays(matrix):
    """(data float32, indices int32, indptr int64) for the C interface,
    cached on the matrix object.  Each is a view of the matrix's own array
    where its dtype already matches and a copy otherwise: a matrix held as
    float32 / int32 with scipy's int32 ``indptr`` costs only the int64
    ``indptr`` copy; one held in other dtypes (float64 data, int64
    indices) keeps up to 8 bytes more per stored entry on the host for the
    matrix's life."""
    cached = getattr(matrix, "_native_csr_cache", None)
    if cached is not None:
        return cached
    data = np.ascontiguousarray(matrix.data, np.float32)
    indices = np.ascontiguousarray(matrix.indices, np.int32)
    indptr = np.ascontiguousarray(matrix.indptr, np.int64)
    cached = (data, indices, indptr)
    try:
        matrix._native_csr_cache = cached
    except AttributeError:
        pass
    return cached


def _ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def csr_gather_dense(matrix, rows: np.ndarray) -> np.ndarray:
    """Dense float32 ``matrix[rows]`` of a CSR matrix (rows in any order,
    repeats allowed; a row outside the matrix raises ``IndexError``)."""
    lib = _load()
    data, indices, indptr = _csr_arrays(matrix)
    rows = np.ascontiguousarray(rows, np.int64).reshape(-1)
    if rows.size and (rows.min() < 0 or rows.max() >= matrix.shape[0]):
        raise IndexError(f"rows outside the matrix's {matrix.shape[0]}")
    n_rows, n_cols = rows.shape[0], matrix.shape[1]
    out = np.empty((n_rows, n_cols), np.float32)
    lib.csr_gather_dense_f32(
        _ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), _ptr(rows, ctypes.c_int64),
        n_rows, n_cols, _ptr(out, ctypes.c_float),
    )
    return out


def csr_to_dense(matrix) -> np.ndarray:
    """The whole CSR matrix as a dense float32 array."""
    lib = _load()
    data, indices, indptr = _csr_arrays(matrix)
    n_rows, n_cols = matrix.shape
    out = np.empty((n_rows, n_cols), np.float32)
    lib.csr_to_dense_f32(
        _ptr(data, ctypes.c_float), _ptr(indices, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), n_rows, n_cols,
        _ptr(out, ctypes.c_float),
    )
    return out
