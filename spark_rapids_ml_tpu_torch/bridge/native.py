"""ctypes loader of the optional host library ``libsrml_tpu.so``.

The port's copy of ``spark_rapids_ml_tpu/bridge/native.py``. The library
is built from ``native/src/columnar.cpp`` (``make -C native``) and holds
threaded host copies: the port's Arrow bridge uses the ragged list
gather and the concatenation of float64 chunks, and
``parallel/sharding.shard_rows`` the float64 → float32 cast. It is
looked up at ``$SRML_TORCH_NATIVE_LIB``, next to this module and in the
repository's ``native/build``. When it is absent, or config
``use_native_bridge`` is off, every wrapper returns None and the caller
does the copy with numpy. It is a host copy helper, not a device kernel.

A successful load is kept for the process. A failed lookup is kept only
while the candidate files stay as they were (their paths and mtimes): a
library built after the first lookup is loaded at the next one.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch import config

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# The candidates' (path, mtime) when the last lookup found nothing to load.
_missed: Optional[Tuple] = None

_SO_NAME = "libsrml_tpu.so"


def _candidate_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    return [
        # An explicit path wins over discovery.
        os.environ.get("SRML_TORCH_NATIVE_LIB", ""),
        os.path.join(here, _SO_NAME),
        os.path.join(repo, "native", "build", _SO_NAME),
    ]


def _signature(paths) -> Tuple:
    sig = []
    for path in paths:
        try:
            sig.append((path, os.stat(path).st_mtime_ns))
        except OSError:
            sig.append((path, None))
    return tuple(sig)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None if it is unavailable or disabled."""
    global _lib, _missed
    if not config.get("use_native_bridge"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        paths = _candidate_paths()
        sig = _signature(paths)
        if sig == _missed:
            return None
        for path in paths:
            if path and os.path.exists(path):
                try:
                    lib = ctypes.CDLL(path)
                    _configure(lib)
                except (OSError, AttributeError):
                    # AttributeError: a stale library without a newer
                    # export; try the next candidate, then numpy.
                    continue
                _lib = lib
                return _lib
        _missed = sig
        return None


def _configure(lib: ctypes.CDLL) -> None:
    c_i64 = ctypes.c_int64
    c_p = ctypes.c_void_p
    # int srml_flatten_list_f64(const double* values, const int64_t* offsets,
    #                           int64_t n_rows, int64_t n_cols, double* out,
    #                           int n_threads)
    lib.srml_flatten_list_f64.restype = ctypes.c_int
    lib.srml_flatten_list_f64.argtypes = [c_p, c_p, c_i64, c_i64, c_p, ctypes.c_int]
    lib.srml_flatten_list_f32.restype = ctypes.c_int
    lib.srml_flatten_list_f32.argtypes = [c_p, c_p, c_i64, c_i64, c_p, ctypes.c_int]
    # int srml_concat_chunks_f64(const double** chunks, const int64_t* rows,
    #                            int64_t n_chunks, int64_t n_cols, double* out,
    #                            int n_threads)
    lib.srml_concat_chunks_f64.restype = ctypes.c_int
    lib.srml_concat_chunks_f64.argtypes = [c_p, c_p, c_i64, c_i64, c_p, ctypes.c_int]
    # int srml_cast_f64_to_f32(const double* src, int64_t n, float* dst, int n_threads)
    lib.srml_cast_f64_to_f32.restype = ctypes.c_int
    lib.srml_cast_f64_to_f32.argtypes = [c_p, c_i64, c_p, ctypes.c_int]
    lib.srml_abi_version.restype = ctypes.c_int
    lib.srml_abi_version.argtypes = []
    if lib.srml_abi_version() != 1:
        raise OSError("libsrml_tpu ABI version mismatch")


def _nthreads() -> int:
    return min(16, os.cpu_count() or 1)


def flatten_ragged(values: np.ndarray, offsets: np.ndarray, n_cols: int) -> Optional[np.ndarray]:
    """Gather a list column into an (n_rows, n_cols) matrix natively.

    ``values`` is the flat child buffer, ``offsets`` the (n_rows + 1,)
    offsets into it. Every row must hold exactly ``n_cols`` elements (the
    library checks); None on any error, and the caller falls back."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows = len(offsets) - 1
    if n_rows < 0:
        return None
    # Bounds check on the host: the library never sees the values length,
    # and corrupt offsets must not become an out-of-bounds copy.
    if n_rows > 0 and (int(offsets[0]) < 0 or int(offsets[-1]) > values.size):
        return None
    if values.dtype == np.float64:
        fn = lib.srml_flatten_list_f64
    elif values.dtype == np.float32:
        fn = lib.srml_flatten_list_f32
    else:
        return None
    out = np.empty((n_rows, n_cols), dtype=values.dtype)
    values = np.ascontiguousarray(values)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    rc = fn(
        values.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        n_rows,
        n_cols,
        out.ctypes.data_as(ctypes.c_void_p),
        _nthreads(),
    )
    return out if rc == 0 else None


def cast_f64_to_f32(src: np.ndarray) -> Optional[np.ndarray]:
    """A float32 copy of a float64 array by the library's threaded cast
    (round to nearest, as numpy's ``astype``), or None when the library is
    unavailable or ``src`` is not float64: the caller then casts with
    numpy."""
    lib = get_lib()
    if lib is None or src.dtype != np.float64:
        return None
    src = np.ascontiguousarray(src)
    dst = np.empty(src.shape, dtype=np.float32)
    rc = lib.srml_cast_f64_to_f32(
        src.ctypes.data_as(ctypes.c_void_p),
        src.size,
        dst.ctypes.data_as(ctypes.c_void_p),
        _nthreads(),
    )
    if rc != 0:
        return None
    return dst


def concat_chunks_f64(chunks) -> Optional[np.ndarray]:
    """A threaded concatenation of (rows_i, d) float64 blocks; None
    without the library or for blocks of another dtype or width."""
    lib = get_lib()
    if lib is None or not chunks:
        return None
    arrs = [np.ascontiguousarray(c) for c in chunks]
    if any(a.dtype != np.float64 or a.ndim != 2 for a in arrs):
        return None
    d = arrs[0].shape[1]
    if any(a.shape[1] != d for a in arrs):
        return None
    out = np.empty((sum(a.shape[0] for a in arrs), d), dtype=np.float64)
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
    )
    rows = np.asarray([a.shape[0] for a in arrs], dtype=np.int64)
    rc = lib.srml_concat_chunks_f64(
        ctypes.cast(ptrs, ctypes.c_void_p),
        rows.ctypes.data_as(ctypes.c_void_p),
        len(arrs),
        d,
        out.ctypes.data_as(ctypes.c_void_p),
        _nthreads(),
    )
    return out if rc == 0 else None
