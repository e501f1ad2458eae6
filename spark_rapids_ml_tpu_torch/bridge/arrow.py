"""Arrow list column <-> contiguous (n, d) matrix conversion.

The port's copy of ``spark_rapids_ml_tpu/bridge/arrow.py``: the reference
reads training rows as a LIST column and grabs its flat child buffer
(rapidsml_jni.cu:114-115); here a ``fixed_size_list`` column reshapes its
child values zero-copy, and a ``list``/``large_list`` is validated
and gathered. pyarrow is optional: without it only the numpy and torch
containers are accepted.

With the host library loaded (``bridge/native.py``), a ``list`` column is
gathered by its threaded width check and copy, and the float64 chunks of a
multi-chunk column are concatenated by its threaded copy, as in the
reference; without it numpy does both (the ``list`` case as a read-only
view, which ``parallel.sharding.as_tensor`` copies later anyway).
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.bridge import native as _native


def _require_pa():
    """pyarrow, imported at use: importing the package never loads it (the
    GPU image ships without it)."""
    try:
        import pyarrow
    except ImportError as e:  # pragma: no cover - the GPU image
        raise ImportError("pyarrow is required for the Arrow columnar bridge") from e
    return pyarrow


def list_column_to_matrix(col, n_cols: Optional[int] = None) -> np.ndarray:
    """Convert an Arrow (Chunked)Array of list type to an (n, d) ndarray."""
    pa = _require_pa()
    if isinstance(col, pa.ChunkedArray):
        if col.num_chunks == 1:
            return _array_to_matrix(col.chunk(0), n_cols)
        mats = [_array_to_matrix(c, n_cols) for c in col.chunks if len(c)]
        if not mats:
            return np.empty((0, n_cols or 0))
        if len(mats) > 1 and mats[0].dtype == np.float64:
            out = _native.concat_chunks_f64(mats)
            if out is not None:
                return out
        return np.concatenate(mats, axis=0)
    return _array_to_matrix(col, n_cols)


def _array_to_matrix(arr, n_cols: Optional[int]) -> np.ndarray:
    pa = _require_pa()
    if arr.null_count:
        raise ValueError("list column contains nulls; expected dense vectors")
    t = arr.type
    if pa.types.is_fixed_size_list(t):
        d = t.list_size
        if n_cols is not None and d != n_cols:
            raise ValueError(f"fixed_size_list width {d} != expected {n_cols}")
        # flatten() accounts for slicing (arr.values is the unsliced child).
        flat = arr.flatten()
        if flat.null_count:
            raise ValueError("list column contains null elements; expected dense vectors")
        return flat.to_numpy(zero_copy_only=True).reshape(len(arr), d)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        offsets = np.asarray(arr.offsets)
        child = arr.values  # unsliced child; offsets index into it
        start, stop = int(offsets[0]), int(offsets[-1])
        if child.null_count and child.slice(start, stop - start).null_count:
            raise ValueError("list column contains null elements; expected dense vectors")
        vals = child.to_numpy(zero_copy_only=child.null_count == 0)
        if len(offsets) <= 1:
            return np.empty((0, n_cols or 0), dtype=vals.dtype)
        d = int(offsets[1] - offsets[0]) if n_cols is None else n_cols
        out = _native.flatten_ragged(vals, offsets, d)  # checks every row's width
        if out is not None:
            return out
        widths = np.diff(offsets)
        if not np.all(widths == d):
            raise ValueError("ragged list column: rows have differing lengths")
        return vals[start:stop].reshape(len(arr), d)
    raise TypeError(f"unsupported Arrow type for vector column: {t}")


def table_column_to_matrix(table, name: str, n_cols: Optional[int] = None) -> np.ndarray:
    """Extract column ``name`` of an Arrow Table as an (n, d) matrix."""
    if name not in table.column_names:
        raise KeyError(f"column {name!r} not in table (have {table.column_names})")
    return list_column_to_matrix(table.column(name), n_cols)


def matrix_to_list_column(mat: np.ndarray):
    """Wrap an (n, d) ndarray as an Arrow fixed_size_list array."""
    pa = _require_pa()
    mat = np.ascontiguousarray(mat)
    return pa.FixedSizeListArray.from_arrays(pa.array(mat.reshape(-1)), mat.shape[1])


def matrix_from_any(col) -> Tuple[object, int]:
    """Best-effort conversion of a column of vectors in any host format.

    A 2-D ``torch.Tensor`` passes through as it is (on whatever device it
    lies), so device-resident data reaches the fit without a host copy.
    """
    import torch

    if isinstance(col, torch.Tensor):
        if col.dim() != 2:
            raise ValueError(f"expected 2-D vector column, got shape {tuple(col.shape)}")
        return col, col.shape[1]
    pa = sys.modules.get("pyarrow")  # an Arrow column exists only once it is loaded
    if pa is not None and isinstance(col, (pa.Array, pa.ChunkedArray)):
        m = list_column_to_matrix(col)
        return m, m.shape[1]
    arr = np.asarray(col)
    if arr.dtype == object:
        arr = np.stack([np.asarray(r) for r in arr])
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D vector column, got shape {arr.shape}")
    return arr, arr.shape[1]
