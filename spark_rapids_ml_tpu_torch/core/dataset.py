"""Dataset abstraction: column access over host data containers.

The port's copy of ``spark_rapids_ml_tpu/core/dataset.py`` (the slice's
part of it). Estimators address columns by name over a
``pyarrow.Table``/``RecordBatch``, a ``pandas.DataFrame``, a ``dict`` of
name → array or tensor, or a bare 2-D matrix (numpy array or
``torch.Tensor``; column names ignored). ``with_column`` returns the same
container kind with the output column appended, mirroring
``df.withColumn(outputCol, ...)`` (RapidsPCA.scala:165).
"""

from __future__ import annotations

import sys
from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.bridge import arrow as _arrow_bridge


def _is_arrow(dataset: Any) -> bool:
    # An Arrow container exists only once its caller imported pyarrow, so
    # the check reads sys.modules and never imports it (importing the
    # package must not load pyarrow: the data-plane daemon runs without).
    pa = sys.modules.get("pyarrow")
    return pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch))


def _is_pandas(dataset: Any) -> bool:
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(dataset, pd.DataFrame)


def _arrow_table(dataset: Any):
    """An Arrow RecordBatch as a Table; a Table as it is."""
    pa = sys.modules["pyarrow"]
    return pa.Table.from_batches([dataset]) if isinstance(dataset, pa.RecordBatch) else dataset


def num_rows(dataset: Any) -> int:
    if _is_arrow(dataset):
        return dataset.num_rows
    if _is_pandas(dataset):
        return len(dataset)
    if isinstance(dataset, dict):
        if not dataset:
            return 0
        return len(next(iter(dataset.values())))
    return int(dataset.shape[0]) if hasattr(dataset, "shape") else len(dataset)


def as_matrix(dataset: Any, col: Optional[str] = None, n_cols: Optional[int] = None):
    """Extract a column of fixed-width vectors as an (n, d) matrix (numpy
    array, or the tensor itself when the column is a ``torch.Tensor``)."""
    if _is_arrow(dataset):
        assert col is not None, "column name required for Arrow datasets"
        return _arrow_bridge.table_column_to_matrix(_arrow_table(dataset), col, n_cols)
    if _is_pandas(dataset):
        assert col is not None, "column name required for pandas datasets"
        mat, _ = _arrow_bridge.matrix_from_any(dataset[col].to_numpy())
        return mat
    if isinstance(dataset, dict):
        assert col is not None, "column name required for dict datasets"
        mat, _ = _arrow_bridge.matrix_from_any(dataset[col])
        return mat
    mat, _ = _arrow_bridge.matrix_from_any(dataset)
    return mat


def has_column(dataset: Any, col: str) -> bool:
    """Whether the dataset carries a column named ``col`` (a bare matrix
    has none)."""
    if _is_arrow(dataset):
        return col in dataset.schema.names
    if _is_pandas(dataset):
        return col in dataset.columns
    if isinstance(dataset, dict):
        return col in dataset
    return False


def as_column(dataset: Any, col: str):
    """Extract a scalar column (labels, weights) as a 1-D numpy array, or
    the tensor itself when the column is a ``torch.Tensor``."""
    if _is_arrow(dataset):
        return np.asarray(_arrow_table(dataset).column(col))
    if _is_pandas(dataset):
        return dataset[col].to_numpy()
    if isinstance(dataset, dict):
        value = dataset[col]
        return value if isinstance(value, torch.Tensor) else np.asarray(value)
    raise TypeError(
        f"cannot extract named column {col!r} from a bare array dataset; "
        "pass a dict/arrow/pandas container"
    )


def take_rows(dataset: Any, indices: np.ndarray) -> Any:
    """Row-subset the dataset by integer indices, keeping its container
    kind: the fold split of CrossValidator and TrainValidationSplit
    (``tuning.py``). A tensor column is indexed on its own device."""
    indices = np.asarray(indices)
    if _is_arrow(dataset):
        pa = sys.modules["pyarrow"]
        return _arrow_table(dataset).take(pa.array(indices))
    if _is_pandas(dataset):
        return dataset.iloc[indices].reset_index(drop=True)

    def take(v):
        if isinstance(v, torch.Tensor):
            return v[torch.as_tensor(indices, device=v.device)]
        return np.asarray(v)[indices]

    if isinstance(dataset, dict):
        return {k: take(v) for k, v in dataset.items()}
    return take(dataset)


def with_column(dataset: Any, name: str, values) -> Any:
    """Return the dataset with ``values`` appended as column ``name``.

    2-D values become a vector column in the container's native vector
    representation (Arrow fixed_size_list / pandas object column of arrays).
    """
    if _is_arrow(dataset) or _is_pandas(dataset):
        values = values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    if _is_arrow(dataset):
        dataset = _arrow_table(dataset)
        if values.ndim == 2:
            col = _arrow_bridge.matrix_to_list_column(values)
        else:
            col = sys.modules["pyarrow"].array(values)
        if name in dataset.column_names:
            dataset = dataset.drop_columns([name])
        return dataset.append_column(name, col)
    if _is_pandas(dataset):
        out = dataset.copy()
        out[name] = list(values) if values.ndim == 2 else values
        return out
    if isinstance(dataset, dict):
        out = dict(dataset)
        out[name] = values
        return out
    # Bare matrix in, bare matrix out (the pure-matrix API).
    return values
