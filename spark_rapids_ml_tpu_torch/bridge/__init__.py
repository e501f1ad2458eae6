"""Columnar data plane of the port: Arrow list columns <-> (n, d)
matrices (``arrow.py``, pyarrow imported at use) and the optional native
host library (``native.py``)."""

from spark_rapids_ml_tpu_torch.bridge.arrow import (
    list_column_to_matrix,
    matrix_to_list_column,
    table_column_to_matrix,
)

__all__ = [
    "list_column_to_matrix",
    "matrix_to_list_column",
    "table_column_to_matrix",
]
