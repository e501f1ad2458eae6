"""Carry state across from the JAX package, as numpy arrays.

The two packages hold the same numbers in different array types. These
helpers build the port's objects from what the JAX package hands out as
numpy, so a model or a streaming state can move from one package to the
other (and the tests can compute in both from the same numbers).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
from spark_rapids_ml_tpu_torch.models.knn import (
    ApproximateNearestNeighborsModel,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.ops.gram import Stats
from spark_rapids_ml_tpu_torch.parallel.sharding import as_tensor


def pca_model_from_jax(data: Dict[str, np.ndarray], device=None) -> PCAModel:
    """A port ``PCAModel`` from the JAX ``PCAModel._model_data()`` dict
    (``pc``, and ``explainedVariance``/``mean`` when present)."""
    return PCAModel(
        pc=data["pc"],
        explained_variance=data.get("explainedVariance"),
        mean=data.get("mean"),
        device=device,
    )


def stats_from_jax(state: Tuple, device="cpu") -> Stats:
    """A JAX streaming state — PCA's ``(count, colsum, gram)``, or the
    normal equations' ``(XᵀX, Xᵀy, Σx, Σy, Σy², n)`` — as the port's
    tensors on ``device``, dtypes kept."""
    return tuple(as_tensor(np.asarray(a)).to(device) for a in state)


#: The LinearRegression name of :func:`stats_from_jax`.
normal_eq_stats_from_jax = stats_from_jax


def kmeans_model_from_jax(data: Dict[str, np.ndarray], device=None) -> KMeansModel:
    """A port ``KMeansModel`` from the JAX ``KMeansModel._model_data()``
    dict (``clusterCenters``)."""
    return KMeansModel(centers=data["clusterCenters"], device=device)


def linreg_model_from_jax(data: Dict[str, np.ndarray], device=None) -> LinearRegressionModel:
    """A port ``LinearRegressionModel`` from the JAX
    ``LinearRegressionModel._model_data()`` dict (``coefficients``,
    ``intercept``)."""
    return LinearRegressionModel(
        coefficients=data["coefficients"],
        intercept=float(np.asarray(data["intercept"]).reshape(-1)[0]),
        device=device,
    )


def logreg_model_from_jax(data: Dict[str, np.ndarray], device=None) -> LogisticRegressionModel:
    """A port ``LogisticRegressionModel`` from the JAX
    ``LogisticRegressionModel._model_data()`` dict (``coefficients`` (d,)
    or (C, d), ``intercept`` (1,) or (C,)). The fit checkpoints need no
    conversion: both packages write (w, b) or (W (d, C), b) with ``it``,
    ``n_cols`` (and ``n_classes``) in the same ``.npz`` layout."""
    model = LogisticRegressionModel._from_model_data(None, data)
    model._device = device
    return model


def knn_model_from_jax(data: Dict[str, np.ndarray], device=None) -> NearestNeighborsModel:
    """A port ``NearestNeighborsModel`` from the JAX
    ``NearestNeighborsModel._model_data()`` dict (``database``). Params (k,
    metric) are the caller's to set, as after a fit."""
    return NearestNeighborsModel(database=data["database"], device=device)


def ann_model_from_jax(data: Dict[str, np.ndarray], device=None) -> ApproximateNearestNeighborsModel:
    """A port ``ApproximateNearestNeighborsModel`` from the JAX
    ``ApproximateNearestNeighborsModel._model_data()`` dict (``centroids``,
    ``lists``, ``list_ids``, ``list_mask`` and, when present, the
    ``fit_metric`` ordinal that the metric guard reads)."""
    model = ApproximateNearestNeighborsModel._from_model_data(None, data)
    model._device = device
    return model
