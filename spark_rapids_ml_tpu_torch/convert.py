"""Carry state across from the JAX package, as numpy arrays.

The two packages hold the same numbers in different array types. These
helpers build the port's objects from what the JAX package hands out as
numpy, so a model or a streaming state can move from one package to the
other (and the tests can compute in both from the same numbers).
:func:`model_from_jax` carries a whole fitted model, a pipeline stage by
stage, with its uid and params.
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
from spark_rapids_ml_tpu_torch.models.random_forest import (
    RandomForestClassificationModel,
    RandomForestRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.scaler import StandardScalerModel
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


def scaler_model_from_jax(data: Dict[str, np.ndarray], device=None) -> StandardScalerModel:
    """A port ``StandardScalerModel`` from the JAX
    ``StandardScalerModel._model_data()`` dict (``mean``, ``std``). Params
    (withMean, withStd) are the caller's to set, as after a fit."""
    return StandardScalerModel(mean=data["mean"], std=data["std"], device=device)


def forest_model_from_jax(data: Dict[str, np.ndarray], device=None):
    """A port forest model from the JAX forest model's ``_model_data()``
    dict (``bin_edges``, ``feature``, ``threshold``, ``value``,
    ``n_classes``): a ``RandomForestClassificationModel`` when
    ``n_classes`` > 0, else a ``RandomForestRegressionModel``."""
    n_classes = int(np.asarray(data.get("n_classes", [0])).reshape(-1)[0])
    cls = RandomForestClassificationModel if n_classes > 0 else RandomForestRegressionModel
    return cls(arrays=dict(data), device=device)


#: JAX model class name → the converter of its ``_model_data()`` dict.
_STAGE_CONVERTERS = {
    "PCAModel": pca_model_from_jax,
    "KMeansModel": kmeans_model_from_jax,
    "LinearRegressionModel": linreg_model_from_jax,
    "LogisticRegressionModel": logreg_model_from_jax,
    "NearestNeighborsModel": knn_model_from_jax,
    "ApproximateNearestNeighborsModel": ann_model_from_jax,
    "StandardScalerModel": scaler_model_from_jax,
    "RandomForestClassificationModel": forest_model_from_jax,
    "RandomForestRegressionModel": forest_model_from_jax,
}


def model_from_jax(jax_model, device=None):
    """The port's counterpart of a fitted JAX model, its uid and params
    carried across (by name; a param the port lacks is skipped). A JAX
    ``PipelineModel`` converts stage by stage into the port's."""
    from spark_rapids_ml_tpu_torch.pipeline import PipelineModel

    name = type(jax_model).__name__
    if name == "PipelineModel":
        out = PipelineModel(stages=[model_from_jax(s, device) for s in jax_model.stages])
    else:
        if name not in _STAGE_CONVERTERS:
            raise TypeError(f"no port counterpart for the JAX model class {name}")
        out = _STAGE_CONVERTERS[name](
            {k: np.asarray(v) for k, v in jax_model._model_data().items() if v is not None},
            device=device,
        )
        for p in jax_model.params:
            if not out.hasParam(p.name):
                continue
            if p in jax_model._defaultParamMap:
                out.setDefault(**{p.name: jax_model._defaultParamMap[p]})
            if p in jax_model._paramMap:
                out._set(**{p.name: jax_model._paramMap[p]})
    out.uid = jax_model.uid
    return out
