"""StandardScaler — feature standardization, Spark ML semantics.

The port of ``spark_rapids_ml_tpu/models/scaler.py``. The reference leaves
mean-centering to "an ETL preprocess upstream" (RapidsRowMatrix.scala:
111-117); this estimator is that preprocess. ``fit`` is one device pass of
(n, Σx, Σx²) in the accumulation dtype (config ``accum_dtype``) on the
entry point's device, then a host float64 finalize. The model standardizes
on the host in float64 and hands back float32, exactly as the JAX model
does, so its output is bitwise the reference's.

Spark parity (``org.apache.spark.ml.feature.StandardScaler``): ``withStd``
defaults true, ``withMean`` false, std is the unbiased sample standard
deviation (ddof = 1), and a zero-variance feature scales by 0 as in MLlib's
``StandardScalerModel`` (never NaN).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core.dataset import as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasInputCol,
    HasOutputCol,
    Model,
    ParamDecl,
    TypeConverters,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.parallel.sharding import resolve_device, to_device
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span


#: Bytes of float64 a block of the host transform holds.
_BLOCK_BYTES = 1 << 22


def moments(x, device=None) -> Tuple[float, np.ndarray, np.ndarray]:
    """(n, Σx, Σx²) of an (n, d) matrix, summed on ``device`` (None: the
    card) in the accumulation dtype after a float32 cast, as the reference
    places its rows; returned as host float64."""
    dev = resolve_device(device)
    xs = to_device(x, dev, torch.float32).to(config.accum_dtype())
    s1 = xs.sum(0)
    s2 = xs.square().sum(0)
    as_np = lambda t: t.cpu().numpy().astype(np.float64)  # noqa: E731
    return float(xs.shape[0]), as_np(s1), as_np(s2)


def finalize_moments(n: float, s1, s2) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) from (n, Σx, Σx²) in host float64: the unbiased
    variance, floored at 0 (the Σx² − n·μ² form can go −eps for a constant
    feature)."""
    mean = np.asarray(s1, np.float64) / n
    var = (np.asarray(s2, np.float64) - n * mean * mean) / max(n - 1.0, 1.0)
    return mean, np.sqrt(np.maximum(var, 0.0))


class _ScalerParams(HasInputCol, HasOutputCol):
    withMean = ParamDecl("withMean", "center features to zero mean", TypeConverters.toBoolean)
    withStd = ParamDecl(
        "withStd", "scale features to unit standard deviation", TypeConverters.toBoolean
    )

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(
            withMean=False, withStd=True, inputCol="features", outputCol="scaled_features",
        )

    def getWithMean(self) -> bool:
        return self.getOrDefault(self.withMean)

    def getWithStd(self) -> bool:
        return self.getOrDefault(self.withStd)


class StandardScaler(Estimator, _ScalerParams, MLWritable, MLReadable):
    """fit() computes per-feature mean and std in one device pass.

    ``device``: where the pass runs; None → the card."""

    _uid_prefix = "StandardScaler"
    _persist_class = "spark_rapids_ml_tpu.models.scaler.StandardScaler"

    def __init__(self, uid=None, device=None):
        super().__init__(uid=uid)
        self._device = device

    def setWithMean(self, value: bool) -> "StandardScaler":
        return self._set(withMean=value)

    def setWithStd(self, value: bool) -> "StandardScaler":
        return self._set(withStd=value)

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)

    def _fit(self, dataset) -> "StandardScalerModel":
        x = as_matrix(dataset, self.getInputCol())
        with trace_span("scaler fit"):
            mean, std = finalize_moments(*moments(x, self._device))
        model = StandardScalerModel(mean=mean, std=std, device=self._device)
        model.uid = self.uid
        self._copy_params_to(model)
        return model


class StandardScalerModel(Model, _ScalerParams, MLWritable, MLReadable):
    _uid_prefix = "StandardScalerModel"
    _persist_class = "spark_rapids_ml_tpu.models.scaler.StandardScalerModel"
    # The daemon's serving contract (spark/estimator.py). withMean/withStd
    # ride the registration, so the served copy scales as this one does:
    # they are the only params that change the served output.
    _serve_algo = "scaler"
    _serve_outputs = (("output", "outputCol", "vec"),)
    _serve_params = ("withMean", "withStd")

    def __init__(self, mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 uid=None, device=None):
        super().__init__(uid=uid)
        self.mean = None if mean is None else np.asarray(mean, np.float64)
        self.std = None if std is None else np.asarray(std, np.float64)
        # The transform is host work; the device names the daemon that
        # serves a Spark transform (None: the card's).
        self._device = device

    def _model_data(self):
        return {"mean": self.mean, "std": self.std}

    @classmethod
    def _from_model_data(cls, uid, data):
        return cls(mean=data["mean"], std=data["std"], uid=uid)

    def _copy_extra_state(self, source):
        self.mean = source.mean
        self.std = source.std
        self._device = getattr(source, "_device", None)

    def _serve_aot_plan(self, n_rows, n_cols, dtype="float32", k=None):
        """AOT-at-registration plan (``serve/aot.py``), the JAX plan's: the
        transform is host elementwise, so nothing is built and the plan is
        complete as an empty list (AOT succeeds with no program rather than
        falling back to the trace warmup). A wrong width still raises."""
        if self.mean is not None:
            from spark_rapids_ml_tpu_torch.serve import aot

            aot.check_width(n_cols, np.asarray(self.mean).shape[0])
        return []

    def transform_matrix(self, x) -> dict:
        """Role-keyed transform of a bare matrix, host float64 elementwise
        (bandwidth-trivial beside any model's product), float32 out. A
        tensor is copied to the host first."""
        if self.mean is None:
            raise RuntimeError("StandardScalerModel has no statistics (unfitted?)")
        with trace_span("scaler transform"):
            if isinstance(x, torch.Tensor):
                x = x.cpu().numpy()
            x = np.asarray(x)
            out = np.empty(x.shape, np.float32)
            with_mean, with_std = self.getWithMean(), self.getWithStd()
            # MLlib convention: zero-variance features multiply by 0.
            inv = np.where(self.std > 0, 1.0 / np.where(self.std > 0, self.std, 1.0), 0.0)
            # Blocks of rows whose float64 copy stays in cache, a block a
            # thread (numpy leaves the interpreter lock in its loops): the
            # same elementwise float64 arithmetic, without four serial
            # passes over a float64 copy of the whole matrix.
            step = max(1, _BLOCK_BYTES // (8 * max(1, x.shape[1])))

            def block(i):
                xb = x[i: i + step].astype(np.float64)
                if with_mean:
                    xb -= self.mean
                if with_std:
                    xb *= inv
                out[i: i + step] = xb

            starts = range(0, x.shape[0], step)
            with ThreadPoolExecutor(max(1, min(len(starts), torch.get_num_threads()))) as pool:
                list(pool.map(block, starts))
            return {"output": out}

    def _transform(self, dataset):
        x = as_matrix(dataset, self.getInputCol())
        return with_column(dataset, self.getOutputCol(), self.transform_matrix(x)["output"])
