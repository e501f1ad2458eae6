"""Evaluators — pyspark.ml.evaluation equivalents for model selection.

The port of ``spark_rapids_ml_tpu/evaluation.py``. The metrics are host
numpy over the prediction and label columns of a transformed dataset, as
there: they are O(rows) scalars, not device work, and host float64 makes
them the same floats the JAX package returns. A tensor column (a model's
output on the card) is copied to the host first. ``isLargerBetter``
follows Spark, so CrossValidator's choice of the best map does not depend
on the metric.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.core.dataset import as_column, as_matrix, has_column
from spark_rapids_ml_tpu_torch.core.params import (
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
    ParamDecl,
    Params,
    TypeConverters,
)


def _host(values) -> np.ndarray:
    """A column as a host array (a tensor is copied off its device)."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _is_vector_column(dataset, col: str) -> bool:
    """True when ``col`` holds per-row vectors rather than scalars."""
    try:
        probe = _host(as_column(dataset, col))
    except (TypeError, ValueError, KeyError):
        return True  # list/fixed_size_list columns as_column can't flatten
    return probe.ndim > 1 or probe.dtype == object


class Evaluator(Params):
    """evaluate(dataset) -> float. Mirrors org.apache.spark.ml.evaluation."""

    def evaluate(self, dataset) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class _MetricParams(HasLabelCol, HasPredictionCol):
    metricName = ParamDecl("metricName", "metric to compute", TypeConverters.toString)

    def getMetricName(self) -> str:
        return self.getOrDefault(self.metricName)

    def setMetricName(self, value: str):
        return self._set(metricName=value)

    def _columns(self, dataset):
        y = np.asarray(_host(as_column(dataset, self.getLabelCol())), np.float64)
        p = np.asarray(_host(as_column(dataset, self.getPredictionCol())), np.float64)
        return y, p


class RegressionEvaluator(Evaluator, _MetricParams):
    """rmse (default) | mse | mae | r2 — Spark's metric set."""

    _uid_prefix = "RegressionEvaluator"

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(metricName="rmse", labelCol="label", predictionCol="prediction")

    def evaluate(self, dataset) -> float:
        y, p = self._columns(dataset)
        err = y - p
        name = self.getMetricName()
        if name == "rmse":
            return float(np.sqrt(np.mean(err**2)))
        if name == "mse":
            return float(np.mean(err**2))
        if name == "mae":
            return float(np.mean(np.abs(err)))
        if name == "r2":
            ss_res = float(np.sum(err**2))
            ss_tot = float(np.sum((y - y.mean()) ** 2))
            return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
        raise ValueError(f"unknown regression metric {name!r}")

    def isLargerBetter(self) -> bool:
        return self.getMetricName() == "r2"


class BinaryClassificationEvaluator(Evaluator, _MetricParams, HasRawPredictionCol):
    """areaUnderROC (default) | areaUnderPR over a score column.

    As in Spark, the score is read from ``rawPredictionCol`` (default
    ``rawPrediction``), the margin column LogisticRegressionModel writes. It
    may hold a per-class vector (its last, positive-class component is
    used) or a scalar score. Without such a column, ``predictionCol`` is
    the score (hard 0/1 predictions give the one-threshold AUC).
    """

    _uid_prefix = "BinaryClassificationEvaluator"

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(
            metricName="areaUnderROC",
            labelCol="label",
            predictionCol="prediction",
            rawPredictionCol="rawPrediction",
        )

    def _score(self, dataset) -> np.ndarray:
        col = self.getRawPredictionCol()
        if not has_column(dataset, col):
            col = self.getPredictionCol()
        if _is_vector_column(dataset, col):
            return np.asarray(_host(as_matrix(dataset, col))[:, -1], np.float64)
        return np.asarray(_host(as_column(dataset, col)), np.float64)

    def evaluate(self, dataset) -> float:
        y = np.asarray(_host(as_column(dataset, self.getLabelCol())), np.float64)
        score = self._score(dataset)
        pos = y > 0.5
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            return 0.0
        order = np.argsort(score, kind="stable")
        name = self.getMetricName()
        if name == "areaUnderROC":
            # Mann-Whitney U with midrank tie handling.
            ranks = np.empty_like(score)
            ranks[order] = np.arange(1, len(score) + 1, dtype=np.float64)
            uniq, inv, counts = np.unique(score, return_inverse=True, return_counts=True)
            if len(uniq) != len(score):
                sums = np.zeros(len(uniq))
                np.add.at(sums, inv, ranks)
                ranks = sums[inv] / counts[inv]
            u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
            return float(u / (n_pos * n_neg))
        if name == "areaUnderPR":
            desc = order[::-1]
            tp = np.cumsum(pos[desc])
            precision = tp / np.arange(1, len(score) + 1)
            recall = tp / n_pos
            # Trapezoid over recall, prepending (0, 1) as Spark does.
            r = np.concatenate([[0.0], recall])
            pcs = np.concatenate([[1.0], precision])
            return float(np.sum(np.diff(r) * (pcs[1:] + pcs[:-1]) / 2.0))
        raise ValueError(f"unknown binary metric {name!r}")


class MulticlassClassificationEvaluator(Evaluator, _MetricParams):
    """accuracy (default) | f1 (Spark's weightedFMeasure over hard
    predictions: each class's F1 weighted by its share of the labels)."""

    _uid_prefix = "MulticlassClassificationEvaluator"

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(metricName="accuracy", labelCol="label", predictionCol="prediction")

    def evaluate(self, dataset) -> float:
        y, p = self._columns(dataset)
        name = self.getMetricName()
        if name == "accuracy":
            return float(np.mean(y == p))
        if name == "f1":
            classes = np.unique(np.concatenate([y, p]))
            weighted = 0.0
            for c in classes:
                tp = float(np.sum((p == c) & (y == c)))
                fp = float(np.sum((p == c) & (y != c)))
                fn = float(np.sum((p != c) & (y == c)))
                prec = tp / (tp + fp) if tp + fp > 0 else 0.0
                rec = tp / (tp + fn) if tp + fn > 0 else 0.0
                f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
                weighted += f1 * float(np.sum(y == c)) / len(y)
            return weighted
        raise ValueError(f"unknown multiclass metric {name!r}")
