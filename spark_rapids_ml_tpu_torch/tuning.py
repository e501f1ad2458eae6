"""Model selection — pyspark.ml.tuning equivalents.

The port of ``spark_rapids_ml_tpu/tuning.py``. ``ParamGridBuilder`` /
``CrossValidator`` / ``TrainValidationSplit`` with Spark's semantics: the
grid is a list of param maps; each candidate is evaluated with the caller's
Evaluator; the best map is re-fit on the FULL dataset. Folds and splits are
the reference's seeded ``np.random.default_rng(seed).permutation`` of the
row indices over the host dataset abstraction (``core.dataset.take_rows``),
so the same seed gives the same folds, and the same metrics, in both
packages. Candidates fit one after another, each on the estimator's device.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Sequence

import numpy as np

from spark_rapids_ml_tpu_torch.core.dataset import num_rows, take_rows
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasSeed,
    Model,
    Param,
    ParamDecl,
    TypeConverters,
)
from spark_rapids_ml_tpu_torch.core.persistence import (
    DefaultParamsReader,
    DefaultParamsWriter,
    MLReadable,
    MLWritable,
)
from spark_rapids_ml_tpu_torch.evaluation import Evaluator


class _TunedModelPersistence(MLWritable, MLReadable):
    """Nested save/load of a tuned model, as Spark's: the metrics ride the
    metadata JSON and the best model saves itself under ``bestModel/``."""

    _metrics_attr = "avgMetrics"  # subclass overrides

    def save(self, path: str) -> None:
        # Validate BEFORE touching the filesystem: a failed save must not
        # leave a partial directory that blocks every retry.
        if self.bestModel is None:
            raise ValueError("cannot save a tuned model with no bestModel")
        if not isinstance(self.bestModel, MLWritable):
            raise TypeError(f"bestModel {self.bestModel.uid} is not MLWritable")
        if os.path.exists(path):
            raise FileExistsError(f"path {path} already exists")
        os.makedirs(path)
        try:
            DefaultParamsWriter.save_metadata(
                self, path, extra={self._metrics_attr: list(getattr(self, self._metrics_attr))},
            )
            self.bestModel.save(os.path.join(path, "bestModel"))
        except BaseException:
            # A nested writer's failure must not leave a partial directory.
            shutil.rmtree(path, ignore_errors=True)
            raise

    @classmethod
    def load(cls, path: str):
        meta = DefaultParamsReader.load_metadata(path)
        best = DefaultParamsReader.load_instance(os.path.join(path, "bestModel"))
        obj = cls(bestModel=best)
        obj.uid = meta["uid"]
        setattr(obj, cls._metrics_attr, list(meta.get(cls._metrics_attr, [])))
        for name, value in meta.get("defaultParamMap", {}).items():
            if obj.hasParam(name):
                obj.setDefault(**{name: value})
        for name, value in meta.get("paramMap", {}).items():
            if obj.hasParam(name):
                obj._set(**{name: value})
        return obj


class ParamGridBuilder:
    """Cartesian grid of param maps (pyspark.ml.tuning.ParamGridBuilder)."""

    def __init__(self):
        self._grid: Dict[Param, Sequence] = {}
        self._base: Dict[Param, object] = {}

    def baseOn(self, *args) -> "ParamGridBuilder":
        if len(args) == 1 and isinstance(args[0], dict):
            self._base.update(args[0])
        else:
            for param, value in args:
                self._base[param] = value
        return self

    def addGrid(self, param: Param, values: Sequence) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError(f"addGrid expects a Param, got {type(param).__name__}")
        self._grid[param] = list(values)
        return self

    def build(self) -> List[Dict[Param, object]]:
        maps = [dict(self._base)]
        for param, values in self._grid.items():
            maps = [{**m, param: v} for m in maps for v in values]
        return maps


class _ValidatorParams(HasSeed):
    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None, uid=None):
        super().__init__(uid=uid)
        self._est = estimator
        self._maps = list(estimatorParamMaps or [{}])
        self._eval = evaluator

    def setEstimator(self, est: Estimator):
        self._est = est
        return self

    def setEstimatorParamMaps(self, maps):
        self._maps = list(maps)
        return self

    def setEvaluator(self, ev: Evaluator):
        self._eval = ev
        return self

    def getEstimator(self) -> Estimator:
        return self._est

    def getEstimatorParamMaps(self):
        return list(self._maps)

    def getEvaluator(self) -> Evaluator:
        return self._eval

    def _copy_extra_state(self, source):
        self._est = getattr(source, "_est", None)
        self._maps = list(getattr(source, "_maps", [{}]))
        self._eval = getattr(source, "_eval", None)

    def _check(self):
        if self._est is None or self._eval is None:
            raise ValueError("estimator and evaluator must both be set")

    def _fit_and_eval(self, train, val) -> List[float]:
        metrics = []
        for pmap in self._maps:
            model = self._est.fit(train, params=pmap or None)
            metrics.append(float(self._eval.evaluate(model.transform(val))))
        return metrics

    def _best_index(self, metrics: np.ndarray) -> int:
        return int(np.argmax(metrics) if self._eval.isLargerBetter() else np.argmin(metrics))


class CrossValidator(Estimator, _ValidatorParams):
    """k-fold CV over the param grid; the best map re-fit on the full data."""

    _uid_prefix = "CrossValidator"
    numFolds = ParamDecl("numFolds", "number of folds (>= 2)", TypeConverters.toInt)

    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 numFolds: int = 3, seed: int = 0, uid=None):
        super().__init__(estimator, estimatorParamMaps, evaluator, uid=uid)
        self.setDefault(numFolds=3, seed=0)
        self._set(numFolds=numFolds, seed=seed)

    def setNumFolds(self, value: int) -> "CrossValidator":
        return self._set(numFolds=value)

    def getNumFolds(self) -> int:
        return self.getOrDefault(self.numFolds)

    def _fit(self, dataset) -> "CrossValidatorModel":
        self._check()
        k = self.getNumFolds()
        if k < 2:
            raise ValueError(f"numFolds = {k} must be >= 2")
        n = num_rows(dataset)
        if n < k:
            raise ValueError(f"dataset has {n} rows < numFolds = {k}")
        perm = np.random.default_rng(self.getSeed()).permutation(n)
        metrics = np.zeros((k, len(self._maps)))
        for fold in range(k):
            val_idx = np.sort(perm[fold::k])
            train_idx = np.sort(np.concatenate([perm[f::k] for f in range(k) if f != fold]))
            metrics[fold] = self._fit_and_eval(
                take_rows(dataset, train_idx), take_rows(dataset, val_idx)
            )
        avg = metrics.mean(axis=0)
        best = self._best_index(avg)
        best_model = self._est.fit(dataset, params=self._maps[best] or None)
        out = CrossValidatorModel(bestModel=best_model, avgMetrics=avg.tolist())
        out.uid = self.uid
        out._eval = self._eval
        return out


class CrossValidatorModel(Model, _TunedModelPersistence):
    _uid_prefix = "CrossValidatorModel"
    _persist_class = "spark_rapids_ml_tpu.tuning.CrossValidatorModel"
    _metrics_attr = "avgMetrics"

    def __init__(self, bestModel=None, avgMetrics=None, uid=None):
        super().__init__(uid=uid)
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics or [])
        self._eval = None

    def _copy_extra_state(self, source):
        self.bestModel = source.bestModel
        self.avgMetrics = list(source.avgMetrics)
        self._eval = getattr(source, "_eval", None)

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)


class TrainValidationSplit(Estimator, _ValidatorParams):
    """One random train/validation split over the param grid."""

    _uid_prefix = "TrainValidationSplit"
    trainRatio = ParamDecl(
        "trainRatio", "fraction of rows used for training (0, 1)", TypeConverters.toFloat,
    )

    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 trainRatio: float = 0.75, seed: int = 0, uid=None):
        super().__init__(estimator, estimatorParamMaps, evaluator, uid=uid)
        self.setDefault(trainRatio=0.75, seed=0)
        self._set(trainRatio=trainRatio, seed=seed)

    def setTrainRatio(self, value: float) -> "TrainValidationSplit":
        return self._set(trainRatio=value)

    def getTrainRatio(self) -> float:
        return self.getOrDefault(self.trainRatio)

    def _fit(self, dataset) -> "TrainValidationSplitModel":
        self._check()
        ratio = self.getTrainRatio()
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"trainRatio = {ratio} must be in (0, 1)")
        n = num_rows(dataset)
        n_train = int(round(n * ratio))
        if n_train == 0 or n_train == n:
            raise ValueError(f"trainRatio = {ratio} leaves an empty split (n = {n})")
        perm = np.random.default_rng(self.getSeed()).permutation(n)
        train_idx = np.sort(perm[:n_train])
        val_idx = np.sort(perm[n_train:])
        metrics = np.asarray(self._fit_and_eval(
            take_rows(dataset, train_idx), take_rows(dataset, val_idx)
        ))
        best = self._best_index(metrics)
        best_model = self._est.fit(dataset, params=self._maps[best] or None)
        out = TrainValidationSplitModel(bestModel=best_model, validationMetrics=metrics.tolist())
        out.uid = self.uid
        return out


class TrainValidationSplitModel(Model, _TunedModelPersistence):
    _uid_prefix = "TrainValidationSplitModel"
    _persist_class = "spark_rapids_ml_tpu.tuning.TrainValidationSplitModel"
    _metrics_attr = "validationMetrics"

    def __init__(self, bestModel=None, validationMetrics=None, uid=None):
        super().__init__(uid=uid)
        self.bestModel = bestModel
        self.validationMetrics = list(validationMetrics or [])

    def _copy_extra_state(self, source):
        self.bestModel = source.bestModel
        self.validationMetrics = list(source.validationMetrics)

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)
