"""Pipeline — chained estimators/transformers, Spark ML semantics.

The port of ``spark_rapids_ml_tpu/pipeline.py``. It mirrors
``org.apache.spark.ml.Pipeline``: ``fit`` walks the stages in order,
fitting each Estimator on the dataset as transformed by everything before
it (and transforming through the fitted model, so later stages see its
output); Models pass through. The result is a ``PipelineModel`` whose
``transform`` applies every fitted stage in order.

Persistence keeps Spark's layout: the pipeline's metadata names its
stages' uids and each stage saves itself under ``stages/{i}_{uid}``. A
stage loads by its saved class name (``core/persistence.py``), so a
pipeline saved by the JAX package loads here into the port's classes.
"""

from __future__ import annotations

import os
from typing import List, Optional

from spark_rapids_ml_tpu_torch.core.params import Estimator, Model, Params
from spark_rapids_ml_tpu_torch.core.persistence import (
    DefaultParamsReader,
    DefaultParamsWriter,
    MLReadable,
    MLWritable,
)


class _StagesMixin(Params):
    def _copy_extra_state(self, source):
        # Shallow share: copy() below always rebuilds the stage list.
        self._stages = list(getattr(source, "_stages", []))

    def copy(self, extra=None):
        # Spark semantics: ``extra`` flows into the stage copies, so a
        # CrossValidator grid keyed on a stage's params tunes the stage
        # through the enclosing Pipeline(Model).
        that = super().copy(extra)
        that._stages = [s.copy(extra) for s in self._stages]
        return that

    def _save_stages(self, path: str, stages) -> None:
        if os.path.exists(path):
            raise FileExistsError(f"path {path} already exists")
        os.makedirs(path)
        DefaultParamsWriter.save_metadata(self, path, extra={"stageUids": [s.uid for s in stages]})
        for i, stage in enumerate(stages):
            if not isinstance(stage, MLWritable):
                raise TypeError(f"stage {stage.uid} is not MLWritable")
            stage.save(os.path.join(path, "stages", f"{i}_{stage.uid}"))

    @classmethod
    def _load(cls, path: str):
        meta = DefaultParamsReader.load_metadata(path)
        stages = [
            DefaultParamsReader.load_instance(os.path.join(path, "stages", f"{i}_{uid}"))
            for i, uid in enumerate(meta["stageUids"])
        ]
        obj = cls(stages=stages)
        obj.uid = meta["uid"]
        return obj

    def save(self, path: str) -> None:
        self._save_stages(path, self._stages)

    @classmethod
    def load(cls, path: str):
        return cls._load(path)


class Pipeline(Estimator, _StagesMixin, MLWritable, MLReadable):
    _uid_prefix = "Pipeline"
    _persist_class = "spark_rapids_ml_tpu.pipeline.Pipeline"

    def __init__(self, stages: Optional[List] = None, uid=None):
        super().__init__(uid=uid)
        self._stages = list(stages or [])

    def setStages(self, stages: List) -> "Pipeline":
        self._stages = list(stages)
        return self

    def getStages(self) -> List:
        return list(self._stages)

    def _fit(self, dataset) -> "PipelineModel":
        fitted = []
        current = dataset
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
            elif isinstance(stage, Model):
                model = stage
            else:
                raise TypeError(
                    f"stage {i} ({type(stage).__name__}) is neither an "
                    f"Estimator nor a Model/transformer"
                )
            fitted.append(model)
            if i < len(self._stages) - 1:  # the last output is never consumed
                current = model.transform(current)
        pm = PipelineModel(stages=fitted)
        pm.uid = self.uid
        return pm


class PipelineModel(Model, _StagesMixin, MLWritable, MLReadable):
    _uid_prefix = "PipelineModel"
    _persist_class = "spark_rapids_ml_tpu.pipeline.PipelineModel"

    def __init__(self, stages: Optional[List] = None, uid=None):
        super().__init__(uid=uid)
        self._stages = list(stages or [])

    @property
    def stages(self) -> List:
        return list(self._stages)

    def _transform(self, dataset):
        current = dataset
        for stage in self._stages:
            current = stage.transform(current)
        return current
