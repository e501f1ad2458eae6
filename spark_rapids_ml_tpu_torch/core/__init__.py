"""Core framework layer of the port: the Spark-ML-contract params,
estimators and models, the dataset abstraction and model persistence
(the JAX package's ``core`` re-exports, name for name)."""

from spark_rapids_ml_tpu_torch.core.params import (
    Param,
    Params,
    Estimator,
    Model,
    TypeConverters,
    HasInputCol,
    HasOutputCol,
    HasLabelCol,
    HasPredictionCol,
    HasFeaturesCol,
    HasSeed,
    HasTol,
    HasMaxIter,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
)
from spark_rapids_ml_tpu_torch.core.dataset import (
    as_matrix,
    as_column,
    with_column,
    num_rows,
)
from spark_rapids_ml_tpu_torch.core.persistence import (
    DefaultParamsWriter,
    DefaultParamsReader,
    MLWriter,
    MLReader,
)

__all__ = [
    "Param",
    "Params",
    "Estimator",
    "Model",
    "TypeConverters",
    "HasInputCol",
    "HasOutputCol",
    "HasLabelCol",
    "HasPredictionCol",
    "HasFeaturesCol",
    "HasSeed",
    "HasTol",
    "HasMaxIter",
    "HasRegParam",
    "HasElasticNetParam",
    "HasFitIntercept",
    "as_matrix",
    "as_column",
    "with_column",
    "num_rows",
    "DefaultParamsWriter",
    "DefaultParamsReader",
    "MLWriter",
    "MLReader",
]
