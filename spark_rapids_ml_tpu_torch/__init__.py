"""spark_rapids_ml_tpu_torch — the PyTorch/CUDA port of spark_rapids_ml_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports
``torch``, numpy and the standard library, never JAX and nothing of the
JAX package, which stays the reference it is tested against. It holds
PCA, LinearRegression, KMeans and LogisticRegression (their in-memory and
streaming fits, transform/predict and persistence), NearestNeighbors
and ApproximateNearestNeighbors (IVF-Flat: build, kneighbors, transform,
persistence), StandardScaler, the histogram RandomForestClassifier and
RandomForestRegressor, Pipeline, the tuners (CrossValidator,
TrainValidationSplit) and the evaluators. The linear-algebra data passes
run in hand-written Hopper kernels: the
Gram family (``ops/csrc/gram.cu``: PCA's fold, LinearRegression's normal
equations and LogisticRegression's weighted Grams, one binomial Newton
pass and the multinomial per-class curvature), KMeans' Lloyd step and
nearest-centre assignment (``ops/csrc/kmeans.cu``), and the exact
distance top-k, the IVF probe and the IVF list scan (``ops/csrc/knn.cu``).
The forests' histograms and the scaler's moments are plain PyTorch, as
the reference's are plain XLA. A Spark fit reaches the card through the
data plane (``serve/``): the executors of a ``spark.SparkPCA`` fit feed a
daemon next to the card. The fits that the JAX package runs across
processes run across ``torch.distributed`` ranks, one process and one
device a rank (``parallel/``).

Entry points run on the card unless the caller passes ``device="cpu"``.

Float32 products run in full float32 for the whole process: TF32 is
turned off once, here, as the JAX package pins ``Precision.HIGHEST``. The
setting is never toggled per call, so concurrent callers (transform served
from threads) all see the same one.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from spark_rapids_ml_tpu_torch import config  # noqa: E402
from spark_rapids_ml_tpu_torch.evaluation import (  # noqa: E402
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel  # noqa: E402
from spark_rapids_ml_tpu_torch.models.knn import (  # noqa: E402
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.linear_regression import (  # noqa: E402
    LinearRegression,
    LinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.logistic_regression import (  # noqa: E402
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel  # noqa: E402
from spark_rapids_ml_tpu_torch.models.random_forest import (  # noqa: E402
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.scaler import (  # noqa: E402
    StandardScaler,
    StandardScalerModel,
)
from spark_rapids_ml_tpu_torch.pipeline import Pipeline, PipelineModel  # noqa: E402
from spark_rapids_ml_tpu_torch.tuning import (  # noqa: E402
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)

__all__ = [
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
    "BinaryClassificationEvaluator",
    "CrossValidator",
    "CrossValidatorModel",
    "KMeans",
    "KMeansModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MulticlassClassificationEvaluator",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "PCA",
    "PCAModel",
    "ParamGridBuilder",
    "Pipeline",
    "PipelineModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "RegressionEvaluator",
    "StandardScaler",
    "StandardScalerModel",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
    "config",
]
