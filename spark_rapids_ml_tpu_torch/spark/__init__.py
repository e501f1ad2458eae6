"""Apache Spark integration of the port: the Spark wrappers and their session.

The port of ``spark_rapids_ml_tpu/spark`` for ``SparkPCA``,
``SparkLinearRegression``, ``SparkKMeans``, ``SparkLogisticRegression``,
``SparkNearestNeighbors``, ``SparkApproximateNearestNeighbors`` and
``SparkStandardScaler``. ``SparkRandomForestClassifier`` and
``SparkRandomForestRegressor`` are defined in ``spark.estimator`` and not
exported here, as in the reference.
The reference reaches Spark three ways (SURVEY.md §1), and so does this:

1. the estimator namespace: each wrapper takes a PySpark DataFrame with
   an ArrayType features column (and a label column for the regressions)
   in place of the core estimator's data; fit feeds the daemon next to the
   card from the executors, transform is served by it;
2. the data plane: partitions go to that daemon as Arrow batches
   (``serve/``);
3. GPU resource scheduling: ``write_discovery_script`` writes the script
   for ``spark.worker.resource.gpu.discoveryScript``, and
   ``gpu_session_conf`` builds the spark-submit conf.

pyspark is optional: everything imports without it, and a DataFrame entry
point raises a clear error where it is missing.
"""

from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark.conf import gpu_session_conf
from spark_rapids_ml_tpu_torch.spark.discovery import discovery_payload, write_discovery_script
from spark_rapids_ml_tpu_torch.spark.estimator import (
    SparkApproximateNearestNeighbors,
    SparkKMeans,
    SparkLinearRegression,
    SparkLogisticRegression,
    SparkNearestNeighbors,
    SparkPCA,
    SparkStandardScaler,
    register_dataframe_type,
)

__all__ = [
    "SparkApproximateNearestNeighbors",
    "SparkKMeans",
    "SparkLinearRegression",
    "SparkLogisticRegression",
    "SparkNearestNeighbors",
    "SparkPCA",
    "SparkStandardScaler",
    "daemon_session",
    "discovery_payload",
    "gpu_session_conf",
    "register_dataframe_type",
    "write_discovery_script",
]
