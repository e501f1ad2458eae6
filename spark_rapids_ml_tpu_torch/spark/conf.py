"""spark-submit configuration of a GPU Spark cluster for the port.

The port of ``spark_rapids_ml_tpu/spark/conf.py`` with the resource name
``gpu``: the upstream spark-rapids recipe the reference's README cites
(README.md:103-113) — ``spark.executor.resource.gpu.amount``, a per-task
fraction, the discovery script, and Arrow on.
"""

from __future__ import annotations

from typing import Dict, Optional

from spark_rapids_ml_tpu_torch.spark.discovery import RESOURCE_NAME


def gpu_session_conf(
    executor_gpus: int = 1,
    tasks_per_gpu: int = 1,
    discovery_script: Optional[str] = None,
    executor_memory: str = "30G",
    driver_memory: str = "20G",
    max_result_size: str = "8G",
    arrow_batch_rows: int = 1 << 16,
) -> Dict[str, str]:
    """The conf dict of a GPU Spark session.

    ``tasks_per_gpu`` > 1 puts several tasks on one card, as the reference
    runs about 12 a GPU (gpu.amount=0.08, README.md:111): tasks feed
    batches, and the daemon next to the card folds them."""
    conf = {
        "spark.driver.memory": driver_memory,
        "spark.executor.memory": executor_memory,
        "spark.driver.maxResultSize": max_result_size,
        f"spark.executor.resource.{RESOURCE_NAME}.amount": str(executor_gpus),
        f"spark.task.resource.{RESOURCE_NAME}.amount": str(round(1.0 / tasks_per_gpu, 4)),
        # Arrow is the columnar interchange with the daemon next to the card.
        "spark.sql.execution.arrow.pyspark.enabled": "true",
        "spark.sql.execution.arrow.maxRecordsPerBatch": str(arrow_batch_rows),
    }
    if discovery_script:
        conf[f"spark.worker.resource.{RESOURCE_NAME}.discoveryScript"] = discovery_script
        conf[f"spark.driver.resource.{RESOURCE_NAME}.discoveryScript"] = discovery_script
    return conf
