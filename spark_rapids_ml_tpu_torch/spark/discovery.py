"""GPU discovery for Spark's resource scheduling.

The port of ``spark_rapids_ml_tpu/spark/discovery.py`` with the resource
``gpu``. Spark runs a discovery script on each worker, which prints one
JSON object ``{"name": "gpu", "addresses": [...]}``; tasks then read
their share from ``TaskContext.resources()["gpu"]`` (reference README.md:
108-113). ``discovery_payload()`` counts the ``/dev/nvidia<N>`` device
files first and asks ``torch.cuda.device_count()`` only without them; it
never raises, so a worker without a card announces no addresses.
``write_discovery_script`` writes the executable script for
``spark.worker.resource.gpu.discoveryScript``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import stat
from typing import List

RESOURCE_NAME = "gpu"

_SCRIPT = """#!/usr/bin/env bash
# GPU discovery script for Spark resource scheduling
# (spark.worker.resource.gpu.discoveryScript). Prints
# {"name": "gpu", "addresses": [...]} per Spark's discovery protocol.
exec python3 -m spark_rapids_ml_tpu_torch.spark.discovery
"""


def _probe_device_files() -> List[str]:
    """One address per ``/dev/nvidia<N>`` file (no CUDA context needed;
    ``nvidiactl`` and ``nvidia-uvm`` are control nodes, not cards)."""
    paths = [p for p in glob.glob("/dev/nvidia[0-9]*") if re.fullmatch(r"/dev/nvidia\d+", p)]
    return [str(i) for i in range(len(paths))]


def _probe_torch() -> List[str]:
    try:
        import torch

        return [str(i) for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001 - discovery must never crash the worker
        return []


def discovery_payload() -> dict:
    """The JSON object Spark's discovery protocol expects on stdout."""
    return {"name": RESOURCE_NAME, "addresses": _probe_device_files() or _probe_torch()}


def write_discovery_script(path: str) -> str:
    """Write the executable discovery script; returns the path."""
    with open(path, "w") as f:
        f.write(_SCRIPT)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return path


if __name__ == "__main__":
    print(json.dumps(discovery_payload()))
