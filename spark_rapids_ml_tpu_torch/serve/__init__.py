"""The data plane: executors feed row batches to a daemon next to the card.

The port of ``spark_rapids_ml_tpu/serve`` for its PCA path. The reference
reaches the accelerator from Spark executors through a device-resident
columnar RDD; here a TCP daemon next to the card (:class:`DataPlaneDaemon`)
takes Arrow IPC or raw record batches from Spark tasks
(:class:`DataPlaneClient`), folds each into the job's device-resident
(count, Σx, XᵀX) state through the hand-written ``gram_colsum`` kernel,
and at ``finalize`` runs the eigensolve: the role the reference's JVM
``RDD.reduce`` played (RapidsRowMatrix.scala:139). The wire protocol
(``protocol``) is the reference's frozen v1. Serving requests from
concurrent connections coalesce into padded micro-batches in the daemon's
:class:`RequestScheduler` (``scheduler``), which sheds with
:class:`SchedulerBusy` (answered ``busy``). Replicas of a served model form
a fleet: each daemon gossips a :class:`FleetView` (``gossip``), and a
:class:`FleetClient` (``router``) routes requests over a
:class:`ConsistentHashRing` of them, failing over past dead and busy
replicas, its :class:`RoutingTable` bootstrapped from one seed daemon
(:func:`bootstrap_table`). A :class:`ModelFleet` (``fleet``) registers
versioned models on the replicas, rolls them forward without downtime
(raising :class:`FleetRolloutError` when no replica takes a version) and
scales the replica set, by hand or under ``autoscaler.AutoScaler``.
Importing this package loads neither JAX nor pyarrow: only the Arrow ops
import pyarrow, at use.
"""

from spark_rapids_ml_tpu_torch.serve.client import DaemonBusy, DataPlaneClient
from spark_rapids_ml_tpu_torch.serve.daemon import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve.fleet import FleetRolloutError, ModelFleet
from spark_rapids_ml_tpu_torch.serve.gossip import FleetView
from spark_rapids_ml_tpu_torch.serve.router import (
    ConsistentHashRing,
    FleetClient,
    FleetUnavailable,
    RoutingTable,
    bootstrap_table,
)
from spark_rapids_ml_tpu_torch.serve.scheduler import RequestScheduler, SchedulerBusy

__all__ = [
    "ConsistentHashRing", "DaemonBusy", "DataPlaneClient", "DataPlaneDaemon",
    "FleetClient", "FleetRolloutError", "FleetUnavailable", "FleetView",
    "ModelFleet", "RequestScheduler", "RoutingTable", "SchedulerBusy",
    "bootstrap_table",
]
