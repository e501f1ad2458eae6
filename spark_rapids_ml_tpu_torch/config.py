"""Runtime configuration of the PyTorch port.

The counterpart of ``spark_rapids_ml_tpu/config.py``, cut to the keys the
port reads (PCA, KMeans, LinearRegression, LogisticRegression,
NearestNeighbors and ApproximateNearestNeighbors, the random forests, the
data-plane daemon's watermarks, the Spark fit policies, the multi-daemon
reduce path, the native bridge, the default mesh's axes and the metrics
switch).
Values are settable programmatically or through environment variables
prefixed ``SRML_TORCH_`` — a prefix of its own, so the port never inherits
the JAX package's ``SRML_TPU_*`` settings; the deployment-facing
``SRML_FIT_DAEMON_JOIN_*`` and ``SRML_FOREST_*`` keep their full names, as
there.

There is no ``use_pallas`` switch, and no ``ann_fused_scan``: the device
of the tensor decides. A CUDA tensor goes through the hand-written kernel,
a CPU tensor through its plain PyTorch version (``ops/kernels.py``). The
IVF query always takes the JAX package's fused flow (the scan kernel, an
exact per-slot selection); only float64 accumulators take its XLA flow,
in plain PyTorch.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import torch

_PREFIX = "SRML_TORCH_"


def _env(name: str, default: str) -> str:
    return os.environ.get(_PREFIX + name, default)


_DEFAULTS: Dict[str, Any] = {
    # Dtype of the big GEMM operands. "auto" = bfloat16 on CUDA (the
    # tensor-core type of the fold), float32 on the CPU.
    "compute_dtype": _env("COMPUTE_DTYPE", "auto"),
    # Dtype of the (count, colsum, Gram) accumulators. The kernels
    # accumulate in float32; float64 is the parity mode the tests run.
    "accum_dtype": _env("ACCUM_DTYPE", "float32"),
    # Eigensolver: "full" (exact eigh) or "randomized" (subspace
    # iteration with a seeded torch.Generator).
    "solver": _env("SOLVER", "full"),
    # Where the eigensolve runs: "device" = torch.linalg.eigh in float64 on
    # the fit's device, "host" = numpy/LAPACK float64; "auto" = "device".
    "finalize": _env("FINALIZE", "auto"),
    # IVF query: per-(list, slot) shortlist multiplier. The rerank
    # rescores ann_shortlist_mult·k candidates (2·mult·k in the float64
    # flow, whose per-slot selection keeps mult·k rows).
    "ann_shortlist_mult": int(_env("ANN_SHORTLIST_MULT", "2")),
    # IVF query: rescore the shortlist exactly from the stored f32 rows.
    # Off answers from the residual-identity scan scores, whose values
    # carry the packed-key mantissa floor.
    "ann_rerank": _env("ANN_RERANK", "true").lower() not in ("0", "false", "off"),
    # IVF query: rerank width in units of k; 0 = auto (ann_shortlist_mult,
    # 2·ann_shortlist_mult in the float64 flow).
    "ann_rerank_width": int(_env("ANN_RERANK_WIDTH", "0")),
    # IVF query: rows each (list, slot) keeps under rerank: "auto" =
    # ceil(1.2·k), "wide" = ann_shortlist_mult·k, "narrow" = k, or an
    # integer. Without rerank the scan keeps k.
    "ann_extract": _env("ANN_EXTRACT", "auto"),
    # Data-plane daemon backpressure (serve/daemon.py; 0 = unlimited):
    # past either watermark, feed/feed_raw/ensure_model/transform are shed
    # with `busy` and a retry_after_s hint.
    "daemon_max_connections": int(_env("DAEMON_MAX_CONNECTIONS", "0")),
    "daemon_max_staged_bytes": int(_env("DAEMON_MAX_STAGED_BYTES", "0")),
    "daemon_retry_after_s": float(_env("DAEMON_RETRY_AFTER_S", "1.0")),
    # Served-model registry cap (0 = unbounded): past it, the least
    # recently used registration is evicted.
    "daemon_max_models": int(_env("DAEMON_MAX_MODELS", "0")),
    # The host library libsrml_tpu.so (bridge/native.py) for the Arrow
    # gathers; off, or when the library is absent, numpy does them.
    "use_native_bridge": _env("USE_NATIVE_BRIDGE", "true").lower() not in ("0", "false", "off"),
    # Spark fit policies (spark/daemon_session.py reads each after its
    # $SRML_FIT_* env and its spark.srml.fit.* conf). Pass replays after a
    # daemon incarnation change; 0 = off, a restart mid-fit fails loudly.
    "fit_recovery_attempts": int(_env("FIT_RECOVERY_ATTEMPTS", "0")),
    # Peer daemons one fit may declare permanently dead and quarantine (the
    # elastic degrade; 0 = off: a lost daemon fails the fit loudly and no
    # liveness probe runs).
    "fit_daemon_loss_tolerance": int(_env("FIT_DAEMON_LOSS_TOLERANCE", "0")),
    # The death deadline: a peer implicated in a failed pass is probed with
    # this as its whole reconnect budget before it is declared dead.
    "fit_daemon_death_timeout_s": float(_env("FIT_DAEMON_DEATH_TIMEOUT_S", "15.0")),
    # Admission of a daemon that appears mid-fit: "off" (an unlisted peer
    # fails its tasks loudly) or "boundary" (admitted at the next pass
    # boundary, seeded from the recovery ledger). Deployment-facing env
    # names, as in the JAX package.
    "fit_daemon_join_policy": os.environ.get("SRML_FIT_DAEMON_JOIN_POLICY", "off"),
    # The join budget: daemons one fit may admit mid-fit; one more fails the
    # fit loudly.
    "fit_daemon_join_limit": int(os.environ.get("SRML_FIT_DAEMON_JOIN_LIMIT", "2")),
    # Histogram tree ensembles (models/random_forest.py); deployment-facing
    # env names, as in the JAX package. Row cap of the prefix sample that
    # trains the quantile bin edges.
    "forest_seed_sample_rows": int(os.environ.get("SRML_FOREST_SEED_SAMPLE_ROWS", "65536")),
    # Budget (MiB) of one frontier's (tree, node, feature, bin, stat)
    # histogram: over it, the fit refuses at the pass that would allocate
    # it (ForestCapacityError), never a mid-pass out-of-memory. 0 = none.
    "forest_hist_budget_mb": int(os.environ.get("SRML_FOREST_HIST_BUDGET_MB", "256")),
    # Default mesh axis sizes (parallel/mesh.py). The data axis is the
    # world of torch.distributed ranks: None = every rank; a model axis
    # above 1 (the feature-sharded Gram) is refused until its slice lands.
    "mesh_data_axis": int(_env("MESH_DATA_AXIS", "0")) or None,
    "mesh_model_axis": int(_env("MESH_MODEL_AXIS", "1")),
    # On-mesh collective reduce of a multi-daemon fit (spark/estimator.py):
    # when every daemon a pass fed is a member of the primary's process-wide
    # registry (parallel/membership.py), one ``reduce_mesh`` op folds the
    # peers' partials on the device instead of the driver's export/merge
    # hub. False forces the hub everywhere (the path the collective one is
    # held to bitwise).
    "mesh_collectives": _env("MESH_COLLECTIVES", "true").lower() not in ("0", "false", "off"),
    # Metrics registry master switch (utils/metrics.py): False turns every
    # counter/gauge/histogram record into an early return.
    "metrics": _env("METRICS", "true").lower() not in ("0", "false", "off"),
}

_lock = threading.Lock()
_conf: Dict[str, Any] = dict(_DEFAULTS)


def get(key: str) -> Any:
    """The stored value of ``key`` ("auto" left unresolved)."""
    with _lock:
        if key not in _conf:
            raise KeyError(f"unknown config key: {key!r} (known: {sorted(_conf)})")
        return _conf[key]


#: The JAX package's name for the unresolved read; the port's :func:`get`
#: resolves no "auto" (the dtype helpers below do), so the two are one.
get_raw = get


def peek(key: str) -> Any:
    """LOCK-FREE read for per-record hot paths (the metrics gate): a single
    dict lookup, atomic under the GIL, no unknown-key check (None for a
    key that does not exist)."""
    return _conf.get(key)


def set(key: str, value: Any) -> None:  # noqa: A003 - mirrors SparkConf.set
    with _lock:
        if key not in _conf:
            raise KeyError(f"unknown config key: {key!r} (known: {sorted(_conf)})")
        _conf[key] = value


def reset() -> None:
    """Restore the defaults (mainly for tests)."""
    with _lock:
        _conf.clear()
        _conf.update(_DEFAULTS)


def fingerprint() -> str:
    """Stable short hash of the current config (raw values, as stored).
    Two processes with different fingerprints run different effective
    configs — the first thing to check when one rank or replica
    misbehaves."""
    import hashlib
    import json

    with _lock:
        items = sorted(_conf.items())
    blob = json.dumps(items, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def compute_dtype(device) -> torch.dtype:
    """``compute_dtype`` as a torch dtype, "auto" resolved for ``device``."""
    name = get("compute_dtype")
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return getattr(torch, name)


def accum_dtype() -> torch.dtype:
    return getattr(torch, get("accum_dtype"))


class option:
    """Context manager to temporarily override a config value."""

    def __init__(self, key: str, value: Any):
        self._key = key
        self._value = value
        self._saved: Optional[Any] = None

    def __enter__(self) -> "option":
        self._saved = get(self._key)
        set(self._key, self._value)
        return self

    def __exit__(self, *exc: Any) -> None:
        set(self._key, self._saved)
