"""Runtime configuration of the PyTorch port.

The counterpart of ``spark_rapids_ml_tpu/config.py``, cut to the keys the
port reads (PCA, KMeans, LinearRegression, LogisticRegression,
NearestNeighbors and ApproximateNearestNeighbors, the random forests, the
data-plane daemon's watermarks, serving scheduler and AOT warmup, the Spark fit
policies, the multi-daemon reduce path, the native bridge, the default
mesh's axes, the metrics switch, the observability plane's journal,
kernel ledger, SLO and flight-recorder keys, the daemon's state directory,
the fleet's version fence, router and gossip keys, the rollout's drain
timeout and the serve autoscaler's keys).
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
    # Default mesh axis sizes (parallel/mesh.py) over the world of
    # torch.distributed ranks: data None = every rank over the model axis.
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
    # The serving scheduler (serve/scheduler.py): cross-connection
    # micro-batching of transform/kneighbors. On by default, as in the JAX
    # package: a batched answer is the solo answer's bits on the paths it
    # batches. Env SRML_TORCH_SERVE_*, never the JAX package's SRML_SERVE_*:
    # a process that imports both must not set both from one variable.
    "serve_batching": _env("SERVE_BATCHING", "true").lower() not in ("0", "false", "off"),
    # Max milliseconds a queued request waits for co-batchable traffic
    # before its micro-batch dispatches anyway.
    "serve_batch_window_ms": float(_env("SERVE_BATCH_WINDOW_MS", "2.0")),
    # Row cap per dispatched micro-batch, floored to a bucket of the ladder.
    "serve_max_batch_rows": int(_env("SERVE_MAX_BATCH_ROWS", "4096")),
    # The bucket ladder (comma-separated ascending row counts): a batch pads
    # up to the smallest bucket that holds it, and a solo transform pads the
    # same way, so one bucket is one product shape. A request larger than
    # the coalescing cap bypasses the scheduler.
    "serve_batch_buckets": _env("SERVE_BATCH_BUCKETS", "64,256,1024,4096"),
    # Run the ladder's trace warmup at registration (ensure_model and a knn
    # finalize) instead of waiting for a `warmup` op; a failed warmup is
    # logged and never fails the registration.
    "serve_warmup_on_register": _env("SERVE_WARMUP_ON_REGISTER", "false").lower()
    not in ("0", "false", "off"),
    # AOT at registration (serve/aot.py): a warmup holds every reachable
    # bucket's serving program on the served instance (a CUDA graph on the
    # card, an eager program on the CPU); models without a plan, a failed
    # capture, or this key off fall back to the trace warmup.
    "serve_aot": _env("SERVE_AOT", "true").lower() not in ("0", "false", "off"),
    # Admission bound: queued requests per served model; overflow, and a
    # request whose deadline the backlog would miss, is shed with `busy`.
    "serve_queue_depth": int(_env("SERVE_QUEUE_DEPTH", "256")),
    # --- The observability plane (utils/{journal,xprof,slo,flight}.py).
    # The JAX package's defaults; env SRML_TORCH_*, never the JAX package's
    # SRML_RUN_JOURNAL / SRML_SLO_* / …: a process that imports both must
    # not arm both journals from one variable. ---
    # Run-journal path: JSON lines of run/phase/mark events. None = off
    # (no event dicts, no I/O).
    "run_journal": _env("RUN_JOURNAL", "") or None,
    # Rotate the journal file (path -> path.1 -> ...) before a line would
    # cross this many bytes, keeping run_journal_keep segments. 0 =
    # unbounded append, required when several processes share one path.
    "run_journal_max_bytes": int(_env("RUN_JOURNAL_MAX_BYTES", "0")),
    "run_journal_keep": int(_env("RUN_JOURNAL_KEEP", "4")),
    # Kernel-ledger timing mode (utils/xprof.py): every kernel call is
    # bracketed by CUDA events and synchronised, so the ledger holds device
    # seconds per call. A measurement mode: it serialises the host and the
    # card. Off by default.
    "device_timing": _env("DEVICE_TIMING", "false").lower() not in ("0", "false", "off"),
    # Journal events the daemon's in-memory ring holds (trace_pull and the
    # flight recorder read it); 0 = no ring.
    "telemetry_trace_buffer": int(_env("TELEMETRY_TRACE_BUFFER", "4096")),
    # Histogram exemplar freshness window (utils/metrics.py).
    "telemetry_exemplar_window_s": float(_env("TELEMETRY_EXEMPLAR_WINDOW_S", "60.0")),
    # The daemon's telemetry thread cadence (SLO burn rates, incident
    # triggers); 0 = no thread (the pull ops still answer).
    "telemetry_eval_interval_s": float(_env("TELEMETRY_EVAL_INTERVAL_S", "1.0")),
    # Declared per-op objectives, "<op>:<kind>[=<target>][@<budget>]" with
    # kind p99_ms|error|shed, semicolon-separated (utils/slo.py).
    "slo_objectives": _env("SLO_OBJECTIVES", ""),
    # The burn-rate windows (a breach needs both over the threshold).
    "slo_fast_window_s": float(_env("SLO_FAST_WINDOW_S", "60.0")),
    "slo_slow_window_s": float(_env("SLO_SLOW_WINDOW_S", "300.0")),
    "slo_burn_threshold": float(_env("SLO_BURN_THRESHOLD", "14.4")),
    # The flight recorder (utils/flight.py): bundles kept under
    # state_dir/incidents (0 = none written), the per-reason debounce, the
    # automatic trigger rates per second (0 = off), and a bundle at SIGTERM
    # or exit.
    "incident_max_bundles": int(_env("INCIDENT_MAX_BUNDLES", "16")),
    "incident_min_interval_s": float(_env("INCIDENT_MIN_INTERVAL_S", "30.0")),
    "incident_shed_rate": float(_env("INCIDENT_SHED_RATE", "0.0")),
    "incident_deadline_rate": float(_env("INCIDENT_DEADLINE_RATE", "0.0")),
    "incident_on_fatal": _env("INCIDENT_ON_FATAL", "false").lower()
    not in ("0", "false", "off"),
    # --- Durable daemons and the routed fleet (serve/{daemon,gossip,router}.py).
    # The JAX package's defaults; env SRML_TORCH_*, never the JAX package's
    # SRML_DAEMON_STATE_DIR / SRML_GOSSIP_* / SRML_FLEET_*. ---
    # The daemon's state directory: its persisted instance identity, the
    # iterative jobs' pass-boundary snapshots, the daemon-built indexes'
    # snapshots and the flight recorder's bundles. None = no durability.
    "daemon_state_dir": _env("DAEMON_STATE_DIR", "") or None,
    # A serving request whose `version` disagrees with the registration's is
    # refused (True) or answered with a warning (False, debugging only).
    "serve_version_strict": _env("SERVE_VERSION_STRICT", "true").lower()
    not in ("0", "false", "off"),
    # How stale the router's polled `health` of a replica may be (also the
    # re-probe interval of a dead replica).
    "fleet_health_poll_s": float(_env("FLEET_HEALTH_POLL_S", "1.0")),
    # Replicas one routed request may try; 0 = one attempt per member.
    "fleet_failover_attempts": int(_env("FLEET_FAILOVER_ATTEMPTS", "0")),
    # Virtual nodes a replica on the consistent-hash ring.
    "fleet_vnodes": int(_env("FLEET_VNODES", "64")),
    # Seconds between a daemon's gossip ticks; 0 = no gossip thread (the
    # view still answers gossip_pull and merges gossip_push).
    "gossip_interval_s": float(_env("GOSSIP_INTERVAL_S", "0.0")),
    # Peers contacted a tick.
    "gossip_fanout": int(_env("GOSSIP_FANOUT", "2")),
    # How long retired-replica and retired-version tombstones gossip before
    # they are pruned; 0 = kept for ever.
    "gossip_tombstone_ttl_s": float(_env("GOSSIP_TOMBSTONE_TTL_S", "600.0")),
    # Comma-separated "host:port" seeds a FleetClient bootstraps from when
    # none are passed.
    "fleet_seed_addresses": _env("FLEET_SEED_ADDRESSES", "") or None,
    # --- The fleet control plane (serve/{fleet,autoscaler}.py). The JAX
    # package's defaults; env SRML_TORCH_FLEET_DRAIN_TIMEOUT_S and
    # SRML_TORCH_AUTOSCALE_*, never SRML_FLEET_* / SRML_AUTOSCALE_*. ---
    # How long a rollout waits for the retired version's in-flight requests
    # before dropping its registrations; a timeout leaves them registered.
    "fleet_drain_timeout_s": float(_env("FLEET_DRAIN_TIMEOUT_S", "30.0")),
    # Scale up when queued requests per live replica reach this.
    "autoscale_high_watermark": float(_env("AUTOSCALE_HIGH_WATERMARK", "8.0")),
    # Scale down at or below this; the band between is the hysteresis.
    "autoscale_low_watermark": float(_env("AUTOSCALE_LOW_WATERMARK", "1.0")),
    # At most one action a cooldown window.
    "autoscale_cooldown_s": float(_env("AUTOSCALE_COOLDOWN_S", "30.0")),
    # The control loop's poll interval.
    "autoscale_tick_s": float(_env("AUTOSCALE_TICK_S", "2.0")),
    # The replica count's floor and ceiling.
    "autoscale_min_replicas": int(_env("AUTOSCALE_MIN_REPLICAS", "1")),
    "autoscale_max_replicas": int(_env("AUTOSCALE_MAX_REPLICAS", "8")),
    # Routed p99 over this forces a scale-up verdict; 0 = off.
    "autoscale_p99_deadline_s": float(_env("AUTOSCALE_P99_DEADLINE_S", "0.0")),
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
