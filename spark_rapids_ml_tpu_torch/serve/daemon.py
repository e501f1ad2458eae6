"""The data-plane daemon: the executor-to-card feeding path.

The port of ``spark_rapids_ml_tpu/serve/daemon.py``, cut to the jobs of
the pca, linreg, kmeans, logreg, rf and knn estimators and their
serving, and the StandardScaler's (a pca job finalized to its raw
moments, and the served ``scaler`` model). A
TCP server next to the card accepts row batches from Spark tasks (Arrow
IPC ``feed``, or raw little-endian ``feed_raw`` frames where no Arrow
library is at hand), folds each batch into the device-resident additive
state of its job, and at ``finalize`` solves and sends the model back —
the reference's executors-fold, Spark-driver-finalizes design, with the
fold next to the accelerator.

pca and linreg are single-pass (``feed``, ``commit``, ``finalize``).
kmeans, logreg and rf are iterative: the driver scans the data once per
pass (feeds carry ``pass_id``), then ``step`` applies the Lloyd or Newton
update, or grows every tree one level, and opens the next pass;
``get_iterate``/``set_iterate`` read and install the iterate (the driver's
recovery ledger; a ``set_iterate`` carrying ``n_cols``, ``algo`` and
``params`` creates a job the daemon lost). A kmeans job is seeded by the
driver's ``seed`` op (its rows are not folded) or by its first
unpartitioned feed. Labels ride the feed: the Arrow table's ``label_col``,
or ``feed_raw``'s ``y`` array.

An rf job's iterate is the forest: the driver's quantile bin edges and
the dense node tables, installed by a creating ``set_iterate`` before the
first scan (a feed before it is refused). Each pass accumulates one
(tree, node, feature, bin, stat) histogram of the open frontier; a feed's
rows bin in the accumulation dtype against the edges, and its bootstrap
bags are keyed on the rows' (partition, offset) identity, the offset
being the stage's row count (the pass's, for a direct feed) before the
feed, so a replayed attempt draws the same bags. ``step`` grows every tree
one level (``models/random_forest.grow_level``) and opens the next depth.

A knn job's state is the dataset: its feeds stage host float32 row blocks
(no device work) and ``commit`` files them under their partition, so the
rows concatenate partition-major however the commits interleaved.
``finalize`` BUILDS the index from them (exact: the rows themselves;
ivf: ``models/knn.build_ivf_flat_device`` or ``build_ivf_flat``, below)
and registers it for ``kneighbors``
serving under ``register_as``: the dataset-sized index never crosses the
wire. ``sample_rows`` reads a seeded sample of the committed rows.

Threading: one acceptor thread and one thread per connection (Spark task).
Concurrent feeds to one job serialize on the job's lock around the fold;
the fold is an associative add, so arrival order does not matter. Every
device section (fold, stage creation, commit add, finalize, index build,
transform, kneighbors) also takes the process-wide ``_DEVICE_LOCK``,
always innermost — after any job or model lock, never before one — so the
lock order stays acyclic. Nothing builds under it: on a card, ``start()``
builds (when needed) and loads the three kernel libraries before it
listens, with no lock held, so a launch under ``_DEVICE_LOCK`` never waits
on ``nvcc``.

Exactly-once under Spark task retry: a feed may carry ``partition`` and
``attempt``. Partitioned feeds fold into a stage of their own per
(partition, attempt); ``commit`` adds the stage into the job state. The
first attempt of a partition to commit wins; the others' stages are freed,
and feeds or commits for an already-committed partition are acknowledged
without folding. A client that lost an ack resends the op with the same
``feed_id``, which folds at most once per stage (per job for direct
feeds).

Operations: jobs idle longer than ``ttl`` are evicted by a reaper thread
(``clock`` is injectable); a daemon-built index, which no client can
re-register, is held 8 times longer and is the last to go under the model
cap; an optional shared ``token`` is checked in constant time on every
op; past a connection or staged-bytes watermark, ops that add load are
shed with ``busy`` and a ``retry_after_s`` hint.

Beyond the reference, ``seed``, ``transform`` and ``kneighbors`` also
take their rows as raw ``arrays`` frames (the ``feed_raw`` framing, array
``x``) in place of the Arrow payload, for a caller without an Arrow
library; the JAX daemon reads only the Arrow form. ``ensure_model`` also
registers an exact index (algo "knn", arrays ``{"database"}``). An ivf
finalize routes as the reference's: ``build="device"``, or "auto" while
the rows' bytes stay within ``SRML_TORCH_IVF_DEVICE_BUILD_MAX`` (4 GiB by
default), builds with ``build_ivf_flat_device`` and serves the index from
the device; "host", or "auto" past the cap, with the host-bucketed
``build_ivf_flat``.

The multi-daemon fit plane: ``merge_state`` folds a peer daemon's
exported state into a job (the driver's hub), and ``mesh_info`` and
``reduce_mesh`` serve the collective path. Every daemon registers
``(instance_id, boot_id)`` in the process-wide membership registry
(``parallel/membership.py``) at ``start()`` and leaves it at ``stop()``;
``reduce_mesh`` folds the pass partials of peers in that registry, which
share this process's device plane, straight from their job states. A
merge adds tensors elementwise, the job's own state the left operand and
the peers in sorted-id order, so the two paths agree bitwise. A knn job
refuses to merge: its state is the dataset.

Fault sites (utils/faults.py), at the JAX daemon's points relative to the
same work: ``daemon.conn`` per accepted connection, ``daemon.op`` per
request after the version check and before the watermark shed,
``daemon.pass_boundary`` between an applied ``step`` and its ack,
``daemon.vanish`` at the cross-daemon coordination ops (``export_state``,
``reduce_mesh``, ``set_iterate``: the permanent-loss site of the elastic
fit) and ``daemon.join`` on the job-creating ``set_iterate`` path (the
mid-fit admission handshake). An injected drop closes the connection, as
any transport failure does.

Serving (``transform``, ``kneighbors``) goes through the serving scheduler
(``serve/scheduler.py``, config ``serve_batching``, on by default): requests
from concurrent connections to one model coalesce into one padded dispatch
on the bucket ladder, a request larger than the coalescing cap and every
IVF/ANN ``kneighbors`` run alone, and an admission shed answers ``busy``. A
solo transform pads to the same ladder, so one bucket is one product shape
however a request was served. ``warmup`` is AOT-first, as in the
reference (``docs/protocol.md`` "AOT at registration"): with ``serve_aot``
on and a model that publishes ``_serve_aot_plan``, every reachable bucket's
serving program is built once and held on the served instance
(``serve/aot.py``: a CUDA graph on the card, replaying the exact index's
``dist_topk`` kernel; an eager program on the CPU), the scheduler's shape
ledger is pre-marked, and a request at a primed shape runs the held
program; ``model_status`` reports its ``aot`` ledger. A model without a
plan (the IVF index), a failed capture or ``serve_aot`` off falls back to
the trace warmup, a zero batch dispatched at every reachable bucket, and
acks ``aot`` false. Both run at registration too with
``serve_warmup_on_register``. ``health`` (load, the scheduler block, the
mesh epoch) and ``metrics`` (the registry, as JSON or Prometheus text) are
never shed; every request is counted by op and outcome, with its latency
and its payload bytes.

The telemetry plane, as in the reference: each dispatched op adopts the
request's ``trace_ctx`` (a ``{"run", "span"}`` frame the client stamps) and
runs inside a ``daemon.<op>`` journal span (``utils/journal.py``; the
liveness and scrape ops of ``_UNJOURNALED_OPS`` excepted), so one fit's
driver, tasks and daemons journal one tree; the span's identity is the
exemplar of the request's latency sample. ``start()`` arms the journal's
in-memory ring (``telemetry_trace_buffer`` events), installs a flight
recorder (``utils/flight.py``) as the process default, subscribed to fired
fault sites, and runs a telemetry thread every ``telemetry_eval_interval_s``
(SLO burn rates, ``utils/slo.py``; the ``slo_breach``, ``shed_storm`` and
``deadline_breach`` triggers). ``trace_pull`` streams the ring from a
cursor; ``telemetry_pull`` answers the registry as OpenMetrics text with
exemplars and as JSON, the kernel ledger (``utils/xprof.py``) and the
config fingerprint. Neither is shed or journaled.

Crash recovery (docs/protocol.md "Crash recovery"), as in the reference:
with a ``state_dir`` (config ``daemon_state_dir``) the daemon persists its
instance identity there, so a restarted daemon keeps its ``instance_id``
(``boot_id`` is fresh every start), and write-ahead-snapshots the kmeans,
logreg and rf jobs at every pass boundary (``seed``, ``step``,
``set_iterate``: the iterate, the pass counter and the creation params,
atomic tmp+rename through ``core/checkpoint.py``) before the boundary's
ack; a restarted daemon restores a job lazily at its first mention.
Pass-local state (stages, the pass's statistics, dedupe memories) dies
with the incarnation: the recovery unit is the pass, which the driver
replays. pca, linreg and knn jobs are single-pass, so their recovery unit
is the driver's scan. A knn finalize snapshots the built index before its
ack, and the index too is restored at its first mention (``transform``,
``kneighbors``, ``warmup``, ``model_status``); ``ensure_model``
registrations stay volatile (their clients hold the arrays). The reaper
keeps a live index's snapshot fresh, holds an evicted one on disk 8× the
TTL, and sweeps orphan job snapshots and crashed writes' temp files. The
flight recorder's bundles land under ``state_dir/incidents/``.

The fleet, as in the reference: ``ensure_model`` takes an immutable
``version``, and ``transform``/``kneighbors`` carrying another ``version``
are refused under ``serve_version_strict``; every serving ack echoes the
registration's ``version`` and the request's ``fleet_epoch``. Each daemon
holds a gossiped ``FleetView`` (``serve/gossip.py``) with its own replica
record, answers ``gossip_pull``, merges ``gossip_push`` (answering with
its view), and with ``gossip_interval_s`` > 0 runs a thread that exchanges
the view with ``gossip_fanout`` peers a tick (fault site ``gossip.push``).

A feed naming an unknown ``algo``, or an ``ensure_model`` naming an
unknown model, is refused before a job or model is registered.
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import json
import math
import os
import random
import socket
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core import checkpoint as checkpoint_mod
from spark_rapids_ml_tpu_torch.models import kmeans as km_mod
from spark_rapids_ml_tpu_torch.models import knn as knn_mod
from spark_rapids_ml_tpu_torch.models import linear_regression as lr_mod
from spark_rapids_ml_tpu_torch.models import logistic_regression as lg_mod
from spark_rapids_ml_tpu_torch.models import random_forest as rf_mod
from spark_rapids_ml_tpu_torch.models.pca import PCAModel, finalize_pca_stats
from spark_rapids_ml_tpu_torch.models.scaler import StandardScalerModel
from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
from spark_rapids_ml_tpu_torch.ops import histogram as hist_ops
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.parallel import membership as membership_mod
from spark_rapids_ml_tpu_torch.parallel.sharding import as_tensor, resolve_device
from spark_rapids_ml_tpu_torch.serve import aot as aot_mod
from spark_rapids_ml_tpu_torch.serve import gossip as gossip_mod
from spark_rapids_ml_tpu_torch.serve import protocol
from spark_rapids_ml_tpu_torch.serve import scheduler as scheduler_mod
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import flight as flight_mod
from spark_rapids_ml_tpu_torch.utils import journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils import slo as slo_mod
from spark_rapids_ml_tpu_torch.utils import xprof as xprof_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

logger = get_logger("serve.daemon")

#: The job algos this daemon runs.
_ALGOS = ("pca", "linreg", "kmeans", "logreg", "rf", "knn")

#: The algos whose feeds carry labels.
_LABELLED = ("linreg", "logreg", "rf")

#: Ops whose request JSON is followed by one Arrow IPC payload frame
#: (docs/protocol.md; ``seed`` and ``kneighbors`` unless they carry
#: ``arrays``). A rejection drains that frame so the framing stays aligned.
_PAYLOAD_OPS = ("feed", "seed", "transform", "kneighbors")

#: Ops whose raw array frames follow the request per its ``arrays`` spec.
_ARRAY_OPS = ("ensure_model", "merge_state", "set_iterate", "feed_raw", "finalize", "seed",
              "kneighbors", "transform")

#: Payload ops that take raw ``arrays`` frames in place of the Arrow frame.
_RAW_OR_ARROW_OPS = ("seed", "kneighbors", "transform")

#: Ops shed with `busy` + retry_after_s over a watermark: the ones that
#: ADD load. Pressure-relieving ops (commit, finalize, drop) and O(1)
#: control ops (ping, health, metrics, status) always pass.
_SHEDDABLE_OPS = ("feed", "feed_raw", "seed", "transform", "kneighbors", "ensure_model",
                  "warmup")

#: Process-wide device lock (see the module docstring): taken innermost.
_DEVICE_LOCK = threading.Lock()

#: The ivf finalize's device-build cap, in bytes of the committed rows
#: (the reference's default): within it ``build="auto"`` builds and keeps
#: the index on the device; past it, or at ``build="host"``, the rows are
#: bucketed in host memory (docs/ann-capacity.md "Build policy").
_IVF_DEVICE_BUILD_MAX_BYTES = int(os.environ.get("SRML_TORCH_IVF_DEVICE_BUILD_MAX", 4 << 30))

#: Every op _dispatch understands: the clamp for metric labels, so a label
#: from the wire cannot mint unbounded registry series (an unknown op
#: string counts under op="unknown").
_KNOWN_OPS = frozenset((
    "ping", "health", "metrics", "status", "feed", "feed_raw", "seed",
    "commit", "step", "finalize", "drop", "export_state", "merge_state",
    "get_iterate", "set_iterate", "ensure_model", "transform",
    "kneighbors", "model_status", "drop_model", "warmup", "sample_rows",
    "mesh_info", "reduce_mesh", "gossip_push", "gossip_pull",
    "telemetry_pull", "trace_pull",
))


def _op_label(op) -> str:
    op = str(op)
    return op if op in _KNOWN_OPS else "unknown"


#: Ops that never open a journal span, even with the journal on: O(1)
#: liveness probes and scrapes, which would bury a fit's tree under
#: polling noise.
_UNJOURNALED_OPS = frozenset((
    "ping", "health", "metrics", "model_status", "gossip_push",
    "gossip_pull", "telemetry_pull", "trace_pull",
))


@contextlib.contextmanager
def _op_trace(op: str, req: Dict[str, Any]):
    """Adopt the request's ``trace_ctx`` around one dispatched op, so the op
    span opened here, and every ``trace_span`` the op runs, parent into the
    caller's run; without a context the span roots itself, and with the
    journal and the ring off this is an early return. Yields the op span's
    ``{"run", "span"}`` identity (None when unjournaled): the latency
    histogram keeps it as the sample's exemplar."""
    tc = req.get("trace_ctx")
    tc = tc if isinstance(tc, dict) else {}
    with journal.adopt(tc.get("run"), tc.get("span")):
        if op not in _UNJOURNALED_OPS and journal.active():
            fields = {k: req[k] for k in ("job", "model") if req.get(k) is not None}
            with journal.span(f"daemon.{op}", **fields):
                yield journal.trace_ctx()
        else:
            yield None


#: Daemon telemetry: the JAX package's names, labels and help texts. The
#: ``metrics`` op exposes the whole registry.
_M_REQUESTS = metrics_mod.counter(
    "srml_daemon_requests_total",
    "Requests dispatched, by op and outcome (ok|error|transport)",
)
_M_REQ_SECONDS = metrics_mod.histogram(
    "srml_daemon_request_seconds", "Request handling latency, by op"
)
_M_RX_BYTES = metrics_mod.counter(
    "srml_daemon_rx_bytes_total",
    "Payload bytes received (Arrow/raw frames, headers excluded), by op",
)
_M_TX_BYTES = metrics_mod.counter(
    "srml_daemon_tx_bytes_total",
    "Response array bytes sent (headers excluded), by op",
)
_M_BUSY_SHEDS = metrics_mod.counter(
    "srml_daemon_busy_sheds_total",
    "Ops shed with busy under a backpressure watermark, by op",
)
_M_REPLAY_HITS = metrics_mod.counter(
    "srml_daemon_replay_hits_total",
    "Deduplicated replays, by kind (feed|merge|step|committed_partition)",
)
_M_CONNS = metrics_mod.gauge(
    "srml_daemon_active_connections",
    "Concurrently open connections (at scrape)",
)
_M_STAGED = metrics_mod.gauge(
    "srml_daemon_staged_bytes", "Bytes held by uncommitted stages (at scrape)"
)
_M_JOBS = metrics_mod.gauge(
    "srml_daemon_active_jobs", "Registered accumulation jobs (at scrape)"
)
_M_MODELS = metrics_mod.gauge(
    "srml_daemon_served_models", "Registered served models (at scrape)"
)
_M_JOB_RESTORES = metrics_mod.counter(
    "srml_daemon_job_restores_total",
    "Jobs resurrected from durable pass-boundary state after a restart, "
    "by algo",
)
_M_MODEL_EVICTIONS = metrics_mod.counter(
    "srml_daemon_model_evictions_total",
    "Served models evicted from the registry, by reason (lru = over the "
    "daemon_max_models cap; ttl = idle past the reaper's deadline)",
)
_M_MESH_REDUCES = metrics_mod.counter(
    "srml_daemon_mesh_reduces_total",
    "On-mesh collective reduces applied (reduce_mesh op: co-resident "
    "peer partials folded on the device plane, no driver hub), by algo",
)
_M_GOSSIP_TICKS = metrics_mod.counter(
    "srml_gossip_ticks_total",
    "Gossip-thread ticks run, by outcome (ok = every contacted peer "
    "exchanged; partial = some peer push dropped this tick)",
)

#: Cap on a request's declared raw-array frames (_recv_arrays_aligned): a
#: PCA model registration carries 3 arrays; 16 leaves headroom without
#: letting a hostile spec queue hundreds of 2 GB frames.
_MAX_ARRAY_SPECS = 16

#: Bound on remembered direct-feed feed_ids per job (FIFO eviction: a
#: replay arrives right after its original, never 4096 ops later).
_MAX_SEEN_FEED_IDS = 4096


def _recv_arrays_aligned(conn, req: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Receive a request's raw array frames with framing-safe parsing: every
    declared frame is drained off the socket before any dtype/shape error
    is raised, so a bad spec errors cleanly and the connection stays
    usable. The spec count and the declared bytes are capped BEFORE any
    frame is buffered, and a frame whose size disagrees with its spec is
    refused (declare tiny, send 2 GB would reopen that bound)."""
    specs = list(req.get("arrays") or [])
    over = None
    sizes = []
    if len(specs) > _MAX_ARRAY_SPECS:
        over = (
            f"request declares {len(specs)} array frames; the protocol ops "
            f"need at most {_MAX_ARRAY_SPECS}"
        )
    else:
        declared = 0
        for spec in specs:
            # Python ints (no np.prod): hostile 2^33-scale dims must not
            # wrap an int64 product back under the cap.
            try:
                shape = [int(s) for s in spec["shape"]]
                if any(s < 0 for s in shape):
                    raise ValueError(f"negative dim in shape {shape}")
                nbytes = np.dtype(spec["dtype"]).itemsize * math.prod(shape)
            except (KeyError, TypeError, ValueError) as e:
                over = f"bad array spec: {e}"
                break
            sizes.append(nbytes)
            declared += nbytes
        if over is None and declared > protocol.MAX_FRAME:
            over = (
                f"request declares {declared} summed array bytes > "
                f"MAX_FRAME {protocol.MAX_FRAME}; split the batch"
            )
    if over is not None:
        # Drain one frame at a time, discarding as we go.
        for _ in specs:
            if protocol.recv_frame(conn) is None:
                break
        raise protocol.ProtocolError(over)
    frames = []
    with trace_span("daemon frame receive"):
        for i in range(len(specs)):
            frame = protocol.recv_frame(conn)
            if frame is None:
                raise protocol.ProtocolError("connection closed mid-array")
            if len(frame) != sizes[i]:
                got, want = len(frame), sizes[i]
                del frame
                for _ in range(i + 1, len(specs)):
                    if protocol.recv_frame(conn) is None:
                        break
                raise protocol.ProtocolError(
                    f"array frame {i} carries {got} bytes; its spec declared {want}"
                )
            frames.append(frame)
    if sizes:
        _M_RX_BYTES.inc(sum(sizes), op=_op_label(req.get("op")))
    out: Dict[str, np.ndarray] = {}
    with trace_span("daemon frame decode"):
        for spec, frame in zip(specs, frames):
            arr = np.frombuffer(frame, dtype=np.dtype(spec["dtype"]))
            out[str(spec["name"])] = arr.reshape(spec["shape"]).copy()
    return out


def _recv_arrow_matrix(conn, op: str, input_col: str, n_cols, label_col=None):
    """One Arrow IPC payload frame -> (the (n, d) matrix of ``input_col``,
    the labels of ``label_col`` or None when it is None). The frame is read
    BEFORE pyarrow is imported, so a daemon without pyarrow (the GPU image)
    answers the error with the framing aligned."""
    with trace_span("daemon frame receive"):
        payload = protocol.recv_frame(conn)
    if payload is None:
        raise protocol.ProtocolError(f"connection closed before {op} payload")
    _M_RX_BYTES.inc(len(payload), op=op)
    import pyarrow as pa

    from spark_rapids_ml_tpu_torch.bridge.arrow import table_column_to_matrix

    with trace_span("daemon frame decode"):
        with pa.ipc.open_stream(payload) as reader:
            table = reader.read_all()
        x = table_column_to_matrix(table, input_col, n_cols)
        if label_col is None:
            return x, None
        if label_col not in table.column_names:
            raise KeyError(f"label column {label_col!r} not in batch")
        return x, np.asarray(table.column(label_col).to_numpy(zero_copy_only=False))


def _recv_raw_matrix(conn, req: Dict[str, Any], op: str) -> np.ndarray:
    """The 2-D ``x`` of a request's raw ``arrays`` frames, held to its
    declared ``n_cols``."""
    x = _recv_arrays_aligned(conn, req).get("x")
    if x is None or x.ndim != 2:
        raise ValueError(f"a raw {op} needs a 2-D 'x' array in the request spec")
    n_cols = req.get("n_cols")
    if n_cols is not None and int(n_cols) != x.shape[1]:
        raise ValueError(f"{op} 'x' width {x.shape[1]} != declared n_cols {n_cols}")
    return x


def _send_arrays_counted(conn, op: str, arrays, meta) -> None:
    """``protocol.send_arrays`` and the per-op TX byte count (array bytes;
    the JSON headers are noise beside the frames)."""
    protocol.send_arrays(conn, arrays, meta)
    _M_TX_BYTES.inc(sum(int(np.asarray(v).nbytes) for v in arrays.values()), op=op)


def _opt(req: Dict[str, Any], key: str, default):
    """Optional request field: omitted and JSON null are equivalent
    (docs/protocol.md), so a present-but-null field takes the default."""
    value = req.get(key)
    return default if value is None else value


class _FifoSet:
    """Bounded replay-dedupe memory: `in` + add with FIFO eviction."""

    __slots__ = ("_set", "_order", "_cap")

    def __init__(self, cap: int = _MAX_SEEN_FEED_IDS):
        self._set: set = set()
        self._order: deque = deque()
        self._cap = cap

    def __contains__(self, item: str) -> bool:
        return item in self._set

    def add(self, item: str) -> None:
        if item in self._set:
            return
        self._set.add(item)
        self._order.append(item)
        if len(self._order) > self._cap:
            self._set.discard(self._order.popleft())


class _Stage:
    """One (partition, attempt) staged accumulation: its state, rows, the
    bytes it holds (the staged-bytes watermark's input) and the feed_ids
    already folded into it."""

    __slots__ = ("state", "rows", "nbytes", "seen")

    def __init__(self, state, nbytes: int):
        self.state = state
        self.rows = 0
        self.nbytes = nbytes
        self.seen: set = set()


def _state_nbytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state)


class _Job:
    """One accumulation job: its algo, device state, stages, iterate, lock.

    ``algo`` is ``pca``, ``linreg`` (single-pass), ``kmeans`` or ``logreg``
    (iterative: one pass per ``step``, the iterate read and installed with
    ``get_iterate``/``set_iterate``), ``rf`` (iterative, one pass per tree
    depth: the iterate is the forest's host tables ``rf_tables``, the pass
    state the 1-tuple (frontier histogram,), or () while there is no
    iterate or no open node), or ``knn`` (no device state: ``state``
    holds the direct feeds' host float32 row blocks in arrival order and
    ``part_rows`` each committed partition's blocks; finalize builds the
    index from them). ``params`` are the first feed's creation params:
    ``k``, ``seed`` and ``init`` for kmeans, ``n_classes`` for logreg
    (above 2 the job runs the multinomial MM-Newton protocol), the forest
    spec for rf (``models/random_forest.forest_spec_from_params``; its
    ``n_classes`` 0 is a regressor)."""

    def __init__(self, algo: str, n_cols: int, device: torch.device,
                 params: Optional[Dict[str, Any]] = None, clock=time.monotonic):
        if algo not in _ALGOS:
            raise ValueError(f"unknown algo {algo!r} ({'|'.join(_ALGOS)})")
        params = params or {}
        # Capacity gate at creation: a (d, d) accumulator over the device
        # budget is a clean first-feed error, never a device OOM mid-pass.
        # The daemon has one device (a model axis of 1), so the gate's own
        # error is the refusal; a width whose slab fits only sharded belongs
        # on the in-memory model-sharded fit.
        if algo in ("pca", "linreg", "logreg"):
            gram_ops.require_gram_capacity(n_cols)
        self._clock = clock
        self.algo = algo
        self.n_cols = n_cols
        self.device = device
        # Creation params, kept verbatim (JSON-able): a durable snapshot
        # stores them, so a restore can re-run this constructor.
        self.params = dict(params)
        # Durability hook (None = off): called under the job lock at every
        # pass boundary (seed, step, set_iterate) BEFORE the op acks, so an
        # acked boundary is a recoverable one.
        self.snapshot_cb = None
        self.lock = threading.Lock()
        self.rows = 0
        self.pass_rows = 0
        self.iteration = 0
        self.dropped = False
        self.touched = clock()
        self.staged: Dict[tuple, _Stage] = {}
        self.committed: Dict[int, int] = {}
        self.staged_bytes = 0
        self._seen_feed_ids = _FifoSet()
        # The merge_state merge_ids and reduce_mesh reduce_ids already
        # applied: a replay of either folds at most once.
        self._seen_merge_ids = _FifoSet()
        # Step idempotency: a replayed step carrying the id of the step
        # already applied gets the cached info back.
        self._last_step_id: Optional[str] = None
        self._last_step_info: Optional[Dict[str, Any]] = None
        self._accum = config.accum_dtype()
        if algo == "kmeans":
            self.k = int(params.get("k", 0))
            if self.k <= 0:
                raise ValueError("kmeans job needs params={'k': > 0} on first feed")
            self.seed = int(params.get("seed", 0))
            self.init = str(params.get("init", "k-means++"))
            if self.init not in ("k-means++", "random"):
                raise ValueError(f"unknown init {self.init!r} (k-means++|random)")
            self.centers: Optional[torch.Tensor] = None  # seeded before the first fold
        elif algo == "rf":
            self.rf_spec = rf_mod.forest_spec_from_params(params, n_cols)
            # The depth-0 gate at creation; each later depth is gated when
            # its pass opens (_zero_state), never mid-pass.
            rf_mod.require_hist_capacity(self.rf_spec, 0, n_cols)
            self.rf_tables: Optional[Dict[str, np.ndarray]] = None  # set_iterate installs
            self._rf_edges: Optional[torch.Tensor] = None
        elif algo == "knn":
            self.state: list = []
            self.part_rows: Dict[int, list] = {}
            return
        elif algo == "logreg":
            self.n_classes = int(params.get("n_classes") or 2)
            w_shape = (n_cols, self.n_classes) if self.n_classes > 2 else (n_cols,)
            b_shape = (self.n_classes,) if self.n_classes > 2 else ()
            with _DEVICE_LOCK:
                self.w = torch.zeros(w_shape, dtype=self._accum, device=device)
                self.b = torch.zeros(b_shape, dtype=self._accum, device=device)
        with _DEVICE_LOCK:
            self.state = self._zero_state()

    @property
    def multinomial(self) -> bool:
        return self.algo == "logreg" and self.n_classes > 2

    def _zero_state(self):
        """A zero accumulator of one pass (call under _DEVICE_LOCK)."""
        ad, dev, d = self._accum, self.device, self.n_cols
        if self.algo == "rf":
            # () without an iterate (feeds are refused), or once no node is
            # open at the depth: a grown-out forest allocates nothing and
            # passes no capacity gate.
            if self.rf_tables is None or self._rf_open_nodes() == 0:
                return ()
            spec, depth = self.rf_spec, int(self.rf_tables["depth"][0])
            rf_mod.require_hist_capacity(spec, depth, d)
            return (hist_ops.zero_hist(spec.num_trees, depth, d, spec.max_bins, spec.n_stats,
                                       ad, dev),)
        if self.algo == "pca":
            return gram_ops.init_stats(d, ad, dev)
        if self.algo == "linreg":
            return lr_mod.init_normal_eq_stats(d, ad, dev)
        if self.algo == "kmeans":
            return km_mod.stream_zero_state(self.k, d, ad, dev)
        if self.multinomial:
            return lg_mod.stream_softmax_zero_state(d, self.n_classes, ad, dev)
        return lg_mod.stream_zero_state(d, ad, dev)

    def _rf_open_nodes(self) -> int:
        return rf_mod.open_frontier_nodes(self.rf_tables["feature"],
                                          int(self.rf_tables["depth"][0]))

    def _fold_locked(self, state, x: np.ndarray, y: Optional[np.ndarray],
                     bag: tuple = (None, 0)) -> None:
        """Fold one batch into ``state`` in place (call under _DEVICE_LOCK).

        The reference pads each batch to a power-of-two bucket under a row
        mask, which only bounds XLA's compiles; the mask is a prefix of
        ones, so the unpadded batch gives the same statistics. On the card:
        pca is one seeded ``gram_colsum`` launch (``streaming_update_rows``),
        linreg one seeded ``linreg_stats`` launch
        (``streaming_normal_eq_update``), multinomial logreg one
        ``softmax_curvature`` launch with float32 accumulators
        (``softmax_stats_update``); kmeans (``kmeans._stream_update``, the
        reference's ``_stream_step_fn``) and binomial logreg
        (``stream_grad_hess_update``) are plain products, as there; so is
        rf's histogram (``random_forest.accumulate_histogram``: the rows
        binned in the accumulation dtype, as the in-process fit and the
        reference bin them, the bags keyed by ``bag`` = (partition, offset
        of the batch's first row)). (On a TPU the reference's masked PCA
        update reaches ``gram_pallas``; the port folds through
        ``gram_colsum``, as its ``fit_pca_stream`` does.)"""
        if self.algo == "rf":
            y = np.asarray(y, np.float64)  # the reference's label dtype
        with trace_span("daemon host to device"):
            xd = as_tensor(x).to(self.device)
            yd = None if y is None else as_tensor(y).to(self.device).reshape(-1)
        with trace_span("daemon fold"):
            if self.algo == "rf":
                bins = hist_ops.bin_matrix(xd.to(self._accum), self._rf_edges).to(torch.uint8)
                keys = rf_mod.row_identity_keys(bag[0], bag[1], x.shape[0]).astype(np.int64)
                rf_mod.accumulate_histogram(state[0], self.rf_tables, bins, yd, None,
                                            torch.from_numpy(keys).to(self.device),
                                            self.rf_spec)
            elif self.algo == "pca":
                gram_ops.streaming_update_rows(state, xd, n_valid=x.shape[0])
            elif self.algo == "linreg":
                lr_mod.streaming_normal_eq_update(state, xd, yd)
            elif self.algo == "kmeans":
                cd = config.compute_dtype(self.device)
                km_mod._stream_update(state, self.centers, xd.to(cd), cd, self._accum)
            elif self.multinomial:
                lg_mod.softmax_stats_update(state, self.w, self.b, xd, yd)
            else:
                lg_mod.stream_grad_hess_update(state, self.w, self.b, xd, yd)

    def _check_pass(self, pass_id: Optional[int]) -> None:
        """Reject traffic of another pass: a zombie task of a stepped pass
        (its batch saw a stale iterate), or a daemon behind the fit."""
        if pass_id is not None and int(pass_id) != self.iteration:
            if int(pass_id) > self.iteration:
                hint = (" — this daemon is behind the fit (it never saw the earlier passes); "
                        "keep executor→daemon routing sticky across retries")
            else:
                hint = " (zombie task of an already-stepped pass)"
            raise ValueError(
                f"stale pass_id {pass_id} (job is on pass {self.iteration}); "
                f"feed rejected{hint}"
            )

    def _seed_locked(self, x: np.ndarray) -> None:
        """Centres from ``x`` by the job's init and seed (under the job
        lock): host k-means++ or random rows, ``np.random.default_rng(seed)``."""
        init_fn = km_mod._kmeans_plus_plus if self.init == "k-means++" else km_mod._random_init
        with _DEVICE_LOCK, trace_span("daemon seed"):
            c0 = init_fn(np.asarray(x), self.k, np.random.default_rng(self.seed))
            self.centers = torch.as_tensor(c0).to(self.device, self._accum)

    def seed_centers(self, x: np.ndarray) -> None:
        """Deterministic kmeans init from a driver-chosen batch: centres
        only, NO fold (the rows arrive again through the scan)."""
        if self.algo != "kmeans":
            raise ValueError(f"seed only applies to kmeans jobs, not {self.algo!r}")
        if x.shape[0] < self.k:
            raise ValueError(f"seed batch has {x.shape[0]} rows < k={self.k}")
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            if self.centers is None:  # a retried seed keeps the first init
                self._seed_locked(x)
                # The seeded centres are the pass-0 boundary: a restarted
                # daemon reopens pass 0 at the same centres.
                self._maybe_snapshot()
            self.touched = self._clock()

    def _is_replay(self, feed_id: Optional[str], stage: Optional[_Stage]) -> bool:
        """True when this feed_id already folded (call under the lock).
        Read-only: the id is recorded only after the fold succeeded."""
        if feed_id is None:
            return False
        feed_id = str(feed_id)
        hit = feed_id in (stage.seen if stage is not None else self._seen_feed_ids)
        if hit:
            _M_REPLAY_HITS.inc(kind="feed")
        return hit

    def _mark_folded(self, feed_id: Optional[str], stage: Optional[_Stage]) -> None:
        if feed_id is None:
            return
        if stage is not None:
            stage.seen.add(str(feed_id))
        else:
            self._seen_feed_ids.add(str(feed_id))

    def _drop_stage(self, key: tuple) -> Optional[_Stage]:
        stage = self.staged.pop(key, None)
        if stage is not None:
            self.staged_bytes -= stage.nbytes
        return stage

    def _clear_pass(self) -> None:
        """Open a new pass: stages, committed set and pass rows cleared
        (zombie traffic of the finished pass is fenced by pass_id)."""
        self.staged.clear()
        self.staged_bytes = 0
        self.committed.clear()
        self.pass_rows = 0

    def fold(
        self,
        x: np.ndarray,
        y: Optional[np.ndarray] = None,
        partition: Optional[int] = None,
        attempt: int = 0,
        pass_id: Optional[int] = None,
        feed_id: Optional[str] = None,
    ) -> None:
        if x.shape[1] != self.n_cols:
            raise ValueError(f"batch width {x.shape[1]} != job n_cols {self.n_cols}")
        if self.algo in _LABELLED and y is None:
            raise ValueError(f"{self.algo} feed needs a label column")
        if self.algo == "knn":
            self._stage_rows(x, partition, attempt, feed_id)
            return
        n = x.shape[0]
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped; rows not accepted")
            self._check_pass(pass_id)
            self.touched = self._clock()
            if partition is not None and partition in self.committed:
                # duplicate of a committed task (retry/speculation)
                _M_REPLAY_HITS.inc(kind="committed_partition")
                return
            if self.algo == "kmeans" and self.centers is None:
                if partition is not None:
                    raise ValueError(
                        "partitioned kmeans feed before centers are seeded; send a 'seed' "
                        "op from the driver first (deterministic init)"
                    )
                if n < self.k:
                    raise ValueError(
                        f"first kmeans batch has {n} rows < k={self.k}; feed a larger "
                        "first batch (it seeds the centers)"
                    )
                self._seed_locked(x)
            if self.algo == "rf":
                if self.rf_tables is None:
                    raise ValueError(
                        "rf feed before the forest iterate is installed; the driver sends "
                        "set_iterate (bin edges + node tables) to the daemon before the first "
                        "scan (spark.srml.daemon.addresses)")
                if self._rf_open_nodes() == 0:
                    raise ValueError(f"rf feed after the forest grew out (no open node at "
                                     f"depth {int(self.rf_tables['depth'][0])}); finalize")
            stage = None
            fresh_stage = False
            if partition is None:
                if self._is_replay(feed_id, None):
                    return
                state = self.state
            else:
                stage = self.staged.get((partition, attempt))
                if stage is None:
                    with _DEVICE_LOCK:
                        zero = self._zero_state()
                    # Registered only after the fold succeeds: a phantom
                    # empty stage would inflate staged_bytes and let a
                    # commit of this attempt succeed with 0 rows.
                    stage = _Stage(zero, _state_nbytes(zero))
                    fresh_stage = True
                if self._is_replay(feed_id, stage):
                    return
                state = stage.state
            # The bag identity of an rf batch: its rows are (partition,
            # offset..offset+n), the offset read BEFORE this fold and
            # advanced only after it succeeds, so a replayed attempt, or a
            # feed whose fold failed, keys its rows as the first try did.
            offset = stage.rows if stage is not None else self.pass_rows
            with _DEVICE_LOCK:
                self._fold_locked(state, x, y, (partition, offset))
            if partition is None:
                self.rows += n
                self.pass_rows += n
            else:
                stage.rows += n
                if fresh_stage:
                    self.staged[(partition, attempt)] = stage
                    self.staged_bytes += stage.nbytes
            # Burned only now: an id recorded before a failing fold would
            # turn the client's replay into an ack without a fold.
            self._mark_folded(feed_id, stage)
            self.touched = self._clock()  # exit stamp: the fold may be slow

    def _stage_rows(self, x: np.ndarray, partition: Optional[int], attempt: int,
                    feed_id: Optional[str]) -> None:
        """A knn feed: the rows join the job as a host float32 block, with
        the exactly-once staging of the device folds (a partitioned block
        counts only at commit). No device work, so no _DEVICE_LOCK."""
        block = np.ascontiguousarray(x, dtype=np.float32)
        n = block.shape[0]
        with self.lock, trace_span("daemon stage rows"):
            if self.dropped:
                raise KeyError("job was finalized/dropped; rows not accepted")
            self.touched = self._clock()
            if partition is not None and partition in self.committed:
                _M_REPLAY_HITS.inc(kind="committed_partition")
                return
            if partition is None:
                if self._is_replay(feed_id, None):
                    return
                self.state.append(block)
                self.rows += n
                self.pass_rows += n
            else:
                stage = self.staged.get((partition, attempt))
                if stage is None:
                    stage = self.staged[(partition, attempt)] = _Stage([], 0)
                if self._is_replay(feed_id, stage):
                    return
                stage.state.append(block)
                stage.rows += n
                stage.nbytes += block.nbytes
                self.staged_bytes += block.nbytes
            self._mark_folded(feed_id, None if partition is None else stage)

    def commit(self, partition: int, attempt: int = 0, pass_id: Optional[int] = None) -> int:
        """Add a partition's stage into the job state. Idempotent: commits
        for an already-committed partition are acknowledged without adding.
        Returns the job's total rows."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self._check_pass(pass_id)
            self.touched = self._clock()
            if partition in self.committed:
                _M_REPLAY_HITS.inc(kind="committed_partition")
                return self.rows
            staged = self._drop_stage((partition, attempt))
            if staged is None:
                raise ValueError(
                    f"commit for partition {partition} attempt {attempt} "
                    "with no staged feed"
                )
            if self.algo == "knn":
                # Keyed by partition, not arrival: the finalize concatenates
                # partition-major, which fixes the global row ids.
                self.part_rows[partition] = staged.state
            else:
                # Every state is additive (counts, sums, Grams, gradient and
                # curvature blocks, cost): the reference's elementwise
                # merge, done in place.
                with _DEVICE_LOCK, trace_span("daemon commit"):
                    for acc, part in zip(self.state, staged.state):
                        acc.add_(part)
            self.committed[partition] = staged.rows
            self.rows += staged.rows
            self.pass_rows += staged.rows
            # the losing attempts' stages of this partition free their buffers
            for key in [k for k in self.staged if k[0] == partition]:
                self._drop_stage(key)
            self.touched = self._clock()
            return self.rows

    def export_state(self):
        """The COMMITTED state as raw arrays (s0, s1, ... in the reference's
        tree order; for pca: count, Σx, XᵀX) and its accounting meta."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            if self.algo == "knn":
                raise ValueError(
                    "knn job state is the dataset itself and does not merge across daemons "
                    "— multi-daemon knn fits instead BUILD A SHARD per daemon (finalize with "
                    "row_id_base; docs/protocol.md 'Sharded index across daemons')"
                )
            self.touched = self._clock()
            with _DEVICE_LOCK:
                arrays = {f"s{i}": t.cpu().numpy() for i, t in enumerate(self.state)}
            meta = {
                "rows": self.rows,
                "pass_rows": self.pass_rows,
                "iteration": self.iteration,
                "algo": self.algo,
                "n_cols": self.n_cols,
                "committed": {str(p): n for p, n in self.committed.items()},
            }
            self.touched = self._clock()
            return arrays, meta

    # -- cross-daemon merges -----------------------------------------------

    def _require_mergeable(self) -> None:
        if self.algo == "knn":
            raise ValueError(
                "knn job state is the dataset itself and does not reduce across daemons "
                "(build per-daemon shards instead; docs/protocol.md)")

    def _check_leaves(self, who: str, incoming) -> None:
        """The peer's leaves must match the job's state leaf for leaf."""
        if len(incoming) != len(self.state):
            raise ValueError(f"{who} has {len(incoming)} leaves; job state has "
                             f"{len(self.state)} (algo/params mismatch between daemons?)")
        for i, (leaf, inc) in enumerate(zip(self.state, incoming)):
            if tuple(inc.shape) != tuple(leaf.shape):
                raise ValueError(f"{who} array s{i} shape {tuple(inc.shape)} != job state "
                                 f"shape {tuple(leaf.shape)}")

    def _fold_peers_locked(self, peer_states, rows: int, op_id: Optional[str]) -> int:
        """Add each peer's leaves to the job's state, in the given order,
        the job's own state the left operand (call under the job lock).
        A leaf on another device, or in another dtype, is moved to the
        job's first. The hub (one ``merge_state`` a peer) and the
        collective reduce make the same additions in the same order, so
        they agree bitwise. ``op_id`` is burned only once the fold has
        applied: a replay of a rejected merge must not become an ack
        without a fold."""
        with _DEVICE_LOCK, trace_span("daemon merge"):
            leaves = list(self.state)
            for state in peer_states:
                leaves = [a + torch.as_tensor(b).to(a.device, a.dtype)
                          for a, b in zip(leaves, state)]
            self.state = tuple(leaves)
        self.rows += int(rows)
        self.pass_rows += int(rows)
        if op_id is not None:
            self._seen_merge_ids.add(str(op_id))
        self.touched = self._clock()  # exit stamp
        return self.rows

    def merge_remote(self, arrays: Dict[str, np.ndarray], rows: int,
                     merge_id: Optional[str] = None) -> int:
        """Fold another daemon's exported state (``s0``, ``s1``, ... as
        :meth:`export_state` sends them) into this job: the cross-daemon
        reduce through the driver's hub. ``rows`` is the exporter's
        committed contribution; it joins the job's total and the current
        pass. A replayed ``merge_id`` folds once. Returns the job's rows."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self._require_mergeable()
            self.touched = self._clock()
            if merge_id is not None and str(merge_id) in self._seen_merge_ids:
                _M_REPLAY_HITS.inc(kind="merge")
                return self.rows
            if len(arrays) != len(self.state):
                raise ValueError(f"merge_state carried {len(arrays)} arrays; job state has "
                                 f"{len(self.state)} (algo/params mismatch between daemons?)")
            missing = [f"s{i}" for i in range(len(self.state)) if f"s{i}" not in arrays]
            if missing:
                raise ValueError(f"merge_state missing array {missing[0]!r}")
            incoming = [arrays[f"s{i}"] for i in range(len(self.state))]
            self._check_leaves("merge_state", incoming)
            return self._fold_peers_locked([incoming], rows, merge_id)

    def seen_reduce(self, reduce_id: Optional[str]) -> Optional[int]:
        """The replay probe of ``reduce_mesh``, run before any peer check:
        an applied ``reduce_id`` returns the job's rows (with
        ``drop_peers`` the first apply dropped the peers' jobs, so checking
        a replay against them would fail an op that succeeded). None: not
        seen."""
        if reduce_id is None:
            return None
        with self.lock:
            if self.dropped or str(reduce_id) not in self._seen_merge_ids:
                return None
            _M_REPLAY_HITS.inc(kind="merge")
            self.touched = self._clock()
            return self.rows

    def peek_pass_state(self):
        """The pre-reduce read of a peer's job: (a copy of the state,
        pass_rows, a copy of the committed partitions, iteration), taken
        together under the job lock. The state is copied because a commit
        adds into it in place: a late (fenced zombie or speculative) commit
        that lands between this read and the fold must not reach the fold
        past the row and partition checks made on this read."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self._require_mergeable()
            self.touched = self._clock()
            with _DEVICE_LOCK:
                state = tuple(t.clone() for t in self.state)
            return state, self.pass_rows, dict(self.committed), self.iteration

    def merge_mesh(self, contributions, reduce_id: Optional[str] = None) -> int:
        """Fold co-resident peers' device states into this job: the
        on-device twin of :meth:`merge_remote`, with no copy through the
        host or the wire. ``contributions``: [(peer id, state, rows)] in
        the driver's sorted-id order, the hub's fold order. A replayed
        ``reduce_id`` folds once. Returns the job's rows."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self._require_mergeable()
            self.touched = self._clock()
            if reduce_id is not None and str(reduce_id) in self._seen_merge_ids:
                _M_REPLAY_HITS.inc(kind="merge")
                return self.rows
            for pid, state, _rows in contributions:
                self._check_leaves(f"peer {pid} state", state)
            return self._fold_peers_locked([state for _p, state, _r in contributions],
                                           sum(int(r) for _p, _s, r in contributions),
                                           reduce_id)

    # -- knn jobs ----------------------------------------------------------

    def _row_blocks(self) -> list:
        """The committed rows as blocks (call under the job lock): direct
        feeds in arrival order, then each partition's in partition order."""
        blocks = list(self.state)
        for pid in sorted(self.part_rows):
            blocks.extend(self.part_rows[pid])
        return blocks

    def sample_rows(self, n: int, seed: int = 0) -> np.ndarray:
        """A seeded uniform sample of this knn job's COMMITTED rows
        (read-only): ``min(n, committed)`` distinct rows in row order,
        Floyd's sampling of ``default_rng(seed)``."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            if self.algo != "knn":
                raise ValueError("sample_rows is a knn-job op (other algos hold O(d²) "
                                 "statistics, not rows)")
            self.touched = self._clock()
            blocks = self._row_blocks()
            total = sum(b.shape[0] for b in blocks)
            if total == 0:
                raise ValueError("sample_rows before any committed feed")
            if int(n) <= 0:
                raise ValueError(f"sample_rows n must be positive, got {n}")
            n = min(int(n), total)
            # shuffle=False: Floyd's O(n) sampling, as build_ivf_flat's pick.
            pick = np.sort(np.random.default_rng(int(seed)).choice(
                total, n, replace=False, shuffle=False))
            out = np.empty((n, blocks[0].shape[1]), blocks[0].dtype)
            base = taken = 0
            for b in blocks:
                hi = base + b.shape[0]
                j = int(np.searchsorted(pick, hi, side="left"))
                if j > taken:
                    out[taken:j] = b[pick[taken:j] - base]
                    taken = j
                base = hi
            return out

    def _id_map(self, id_base: Dict[Any, int]) -> np.ndarray:
        """Local (partition-major) row position → global row id, from the
        driver's {partition: global base} (call under the job lock)."""
        if self.state:
            raise ValueError("row_id_base needs fully partitioned feeds (direct unpartitioned "
                             "rows have no global position)")
        pieces = []
        for pid in sorted(self.part_rows):
            n_p = sum(b.shape[0] for b in self.part_rows[pid])
            base = id_base.get(str(pid), id_base.get(pid))
            if base is None:
                raise ValueError(f"row_id_base missing partition {pid} (this daemon committed it)")
            pieces.append(np.arange(base, base + n_p, dtype=np.int64))
        return np.concatenate(pieces) if pieces else np.zeros(0, np.int64)

    def build_knn_model(self, params: Dict[str, Any],
                        extra_arrays: Optional[Dict[str, np.ndarray]] = None):
        """Build the exact or IVF index from the committed rows and consume
        the job: (core model, info arrays, id map or None). The daemon
        registers the model for ``kneighbors``; only the O(1) info goes
        back to the caller.

        ``params``: ``mode`` (exact|ivf), ``metric``, and for ivf ``nlist``,
        ``seed``, ``nprobe`` and ``build``: "device", or "auto" while the
        rows' bytes stay within ``_IVF_DEVICE_BUILD_MAX_BYTES``, runs
        ``build_ivf_flat_device`` (the index resident on the device);
        "host", or "auto" past the cap, ``build_ivf_flat``; ``row_id_base`` maps
        each partition to its global row base (the served ids become those
        global partition-major positions); ``return_centroids`` ships the
        quantizer back. ``extra_arrays``: ``centroids``, a pretrained
        quantizer kept frozen, or ``train_rows``, the quantizer's training
        set (ignored when ``centroids`` is given)."""
        extra_arrays = extra_arrays or {}
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self.touched = self._clock()
            blocks = self._row_blocks()
            if not blocks:
                raise ValueError("finalize before any feed: no rows")
            id_base = params.get("row_id_base") or None
            id_map = None if id_base is None else self._id_map(id_base)
            mode = str(params.get("mode", "exact"))
            metric = str(params.get("metric") or "euclidean")
            build = str(params.get("build") or "auto")
            if mode not in ("exact", "ivf"):
                raise ValueError(f"unknown knn mode {mode!r} (exact|ivf)")
            if mode == "ivf":
                if metric == "inner_product":
                    raise ValueError("metric='inner_product' needs mode='exact' (IVF partitions "
                                     "by L2 proximity)")
                if build not in ("auto", "device", "host"):
                    raise ValueError(f"unknown build {build!r} (auto|device|host)")
            with trace_span("daemon knn build"):
                rows = np.concatenate(blocks)
                info = {"n_rows": np.asarray([rows.shape[0]], np.int64),
                        "n_cols": np.asarray([rows.shape[1]], np.int64)}
                if mode == "exact":
                    model = knn_mod.NearestNeighborsModel(database=rows, device=self.device)
                    model._set(metric=metric)
                else:
                    if metric == "cosine":
                        # The index stores unit-normalized (augmented) rows;
                        # kneighbors normalizes the queries the same way.
                        rows = knn_mod._normalized_rows(rows, zero_slot=0)
                    nlist = int(params["nlist"])
                    cent_in = extra_arrays.get("centroids")
                    if cent_in is not None:
                        cent_in = np.asarray(cent_in, np.float32)
                    train_in = extra_arrays.get("train_rows")
                    if train_in is not None:
                        train_in = np.asarray(train_in)
                        if metric == "cosine":
                            train_in = knn_mod._normalized_rows(train_in, zero_slot=0)
                    on_device = build == "device" or (
                        build == "auto" and rows.nbytes <= _IVF_DEVICE_BUILD_MAX_BYTES)
                    build_fn = knn_mod.build_ivf_flat_device if on_device else knn_mod.build_ivf_flat
                    with _DEVICE_LOCK:
                        index = build_fn(
                            rows, nlist=nlist, seed=int(params.get("seed") or 0),
                            centroids=cent_in, train_data=train_in, device=self.device)
                        if params.get("return_centroids"):
                            info["centroids"] = knn_mod._host_array(
                                index.centroids).astype(np.float32)
                    model = knn_mod.ApproximateNearestNeighborsModel(index=index,
                                                                     device=self.device)
                    model._set(metric=metric)
                    model._index_metric = metric
                    if params.get("nprobe"):
                        model._set(nprobe=int(params["nprobe"]))
                    info["nlist"] = np.asarray([nlist], np.int64)
                    info["maxlen"] = np.asarray([index.lists.shape[1]], np.int64)
                    info["sharded"] = np.asarray([0], np.int64)
            # The rows are consumed by the built index.
            self.dropped = True
            self.state, self.part_rows = [], {}
            return model, info, id_map

    # -- iterative jobs ----------------------------------------------------

    def _iterate_arrays(self) -> Dict[str, np.ndarray]:
        """The iterate as host arrays (call under the job lock): kmeans
        {"centers"}, logreg {"w", "b"} (b flattened), rf copies of the
        forest's tables (a later grow must not reach an answered iterate)."""
        if self.algo == "rf":
            return {k: np.array(v) for k, v in self.rf_tables.items()}
        with _DEVICE_LOCK:
            if self.algo == "kmeans":
                return {"centers": self.centers.cpu().numpy()}
            if self.algo == "logreg":
                return {"w": self.w.cpu().numpy(), "b": self.b.cpu().numpy().reshape(-1)}
        raise ValueError(f"algo {self.algo!r} is single-pass; it has no iterate")

    def _install_iterate(self, arrays: Dict[str, np.ndarray]) -> None:
        """Validate the iterate's shapes, then install it on the device
        (call under the job lock)."""
        if self.algo == "kmeans":
            c = np.asarray(arrays["centers"])
            if c.shape != (self.k, self.n_cols):
                raise ValueError(f"centers shape {c.shape} != ({self.k}, {self.n_cols})")
            with _DEVICE_LOCK:
                self.centers = torch.as_tensor(c).to(self.device, self._accum)
        elif self.algo == "logreg":
            w = np.asarray(arrays["w"])
            b = np.asarray(arrays["b"]).reshape(-1)
            c = self.n_classes
            want_w = (self.n_cols, c) if c > 2 else (self.n_cols,)
            want_b = c if c > 2 else 1
            if tuple(w.shape) != want_w:
                raise ValueError(f"coefficients shape {tuple(w.shape)} != {want_w} "
                                 f"(n_cols={self.n_cols}, n_classes={c})")
            if b.shape[0] != want_b:
                raise ValueError(f"intercept length {b.shape[0]} != {want_b} (n_classes={c})")
            with _DEVICE_LOCK:
                self.w = torch.as_tensor(w).to(self.device, self._accum)
                self.b = torch.as_tensor(b if c > 2 else b.reshape(())).to(self.device,
                                                                          self._accum)
        elif self.algo == "rf":
            tables = rf_mod.validate_forest_arrays(arrays, self.rf_spec, self.n_cols)
            self.rf_tables = {k: np.array(v) for k, v in tables.items()}
            # The edges stay resident in the accumulation dtype: every feed
            # bins against them (grow_level never moves them).
            with _DEVICE_LOCK:
                self._rf_edges = torch.as_tensor(self.rf_tables["bin_edges"]).to(
                    self.device, self._accum)
        else:
            raise ValueError(f"algo {self.algo!r} is single-pass; set_iterate not applicable")

    def durable_arrays(self) -> Dict[str, np.ndarray]:
        """The iterate a pass-boundary snapshot stores (under the job lock):
        the extraction ``get_iterate`` answers, so the two cannot drift.
        The pass's accumulators are left out: at a boundary they are zero,
        so a snapshot is O(iterate)."""
        if self.algo not in ("kmeans", "logreg", "rf"):
            return {}
        if self.algo == "kmeans" and self.centers is None:
            return {}
        if self.algo == "rf" and self.rf_tables is None:
            return {}
        return self._iterate_arrays()

    def _maybe_snapshot(self) -> None:
        """Write the pass-boundary snapshot when durability is armed (under
        the job lock, before the boundary's ack). A failed write fails the
        op: losing durability silently would turn the next crash into the
        loss the snapshot exists to prevent."""
        cb = self.snapshot_cb
        if cb is not None:
            cb(self)

    def get_iterate(self):
        """(iterate arrays, {"iteration"}) of an iterative job."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self.touched = self._clock()
            if self.algo == "kmeans" and self.centers is None:
                raise ValueError("kmeans job has no centers yet (seed first)")
            if self.algo == "rf" and self.rf_tables is None:
                raise ValueError("forest job has no iterate yet (set_iterate first)")
            return self._iterate_arrays(), {"iteration": self.iteration}

    def set_iterate(self, arrays: Dict[str, np.ndarray], iteration: int) -> None:
        """Install a driver-pushed iterate and open pass ``iteration``: the
        pass statistics and staging reset."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self.touched = self._clock()
            self._install_iterate(arrays)
            with _DEVICE_LOCK:
                self.state = self._zero_state()
            self._clear_pass()
            self.iteration = int(iteration)
            self._maybe_snapshot()  # a pushed iterate is a pass boundary too
            self.touched = self._clock()

    def step(self, params: Dict[str, Any], step_id: Optional[str] = None) -> Dict[str, Any]:
        """Pass boundary of an iterative job: apply the update over the
        pass's statistics, open the next pass, and report convergence info
        (``moved2`` and ``cost`` for kmeans, ``delta`` and ``loss`` for
        logreg, ``depth``, ``open_nodes`` and ``splits`` for rf;
        ``iteration`` and ``pass_rows`` for all). A replayed ``step_id``
        returns the cached info of the step already applied."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self.touched = self._clock()
            if self.algo not in ("kmeans", "logreg", "rf"):
                raise ValueError(f"algo {self.algo!r} is single-pass; step not applicable")
            if (step_id is not None and self._last_step_info is not None
                    and str(step_id) == self._last_step_id):
                _M_REPLAY_HITS.inc(kind="step")
                return dict(self._last_step_info)
            if self.algo == "rf" and self.rf_tables is None:
                raise ValueError("step before the forest iterate is installed")
            pass_rows = self.pass_rows
            self._clear_pass()
            if pass_rows == 0:
                # A retried or premature step over an empty pass would
                # corrupt the iterate (a zero Hessian solve, moved2 = 0).
                raise ValueError("step with no rows fed this pass (duplicate step retry, "
                                 "or executors have not fed yet)")
            info: Dict[str, Any] = {"iteration": self.iteration + 1}
            with _DEVICE_LOCK, trace_span("daemon step"):
                if self.algo == "kmeans":
                    sums, counts, cost = self.state
                    self.centers, moved2 = km_mod.apply_lloyd_update(sums, counts, self.centers)
                    info.update(moved2=float(moved2), cost=float(cost))
                elif self.algo == "rf":
                    info.update(rf_mod.grow_level(self.rf_tables, self.state[0], self.rf_spec))
                else:
                    reg = float(params.get("reg", 0.0))
                    fit_intercept = bool(params.get("fit_intercept", True))
                    lsum, n = self.state[5], self.state[6]
                    info["loss"] = lg_mod.stream_objective(lsum, n, reg, self.w)
                    if self.multinomial:
                        self.w, self.b, delta = lg_mod._softmax_step(
                            self.state, self.w, self.b, reg, fit_intercept)
                    else:
                        self.w, self.b, delta = lg_mod._newton_step(
                            *self.state[:5], n, self.w, self.b, reg, fit_intercept)
                    info["delta"] = float(delta)
                self.state = self._zero_state()
            self.iteration += 1
            info["pass_rows"] = pass_rows
            # The per-pass durability point: the snapshot lands before the
            # step's ack, so a daemon dying after here reopens at this
            # boundary.
            self._maybe_snapshot()
            self._last_step_id = None if step_id is None else str(step_id)
            self._last_step_info = dict(info)
            self.touched = self._clock()  # exit stamp
            return info

    # -- finalize ----------------------------------------------------------

    def finalize(self, params: Dict[str, Any], drop: bool = False) -> Dict[str, np.ndarray]:
        with self.lock:
            with _DEVICE_LOCK:
                result = self._finalize_locked(params)
            if drop:
                # Under the same lock acquisition, so a straggler feed
                # blocked on it errors instead of folding into a model
                # that was already returned.
                self.dropped = True
            return result

    def _finalize_locked(self, params: Dict[str, Any]) -> Dict[str, np.ndarray]:
        if self.algo == "rf":
            if self.rf_tables is None:
                raise ValueError("finalize before any feed: no forest iterate")
            out = {k: np.array(v) for k, v in self.rf_tables.items() if k != "depth"}
            out["n_classes"] = np.asarray([self.rf_spec.n_classes], np.int64)
            out["n_iter"] = np.asarray([self.iteration], np.int64)
            return out
        if self.algo == "kmeans":
            # The cost is the current (unstepped) pass's: a driver feeds one
            # pass at the final centres without stepping to read it.
            if self.centers is None:
                raise ValueError("finalize before any feed: no centers")
            return {
                "centers": self.centers.cpu().numpy(),
                "cost": np.asarray([float(self.state[2])]),
                "n_iter": np.asarray([self.iteration]),
            }
        if self.algo == "logreg":
            w = self.w.cpu().numpy()
            b = self.b.cpu().numpy()
            if self.multinomial:
                w, b = w.T, b.reshape(-1)  # Spark's layout: (C, d) and (C,)
            else:
                b = b.reshape(1)
            return {"coefficients": w, "intercept": b, "n_iter": np.asarray([self.iteration])}
        if self.algo == "linreg":
            sol = lr_mod.finalize_normal_eq_stats(
                self.state,
                reg=float(params.get("reg", 0.0)),
                elastic_net=float(params.get("elastic_net", 0.0)),
                fit_intercept=bool(params.get("fit_intercept", True)),
                max_iter=int(params.get("max_iter", 500)),
                tol=float(params.get("tol", 1e-6)),
                n_true=self.rows,
            )
            return {
                "coefficients": sol.coefficients,
                "intercept": np.asarray([sol.intercept]),
                "rmse": np.asarray([sol.summary.rmse]),
                "r2": np.asarray([sol.summary.r2]),
            }
        if params.get("raw_moments"):
            # A StandardScaler fit is a subset of the PCA statistics
            # (count, Σx, diag XᵀX): no eigensolve.
            count, colsum, g = (t.cpu().numpy() for t in self.state)
            return {
                "count": np.asarray([float(count)]),
                "colsum": np.asarray(colsum),
                "gram_diag": np.diagonal(g).copy(),
            }
        sol = finalize_pca_stats(
            self.state,
            k=int(params["k"]),
            mean_center=bool(params.get("mean_center", True)),
            n_true=self.rows,
            solver=params.get("solver"),
        )
        return {
            "pc": sol.pc,
            "explained_variance": sol.explained_variance,
            "sigma": sol.sigma,
            "mean": sol.mean,
        }


#: Wire algo → the model class a served registration rebuilds from its
#: ``_model_data()`` arrays (the reference's ``_model_class``). Beyond the
#: reference, "knn" registers an exact index (``{"database"}``), so a fleet
#: can serve one from every replica.
_MODEL_CLASSES = {
    "pca": PCAModel,
    "kmeans": km_mod.KMeansModel,
    "linreg": lr_mod.LinearRegressionModel,
    "logreg": lg_mod.LogisticRegressionModel,
    "scaler": StandardScalerModel,
    "rf_classifier": rf_mod.RandomForestClassificationModel,
    "rf_regressor": rf_mod.RandomForestRegressionModel,
    "knn": knn_mod.NearestNeighborsModel,
}


def _model_class(algo: str):
    cls = _MODEL_CLASSES.get(algo)
    if cls is None:
        raise ValueError(f"unknown model algo {algo!r} ({'|'.join(_MODEL_CLASSES)})")
    return cls


class _ServedModel:
    """A registered model serving ``transform`` (or ``kneighbors``): its
    arrays stay resident on the daemon's device across batches and
    connections. ``ttl_scale`` multiplies the reaper's TTL: 1 for an
    ``ensure_model`` registration (its client re-registers on a miss), 8
    for a daemon-built index (:meth:`from_model`), which nothing can
    re-create, and 1 again once a durable daemon has snapshotted it.

    ``buckets``: the daemon's serving ladder. A transform of n rows, n up to
    the top bucket, runs padded to the smallest bucket that holds n, as the
    scheduler pads a coalesced batch, so a request served alone and one
    served inside a batch of the same bucket run the same product shape
    (cuBLAS chooses its algorithm, and with it the summation order, by the
    shape). None: no padding."""

    def __init__(self, algo: str, arrays: Dict[str, np.ndarray], params: Dict[str, Any],
                 device: torch.device, clock=time.monotonic, buckets=None):
        self._clock = clock
        self.algo = algo
        self.model = _model_class(algo)._from_model_data("served", arrays)
        self.model._device = device
        # Params configure serving; unknown names are ignored so client and
        # daemon can skew.
        known = {k: v for k, v in (params or {}).items() if self.model.hasParam(k)}
        if known:
            self.model._set(**known)
        self.lock = threading.Lock()
        self.touched = clock()
        self.id_map: Optional[np.ndarray] = None
        self.ttl_scale = 1.0
        self.buckets = buckets
        # The fleet's immutable version pin (ensure_model's ``version``).
        self.version: Optional[int] = None
        # The held programs of the last AOT warm (serve/aot.py), and the
        # graph pool its buckets share; None until one ran.
        self.aot: Optional[aot_mod.ProgramSet] = None
        self._aot_pool: Optional[aot_mod.CapturePool] = None

    @classmethod
    def from_model(cls, algo: str, model, clock=time.monotonic, id_map=None,
                   buckets=None) -> "_ServedModel":
        """Wrap a core model the daemon built (a knn index). Its source rows
        were consumed by the build, so the reaper holds it 8× longer than a
        re-creatable registration. ``id_map``: local row position → global
        partition-major row id, for an index that holds only some
        partitions."""
        obj = cls.__new__(cls)
        obj._clock = clock
        obj.algo = algo
        obj.model = model
        obj.lock = threading.Lock()
        obj.touched = clock()
        obj.id_map = None if id_map is None else np.asarray(id_map, np.int64)
        obj.ttl_scale = 8.0
        obj.buckets = buckets
        obj.version = None
        obj.aot = None
        obj._aot_pool = None
        return obj

    def aot_warm(self, n_cols: int, buckets, k, dtype: str = "float32"
                 ) -> Optional[Dict[str, Any]]:
        """AOT of the serve bucket ladder (the reference's ``aot_warm``):
        every reachable bucket's serving program, from the model's
        ``_serve_aot_plan``, built and held on this instance
        (``serve/aot.py``). Buckets whose padded shapes coincide share one
        program; programs of an earlier warm that are still valid are kept.
        On the card each program is a CUDA graph, captured under
        ``_DEVICE_LOCK``: a capture must see no other thread's launch. The
        kernel libraries are loaded at ``start()``, so no build runs under
        the lock. Returns the ack's ``{"buckets", "compiled"}`` (compiled =
        the programs THIS call built), or None when the model publishes no
        plan (the caller then runs the trace warmup). Published under the
        model lock; :meth:`aot_status` reads without it."""
        plan_fn = getattr(self.model, "_serve_aot_plan", None)
        if plan_fn is None:
            return None
        buckets = [int(b) for b in buckets]
        with self.lock:
            programs = {} if self.aot is None else dict(self.aot.programs)
            compiled = 0
            for bucket in buckets:
                with _DEVICE_LOCK:
                    plans = plan_fn(bucket, int(n_cols), dtype=dtype, k=k)
                    if plans is None:
                        return None
                    for plan in plans:
                        key = aot_mod.ProgramSet.key(plan.rows, plan.width, plan.dtype, k)
                        held = programs.get(key)
                        if held is not None and held.usable():
                            continue
                        if held is not None:
                            held.release()
                        if plan.device.type == "cuda" and self._aot_pool is None:
                            self._aot_pool = aot_mod.CapturePool(plan.device)
                        programs[key] = aot_mod.BucketProgram(plan, self._aot_pool)
                        compiled += 1
            self.aot = aot_mod.ProgramSet(
                buckets, compiled, programs,
                getattr(self.model, "_serve_dispatch_rows", int))
        return {"buckets": buckets, "compiled": compiled}

    def aot_status(self) -> Optional[Dict[str, Any]]:
        """The compile ledger: primed buckets, programs built, and the
        serve-time hits and misses since this registration's warm (a miss:
        a dispatch at a shape nothing primed, or at a program gone stale).
        None when AOT never ran. One read of the published reference, with
        no lock: a scrape must not wait behind an in-flight dispatch."""
        held = self.aot
        return None if held is None else held.status()

    def release_aot(self) -> None:
        """Free the held programs (the model was dropped)."""
        with self.lock:
            held, self.aot = self.aot, None
            if held is not None:
                for prog in held.programs.values():
                    prog.release()

    def _held(self, x, k=None):
        """The held program's answer for ``x``, or None: no AOT warm ran, or
        a miss (the caller runs the eager path). Under ``self.lock``."""
        held = self.aot
        return None if held is None else held.run(np.asarray(x), k)

    def transform(self, x) -> Dict[str, Any]:
        if self.algo in ("rf_classifier", "rf_regressor"):
            width = int(np.asarray(self.model.arrays["bin_edges"]).shape[0])
            if x.shape[1] != width:
                raise ValueError(f"transform batch width {x.shape[1]} != the forest's "
                                 f"{width} features")
        n = int(x.shape[0])
        rows = n
        if self.buckets and 0 < n <= self.buckets[-1]:
            rows = scheduler_mod.bucket_for(n, self.buckets)
        if rows != n:
            x = np.concatenate([np.asarray(x), np.zeros((rows - n,) + tuple(x.shape[1:]),
                                                        dtype=np.asarray(x).dtype)])
        with self.lock:
            self.touched = self._clock()
            with _DEVICE_LOCK:
                outs = self._held(x)
                if outs is None:
                    outs = self.model.transform_matrix(x)
        if rows != n:
            outs = {name: v[:n] for name, v in outs.items()}
        return outs

    def kneighbors(self, queries: np.ndarray, k):
        """(distances, indices) of a served index; ids through ``id_map``,
        the −1 of "fewer than k found" kept as −1."""
        with self.lock:
            self.touched = self._clock()
            if not hasattr(self.model, "kneighbors"):
                raise ValueError(f"model algo {self.algo!r} does not serve kneighbors")
            with _DEVICE_LOCK, trace_span("daemon kneighbors"):
                res = self._held(queries, _resolve_k(self, k))
                dists, idx = res if res is not None else self.model.kneighbors(queries, k)
            if self.id_map is not None:
                idx = np.where(idx >= 0, self.id_map[np.maximum(idx, 0)], -1)
            return dists, idx


def _model_width(algo: str, arrays: Dict[str, np.ndarray]) -> Optional[int]:
    """The fitted feature width of a registration's arrays: what a
    warmup-on-register warms without the client naming it. None when the
    arrays carry no unambiguous width (the eager warmup is then skipped,
    never failed)."""
    try:
        if algo == "pca":
            return int(np.asarray(arrays["pc"]).shape[0])
        if algo == "scaler":
            return int(np.asarray(arrays["mean"]).shape[0])
        if algo == "linreg":
            return int(np.asarray(arrays["coefficients"]).reshape(-1).shape[0])
        if algo == "logreg":
            c = np.asarray(arrays["coefficients"])
            return int(c.shape[-1] if c.ndim == 2 else c.shape[0])
        if algo == "kmeans":
            # The wire key is the Spark-facing "clusterCenters"; "centers"
            # for hand-built payloads.
            c = arrays.get("clusterCenters")
            if c is None:
                c = arrays["centers"]
            return int(np.asarray(c).shape[1])
        if algo in ("rf_classifier", "rf_regressor"):
            return int(np.asarray(arrays["bin_edges"]).shape[0])
        if algo == "knn":
            return int(np.asarray(arrays["database"]).shape[1])
    except (KeyError, IndexError):
        return None
    return None


def _resolve_k(served: _ServedModel, k):
    """A kneighbors request's ``k``: None means the model's fitted k."""
    if k is not None:
        return int(k)
    getk = getattr(served.model, "getK", None)
    return int(getk()) if getk is not None else None


def _check_mesh_target(name: str, job: _Job, req_algo: str, gathered) -> None:
    """``reduce_mesh``'s checks of the target job against the request and
    each gathered peer job (algo, width, pass), before anything folds."""
    if job.algo != req_algo:
        raise ValueError(f"job {name!r} is algo {job.algo!r}; reduce_mesh carried {req_algo!r}")
    for pid, _peer, pjob, _state, _rows, iteration in gathered:
        if pjob.algo != job.algo or pjob.n_cols != job.n_cols:
            raise ValueError(f"peer {pid} job is ({pjob.algo}, n_cols={pjob.n_cols}); "
                             f"target is ({job.algo}, n_cols={job.n_cols})")
        if iteration != job.iteration:
            raise RuntimeError(
                f"peer {pid} is on pass {iteration}, target on {job.iteration}: a daemon "
                "missed a pass boundary — replay the pass")


class DataPlaneDaemon:
    """Arrow/raw-frames-over-TCP accumulation server next to the card.

    ``device``: where jobs fold and models serve; None means the card, and
    ``start()`` raises without one. Binds loopback by default; on a cluster,
    bind the host's NIC and keep the port reachable from executors only.
    ``serve_batching``: run the serving scheduler (None: the config key).
    ``state_dir``: the durable state's directory (None: the config key
    ``daemon_state_dir``; unset, nothing is persisted).
    ``gossip_interval_s``, ``gossip_fanout``: the gossip thread's cadence
    (0: no thread) and peers a tick (None: the config keys).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        device=None,
        ttl: Optional[float] = None,
        token: Optional[str] = None,
        clock=time.monotonic,
        reap_interval: Optional[float] = None,
        max_connections: Optional[int] = None,
        max_staged_bytes: Optional[int] = None,
        retry_after_s: Optional[float] = None,
        max_models: Optional[int] = None,
        serve_batching: Optional[bool] = None,
        state_dir: Optional[str] = None,
        gossip_interval_s: Optional[float] = None,
        gossip_fanout: Optional[int] = None,
    ):
        self._host, self._port = host, port
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._ttl = ttl
        self._token = token
        # Injectable clock: TTL tests advance a fake clock, no wall sleeps.
        self._clock = clock
        self._reap_interval = reap_interval
        # Watermarks (0/None = unlimited), defaults from config.
        self._max_connections = int(
            config.get("daemon_max_connections") if max_connections is None
            else max_connections
        ) or None
        self._max_staged_bytes = int(
            config.get("daemon_max_staged_bytes") if max_staged_bytes is None
            else max_staged_bytes
        ) or None
        self._retry_after_s = float(
            config.get("daemon_retry_after_s") if retry_after_s is None
            else retry_after_s
        )
        self._max_models = int(
            config.get("daemon_max_models") if max_models is None else max_models
        ) or None
        # The serving scheduler (serve/scheduler.py): built at start(), after
        # the bind, so a failed start leaks no dispatcher thread. The ladder
        # is the daemon's whether or not it batches: a solo transform pads to
        # it too (_ServedModel).
        self._serve_batching = bool(
            config.get("serve_batching") if serve_batching is None else serve_batching
        )
        self._buckets = scheduler_mod.parse_buckets(config.get("serve_batch_buckets"))
        self._scheduler: Optional[scheduler_mod.RequestScheduler] = None
        self._started = clock()
        self._active_conns = 0
        self._conn_socks: set = set()
        self._conn_threads: set = set()
        self._conns_lock = threading.Lock()
        # Self-reported identity (address spellings alias) and the per-boot
        # incarnation id stamped on every state ack. With a state_dir the
        # identity is persisted there: a restarted daemon is the same
        # logical daemon (it restores its jobs), not a new peer mid-fit.
        self.instance_id = uuid.uuid4().hex[:12]
        self.boot_id = uuid.uuid4().hex[:12]
        sd = config.get("daemon_state_dir") if state_dir is None else state_dir
        self._state_dir = str(sd) if sd else None
        if self._state_dir is not None:
            os.makedirs(self._state_dir, exist_ok=True)
            self.instance_id = self._durable_identity()
        self._jobs: Dict[str, _Job] = {}
        self._jobs_lock = threading.Lock()
        # Single-files durable restores (after a restart only): the first
        # scan's N feed tasks would otherwise all miss the registry and run
        # N restores of one job.
        self._restore_lock = threading.Lock()
        self._models: Dict[str, _ServedModel] = {}
        self._models_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._reaper_thread: Optional[threading.Thread] = None
        # The gossip plane (serve/gossip.py): this daemon's FleetView and the
        # anti-entropy thread's cadence (0: no thread; the view still answers
        # gossip_pull and merges gossip_push).
        self._gossip_interval_s = float(
            config.get("gossip_interval_s") if gossip_interval_s is None else gossip_interval_s)
        self._gossip_fanout = max(int(
            config.get("gossip_fanout") if gossip_fanout is None else gossip_fanout), 1)
        self.fleet_view = gossip_mod.FleetView()
        # Peer choice seeded from the boot id: two daemons of one process
        # never walk the same peer sequence.
        self._gossip_rng = random.Random(self.boot_id)
        self._gossip_thread: Optional[threading.Thread] = None
        # The telemetry plane: the journal ring's size, the evaluation
        # thread's cadence (0: no thread; the pull ops still answer), the
        # flight recorder and the SLO evaluator (built at start()).
        self._trace_buffer = int(config.get("telemetry_trace_buffer") or 0)
        self._telemetry_eval_s = float(config.get("telemetry_eval_interval_s") or 0.0)
        self._telemetry_thread: Optional[threading.Thread] = None
        self._flight: Optional[flight_mod.FlightRecorder] = None
        self._slo: Optional[slo_mod.SloEvaluator] = None
        self._last_telemetry_ts: Optional[float] = None
        self._prev_deadline_sheds = 0.0
        self._ring_armed = False
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DataPlaneDaemon":
        self._device = resolve_device(self._device_arg)  # raises without a card
        if self._device.type == "cuda":
            # Build (when needed) and load the kernel libraries before the
            # first connection, with no lock held: a first launch under
            # _DEVICE_LOCK would run nvcc there and stall every dispatch.
            with trace_span("daemon kernel load"):
                kernels.load_libraries()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        self._sock = s
        self._port = s.getsockname()[1]
        if self._serve_batching:
            self._scheduler = scheduler_mod.RequestScheduler(
                buckets=self._buckets, retry_after_s=self._retry_after_s
            ).start()
        self._started = self._clock()
        # This daemon is now a member of the process's device plane: the
        # registration (a durable identity's re-registration after a restart
        # too) bumps the membership epoch, so a collective reduce planned
        # before it re-reads mesh_info.
        membership_mod.registry().register(self.instance_id, self.boot_id, self)
        # Its own replica record enters its view now that the port is bound,
        # at an epoch of the plane the registration just bumped: a rebooted
        # daemon's record dominates every view that holds its old boot.
        adv_host = "127.0.0.1" if self._host in ("0.0.0.0", "::", "") else self._host
        self.fleet_view.observe_replica(self.instance_id, f"{adv_host}:{self._port}",
                                        self.boot_id, liveness="up")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="srml-dataplane-accept", daemon=True
        )
        self._accept_thread.start()
        if self._ttl is not None:
            self._reaper_thread = threading.Thread(
                target=self._reap_loop, name="srml-dataplane-reaper", daemon=True
            )
            self._reaper_thread.start()
        if self._gossip_interval_s > 0:
            self._gossip_thread = threading.Thread(
                target=self._gossip_loop, name="srml-dataplane-gossip", daemon=True
            )
            self._gossip_thread.start()
        # The telemetry plane: the journal ring (trace_pull's and the
        # recorder's events, with or without a journal file), the flight
        # recorder as the process default (its bundles under
        # state_dir/incidents/; none without a state_dir), subscribed to
        # fired fault sites, and the evaluation thread.
        if self._trace_buffer > 0:
            journal.ring_arm(self._trace_buffer)
            self._ring_armed = True
        self._flight = flight_mod.FlightRecorder(
            state_dir=self._state_dir,
            providers={
                "identity": lambda: {**self._identity(), "addr": f"{adv_host}:{self._port}"},
                "gossip": self.fleet_view.to_wire,
            },
        )
        flight_mod.set_default(self._flight)
        faults.subscribe(self._flight.on_fault)
        self._flight.arm_fatal()
        self._slo = slo_mod.SloEvaluator()
        if self._telemetry_eval_s > 0:
            self._telemetry_thread = threading.Thread(
                target=self._telemetry_loop, name="srml-dataplane-telemetry", daemon=True
            )
            self._telemetry_thread.start()
        logger.info("data-plane daemon listening on %s:%d (%s)", self._host,
                    self._port, self._device)
        return self

    @property
    def address(self):
        return self._host, self._port

    def stop(self) -> None:
        self._stop.set()
        # Leave the mesh first (an epoch bump): a reduce_mesh racing this
        # stop fails the epoch fence instead of folding a dying daemon.
        # Scoped to this incarnation, so a superseded object's late stop
        # never unregisters a successor that holds the same id.
        membership_mod.registry().unregister(self.instance_id, boot_id=self.boot_id)
        if self._scheduler is not None:
            # Before the sockets and the models go: queued serving requests
            # fail out with busy and unblock their connection threads.
            self._scheduler.stop()
        if self._sock is not None:
            # close() alone does not reliably wake a thread parked in
            # accept() on Linux: a self-connect pokes the acceptor, which
            # re-checks _stop and exits.
            host = "127.0.0.1" if self._host in ("0.0.0.0", "::", "") else self._host
            try:
                socket.create_connection((host, self._port), timeout=0.5).close()
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        # Shut live connections too (shutdown, not close, unblocks a thread
        # parked in recv), then wait, bounded, for their threads to unwind.
        with self._conns_lock:
            conns = list(self._conn_socks)
            conn_threads = list(self._conn_threads)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        me = threading.current_thread()
        for t in conn_threads:
            if t is me:
                continue
            while True:
                try:
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                    break
                except RuntimeError:
                    # Registered by the acceptor but not started yet: it
                    # starts and exits at once (the sockets are shut).
                    if time.monotonic() >= deadline:
                        break
                    time.sleep(0.002)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        if self._reaper_thread is not None:
            self._reaper_thread.join(timeout=5)
        if self._gossip_thread is not None:
            self._gossip_thread.join(timeout=5)
        # After the connection threads: their trailing journal lines (the op
        # span is written after the ack) land in the ring before it goes.
        if self._telemetry_thread is not None:
            self._telemetry_thread.join(timeout=5)
        if self._flight is not None:
            faults.unsubscribe(self._flight.on_fault)
            flight_mod.set_default(None)
        if self._ring_armed:
            journal.ring_disarm()
            self._ring_armed = False

    # -- telemetry evaluation ----------------------------------------------

    def _telemetry_loop(self) -> None:
        """Each tick: the registry snapshot, the SLO burn rates (the
        ``srml_slo_*`` gauges), the flight recorder's rolling delta and its
        automatic triggers. Host arithmetic only: it takes neither
        ``_DEVICE_LOCK`` nor a job lock, so it cannot stall traffic."""
        while not self._stop.wait(self._telemetry_eval_s):
            try:
                self._telemetry_tick()
            except Exception:
                logger.exception("telemetry tick failed")

    def _telemetry_tick(self) -> None:
        now = time.time()
        elapsed = (now - self._last_telemetry_ts if self._last_telemetry_ts is not None
                   else self._telemetry_eval_s)
        # Tick bookkeeping is single-writer: only the telemetry thread
        # reaches this method (start() runs one), so the unlocked writes
        # here cannot race anything.
        self._last_telemetry_ts = now  # srml: disable=thread-shared-state
        elapsed = max(elapsed, 1e-6)
        snap = metrics_mod.snapshot()
        deltas = self._flight.observe(snap, now) if self._flight else {}
        # SLO burn rates: a breach is itself a flight-recorder trigger.
        if self._slo is not None and self._slo.objectives:
            evals = self._slo.tick(snap, now)
            breaches = [e["objective"] for e in evals if e["breach"]]
            if breaches and self._flight is not None:
                self._flight.trigger("slo_breach", {"objectives": breaches})
        if self._flight is None:
            return
        # Shed storm: sheds a second over the tick, across ops.
        shed_cap = float(config.get("incident_shed_rate") or 0.0)
        if shed_cap > 0:
            sheds = sum(d["shed"] for d in deltas.values())
            if sheds / elapsed >= shed_cap:
                self._flight.trigger("shed_storm", {"sheds": sheds, "window_s": elapsed})
        # Deadline breaches: scheduler sheds with reason="deadline" (requests
        # whose deadline the backlog would miss), a second over the tick.
        dl_cap = float(config.get("incident_deadline_rate") or 0.0)
        if dl_cap > 0:
            dl_now = sum(float(s["value"])
                         for s in snap.get("srml_scheduler_sheds_total", {}).get("samples", [])
                         if s["labels"].get("reason") == "deadline")
            dl_delta = max(0.0, dl_now - self._prev_deadline_sheds)
            # Same single-writer bookkeeping as _last_telemetry_ts.
            self._prev_deadline_sheds = dl_now  # srml: disable=thread-shared-state
            if dl_delta / elapsed >= dl_cap:
                self._flight.trigger("deadline_breach",
                                     {"breaches": dl_delta, "window_s": elapsed})

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _identity(self) -> Dict[str, str]:
        """The ack stamp: instance id and per-boot incarnation id."""
        return {"id": self.instance_id, "boot_id": self.boot_id}

    # -- durable state (crash recovery; docs/protocol.md) --------------------

    def _durable_identity(self) -> str:
        """Load, or first write, the persisted instance id (tmp+rename)."""
        path = os.path.join(self._state_dir, "identity.json")
        try:
            with open(path, encoding="utf-8") as f:
                ident = str(json.load(f)["instance_id"])
            if ident:
                return ident
        except (OSError, ValueError, KeyError, TypeError):
            pass
        tmp = f"{path}.{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"instance_id": self.instance_id}, f)
        os.replace(tmp, path)
        return self.instance_id

    def _state_path(self, kind: str, name: str) -> str:
        """The snapshot file of a job or a model: a readable sanitized prefix
        of the caller-chosen name and a digest, so two names that sanitize
        alike never share a file."""
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in name)[:64]
        digest = hashlib.sha1(name.encode()).hexdigest()[:10]
        return os.path.join(self._state_dir, f"{kind}-{safe}-{digest}.npz")

    def _job_state_path(self, name: str) -> str:
        return self._state_path("job", name)

    def _model_state_path(self, name: str) -> str:
        return self._state_path("model", name)

    def _save_job_state(self, name: str, job: _Job) -> None:
        """The snapshot_cb target (under the job lock at a pass boundary,
        before its ack): the iterate and what a restore needs to re-run the
        job's constructor."""
        with trace_span("daemon snapshot write"):
            checkpoint_mod.save_state(self._job_state_path(name), job.durable_arrays(), {
                "name": name, "algo": job.algo, "n_cols": job.n_cols, "params": job.params,
                "iteration": job.iteration, "rows": job.rows, "boot_id": self.boot_id,
            })

    def _discard_job_state(self, name: str) -> None:
        """A finalized, dropped or evicted job must not resurrect."""
        if self._state_dir is not None:
            checkpoint_mod.discard_state(self._job_state_path(name))

    def _attach_durability(self, name: str, job: _Job) -> None:
        """Arm the pass-boundary snapshots of an iterative job. pca, linreg
        and knn jobs have no boundary before finalize: their recovery unit
        is the driver's scan."""
        if self._state_dir is None or job.algo not in ("kmeans", "logreg", "rf"):
            return
        job.snapshot_cb = lambda j, _n=name: self._save_job_state(_n, j)

    def _restore_job(self, name: str) -> Optional[_Job]:
        """A job from its pass-boundary snapshot: the constructor re-run from
        the persisted params, the iterate and the pass counter installed.
        Pass-local state died with the old incarnation: the job reopens at
        the boundary the snapshot recorded. A snapshot that does not load
        or install raises: nothing is served from an empty job."""
        with trace_span("daemon restore"):
            data = checkpoint_mod.load_state(self._job_state_path(name))
            if data is None:
                return None
            arrays, meta = data
            job = _Job(str(meta["algo"]), int(meta["n_cols"]), self._device,
                       meta.get("params") or {}, clock=self._clock)
            with job.lock:
                if arrays:
                    # The wire set_iterate's validation and install.
                    job._install_iterate(arrays)
                    if job.algo == "rf":
                        # The forest reopens with a zero histogram of the
                        # installed depth's frontier (the wire path gets it
                        # from set_iterate's tail, which a restore skips).
                        with _DEVICE_LOCK:
                            job.state = job._zero_state()
                job.iteration = int(meta["iteration"])
                job.rows = int(meta["rows"])
                job.touched = self._clock()
        self._attach_durability(name, job)
        _M_JOB_RESTORES.inc(algo=str(job.algo))  # the constructor admits only known algos
        logger.warning("restored job %r from durable state at pass %d (%d rows committed; "
                       "snapshot by boot %s, this boot %s)", name, job.iteration, job.rows,
                       meta.get("boot_id"), self.boot_id)
        return job

    def _save_model_state(self, name: str, served: _ServedModel) -> bool:
        """Snapshot a daemon-built index before the finalize's ack (an acked
        build is a restorable one); ``ensure_model`` registrations stay
        volatile. A device-built index is copied to the host under the
        device lock; the file is written outside it. True when a snapshot
        was written."""
        if self._state_dir is None:
            return False
        model = served.model
        with _DEVICE_LOCK:
            data = model._model_data()
        arrays = {k: np.asarray(v) for k, v in data.items() if v is not None}
        if served.id_map is not None:
            arrays["id_map"] = np.asarray(served.id_map, np.int64)
        params = {p: model.getOrDefault(p) for p in ("metric", "nprobe") if model.hasParam(p)}
        with trace_span("daemon snapshot write"):
            checkpoint_mod.save_state(self._model_state_path(name), arrays, {
                "name": name, "algo": served.algo, "params": params,
                "sharded": False,  # the port shards no index in one daemon
                "boot_id": self.boot_id,
            })
        return True

    def _discard_model_state(self, name: str) -> None:
        if self._state_dir is not None:
            checkpoint_mod.discard_state(self._model_state_path(name))

    def _touch_model_state(self, name: str) -> None:
        """Restart an evicted index's disk-retention clock."""
        if self._state_dir is None:
            return
        try:
            os.utime(self._model_state_path(name), None)
        except OSError:
            pass

    def _restore_model(self, name: str) -> Optional[_ServedModel]:
        """A daemon-built index from its snapshot: the core model rebuilt
        from the persisted arrays, its serving params re-pinned. It reaps at
        the plain TTL: the snapshot can re-create it."""
        with trace_span("daemon restore"):
            data = checkpoint_mod.load_state(self._model_state_path(name))
            if data is None:
                return None
            arrays, meta = data
            arrays = dict(arrays)
            id_map = arrays.pop("id_map", None)
            algo = str(meta["algo"])
            cls = (knn_mod.ApproximateNearestNeighborsModel if algo == "ann"
                   else knn_mod.NearestNeighborsModel)
            model = cls._from_model_data("served", arrays)
            model._device = self._device
            known = {k: v for k, v in (meta.get("params") or {}).items() if model.hasParam(k)}
            if known:
                model._set(**known)
        served = _ServedModel.from_model(algo, model, clock=self._clock, id_map=id_map,
                                         buckets=self._buckets)
        served.ttl_scale = 1.0
        logger.warning("restored served model %r from its durable snapshot (%s index; "
                       "snapshot by boot %s, this boot %s)", name, algo, meta.get("boot_id"),
                       self.boot_id)
        return served

    def _reap_loop(self) -> None:
        interval = (
            self._reap_interval if self._reap_interval is not None
            else max(min(self._ttl / 4.0, 30.0), 0.05)
        )
        while not self._stop.wait(interval):
            self._reap_once()

    def _reap_once(self) -> None:
        """Evict jobs and models idle longer than ``ttl`` (one reaper tick):
        a Spark driver that crashed between feed and finalize must not leak d × d
        device buffers forever. With a state_dir, also keep the live indexes'
        snapshots fresh and sweep orphan snapshots."""
        now = self._clock()
        evicted = []
        # Check-and-remove under BOTH locks (registry, then job); a job
        # whose lock is busy has an op in flight, which refreshes touched.
        with self._jobs_lock:
            for name, job in list(self._jobs.items()):
                if now - job.touched <= self._ttl:
                    continue
                if not job.lock.acquire(blocking=False):
                    continue
                try:
                    if now - job.touched > self._ttl:
                        # The snapshot first (see _drop_job): an evicted
                        # job must not be resurrectable.
                        self._discard_job_state(name)
                        job.dropped = True
                        del self._jobs[name]
                        evicted.append((name, job))
                finally:
                    job.lock.release()
        for name, job in evicted:
            logger.warning("evicted idle job %r (%.1fs > ttl %.1fs, %d rows fed)",
                           name, now - job.touched, self._ttl, job.rows)
        # A daemon-built index (ttl_scale 8) outlives a re-creatable
        # registration before its dataset-sized memory is reclaimed.
        with self._models_lock:
            stale = [n for n, m in self._models.items()
                     if now - m.touched > self._ttl * m.ttl_scale]
            for n in stale:
                del self._models[n]
        for n in stale:
            _M_MODEL_EVICTIONS.inc(reason="ttl")
            # An evicted durable index is disk-only from now: its snapshot's
            # retention clock restarts, so the sweep grants the full 8× TTL
            # from this moment.
            self._touch_model_state(n)
            logger.warning("evicted idle served model %r", n)
        if self._state_dir is not None:
            # A live index's snapshot stays fresh: an index live past 8× the
            # TTL would otherwise carry its build's mtime, and after a crash
            # the next boot's sweep could reclaim it before its first mention
            # restores it. The retention clock counts from eviction or death.
            with self._models_lock:
                live_now = list(self._models)
            for n in live_now:
                self._touch_model_state(n)
        self._sweep_orphan_snapshots()

    def _sweep_orphan_snapshots(self) -> None:
        """The on-disk twin of the reaper: a crashed fit whose driver died
        too leaves a job snapshot nothing mentions again. Sweep job
        snapshots with no live job idle past the TTL (boundary writes
        refresh the mtime, so an in-flight fit's is never swept), evicted
        index snapshots past 8× the TTL (a live index's never), and temp
        files of writes that died before their rename, past the TTL."""
        if self._state_dir is None:
            return
        with self._jobs_lock:
            live = {self._job_state_path(n) for n in self._jobs}
        with self._models_lock:
            live_models = {self._model_state_path(n) for n in self._models}
        try:
            names = os.listdir(self._state_dir)
        except OSError:
            return
        now_wall = time.time()  # file mtimes are wall-clock
        for fname in names:
            path = os.path.join(self._state_dir, fname)
            if fname.startswith("model-") and fname.endswith(".npz"):
                if path in live_models:
                    continue
                limit, what = self._ttl * 8.0, "served-model snapshot (evicted > 8x ttl)"
            elif fname.endswith(".tmp"):
                limit, what = self._ttl, "temp file (a write that crashed)"
            elif fname.startswith("job-") and fname.endswith(".npz"):
                if path in live:
                    continue
                limit, what = self._ttl, "orphan job snapshot (no live job, idle > ttl)"
            else:
                continue
            try:
                if now_wall - os.path.getmtime(path) > limit:
                    os.unlink(path)
                    logger.warning("swept %s %s", what, fname)
            except OSError:
                pass  # raced a restore or a drop, or already gone

    # -- the fleet's gossip plane (serve/gossip.py) -----------------------

    def _gossip_peers(self) -> list:
        """Up to ``gossip_fanout`` peer addresses from this daemon's view:
        live replica records other than its own. No lock is held across the
        exchanges."""
        peers = [r["addr"] for r in self.fleet_view.replicas(liveness="up")
                 if r["server_id"] != self.instance_id and r["addr"]]
        if len(peers) <= self._gossip_fanout:
            return peers
        return self._gossip_rng.sample(peers, self._gossip_fanout)

    def _gossip_tick(self) -> Dict[str, int]:
        """One anti-entropy round: push this view to each chosen peer and
        merge the peer's view from the ack. A failed peer (dead, busy, or
        the ``gossip.push`` fault site) drops that exchange for this tick:
        the view merges only complete acks."""
        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        pushed = dropped = 0
        for addr in self._gossip_peers():
            host, _, port = addr.rpartition(":")
            try:
                faults.checkpoint("gossip.push")
                with DataPlaneClient(host or "127.0.0.1", int(port), token=self._token,
                                     timeout=5.0, op_deadline_s=5.0, max_op_attempts=1) as c:
                    ack = c.gossip_push(self.fleet_view.to_wire())
                remote = ack.get("view")
                if isinstance(remote, dict):
                    self.fleet_view.merge(remote)
                pushed += 1
            except Exception as e:
                dropped += 1
                logger.debug("gossip push to %s dropped: %s", addr, e)
        _M_GOSSIP_TICKS.inc(outcome="partial" if dropped else "ok")
        return {"pushed": pushed, "dropped": dropped}

    def _gossip_loop(self) -> None:
        """One tick every ``gossip_interval_s`` until stop. Socket work only:
        it takes no daemon lock and never touches the device."""
        while not self._stop.wait(self._gossip_interval_s):
            try:
                self._gossip_tick()
            except Exception:
                logger.exception("gossip tick failed")

    def _op_gossip_push(self, conn, req: Dict[str, Any]) -> None:
        """Merge the sender's view and answer with this one (the pull half
        of push-pull). Never shed, never journaled."""
        remote = req.get("view")
        merged = self.fleet_view.merge(remote) if isinstance(remote, dict) else 0
        protocol.send_json(conn, {"ok": True, "merged": merged,
                                  "view": self.fleet_view.to_wire(), **self._identity()})

    def _op_gossip_pull(self, conn) -> None:
        """This daemon's FleetView, read-only: what a stateless client builds
        its routing table from."""
        protocol.send_json(conn, {"ok": True, "view": self.fleet_view.to_wire(),
                                  **self._identity()})

    # -- connections -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # socket closed
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True,
                                 name=f"srml-dataplane-{addr[1]}")
            with self._conns_lock:
                # Re-checked under the roster lock: a connection landing
                # after stop() (its own poke) must not spawn a thread
                # stop() would never join.
                if self._stop.is_set():
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conn_threads.add(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._active_conns += 1
            self._conn_socks.add(conn)
        try:
            faults.checkpoint("daemon.conn")
            self._serve_conn_inner(conn)
        except OSError:
            pass  # an injected or real transport failure: the connection is gone
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                self._active_conns -= 1
                self._conn_socks.discard(conn)
                self._conn_threads.discard(threading.current_thread())

    def _serve_conn_inner(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    req = protocol.recv_json(conn)
                except protocol.ProtocolError as e:
                    protocol.send_json(conn, {"ok": False, "error": str(e)})
                    return
                except OSError:
                    return  # transport died mid-read
                if req is None:
                    return  # client done
                op = _op_label(req.get("op"))
                t0 = time.perf_counter()
                outcome = "ok"
                exemplar = None
                try:
                    with _op_trace(op, req) as exemplar:
                        self._dispatch(conn, req)
                except (ConnectionError, TimeoutError):
                    # The CONNECTION broke, not the request: close it rather
                    # than answer on a dead or desynced wire. (PermissionError,
                    # the auth rejection, is an OSError answered below.)
                    outcome = "transport"
                    return
                except Exception as e:  # answer the caller, keep serving
                    outcome = "error"
                    logger.exception("request failed: %s", req.get("op"))
                    try:
                        protocol.send_json(conn, {"ok": False, "error": str(e)})
                    except OSError:
                        return
                finally:
                    # Per-op accounting (a shed op counts "ok" here;
                    # srml_daemon_busy_sheds_total carries the shed). The op
                    # span's identity is the sample's exemplar.
                    _M_REQ_SECONDS.observe(time.perf_counter() - t0, exemplar=exemplar, op=op)
                    _M_REQUESTS.inc(op=op, outcome=outcome)

    def _dispatch(self, conn, req: Dict[str, Any]) -> None:
        op = req.get("op")

        def _drain_payload():
            # Payload-carrying ops already have their frames in flight when
            # the JSON header is rejected: read them to keep the framing.
            if op in _PAYLOAD_OPS and not (op in _RAW_OR_ARROW_OPS and req.get("arrays")):
                protocol.recv_frame(conn)
            elif op in _ARRAY_OPS:
                for _ in req.get("arrays") or []:
                    protocol.recv_frame(conn)

        # Auth first, in constant time: an unauthenticated peer learns
        # nothing, not even the protocol version.
        if self._token is not None and not hmac.compare_digest(
            str(req.get("token", "")), self._token
        ):
            _drain_payload()
            raise PermissionError("unauthorized: bad or missing token")
        if op != "ping" and req.get("v") != protocol.PROTOCOL_VERSION:
            # ping is the version-exempt hello; a missing v is rejected too.
            _drain_payload()
            raise protocol.ProtocolError(
                f"protocol version mismatch: server speaks v{protocol.PROTOCOL_VERSION}, "
                f"request carried v={req.get('v')!r}; see docs/protocol.md"
            )
        faults.checkpoint("daemon.op")
        if op in _SHEDDABLE_OPS:
            reason = self._overloaded()
            if reason is not None:
                _M_BUSY_SHEDS.inc(op=_op_label(op))
                _drain_payload()
                protocol.send_json(conn, {
                    "ok": False, "busy": True,
                    "retry_after_s": self._retry_after_s,
                    "error": f"busy: {reason}",
                })
                return
        if op == "feed":
            self._op_feed(conn, req)
        elif op == "feed_raw":
            self._op_feed_raw(conn, req)
        elif op == "seed":
            self._op_seed(conn, req)
        elif op == "commit":
            job = self._get_job(req)
            rows = job.commit(int(req["partition"]), int(_opt(req, "attempt", 0)),
                              req.get("pass_id"))
            protocol.send_json(conn, {"ok": True, "rows": rows, **self._identity()})
        elif op == "finalize":
            self._op_finalize(conn, req)
        elif op == "step":
            job = self._get_job(req)
            info = job.step(_opt(req, "params", {}), step_id=req.get("step_id"))
            # The step applied and its ack is unsent: a crash here is a
            # daemon dying exactly at the pass boundary.
            faults.checkpoint("daemon.pass_boundary")
            protocol.send_json(conn, {"ok": True, **self._identity(), **info})
        elif op == "status":
            job = self._get_job(req)
            protocol.send_json(conn, {"ok": True, "rows": job.rows, "algo": job.algo,
                                      "n_cols": job.n_cols, "pass_rows": job.pass_rows,
                                      "iteration": job.iteration})
        elif op == "drop":
            protocol.send_json(conn, {"ok": True, "dropped": self._drop_job(str(req.get("job")))})
        elif op == "export_state":
            # The permanent-loss site (with reduce_mesh and set_iterate): a
            # crash here is a peer dying as the fit coordinates across
            # daemons, which the driver's death policy must survive.
            faults.checkpoint("daemon.vanish")
            arrays, meta = self._get_job(req).export_state()
            _send_arrays_counted(conn, "export_state", arrays, {"ok": True, **meta})
        elif op == "merge_state":
            self._op_merge_state(conn, req)
        elif op == "mesh_info":
            self._op_mesh_info(conn)
        elif op == "reduce_mesh":
            self._op_reduce_mesh(conn, req)
        elif op == "sample_rows":
            rows = self._get_job(req).sample_rows(int(_opt(req, "n", 1024)),
                                                  int(_opt(req, "seed", 0)))
            _send_arrays_counted(conn, "sample_rows", {"rows": rows}, {"ok": True})
        elif op == "get_iterate":
            arrays, meta = self._get_job(req).get_iterate()
            _send_arrays_counted(conn, "get_iterate", arrays, {"ok": True, **meta})
        elif op == "set_iterate":
            self._op_set_iterate(conn, req)
        elif op == "ensure_model":
            self._op_ensure_model(conn, req)
        elif op == "transform":
            self._op_transform(conn, req)
        elif op == "kneighbors":
            self._op_kneighbors(conn, req)
        elif op == "warmup":
            self._op_warmup(conn, req)
        elif op == "model_status":
            m = self._lookup_model(str(req.get("model")))
            # ``aot``: the registration's compile ledger, null when AOT never
            # ran for it.
            protocol.send_json(conn, {"ok": True, "exists": m is not None,
                                      "algo": None if m is None else m.algo,
                                      "aot": None if m is None else m.aot_status()})
        elif op == "drop_model":
            # The snapshot first, whether or not the model is live: an
            # orphan snapshot would resurrect the released index.
            model_name = str(req.get("model"))
            self._discard_model_state(model_name)
            with self._models_lock:
                m = self._models.pop(model_name, None)
            if m is not None:
                m.release_aot()
            protocol.send_json(conn, {"ok": True, "dropped": m is not None})
        elif op == "gossip_push":
            self._op_gossip_push(conn, req)
        elif op == "gossip_pull":
            self._op_gossip_pull(conn)
        elif op == "health":
            self._op_health(conn)
        elif op == "metrics":
            self._op_metrics(conn, req)
        elif op == "telemetry_pull":
            self._op_telemetry_pull(conn)
        elif op == "trace_pull":
            self._op_trace_pull(conn, req)
        elif op == "ping":
            protocol.send_json(conn, {"ok": True, "v": protocol.PROTOCOL_VERSION,
                                      **self._identity()})
        else:
            _drain_payload()
            raise ValueError(f"unknown op {op!r}")

    # -- backpressure ------------------------------------------------------

    def _staged_bytes_total(self) -> int:
        with self._jobs_lock:
            return sum(j.staged_bytes for j in self._jobs.values())

    def _overloaded(self, staged: Optional[int] = None) -> Optional[str]:
        """The watermark breach, or None. A load signal, read without job
        locks. ``staged``: the staged-bytes total when the caller reports it
        too (``health``), so the reported value is the one judged."""
        if self._max_connections is not None:
            with self._conns_lock:
                n = self._active_conns
            if n > self._max_connections:
                return (f"{n} concurrent connections exceed the watermark "
                        f"({self._max_connections})")
        if self._max_staged_bytes is not None:
            if staged is None:
                staged = self._staged_bytes_total()
            if staged > self._max_staged_bytes:
                return (f"{staged} staged bytes exceed the watermark "
                        f"({self._max_staged_bytes}); commit or drop stages")
        return None

    # -- observability -----------------------------------------------------

    def _op_health(self, conn) -> None:
        """Load and liveness in O(jobs) time. Never shed: health is how a
        load balancer decides where to send traffic, and a daemon too busy
        to say "busy" looks dead. ``durable``: a ``state_dir`` is set."""
        staged_bytes = self._staged_bytes_total()
        reason = self._overloaded(staged=staged_bytes)
        with self._jobs_lock:
            active_jobs = len(self._jobs)
        with self._models_lock:
            served_models = len(self._models)
        with self._conns_lock:
            queue_depth = self._active_conns
        mesh_snap = membership_mod.registry().snapshot()
        resp = {
            "ok": True,
            "v": protocol.PROTOCOL_VERSION,
            "id": self.instance_id,
            "boot_id": self.boot_id,
            "durable": self._state_dir is not None,
            "queue_depth": queue_depth,
            "staged_bytes": staged_bytes,
            "active_jobs": active_jobs,
            "served_models": served_models,
            "uptime_s": float(self._clock() - self._started),
            "busy": reason is not None,
            # The serving scheduler's config, per-model queue depths and
            # dispatched batches.
            "scheduler": ({"enabled": False} if self._scheduler is None
                          else self._scheduler.snapshot()),
            # The membership epoch a driver fences reduce_mesh with, and how
            # many co-resident daemons share this device plane.
            "mesh": {"epoch": mesh_snap["epoch"], "members": len(mesh_snap["members"])},
        }
        if reason is not None:
            resp["retry_after_s"] = self._retry_after_s
            resp["busy_reason"] = reason
        protocol.send_json(conn, resp)

    def _op_metrics(self, conn, req: Dict[str, Any]) -> None:
        """The process-wide metrics registry, its level gauges refreshed at
        scrape. ``format``: "json" (the registry snapshot, histogram buckets
        cumulative) or "prometheus" (text exposition v0.0.4 in ``text``).
        Never shed: a scrape is O(registry) host work, and what an operator
        needs most when the daemon is busy."""
        self._refresh_level_gauges()
        fmt = str(_opt(req, "format", "json"))
        base = {
            "ok": True,
            "v": protocol.PROTOCOL_VERSION,
            "id": self.instance_id,
            "uptime_s": float(self._clock() - self._started),
        }
        if fmt == "prometheus":
            protocol.send_json(conn, {**base, "text": metrics_mod.render_prometheus()})
        elif fmt == "json":
            protocol.send_json(conn, {**base, "metrics": metrics_mod.snapshot()})
        else:
            raise ValueError(f"unknown metrics format {fmt!r} (json|prometheus)")

    def _op_telemetry_pull(self, conn) -> None:
        """Everything a scrape needs in one cursor-free answer: the registry
        as OpenMetrics text with per-bucket exemplars (``text``) and as the
        JSON snapshot (``metrics``), the kernel ledger (``xprof``) and the
        config fingerprint. Never shed, never journaled."""
        self._refresh_level_gauges()
        protocol.send_json(conn, {
            "ok": True,
            "v": protocol.PROTOCOL_VERSION,
            **self._identity(),
            "uptime_s": float(self._clock() - self._started),
            "text": metrics_mod.render_openmetrics(),
            "metrics": metrics_mod.snapshot(),
            "xprof": xprof_mod.snapshot(),
            "fingerprint": config.fingerprint(),
        })

    def _op_trace_pull(self, conn, req: Dict[str, Any]) -> None:
        """The ring's journal events with ``seq`` above the request's
        ``cursor`` (0: all it holds), and the current ``seq``, the caller's
        next cursor: repeated pulls stream without duplication. The cursor
        is per daemon process and per boot (restart from 0 when ``boot_id``
        changes); events that aged out of the bounded ring are gone."""
        events, seq = journal.tail(int(_opt(req, "cursor", 0) or 0))
        protocol.send_json(conn, {
            "ok": True,
            "v": protocol.PROTOCOL_VERSION,
            **self._identity(),
            "events": events,
            "seq": seq,
        })

    def _refresh_level_gauges(self) -> None:
        """The level gauges (staged bytes, jobs, models, connections, the
        scheduler's queue depths), refreshed at scrape so a snapshot agrees
        with what ``health`` would report."""
        _M_STAGED.set(self._staged_bytes_total())
        with self._jobs_lock:
            _M_JOBS.set(len(self._jobs))
        with self._models_lock:
            _M_MODELS.set(len(self._models))
        with self._conns_lock:
            _M_CONNS.set(self._active_conns)
        if self._scheduler is not None:
            self._scheduler.snapshot()  # refreshes the queue-depth gauge

    # -- jobs --------------------------------------------------------------

    def _get_job(self, req) -> _Job:
        name = str(req.get("job"))
        job = self._lookup_job(name)  # the registry, then a durable restore
        if job is None:
            raise KeyError(f"no such job {name!r}")
        return job

    def _drop_job(self, name: str) -> bool:
        """The ``drop`` op's body (also run on peers by a single-pass
        ``reduce_mesh``). The snapshot goes first, whether or not the job is
        live (an orphan snapshot would resurrect the aborted job), and
        before the registry entry, so a racing restore finds either the
        entry or no file."""
        self._discard_job_state(name)
        with self._jobs_lock:
            job = self._jobs.pop(name, None)
        if job is not None:
            with job.lock:
                job.dropped = True
        return job is not None

    def _lookup_job(self, name: str) -> Optional[_Job]:
        """The registry, then a lazy durable restore, single-filed on the
        restore lock with a re-check, so concurrent first mentions after a
        restart restore once."""
        with self._jobs_lock:
            job = self._jobs.get(name)
        if job is not None or self._state_dir is None:
            return job
        with self._restore_lock:
            with self._jobs_lock:
                job = self._jobs.get(name)
            if job is not None:
                return job
            restored = self._restore_job(name)
        if restored is None:
            return None
        with self._jobs_lock:
            current = self._jobs.get(name)
            if current is None:
                self._jobs[name] = restored
                current = restored
        if current is restored and not os.path.exists(self._job_state_path(name)):
            # A drop or finalize raced the restore and discarded the
            # snapshot (before unregistering): honour the abort.
            with self._jobs_lock:
                if self._jobs.get(name) is restored:
                    del self._jobs[name]
            with restored.lock:
                restored.dropped = True
            return None
        return current

    def _op_feed(self, conn, req: Dict[str, Any]) -> None:
        labelled = str(_opt(req, "algo", "pca")) in _LABELLED
        x, y = _recv_arrow_matrix(conn, "feed", _opt(req, "input_col", "features"),
                                  req.get("n_cols"),
                                  _opt(req, "label_col", "label") if labelled else None)
        self._feed_validated(conn, req, x, y)

    def _op_feed_raw(self, conn, req: Dict[str, Any]) -> None:
        """`feed` with raw little-endian C-contiguous buffers instead of
        Arrow IPC: array `x` (n, d) float32/float64 and, for linreg, logreg
        and rf, `y` (n,)."""
        arrays = _recv_arrays_aligned(conn, req)
        if "x" not in arrays:
            raise ValueError("feed_raw needs an 'x' array in the request spec")
        x = arrays["x"]
        if x.ndim != 2:
            raise ValueError(f"feed_raw 'x' must be 2-D, got shape {x.shape}")
        if x.dtype not in (np.float32, np.float64):
            raise ValueError(f"feed_raw 'x' must be float32/float64, got {x.dtype}")
        n_cols = req.get("n_cols")
        if n_cols is not None and int(n_cols) != x.shape[1]:
            raise ValueError(f"feed_raw 'x' width {x.shape[1]} != declared n_cols {n_cols}")
        y = arrays.get("y")
        if y is not None:
            y = y.reshape(-1)
            if y.shape[0] != x.shape[0]:
                raise ValueError(f"feed_raw 'y' length {y.shape[0]} != rows {x.shape[0]}")
        self._feed_validated(conn, req, x, y)

    def _feed_validated(self, conn, req: Dict[str, Any], x: np.ndarray,
                        y: Optional[np.ndarray]) -> None:
        """Shared feed tail: validate BEFORE registering a job, so a
        rejected first feed leaves no orphan job (with its d × d buffers)
        under the name."""
        name = str(req["job"])
        algo = str(_opt(req, "algo", "pca"))
        if algo not in _ALGOS:
            raise ValueError(f"unknown algo {algo!r} ({'|'.join(_ALGOS)})")
        params = _opt(req, "params", {})
        # One parse of n_classes for the label check and the job guard: a
        # logreg job defaults to 2, a forest's 0 (read raw) is a regressor.
        n_classes = int(params.get("n_classes") or (0 if algo == "rf" else 2))
        if algo in _LABELLED:
            if y is None:
                raise ValueError(f"{algo} feed needs a label array")
            if (algo == "rf" and n_classes > 0) or (algo == "logreg" and n_classes > 2):
                lg_mod.validate_multiclass_labels(y, n_classes)
            elif algo == "logreg":
                lg_mod.validate_binary_labels(y)
        job = self._lookup_job(name)
        if job is None and algo == "kmeans" and x.shape[0] < int(params.get("k", 0)):
            # Before registering: a first batch smaller than k must not
            # leave a centreless job parked under the name.
            raise ValueError(f"first kmeans batch has {x.shape[0]} rows < k={params.get('k')}; "
                             "feed a larger first batch (it seeds the centers)")
        part = req.get("partition")
        for retry in (False, True):
            created = False
            if job is None:
                with self._jobs_lock:
                    job = self._jobs.get(name)
                    created = job is None
                    if created:
                        job = _Job(algo, x.shape[1], self._device, params, clock=self._clock)
                        self._attach_durability(name, job)
                        self._jobs[name] = job
            if job.algo != algo:
                raise ValueError(f"job {name!r} is algo {job.algo!r}; feed requested {algo!r}")
            job_classes = (job.n_classes if algo == "logreg"
                           else job.rf_spec.n_classes if algo == "rf" else n_classes)
            if n_classes != job_classes:
                raise ValueError(f"job {name!r} has n_classes={job_classes}; feed carried "
                                 f"n_classes={n_classes}")
            try:
                job.fold(
                    x,
                    y,
                    partition=None if part is None else int(part),
                    attempt=int(_opt(req, "attempt", 0)),
                    pass_id=req.get("pass_id"),
                    feed_id=req.get("feed_id"),
                )
                break
            except ValueError:
                if created:
                    # A job whose very FIRST fold was rejected (a mid-fit
                    # pass_id, ...) must not stay parked under the name:
                    # every Spark retry would meet the orphan.
                    with self._jobs_lock:
                        if self._jobs.get(name) is job:
                            with job.lock:
                                if job.rows == 0 and not job.staged and not job.committed:
                                    job.dropped = True
                                    del self._jobs[name]
                raise
            except KeyError:
                # fold met dropped=True: usually a finalized job, but the
                # cleanup above can race a concurrent valid first feed (this
                # thread fetched the job, a sibling's rejected first fold
                # then dropped it while still empty). The victim is an EMPTY
                # job that has left the registry: retry once against it.
                if retry or created:
                    raise
                with job.lock:
                    empty = job.rows == 0 and not job.staged and not job.committed
                with self._jobs_lock:
                    gone = self._jobs.get(name) is not job
                if not (empty and gone):
                    raise
                logger.info("feed into job %r raced a rejected-first-feed cleanup; "
                            "retrying against the live registry", name)
                job = None
        protocol.send_json(conn, {"ok": True, "rows": job.rows, **self._identity()})

    def _op_finalize(self, conn, req: Dict[str, Any]) -> None:
        # Optional raw array frames (a knn build's ``centroids`` or
        # ``train_rows``): read FIRST so any rejection leaves the framing
        # aligned.
        extra = _recv_arrays_aligned(conn, req) if req.get("arrays") else {}
        job = self._get_job(req)
        params = _opt(req, "params", {})
        if job.algo == "knn":
            self._finalize_knn(conn, req, job, params, extra)
            return
        drop = bool(_opt(req, "drop", True))
        arrays = job.finalize(params, drop=drop)
        # Unregister BEFORE sending: a client that disconnects mid-response
        # must not leave the name poisoned (dropped) in the registry. The
        # snapshot goes before the entry (see _drop_job).
        if drop:
            self._discard_job_state(str(req.get("job")))
            with self._jobs_lock:
                if self._jobs.get(str(req.get("job"))) is job:
                    del self._jobs[str(req.get("job"))]
        _send_arrays_counted(conn, "finalize", arrays, {"ok": True, "rows": job.rows,
                                                        "pass_rows": job.pass_rows,
                                                        **self._identity()})

    def _finalize_knn(self, conn, req: Dict[str, Any], job: _Job, params: Dict[str, Any],
                      extra: Dict[str, np.ndarray]) -> None:
        """Build-and-serve: the index is registered here under
        ``register_as`` (first wins: a name already registered is refused
        before and after the build) and only the O(1) info goes back. The
        job is consumed whatever ``drop`` says."""
        name = str(params.get("register_as") or f"knn-{req.get('job')}")
        taken = (f"model name {name!r} is already registered; pick a fresh register_as")
        with self._models_lock:
            if name in self._models:
                raise ValueError(taken)
        model, info, id_map = job.build_knn_model(params, extra)
        served = _ServedModel.from_model("ann" if params.get("mode") == "ivf" else "knn", model,
                                         clock=self._clock, id_map=id_map, buckets=self._buckets)
        with self._models_lock:
            if name in self._models:  # a raced registration: the first wins
                raise ValueError(taken)
            self._models[name] = served
            evicted = self._enforce_model_cap_locked(keep=name)
        self._log_lru_evictions(evicted)
        # A durable daemon snapshots the built index BEFORE the ack: an
        # acked build survives a SIGKILL, and the registration reaps at the
        # plain TTL (the snapshot re-creates it).
        if self._save_model_state(name, served):
            served.ttl_scale = 1.0
        # The eager warmup of ensure_model, for the built index: its
        # kneighbors ladder is dispatched before the finalize ack.
        self._warmup_on_register(name, int(np.asarray(info["n_cols"]).reshape(-1)[0]))
        self._discard_job_state(str(req.get("job")))  # before the entry (see _drop_job)
        with self._jobs_lock:
            if self._jobs.get(str(req.get("job"))) is job:
                del self._jobs[str(req.get("job"))]
        _send_arrays_counted(conn, "finalize", info, {"ok": True, "rows": job.rows,
                                                      "model": name, **self._identity()})

    def _op_seed(self, conn, req: Dict[str, Any]) -> None:
        """Driver-sent deterministic kmeans init: the batch seeds the
        centres, its rows are NOT folded (they arrive through the scan).
        The rows come as one Arrow payload, or as raw ``arrays`` frames
        (``x``) from a driver without an Arrow library."""
        if req.get("arrays"):
            x = _recv_raw_matrix(conn, req, "seed")
        else:
            x, _ = _recv_arrow_matrix(conn, "seed", _opt(req, "input_col", "features"),
                                      req.get("n_cols"))
        name = str(req["job"])
        params = _opt(req, "params", {})
        k = int(params.get("k", 0))
        if x.shape[0] < k:
            raise ValueError(f"seed batch has {x.shape[0]} rows < k={k}")
        job = self._lookup_job(name)
        if job is None:
            with self._jobs_lock:
                job = self._jobs.get(name)
                if job is None:
                    job = _Job("kmeans", x.shape[1], self._device, params, clock=self._clock)
                    self._attach_durability(name, job)
                    self._jobs[name] = job
        job.seed_centers(x)
        protocol.send_json(conn, {"ok": True, "rows": job.rows, **self._identity()})

    def _op_set_iterate(self, conn, req: Dict[str, Any]) -> None:
        """Install a driver-pushed iterate. When the job is unknown and the
        request carries ``n_cols`` (with ``algo``/``params``, as a first
        feed), the job is CREATED at that iterate: the driver's recovery
        ledger re-seeds a daemon that lost the job. Without ``n_cols`` an
        unknown job stays an error."""
        arrays = _recv_arrays_aligned(conn, req)
        # The permanent-loss site (see export_state): the boundary sync is
        # where an iterative fit meets a dead peer; the frames are drained,
        # so the framing stays aligned.
        faults.checkpoint("daemon.vanish")
        name = str(req["job"])
        job = self._lookup_job(name)
        if job is None:
            n_cols = req.get("n_cols")
            if n_cols is None:
                raise KeyError(f"no such job {name!r} (a recovery set_iterate that should "
                               "recreate it must carry n_cols/algo/params)")
            # The admission handshake's daemon end: a joiner that crashes
            # or stalls here leaves the driver's membership as it was (the
            # driver registers a peer only once this op acks).
            faults.checkpoint("daemon.join")
            job = _Job(str(_opt(req, "algo", "pca")), int(n_cols), self._device,
                       _opt(req, "params", {}), clock=self._clock)
            self._attach_durability(name, job)
            # Installed BEFORE the job is published: a rejected iterate (a
            # bad shape) leaves no orphan job under the name.
            job.set_iterate(arrays, int(req["iteration"]))
            with self._jobs_lock:
                current = self._jobs.get(name)
                if current is None:
                    self._jobs[name] = job
            if current is None:
                protocol.send_json(conn, {"ok": True, **self._identity()})
                return
            job = current  # raced a concurrent creation: converge on it
        job.set_iterate(arrays, int(req["iteration"]))
        protocol.send_json(conn, {"ok": True, **self._identity()})

    # -- cross-daemon merges -----------------------------------------------

    def _op_merge_state(self, conn, req: Dict[str, Any]) -> None:
        """Fold a peer daemon's exported job state into the named job: the
        driver's hub reduce. The job is created when absent (the request
        carries ``algo``, ``n_cols`` and ``params`` as a first feed does),
        so a driver can merge into a primary that was fed no row. ``rows``
        is the exporter's committed contribution."""
        arrays = _recv_arrays_aligned(conn, req)
        name = str(req["job"])
        req_algo = str(_opt(req, "algo", "pca"))
        contrib = int(_opt(req, "rows", 0))
        merge_id = req.get("merge_id")
        job = self._lookup_job(name)
        if job is None:
            n_cols = req.get("n_cols")
            if n_cols is None:
                raise ValueError("merge_state into an unknown job needs n_cols")
            # Merged BEFORE the job is published: a rejected payload (a
            # count or shape mismatch) leaves no orphan job under the name.
            job = _Job(req_algo, int(n_cols), self._device, _opt(req, "params", {}),
                       clock=self._clock)
            self._attach_durability(name, job)
            rows = job.merge_remote(arrays, contrib, merge_id=merge_id)
            with self._jobs_lock:
                current = self._jobs.get(name)
                if current is None:
                    self._jobs[name] = job
            if current is None:
                protocol.send_json(conn, {"ok": True, "rows": rows})
                return
            job = current  # raced a concurrent creation: fold into the published job
        if job.algo != req_algo:
            raise ValueError(f"job {name!r} is algo {job.algo!r}; merge_state carried "
                             f"{req_algo!r}")
        rows = job.merge_remote(arrays, contrib, merge_id=merge_id)
        protocol.send_json(conn, {"ok": True, "rows": rows})

    def _op_mesh_info(self, conn) -> None:
        """The membership snapshot of this process's device plane: its
        daemons (id, boot_id, joined_epoch) and the fencing epoch, which
        the driver reads to choose the collective reduce or the hub and
        stamps on ``reduce_mesh``. ``n_devices`` is this daemon's: one."""
        snap = membership_mod.registry().snapshot()
        protocol.send_json(conn, {
            "ok": True,
            "v": protocol.PROTOCOL_VERSION,
            **self._identity(),
            "epoch": snap["epoch"],
            "members": snap["members"],
            "n_devices": 1,
        })

    def _op_reduce_mesh(self, conn, req: Dict[str, Any]) -> None:
        """Fold co-resident peer daemons' committed pass partials into the
        named job on the device: the driver's hub (export_state, the wire,
        merge_state) collapsed into one op whose statistics never leave the
        card. Every check runs before anything folds:

        1. the replay dedupe: an applied ``reduce_id`` gets its ack back
           (its ``drop_peers`` may have dropped the peers' jobs already);
        2. the epoch fence: the request's ``epoch`` must be the live
           membership epoch, so a join, leave or reboot since the driver's
           ``mesh_info`` refuses the reduce;
        3. the pre-reduce gather of each peer's (boot, pass rows, committed
           partitions, iteration) against the driver's task acks.

        Then the fold in sorted-peer order (bitwise the hub's), and with
        ``drop_peers`` (the single-pass algos) the peers' jobs go."""
        name = str(req["job"])
        req_algo = str(_opt(req, "algo", "pca"))
        peers_spec = req.get("peers") or {}
        if not isinstance(peers_spec, dict) or not peers_spec:
            raise ValueError("reduce_mesh needs a non-empty peers map")
        # The permanent-loss site (see export_state): a peer stopping here
        # leaves the mesh mid-reduce, and the epoch fence refuses the replay.
        faults.checkpoint("daemon.vanish")
        job = self._lookup_job(name)
        if job is not None:
            cached = job.seen_reduce(req.get("reduce_id"))
            if cached is not None:
                protocol.send_json(conn, {"ok": True, "rows": cached,
                                          "reduced": len(peers_spec), **self._identity()})
                return
        reg = membership_mod.registry()
        snap = reg.snapshot()
        if int(_opt(req, "epoch", -1)) != snap["epoch"]:
            raise RuntimeError(
                f"mesh membership changed (epoch {snap['epoch']} != driver's "
                f"{req.get('epoch')}): a daemon joined, left, or rebooted since mesh_info; "
                "replay the pass")
        members = {m["id"]: m["boot_id"] for m in snap["members"]}
        gathered = []
        for pid in sorted(peers_spec):
            spec = peers_spec[pid] or {}
            boot = str(spec.get("boot_id"))
            if pid == self.instance_id:
                raise ValueError("reduce_mesh peers must not include the target daemon")
            if members.get(pid) != boot:
                raise RuntimeError(
                    f"peer daemon {pid} is not a co-resident mesh member at boot {boot} "
                    f"(epoch {snap['epoch']}): it rebooted or left — rows acked to the old "
                    "incarnation are gone; replay the pass")
            peer = reg.get(pid, boot_id=boot)
            if peer is None:
                raise RuntimeError(f"peer daemon {pid} left the mesh")
            pjob = peer._lookup_job(name)
            if pjob is None:
                raise KeyError(f"peer daemon {pid} has no job {name!r}")
            state, pass_rows, committed, iteration = pjob.peek_pass_state()
            want_rows = int(_opt(spec, "rows", -1))
            if pass_rows != want_rows:
                raise RuntimeError(
                    f"daemon row-count mismatch at mesh reduce: tasks acked {want_rows} rows "
                    f"on peer {pid} but its job accounts {pass_rows} this pass; falling "
                    "through would corrupt the model — replay or refit")
            want_parts = {int(p) for p in (spec.get("partitions") or [])}
            orphans = sorted(p for p in committed if p not in want_parts)
            lost = sorted(p for p in want_parts if p not in committed)
            if orphans or lost:
                parts = []
                if orphans:
                    parts.append(f"partitions {orphans} committed on peer {pid} but acked "
                                 "elsewhere (cross-daemon retry orphans)")
                if lost:
                    parts.append(f"partitions {lost} acked on peer {pid} but not committed")
                raise RuntimeError("partition accounting mismatch at mesh reduce: "
                                   + "; ".join(parts))
            gathered.append((pid, peer, pjob, state, pass_rows, iteration))
        contributions = [(pid, state, n) for pid, _p, _j, state, n, _i in gathered]
        job = self._lookup_job(name)
        fresh = job is None
        if fresh:
            # Every row may have been fed to peers: create the target as
            # merge_state does, shaped from the first peer's job, and fold
            # BEFORE it is published: a refused reduce leaves no orphan job.
            job = _Job(req_algo, gathered[0][2].n_cols, self._device,
                       _opt(req, "params", {}), clock=self._clock)
            self._attach_durability(name, job)
        _check_mesh_target(name, job, req_algo, gathered)
        rows = job.merge_mesh(contributions, reduce_id=req.get("reduce_id"))
        if fresh:
            with self._jobs_lock:
                current = self._jobs.get(name)
                if current is None:
                    self._jobs[name] = job
            if current is not None:
                job = current  # raced a concurrent creation: fold into the published job
                _check_mesh_target(name, job, req_algo, gathered)
                rows = job.merge_mesh(contributions, reduce_id=req.get("reduce_id"))
        if _opt(req, "drop_peers", False):
            for _pid, peer, _pjob, _state, _rows, _i in gathered:
                peer._drop_job(name)
        _M_MESH_REDUCES.inc(algo=job.algo)
        protocol.send_json(conn, {"ok": True, "rows": rows, "reduced": len(gathered),
                                  **self._identity()})

    # -- serving -----------------------------------------------------------

    def _op_ensure_model(self, conn, req: Dict[str, Any]) -> None:
        """Register a fitted model for serving (idempotent; the first caller
        wins). Raw array frames follow the JSON per its ``arrays`` spec.
        ``version`` pins the registration to a fleet model version: it is
        immutable under the name (another version is refused), and a
        registration made without one adopts a later pin."""
        arrays = _recv_arrays_aligned(conn, req)
        name = str(req["model"])
        algo = str(req["algo"])
        version = req.get("version")
        version = None if version is None else int(version)
        _model_class(algo)  # an unknown algo is refused before the registry is touched
        evicted = []
        with self._models_lock:
            existing = self._models.get(name)
            if existing is None:
                served = _ServedModel(algo, arrays, _opt(req, "params", {}), self._device,
                                      clock=self._clock, buckets=self._buckets)
                served.version = version
                self._models[name] = served
                created = True
                evicted = self._enforce_model_cap_locked(keep=name)
            else:
                if existing.algo != algo:
                    raise ValueError(f"model {name!r} is algo {existing.algo!r}; "
                                     f"ensure_model requested {algo!r}")
                if (version is not None and existing.version is not None
                        and existing.version != version):
                    # Two fleets' flips must never race into serving mixed
                    # versions under one key.
                    raise ValueError(
                        f"model {name!r} is registered at version {existing.version}; "
                        f"ensure_model carried version {version} — versions are immutable, "
                        "register the new version under its own name")
                if existing.version is None and version is not None:
                    existing.version = version  # adopt the late pin
                existing.touched = self._clock()
                created = False
        self._log_lru_evictions(evicted)
        warmed = self._warmup_on_register(name, _model_width(algo, arrays)) if created else None
        ack: Dict[str, Any] = {"ok": True, "created": created}
        if warmed is not None:
            ack["warmup"] = warmed
        protocol.send_json(conn, ack)

    def _warmup_on_register(self, name: str, width: Optional[int]) -> Optional[Dict[str, Any]]:
        """The eager warmup (config ``serve_warmup_on_register``): the
        ladder's trace warmup at registration, of an ensure_model payload or
        a daemon-built index, before the registering caller's ack. A failed
        warmup is logged and never fails the registration. Returns the
        warmup info, or None when it does not apply (scheduler off, flag
        off, unknown width)."""
        if self._scheduler is None or width is None:
            return None
        if not bool(config.peek("serve_warmup_on_register")):
            return None
        with self._models_lock:
            served = self._models.get(name)
        if served is None:
            return None
        kind = "kneighbors" if hasattr(served.model, "kneighbors") else "transform"
        try:
            return self._warm_model(name, served, int(width), kind=kind,
                                    k=_resolve_k(served, None) if kind == "kneighbors" else None)
        except Exception as e:
            logger.warning("warmup-on-register for %r failed (first requests will meet cold "
                           "shapes): %s", name, e)
            return None

    def _warm_model(self, name: str, served, n_cols: int, kind: str, k: Optional[int],
                    dtype: str = "float32") -> Dict[str, Any]:
        """One warm pass over the reachable bucket ladder, AOT-first, as the
        reference's: with ``serve_aot`` on and a model that publishes a
        plan, every bucket's serving program is built and held
        (:meth:`_ServedModel.aot_warm`) and the scheduler's shape ledger
        pre-marked, so the first batch at a warmed bucket reads as a hit. A
        model without a plan, a failed capture (logged) or ``serve_aot`` off
        runs the trace warmup, a zero batch dispatched at every bucket. The
        ack's ``aot`` says which ran."""
        buckets = self._scheduler.reachable_buckets()
        if bool(config.peek("serve_aot")):
            try:
                info = served.aot_warm(n_cols, buckets, k, dtype)
            except Exception as e:
                logger.warning("AOT warmup for %r failed (falling back to the trace warmup): "
                               "%s", name, e)
                info = None
            if info is not None:
                self._scheduler.premark_shapes(
                    served, [(kind, k, dtype, int(n_cols), int(b)) for b in info["buckets"]])
                return {**info, "aot": True}
        out = self._scheduler.warmup(name, served, int(n_cols), kind=kind, k=k, dtype=dtype)
        return {**out, "aot": False}

    def _serve_dispatch(self, conn, req: Dict[str, Any], kind: str, name: str, served, x,
                        k: Optional[int] = None):
        """Run one serving request through the micro-batching scheduler (when
        it runs and the request fits the coalescing cap) or solo. Returns
        the result, or None after answering a scheduler shed with the
        busy/retry_after_s response (the payload was already read, so the
        framing stays aligned)."""
        sched = self._scheduler
        if sched is not None:
            # IVF/ANN kneighbors never coalesces: the capacity-bucketed
            # candidate search shares per-list query slots across the batch,
            # so a co-batched or padding row can EVICT a real query's
            # candidates. Exact kNN and every transform are row-wise.
            ann = kind == "kneighbors" and getattr(served, "algo", "") == "ann"
            if not ann and sched.eligible(int(x.shape[0])):
                try:
                    return sched.submit(name, served, kind, x, k=k,
                                        deadline_s=req.get("deadline_s"))
                except scheduler_mod.SchedulerBusy as e:
                    _M_BUSY_SHEDS.inc(op=_op_label(kind))
                    protocol.send_json(conn, {"ok": False, "busy": True,
                                              "retry_after_s": e.retry_after_s,
                                              "error": f"busy: {e}"})
                    return None
            elif x.shape[0]:  # a 0-row request is not "larger than the ladder"
                sched.note_bypass(kind)
        if kind == "transform":
            return served.transform(x)
        return served.kneighbors(x, k)

    def _op_warmup(self, conn, req: Dict[str, Any]) -> None:
        """Warm the scheduler's bucket ladder for a served model, so each
        bucket's first request finds its shape seen. ``n_cols`` names the
        feature width to warm; ``dtype`` (default float32) must be the dtype
        real traffic carries (the batch key includes it). With the scheduler
        off the op is an honest no-op (enabled: false)."""
        served = self._require_model(str(req["model"]))
        if self._scheduler is None:
            protocol.send_json(conn, {"ok": True, "enabled": False, "buckets": [],
                                      "compiled": 0})
            return
        n_cols = req.get("n_cols")
        if n_cols is None:
            raise ValueError("warmup needs n_cols (the model's feature width)")
        kind = _opt(req, "kind",
                    "kneighbors" if hasattr(served.model, "kneighbors") else "transform")
        if kind not in ("transform", "kneighbors"):
            raise ValueError(f"unknown warmup kind {kind!r} (transform|kneighbors)")
        info = self._warm_model(
            str(req["model"]), served, int(n_cols), kind=str(kind),
            k=_resolve_k(served, req.get("k")) if kind == "kneighbors" else None,
            dtype=str(_opt(req, "dtype", "float32")),
        )
        protocol.send_json(conn, {"ok": True, "enabled": True, **info})

    def _enforce_model_cap_locked(self, keep: str) -> list:
        """LRU eviction past ``max_models`` (under ``_models_lock``, right
        after registering ``keep``). Re-creatable registrations (ttl_scale
        1) go first; a daemon-built index only when none is left. Returns
        the evicted names."""
        if self._max_models is None:
            return []
        evicted = []
        while len(self._models) > self._max_models:
            candidates = sorted((m.ttl_scale, m.touched, n)
                                for n, m in self._models.items() if n != keep)
            if not candidates:
                break
            victim = candidates[0][2]
            del self._models[victim]
            _M_MODEL_EVICTIONS.inc(reason="lru")
            evicted.append(victim)
        return evicted

    def _log_lru_evictions(self, evicted: list) -> None:
        for victim in evicted:
            logger.warning("evicted served model %r (LRU, registry over the %d-model cap)",
                           victim, self._max_models)

    def _lookup_model(self, name: str) -> Optional[_ServedModel]:
        """The registry, then a lazy durable restore of a daemon-built
        index: the served-model twin of :meth:`_lookup_job` (one restore
        at a time, race-safe publication, a raced drop honoured)."""
        with self._models_lock:
            served = self._models.get(name)
        if served is not None or self._state_dir is None:
            return served
        with self._restore_lock:
            with self._models_lock:
                served = self._models.get(name)
            if served is not None:
                return served
            restored = self._restore_model(name)
        if restored is None:
            return None
        evicted: list = []
        with self._models_lock:
            current = self._models.get(name)
            if current is None:
                self._models[name] = restored
                current = restored
                evicted = self._enforce_model_cap_locked(keep=name)
        self._log_lru_evictions(evicted)
        if current is restored and not os.path.exists(self._model_state_path(name)):
            # A drop_model raced the restore and discarded the snapshot.
            with self._models_lock:
                if self._models.get(name) is restored:
                    del self._models[name]
            return None
        return current

    def _require_model(self, name: str, hint: str = "ensure_model first") -> _ServedModel:
        served = self._lookup_model(name)
        if served is None:
            raise KeyError(f"no such model {name!r}; {hint}")
        return served

    @staticmethod
    def _version_fence(req: Dict[str, Any], name: str, served) -> Dict[str, Any]:
        """The fleet's version pin (docs/protocol.md "Fleet & versioned
        serving"): a request carrying ``version`` against a versioned
        registration of another version is refused under
        ``serve_version_strict`` (the replica missed a rollout, or the
        router's table is stale), else answered with a warning. Returns the
        ack's echo: the registration's ``version`` and the request's
        ``fleet_epoch``."""
        want = req.get("version")
        if want is not None and served.version is not None and int(want) != served.version:
            msg = (f"version mismatch on model {name!r}: request expects v{int(want)}, this "
                   f"replica serves v{served.version} — a missed rollout or a stale routing "
                   "table")
            if bool(config.peek("serve_version_strict")):
                raise ValueError(msg)
            logger.warning("%s (serve_version_strict off: answering)", msg)
        echo: Dict[str, Any] = {}
        if served.version is not None:
            echo["version"] = served.version
        if req.get("fleet_epoch") is not None:
            echo["fleet_epoch"] = int(req["fleet_epoch"])
        return echo

    def _op_transform(self, conn, req: Dict[str, Any]) -> None:
        """Run a registered model over one batch (one Arrow payload, or raw
        ``arrays`` frames with ``x``); the role-keyed output arrays stream
        back as raw frames, the ack echoing the version pin."""
        if req.get("arrays"):
            x = _recv_raw_matrix(conn, req, "transform")
        else:
            x, _ = _recv_arrow_matrix(conn, "transform", _opt(req, "input_col", "features"),
                                      req.get("n_cols"))
        name = str(req["model"])
        served = self._require_model(name)
        echo = self._version_fence(req, name, served)
        outs = self._serve_dispatch(conn, req, "transform", name, served, x)
        if outs is None:
            return  # shed with busy; the client retries
        _send_arrays_counted(conn, "transform", outs,
                             {"ok": True, "rows": int(x.shape[0]), **echo})

    def _op_kneighbors(self, conn, req: Dict[str, Any]) -> None:
        """Query a daemon-built index: the query batch in (one Arrow payload,
        or raw ``arrays`` frames with ``x``), the (q, k) float64 distances
        and int64 global row ids back."""
        if req.get("arrays"):
            q = _recv_raw_matrix(conn, req, "kneighbors")
        else:
            q, _ = _recv_arrow_matrix(conn, "kneighbors", _opt(req, "input_col", "features"),
                                      req.get("n_cols"))
        name = str(req["model"])
        served = self._require_model(
            name, "a daemon-built index this old was evicted; refit the estimator (a durable "
                  "daemon's snapshot of it outlives the eviction by 8x the TTL)")
        echo = self._version_fence(req, name, served)
        # k resolved first, so a request that omits k batches with one that
        # names the fitted k.
        res = self._serve_dispatch(conn, req, "kneighbors", name, served, q,
                                   k=_resolve_k(served, req.get("k")))
        if res is None:
            return  # shed with busy; the client retries
        dists, idx = res
        _send_arrays_counted(conn, "kneighbors",
                             {"distances": np.asarray(dists, np.float64),
                              "indices": np.asarray(idx, np.int64)},
                             {"ok": True, "rows": int(q.shape[0]), **echo})
