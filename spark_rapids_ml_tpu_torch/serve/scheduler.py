"""Serving scheduler: cross-connection micro-batching for the inference plane.

The port of ``spark_rapids_ml_tpu/serve/scheduler.py``. Without it every
``transform``/``kneighbors`` request runs alone on its connection thread,
and N concurrent callers cost N device dispatches under ``_DEVICE_LOCK``:
for exact kNN, N reads of the whole index. This per-daemon scheduler
COALESCES concurrent serving requests, across connections and per model,
into padded micro-batches before the one device dispatch.

Core pieces:

* **Admission control**: a bounded per-model queue. Overflow, and requests
  whose ``deadline_s`` the current backlog would already miss, are shed
  with :class:`SchedulerBusy`, which the daemon answers with the existing
  ``busy``/``retry_after_s`` contract; every client already retries.
* **Shape bucketing**: coalesced rows are padded up to a small fixed
  ladder of bucket sizes (config ``serve_batch_buckets``, env
  ``SRML_TORCH_SERVE_BATCH_BUCKETS``), so the shapes a served model sees
  are bounded by the ladder and counted. PyTorch runs eagerly, so a novel
  shape compiles nothing; its first dispatch is the first use of that
  shape by the caching allocator, cuBLAS's algorithm choice and the
  kernels' attributes, and ``srml_scheduler_compile_misses_total`` keeps
  its name for it. Padding is exact on every BATCHED path: transform and
  exact-kNN serving are row-wise, so a padded or co-batched row never
  reaches a real row's output. IVF/ANN ``kneighbors`` is the carve-out the
  daemon enforces: its capacity-bucketed candidate search shares per-list
  query slots across a batch (a padding or co-batched row can EVICT a real
  query's candidates), so those requests always dispatch solo
  (``srml_scheduler_bypass_total``).
* **Batching loop**: one dispatcher thread drains the queues. A batch goes
  to the device when its oldest request has waited
  ``serve_batch_window_ms`` or the coalesced rows reach the cap, dispatches
  ONCE under the model lock and ``_DEVICE_LOCK`` (through ``_ServedModel``),
  and scatters per-request row slices back to the waiting connection
  threads. The loop never holds its condition ``_cv`` across a dispatch.
* **Warmup**: :meth:`RequestScheduler.warmup` dispatches one zero batch at
  every reachable bucket of a served model (the ``warmup`` wire op), so the
  first real request of each bucket meets a warm allocator and library.

Batches only ever mix requests with identical (model, kind, k, dtype, row
width): anything else would change numerics or shapes. A request larger
than the coalescing cap bypasses the scheduler; it is a full dispatch of
its own.

Fault site ``daemon.scheduler`` (utils/faults.py): an injected fault at
admission becomes a shed, which the client heals through the busy retry.

Default: on (``serve_batching``; ``SRML_TORCH_SERVE_BATCHING=0`` opts
out), as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

logger = get_logger("serve.scheduler")

__all__ = ["RequestScheduler", "SchedulerBusy", "bucket_for", "parse_buckets"]

#: Scheduler telemetry: the JAX package's names and labels.
_M_QUEUE_DEPTH = metrics_mod.gauge(
    "srml_scheduler_queue_depth",
    "Queued serving requests, by model (refreshed at scrape)",
)
_M_BATCHES = metrics_mod.counter(
    "srml_scheduler_batches_total", "Micro-batches dispatched, by op"
)
_M_BATCHED_REQUESTS = metrics_mod.counter(
    "srml_scheduler_batched_requests_total",
    "Requests served through micro-batches, by op",
)
_M_BATCH_ROWS = metrics_mod.histogram(
    "srml_scheduler_batch_rows",
    "Real (unpadded) rows per dispatched micro-batch, by op — the "
    "occupancy distribution; mean occupancy = sum/count",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
)
_M_BATCH_SECONDS = metrics_mod.histogram(
    "srml_scheduler_batch_seconds", "Micro-batch device dispatch latency, by op"
)
_M_PADDED_ROWS = metrics_mod.counter(
    "srml_scheduler_padded_rows_total",
    "Padding rows added to reach the bucket size, by op (waste ratio = "
    "padded / (padded + batch_rows sum))",
)
_M_SHEDS = metrics_mod.counter(
    "srml_scheduler_sheds_total",
    "Requests shed at admission, by op and reason "
    "(queue_full|deadline|fault|stopping)",
)
_M_COMPILE_MISSES = metrics_mod.counter(
    "srml_scheduler_compile_misses_total",
    "First dispatches of a novel (op, k, dtype, width, bucket) shape on a "
    "served model, by op — eager PyTorch compiles nothing: a miss is the "
    "first use of the shape by the allocator, cuBLAS and the kernels' "
    "attributes; bounded by the bucket ladder",
)
_M_COMPILE_HITS = metrics_mod.counter(
    "srml_scheduler_compile_hits_total",
    "Dispatches that reused an already-seen batch shape, by op",
)
_M_BYPASS = metrics_mod.counter(
    "srml_scheduler_bypass_total",
    "Requests served solo, by op: larger than the coalescing cap "
    "(serve_max_batch_rows floored to a bucket, at most the top bucket), "
    "or an IVF/ANN kneighbors",
)

#: Fallback ladder when the config string fails to parse: the config
#: default, so a typo degrades to the documented behaviour.
_DEFAULT_BUCKETS = (64, 256, 1024, 4096)


class SchedulerBusy(RuntimeError):
    """Admission shed the request; the daemon answers the existing
    ``busy``/``retry_after_s`` contract and the client retries."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def parse_buckets(spec) -> Tuple[int, ...]:
    """``serve_batch_buckets`` value → ascending positive ints. Accepts a
    comma-separated string or any int iterable; falls back to the default
    ladder (with a warning) on garbage: a typo'd env var must degrade, not
    kill the daemon."""
    try:
        if isinstance(spec, str):
            vals = [int(p) for p in spec.replace(";", ",").split(",") if p.strip()]
        else:
            vals = [int(v) for v in spec]
        vals = sorted(set(vals))
        if not vals or vals[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {spec!r}")
        return tuple(vals)
    except (TypeError, ValueError) as e:
        logger.warning("bad serve_batch_buckets %r (%s); using default %s",
                       spec, e, _DEFAULT_BUCKETS)
        return _DEFAULT_BUCKETS


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """The smallest bucket of the ladder that holds ``n`` rows; the top
    bucket above it (the scheduler's coalescing never exceeds it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _Request:
    """One enqueued serving request: rows in, a slice of the batch out."""

    __slots__ = ("x", "rows", "event", "result", "error", "enq_t")

    def __init__(self, x: np.ndarray, enq_t: float):
        self.x = x
        self.rows = int(x.shape[0])
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.enq_t = enq_t


class RequestScheduler:
    """Cross-connection micro-batching for ``transform``/``kneighbors``.

    Thread model: connection threads :meth:`submit` and block on their
    request's event; ONE dispatcher thread owns every batched dispatch
    (batches of different models still go single file: the card is one
    resource, which ``_DEVICE_LOCK`` enforces anyway). The loop never holds
    the queue lock across a dispatch: queues keep filling while the device
    runs.
    """

    def __init__(
        self,
        window_ms: Optional[float] = None,
        max_batch_rows: Optional[int] = None,
        buckets=None,
        queue_depth: Optional[int] = None,
        retry_after_s: float = 1.0,
    ):
        from spark_rapids_ml_tpu_torch import config

        self._window_s = float(
            config.get("serve_batch_window_ms") if window_ms is None else window_ms
        ) / 1000.0
        self._max_rows = int(
            config.get("serve_max_batch_rows") if max_batch_rows is None else max_batch_rows
        )
        self._buckets = parse_buckets(
            config.get("serve_batch_buckets") if buckets is None else buckets
        )
        self._queue_depth = int(
            config.get("serve_queue_depth") if queue_depth is None else queue_depth
        )
        self._retry_after_s = float(retry_after_s)
        # Coalescing cap: a batch must fit the top bucket AND the row cap,
        # floored to a bucket boundary (a batch coalesced past one would pad
        # UP to the next bucket, dispatching more rows than the operator's
        # cap, at a shape warmup never saw). A cap below the smallest bucket
        # stands as it is: those batches pad to the smallest bucket.
        cap = min(self._max_rows, self._buckets[-1])
        for b in reversed(self._buckets):
            if b <= cap:
                cap = b
                break
        self._cap_rows = cap
        self._cv = threading.Condition()
        #: (model, kind, k, dtype, width, id(served)) → deque[_Request]. The
        #: full key guards numerics: mixing dtypes would promote, mixing k
        #: would change output widths, and id(served) pins the batch to ONE
        #: registered model instance across a racing drop and re-register.
        self._queues: Dict[tuple, deque] = {}
        #: served instance per key (the dispatch target).
        self._served: Dict[tuple, Any] = {}
        #: model name → queued request count (the admission bound).
        self._depth: Dict[str, int] = {}
        #: model name → queued rows (the deadline estimator's backlog).
        self._qrows: Dict[str, int] = {}
        #: queue key → queued rows, so the due scan is O(#keys).
        self._krows: Dict[tuple, int] = {}
        #: model names the queue-depth gauge was last refreshed with (pruned
        #: names get a final 0).
        self._gauged: set = set()
        #: EWMA of batch dispatch seconds (deadline admission input).
        self._ewma_s = 0.0
        self._batches = 0
        self._stopping = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RequestScheduler":
        self._thread = threading.Thread(target=self._loop, name="srml-serve-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Fail every pending request and stop the loop: a stopping daemon
        must unblock its connection threads, not strand them."""
        with self._cv:
            self._stopping = True
            pending = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._served.clear()
            self._depth.clear()
            self._qrows.clear()
            self._krows.clear()
            self._cv.notify_all()
        for r in pending:
            r.error = SchedulerBusy("scheduler stopping", self._retry_after_s)
            r.event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- admission + submit ------------------------------------------------

    def eligible(self, n_rows: int) -> bool:
        """Whether a request of this size belongs in a micro-batch: one
        larger than the coalescing cap is a full dispatch on its own."""
        return 0 < n_rows <= self._cap_rows

    def submit(self, model: str, served, kind: str, x: np.ndarray, k: Optional[int] = None,
               deadline_s: Optional[float] = None):
        """Enqueue one request and block until its batch dispatched.

        Returns the request's slice of the batch result: the role-keyed
        output dict for ``transform``, a ``(distances, indices)`` pair for
        ``kneighbors``. Raises :class:`SchedulerBusy` when admission sheds
        it, or the dispatch's exception as it was raised.
        """
        x = np.ascontiguousarray(x)
        key = (model, kind, k, str(x.dtype), int(x.shape[1]), id(served))
        # The chaos hook, before the lock (a latency rule must not stall
        # every other submitter): an injected fault becomes a shed, so the
        # client walks the ordinary busy-retry path.
        try:
            faults.checkpoint("daemon.scheduler")
        except (ConnectionError, OSError) as e:
            _M_SHEDS.inc(op=kind, reason="fault")
            raise SchedulerBusy(f"scheduler shed (injected fault: {e})",
                                self._retry_after_s) from e
        with self._cv:
            if self._stopping:
                _M_SHEDS.inc(op=kind, reason="stopping")
                raise SchedulerBusy("scheduler stopping", self._retry_after_s)
            depth = self._depth.get(model, 0)
            if depth >= self._queue_depth:
                _M_SHEDS.inc(op=kind, reason="queue_full")
                raise SchedulerBusy(
                    f"{depth} requests queued for model {model!r} (cap {self._queue_depth})",
                    self._retry_after_s,
                )
            if deadline_s is not None and self._ewma_s > 0.0:
                # The batches ahead of us plus our own, each ~EWMA seconds: a
                # request that would expire IN the queue is shed now.
                backlog = self._qrows.get(model, 0) / max(self._cap_rows, 1)
                est = self._ewma_s * (1.0 + backlog)
                if est > float(deadline_s):
                    _M_SHEDS.inc(op=kind, reason="deadline")
                    raise SchedulerBusy(
                        f"estimated wait {est:.3f}s exceeds the request deadline "
                        f"{float(deadline_s):.3f}s",
                        self._retry_after_s,
                    )
            req = _Request(x, time.monotonic())
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            self._served[key] = served
            q.append(req)
            self._depth[model] = depth + 1
            self._qrows[model] = self._qrows.get(model, 0) + req.rows
            self._krows[key] = self._krows.get(key, 0) + req.rows
            self._cv.notify_all()
        # Block outside the lock. The liveness check is a backstop for a
        # dead loop thread (a bug, not a load condition): a request must
        # never hang its connection for ever.
        while not req.event.wait(timeout=1.0):
            if self._thread is None or not self._thread.is_alive():
                raise RuntimeError("serving scheduler dispatcher died with requests in flight")
        if req.error is not None:
            raise req.error
        return req.result

    def note_bypass(self, kind: str) -> None:
        """Count a request the daemon served solo (the scheduler never saw
        its rows)."""
        _M_BYPASS.inc(op=kind)

    # -- warmup ------------------------------------------------------------

    def reachable_buckets(self) -> list:
        """Every bucket some coalesced batch can map to, up to
        ``_bucket_for(cap)`` (which covers a cap below the smallest bucket).
        Buckets above the cap never hold a coalesced batch, so warming them
        is dead weight."""
        top = self._bucket_for(self._cap_rows)
        return [b for b in self._buckets if b <= top]

    def premark_shapes(self, served, shape_keys) -> None:
        """Mark shapes as seen in the served instance's shape ledger, under
        the scheduler's lock (``_dispatch`` reads and adds to the same set
        under ``_cv``)."""
        with self._cv:
            ledger = getattr(served, "_sched_seen", None)
            if ledger is None:
                ledger = set()
                served._sched_seen = ledger
            ledger.update(shape_keys)

    def warmup(self, model: str, served, n_cols: int, kind: str = "transform",
               k: Optional[int] = None, dtype: str = "float32") -> Dict[str, Any]:
        """Dispatch a full zero batch at every reachable bucket through the
        batched path, so each bucket's first real batch finds its shape
        seen. Returns ``{"buckets", "compiled"}``: ``compiled`` counts the
        shapes this call saw for the first time."""
        ladder = self.reachable_buckets()
        compiled = 0
        for bucket in ladder:
            x = np.zeros((bucket, int(n_cols)), dtype=np.dtype(dtype))
            key = (model, kind, k, str(x.dtype), int(n_cols), id(served))
            req = _Request(x, time.monotonic())
            if self._dispatch(key, [req], served, record=False):
                compiled += 1
            if req.error is not None:
                raise req.error
        return {"buckets": ladder, "compiled": compiled}

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``health`` op's scheduler block (and the gauge refresher):
        the config, live queue depths (models with queued work only) and
        dispatch totals."""
        with self._cv:
            models = dict(self._depth)
            batches = self._batches
            # A model seen at the last scrape but pruned since reads 0, not
            # its final queued value; under the lock, since health and
            # metrics snapshot from concurrent connection threads.
            for m in self._gauged - set(models):
                _M_QUEUE_DEPTH.set(0, model=m)
            self._gauged = set(models)
            for m, d in models.items():
                _M_QUEUE_DEPTH.set(d, model=m)
        return {
            "enabled": True,
            "window_ms": self._window_s * 1000.0,
            "max_batch_rows": self._max_rows,
            "buckets": list(self._buckets),
            "queue_depth_cap": self._queue_depth,
            "queued": sum(models.values()),
            "models": models,
            "batches": batches,
        }

    # -- batching loop -----------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        return bucket_for(n, self._buckets)

    def _loop(self) -> None:
        while True:
            with self._cv:
                key = self._next_due_locked()
                while key is None:
                    if self._stopping:
                        return
                    self._cv.wait(timeout=self._wait_s_locked())
                    key = self._next_due_locked()
                batch, served = self._pop_batch_locked(key)
            if batch:
                self._dispatch(key, batch, served)
            # Loop locals must not pin the served model (or the payloads)
            # across the next idle wait.
            batch = served = None

    def _wait_s_locked(self) -> Optional[float]:
        """Sleep until the oldest pending request's window expires (None:
        nothing pending, wait for a submit's notify)."""
        oldest = None
        for q in self._queues.values():
            if q and (oldest is None or q[0].enq_t < oldest):
                oldest = q[0].enq_t
        if oldest is None:
            return None
        return max(oldest + self._window_s - time.monotonic(), 0.001)

    def _next_due_locked(self) -> Optional[tuple]:
        """The dispatchable key whose head request is oldest: due when the
        window elapsed or the coalesced rows already fill a batch."""
        now = time.monotonic()
        due, due_t = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            rows = self._krows.get(key, 0)
            if now - q[0].enq_t >= self._window_s or rows >= self._cap_rows:
                if due_t is None or q[0].enq_t < due_t:
                    due, due_t = key, q[0].enq_t
        return due

    def _pop_batch_locked(self, key: tuple):
        q = self._queues.get(key)
        if not q:
            return [], None
        model = key[0]
        batch = [q.popleft()]
        total = batch[0].rows
        while q and total + q[0].rows <= self._cap_rows:
            r = q.popleft()
            batch.append(r)
            total += r.rows
        served = self._served.get(key)
        if not q:
            # Drop the drained queue AND its served-model reference: the
            # scheduler must never pin a dropped or evicted model (a
            # daemon-built index is dataset-sized) past its last request.
            del self._queues[key]
            self._served.pop(key, None)
            self._krows.pop(key, None)
        else:
            self._krows[key] = self._krows.get(key, 0) - total
        # Prune zeroed accounting entries, so the per-model dicts (and the
        # health "models" map) do not grow one dead key per model name.
        if self._depth.get(model, 0) - len(batch) <= 0:
            self._depth.pop(model, None)
            self._qrows.pop(model, None)
        else:
            self._depth[model] -= len(batch)
            self._qrows[model] = self._qrows.get(model, 0) - total
        return batch, served

    def _dispatch(self, key: tuple, batch, served, record: bool = True) -> bool:
        """Pad the coalesced rows to the bucket, run ONE dispatch through
        the served model (its lock, then ``_DEVICE_LOCK``), scatter the
        per-request slices, wake the waiters. Never raises: a failure lands
        on every request of the batch. Returns whether the batch shape was
        novel. The shape ledger, the EWMA and the batch count change only
        under ``_cv``: warmup runs this on a connection thread while the
        loop runs."""
        kind, k, dtype, width = key[1], key[2], key[3], key[4]
        total = sum(r.rows for r in batch)
        bucket = self._bucket_for(total)
        shape_key = (kind, k, dtype, width, bucket)
        with self._cv:
            # The ledger lives ON the served instance: it dies with the
            # model, and a re-registration under an old name counts misses.
            ledger = getattr(served, "_sched_seen", None)
            if ledger is None:
                ledger = set()
                served._sched_seen = ledger
            fresh = shape_key not in ledger
            if fresh:
                ledger.add(shape_key)
        if fresh:
            _M_COMPILE_MISSES.inc(op=kind)
        else:
            _M_COMPILE_HITS.inc(op=kind)
        xb = np.zeros((bucket, width), dtype=np.dtype(dtype))
        offsets = []
        off = 0
        for r in batch:
            xb[off:off + r.rows] = r.x
            offsets.append(off)
            off += r.rows
        t0 = time.perf_counter()
        try:
            with trace_span(f"scheduler {kind}"):
                if kind == "transform":
                    outs = served.transform(xb)
                    for r, o in zip(batch, offsets):
                        r.result = {name: np.asarray(v)[o:o + r.rows]
                                    for name, v in outs.items()}
                elif kind == "kneighbors":
                    dists, idx = served.kneighbors(xb, k)
                    dists, idx = np.asarray(dists), np.asarray(idx)
                    for r, o in zip(batch, offsets):
                        r.result = (dists[o:o + r.rows], idx[o:o + r.rows])
                else:  # pragma: no cover - submit() enqueues only these
                    raise ValueError(f"unknown scheduler kind {kind!r}")
        except BaseException as e:  # noqa: BLE001 - every waiter must wake
            for r in batch:
                r.error = e
        finally:
            dt = time.perf_counter() - t0
            with self._cv:
                # Fresh shapes are left out of the deadline estimator: a
                # first dispatch carries one-time costs, and an estimate
                # poisoned by them would shed every deadline request (the
                # EWMA moves only on a dispatch, so it could never decay).
                if not fresh:
                    self._ewma_s = dt if self._ewma_s == 0.0 else 0.8 * self._ewma_s + 0.2 * dt
                if record:
                    self._batches += 1
            if record:
                _M_BATCHES.inc(op=kind)
                _M_BATCHED_REQUESTS.inc(len(batch), op=kind)
                _M_BATCH_ROWS.observe(total, op=kind)
                _M_PADDED_ROWS.inc(bucket - total, op=kind)
                _M_BATCH_SECONDS.observe(dt, op=kind)
            for r in batch:
                r.event.set()
        return fresh
