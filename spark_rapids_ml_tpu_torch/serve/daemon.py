"""The data-plane daemon: the executor-to-card feeding path, PCA job.

The port of ``spark_rapids_ml_tpu/serve/daemon.py``, cut to its PCA job and
PCA serving. A TCP server next to the card accepts row batches from Spark
tasks (Arrow IPC ``feed``, or raw little-endian ``feed_raw`` frames where
no Arrow library is at hand), folds each batch into the device-resident
(count, Σx, XᵀX) state of its job, and at ``finalize`` runs the PCA
eigensolve and sends the model back — the reference's executors-fold,
Spark-driver-finalizes design, with the fold next to the accelerator.

Threading: one acceptor thread and one thread per connection (Spark task).
Concurrent feeds to one job serialize on the job's lock around the fold;
the fold is an associative add, so arrival order does not matter. Every
device section (fold, stage creation, commit add, finalize, transform)
also takes the process-wide ``_DEVICE_LOCK``, always innermost — after any
job or model lock, never before one — so the lock order stays acyclic.

Exactly-once under Spark task retry: a feed may carry ``partition`` and
``attempt``. Partitioned feeds fold into a stage of their own per
(partition, attempt); ``commit`` adds the stage into the job state. The
first attempt of a partition to commit wins; the others' stages are freed,
and feeds or commits for an already-committed partition are acknowledged
without folding. A client that lost an ack resends the op with the same
``feed_id``, which folds at most once per stage (per job for direct
feeds).

Operations: jobs idle longer than ``ttl`` are evicted by a reaper thread
(``clock`` is injectable); an optional shared ``token`` is checked in
constant time on every op; past a connection or staged-bytes watermark,
ops that add load are shed with ``busy`` and a ``retry_after_s`` hint.

Left for later slices of the port: the other estimators' jobs (linreg,
kmeans, logreg, rf, knn) and their ``seed``/``step``/iterate ops, durable
job state, the serving scheduler and AOT warmup, cross-daemon merges,
gossip, and the health/metrics/telemetry ops. Any such op is answered
"unknown op" with its payload drained, and a feed naming another ``algo``
is refused before a job is registered.
"""

from __future__ import annotations

import hmac
import math
import socket
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models.pca import PCAModel, finalize_pca_stats
from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
from spark_rapids_ml_tpu_torch.parallel.sharding import as_tensor, resolve_device
from spark_rapids_ml_tpu_torch.serve import protocol
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

logger = get_logger("serve.daemon")

#: Ops whose request JSON is followed by one Arrow IPC payload frame
#: (docs/protocol.md). A rejection drains that frame so the framing stays
#: aligned; ``seed`` and ``kneighbors`` are reference ops the port answers
#: "unknown op".
_PAYLOAD_OPS = ("feed", "seed", "transform", "kneighbors")

#: Ops whose raw array frames follow the request per its ``arrays`` spec.
_ARRAY_OPS = ("ensure_model", "merge_state", "set_iterate", "feed_raw", "finalize")

#: Ops shed with `busy` + retry_after_s over a watermark: the ones that
#: ADD load. Pressure-relieving ops (commit, finalize, drop) and O(1)
#: control ops always pass.
_SHEDDABLE_OPS = ("feed", "feed_raw", "transform", "ensure_model")

#: Process-wide device lock (see the module docstring): taken innermost.
_DEVICE_LOCK = threading.Lock()

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
    out: Dict[str, np.ndarray] = {}
    with trace_span("daemon frame decode"):
        for spec, frame in zip(specs, frames):
            arr = np.frombuffer(frame, dtype=np.dtype(spec["dtype"]))
            out[str(spec["name"])] = arr.reshape(spec["shape"]).copy()
    return out


def _recv_arrow_matrix(conn, op: str, input_col: str, n_cols) -> np.ndarray:
    """One Arrow IPC payload frame -> the (n, d) matrix of ``input_col``.
    The frame is read BEFORE pyarrow is imported, so a daemon without
    pyarrow (the GPU image) answers the error with the framing aligned."""
    with trace_span("daemon frame receive"):
        payload = protocol.recv_frame(conn)
    if payload is None:
        raise protocol.ProtocolError(f"connection closed before {op} payload")
    import pyarrow as pa

    from spark_rapids_ml_tpu_torch.bridge.arrow import table_column_to_matrix

    with trace_span("daemon frame decode"):
        with pa.ipc.open_stream(payload) as reader:
            table = reader.read_all()
        return table_column_to_matrix(table, input_col, n_cols)


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


def _fold(state, x: np.ndarray, device: torch.device) -> None:
    """Fold one batch into ``state`` in place (call under _DEVICE_LOCK).

    One seeded ``kernels.gram_colsum`` launch per batch through
    ``streaming_update_rows``: the tensor-core route for bf16 compute with
    d % 8 == 0 on the card, the plain version on a CPU tensor. The
    reference pads each batch to a power-of-two bucket under a row mask,
    which only bounds XLA's compiles; the mask is a prefix of ones, so
    ``n_valid = n`` over the unpadded batch gives the same statistics.
    (On a TPU the reference's masked update reaches ``gram_pallas``; the
    port folds through ``gram_colsum``, as its ``fit_pca_stream`` does.)"""
    with trace_span("daemon host to device"):
        xd = as_tensor(x).to(device)
    with trace_span("daemon fold"):
        gram_ops.streaming_update_rows(state, xd, n_valid=x.shape[0])


def _state_nbytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state)


class _Job:
    """One PCA accumulation job: the device state, its stages, a lock."""

    algo = "pca"

    def __init__(self, n_cols: int, device: torch.device, clock=time.monotonic):
        # Capacity gate at creation: a (d, d) accumulator over the device
        # budget is a clean first-feed error, never a device OOM mid-pass.
        gram_ops.require_gram_capacity(n_cols)
        self._clock = clock
        self.n_cols = n_cols
        self.device = device
        self.lock = threading.Lock()
        self.rows = 0
        # Single-pass: the job is always on pass 0, and every row is the
        # pass's (the wire's "pass_rows" is `rows`).
        self.iteration = 0
        self.dropped = False
        self.touched = clock()
        self.staged: Dict[tuple, _Stage] = {}
        self.committed: Dict[int, int] = {}
        self.staged_bytes = 0
        self._seen_feed_ids = _FifoSet()
        with _DEVICE_LOCK:
            self.state = gram_ops.init_stats(n_cols, device=device)

    def _check_pass(self, pass_id: Optional[int]) -> None:
        """Reject traffic of another pass (a zombie task of an iterative
        fit, or a daemon that never saw the earlier passes)."""
        if pass_id is not None and int(pass_id) != self.iteration:
            raise ValueError(
                f"stale pass_id {pass_id} (job is on pass {self.iteration}); "
                "feed rejected"
            )

    def _is_replay(self, feed_id: Optional[str], stage: Optional[_Stage]) -> bool:
        """True when this feed_id already folded (call under the lock).
        Read-only: the id is recorded only after the fold succeeded."""
        if feed_id is None:
            return False
        feed_id = str(feed_id)
        return feed_id in (stage.seen if stage is not None else self._seen_feed_ids)

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

    def fold(
        self,
        x: np.ndarray,
        partition: Optional[int] = None,
        attempt: int = 0,
        pass_id: Optional[int] = None,
        feed_id: Optional[str] = None,
    ) -> None:
        if x.shape[1] != self.n_cols:
            raise ValueError(f"batch width {x.shape[1]} != job n_cols {self.n_cols}")
        n = x.shape[0]
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped; rows not accepted")
            self._check_pass(pass_id)
            self.touched = self._clock()
            if partition is not None and partition in self.committed:
                return  # duplicate of a committed task (retry/speculation)
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
                        zero = gram_ops.init_stats(self.n_cols, device=self.device)
                    # Registered only after the fold succeeds: a phantom
                    # empty stage would inflate staged_bytes and let a
                    # commit of this attempt succeed with 0 rows.
                    stage = _Stage(zero, _state_nbytes(zero))
                    fresh_stage = True
                if self._is_replay(feed_id, stage):
                    return
                state = stage.state
            with _DEVICE_LOCK:
                _fold(state, x, self.device)
            if partition is None:
                self.rows += n
            else:
                stage.rows += n
                if fresh_stage:
                    self.staged[(partition, attempt)] = stage
                    self.staged_bytes += stage.nbytes
            # Burned only now: an id recorded before a failing fold would
            # turn the client's replay into an ack without a fold.
            self._mark_folded(feed_id, stage)
            self.touched = self._clock()  # exit stamp: the fold may be slow

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
                return self.rows
            staged = self._drop_stage((partition, attempt))
            if staged is None:
                raise ValueError(
                    f"commit for partition {partition} attempt {attempt} "
                    "with no staged feed"
                )
            # Every state is additive (count, Σx, XᵀX): the merge of the
            # reference (an elementwise add) done in place.
            with _DEVICE_LOCK, trace_span("daemon commit"):
                for acc, part in zip(self.state, staged.state):
                    acc.add_(part)
            self.committed[partition] = staged.rows
            self.rows += staged.rows
            # the losing attempts' stages of this partition free their buffers
            for key in [k for k in self.staged if k[0] == partition]:
                self._drop_stage(key)
            self.touched = self._clock()
            return self.rows

    def export_state(self):
        """The COMMITTED state as raw arrays (s0, s1, s2 = count, Σx, XᵀX,
        the reference's tree order) and its accounting meta. Read-only."""
        with self.lock:
            if self.dropped:
                raise KeyError("job was finalized/dropped")
            self.touched = self._clock()
            with _DEVICE_LOCK:
                arrays = {f"s{i}": t.cpu().numpy() for i, t in enumerate(self.state)}
            meta = {
                "rows": self.rows,
                "pass_rows": self.rows,
                "iteration": self.iteration,
                "algo": self.algo,
                "n_cols": self.n_cols,
                "committed": {str(p): n for p, n in self.committed.items()},
            }
            self.touched = self._clock()
            return arrays, meta

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


class _ServedModel:
    """A registered PCA model serving ``transform``: its components stay
    resident on the daemon's device across batches and connections."""

    algo = "pca"

    def __init__(self, arrays: Dict[str, np.ndarray], params: Dict[str, Any],
                 device: torch.device, clock=time.monotonic):
        self._clock = clock
        self.model = PCAModel._from_model_data("served", arrays)
        self.model._device = device
        # Params configure serving; unknown names are ignored so client and
        # daemon can skew.
        known = {k: v for k, v in (params or {}).items() if self.model.hasParam(k)}
        if known:
            self.model._set(**known)
        self.lock = threading.Lock()
        self.touched = clock()

    def transform(self, x) -> Dict[str, Any]:
        with self.lock:
            self.touched = self._clock()
            with _DEVICE_LOCK:
                return self.model.transform_matrix(x)


class DataPlaneDaemon:
    """Arrow/raw-frames-over-TCP accumulation server next to the card.

    ``device``: where jobs fold and models serve; None means the card, and
    ``start()`` raises without one. Binds loopback by default; on a cluster,
    bind the host's NIC and keep the port reachable from executors only.
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
        self._active_conns = 0
        self._conn_socks: set = set()
        self._conn_threads: set = set()
        self._conns_lock = threading.Lock()
        # Self-reported identity (address spellings alias) and the per-boot
        # incarnation id stamped on every state ack.
        self.instance_id = uuid.uuid4().hex[:12]
        self.boot_id = uuid.uuid4().hex[:12]
        self._jobs: Dict[str, _Job] = {}
        self._jobs_lock = threading.Lock()
        self._models: Dict[str, _ServedModel] = {}
        self._models_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._reaper_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DataPlaneDaemon":
        self._device = resolve_device(self._device_arg)  # raises without a card
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        self._sock = s
        self._port = s.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="srml-dataplane-accept", daemon=True
        )
        self._accept_thread.start()
        if self._ttl is not None:
            self._reaper_thread = threading.Thread(
                target=self._reap_loop, name="srml-dataplane-reaper", daemon=True
            )
            self._reaper_thread.start()
        logger.info("data-plane daemon listening on %s:%d (%s)", self._host,
                    self._port, self._device)
        return self

    @property
    def address(self):
        return self._host, self._port

    def stop(self) -> None:
        self._stop.set()
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

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _identity(self) -> Dict[str, str]:
        """The ack stamp: instance id and per-boot incarnation id."""
        return {"id": self.instance_id, "boot_id": self.boot_id}

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
        device buffers forever."""
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
                        job.dropped = True
                        del self._jobs[name]
                        evicted.append((name, job))
                finally:
                    job.lock.release()
        for name, job in evicted:
            logger.warning("evicted idle job %r (%.1fs > ttl %.1fs, %d rows fed)",
                           name, now - job.touched, self._ttl, job.rows)
        with self._models_lock:
            stale = [n for n, m in self._models.items() if now - m.touched > self._ttl]
            for n in stale:
                del self._models[n]
        for n in stale:
            logger.warning("evicted idle served model %r", n)

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
            self._serve_conn_inner(conn)
        except OSError:
            pass  # transport failure: the connection is simply gone
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
                try:
                    self._dispatch(conn, req)
                except (ConnectionError, TimeoutError):
                    # The CONNECTION broke, not the request: close it rather
                    # than answer on a dead or desynced wire. (PermissionError,
                    # the auth rejection, is an OSError answered below.)
                    return
                except Exception as e:  # answer the caller, keep serving
                    logger.exception("request failed: %s", req.get("op"))
                    try:
                        protocol.send_json(conn, {"ok": False, "error": str(e)})
                    except OSError:
                        return

    def _dispatch(self, conn, req: Dict[str, Any]) -> None:
        op = req.get("op")

        def _drain_payload():
            # Payload-carrying ops already have their frames in flight when
            # the JSON header is rejected: read them to keep the framing.
            if op in _PAYLOAD_OPS:
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
        if op in _SHEDDABLE_OPS:
            reason = self._overloaded()
            if reason is not None:
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
        elif op == "commit":
            job = self._get_job(req)
            rows = job.commit(int(req["partition"]), int(_opt(req, "attempt", 0)),
                              req.get("pass_id"))
            protocol.send_json(conn, {"ok": True, "rows": rows, **self._identity()})
        elif op == "finalize":
            self._op_finalize(conn, req)
        elif op == "status":
            job = self._get_job(req)
            protocol.send_json(conn, {"ok": True, "rows": job.rows, "algo": job.algo,
                                      "n_cols": job.n_cols})
        elif op == "drop":
            protocol.send_json(conn, {"ok": True, "dropped": self._drop_job(str(req.get("job")))})
        elif op == "export_state":
            arrays, meta = self._get_job(req).export_state()
            protocol.send_arrays(conn, arrays, {"ok": True, **meta})
        elif op == "ensure_model":
            self._op_ensure_model(conn, req)
        elif op == "transform":
            self._op_transform(conn, req)
        elif op == "model_status":
            with self._models_lock:
                m = self._models.get(str(req.get("model")))
            protocol.send_json(conn, {"ok": True, "exists": m is not None,
                                      "algo": None if m is None else m.algo})
        elif op == "drop_model":
            with self._models_lock:
                m = self._models.pop(str(req.get("model")), None)
            protocol.send_json(conn, {"ok": True, "dropped": m is not None})
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

    def _overloaded(self) -> Optional[str]:
        """The watermark breach, or None. A load signal, read without job
        locks."""
        if self._max_connections is not None:
            with self._conns_lock:
                n = self._active_conns
            if n > self._max_connections:
                return (f"{n} concurrent connections exceed the watermark "
                        f"({self._max_connections})")
        if self._max_staged_bytes is not None:
            staged = self._staged_bytes_total()
            if staged > self._max_staged_bytes:
                return (f"{staged} staged bytes exceed the watermark "
                        f"({self._max_staged_bytes}); commit or drop stages")
        return None

    # -- jobs --------------------------------------------------------------

    def _get_job(self, req) -> _Job:
        name = str(req.get("job"))
        with self._jobs_lock:
            job = self._jobs.get(name)
        if job is None:
            raise KeyError(f"no such job {name!r}")
        return job

    def _drop_job(self, name: str) -> bool:
        with self._jobs_lock:
            job = self._jobs.pop(name, None)
        if job is not None:
            with job.lock:
                job.dropped = True
        return job is not None

    def _op_feed(self, conn, req: Dict[str, Any]) -> None:
        x = _recv_arrow_matrix(conn, "feed", _opt(req, "input_col", "features"),
                               req.get("n_cols"))
        self._feed_validated(conn, req, x)

    def _op_feed_raw(self, conn, req: Dict[str, Any]) -> None:
        """`feed` with raw little-endian C-contiguous buffers instead of
        Arrow IPC: array `x` (n, d) float32/float64 (`y` only for the
        labelled algos, which this port's daemon does not serve yet)."""
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
        self._feed_validated(conn, req, x)

    def _feed_validated(self, conn, req: Dict[str, Any], x: np.ndarray) -> None:
        """Shared feed tail: validate BEFORE registering a job, so a
        rejected first feed leaves no orphan job (with its d × d buffers)
        under the name."""
        name = str(req["job"])
        algo = str(_opt(req, "algo", "pca"))
        if algo != "pca":
            raise ValueError(
                f"algo {algo!r} is not in the port's daemon yet (it serves 'pca' only)"
            )
        with self._jobs_lock:
            job = self._jobs.get(name)
        part = req.get("partition")
        for retry in (False, True):
            created = False
            if job is None:
                with self._jobs_lock:
                    job = self._jobs.get(name)
                    created = job is None
                    if created:
                        job = _Job(x.shape[1], self._device, clock=self._clock)
                        self._jobs[name] = job
            try:
                job.fold(
                    x,
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
        # Optional raw array frames (the reference's sharded KNN build):
        # drained FIRST so any rejection leaves the framing aligned.
        if req.get("arrays"):
            _recv_arrays_aligned(conn, req)
        job = self._get_job(req)
        drop = bool(_opt(req, "drop", True))
        arrays = job.finalize(_opt(req, "params", {}), drop=drop)
        # Unregister BEFORE sending: a client that disconnects mid-response
        # must not leave the name poisoned (dropped) in the registry.
        if drop:
            with self._jobs_lock:
                if self._jobs.get(str(req.get("job"))) is job:
                    del self._jobs[str(req.get("job"))]
        protocol.send_arrays(conn, arrays, {"ok": True, "rows": job.rows,
                                            "pass_rows": job.rows, **self._identity()})

    # -- serving -----------------------------------------------------------

    def _op_ensure_model(self, conn, req: Dict[str, Any]) -> None:
        """Register a fitted model for serving (idempotent; the first caller
        wins). Raw array frames follow the JSON per its ``arrays`` spec."""
        arrays = _recv_arrays_aligned(conn, req)
        name = str(req["model"])
        algo = str(req["algo"])
        if algo != "pca":
            raise ValueError(
                f"model algo {algo!r} is not in the port's daemon yet (it serves 'pca' only)"
            )
        evicted = []
        with self._models_lock:
            existing = self._models.get(name)
            if existing is None:
                self._models[name] = _ServedModel(arrays, _opt(req, "params", {}),
                                                  self._device, clock=self._clock)
                created = True
                evicted = self._enforce_model_cap_locked(keep=name)
            else:
                if existing.algo != algo:
                    raise ValueError(f"model {name!r} is algo {existing.algo!r}; "
                                     f"ensure_model requested {algo!r}")
                existing.touched = self._clock()
                created = False
        for victim in evicted:
            logger.warning("evicted served model %r (LRU, registry over the %d-model cap)",
                           victim, self._max_models)
        protocol.send_json(conn, {"ok": True, "created": created})

    def _enforce_model_cap_locked(self, keep: str) -> list:
        """LRU eviction past ``max_models`` (under ``_models_lock``, right
        after registering ``keep``). Returns the evicted names."""
        if self._max_models is None:
            return []
        evicted = []
        while len(self._models) > self._max_models:
            candidates = sorted((m.touched, n) for n, m in self._models.items() if n != keep)
            if not candidates:
                break
            victim = candidates[0][1]
            del self._models[victim]
            evicted.append(victim)
        return evicted

    def _lookup_model(self, name: str) -> _ServedModel:
        with self._models_lock:
            served = self._models.get(name)
        if served is None:
            raise KeyError(f"no such model {name!r}; ensure_model first")
        return served

    def _op_transform(self, conn, req: Dict[str, Any]) -> None:
        """Run a registered model over one Arrow batch; the role-keyed
        output arrays stream back as raw frames."""
        x = _recv_arrow_matrix(conn, "transform", _opt(req, "input_col", "features"),
                               req.get("n_cols"))
        outs = self._lookup_model(str(req["model"])).transform(x)
        protocol.send_arrays(conn, outs, {"ok": True, "rows": int(x.shape[0])})
