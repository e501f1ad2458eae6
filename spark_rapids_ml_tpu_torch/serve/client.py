"""Client side of the data-plane protocol — what a Spark task runs.

The port of ``spark_rapids_ml_tpu/serve/client.py``, cut to the ops the
port's daemon serves. A task opens one connection, feeds its partition as
one or more frames (Arrow IPC ``feed``, or raw ``feed_raw`` without an
Arrow library), commits, and closes; the Spark driver (or any one caller)
finalizes, and for an iterative job (kmeans, logreg, rf) runs the passes:
``seed_kmeans`` (a forest's creating ``set_iterate``), then per pass the
scan and ``step``, with
``get_iterate``/``set_iterate`` for its recovery ledger and its peer
daemons. A fit across daemons folds each peer's partials into the primary
with ``export_state`` + ``merge_state`` (the hub) or one ``reduce_mesh``
(peers in the primary's process, after ``mesh_info``). A knn job's
``finalize_knn`` builds and registers its index on the daemon, which then
answers ``kneighbors`` (Arrow, or ``kneighbors_raw`` without an Arrow
library). Socket work only: no device work happens here.

Self-healing: every op runs inside a reconnect loop. A connection-level
failure (``ConnectionError``, ``ProtocolError``, a socket timeout, any
``OSError``) drops the cached socket, backs off with decorrelated jitter
(utils/retry.py), reconnects and replays the op. Replay is exactly-once:
``feed``/``feed_raw`` carry a ``feed_id`` minted once per op that the
daemon dedupes, ``step`` a ``step_id`` whose replay returns the applied
step's info, ``merge_state`` a ``merge_id`` and ``reduce_mesh`` a
``reduce_id`` that fold once, ``commit``, ``seed`` and ``set_iterate`` are
idempotent by design, and reads are pure. A
per-op deadline (``op_deadline_s``) bounds the TOTAL time spent healing
one op and clamps each attempt's socket timeout. A ``busy`` response is
honoured by waiting the daemon's ``retry_after_s`` hint (jittered) without
using up a reconnect attempt. ``FrameTooLarge`` is deterministic and is
never replayed. ``finalize`` sends ``drop: false`` and drops with a
separate op once the arrays are in hand, so a replay after a lost
response re-reads the same model.

The healing loop counts what it does in the process-wide metrics registry
(``srml_client_*_total``; per-client deltas in ``stats``), and an injected
fault (utils/faults.py; the ``client.connect`` and ``client.op`` sites are
here) that it absorbs counts as a fault trip.

Distributed tracing: every op carries the additive ``trace_ctx`` field,
the constructor's fixed context or else the calling thread's innermost
journal frame (``utils/journal.py``), so the daemon's spans parent into
the caller's run; outside any run, with no fixed context, nothing is
stamped and the wire bytes are the untraced ones. ``trace_pull`` and
``telemetry_pull`` read the daemon's journal ring and its telemetry.
"""

from __future__ import annotations

import random
import socket
import time
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.serve import protocol
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.retry import decorrelated_jitter

logger = get_logger("serve.client")

#: The healing loop's counters (process-wide; per-client deltas live in
#: ``DataPlaneClient.stats``).
_M_RECONNECTS = metrics_mod.counter(
    "srml_client_reconnects_total", "Connection-level failures healed by reconnecting, by op")
_M_REPLAYS = metrics_mod.counter(
    "srml_client_replays_total", "Ops replayed after possibly reaching the wire, by op")
_M_BACKOFF_SECONDS = metrics_mod.counter(
    "srml_client_backoff_seconds_total", "Seconds slept in reconnect backoff (decorrelated jitter)")
_M_BUSY_WAITS = metrics_mod.counter(
    "srml_client_busy_waits_total", "busy sheds honored with a wait, by op")
_M_BUSY_WAIT_SECONDS = metrics_mod.counter(
    "srml_client_busy_wait_seconds_total", "Seconds slept honoring busy retry_after_s hints")
_M_DEADLINE_EXPIRIES = metrics_mod.counter(
    "srml_client_deadline_expiries_total",
    "Ops abandoned because the per-op deadline expired, by op")
_M_FAULT_TRIPS = metrics_mod.counter(
    "srml_client_fault_trips_total",
    "Injected faults (utils/faults.py) observed by the healing loop, by op")

#: Ops whose acks vouch for job state: their ``boot_id`` joins
#: ``seen_boot_ids`` (a ping's does not).
_STATE_ACK_OPS = frozenset(("feed", "feed_raw", "seed", "commit", "step", "set_iterate",
                            "finalize"))


class DaemonBusy(RuntimeError):
    """The daemon shed the op under load; retry after ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _with_meta(arrays, resp: Dict[str, Any], with_meta: bool):
    """``arrays``, or ``(arrays, the ack's fields)`` with ``with_meta``."""
    if not with_meta:
        return arrays
    return arrays, {k: v for k, v in resp.items() if k not in ("ok", "arrays")}


class DataPlaneClient:
    """One connection to a daemon; one client per thread."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 120.0,
        token: Optional[str] = None,
        op_deadline_s: Optional[float] = None,
        max_op_attempts: int = 5,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        max_busy_wait_s: Optional[float] = None,
        trace_ctx: Optional[Dict[str, str]] = None,
    ):
        """``timeout`` bounds one socket syscall; ``op_deadline_s`` bounds
        one whole op including every reconnect, replay and busy wait (None:
        the attempts alone bound it); ``max_op_attempts`` counts connection
        failures per op; ``max_busy_wait_s`` caps the busy waiting of one
        op: by default 60 s when no deadline is set and the deadline alone
        otherwise, and an explicit value always applies. ``trace_ctx``: a
        fixed ``{"run", "span"}`` context stamped on every op (how a Spark
        task, whose process never opened the driver's run, parents the
        daemon's spans into it); None stamps the calling thread's journal
        frame, if any."""
        self._addr = (host, int(port))
        self._timeout = timeout
        self._token = token
        self._sock: Optional[socket.socket] = None
        self._op_deadline = op_deadline_s
        self._max_attempts = max(1, int(max_op_attempts))
        self._backoff_base = backoff_base_s
        self._backoff_max = backoff_max_s
        self._busy_wait_explicit = max_busy_wait_s is not None
        self._max_busy_wait = 60.0 if max_busy_wait_s is None else float(max_busy_wait_s)
        self._trace_ctx = trace_ctx
        self._rng = random.Random()
        # Feed idempotency nonce: a replayed op carries the same id.
        self._nonce = uuid.uuid4().hex[:12]
        self._seq = 0
        #: Healing counters.
        self.stats: Dict[str, int] = {"reconnects": 0, "replays": 0, "busy_waits": 0}
        #: Every daemon incarnation (``boot_id``) whose state acks this
        #: client has seen. Two mean the daemon restarted under the client's
        #: rows: the fence the Spark fit keys on.
        self.seen_boot_ids: set = set()
        #: The instance id of the last ack: it outranks a cached ping, since
        #: a restarted daemon answers with a new identity.
        self.last_server_id: Optional[str] = None

    # -- connection --------------------------------------------------------

    def _conn(self, deadline: Optional[float] = None) -> socket.socket:
        if self._sock is None:
            faults.checkpoint("client.connect")
            # The connect honours the op deadline too: a blackholed host
            # costs the remaining budget, not a full timeout per attempt.
            timeout = self._timeout
            if deadline is not None:
                timeout = min(timeout, max(deadline - time.monotonic(), 0.01))
            s = socket.create_connection(self._addr, timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _reset(self) -> None:
        """Drop the cached socket: after a connection-level error it may be
        desynced mid-frame."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._reset()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _op_id(self) -> str:
        self._seq += 1
        return f"{self._nonce}-{self._seq}"

    def _attempt(
        self,
        req: Dict[str, Any],
        payload: Optional[bytes],
        arrays: Optional[Dict[str, np.ndarray]],
        want_arrays: bool,
        deadline: Optional[float],
        sent: Dict[str, bool],
    ):
        """One request/response exchange on the cached connection. Response
        array frames are read INSIDE the attempt, so a drop mid-response
        replays the whole op. ``sent`` flips once request bytes may have
        reached the wire: the line between a reconnect and a REPLAY."""
        faults.checkpoint("client.op")
        sock = self._conn(deadline=deadline)
        if deadline is not None:
            # The deadline bounds blocked syscalls too (floor 10 ms, so an
            # expired deadline fails fast).
            sock.settimeout(min(self._timeout, max(deadline - time.monotonic(), 0.01)))
        req = {"v": protocol.PROTOCOL_VERSION, **req}
        if self._token is not None:
            req["token"] = self._token
        sent["flag"] = True
        if arrays is not None:
            protocol.send_arrays(sock, {k: np.asarray(v) for k, v in arrays.items()}, req)
        else:
            protocol.send_json(sock, req)
            if payload is not None:
                protocol.send_frame(sock, payload)
        resp = protocol.recv_json(sock)
        if resp is None:
            raise ConnectionError("daemon closed the connection")
        if not resp.get("ok", False):
            if resp.get("busy"):
                raise DaemonBusy(f"daemon busy: {resp.get('error')}",
                                 float(resp.get("retry_after_s", 1.0)))
            raise RuntimeError(f"daemon error: {resp.get('error')}")
        boot = resp.get("boot_id")
        if boot is not None and req.get("op") in _STATE_ACK_OPS:
            self.seen_boot_ids.add(str(boot))
        if resp.get("id") is not None:
            self.last_server_id = str(resp["id"])
        outs = protocol.recv_arrays(sock, resp) if want_arrays else None
        return resp, outs

    def _op(
        self,
        req: Dict[str, Any],
        payload: Optional[bytes] = None,
        arrays: Optional[Dict[str, np.ndarray]] = None,
        want_arrays: bool = False,
    ):
        """Run one op through the self-healing loop (module docstring)."""
        # Stamped once, outside the retry loop: a replay carries the first
        # attempt's context.
        tc = self._trace_ctx or journal.trace_ctx()
        if tc:
            req = {**req, "trace_ctx": tc}
        start = time.monotonic()
        deadline = None if self._op_deadline is None else start + self._op_deadline
        attempt = 0
        busy_waited = 0.0
        delay = self._backoff_base
        while True:
            sent = {"flag": False}
            try:
                return self._attempt(req, payload, arrays, want_arrays, deadline, sent)
            except protocol.FrameTooLarge:
                # Deterministic: replaying cannot help. The JSON header
                # already went out, so the connection is mid-request: drop
                # it, or the next op's header is read as this op's payload.
                self._reset()
                raise
            except DaemonBusy as e:
                # Release the connection slot through the wait (a parked
                # connection would pin a connection watermark), then retry.
                self._reset()
                wait = e.retry_after_s * (0.5 + self._rng.random())
                if deadline is not None and time.monotonic() + wait > deadline:
                    _M_DEADLINE_EXPIRIES.inc(op=str(req.get("op")))
                    raise
                if (deadline is None or self._busy_wait_explicit) and \
                        busy_waited + wait > self._max_busy_wait:
                    raise
                self.stats["busy_waits"] += 1
                busy_waited += wait
                _M_BUSY_WAITS.inc(op=str(req.get("op")))
                _M_BUSY_WAIT_SECONDS.inc(wait)
                logger.info("daemon busy (%s); retrying op %r in %.2fs",
                            self._addr, req.get("op"), wait)
                time.sleep(wait)
            except (protocol.ProtocolError, OSError) as e:
                # Includes ConnectionError and socket timeouts; the socket
                # may be mid-frame, so it always goes.
                self._reset()
                if isinstance(e, (faults.InjectedDrop, faults.InjectedRefusal)):
                    # The chaos tests' proof that the healing ran.
                    _M_FAULT_TRIPS.inc(op=str(req.get("op")))
                attempt += 1
                if attempt >= self._max_attempts:
                    raise
                delay = decorrelated_jitter(delay, self._backoff_base, self._backoff_max,
                                            self._rng)
                if deadline is not None and time.monotonic() + delay > deadline:
                    _M_DEADLINE_EXPIRIES.inc(op=str(req.get("op")))
                    raise
                self.stats["reconnects"] += 1
                _M_RECONNECTS.inc(op=str(req.get("op")))
                _M_BACKOFF_SECONDS.inc(delay)
                if sent["flag"]:
                    self.stats["replays"] += 1
                    _M_REPLAYS.inc(op=str(req.get("op")))
                logger.warning("connection failure on op %r to %s (attempt %d/%d, "
                               "reconnect in %.2fs): %s", req.get("op"), self._addr,
                               attempt, self._max_attempts, delay, e)
                time.sleep(delay)

    def _roundtrip(self, req: Dict[str, Any], payload: Optional[bytes] = None):
        resp, _ = self._op(req, payload=payload)
        return resp, self._sock

    def _send_arrays_op(self, req: Dict[str, Any], arrays: Dict[str, np.ndarray]):
        """A request carrying raw array frames (ensure_model framing)."""
        resp, _ = self._op(req, arrays=arrays)
        return resp

    # -- ops ---------------------------------------------------------------

    def ping(self) -> bool:
        """Hello: liveness and the version handshake. The server echoes the
        protocol version it speaks; a mismatch raises here."""
        resp, _ = self._roundtrip({"op": "ping"})
        server_v = resp.get("v")
        if server_v is not None and server_v != protocol.PROTOCOL_VERSION:
            raise protocol.ProtocolError(
                f"daemon speaks protocol v{server_v}; this client speaks "
                f"v{protocol.PROTOCOL_VERSION}"
            )
        return bool(resp["ok"])

    def server_id(self) -> Optional[str]:
        """The daemon's self-reported instance id (from a ping): how callers
        tell whether two addresses name one daemon. None from a daemon that
        reports none."""
        resp, _ = self._roundtrip({"op": "ping"})
        return None if resp.get("id") is None else str(resp["id"])

    def server_info(self) -> Dict[str, Any]:
        """The whole ping identity: ``{"v", "id", "boot_id"}``. ``boot_id``
        is the incarnation, fresh every start: two boot_ids under one id is
        a restart."""
        resp, _ = self._roundtrip({"op": "ping"})
        return {k: v for k, v in resp.items() if k != "ok"}

    def health(self) -> Dict[str, Any]:
        """The daemon's health snapshot: ``queue_depth`` (active
        connections), ``staged_bytes``, ``active_jobs``, ``served_models``,
        ``uptime_s``, ``busy`` (over a watermark and shedding, with
        ``retry_after_s``), the ``scheduler`` block and the ``mesh``
        epoch."""
        resp, _ = self._roundtrip({"op": "health"})
        return {k: v for k, v in resp.items() if k != "ok"}

    def gossip_push(self, view: Dict[str, Any]) -> Dict[str, Any]:
        """Push a FleetView wire dict (``serve/gossip.FleetView.to_wire``);
        the ack carries the daemon's own ``view`` back (push-pull in one
        round trip), ``merged`` (the records it adopted) and its identity."""
        resp, _ = self._roundtrip({"op": "gossip_push", "view": view})
        return {k: v for k, v in resp.items() if k != "ok"}

    def gossip_pull(self) -> Dict[str, Any]:
        """The daemon's gossiped FleetView wire dict: what a client builds
        its routing table from, given one seed address."""
        resp, _ = self._roundtrip({"op": "gossip_pull"})
        view = resp.get("view")
        return view if isinstance(view, dict) else {}

    def metrics(self, format: str = "json"):
        """The daemon process's metrics registry: ``format="json"`` returns
        the snapshot dict (histogram buckets cumulative), ``"prometheus"``
        the text exposition (v0.0.4) string."""
        resp, _ = self._roundtrip({"op": "metrics", "format": format})
        if format == "prometheus":
            return str(resp.get("text", ""))
        return resp.get("metrics", {})

    def telemetry_pull(self) -> Dict[str, Any]:
        """The daemon's telemetry in one cursor-free answer: ``text``
        (OpenMetrics with per-bucket exemplars), ``metrics`` (the JSON
        snapshot), ``xprof`` (the kernel ledger), ``fingerprint`` (the
        config fingerprint), with its identity and ``uptime_s``."""
        resp, _ = self._roundtrip({"op": "telemetry_pull"})
        return {k: v for k, v in resp.items() if k != "ok"}

    def trace_pull(self, cursor: int = 0) -> Dict[str, Any]:
        """Journal events of the daemon's ring with ``seq`` above
        ``cursor``: ``{"events": [...], "seq": N, "id", "boot_id"}``. Pass the
        returned ``seq`` as the next cursor to stream without duplicates;
        start again from 0 when ``boot_id`` changes."""
        resp, _ = self._roundtrip({"op": "trace_pull", "cursor": int(cursor)})
        return {k: v for k, v in resp.items() if k != "ok"}

    @staticmethod
    def _to_ipc(data, input_col: str, label_col: str = "label") -> bytes:
        """An (n, d) ndarray, an (x, y) pair of arrays or an Arrow
        Table/RecordBatch as one Arrow IPC stream (pyarrow imported here:
        only the Arrow ops need it)."""
        import pyarrow as pa

        from spark_rapids_ml_tpu_torch.bridge.arrow import matrix_to_list_column

        if isinstance(data, tuple):
            x, y = data
            table = pa.table({input_col: matrix_to_list_column(np.asarray(x)),
                              label_col: pa.array(np.asarray(y).reshape(-1))})
        elif isinstance(data, np.ndarray):
            table = pa.table({input_col: matrix_to_list_column(data)})
        elif isinstance(data, pa.RecordBatch):
            table = pa.Table.from_batches([data])
        else:
            table = data
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return sink.getvalue().to_pybytes()

    def feed(
        self,
        job: str,
        data,
        algo: str = "pca",
        input_col: str = "features",
        label_col: str = "label",
        n_cols: Optional[int] = None,
        params: Optional[Dict[str, Any]] = None,
        partition: Optional[int] = None,
        attempt: int = 0,
        pass_id: Optional[int] = None,
    ) -> int:
        """Feed one batch: an Arrow Table/RecordBatch, an (n, d) ndarray or
        an (x, y) pair for linreg/logreg/rf (the labels in ``label_col``).
        ``params`` configure the job at its first feed (kmeans {"k", "seed",
        "init"}, logreg {"n_classes"}). With ``partition`` set the batch goes
        to that partition's stage and counts only after :meth:`commit`;
        ``pass_id`` fences an iterative job's feeds to its current pass.
        Returns the job's committed rows."""
        resp, _ = self._roundtrip(
            {
                "op": "feed",
                "job": job,
                "algo": algo,
                "input_col": input_col,
                "label_col": label_col,
                "n_cols": n_cols,
                "params": params or {},
                "partition": partition,
                "attempt": attempt,
                "pass_id": pass_id,
                # a reconnect replays this exact feed; folded at most once
                "feed_id": self._op_id(),
            },
            payload=self._to_ipc(data, input_col, label_col),
        )
        return int(resp["rows"])

    def feed_raw(
        self,
        job: str,
        x: np.ndarray,
        y: Optional[np.ndarray] = None,
        algo: str = "pca",
        n_cols: Optional[int] = None,
        params: Optional[Dict[str, Any]] = None,
        partition: Optional[int] = None,
        attempt: int = 0,
        pass_id: Optional[int] = None,
    ) -> int:
        """:meth:`feed` with raw little-endian buffers instead of Arrow IPC:
        the op a client without an Arrow library uses. ``y``: the (n,)
        labels of a linreg/logreg/rf feed."""
        arrays: Dict[str, np.ndarray] = {"x": np.asarray(x)}
        if y is not None:
            arrays["y"] = np.asarray(y).reshape(-1)
        resp = self._send_arrays_op(
            {
                "op": "feed_raw",
                "job": job,
                "algo": algo,
                "n_cols": n_cols,
                "params": params or {},
                "partition": partition,
                "attempt": attempt,
                "pass_id": pass_id,
                "feed_id": self._op_id(),
            },
            arrays,
        )
        return int(resp["rows"])

    def commit(self, job: str, partition: int, attempt: int = 0,
               pass_id: Optional[int] = None) -> int:
        """Commit a partition's stage into the job (idempotent). Returns the
        job's committed rows."""
        resp, _ = self._roundtrip({"op": "commit", "job": job, "partition": partition,
                                   "attempt": attempt, "pass_id": pass_id})
        return int(resp["rows"])

    def seed_kmeans(self, job: str, data, k: int, input_col: str = "features",
                    n_cols: Optional[int] = None,
                    params: Optional[Dict[str, Any]] = None) -> None:
        """Seed a kmeans job's centres from a driver-chosen batch of >= k
        rows (an Arrow Table or an (n, d) ndarray, sent as Arrow IPC). The
        rows are NOT folded: they arrive through the partition scan.
        Idempotent: a retried seed keeps the first centres."""
        self._roundtrip(
            {"op": "seed", "job": job, "input_col": input_col, "n_cols": n_cols,
             "params": {**(params or {}), "k": k}},
            payload=self._to_ipc(data, input_col),
        )

    def seed_kmeans_raw(self, job: str, x: np.ndarray, k: int,
                        params: Optional[Dict[str, Any]] = None) -> None:
        """:meth:`seed_kmeans` with the rows as a raw ``x`` frame, for a
        driver without an Arrow library (the port's daemon reads both
        forms; the JAX daemon reads only Arrow)."""
        x = np.asarray(x)
        self._send_arrays_op(
            {"op": "seed", "job": job, "n_cols": int(x.shape[1]),
             "params": {**(params or {}), "k": k}},
            {"x": x},
        )

    def step(self, job: str, params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Pass boundary of an iterative job: the Lloyd or Newton update, or
        a forest's next level, over the pass's statistics. Returns
        {"iteration", "pass_rows", and "moved2", "cost" (kmeans), "delta",
        "loss" (logreg) or "depth", "open_nodes", "splits" (rf)}. The
        ``step_id`` minted here rides every replay of this call, so a
        healed resend gets the applied step's info and never steps twice."""
        resp, _ = self._roundtrip({"op": "step", "job": job, "params": params or {},
                                   "step_id": self._op_id()})
        return {k: v for k, v in resp.items() if k != "ok"}

    def get_iterate(self, job: str) -> Tuple[Dict[str, np.ndarray], int]:
        """(iterate arrays, iteration): kmeans {"centers"}, logreg {"w", "b"},
        rf the forest's tables {"bin_edges", "feature", "threshold", "value",
        "depth"}."""
        resp, arrays = self._op({"op": "get_iterate", "job": job}, want_arrays=True)
        return arrays, int(resp["iteration"])

    def set_iterate(self, job: str, arrays: Dict[str, np.ndarray], iteration: int,
                    algo: Optional[str] = None, n_cols: Optional[int] = None,
                    params: Optional[Dict[str, Any]] = None) -> None:
        """Install an iterate and open pass ``iteration`` (the pass's
        statistics and stages reset). With ``n_cols`` (plus ``algo`` and
        ``params``, as a first feed) a job the daemon does not know is
        created at this iterate: the recovery path of a driver's ledger.
        Given ``algo`` or ``params`` without ``n_cols``, the width is read
        from the iterate (centres (k, d), a forest's bin edges (d, B − 1),
        w (d,) or (d, C))."""
        req: Dict[str, Any] = {"op": "set_iterate", "job": job, "iteration": int(iteration)}
        if n_cols is None and (algo is not None or params is not None):
            if "centers" in arrays:
                n_cols = int(np.asarray(arrays["centers"]).shape[1])
            elif "bin_edges" in arrays or "w" in arrays:
                n_cols = int(np.asarray(arrays.get("bin_edges", arrays.get("w"))).shape[0])
        if n_cols is not None:
            req.update(algo=algo or "pca", n_cols=int(n_cols), params=params or {})
        self._send_arrays_op(req, arrays)

    def status(self, job: str) -> Dict[str, Any]:
        resp, _ = self._roundtrip({"op": "status", "job": job})
        return resp

    def drop(self, job: str) -> bool:
        resp, _ = self._roundtrip({"op": "drop", "job": job})
        return bool(resp["dropped"])

    def finalize(self, job: str, params: Dict[str, Any], drop: bool = True,
                 arrays: Optional[Dict[str, np.ndarray]] = None, with_meta: bool = False):
        """Finalize a job: (result arrays, total rows), or with
        ``with_meta=True`` (arrays, rows, meta), where meta holds the ack's
        other fields (``pass_rows``, ``model``, ``id``, ``boot_id``).
        ``arrays``: raw frames sent with the request (a knn build's
        ``centroids`` or ``train_rows``). The request always carries
        ``drop: false``; ``drop=True`` then sends the idempotent ``drop``
        once the arrays are in hand (a knn finalize consumes its job
        either way)."""
        req = {"op": "finalize", "job": job, "params": params, "drop": False}
        resp, outs = self._op(req, arrays=arrays or None, want_arrays=True)
        if drop:
            self.drop(job)
        if with_meta:
            meta = {k: v for k, v in resp.items() if k not in ("ok", "arrays")}
            return outs, int(resp["rows"]), meta
        return outs, int(resp["rows"])

    def finalize_pca(self, job: str, k: int, mean_center: bool = True,
                     solver: Optional[str] = None) -> Dict[str, np.ndarray]:
        """{"pc", "explained_variance", "sigma", "mean"} of a PCA job."""
        arrays, _ = self.finalize(job, {"k": k, "mean_center": mean_center, "solver": solver})
        return arrays

    def finalize_linreg(self, job: str, **params) -> Dict[str, np.ndarray]:
        """{"coefficients", "intercept", "rmse", "r2"}; ``params``: reg,
        elastic_net, fit_intercept, max_iter, tol."""
        arrays, _ = self.finalize(job, params)
        return arrays

    def finalize_kmeans(self, job: str) -> Dict[str, np.ndarray]:
        """{"centers", "cost", "n_iter"} after the last ``step``: ``cost`` is
        the current (unstepped) pass's, so feed one pass at the final
        centres without stepping to read the final cost."""
        arrays, _ = self.finalize(job, {})
        return arrays

    def finalize_logreg(self, job: str) -> Dict[str, np.ndarray]:
        """{"coefficients", "intercept", "n_iter"} after the last ``step``
        (Spark's layout: (C, d) and (C,) for the multinomial protocol)."""
        arrays, _ = self.finalize(job, {})
        return arrays

    def finalize_knn(
        self,
        job: str,
        register_as: str,
        mode: str = "exact",
        nlist: Optional[int] = None,
        nprobe: Optional[int] = None,
        seed: int = 0,
        metric: str = "euclidean",
        row_id_base: Optional[Dict[Any, int]] = None,
        centroids: Optional[np.ndarray] = None,
        return_centroids: bool = False,
        train_rows_sample: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """Build the index of a knn job's rows ON the daemon and register it
        as ``register_as`` for :meth:`kneighbors`. Returns only the O(1)
        info ({"n_rows", "n_cols"} and, for ivf, "nlist", "maxlen",
        "sharded"); the index never crosses the wire. ``row_id_base`` maps
        each partition to its global row base; ``centroids`` is a
        pretrained (nlist, d) quantizer, kept frozen; ``return_centroids``
        ships the trained quantizer back; ``train_rows_sample`` is the
        quantizer's training set."""
        params: Dict[str, Any] = {"mode": mode, "register_as": register_as, "seed": seed,
                                  "metric": metric}
        if nlist is not None:
            params["nlist"] = nlist
        if nprobe is not None:
            params["nprobe"] = nprobe
        if row_id_base is not None:
            params["row_id_base"] = {str(p): int(b) for p, b in row_id_base.items()}
        if return_centroids:
            params["return_centroids"] = True
        extra: Dict[str, np.ndarray] = {}
        if centroids is not None:
            extra["centroids"] = np.asarray(centroids, np.float32)
        if train_rows_sample is not None:
            extra["train_rows"] = np.asarray(train_rows_sample)
        arrays, _ = self.finalize(job, params, arrays=extra or None)
        return arrays

    def sample_rows(self, job: str, n: int, seed: int = 0) -> np.ndarray:
        """A seeded uniform sample of at most ``n`` of a knn job's committed
        rows (read-only)."""
        _, arrays = self._op({"op": "sample_rows", "job": job, "n": int(n), "seed": int(seed)},
                             want_arrays=True)
        return arrays["rows"]

    def export_state(self, job: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """A job's committed statistics (s0, s1, ... in the reference's order;
        count, Σx, XᵀX for pca) and meta (rows, pass_rows, iteration, algo, n_cols, committed)."""
        resp, arrays = self._op({"op": "export_state", "job": job}, want_arrays=True)
        meta = {k: v for k, v in resp.items() if k not in ("ok", "arrays")}
        return arrays, meta

    # -- cross-daemon merges -----------------------------------------------

    def merge_state(self, job: str, arrays: Dict[str, np.ndarray], rows: int,
                    algo: str = "pca", n_cols: Optional[int] = None,
                    params: Optional[Dict[str, Any]] = None) -> int:
        """Fold a peer daemon's exported state (:meth:`export_state`'s
        arrays) into ``job``, creating it when absent (``algo``, ``n_cols``
        and ``params`` as a first feed's). ``rows`` is the exporter's
        committed contribution; returns the job's new total. The request
        carries a fresh ``merge_id``, so a replay folds once."""
        resp = self._send_arrays_op(
            {"op": "merge_state", "job": job, "algo": algo, "n_cols": n_cols,
             "params": params or {}, "rows": int(rows), "merge_id": self._op_id()},
            arrays,
        )
        return int(resp["rows"])

    def mesh_info(self) -> Dict[str, Any]:
        """The membership snapshot of the daemon's device plane: ``epoch``
        (bumped by every join, leave and reboot), ``members`` (``id``,
        ``boot_id``, ``joined_epoch``), ``n_devices``, and the daemon's own
        ``id`` and ``boot_id``. A driver reads it each pass to choose the
        collective reduce or the hub, and stamps ``epoch`` on
        :meth:`reduce_mesh`."""
        resp, _ = self._roundtrip({"op": "mesh_info"})
        return {k: v for k, v in resp.items() if k != "ok"}

    def reduce_mesh(self, job: str, *, epoch: int, peers: Dict[str, Dict[str, Any]],
                    algo: str = "pca", params: Optional[Dict[str, Any]] = None,
                    drop_peers: bool = False) -> Dict[str, Any]:
        """Fold every named co-resident peer's committed pass partials into
        ``job`` on the daemon's device. ``peers``: {peer id: {"boot_id",
        "rows", "partitions"}}, the driver's task-ack accounting, which the
        daemon checks against each peer's live job before anything folds.
        ``epoch`` must be the one :meth:`mesh_info` reported. The request
        carries a fresh ``reduce_id``, so a replay folds once."""
        resp, _ = self._op({
            "op": "reduce_mesh", "job": job, "epoch": int(epoch), "peers": peers,
            "algo": algo, "params": params or {}, "drop_peers": bool(drop_peers),
            "reduce_id": self._op_id(),
        })
        return resp

    # -- model serving -----------------------------------------------------

    def ensure_model(self, name: str, algo: str, arrays: Dict[str, np.ndarray],
                     params: Optional[Dict[str, Any]] = None,
                     version: Optional[int] = None) -> bool:
        """Register a fitted model for serving (idempotent; the first caller
        wins). ``arrays`` is the model's ``_model_data()``; raw frames
        follow the JSON header. ``version`` pins the registration to a
        fleet model version, immutable under the name: a serving request
        carrying another ``version`` is refused. True when this call
        created it."""
        resp = self._send_arrays_op(
            {"op": "ensure_model", "model": name, "algo": algo, "params": params or {},
             "version": version},
            arrays,
        )
        return bool(resp["created"])

    def model_exists(self, name: str) -> bool:
        resp, _ = self._roundtrip({"op": "model_status", "model": name})
        return bool(resp["exists"])

    def transform(self, name: str, data, input_col: str = "features",
                  n_cols: Optional[int] = None,
                  deadline_s: Optional[float] = None, version: Optional[int] = None,
                  fleet_epoch: Optional[int] = None, with_meta: bool = False):
        """Run a registered model over one batch on the daemon's device:
        the role-keyed outputs of the model's ``_serve_outputs`` ({"output"}
        for PCA, {"prediction"} for KMeans and LinearRegression,
        {"rawPrediction", "probability", "prediction"} for
        LogisticRegression). ``deadline_s``: the request's latency budget;
        the serving scheduler sheds it with ``busy`` when its backlog would
        already miss it. ``version``/``fleet_epoch``: the fleet's routing
        pin; a versioned registration refuses another ``version`` and the
        ack echoes both. ``with_meta``: return ``(arrays, meta)``, ``meta``
        the ack's fields (``rows``, ``version``, ``fleet_epoch``)."""
        resp, arrays = self._op(
            {"op": "transform", "model": name, "input_col": input_col, "n_cols": n_cols,
             "deadline_s": deadline_s, "version": version, "fleet_epoch": fleet_epoch},
            payload=self._to_ipc(data, input_col),
            want_arrays=True,
        )
        return _with_meta(arrays, resp, with_meta)

    def transform_raw(self, name: str, x: np.ndarray, deadline_s: Optional[float] = None,
                      version: Optional[int] = None, fleet_epoch: Optional[int] = None,
                      with_meta: bool = False):
        """:meth:`transform` with the rows as a raw ``x`` frame, for a caller
        without an Arrow library (the port's daemon reads both forms; the
        JAX daemon reads only Arrow)."""
        x = np.asarray(x)
        resp, arrays = self._op(
            {"op": "transform", "model": name, "n_cols": int(x.shape[1]),
             "deadline_s": deadline_s, "version": version, "fleet_epoch": fleet_epoch},
            arrays={"x": x}, want_arrays=True,
        )
        return _with_meta(arrays, resp, with_meta)

    def warmup(self, name: str, n_cols: int, k: Optional[int] = None, dtype: str = "float32",
               kind: Optional[str] = None) -> Dict[str, Any]:
        """Warm the serving scheduler's bucket ladder for a registered model:
        one zero batch at every reachable bucket. ``dtype`` must be the
        dtype real batches carry; ``kind`` defaults daemon-side to
        ``kneighbors`` for a knn index and ``transform`` otherwise. On a
        daemon without batching it is an honest no-op: ``enabled: false``."""
        resp, _ = self._roundtrip({"op": "warmup", "model": name, "n_cols": int(n_cols),
                                   "k": k, "dtype": dtype, "kind": kind})
        return {kk: v for kk, v in resp.items() if kk != "ok"}

    def drop_model(self, name: str) -> bool:
        resp, _ = self._roundtrip({"op": "drop_model", "model": name})
        return bool(resp["dropped"])

    def kneighbors(self, model: str, queries, k: Optional[int] = None,
                   input_col: str = "features", n_cols: Optional[int] = None,
                   deadline_s: Optional[float] = None, version: Optional[int] = None,
                   fleet_epoch: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Query a daemon-built index with one batch (an (q, d) ndarray or an
        Arrow table, sent as Arrow IPC): (distances (q, k) float64, indices
        (q, k) int64 global row ids). ``k`` None: the index's fitted k.
        ``deadline_s`` and ``version``/``fleet_epoch``: as in
        :meth:`transform`."""
        _, arrays = self._op(
            {"op": "kneighbors", "model": model, "k": k, "input_col": input_col,
             "n_cols": n_cols, "deadline_s": deadline_s, "version": version,
             "fleet_epoch": fleet_epoch},
            payload=self._to_ipc(queries, input_col),
            want_arrays=True,
        )
        return arrays["distances"], arrays["indices"]

    def kneighbors_raw(self, model: str, x: np.ndarray, k: Optional[int] = None,
                       deadline_s: Optional[float] = None, version: Optional[int] = None,
                       fleet_epoch: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`kneighbors` with the queries as a raw ``x`` frame, for a
        caller without an Arrow library (the port's daemon reads both
        forms; the JAX daemon reads only Arrow)."""
        x = np.asarray(x)
        _, arrays = self._op(
            {"op": "kneighbors", "model": model, "k": k, "n_cols": int(x.shape[1]),
             "deadline_s": deadline_s, "version": version, "fleet_epoch": fleet_epoch},
            arrays={"x": x}, want_arrays=True,
        )
        return arrays["distances"], arrays["indices"]
