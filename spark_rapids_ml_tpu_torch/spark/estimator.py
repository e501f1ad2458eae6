"""The PySpark DataFrame adapters of the port: ``SparkPCA``,
``SparkLinearRegression``, ``SparkKMeans``, ``SparkLogisticRegression``,
``SparkNearestNeighbors``, ``SparkApproximateNearestNeighbors``,
``SparkStandardScaler``, ``SparkRandomForestClassifier`` and
``SparkRandomForestRegressor``.

The port of ``spark_rapids_ml_tpu/spark/estimator.py`` for those nine
estimators. The reference's user contract is to change one import and
keep the Spark ML code (reference PCA.scala:27-37, README.md:27-37, with
the features column an ArrayType):
``SparkPCA().setInputCol("features").setK(3).fit(df)``.

**fit is distributed.** Each partition task streams its Arrow batches
(features, and labels for the regressions) to the data-plane daemon next
to the card (``serve/``) and commits; the daemon folds every batch into
its job's state on the card; the driver finalizes and receives only the
model (RapidsRowMatrix.scala:118-139). The dataset never reaches the
driver. PCA, StandardScaler (a pca job finalized to its raw moments,
no eigensolve) and LinearRegression are one scan. KMeans,
LogisticRegression and the forests are one scan per pass: the driver seeds
KMeans' centres from a small prefix sample (``seed``), learns
LogisticRegression's and the forest classifier's class count from a
one-row-per-task label probe, installs a forest's quantile bin edges
(from a prefix sample) and empty trees with a creating ``set_iterate``,
and after each scan steps the daemon's iterate until it converges (a
forest: one level per pass, until no node is open); KMeans then scans
once more at the final centres for its training cost. Task retries and
speculative duplicates are safe: feeds stage per (partition, attempt,
pass) and only ``commit`` adds a stage, once. The driver holds the daemon to the tasks'
acks (a row-count mismatch, at finalize or at a step, fails the fit) and
fences a daemon restart under a scan (an incarnation change). The
nearest-neighbour fits are one scan into a ``knn`` job whose finalize
BUILDS the index on the daemon and registers it there: the fit returns a
handle (:class:`_DaemonKNNModel`) whose ``kneighbors`` and ``transform``
query that index, which is dataset-sized and never reaches the driver.
With
``spark.srml.fit.recovery_attempts`` > 0 it keeps a ledger of the last
iterate (``get_iterate`` at each pass boundary) and replays the failed
pass from it, recreating a lost job with ``set_iterate``; a single-pass
fit replays its scan.

Each driver loop (``_drive_pca``, ``_drive_scaler``, ``_drive_linreg``,
``_drive_kmeans``, ``_drive_logreg``, ``_drive_forest``, ``_drive_knn``)
is a function of a :class:`_DaemonFit` and a ``run_pass(pass_id) -> acks``
callable: the Spark fit passes one that runs ``mapInArrow`` tasks, and a
driver without Spark (the card smoke) one of its own.

**transform** runs ``mapInArrow`` tasks that register the model with the
daemon once (``ensure_model``) and send each batch's features to its
``transform`` op, or, with ``SRML_TRANSFORM_LOCAL=1``, score on the
executor's CPU. The model's serving params (``_serve_params``: the
scaler's withMean and withStd) ride the registration and its name, so two
copies of one fit that differ in them are served apart.

**Across daemons.** Executors on several hosts feed their own daemons
(``SRML_DAEMON_ADDRESS`` in the executor's env). The daemon the driver
resolved is the primary; every other daemon that holds rows of a scan
becomes a peer (:class:`_DaemonFit`), and the scan ends with the peers'
partials folded into the primary: one ``reduce_mesh`` on the device when
the peers share the primary's process (``mesh_collectives``), else the
driver's hub (``export_state`` from each peer, ``merge_state`` into the
primary). Both fold in sorted peer-id order, so they agree bitwise, and
each peer is held to its tasks' acks, per partition, before anything
folds. At each pass boundary the primary's stepped iterate goes to every
peer. KMeans and the forests seed the configured daemons
(``spark.srml.daemon.addresses``) before the first scan; a peer that was
not configured fails its tasks loudly. A knn fit across daemons builds
one shard a daemon (one shared quantizer for IVF) and serves a fan-out.

**Elastic.** With ``spark.srml.fit.daemon_loss_tolerance`` > 0 a fit
survives the permanent loss of a PEER daemon: after a failed pass it probes
every daemon within ``daemon_death_timeout_s`` (mesh membership is a second
witness), quarantines the dead peers within the loss budget, rewinds the
survivors to the last pass boundary and replays the pass, the dead
daemon's partitions rerouted by Spark to the survivors. With
``spark.srml.fit.daemon_join_policy=boundary`` a daemon that appears in
``spark.srml.daemon.addresses`` mid-fit is admitted at the next pass
boundary (seeded with the ledger's iterate, at most
``daemon_join_limit`` a fit) and the replayed pass rebalances partitions
onto it. Both models equal the fit on the static topology. The knn fit
runs neither loop, as in the reference: a daemon lost there fails it.

pyspark is optional: importing this module never needs it (nor pyarrow,
which the tasks import at use); ``fit``/``transform`` of a Spark DataFrame
do.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import kmeans as _km
from spark_rapids_ml_tpu_torch.models import knn as _knn
from spark_rapids_ml_tpu_torch.models import linear_regression as _lr
from spark_rapids_ml_tpu_torch.models import logistic_regression as _lg
from spark_rapids_ml_tpu_torch.models import random_forest as _rf
from spark_rapids_ml_tpu_torch.models.pca import PCA as _PCA
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.models.scaler import StandardScaler as _StandardScaler
from spark_rapids_ml_tpu_torch.models.scaler import StandardScalerModel, finalize_moments
from spark_rapids_ml_tpu_torch.ops.histogram import quantile_bin_edges
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

logger = get_logger("spark.estimator")

_M_FIT_RECOVERIES = metrics_mod.counter(
    "srml_fit_recoveries_total",
    "Fit passes replayed after a daemon incarnation change or poisoned pass, by algo",
)
_M_DROP_ERRORS = metrics_mod.counter(
    "srml_client_drop_errors_total",
    "Cleanup drop() calls that failed (the daemon job leaks until its TTL), by stage",
)
_M_MESH_PATHS = metrics_mod.counter(
    "srml_fit_mesh_reduce_paths_total",
    "Multi-daemon pass reductions by path (collective = on-mesh "
    "reduce_mesh; hub = driver-mediated export/merge fallback)",
)
_M_DAEMON_LOSSES = metrics_mod.counter(
    "srml_fit_daemon_losses_total",
    "Peer daemons declared permanently dead and quarantined by an elastic fit "
    "(fit_daemon_loss_tolerance > 0), by algo",
)
_M_FIT_REROUTES = metrics_mod.counter(
    "srml_fit_reroutes_total",
    "Feed passes rerun on the shrunken topology after a daemon loss (the dead daemon's "
    "partitions reroute to survivors), by algo",
)
_M_FIT_JOINS = metrics_mod.counter(
    "srml_fit_joins_total",
    "Daemons admitted into a running fit at a pass boundary "
    "(fit_daemon_join_policy=boundary), by algo",
)
_M_FIT_REBALANCED = metrics_mod.counter(
    "srml_fit_rebalanced_rows_total",
    "Rows the task layer rebalanced onto mid-fit joiners on their first acked pass after "
    "admission, by algo",
)

#: The schema of a feed task's one ack row.
_ACK_SCHEMA = "partition int, rows long, daemon string, daemon_id string, boots string"


def _drop_quietly(client, job: str, stage: str) -> None:
    """A cleanup drop that cannot mask the fit's outcome; a failure is
    counted and logged (the daemon holds the job until its TTL)."""
    try:
        client.drop(job)
    except Exception as e:
        _M_DROP_ERRORS.inc(stage=stage)
        logger.debug("cleanup drop of job %r failed (%s); the daemon holds it until "
                     "its TTL: %s", job, stage, e)


def _pyspark():
    try:
        from pyspark.sql import DataFrame

        return DataFrame
    except ImportError:
        return None


# Extra DataFrame types treated as Spark DataFrames: stand-ins with the
# same surface (the test harness's SimDataFrame registers here, so the
# wrappers' real code paths run without pyspark).
_EXTRA_DF_TYPES: tuple = ()


def register_dataframe_type(cls) -> None:
    global _EXTRA_DF_TYPES
    _EXTRA_DF_TYPES = tuple(set(_EXTRA_DF_TYPES) | {cls})


def _is_spark_df(dataset: Any) -> bool:
    if _EXTRA_DF_TYPES and isinstance(dataset, _EXTRA_DF_TYPES):
        return True
    df_cls = _pyspark()
    return df_cls is not None and isinstance(dataset, df_cls)


def _check_not_orphan_spark_df(dataset: Any) -> None:
    """A clear error for a Spark-shaped dataset when pyspark is missing."""
    if _pyspark() is None and (
        hasattr(dataset, "sparkSession") or type(dataset).__module__.split(".")[0] == "pyspark"
    ):
        raise ImportError(
            "pyspark is not installed; Spark* estimators need it for DataFrame inputs. "
            "Use the core estimators (spark_rapids_ml_tpu_torch.PCA etc.) with "
            "arrow/pandas/numpy data."
        )


# Executor-side cache: daemon instance id per (fit job, host, port). Scoped
# by job, so a daemon restarted between fits is pinged afresh by the next
# fit, while the tasks of one fit share one ping per worker process.
_DAEMON_ID_CACHE: Dict[Tuple[str, str, int], str] = {}


def _evict_daemon_id_cache(job: str, addr: Optional[str] = None, prefix: bool = False) -> None:
    """Drop this fit's id-cache routes from this process's cache: all of
    them at fit exit (a recycled job name must not inherit a stale daemon
    id), only ``addr``'s when a daemon is quarantined. ``prefix`` sweeps
    every job under a uid prefix. Each process owns its copy: on reused
    executor workers the eviction rides the task (``_FeedTask``'s
    ``evict_routes``). A malformed ``addr`` is a no-op."""
    if addr is not None:
        try:
            host, port = daemon_session._parse_addr(addr)
        except ValueError:
            return
        _DAEMON_ID_CACHE.pop((job, host, port), None)
        return
    for key in [k for k in _DAEMON_ID_CACHE
                if (str(k[0]).startswith(job) if prefix else k[0] == job)]:
        _DAEMON_ID_CACHE.pop(key, None)


def _num_rows(batch) -> int:
    if isinstance(batch, tuple):  # an (x, y) pair of arrays
        batch = batch[0]
    return int(batch.num_rows) if hasattr(batch, "num_rows") else int(batch.shape[0])


def _feed_partition(client, batches, send: Callable[[Any], Any], job: str, partition: int,
                    attempt: int, pass_id: Optional[int], address: Tuple[str, int]) -> dict:
    """One partition task's body: ``send`` every non-empty batch, then
    commit, over ``client`` (connected to ``address``). Returns the ack
    row: ``partition``, ``rows``, ``daemon`` (the address fed), ``daemon_id``
    (its self-reported instance id) and ``boots`` (every incarnation that
    acked this task's state, comma-joined: two mean the daemon restarted
    under the task's rows).

    ``send(batch)`` sends one batch as ``partition``/``attempt``: an Arrow
    ``feed`` in :class:`_FeedTask`, a raw ``feed_raw`` of a numpy batch
    where no Arrow library is at hand. Batches are Arrow record batches,
    (n, d) arrays or (x, y) pairs of arrays."""
    h, p = address
    daemon_id = _DAEMON_ID_CACHE.get((job, h, p))
    if daemon_id is None:
        # The daemon's own identity: the driver keys on it, never on the
        # address spelling (an alias of the primary must not look like a peer).
        daemon_id = client.server_id() or f"{h}:{p}"
        if len(_DAEMON_ID_CACHE) > 256:  # bound worker-reuse growth
            _DAEMON_ID_CACHE.clear()
        _DAEMON_ID_CACHE[(job, h, p)] = daemon_id
    rows = 0
    for batch in batches:
        n = _num_rows(batch)
        if n == 0:
            continue
        send(batch)
        rows += n
    if rows > 0:
        client.commit(job, partition=partition, attempt=attempt, pass_id=pass_id)
    if client.last_server_id and client.last_server_id != daemon_id:
        # The daemon answered with another identity than the cached ping:
        # it restarted under this worker. The ack names who holds the rows.
        daemon_id = client.last_server_id
        _DAEMON_ID_CACHE[(job, h, p)] = daemon_id
    return {
        "partition": partition,
        "rows": rows,
        "daemon": f"{h}:{p}",
        "daemon_id": daemon_id,
        "boots": ",".join(sorted(client.seen_boot_ids)),
    }


def _features_col(core) -> str:
    """The features column a core estimator or model reads: ``inputCol``
    (PCA) or ``featuresCol``."""
    return core.getOrDefault("inputCol" if core.hasParam("inputCol") else "featuresCol")


def _prefix_sample(df, input_col: str, rows: int) -> np.ndarray:
    """The (n, d) prefix of ``input_col``, at most ``rows`` rows: the only
    rows that reach the driver (the kmeans seed, a forest's bin edges)."""
    import pyarrow as pa

    from spark_rapids_ml_tpu_torch.bridge.arrow import table_column_to_matrix

    selected = df.select(input_col).limit(rows)
    if hasattr(selected, "toArrow"):
        table = selected.toArrow()
    else:
        table = pa.Table.from_pandas(selected.toPandas(), preserve_index=False)
    if table.num_rows == 0:
        return np.empty((0, 0), np.float32)
    return table_column_to_matrix(table, input_col)


class _FeedTask:
    """The executor-side partition feeder: a plain picklable callable for
    ``mapInArrow`` (its imports happen on the executor). One task is one
    partition on one connection: an Arrow ``feed`` per non-empty batch
    (features, and ``label_col`` for linreg/logreg/rf; ``params`` create the
    job at its first feed), keyed (partition, attempt, pass_id), then
    ``commit``; it yields one ack row. ``evict_routes``: the quarantined
    daemons' addresses, dropped from this worker process's id cache before
    the task resolves its daemon (a reused worker must re-ping whatever
    now answers at a dead daemon's address). ``trace_ctx``: the driver's
    journal frame when the task was built, stamped by the task's client on
    every op, so the daemon's spans parent into the driver's fit run
    although the executor process never opened it."""

    def __init__(self, host, port, token, job, algo, input_col, pass_id, label_col=None,
                 params=None, evict_routes=()):
        self.host, self.port, self.token = host, port, token
        self.job, self.algo = job, algo
        self.input_col, self.pass_id = input_col, pass_id
        self.label_col, self.params = label_col, dict(params or {})
        self.evict_routes = tuple(evict_routes)
        self.trace_ctx = journal.trace_ctx()

    def __call__(self, batches):
        import pyarrow as pa

        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        ds = daemon_session
        pid, attempt = ds.task_context()
        h, p = ds.executor_daemon_address(self.host, self.port)
        for bad in self.evict_routes:
            _evict_daemon_id_cache(self.job, bad)
        # client_kwargs(): the executor env's resilience tuning, so a daemon
        # hiccup is healed by the client before it costs a Spark task retry.
        with DataPlaneClient(h, p, token=self.token, trace_ctx=self.trace_ctx,
                             **ds.client_kwargs()) as c:

            def send(batch):
                c.feed(self.job, batch, algo=self.algo, input_col=self.input_col,
                       label_col=self.label_col or "label", params=self.params,
                       partition=pid, attempt=attempt, pass_id=self.pass_id)

            ack = _feed_partition(c, batches, send, self.job, pid, attempt, self.pass_id,
                                  (h, p))
        yield pa.RecordBatch.from_pydict({
            "partition": pa.array([ack["partition"]], pa.int32()),
            "rows": pa.array([ack["rows"]], pa.int64()),
            "daemon": pa.array([ack["daemon"]], pa.string()),
            "daemon_id": pa.array([ack["daemon_id"]], pa.string()),
            "boots": pa.array([ack["boots"]], pa.string()),
        })


class _LabelMaxTask:
    """A one-row-per-task label scan: each task reports its partition's
    largest label. One small Spark job (as the reference's numCols probe,
    RapidsPCA.scala:73-74) tells the driver the class count without
    collecting labels."""

    def __init__(self, label_col):
        self._label = label_col

    def __call__(self, batches):
        import pyarrow as pa

        mx = -1.0
        for batch in batches:
            if batch.num_rows:
                col = pa.Table.from_batches([batch]).column(self._label)
                arr = np.asarray(col.to_numpy(zero_copy_only=False))
                if arr.size:
                    mx = max(mx, float(np.max(arr)))
        yield pa.RecordBatch.from_pydict({"maxlabel": pa.array([mx], pa.float64())})


def _probe_num_classes(df, label_col) -> int:
    """max(largest label + 1, 2), from one ``_LabelMaxTask`` job."""
    acks = df.select(label_col).mapInArrow(_LabelMaxTask(label_col), "maxlabel double").collect()
    mx = max((float(r["maxlabel"]) for r in acks), default=-1.0)
    return max(int(mx) + 1, 2)


def _ack_rows(acks):
    """(total rows, rows by daemon id, id → address, partition → winning
    daemon id, daemon id → incarnations seen) of one feed pass's acks.
    Daemons are keyed by their self-reported instance id."""
    per: dict = {}
    addr_of: dict = {}
    owner: dict = {}
    boots: dict = {}
    for r in acks:
        did = r["daemon_id"]
        per[did] = per.get(did, 0) + int(r["rows"])
        addr_of.setdefault(did, r["daemon"])
        if int(r["rows"]) > 0:
            owner[int(r["partition"])] = did
        bs = boots.setdefault(did, set())
        for b in str(r["boots"] or "").split(","):
            if b:
                bs.add(b)
    return sum(per.values()), per, addr_of, owner, boots


def _incarnation_change(addr: str, boots) -> RuntimeError:
    """The fence: a pass whose acks span two incarnations of one daemon fed
    some rows to a state that died with the old one."""
    return RuntimeError(
        f"daemon {addr} restarted mid-pass (incarnations {sorted(boots)}): rows acked to "
        "the dead incarnation are gone from the accumulator while the tasks still count "
        "them. Enable fit recovery (SRML_FIT_RECOVERY_ATTEMPTS / "
        "spark.srml.fit.recovery_attempts) to replay the pass, or refit."
    )


def _split_brain(context: str, expected: int, got: int, detail: str) -> RuntimeError:
    """Committed rows and task-acked rows must reconcile; a mismatch means
    the model would silently miss (or double-count) data."""
    if got > expected:
        hint = (
            "the daemon holds MORE rows than this fit's winning task acks: a task "
            "likely committed here, lost its ack, and was re-run against a different "
            "daemon, or rows were fed outside this fit. Keep executor→daemon routing "
            "sticky across retries."
        )
    else:
        hint = (
            "the daemon holds FEWER rows than tasks acked: its job was TTL-evicted or "
            "recreated mid-fit. Raise the daemon ttl relative to fit duration."
        )
    return RuntimeError(
        f"daemon row-count mismatch at {context}: tasks acked {expected} rows ({detail}) "
        f"but the daemon plane accounts {got}; {hint} Refit after fixing the cause."
    )


def _iterate_width(arrays: Dict[str, np.ndarray]) -> int:
    """The feature width an iterate's layout carries: kmeans centres (k,
    d), a forest's bin edges (d, B − 1), logreg w (d[, C])."""
    return int(arrays["centers"].shape[1] if "centers" in arrays
               else arrays["bin_edges"].shape[0] if "bin_edges" in arrays
               else arrays["w"].shape[0])


class _DaemonFit:
    """The driver's side of a fit over a primary daemon and its peers: the
    clients, the row accounting of the acks, the peer reduce at each scan,
    the iterate push at each pass boundary, the guarded finalize, the
    recovery ledger and the pass replay.

    The port of ``_fit_distributed_inner``'s body, as methods rather than
    closures, so a driver other than the Spark wrappers' fit (the card
    smoke, whose tasks send raw frames) runs the same checks.

    Executors feed their own host's daemon. A daemon that holds rows of a
    scan and is not the primary becomes a peer (keyed by its self-reported
    instance id: address spellings alias), and every scan ends with the
    peers' partials folded into the primary: one ``reduce_mesh`` when they
    share the primary's device plane, else the export/merge hub. At each
    pass boundary the primary's stepped iterate goes to every peer
    (``set_iterate``) before the ledger advances. ``spark`` names the
    configured daemons (``daemon_session.resolve_all``) that a seeded fit
    seeds before its first scan (:meth:`seed_peers`).

    ``recovery_attempts`` > 0 arms the ledger: the last good iterate,
    pulled at each pass boundary (:meth:`record`), which :meth:`recover`
    reinstalls on every daemon. The driver loop sets ``algo`` and
    ``params`` (the feeds'), with which a creating ``set_iterate`` rebuilds
    a job a daemon lost, and ``push_tol`` (logreg: no push once the step
    converged).

    The elastic fit rides the same replay loop (:meth:`with_recovery`).
    ``loss_tolerance`` > 0 (the death policy): a failed unit whose peers
    give no answer within ``death_timeout_s`` quarantines them
    (:meth:`try_quarantine`) and replays on the survivors.
    ``join_policy`` "boundary" (the grow policy): a failed unit admits the
    configured daemons the fit does not know yet, at most ``join_limit``
    (:meth:`try_admit`), and replays on the grown topology. Either arms
    the ledger; neither uses up ``recovery_attempts``."""

    def __init__(self, host: str, port: int, job: str, token: Optional[str] = None,
                 recovery_attempts: int = 0, spark=None, loss_tolerance: int = 0,
                 death_timeout_s: float = 15.0, join_policy: str = "off", join_limit: int = 2,
                 **client_kw):
        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        self._token, self._client_kw = token, client_kw
        self.client = DataPlaneClient(host, port, token=token, **client_kw)
        self.job = job
        self.address = f"{host}:{port}"
        self.spark = spark
        self.primary_id = self.client.server_id() or self.address
        self.addr_by_id = {self.primary_id: self.address}
        self.total_fed = 0
        self.fed_by_daemon: Dict[str, int] = {}
        self.recovery_attempts = int(recovery_attempts)
        self.loss_tolerance = int(loss_tolerance)
        self.death_timeout_s = float(death_timeout_s)
        self.grow = join_policy == "boundary"
        self.join_limit = int(join_limit)
        self.algo: str = "pca"
        self.params: Dict[str, Any] = {}
        self.push_tol: Optional[float] = None
        #: Peer daemons by instance id → (host, port), and their clients
        #: (one long-lived client each: merges and pushes run every pass).
        self.peers: Dict[str, Tuple[str, int]] = {}
        self._peer_clients: Dict[str, Any] = {}
        #: The collective path's memory: a "no mesh ops here" verdict is
        #: probed once a fit, not every pass. None: not yet read.
        self._hub_only: Optional[bool] = None
        #: (iterate arrays, the pass they open), or None: no boundary yet.
        self.ledger: Optional[Tuple[Dict[str, np.ndarray], int]] = None
        self._pulled: Optional[Tuple[Dict[str, np.ndarray], int]] = None
        self.last_acks: list = []
        #: Quarantined daemons, id → last known address: out of the fit for
        #: good (never synced or merged again; rows they ack are refused).
        self.quarantined: Dict[str, Optional[str]] = {}
        #: Mid-fit joiners, id → address, and those whose first acked pass
        #: since admission has not come yet (its rows are the rebalance).
        self.joined: Dict[str, str] = {}
        self._awaiting_rebalance: set = set()

    @property
    def ledger_on(self) -> bool:
        """Recovery, the death policy and the grow policy all replay from
        the ledger."""
        return self.recovery_attempts > 0 or self.loss_tolerance > 0 or self.grow

    def evict_routes(self) -> list:
        """The quarantined daemons' addresses, sorted: the routes a feed
        task evicts from its worker's id cache."""
        return sorted(a for a in self.quarantined.values() if a)

    def peer_client(self, did: str):
        c = self._peer_clients.get(did)
        if c is None:
            from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

            c = DataPlaneClient(*self.peers[did], token=self._token, **self._client_kw)
            self._peer_clients[did] = c
        return c

    def seed_peers(self, seed_fn: Callable[[Any], Any]) -> None:
        """Register and pre-seed every configured peer daemon
        (``daemon_session.resolve_all``) before pass 0, with ``seed_fn(client)``
        (kmeans centres, a forest's iterate). An address that answers with
        the primary's id, or a peer's already seeded, is an alias and is
        skipped; a client that never registers is closed here."""
        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        for ph, pp in daemon_session.resolve_all(self.spark):
            pc = DataPlaneClient(ph, pp, token=self._token, **self._client_kw)
            registered = False
            try:
                did = pc.server_id() or f"{ph}:{pp}"
                if did == self.primary_id or did in self.peers:
                    continue
                self.peers[did] = (ph, pp)
                self.addr_by_id.setdefault(did, f"{ph}:{pp}")
                self._peer_clients[did] = pc
                registered = True
                seed_fn(pc)
            finally:
                if not registered:
                    pc.close()

    def account(self, acks) -> int:
        """Take one feed pass's acks into the row accounting and register
        the daemons that hold its rows as peers; returns the pass's rows.
        Fences a restart under the scan (an incarnation change) and an
        alias of the primary; a daemon whose partitions were all empty
        created no job and is no peer. Rows acked by a quarantined daemon
        are refused: it is alive with state no rewind reached."""
        n, per, addr_of, _, boots = _ack_rows(acks)
        for did, cnt in per.items():
            if cnt > 0 and did in self.quarantined:
                raise RuntimeError(
                    f"daemon {addr_of[did]} ({did}) was declared dead and quarantined, yet "
                    f"acked {cnt} rows of the replayed pass: it is alive and holds un-rewound "
                    "state. Stop routing executors to it (it left this fit for good), or "
                    "refit.")
        for did, cnt in per.items():
            self.fed_by_daemon[did] = self.fed_by_daemon.get(did, 0) + cnt
            self.addr_by_id.setdefault(did, addr_of[did])
            if cnt == 0 or did == self.primary_id or did in self.peers:
                continue
            # An unknown id AT the primary's address, or the one the live
            # primary now answers with, is the primary restarted: fence it
            # (a peer of it would export the primary into itself).
            if addr_of[did] == self.address or did == (
                self.client.server_id() or self.primary_id
            ):
                raise _incarnation_change(addr_of[did], {self.primary_id, did})
            # Instance ids are opaque hex: a ":" is the address fallback of
            # a daemon that reports no id, which predates the peer ops and
            # whose aliases cannot be told apart.
            if ":" in did or ":" in self.primary_id:
                raise RuntimeError(
                    f"task acks name a second daemon ({addr_of[did]} vs primary "
                    f"{self.address}) but at least one daemon does not report an instance "
                    "id — it predates the multi-host data plane. Upgrade every daemon, or "
                    "unify the daemon address spelling and use one daemon.")
            self.peers[did] = daemon_session._parse_addr(addr_of[did])
        # A joiner's first acked pass since admission is the rebalance: the
        # rows the task layer moved onto it.
        for did in sorted(self._awaiting_rebalance):
            if per.get(did, 0) > 0:
                _M_FIT_REBALANCED.inc(per[did], algo=self.algo)
                self._awaiting_rebalance.discard(did)
        # After the registration (recover() must know every daemon the pass
        # touched) and before any merge: partials of a daemon that restarted
        # under the scan are partial in an unknowable way.
        for did, bs in boots.items():
            if len(bs) > 1:
                raise _incarnation_change(addr_of.get(did, did), bs)
        self.total_fed += n
        self.last_acks = acks
        return n

    def reduce_peers(self, drop_peer: bool = False) -> None:
        """Fold the last scan's peer partials into the primary: the
        collective reduce, else the hub. ``drop_peer`` (the single-pass
        algos) drops the peers' jobs once folded."""
        _, per, addr_of, owner, boots = _ack_rows(self.last_acks)
        with trace_span("merge peers"):
            if not self._reduce_on_mesh(per, addr_of, owner, boots, drop_peer):
                self._merge_peer_daemons(per, addr_of, owner, drop_peer)

    def _reduce_on_mesh(self, per, addr_of, owner, boots, drop_peer) -> bool:
        """The collective-first pass reduce: when the primary and every peer
        that holds rows of the pass are members of one device plane
        (daemons in one process, registered in
        ``parallel/membership.registry()``), ONE ``reduce_mesh`` op folds
        the peers' partials on the device and the O(d²) statistics never
        cross the wire. Returns True when the pass is reduced (or there was
        nothing to reduce), False to hand it to the hub
        (:meth:`_merge_peer_daemons`): a peer in another process, a daemon
        without the op, or ``mesh_collectives`` off.

        The split-brain accounting does not weaken on this path: the driver
        sends its task-ack view (rows and owned partitions of each peer)
        and the daemon checks it against each peer's live (boot, pass rows)
        before anything folds, refusing the whole reduce on a mismatch or a
        membership-epoch change. A co-resident peer that rebooted since the
        scan acked raises the incarnation fence here."""
        peer_rows = {d: n for d, n in per.items() if d != self.primary_id and n > 0}
        if not peer_rows:
            return True  # a single-daemon pass: nothing to reduce on any path
        if self._hub_only is None:
            self._hub_only = not bool(config.get("mesh_collectives"))
        if self._hub_only:
            _M_MESH_PATHS.inc(path="hub")
            return False
        # Two attempts: the epoch fence is process-wide, so an unrelated
        # daemon joining or leaving between mesh_info and the reduce refuses
        # it; one re-read checks every participant against the fresh epoch.
        # A second refusal (sustained churn) surfaces, and recovery treats
        # it as any daemon failure.
        for attempt in range(2):
            try:
                info = self.client.mesh_info()
            except Exception as e:
                logger.debug("mesh_info unavailable on the primary (%s); this fit uses the "
                             "driver-hub merge", e)
                self._hub_only = True
                _M_MESH_PATHS.inc(path="hub")
                return False
            members = {str(m["id"]): str(m["boot_id"]) for m in info.get("members", [])}
            if self.primary_id not in members:
                _M_MESH_PATHS.inc(path="hub")
                return False
            for did in sorted(peer_rows):
                if did not in members:
                    # A daemon of another process: the hub is the right path.
                    _M_MESH_PATHS.inc(path="hub")
                    return False
                ack_boot = next(iter(boots.get(did) or []), None)
                if ack_boot is not None and members[did] != ack_boot:
                    raise _incarnation_change(addr_of.get(did, did), {ack_boot, members[did]})
            peers = {
                did: {"boot_id": members[did], "rows": int(n),
                      "partitions": sorted(int(p) for p, d in owner.items() if d == did)}
                for did, n in peer_rows.items()
            }
            try:
                with trace_span("reduce mesh"):
                    self.client.reduce_mesh(self.job, epoch=int(info["epoch"]), peers=peers,
                                            algo=self.algo, params=self.params,
                                            drop_peers=drop_peer)
            except RuntimeError as e:
                if attempt == 0 and "membership changed" in str(e):
                    continue
                raise
            _M_MESH_PATHS.inc(path="collective")
            return True
        return False  # not reached: the second attempt returns or raises

    def _merge_peer_daemons(self, per, addr_of, owner, drop_peer) -> None:
        """The driver's hub: pull every peer daemon's committed partials
        (``export_state``) and fold them into the primary (``merge_state``),
        in sorted-id order. Each peer's export is held to what its tasks
        acked BEFORE it folds, per partition, so a cross-daemon retry orphan
        or a lost partition is named, and a short or overfull peer fails the
        fit instead of corrupting it."""
        for did, fed in sorted(per.items()):
            if did == self.primary_id or fed == 0:
                continue
            addr = addr_of[did]
            peer = self.peer_client(did)
            with trace_span("export state"):
                arrays, meta = peer.export_state(self.job)
            if drop_peer:
                peer.drop(self.job)
            committed = {int(p): int(n) for p, n in (meta.get("committed") or {}).items()}
            owned = {p for p, d in owner.items() if d == did}
            orphans = sorted(p for p in committed if p not in owned)
            lost = sorted(p for p in owned if p not in committed)
            if int(meta["pass_rows"]) != fed or orphans or lost:
                parts = []
                if orphans:
                    parts.append(f"partitions {orphans} committed here but acked on another "
                                 "daemon (cross-daemon retry orphans)")
                if lost:
                    parts.append(f"partitions {lost} acked here but not committed")
                raise _split_brain(f"peer daemon {addr} export", fed, int(meta["pass_rows"]),
                                   "; ".join(parts) or f"{addr}={fed}")
            with trace_span("merge state"):
                self.client.merge_state(self.job, arrays, rows=int(meta["pass_rows"]),
                                        algo=self.algo, n_cols=int(meta["n_cols"]),
                                        params=self.params)

    def _fed_detail(self) -> str:
        return ", ".join(f"{self.addr_by_id.get(d, d)}={c}"
                         for d, c in sorted(self.fed_by_daemon.items())) or "no acks"

    def scan(self, run_pass: Callable[[Optional[int]], Any], pass_id: Optional[int],
             drop_peer: bool = False, merge: bool = True) -> int:
        """One executor scan (``run_pass(pass_id)`` returns its acks) taken
        into the accounting, then the peer reduce (``merge``; a knn scan
        builds a shard per daemon instead); returns its rows. An empty scan
        is refused."""
        with trace_span("feed pass"):
            acks = run_pass(pass_id)
        n = self.account(acks)
        if n == 0:
            raise ValueError("cannot fit on an empty DataFrame")
        if merge:
            self.reduce_peers(drop_peer)
        return n

    def step(self, pass_id: int, n: int, params: Optional[dict] = None) -> Dict[str, Any]:
        """The pass boundary of an iterative fit: ``step`` over the scan of
        ``n`` rows, held to it (a job resurrected mid-pass answers short
        instead of stepping on partial sums), then the stepped iterate
        pushed to every peer and the ledger record. Inside the recovery
        unit: a daemon dying here rewinds to the previous boundary."""
        with trace_span("step"):
            info = self.client.step(self.job, params=params)
        if int(info["pass_rows"]) != n:
            raise _split_brain(f"step (pass {pass_id})", n, int(info["pass_rows"]),
                               self._fed_detail())
        # Converged logreg: nothing reads a peer's iterate again, but the
        # ledger still records this one (a finalize replay rewinds to it).
        self.sync_peers(self.push_tol is None or float(info["delta"]) > self.push_tol)
        self.record()
        return info

    def sync_peers(self, push: bool = True) -> None:
        """Push the primary's iterate to every peer (``set_iterate``, which
        opens the pass there), from one ``get_iterate`` that :meth:`record`
        reuses."""
        self._pulled = None
        if push and self.peers:
            with trace_span("sync peers"):
                arrays, iteration = self._pulled = self.client.get_iterate(self.job)
                for did in sorted(self.peers):
                    self.peer_client(did).set_iterate(self.job, arrays, iteration)

    def record(self) -> None:
        """Snapshot the iterate into the ledger (:attr:`ledger_on` only). It
        runs after :meth:`sync_peers`: the ledger advances only once every
        daemon holds the new boundary, so a half-pushed boundary replays
        from the old one."""
        if self.ledger_on:
            self.ledger = self._pulled or self.client.get_iterate(self.job)
        self._pulled = None

    def finalize_guarded(self, params: dict, pass_rows_expected: Optional[int] = None):
        """Finalize with the split-brain row guard: the daemon's total must
        equal what the tasks acked (and ``pass_rows_expected`` the current
        pass's rows: the kmeans cost reads that pass). Finalize with
        drop=False, check, THEN drop, so a failed guard leaves the job for a
        replay. Returns (arrays, rows)."""
        with trace_span("finalize"):
            arrays, fin_rows, meta = self.client.finalize(self.job, params, drop=False,
                                                          with_meta=True)
        if fin_rows != self.total_fed:
            raise _split_brain("finalize", self.total_fed, fin_rows, self._fed_detail())
        if (
            pass_rows_expected is not None
            and meta.get("pass_rows") is not None
            and int(meta["pass_rows"]) != int(pass_rows_expected)
        ):
            raise _split_brain("finalize (current pass)", int(pass_rows_expected),
                               int(meta["pass_rows"]), self._fed_detail())
        _drop_quietly(self.client, self.job, "finalize")
        return arrays, fin_rows

    def recover(self, err: Exception) -> None:
        """Rewind every daemon to the last pass boundary. With a ledger,
        reinstall its iterate on the primary and on every peer with a
        creating ``set_iterate`` (which discards the failed pass's state,
        or rebuilds a job a daemon lost) and resync the row accounting from
        the primary's ``status``; without one (a single-pass fit, or pass 0
        of a logreg fit), drop the job everywhere and let the replay feed
        it anew. A restarted primary's new identity becomes the primary's."""
        _M_FIT_RECOVERIES.inc(algo=self.algo)
        logger.warning("fit recovery (%s): replaying from the last pass boundary after: %s",
                       self.algo, err)
        journal.mark("fit recovery", algo=self.algo, job=self.job, error=str(err)[:300])
        with trace_span("recovery"):
            new_id = self.client.server_id() or self.primary_id
            if new_id != self.primary_id:
                self.addr_by_id[new_id] = self.address
                self.peers.pop(new_id, None)
                self.primary_id = new_id
            if self.ledger is not None:
                arrays, iteration = self.ledger
                n_cols = _iterate_width(arrays)
                for c in [self.client] + [self.peer_client(d) for d in sorted(self.peers)]:
                    c.set_iterate(self.job, arrays, iteration, algo=self.algo, n_cols=n_cols,
                                  params=self.params)
                self.total_fed = int(self.client.status(self.job)["rows"])
            else:
                for c in [self.client] + [self.peer_client(d) for d in sorted(self.peers)]:
                    _drop_quietly(c, self.job, "recovery")
                self.total_fed = 0
            self.fed_by_daemon.clear()

    def _probe_alive(self, addr: Tuple[str, int]) -> bool:
        """The death policy's liveness verdict: one ping whose op deadline is
        the death timeout, with at least 8 attempts, so a slow or busy
        daemon that answers within the whole budget is never declared
        dead on a hunch."""
        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        kw = dict(self._client_kw)
        kw["op_deadline_s"] = self.death_timeout_s
        kw["max_op_attempts"] = max(int(kw.get("max_op_attempts", 5)), 8)
        try:
            with DataPlaneClient(*addr, token=self._token, **kw) as pc:
                pc.ping()
            return True
        except Exception:
            return False

    def try_admit(self, err: Exception) -> bool:
        """The grow policy's admission step, run only after a unit failed
        (a joiner's refusal of its unseeded feeds is the signal). Re-reads
        the configured daemons (``daemon_session.resolve_all``: dynamic
        allocation re-points ``spark.srml.daemon.addresses``), skips the
        addresses and ids this fit knows (an alias of a known daemon, a
        quarantined one), and admits each new daemon at the current pass
        boundary: a creating ``set_iterate`` of the ledger's iterate, after
        which, and only after which, it is a peer. A joiner that fails the
        handshake is never half-joined. True: at least one admitted (the
        caller rewinds and replays); False: nothing new appeared. Past
        ``join_limit`` joins it raises."""
        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        if not self.grow or self.ledger is None:
            # No boundary iterate to seed a joiner from: a single-pass fit
            # registers an unknown daemon from its acks anyway.
            return False
        known = {self.address}
        known.update(f"{h}:{p}" for h, p in self.peers.values())
        known.update(a for a in self.quarantined.values() if a)
        known.update(self.joined.values())
        admitted = 0
        for ph, pp in daemon_session.resolve_all(self.spark):
            addr = f"{ph}:{pp}"
            if addr in known:
                continue
            pc = DataPlaneClient(ph, pp, token=self._token, **self._client_kw)
            registered = False
            try:
                try:
                    did = pc.server_id()
                except Exception:
                    continue  # configured but not up yet
                # An unknown address may still spell a daemon this fit knows.
                if not did or did == self.primary_id or did in self.peers \
                        or did in self.quarantined:
                    continue
                if len(self.joined) + 1 > self.join_limit:
                    raise RuntimeError(
                        f"daemon {addr} ({did}) appeared mid-fit but this fit's join budget "
                        f"is spent (fit_daemon_join_limit={self.join_limit}, "
                        f"{len(self.joined)} already admitted). Raise the limit, or stop "
                        "routing executors to it until the next fit.") from err
                # The admission handshake: nothing is registered until the
                # joiner holds the boundary iterate.
                faults.checkpoint("daemon.join")
                arrays, iteration = self.ledger
                pc.set_iterate(self.job, arrays, int(iteration), algo=self.algo,
                               n_cols=_iterate_width(arrays), params=self.params)
                self.peers[did] = (ph, pp)
                self.addr_by_id[did] = addr
                self._peer_clients[did] = pc
                registered = True
                self.joined[did] = addr
                self._awaiting_rebalance.add(did)
                admitted += 1
                _M_FIT_JOINS.inc(algo=self.algo)
                journal.mark("fit daemon join", algo=self.algo, job=self.job, daemon=did,
                             addr=addr, iteration=int(iteration))
                logger.warning(
                    "fit elastic grow (%s): daemon %s (%s) admitted at the pass-%d boundary — "
                    "seeded with the ledger iterate; replaying the failed pass on the "
                    "%d-daemon topology", self.algo, addr, did, int(iteration),
                    len(self.peers) + 1)
            finally:
                if not registered:
                    pc.close()
        return admitted > 0

    def try_quarantine(self, err: Exception) -> bool:
        """The death policy's classification step, run only after a unit
        failed: the primary and every peer are probed concurrently within
        the death deadline, and on the collective path the mesh membership
        is a second witness (a live member is not dead, whatever its
        probe). A dead primary raises (it holds the folded state: no
        amputation survives it); dead peers past the loss budget raise;
        otherwise each dead peer is quarantined: out of ``peers``, its
        client closed, its id-cache route evicted, the loss counted. True:
        at least one quarantined (the caller rewinds and replays)."""
        from concurrent.futures import ThreadPoolExecutor

        if not self.peers:
            return False
        live_members = None
        if not self._hub_only:
            try:
                live_members = {str(m["id"]) for m in self.client.mesh_info().get("members", [])}
            except Exception:
                live_members = None
        with ThreadPoolExecutor(max_workers=min(len(self.peers) + 1, 16)) as ex:
            primary = ex.submit(self._probe_alive, self.client._addr)
            probes = {did: ex.submit(self._probe_alive, self.peers[did])
                      for did in sorted(self.peers)}
            primary_ok = primary.result()
            alive = {did: f.result() for did, f in probes.items()}
        if not primary_ok:
            raise RuntimeError(
                f"primary daemon {self.address} is unreachable (no answer within the "
                f"{self.death_timeout_s:.1f}s death deadline): elastic degrade can only "
                "amputate PEER daemons — the primary holds the folded state. Restart it "
                "(crash recovery resurrects durable jobs) or refit.") from err
        dead = []
        for did in sorted(self.peers):
            if alive[did]:
                continue
            if live_members is not None and did in live_members:
                logger.warning("peer daemon %s failed its liveness probe but is still a live "
                               "mesh member — treating the failure as transient, not a death",
                               self.addr_by_id.get(did, did))
                continue
            dead.append(did)
        if not dead:
            return False
        if len(self.quarantined) + len(dead) > self.loss_tolerance:
            raise RuntimeError(
                f"daemon(s) {[self.addr_by_id.get(d, d) for d in dead]} gave no answer within "
                f"the {self.death_timeout_s:.1f}s death deadline, but this fit's loss budget is "
                f"spent (fit_daemon_loss_tolerance={self.loss_tolerance}, "
                f"{len(self.quarantined)} already quarantined). Raise the tolerance, or refit "
                "on the surviving daemons.") from err
        for did in dead:
            addr = self.addr_by_id.get(did)
            self.quarantined[did] = addr
            self.peers.pop(did, None)
            pc = self._peer_clients.pop(did, None)
            if pc is not None:
                pc.close()
            if addr is not None:
                # The replayed tasks must re-ping whatever now answers there.
                _evict_daemon_id_cache(self.job, addr)
            _M_DAEMON_LOSSES.inc(algo=self.algo)
            journal.mark("fit daemon loss", algo=self.algo, job=self.job, daemon=did, addr=addr)
            logger.warning(
                "fit elastic degrade (%s): peer daemon %s (%s) declared dead — no answer "
                "within the %.1fs death deadline; quarantining it and replaying from the last "
                "pass boundary with its partitions rerouted to the %d survivor(s)", self.algo,
                addr, did, self.death_timeout_s, len(self.peers) + 1)
        return True

    def with_recovery(self, body: Callable[[], Any]):
        """Run ``body`` (one pass-boundary unit: scan + step, or scan +
        finalize) under the bounded replay loop. Deterministic driver-side
        errors (validation, config, refusals) are never replayed. A daemon
        or task failure is first offered to the grow policy (an unadmitted
        newcomer), then to the death policy (a dead peer); either heals it
        with a rewind and a replay bounded by its own budget. Otherwise
        the transient replay runs, ``recovery_attempts`` times."""
        attempt = 0
        while True:
            try:
                return body()
            except (ValueError, TypeError, KeyError, AttributeError, AssertionError,
                    NotImplementedError):
                raise
            except Exception as e:
                if self.grow and self.try_admit(e):
                    with trace_span("elastic grow"):
                        journal.mark("fit elastic-grow", algo=self.algo, job=self.job,
                                     error=str(e)[:300])
                        self.recover(e)
                    continue
                if self.loss_tolerance > 0 and self.try_quarantine(e):
                    with trace_span("elastic degrade"):
                        _M_FIT_REROUTES.inc(algo=self.algo)
                        journal.mark("fit elastic-degrade", algo=self.algo, job=self.job,
                                     error=str(e)[:300])
                        self.recover(e)
                    continue
                if attempt >= self.recovery_attempts:
                    raise
                attempt += 1
                self.recover(e)

    def close(self) -> None:
        """Drop the fit's job on the primary and on every peer (a no-op
        where a finalize or a reduce already dropped it), and close every
        client."""
        _drop_quietly(self.client, self.job, "primary")
        self.client.close()
        for did in list(self.peers):
            try:
                _drop_quietly(self.peer_client(did), self.job, "peer")
            except Exception as e:  # peer_client() itself can fail
                logger.debug("cleanup drop on peer %s failed: %s", did, e)
        for pc in self._peer_clients.values():
            pc.close()


def _pca_model(arrays: dict, device=None) -> PCAModel:
    """The fitted ``PCAModel`` of a PCA finalize's arrays."""
    return PCAModel(pc=arrays["pc"], explained_variance=arrays["explained_variance"],
                    mean=arrays["mean"], device=device)


# The driver loops. Each takes the fit, ``run_pass(pass_id) -> acks`` and
# the core estimator whose params it reads, and returns the fitted core
# model with its summary.


def _drive_pca(fit: _DaemonFit, run_pass, core) -> PCAModel:
    fit.algo = "pca"
    params = {"k": core.getK(), "mean_center": core.getMeanCentering(),
              "solver": core.getSolver()}

    def shot():
        n = fit.scan(run_pass, None, drop_peer=True)
        return fit.finalize_guarded(params, pass_rows_expected=n)

    arrays, _ = fit.with_recovery(shot)
    return _pca_model(arrays, device=core._device)


def _drive_scaler(fit: _DaemonFit, run_pass, core) -> StandardScalerModel:
    """One scan into a pca job, finalized to its raw moments (count, Σx,
    diag XᵀX; no eigensolve), then the host float64 mean and unbiased std,
    as the reference's scaler fit."""
    fit.algo = "pca"

    def shot():
        n = fit.scan(run_pass, None, drop_peer=True)
        return fit.finalize_guarded({"raw_moments": True}, pass_rows_expected=n)

    arrays, _ = fit.with_recovery(shot)
    mean, std = finalize_moments(float(arrays["count"][0]), arrays["colsum"],
                                 arrays["gram_diag"])
    return StandardScalerModel(mean=mean, std=std, device=core._device)


def _drive_linreg(fit: _DaemonFit, run_pass, core) -> "_lr.LinearRegressionModel":
    fit.algo = "linreg"
    params = {"reg": core.getRegParam(), "elastic_net": core.getElasticNetParam(),
              "fit_intercept": core.getFitIntercept(), "max_iter": core.getMaxIter(),
              "tol": core.getTol()}

    def shot():
        n = fit.scan(run_pass, None, drop_peer=True)
        return fit.finalize_guarded(params, pass_rows_expected=n)

    arrays, rows = fit.with_recovery(shot)
    model = _lr.LinearRegressionModel(coefficients=arrays["coefficients"],
                                      intercept=float(arrays["intercept"][0]),
                                      device=core._device)
    # rss and tss are not on the wire: the finalize sends rmse and r2.
    model._summary = _lr.LinearRegressionTrainingSummary(
        rmse=float(arrays["rmse"][0]), r2=float(arrays["r2"][0]), rss=float("nan"),
        tss=float("nan"), n_rows=rows)
    return model


def _kmeans_seed_rows(k: int) -> int:
    """Rows of the driver's seed sample: at least k, at most 4,096 unless k
    is larger, 32 per centre between."""
    return max(k, min(4096, 32 * k))


def _drive_kmeans(fit: _DaemonFit, run_pass, core,
                  seed_sample: np.ndarray) -> "_km.KMeansModel":
    """Seed the centres from ``seed_sample`` (an (n, d) array sent as raw
    frames) on the primary and on every configured peer (the same rows and
    generator seed, so every daemon opens pass 0 at the same centres; a
    peer not configured fails its tasks loudly), then passes of scan +
    step until moved² <= tol² or maxIter, then one cost-only scan at the
    final centres and the guarded finalize."""
    k = core.getK()
    fit.algo, fit.params = "kmeans", {"k": k, "seed": core.getSeed(), "init": core.getInitMode()}
    if seed_sample.shape[0] == 0:
        raise ValueError("cannot fit on an empty DataFrame")
    with trace_span("seed"):
        fit.client.seed_kmeans_raw(fit.job, seed_sample, k=k, params=fit.params)
        fit.seed_peers(lambda pc: pc.seed_kmeans_raw(fit.job, seed_sample, k=k,
                                                     params=fit.params))
    fit.record()  # pass 0 opens with the seeded centres: a pass-0 replay reinstalls them
    tol2 = core.getTol() ** 2
    info = {"iteration": 0}

    def kmeans_pass(pass_id):
        return fit.step(pass_id, fit.scan(run_pass, pass_id))

    for it in range(core.getMaxIter()):
        info = fit.with_recovery(lambda pid=it: kmeans_pass(pid))
        if info["moved2"] <= tol2:
            break

    # The step's cost is at the centres it moved from: the final cost is one
    # unstepped scan at the final centres, read by finalize.
    def final():
        n = fit.scan(run_pass, info["iteration"])
        return n, fit.finalize_guarded({}, pass_rows_expected=n)[0]

    n_rows, arrays = fit.with_recovery(final)
    cost = float(arrays["cost"][0])
    model = _km.KMeansModel(centers=arrays["centers"], device=core._device)
    model._training_cost = cost
    model._n_iter = int(info["iteration"])
    model._summary = _km.KMeansSummary(trainingCost=cost, numIter=int(info["iteration"]),
                                       k=k, n_rows=n_rows)
    return model


def _drive_logreg(fit: _DaemonFit, run_pass, core,
                  n_classes: int) -> "_lg.LogisticRegressionModel":
    """Newton (binary) or MM-Newton (``n_classes`` > 2) passes of scan +
    step until delta <= tol or maxIter, then the guarded finalize. Peers
    are found in pass 0's acks (every daemon opens at the zero iterate)
    and get the stepped iterate until the step converges."""
    fit.algo, fit.params = "logreg", {"n_classes": int(n_classes)}
    fit.push_tol = core.getTol()
    step_params = {"reg": core.getRegParam(), "fit_intercept": core.getFitIntercept()}
    info = {"loss": float("nan"), "iteration": 0}
    rows, history = 0, []

    def logreg_pass(pass_id):
        n = fit.scan(run_pass, pass_id)
        return n, fit.step(pass_id, n, step_params)

    for it in range(core.getMaxIter()):
        rows, info = fit.with_recovery(lambda pid=it: logreg_pass(pid))
        history.append(float(info["loss"]))
        if info["delta"] <= core.getTol():
            break
    arrays, _ = fit.with_recovery(lambda: fit.finalize_guarded({}))
    coef = arrays["coefficients"]
    model = _lg.LogisticRegressionModel(
        coefficients=coef,
        # Binary: a scalar; multinomial ((C, d) coefficients): (C,).
        intercept=float(arrays["intercept"][0]) if coef.ndim == 1 else arrays["intercept"],
        device=core._device,
    )
    model._summary = _lg.LogisticTrainingSummary(
        loss=float(info["loss"]), numIter=int(info["iteration"]), n_rows=rows,
        objectiveHistory=tuple(history))
    return model


def _forest_params(core, n_classes: int) -> Dict[str, Any]:
    """The rf job's creation params from a forest estimator's (the
    reference's eight feed params); ``n_classes`` 0 is a regressor."""
    return {"num_trees": core.getNumTrees(), "max_depth": core.getMaxDepth(),
            "max_bins": core.getMaxBins(), "n_classes": int(n_classes),
            "subset": core.getFeatureSubsetStrategy(), "seed": core.getSeed(),
            "bootstrap": core.getBootstrap(), "min_instances": core.getMinInstancesPerNode()}


def _drive_forest(fit: _DaemonFit, run_pass, core, sample: np.ndarray,
                  n_classes: int) -> "_rf._ForestModelBase":
    """Install the forest's depth-0 iterate (quantile bin edges of the
    driver's prefix ``sample``, every root open) with a creating
    ``set_iterate`` on the primary and on every configured peer, then one
    pass of scan + step per depth until no node is open (at most maxDepth +
    1), then the guarded finalize. Each daemon bins every row against
    those edges and keys its bags by the row's (partition, offset), so the
    forest depends neither on the order the tasks' feeds and commits
    arrive in, nor on a task's retries, nor on which daemon a partition
    fed: its histogram sums are the one-daemon fit's."""
    fit.algo, fit.params = "rf", _forest_params(core, n_classes)
    sample = np.asarray(sample)
    if sample.shape[0] == 0:
        raise ValueError("cannot fit on an empty DataFrame")
    d = int(sample.shape[1])
    spec = _rf.forest_spec_from_params(fit.params, d)
    arrays = _rf.init_forest_arrays(spec, quantile_bin_edges(sample, spec.max_bins))
    with trace_span("seed"):
        fit.client.set_iterate(fit.job, arrays, 0, algo="rf", n_cols=d, params=fit.params)
        fit.seed_peers(lambda pc: pc.set_iterate(fit.job, arrays, 0, algo="rf", n_cols=d,
                                                 params=fit.params))
    fit.record()  # pass 0 opens with the empty trees: a pass-0 replay reinstalls them

    def forest_pass(pass_id):
        return fit.step(pass_id, fit.scan(run_pass, pass_id))

    for it in range(spec.max_depth + 1):
        info = fit.with_recovery(lambda pid=it: forest_pass(pid))
        if int(info["open_nodes"]) == 0:
            break
    arrays, _ = fit.with_recovery(lambda: fit.finalize_guarded({}))
    arrays = dict(arrays)
    arrays.pop("n_iter", None)
    return core._model_cls(arrays=arrays, device=core._device)


def _drive_knn(fit: _DaemonFit, run_pass, core) -> "_DaemonKNNModel":
    """One scan into a knn job, then the finalize that BUILDS the index on
    the daemon and registers it as ``knnidx-<job>``: exact for a
    ``NearestNeighbors`` core, IVF (the core's nlist, nprobe, seed) for an
    ``ApproximateNearestNeighbors``. The dataset never reaches the driver,
    nor does the index, which is as large.

    A scan whose acks name several daemons builds a SHARDED index: each
    daemon builds and serves the shard of its own committed partitions,
    its ids translated to global partition-major positions through the
    driver's ``row_id_base``, and the handle's ``kneighbors`` fans a query
    batch out to every shard and merges the top-k
    (:func:`_fanout_kneighbors`). IVF shards bucket against ONE quantizer:
    the first daemon's build trains it on a sample drawn from every daemon
    in proportion to its rows (``sample_rows``, min(rows, max(64·nlist,
    4096), 65,536) in all) and returns the (nlist, d) centroids, against
    which the others build, so the union of the shards' probes is the one
    index's candidate set. Each shard's rows are held to its acks, and on
    any failure every daemon's job and shard are dropped at once: both are
    dataset-sized.

    No elastic loop runs here, as in the reference's knn fit: every shard
    IS its daemon's rows, so a daemon lost during the fit fails it loudly
    whatever the loss tolerance or join policy."""
    import contextlib
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

    fit.algo = "knn"
    ivf = core.hasParam("nlist")
    metric = core.getMetric()
    if ivf and metric == "inner_product":
        raise ValueError("metric='inner_product' is supported by the exact NearestNeighbors only")
    name = f"knnidx-{fit.job}"
    fed: Dict[str, int] = {}
    addr_of: Dict[str, str] = {}
    # The shard builds and samples run on pool threads, whose journal stack
    # is empty: they carry the driver's fit frame, or the daemons' heaviest
    # spans (index builds, sampling) fall out of the fit's tree.
    fit_ctx = journal.trace_ctx() or {}

    @contextlib.contextmanager
    def client_of(did):
        # The primary's own client (one thread uses it at a time) under the
        # fit's frame, else a client of the peer's own stamping it: no
        # socket is shared across threads.
        if did == fit.primary_id:
            with journal.adopt(fit_ctx.get("run"), fit_ctx.get("span")):
                yield fit.client
            return
        with DataPlaneClient(*daemon_session._parse_addr(addr_of[did]), token=fit._token,
                             trace_ctx=fit_ctx or None, **fit._client_kw) as c:
            yield c

    def cleanup():
        # Free the dataset-sized state BEFORE failing: a knn job or shard
        # holds the raw rows, and leaking them until the TTL on every
        # daemon could exhaust the memory of the corrected refit.
        for did in fed or {fit.primary_id: 0}:
            try:
                with client_of(did) as c:
                    _drop_quietly(c, fit.job, "knn cleanup")
                    c.drop_model(name)
            except Exception as e:
                logger.debug("knn cleanup on %s failed: %s", addr_of.get(did, did), e)

    shards = []
    try:
        fit.scan(run_pass, None, merge=False)
        total = fit.total_fed
        _, per, addr_of, _, _ = _ack_rows(fit.last_acks)
        fed = {d: n for d, n in per.items() if n > 0}
        multi = len(fed) > 1
        # Global ids are partition-major positions of the fitted DataFrame
        # (the one-daemon convention); each shard maps its local positions
        # through this base of every partition.
        part_rows = {int(r["partition"]): int(r["rows"]) for r in fit.last_acks
                     if int(r["rows"]) > 0}
        id_base, cum = {}, 0
        for pid in sorted(part_rows):
            id_base[pid] = cum
            cum += part_rows[pid]
        # The primary first (the quantizer's owner), then the peers by id.
        daemon_ids = sorted(fed, key=lambda d: (d != fit.primary_id, d))

        def finalize_shard(did, centroids=None, first=False, train_rows_sample=None):
            with client_of(did) as c:
                if ivf:
                    info = c.finalize_knn(
                        fit.job, register_as=name, mode="ivf", nlist=core.getNlist(),
                        nprobe=core.getNprobe(), seed=core.getSeed(), metric=metric,
                        row_id_base=id_base if multi else None, centroids=centroids,
                        return_centroids=multi and first, train_rows_sample=train_rows_sample)
                else:
                    info = c.finalize_knn(fit.job, register_as=name, mode="exact",
                                          metric=metric, row_id_base=id_base if multi else None)
            n_shard = int(info["n_rows"][0])
            if n_shard != fed[did]:
                raise _split_brain(f"knn shard build on {addr_of[did]}", fed[did], n_shard,
                                   ", ".join(f"{addr_of[d]}={n}" for d, n in sorted(fed.items())))
            return info, (addr_of[did], n_shard)

        with trace_span("knn build"):
            if ivf and multi:
                with trace_span("quantizer sample"):
                    want = min(total, max(64 * core.getNlist(), 4096), 65536)

                    def sample_shard(i, did):
                        # A ceiling split: the union never rounds below want.
                        with client_of(did) as c:
                            return c.sample_rows(fit.job, (want * fed[did] + total - 1) // total,
                                                 seed=core.getSeed() + i)

                    # Concurrent reads, gathered in daemon order: the union,
                    # and so the quantizer, is deterministic.
                    with ThreadPoolExecutor(max_workers=min(len(daemon_ids), 16)) as ex:
                        futs = [ex.submit(sample_shard, i, did)
                                for i, did in enumerate(daemon_ids)]
                        train_sample = np.concatenate([f.result() for f in futs], axis=0)
                # The owner's build runs first; the others then build
                # concurrently against its centroids.
                first_info, first_shard = finalize_shard(daemon_ids[0], first=True,
                                                         train_rows_sample=train_sample)
                shards.append(first_shard)
                rest = daemon_ids[1:]
                with ThreadPoolExecutor(max_workers=min(len(rest), 16)) as ex:
                    futs = [ex.submit(finalize_shard, did, first_info["centroids"])
                            for did in rest]
                    shards.extend(f.result()[1] for f in futs)
            else:
                with ThreadPoolExecutor(max_workers=min(len(daemon_ids), 16)) as ex:
                    futs = [ex.submit(finalize_shard, did) for did in daemon_ids]
                    shards.extend(f.result()[1] for f in futs)
        built = sum(n for _, n in shards)
        if built != total:
            raise _split_brain("knn index build", total, built,
                               ", ".join(f"{a}={n}" for a, n in shards))
    except BaseException:
        cleanup()
        raise
    if multi:
        host, port = fit.client._addr
    else:
        # One daemon holds the whole index, perhaps not the driver's (every
        # executor fed another): the handle queries and frees it THERE.
        host, port = daemon_session._parse_addr(shards[0][0])
    return _DaemonKNNModel(core, host, port, fit._token, name, n_rows=total,
                           input_col=_features_col(core), shards=shards if multi else None,
                           client_kw=fit._client_kw)


class _SparkAdapter:
    """Wraps a core estimator class with Spark DataFrame in/out. Other
    datasets pass straight to the core estimator, so the wrapper is a
    superset of the core API."""

    _core_cls = None  # override
    _daemon_algo: Optional[str] = None

    def __init__(self, **kwargs):
        self._core = type(self)._core_cls(**kwargs)

    def __getattr__(self, name):
        # Fluent setters return the wrapper; everything else passes through.
        attr = getattr(self._core, name)
        if callable(attr) and name.startswith("set"):
            def fluent(*a, **kw):
                attr(*a, **kw)
                return self

            return fluent
        return attr

    def fit(self, dataset):
        if _is_spark_df(dataset):
            core_model = self._fit_distributed(dataset)
            if self._daemon_algo == "knn":
                return core_model  # a handle of the daemon-resident index
        else:
            _check_not_orphan_spark_df(dataset)
            core_model = self._core.fit(dataset)
        return _SparkModelAdapter(core_model)

    def _fit_distributed(self, df):
        """The run journal's shell: one ``fit`` run a fit, every feed pass,
        step, merge and finalize span (the driver's, the tasks' daemons')
        under it; :meth:`_fit_distributed_inner` runs the protocol."""
        with journal.run("fit", estimator=type(self).__name__, algo=self._daemon_algo,
                         uid=self._core.uid):
            return self._fit_distributed_inner(df)

    def _fit_distributed_inner(self, df):
        """Executor-fed fit: partition batches flow task → daemon, and the
        driver sees only the finalize's arrays (and, for KMeans, a prefix
        sample of at most max(k, 4,096) rows to seed the centres; for the
        forests a prefix sample of at most ``forest_seed_sample_rows`` for
        the bin edges; for the nearest-neighbour estimators only the built
        index's row count)."""
        core = self._core
        algo = self._daemon_algo
        forest = algo in ("rf_classifier", "rf_regressor")
        # A scaler fit feeds the pca job protocol: its statistics are a
        # subset of PCA's. Both forests speak the one rf job protocol (the
        # params' n_classes picks Gini or variance splits).
        wire_algo = "pca" if algo == "scaler" else "rf" if forest else algo
        spark = getattr(df, "sparkSession", None)
        # Without a configured daemon this starts the driver's own on the
        # estimator's device (the card unless device="cpu"; raises without one).
        host, port, token = daemon_session.resolve(spark, device=core._device)
        ckw = daemon_session.client_kwargs(spark)
        job = f"{core.uid}-{uuid.uuid4().hex[:8]}"
        input_col = _features_col(core)
        label_col = core.getLabelCol() if algo in ("linreg", "logreg") or forest else None
        sel = df.select(*([input_col] + ([label_col] if label_col else [])))
        multi_pass = algo in ("kmeans", "logreg") or forest
        if multi_pass:
            sel = sel.persist()
        ds = daemon_session
        fit = _DaemonFit(host, port, job, token=token,
                         recovery_attempts=ds.recovery_attempts(spark), spark=spark,
                         loss_tolerance=ds.daemon_loss_tolerance(spark),
                         death_timeout_s=ds.daemon_death_timeout_s(spark),
                         join_policy=ds.daemon_join_policy(spark),
                         join_limit=ds.daemon_join_limit(spark), **ckw)
        try:

            def run_pass(pass_id):
                task = _FeedTask(host, port, token, job, wire_algo, input_col, pass_id,
                                 label_col=label_col, params=fit.params,
                                 evict_routes=fit.evict_routes())
                return sel.mapInArrow(task, _ACK_SCHEMA).collect()

            if algo == "knn":
                return _drive_knn(fit, run_pass, core)
            if algo == "pca":
                model = _drive_pca(fit, run_pass, core)
            elif algo == "scaler":
                model = _drive_scaler(fit, run_pass, core)
            elif algo == "linreg":
                model = _drive_linreg(fit, run_pass, core)
            elif algo == "kmeans":
                sample = _prefix_sample(sel, input_col, _kmeans_seed_rows(core.getK()))
                model = _drive_kmeans(fit, run_pass, core, sample)
            elif forest:
                n_classes = _probe_num_classes(sel, label_col) if algo == "rf_classifier" else 0
                sample = _prefix_sample(sel, input_col, int(config.get("forest_seed_sample_rows")))
                model = _drive_forest(fit, run_pass, core, sample, n_classes)
            else:
                model = _drive_logreg(fit, run_pass, core, _probe_num_classes(sel, label_col))
        finally:
            _evict_daemon_id_cache(job)
            fit.close()
            if multi_pass:
                sel.unpersist()
        model.uid = core.uid
        core._copy_params_to(model)
        return model


def _serve_spec(core_model):
    """(wire algo, [(role, output column, kind)]) of a model that declares
    the daemon serving contract (``_serve_algo``/``_serve_outputs``); None
    for a model without one."""
    algo = getattr(core_model, "_serve_algo", None)
    outs = getattr(core_model, "_serve_outputs", None)
    if not algo or not outs:
        return None
    return algo, [(role, core_model.getOrDefault(param), kind) for role, param, kind in outs]


def _scalar_params(core_model) -> Dict[str, Any]:
    """The model's serving params (``_serve_params``, e.g. the scaler's
    withMean/withStd): what a served copy needs to transform as the model
    does. Cosmetic params (column names) do not change the output and stay
    out, so they do not split the registry."""
    return {n: core_model.getOrDefault(n) for n in getattr(core_model, "_serve_params", ())}


def _model_fingerprint(core_model) -> str:
    """Content hash of the fitted arrays and the serving params: the
    registry key. Identical fits share a served copy; a refit, or a copy
    with other serving params, gets a fresh one."""
    import hashlib

    h = hashlib.md5()
    for k, v in sorted(core_model._model_data().items()):
        h.update(k.encode())
        if v is not None:
            h.update(np.ascontiguousarray(v).tobytes())
    for k, v in sorted(_scalar_params(core_model).items()):
        h.update(f"{k}={v!r}".encode())
    return h.hexdigest()[:12]


def _arrow_kind_type(kind):
    import pyarrow as pa

    return {"vec": pa.list_(pa.float64()), "ivec": pa.list_(pa.int64()), "int": pa.int32(),
            "double": pa.float64()}[kind]


def _output_column(vals, kind, n_rows):
    """One output column of its declared kind, whatever dtype the transform
    computed in: ``vec`` list<float64>, ``ivec`` list<int64>, ``int``
    int32, ``double`` float64."""
    import pyarrow as pa

    if n_rows == 0:
        return pa.array([], _arrow_kind_type(kind))
    if vals is None:
        raise RuntimeError(
            "daemon transform returned no array for a declared output role (client/daemon "
            "version skew?); upgrade the daemon or set SRML_TRANSFORM_LOCAL=1 to score "
            "executor-side"
        )
    if kind == "int":
        return pa.array(np.asarray(vals).astype(np.int32))
    if kind == "double":
        return pa.array(np.asarray(vals, dtype=np.float64))
    from spark_rapids_ml_tpu_torch.bridge.arrow import matrix_to_list_column

    vals = np.asarray(vals, dtype=np.int64 if kind == "ivec" else np.float64)
    return matrix_to_list_column(vals).cast(_arrow_kind_type(kind))


def _derive_output_schema(dataset, outputs):
    """Input schema + the declared output fields, without a Spark job.
    Stand-ins without a StructType schema get None (they ignore it)."""
    try:
        from pyspark.sql import types as T

        base = dataset.schema
    except (ImportError, AttributeError):
        return None
    out_names = {name for _, name, _ in outputs}
    fields = [f for f in base.fields if f.name not in out_names]
    spark_types = {"vec": lambda: T.ArrayType(T.DoubleType()),
                   "ivec": lambda: T.ArrayType(T.LongType()), "int": T.IntegerType,
                   "double": T.DoubleType}
    for _, name, kind in outputs:
        fields.append(T.StructField(name, spark_types[kind](), True))
    return T.StructType(fields)


def _append_outputs(table, role_arrays, outputs):
    """Append (or replace) the model's output columns on one batch table."""
    for role, colname, kind in outputs:
        if colname in table.column_names:
            table = table.drop_columns([colname])
        table = table.append_column(colname,
                                    _output_column(role_arrays.get(role), kind, table.num_rows))
    return table


class _TransformTask:
    """Executor-side CPU transform: the explicit path when no daemon should
    serve (``SRML_TRANSFORM_LOCAL=1``). The closure carries the model's
    class, uid and fitted arrays, never the model itself (whose projector
    cache may hold device tensors); the task rebuilds it with
    ``device="cpu"``."""

    def __init__(self, core_model, input_col, outputs):
        self._cls = type(core_model)
        self._uid = core_model.uid
        self._arrays = core_model._model_data()
        self._params = _scalar_params(core_model)
        self._input_col = input_col
        self._outputs = outputs

    def __call__(self, batches):
        import pyarrow as pa

        from spark_rapids_ml_tpu_torch.core.dataset import as_matrix

        model = self._cls._from_model_data(self._uid, self._arrays)
        model._device = "cpu"
        if self._params:
            model._set(**self._params)
        for batch in batches:
            table = pa.Table.from_batches([batch])
            if table.num_rows == 0:
                yield from _append_outputs(table, {}, self._outputs).to_batches()
                continue
            outs = model.transform_matrix(as_matrix(table, self._input_col))
            yield from _append_outputs(table, outs, self._outputs).to_batches()


class _DaemonTransformTask:
    """Executor-side feeder of the served transform: each batch's features
    go to the daemon's ``transform`` op and the outputs come back
    (RapidsPCA.scala:128-161 → rapidsml_jni.cu:75-107), the model
    registered once (``ensure_model``, with the serving params) and
    resident on the card across batches. Only the features column crosses
    the wire. The closure carries the model's ``_model_data()`` arrays,
    never the model, and the driver's journal frame (``trace_ctx``), which
    its client stamps."""

    def __init__(self, core_model, host, port, token, input_col, algo, outputs):
        self.host, self.port, self.token = host, port, token
        self.trace_ctx = journal.trace_ctx()
        self._arrays = core_model._model_data()
        self._params = _scalar_params(core_model)
        self._input_col = input_col
        self._algo = algo
        self._outputs = outputs
        self._name = f"{core_model.uid}-{_model_fingerprint(core_model)}"

    def __call__(self, batches):
        import pyarrow as pa

        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        ds = daemon_session
        h, p = ds.executor_daemon_address(self.host, self.port)
        with DataPlaneClient(h, p, token=self.token, trace_ctx=self.trace_ctx,
                             **ds.client_kwargs()) as c:
            registered = c.model_exists(self._name)
            for batch in batches:
                table = pa.Table.from_batches([batch])
                if table.num_rows == 0:
                    yield from _append_outputs(table, {}, self._outputs).to_batches()
                    continue
                if not registered:
                    c.ensure_model(self._name, self._algo, self._arrays, params=self._params)
                    registered = True
                features = table.select([self._input_col])
                try:
                    outs = c.transform(self._name, features, input_col=self._input_col)
                except RuntimeError as e:
                    if "no such model" not in str(e):
                        raise
                    # Registrations are TTL-evictable: register again, retry.
                    c.ensure_model(self._name, self._algo, self._arrays, params=self._params)
                    outs = c.transform(self._name, features, input_col=self._input_col)
                yield from _append_outputs(table, outs, self._outputs).to_batches()


class _SparkModelAdapter:
    """Wraps a fitted core model with Spark DataFrame transform."""

    def __init__(self, core_model):
        self._core = core_model

    def __getattr__(self, name):
        return getattr(self._core, name)

    def transform(self, dataset):
        if not _is_spark_df(dataset):
            _check_not_orphan_spark_df(dataset)
            return self._core.transform(dataset)
        core = self._core
        spec = _serve_spec(core)
        if not hasattr(dataset, "mapInArrow") or spec is None:
            # No collect-based path: every Spark code path keeps the
            # dataset off the driver (RapidsRowMatrix.scala:118-139).
            raise NotImplementedError(
                "distributed transform needs DataFrame.mapInArrow (pyspark >= 3.3) and a "
                "model with a serving contract; for in-memory data use the core "
                "estimators (spark_rapids_ml_tpu_torch.*) directly"
            )
        algo, outputs = spec
        input_col = _features_col(core)
        if os.environ.get("SRML_TRANSFORM_LOCAL", "").lower() in ("1", "true"):
            fn = _TransformTask(core, input_col, outputs)
        else:
            spark = getattr(dataset, "sparkSession", None)
            host, port, token = daemon_session.resolve(spark, device=core._device)
            fn = _DaemonTransformTask(core, host, port, token, input_col, algo, outputs)
        return dataset.mapInArrow(fn, _derive_output_schema(dataset, outputs))


#: The nearest-neighbour outputs: (role, column, kind).
_KNN_OUTPUTS = (
    ("distances", "knn_distances", "vec"),
    ("indices", "knn_indices", "ivec"),
)


def _fanout_kneighbors(ex, shard_clients, name, queries, k, input_col, descending,
                       raw=False):
    """Query every shard daemon concurrently and merge the top-k
    (``models/knn.merge_topk``, exact given exact shard answers): the one
    implementation of the executor task and the driver's handle. ``ex``: a
    caller-owned ThreadPoolExecutor; ``shard_clients``: [((addr, shard
    rows), client)], one client a shard (no socket shared across threads);
    ``raw`` sends the queries as a raw frame (an ndarray, no Arrow
    library) rather than Arrow. A batch waits for its slowest shard, not
    for the sum."""

    def one(entry):
        (_addr, n_shard), c = entry
        kk = min(k, n_shard)
        if raw:
            return c.kneighbors_raw(name, queries, k=kk)
        return c.kneighbors(name, queries, k=kk, input_col=input_col)

    results = list(ex.map(one, shard_clients))
    return _knn.merge_topk([d for d, _ in results], [i for _, i in results], k,
                           descending=descending)


class _DaemonKNNTask:
    """Executor-side query feeder: each batch's query rows go to the
    daemon's ``kneighbors`` op (Arrow) and the neighbour distance and index
    columns come back. The index stays on the daemon. A sharded index
    (``shards``: [(addr, shard rows)]) fans each batch out to every shard
    daemon and merges the shards' top-k here (:func:`_fanout_kneighbors`):
    O(q·k·shards) a batch, whatever the database's size. Its clients stamp
    the driver's journal frame (``trace_ctx``)."""

    def __init__(self, host, port, token, name, input_col, k, shards=None, descending=False):
        self.host, self.port, self.token = host, port, token
        self.trace_ctx = journal.trace_ctx()
        self._name = name
        self._input_col = input_col
        self._k = k
        self._shards = shards
        self._descending = descending

    def __call__(self, batches):
        import contextlib
        from concurrent.futures import ThreadPoolExecutor

        import pyarrow as pa

        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        ds = daemon_session
        with contextlib.ExitStack() as stack:
            ckw = dict(ds.client_kwargs(), trace_ctx=self.trace_ctx)
            if self._shards:
                clients = [(s, stack.enter_context(DataPlaneClient(
                    *ds._parse_addr(s[0]), token=self.token, **ckw))) for s in self._shards]
                ex = stack.enter_context(ThreadPoolExecutor(max_workers=min(len(clients), 16)))
            else:
                h, p = ds.executor_daemon_address(self.host, self.port)
                c = stack.enter_context(DataPlaneClient(h, p, token=self.token, **ckw))
            for batch in batches:
                table = pa.Table.from_batches([batch])
                if table.num_rows == 0:
                    yield from _append_outputs(table, {}, _KNN_OUTPUTS).to_batches()
                    continue
                q = table.select([self._input_col])
                if self._shards:
                    dists, idx = _fanout_kneighbors(ex, clients, self._name, q, self._k,
                                                    self._input_col, self._descending)
                else:
                    dists, idx = c.kneighbors(self._name, q, k=self._k,
                                              input_col=self._input_col)
                out = {"distances": dists, "indices": idx}
                yield from _append_outputs(table, out, _KNN_OUTPUTS).to_batches()


class _DaemonKNNModel:
    """A fitted nearest-neighbour handle whose index lives ON the daemon.

    For KNN the fitted model IS the dataset (BASELINE.json config #5:
    10M x 768 f32 is 31 GB), so it is served where it was built and never
    persisted from the driver; use the core estimators for an in-memory,
    persistable index. Indices are global partition-major row positions of
    the fitted DataFrame. An index built across daemons is served in
    shards, one a daemon (``shards``)."""

    def __init__(self, core, host, port, token, name, n_rows, input_col, shards=None,
                 client_kw=None):
        self._core = core  # the estimator: the param surface (k, metric, featuresCol)
        self._host, self._port, self._token = host, port, token
        self._name = name
        self._n_rows = n_rows
        self._input_col = input_col
        # [(addr, shard rows)] when the index spans daemons; None: one daemon.
        self._shards = shards
        # The fit's resilience tuning: the handle has no Spark session at
        # query time.
        self._client_kw = dict(client_kw or {})

    def __getattr__(self, name):
        return getattr(self._core, name)

    @property
    def daemon_model_name(self) -> str:
        return self._name

    @property
    def numRows(self) -> int:
        return self._n_rows

    @property
    def shards(self):
        """[(daemon address, rows served there)] of an index built across
        daemons; None when one daemon serves the whole index."""
        return None if self._shards is None else list(self._shards)

    def _descending(self) -> bool:
        return self._core.hasParam("metric") and self._core.getOrDefault("metric") == \
            "inner_product"

    def _client(self, host=None, port=None):
        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient

        # The caller's journal frame, fixed: the fan-out's pool threads stamp
        # it too.
        return DataPlaneClient(host or self._host, port or self._port, token=self._token,
                               trace_ctx=journal.trace_ctx(), **self._client_kw)

    def kneighbors(self, queries, k=None):
        """(distances (q, k), indices (q, k)) of an (q, d) ndarray of
        queries, sent as a raw frame (``kneighbors_raw``: the port's daemon
        reads it without an Arrow library on either side). A sharded index
        fans the batch out to every shard daemon and merges the top-k."""
        if _is_spark_df(queries):
            raise TypeError("pass a DataFrame to transform() for distributed queries; "
                            "kneighbors takes an (q, d) ndarray")
        k = self._core.getOrDefault("k") if k is None else k
        queries = np.asarray(queries)
        if self._shards is None:
            with self._client() as c:
                return c.kneighbors_raw(self._name, queries, k=k)
        import contextlib
        from concurrent.futures import ThreadPoolExecutor

        with contextlib.ExitStack() as stack:
            clients = [(s, stack.enter_context(self._client(*daemon_session._parse_addr(s[0]))))
                       for s in self._shards]
            ex = stack.enter_context(ThreadPoolExecutor(max_workers=min(len(clients), 16)))
            return _fanout_kneighbors(ex, clients, self._name, queries, k, self._input_col,
                                      self._descending(), raw=True)

    def transform(self, dataset):
        """Distributed query: appends knn_distances (list<double>) and
        knn_indices (list<long>) through ``mapInArrow`` tasks that query the
        daemon: no index download, no driver collect."""
        if not _is_spark_df(dataset):
            from spark_rapids_ml_tpu_torch.core.dataset import as_matrix, with_column

            dists, idx = self.kneighbors(as_matrix(dataset, self._input_col))
            return with_column(with_column(dataset, "knn_distances", dists), "knn_indices", idx)
        fn = _DaemonKNNTask(self._host, self._port, self._token, self._name, self._input_col,
                            self._core.getOrDefault("k"), shards=self._shards,
                            descending=self._descending())
        return dataset.mapInArrow(fn, _derive_output_schema(dataset, _KNN_OUTPUTS))

    def release(self) -> bool:
        """Free the daemon-resident index now (it is dataset-sized, and
        otherwise held until 8 times the daemon's TTL; a sharded index
        frees every shard). The handle is unusable afterwards."""
        addrs = ([(self._host, self._port)] if self._shards is None
                 else [daemon_session._parse_addr(a) for a, _ in self._shards])
        dropped = False
        for h, p in addrs:
            try:
                with self._client(h, p) as c:
                    dropped = c.drop_model(self._name) or dropped
            except OSError:
                continue  # the daemon is already gone: nothing to free there
        return dropped

    def write(self):
        raise NotImplementedError(
            "a daemon-resident KNN index is dataset-sized and cannot be persisted from the "
            "driver; fit the core (spark_rapids_ml_tpu_torch.NearestNeighbors / "
            "ApproximateNearestNeighbors) estimator on in-memory data for a persistable model"
        )


class SparkPCA(_SparkAdapter):
    """PCA over PySpark DataFrames (ArrayType features column).
    ``SparkPCA(device='cpu')`` fits on the CPU (the driver's own daemon too)."""

    _core_cls = _PCA
    _daemon_algo = "pca"


class SparkLinearRegression(_SparkAdapter):
    """LinearRegression over PySpark DataFrames: one scan of (features,
    label) folded into the daemon's normal equations, served predictions."""

    _core_cls = _lr.LinearRegression
    _daemon_algo = "linreg"


class SparkKMeans(_SparkAdapter):
    """KMeans over PySpark DataFrames: centres seeded by the driver from a
    prefix sample, one scan per Lloyd pass, served int32 predictions."""

    _core_cls = _km.KMeans
    _daemon_algo = "kmeans"


class SparkLogisticRegression(_SparkAdapter):
    """LogisticRegression over PySpark DataFrames: the class count from a
    label probe, one scan per Newton (binary) or MM-Newton (multinomial)
    pass, served rawPrediction, probability and prediction."""

    _core_cls = _lg.LogisticRegression
    _daemon_algo = "logreg"


class SparkStandardScaler(_SparkAdapter):
    """StandardScaler over PySpark DataFrames: one scan folded into the
    daemon's pca job and finalized to raw moments; the served transform
    carries withMean/withStd."""

    _core_cls = _StandardScaler
    _daemon_algo = "scaler"


class SparkRandomForestClassifier(_SparkAdapter):
    """RandomForestClassifier over PySpark DataFrames: the class count from
    a label probe, the bin edges from a prefix sample, one scan per tree
    depth into the daemon's rf job (Gini splits), served predictions. Not
    exported from ``spark``, as in the reference."""

    _core_cls = _rf.RandomForestClassifier
    _daemon_algo = "rf_classifier"


class SparkRandomForestRegressor(_SparkAdapter):
    """RandomForestRegressor over PySpark DataFrames: the rf job with
    variance splits, served predictions. Not exported from ``spark``, as
    in the reference."""

    _core_cls = _rf.RandomForestRegressor
    _daemon_algo = "rf_regressor"


class SparkNearestNeighbors(_SparkAdapter):
    """Exact NearestNeighbors over PySpark DataFrames: the rows stream to the
    daemon's knn job, which indexes them and serves kneighbors; ``fit``
    returns a handle of that index (``_DaemonKNNModel``)."""

    _core_cls = _knn.NearestNeighbors
    _daemon_algo = "knn"


class SparkApproximateNearestNeighbors(_SparkAdapter):
    """IVF-Flat ApproximateNearestNeighbors over PySpark DataFrames: the
    daemon builds the index from the fed rows at finalize and serves
    kneighbors; ``fit`` returns a handle of that index."""

    _core_cls = _knn.ApproximateNearestNeighbors
    _daemon_algo = "knn"
