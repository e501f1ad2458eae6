"""The port's elastic fit, the degrade half, KMeans: a peer daemon dies for
good mid-fit and the fit completes on the survivors.

The port of the KMeans half of ``tests/test_elastic.py``'s degrade tests
(the topology and the rows: ``tests/torch_elastic_common.py``; the PCA and
knn half: ``tests/test_torch_elastic_pca.py``). Three port daemons
(``device="cpu"``, in this process, so one membership registry and the
collective path applies). The doomed peer is stopped by the port's
``FaultPlan`` at a ``daemon.vanish`` site (``.on_crash(b.stop)``) and
never restarted; partition 1, which fed it, fails over to the primary.

* KMeans degrade on the collective and the hub path: the model equals the
  fit on the surviving topology bitwise (centres, cost, ``numIter``,
  ``n_rows`` complete), and the loss and reroute counters go up.
* The default tolerance 0 keeps the loud ``OSError`` and counts no loss;
  losing more peers than the tolerance raises "loss budget".
* The id cache: ``_evict_daemon_id_cache``'s semantics, the sweep at fit
  exit, and the eviction the feed task carries to its worker.
* A ``daemon.pass_boundary`` crash with a volatile restart replays to the
  clean fit with ``recovery_attempts`` 2 (``srml_fit_recoveries_total``
  goes up), and fails loudly without.
* The surviving-topology oracle agrees with the JAX in-memory
  ``fit_kmeans`` of the same rows.

The oracle runs the same driver with its tasks in this process
(``torch_port_helpers.direct_fit``), once for the module.
"""

import uuid as uuid_mod

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame
from spark_rapids_ml_tpu.models import kmeans as jax_km
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from spark_rapids_ml_tpu_torch.spark.estimator import _DAEMON_ID_CACHE, _evict_daemon_id_cache
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils.faults import FaultPlan
from torch_elastic_common import (  # noqa: F401 - fixtures
    K,
    MAX_ITER,
    SEED,
    X,
    counter_total,
    elastic_env,
    failover_env,
    kmeans_oracle_fit,
    no_jobs,
    same_kmeans,
    session,
    sim_df,
    spark_kmeans,
    survivors,
    third,
)
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)


@pytest.fixture(scope="module")
def oracle(survivors):
    return kmeans_oracle_fit(*survivors)


def _losses():
    return counter_total(port_est._M_DAEMON_LOSSES)


def _vanish(b, after=1):
    """The second hit (pass 0's reduce is the first) lands in the pass-0
    coordination: the boundary sync, or the hub's second export."""
    return FaultPlan(seed=2).rule("daemon.vanish", "crash", after=after, times=1).on_crash(b.stop)


@pytest.mark.parametrize("collectives", [True, False], ids=["collective", "hub"])
def test_kmeans_degrade_bitwise(collectives, survivors, third, oracle, monkeypatch):
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
    losses0, reroutes0 = _losses(), counter_total(port_est._M_FIT_REROUTES)
    plan = _vanish(b)
    with config.option("mesh_collectives", collectives), faults.active(plan):
        m = spark_kmeans(sim_df(session(a, (a, b, c)), failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 1}, "the death never fired: the run proved nothing"
    same_kmeans(m, oracle)
    assert _losses() == losses0 + 1
    assert counter_total(port_est._M_FIT_REROUTES) == reroutes0 + 1
    no_jobs(a, c)


def test_zero_tolerance_keeps_the_loud_error(survivors, third):
    """The default tolerance 0: the same death fails the fit with the
    transport error; no daemon is probed or quarantined."""
    a, c = survivors
    b = third
    losses0 = _losses()
    plan = _vanish(b)
    with faults.active(plan), pytest.raises(OSError):
        spark_kmeans(sim_df(session(a, (a, b, c)), failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 1}
    assert _losses() == losses0
    no_jobs(a, c)


def test_losing_more_peers_than_the_tolerance_raises(third, monkeypatch):
    """Both peers die at once under tolerance 1: the budget error, not a
    partial model (a survivor of its own, since this one dies too)."""
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as c:
        plan = FaultPlan(seed=2).rule("daemon.vanish", "crash", after=1, times=1).on_crash(
            lambda: (b.stop(), c.stop()))
        with faults.active(plan), pytest.raises(RuntimeError, match="loss budget"):
            spark_kmeans(sim_df(session(a, (a, b, c)), failover_env(b, a, c)))
        assert plan.fired == {"daemon.vanish": 1}


# -- the id cache -----------------------------------------------------------------


def test_evict_daemon_id_cache_semantics():
    """The job sweep, one address's eviction (the quarantine), the uid-prefix
    sweep; none touches another fit's routes, and a malformed address is a
    no-op."""
    saved = dict(_DAEMON_ID_CACHE)
    _DAEMON_ID_CACHE.clear()
    try:
        _DAEMON_ID_CACHE.update({("job-a", "127.0.0.1", 1111): "id1",
                                 ("job-a", "127.0.0.1", 2222): "id2",
                                 ("job-b", "127.0.0.1", 1111): "id3",
                                 ("uid9-deadbeef", "127.0.0.1", 3333): "id4"})
        _evict_daemon_id_cache("job-a", addr="127.0.0.1:1111")
        assert set(_DAEMON_ID_CACHE) == {("job-a", "127.0.0.1", 2222),
                                         ("job-b", "127.0.0.1", 1111),
                                         ("uid9-deadbeef", "127.0.0.1", 3333)}
        _evict_daemon_id_cache("job-a")
        assert ("job-a", "127.0.0.1", 2222) not in _DAEMON_ID_CACHE
        _evict_daemon_id_cache("uid9-", prefix=True)
        assert set(_DAEMON_ID_CACHE) == {("job-b", "127.0.0.1", 1111)}
        _evict_daemon_id_cache("job-b", addr="not-an-address")
        assert set(_DAEMON_ID_CACHE) == {("job-b", "127.0.0.1", 1111)}
    finally:
        _DAEMON_ID_CACHE.clear()
        _DAEMON_ID_CACHE.update(saved)


def test_fit_exit_sweeps_the_fits_routes(survivors, monkeypatch):
    """The fit's job name pinned through the uuid suffix: a stale route of
    "the fit that used the name before" is gone after the fit."""
    a, _ = survivors
    fake = uuid_mod.UUID(hex="deadbeef" * 4)
    monkeypatch.setattr(port_est.uuid, "uuid4", lambda: fake)
    est = port_est.SparkPCA(device="cpu").setInputCol("features").setK(2)
    job = f"{est._core.uid}-{fake.hex[:8]}"
    _DAEMON_ID_CACHE[(job, "127.0.0.1", a.address[1])] = "stale-ghost"
    est.fit(sim_df(session(a), {}))
    assert not [k for k in _DAEMON_ID_CACHE if k[0] == job]


def test_the_feed_task_evicts_quarantined_routes_in_its_worker(survivors, monkeypatch):
    """The eviction that matters on real executors rides the task: a reused
    worker's cached ghost id for a quarantined address is dropped at task
    start, so the live daemon there is pinged afresh and named in the ack.
    The task callable runs in this process (sparksim's processes reuse
    nothing)."""
    import pyarrow as pa

    from spark_rapids_ml_tpu_torch.bridge.arrow import matrix_to_list_column

    a, _ = survivors
    h, p = a.address
    job = "evict-task-job"
    _DAEMON_ID_CACHE[(job, h, p)] = "ghost-id"
    monkeypatch.setenv("SRML_PARTITION_ID", "0")
    monkeypatch.setenv("SRML_ATTEMPT", "0")
    pings = []
    real_ping = DataPlaneClient.server_id
    monkeypatch.setattr(DataPlaneClient, "server_id",
                        lambda self: pings.append(self._addr) or real_ping(self))
    task = port_est._FeedTask(h, p, None, job, "pca", "features", None,
                              evict_routes=(f"{h}:{p}",))
    batch = pa.table({"features": matrix_to_list_column(X[:8])}).to_batches()[0]
    try:
        acks = list(task([batch]))
        assert pings == [(h, p)]  # the ghost was not believed: the task pinged
        assert _DAEMON_ID_CACHE[(job, h, p)] == a.instance_id
        assert acks[0].column("daemon_id")[0].as_py() == a.instance_id
    finally:
        with DataPlaneClient(h, p) as c:
            c.drop(job)
        _evict_daemon_id_cache(job)


# -- a volatile restart at the pass boundary ----------------------------------------


class _Supervised:
    """A daemon at a fixed address that a supervisor restarts without its
    jobs (a volatile restart: a new instance id)."""

    def __init__(self):
        self.daemon = DataPlaneDaemon(device="cpu").start()
        self.port = self.daemon.address[1]
        self.restarts = 0

    def restart(self):
        self.daemon.stop()
        self.daemon = DataPlaneDaemon(port=self.port, device="cpu").start()
        self.restarts += 1


@pytest.mark.parametrize("recovery", [2, 0], ids=["recovery", "no-recovery"])
def test_a_pass_boundary_crash_with_a_volatile_restart(recovery, oracle, monkeypatch):
    """The one daemon dies at the pass-1 boundary (the step applied, its ack
    unsent) and comes back empty: with ``recovery_attempts`` 2 the fit
    rewinds to the ledger's pass-1 iterate on the new incarnation and
    equals the clean fit bitwise (the oracle: every sum exact, so one
    daemon's clean fit is the same model); without, it fails loudly."""
    if recovery:
        monkeypatch.setenv("SRML_FIT_RECOVERY_ATTEMPTS", str(recovery))
    sup = _Supervised()
    try:
        plan = FaultPlan(seed=3).rule("daemon.pass_boundary", "crash", after=1,
                                      times=1).on_crash(sup.restart)
        recoveries0 = counter_total(port_est._M_FIT_RECOVERIES)
        df = sim_df(session(sup.daemon), {})
        with faults.active(plan):
            if recovery:
                m = spark_kmeans(df)
            else:
                with pytest.raises(RuntimeError, match="no such job"):
                    spark_kmeans(df)
        assert plan.fired == {"daemon.pass_boundary": 1} and sup.restarts == 1
        if recovery:
            same_kmeans(m, oracle)
            assert counter_total(port_est._M_FIT_RECOVERIES) >= recoveries0 + 1
        else:
            assert counter_total(port_est._M_FIT_RECOVERIES) == recoveries0
    finally:
        sup.daemon.stop()


def test_the_oracle_agrees_with_the_jax_in_memory_fit(oracle, mesh8):
    """The surviving-topology fit against the JAX package's in-memory
    ``fit_kmeans`` of the same rows: both at the blobs' integer centres,
    bitwise (cluster order aside, each seeds its own k-means++), as
    tests/test_torch_spark_multidaemon_kmeans.py holds them, and the same
    exact cost."""
    with jax_ledger_off():
        km = jax_km.fit_kmeans(X, k=K, max_iter=MAX_ITER, seed=SEED, mesh=mesh8)

    def rows(c):
        c = np.asarray(c, np.float64)
        return c[np.lexsort(c.T[::-1])]

    np.testing.assert_array_equal(rows(oracle.centers), rows(km.centers))
    assert oracle.summary.trainingCost == float(km.cost)
