"""The port's elastic fit, the degrade half, single pass: PCA, and the knn
fit that has no elastic loop.

The port of ``tests/test_elastic.py``'s single-pass degrade test and of
its guards (the topology and the rows: ``tests/torch_elastic_common.py``).
A single-pass fit has no iterate ledger: the rewind drops the job on
every daemon and the whole scan replays on the survivors.

* PCA degrade on the collective and the hub path, the peer dying at the
  first ``daemon.vanish`` hit (the scan's reduce, after its rows were
  committed and acked): the model equals the fit on the surviving
  topology bitwise, and one loss is counted.
* An unreachable primary raises its own error; a daemon declared dead
  that is alive and acks rows of the replay is refused.
* The knn fit runs no elastic loop, as the reference's: with tolerance 1,
  a shard daemon lost after the scan fails it, and no loss is counted.
* Against the JAX package: the surviving-topology oracle agrees with the
  JAX in-memory ``fit_pca`` of the same rows at PCASuite's 1e-5, and the
  JAX ``SparkPCA`` with tolerance 1 over three port daemons, while the
  port's plan kills a peer, equals the port's elastic fit bitwise.
"""

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame
from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import NearestNeighbors, config
from spark_rapids_ml_tpu_torch.models.pca import PCA as PortPCA
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils.faults import FaultPlan
from torch_elastic_common import (  # noqa: F401 - fixtures
    D,
    PARTS,
    X,
    counter_total,
    elastic_env,
    failover_env,
    no_jobs,
    same_pca,
    session,
    sim_df,
    spark_pca,
    survivor_env,
    survivors,
    third,
)
from torch_port_helpers import daemon_addr, direct_fit, jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

JAX_PCA_TOL = 1e-5  # PCASuite.scala:87, as tests/test_torch_spark_multidaemon.py


@pytest.fixture(scope="module")
def oracle(survivors):
    """The PCA fit on the surviving topology, its tasks in this process."""
    a, c = survivors
    core = PortPCA(device="cpu").setInputCol("features").setK(3)
    return direct_fit(lambda f, rp: port_est._drive_pca(f, rp, core), a, X, PARTS, "pca",
                      routes={2: c, 3: c})


def _losses():
    return counter_total(port_est._M_DAEMON_LOSSES)


def _vanish(b):
    return FaultPlan(seed=3).rule("daemon.vanish", "crash", times=1).on_crash(b.stop)


@pytest.mark.parametrize("collectives", [True, False], ids=["collective", "hub"])
def test_pca_degrade_single_pass_bitwise(collectives, survivors, third, oracle, monkeypatch):
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
    losses0 = _losses()
    plan = _vanish(b)
    with config.option("mesh_collectives", collectives), faults.active(plan):
        m = spark_pca(sim_df(session(a), failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 1}
    same_pca(m, oracle)
    assert _losses() == losses0 + 1
    no_jobs(a, c)


def test_an_unreachable_primary_raises_its_own_error(third, monkeypatch):
    """The primary holds the folded state: its loss is no peer's, whatever
    the tolerance. It dies at the hub's first export."""
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
    a = DataPlaneDaemon(device="cpu").start()
    try:
        with DataPlaneDaemon(device="cpu") as c:
            plan = FaultPlan(seed=1).rule("daemon.vanish", "crash", times=1).on_crash(a.stop)
            with config.option("mesh_collectives", False), faults.active(plan), \
                    pytest.raises(RuntimeError, match="primary daemon .* is unreachable"):
                spark_pca(sim_df(session(a), failover_env(b, a, c), max_attempts=2))
            assert plan.fired == {"daemon.vanish": 1}
    finally:
        a.stop()


def test_a_quarantined_daemon_that_acks_rows_is_refused(survivors, third, monkeypatch):
    """A peer declared dead (its probe patched to fail) that is alive and
    still fed by its executor acks rows of the replay: refused, since it
    holds state no rewind reached."""
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
    real = port_est._DaemonFit._probe_alive
    monkeypatch.setattr(port_est._DaemonFit, "_probe_alive",
                        lambda self, addr: tuple(addr) != b.address and real(self, addr))
    # Both attempts of the first export fail: a failed reduce.
    plan = FaultPlan(seed=1).rule("daemon.vanish", "drop", times=2)
    env = {1: {"SRML_DAEMON_ADDRESS": daemon_addr(b)}, **survivor_env(c)}
    losses0 = _losses()
    with config.option("mesh_collectives", False), faults.active(plan), \
            pytest.raises(RuntimeError, match="declared dead and quarantined, yet acked"):
        spark_pca(sim_df(session(a), env))
    assert plan.fired == {"daemon.vanish": 2}
    assert _losses() == losses0 + 1
    no_jobs(a, c)


def test_the_knn_fit_fails_loudly_when_a_shard_daemon_dies(survivors, third):
    """No elastic loop in the knn fit: with tolerance 1, a shard daemon
    that dies between the scan and the build fails the fit, nothing is
    quarantined, and the surviving shard's job and index are freed."""
    a, _ = survivors
    b = third
    job = "elastic-knn"
    fit = port_est._DaemonFit(*a.address, job, loss_tolerance=1, death_timeout_s=2.0,
                              max_op_attempts=2)
    halves = np.array_split(X.astype(np.float32), 2)

    def run_pass(pass_id):
        acks = []
        for p, (d, rows) in enumerate(zip((a, b), halves)):
            with DataPlaneClient(*d.address) as cl:
                def send(batch, cl=cl, p=p):
                    cl.feed_raw(job, batch, algo="knn", n_cols=D, partition=p)

                acks.append(port_est._feed_partition(cl, [rows], send, job, p, 0, pass_id,
                                                     d.address))
        b.stop()
        return acks

    losses0 = _losses()
    try:
        with pytest.raises(OSError):
            port_est._drive_knn(fit, run_pass, NearestNeighbors(device="cpu").setK(3))
    finally:
        fit.close()
        port_est._evict_daemon_id_cache(job)
    assert _losses() == losses0 and not fit.quarantined
    no_jobs(a)
    assert not a._models


def test_the_oracle_agrees_with_the_jax_in_memory_fit(oracle, mesh8):
    with jax_ledger_off():
        ref = jax_pca.fit_pca(X, k=3, mesh=mesh8)
    np.testing.assert_allclose(np.abs(oracle.pc), np.abs(ref.pc), atol=JAX_PCA_TOL)
    np.testing.assert_allclose(oracle.explainedVariance, ref.explained_variance,
                               atol=JAX_PCA_TOL)
    np.testing.assert_allclose(oracle.mean, ref.mean, atol=JAX_PCA_TOL)


def test_the_jax_elastic_driver_over_port_daemons_equals_the_port(survivors, third, oracle,
                                                                  mesh8, monkeypatch):
    """The JAX ``SparkPCA`` with tolerance 1 drives three port daemons while
    the port's plan kills the doomed peer at its first ``daemon.vanish``
    (the port daemon's ``reduce_mesh``): its elastic fit, finalized on the
    port's primary from the same exact sums, equals the port's fit on the
    surviving topology bitwise."""
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
    plan = _vanish(b)
    with faults.active(plan), jax_ledger_off():
        m = jax_est.SparkPCA(mesh=mesh8).setInputCol("features").setK(3).fit(
            sim_df(session(a), failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 1}
    same_pca(m, oracle)
    no_jobs(a, c)
