"""The port's elastic fit, the grow half: a daemon that appears mid-fit is
admitted at a pass boundary.

The port of ``tests/test_elastic.py:491-646`` (the topology and the rows:
``tests/torch_elastic_common.py``). The fit starts on two configured daemons,
the primary ``a`` and the peer ``c``. Partition 1's task tries the newcomer
``b`` first on every pass and fails over to the primary: before ``b`` is
admitted it has no job and refuses the feeds, so the rows land on the
primary. A boundary failure (both client attempts of a ``daemon.vanish``
crash) runs the callback that plays Spark's dynamic allocation: ``b`` joins
``spark.srml.daemon.addresses``. With ``spark.srml.fit.daemon_join_policy``
``boundary`` the driver admits it, seeded with the ledger's iterate by one
creating ``set_iterate``, and the replayed pass moves partition 1 onto it.

* KMeans with a mid-fit join, on the collective and the hub path, equals
  the static-topology fit bitwise; ``srml_fit_joins_total`` goes up by
  exactly 1 and ``srml_fit_rebalanced_rows_total`` by exactly the rows that
  moved (partition 1's).
* The policy ``off`` (the default) keeps the loud error and admits nobody.
* ``fit_daemon_join_limit`` 0 raises "join budget".
* A ``daemon.join`` refusal during the admission leaves no half-join: the
  fit fails, no join is counted, and the would-be joiner holds no job.
"""

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils.faults import FaultPlan
from torch_elastic_common import (  # noqa: F401 - fixtures
    X,
    PARTS,
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
from torch_port_helpers import daemon_addr

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)


@pytest.fixture(scope="module")
def oracle(survivors):
    """The fit on the static topology: partition 1 on the primary."""
    return kmeans_oracle_fit(*survivors)


def _grow_plan(sess, a, b, c):
    """Both client attempts of the pass-0 boundary sync fail (the first
    ``daemon.vanish`` hit, pass 0's reduce, passes), and the callback adds
    the newcomer to the configured daemons."""
    grown = ",".join(daemon_addr(d) for d in (a, b, c))
    return (FaultPlan(seed=4).rule("daemon.vanish", "crash", after=1, times=2)
            .on_crash(lambda: sess.conf.set("spark.srml.daemon.addresses", grown)))


def _joins():
    return counter_total(port_est._M_FIT_JOINS)


def _rebalanced():
    return counter_total(port_est._M_FIT_REBALANCED)


@pytest.mark.parametrize("collectives", [True, False], ids=["collective", "hub"])
def test_kmeans_mid_fit_join_bitwise(collectives, survivors, third, oracle, monkeypatch):
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_JOIN_POLICY", "boundary")
    joins0, rebal0 = _joins(), _rebalanced()
    sess = session(a, (a, c))
    plan = _grow_plan(sess, a, b, c)
    with config.option("mesh_collectives", collectives), faults.active(plan):
        m = spark_kmeans(sim_df(sess, failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 2}, "the boundary failure never fired"
    same_kmeans(m, oracle)
    assert _joins() == joins0 + 1
    # Partition 1 moved onto the joiner on its first acked pass.
    assert _rebalanced() == rebal0 + len(np.array_split(X, PARTS)[1])
    no_jobs(a, b, c)


def test_join_policy_off_stays_loud(survivors, third):
    """The default ``off``: the same appearance changes nothing; the boundary
    failure is the loud error and nobody is admitted."""
    a, c = survivors
    b = third
    joins0 = _joins()
    sess = session(a, (a, c))
    plan = _grow_plan(sess, a, b, c)
    with faults.active(plan), pytest.raises(OSError):
        spark_kmeans(sim_df(sess, failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 2}
    assert _joins() == joins0
    no_jobs(a, b, c)


def test_join_budget_exhausted_fails_loudly(survivors, third, monkeypatch):
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_JOIN_POLICY", "boundary")
    monkeypatch.setenv("SRML_FIT_DAEMON_JOIN_LIMIT", "0")
    joins0 = _joins()
    sess = session(a, (a, c))
    with faults.active(_grow_plan(sess, a, b, c)), \
            pytest.raises(RuntimeError, match="join budget"):
        spark_kmeans(sim_df(sess, failover_env(b, a, c)))
    assert _joins() == joins0
    no_jobs(a, b, c)


def test_a_join_fault_during_admission_leaves_no_half_join(survivors, third, monkeypatch):
    """The driver's ``daemon.join`` site refuses the handshake before the
    joiner's seeding ``set_iterate``: the fit fails, nothing is registered
    or counted, and the would-be joiner holds no job."""
    a, c = survivors
    b = third
    monkeypatch.setenv("SRML_FIT_DAEMON_JOIN_POLICY", "boundary")
    joins0 = _joins()
    sess = session(a, (a, c))
    plan = _grow_plan(sess, a, b, c).rule("daemon.join", "refuse", times=1)
    with faults.active(plan), pytest.raises(OSError):
        spark_kmeans(sim_df(sess, failover_env(b, a, c)))
    assert plan.fired == {"daemon.vanish": 2, "daemon.join": 1}, \
        "the admission fault never fired: the run proved nothing"
    assert _joins() == joins0
    no_jobs(a, b, c)
