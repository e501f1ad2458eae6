"""The port's Spark fits across daemons: the single-pass algos, the two
reduce paths and the driver's guards, through sparksim.

Executors on another host feed their own daemon (``SRML_DAEMON_ADDRESS``
in the task's env, sparksim's ``env_plan``): here the upper half of the
partitions route to a second port daemon (``device="cpu"``, in this
process). The port of ``tests/test_spark_multidaemon.py`` and of the
daemon half of ``tests/test_mesh_collectives.py``:

* PCA, StandardScaler and LinearRegression over two daemons equal the
  one-daemon fit bitwise on integer rows (every statistic an exact float32
  sum), and the JAX package's in-memory fit of the same rows at the JAX
  tests' tolerances, and both daemons keep no job;
* on gaussian rows, one partition a daemon (so each daemon's state is
  the same in both fits), the collective reduce and the hub
  (``mesh_collectives`` off) give bitwise the same PCA, and the path
  counter ``srml_fit_mesh_reduce_paths_total`` says which ran;
* a retried task on the peer gives the clean fit; a lost commit on the
  peer (both paths) and a peer export short of its acks (the hub) fail
  the fit loudly with the row-count mismatch;
* an alias of the primary's address is no peer;
* the JAX ``SparkPCA`` over two port daemons (its collective reduce on
  the port's ``reduce_mesh``) equals the port's wrapper.
"""

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
import spark_rapids_ml_tpu as jax_pkg
from spark_rapids_ml_tpu.models import linear_regression as jax_lr
from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import daemon as port_daemon
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import daemon_addr, jax_ledger_off, split_routing

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

N, D = 800, 8
#: The two-daemon fit against the JAX in-memory fit: PCASuite.scala:87;
#: tests/test_torch_scaler_pipeline.py's 1e-12 relative (the sums are exact);
#: tests/test_linear_regression.py:25 (the daemons solve in float32).
JAX_TOLS = {"pca": {"atol": 1e-5}, "scaler": {"rtol": 1e-12, "atol": 0},
            "linreg": {"atol": 1e-6}}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_DAEMON_ADDRESSES", "SRML_TRANSFORM_LOCAL",
                 "SRML_FIT_RECOVERY_ATTEMPTS"):
        monkeypatch.delenv(name, raising=False)
    yield
    daemon_session.shutdown()


@pytest.fixture
def two_daemons():
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        yield a, b


def _int_rows(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(N, D)).astype(np.float64)
    y = (x @ rng.integers(-2, 3, size=D)).astype(np.float64)
    return x, y


def _one_daemon_df(daemon, x, **kw):
    return simdf_from_numpy(x, n_partitions=4, session=SimSparkSession(
        {"spark.srml.daemon.address": daemon_addr(daemon)}), **kw)


def _split_df(a, b, x, n_partitions=4, **kw):
    session, env_plan = split_routing(a, b, n_partitions)
    return simdf_from_numpy(x, n_partitions=n_partitions, session=session, env_plan=env_plan,
                            **kw)


def _paths():
    c = port_est._M_MESH_PATHS
    return {p: c.value(path=p) for p in ("collective", "hub")}


def _assert_same(model, ref, attrs):
    for attr in attrs:
        np.testing.assert_array_equal(np.asarray(getattr(model, attr)),
                                      np.asarray(getattr(ref, attr)), err_msg=attr)


#: name → (estimator factory, labelled, model attributes compared)
SINGLE_PASS = {
    "pca": (lambda: port_est.SparkPCA(device="cpu").setK(3), False,
            ("pc", "explainedVariance", "mean")),
    "scaler": (lambda: port_est.SparkStandardScaler(device="cpu").setWithMean(True), False,
               ("mean", "std")),
    "linreg": (lambda: port_est.SparkLinearRegression(device="cpu").setRegParam(1e-3), True,
               ("coefficients", "intercept")),
}


def _jax_fit(name, x, y, mesh):
    """The JAX package's in-memory fit of the same rows: {attribute: value}."""
    with jax_ledger_off():
        if name == "pca":
            ref = jax_pca.fit_pca(x, k=3, mesh=mesh)
            return {"pc": np.abs(ref.pc), "explainedVariance": ref.explained_variance,
                    "mean": ref.mean}
        if name == "scaler":
            ref = jax_pkg.StandardScaler(mesh=mesh).setWithMean(True).fit({"features": x})
            return {"mean": ref.mean, "std": ref.std}
        ref = jax_lr.fit_linear_regression(x, y, reg=1e-3, mesh=mesh)
        return {"coefficients": ref.coefficients, "intercept": ref.intercept}


@pytest.mark.parametrize("name", list(SINGLE_PASS))
def test_two_daemons_equal_one_daemon_bitwise(name, two_daemons, mesh8):
    a, b = two_daemons
    make, labelled, attrs = SINGLE_PASS[name]
    x, y = _int_rows()
    kw = {"label": y} if labelled else {}
    one = make().fit(_one_daemon_df(a, x, **kw))
    before = _paths()
    split = _split_df(a, b, x, **kw)
    two = make().fit(split)
    assert split.sparkSession.driver_rows_materialized == 0
    _assert_same(two, one, attrs)
    for attr, want in _jax_fit(name, x, y, mesh8).items():
        got = np.asarray(getattr(two, attr))
        got = np.abs(got) if attr == "pc" else got
        np.testing.assert_allclose(got, want, err_msg=attr, **JAX_TOLS[name])
    if name == "linreg":
        assert two.summary.rmse == one.summary.rmse and two.summary.n_rows == N
    assert _paths() == {**before, "collective": before["collective"] + 1}
    assert a._jobs == {} and b._jobs == {}  # both daemons' jobs went with the fit


def test_collective_and_hub_give_the_same_pca_bitwise(two_daemons):
    """Gaussian float32 rows, one partition a daemon: each daemon folds the
    same rows in the same order in every fit, so the two reduce paths must
    make the same additions."""
    a, b = two_daemons
    x = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)
    fits = {}
    for path in ("collective", "hub"):
        before = _paths()
        with config.option("mesh_collectives", path == "collective"):
            fits[path] = port_est.SparkPCA(device="cpu").setK(3).fit(
                _split_df(a, b, x, n_partitions=2))
        ran = {p: _paths()[p] - before[p] for p in before}
        assert ran == {"collective": int(path == "collective"), "hub": int(path == "hub")}
        assert a._jobs == {} and b._jobs == {}
    _assert_same(fits["collective"], fits["hub"], ("pc", "explainedVariance", "mean"))


def test_a_retried_task_on_the_peer_gives_the_clean_fit(two_daemons):
    a, b = two_daemons
    x, _ = _int_rows(1)
    clean = port_est.SparkPCA(device="cpu").setK(3).fit(_split_df(a, b, x))
    # Partition 3 (the peer's) dies after one batch, and Spark retries it.
    flaky = port_est.SparkPCA(device="cpu").setK(3).fit(_split_df(a, b, x, fail_plan={3: [1]}))
    _assert_same(flaky, clean, ("pc", "explainedVariance", "mean"))
    assert a._jobs == {} and b._jobs == {}


@pytest.mark.parametrize("collectives", [True, False], ids=["collective", "hub"])
def test_a_lost_commit_on_the_peer_fails_loudly(collectives, two_daemons, monkeypatch):
    """The peer acks partition 2's commit without folding its rows (a lost
    stage): the daemon's pre-reduce gather (collective) or the driver's
    export check (hub) refuses before anything folds."""
    a, b = two_daemons
    real = port_daemon._Job.commit

    def lossy_commit(self, partition, attempt=0, pass_id=None):
        if partition == 2:
            with self.lock:
                self._drop_stage((partition, attempt))
                self.committed[partition] = 0
                return self.rows
        return real(self, partition, attempt, pass_id)

    monkeypatch.setattr(port_daemon._Job, "commit", lossy_commit)
    with config.option("mesh_collectives", collectives):
        with pytest.raises(RuntimeError, match="row-count mismatch"):
            port_est.SparkPCA(device="cpu").setK(3).fit(_split_df(a, b, _int_rows()[0]))
    assert a._jobs == {} and b._jobs == {}


def test_a_peer_export_short_of_its_acks_fails_loudly(two_daemons, monkeypatch):
    a, b = two_daemons
    real = port_daemon._Job.export_state

    def short_export(self):
        arrays, meta = real(self)
        return arrays, {**meta, "pass_rows": meta["pass_rows"] - 7}

    monkeypatch.setattr(port_daemon._Job, "export_state", short_export)
    with config.option("mesh_collectives", False):
        with pytest.raises(RuntimeError, match="row-count mismatch at peer daemon"):
            port_est.SparkPCA(device="cpu").setK(3).fit(_split_df(a, b, _int_rows()[0]))
    assert a._jobs == {} and b._jobs == {}


def test_an_alias_of_the_primary_is_no_peer(two_daemons):
    """Tasks routed to ``localhost:PORT`` while the driver resolves
    ``127.0.0.1:PORT``: the same daemon by its instance id, so the fit is a
    one-daemon fit (no self-merge, no reduce)."""
    a, _ = two_daemons
    x, _ = _int_rows(2)
    plain = port_est.SparkPCA(device="cpu").setK(3).fit(_one_daemon_df(a, x))
    before = _paths()
    alias = {pid: {"SRML_DAEMON_ADDRESS": f"localhost:{a.address[1]}"} for pid in (2, 3)}
    aliased = port_est.SparkPCA(device="cpu").setK(3).fit(_one_daemon_df(a, x, env_plan=alias))
    _assert_same(aliased, plain, ("pc", "explainedVariance", "mean"))
    assert _paths() == before
    assert a._jobs == {}


def test_the_jax_sparkpca_over_two_port_daemons_equals_the_ports(two_daemons, mesh8):
    a, b = two_daemons
    x, _ = _int_rows(4)
    port_model = port_est.SparkPCA(device="cpu").setK(3).fit(_split_df(a, b, x))
    reduces = port_daemon._M_MESH_REDUCES.value(algo="pca")
    with jax_ledger_off():
        jax_model = jax_est.SparkPCA(mesh=mesh8).setInputCol("features").setK(3).fit(
            _split_df(a, b, x))
    # The JAX driver took the collective path on the port's reduce_mesh.
    assert port_daemon._M_MESH_REDUCES.value(algo="pca") == reduces + 1
    # Both finalized on the primary port daemon from the same exact sums.
    for attr in ("pc", "explainedVariance", "mean"):
        np.testing.assert_array_equal(np.asarray(getattr(jax_model, attr), np.float64),
                                      np.asarray(getattr(port_model, attr), np.float64))
    assert a._jobs == {} and b._jobs == {}
