"""The port's ``SparkPCA`` through sparksim, against the JAX package.

sparksim (``tests/sparksim.py``) runs each partition task in its own OS
process over real TCP, with Spark's retries, so the executor closures run
as they would under pyspark. Every fit here is the port's
``SparkPCA(device="cpu")`` (float32 compute on the CPU) over 800 x 24 rows
with a decaying spectrum, and every fit asserts that the driver
materialized no row of the dataset.

* the fit against the JAX ``fit_pca`` of the same rows (float64, under
  ``jax_ledger_off()``): components sign-invariantly, σ/Σσ and the mean to
  absTol 1e-5 (PCASuite.scala:80-87, the Queue 3 contract for the port's
  float32 compute); the fitted model saved by the port loads in the JAX
  package;
* in the port's float64 mode (the daemon runs in this process, so the
  config reaches its folds), within 1e-6 of its own in-memory ``fit_pca``;
  and exactly-once: a retried task and a speculative duplicate each give
  that clean fit's model within 1e-6, and the daemon's finalize counts
  each row once. (In float32, tasks that commit in another order sum the
  Gram in another order, which moves the components by about 2e-6 here.)
* an empty DataFrame raises; without a card and without ``device="cpu"``
  the fit raises the "no CUDA device" error and starts no daemon;
* the served transform (``x @ pc``, no centring, RapidsPCA.scala:159)
  through the driver's own daemon, and ``SRML_TRANSFORM_LOCAL=1`` on the
  executors with the same output;
* the cross pairings: the port's ``SparkPCA`` against an in-process JAX
  daemon, and the JAX ``SparkPCA`` against the port's daemon;
* a second daemon in the acks (folded in as a peer), the refusals of the
  elastic and join policies, and the scan replay after a daemon restart;
* the task closures pickle without a torch object.
"""

import pickle
import pickletools

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import SparkPCA, daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

K = 4
JAX_TOL = 1e-5  # PCASuite.scala:87
SELF_TOL = 1e-6  # the port against its own in-memory fit, and across exactly-once traffic


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_TRANSFORM_LOCAL", "SRML_FIT_RECOVERY_ATTEMPTS",
                 "SRML_FIT_DAEMON_LOSS_TOLERANCE", "SRML_FIT_DAEMON_JOIN_POLICY"):
        monkeypatch.delenv(name, raising=False)
    yield
    daemon_session.shutdown()


@pytest.fixture(scope="module")
def pca_data():
    rng = np.random.default_rng(42)
    n, d = 800, 24
    basis = rng.normal(size=(d, d)) * np.logspace(0, -1.5, d)
    return rng.normal(size=(n, d)) @ basis


@pytest.fixture(scope="module")
def jax_ref(pca_data, mesh8):
    with jax_ledger_off():
        return jax_pca.fit_pca(pca_data, k=K, mesh=mesh8)


def _fit(df):
    model = SparkPCA(device="cpu").setInputCol("features").setK(K).fit(df)
    assert df.sparkSession.driver_rows_materialized == 0
    return model


@pytest.fixture
def float64_mode():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield


@pytest.fixture(scope="module")
def clean_fit(pca_data):
    model = _fit(simdf_from_numpy(pca_data, n_partitions=3))
    daemon_session.shutdown()
    return model


@pytest.fixture(scope="module")
def clean_fit64(pca_data):
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        model = _fit(simdf_from_numpy(pca_data, n_partitions=3))
    daemon_session.shutdown()
    return model


def _assert_close(model, ref, tol):
    """Components sign-invariantly, σ/Σσ and the mean, to ``tol``."""
    ev = getattr(ref, "explained_variance", None)
    ev = ref.explainedVariance if ev is None else ev
    np.testing.assert_allclose(np.abs(model.pc), np.abs(ref.pc), atol=tol)
    np.testing.assert_allclose(model.explainedVariance, ev, atol=tol)
    np.testing.assert_allclose(model.mean, ref.mean, atol=tol)


def test_fit_is_distributed_and_matches_jax(clean_fit, pca_data, jax_ref, tmp_path):
    assert isinstance(clean_fit, port_est._SparkModelAdapter)
    assert clean_fit.pc.shape == (24, K) and clean_fit.getK() == K
    _assert_close(clean_fit, jax_ref, JAX_TOL)
    # A Spark-fitted port model carries across to the JAX package.
    clean_fit.write().save(str(tmp_path / "m"))
    loaded = jax_pca.PCAModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(loaded.pc, clean_fit.pc)
    assert loaded.getK() == K and loaded.uid == clean_fit.uid


def test_float64_fit_matches_the_in_memory_fit(clean_fit64, pca_data, float64_mode):
    _assert_close(clean_fit64, port_pca.fit_pca(pca_data, K, device="cpu"), SELF_TOL)


@pytest.mark.parametrize("traffic", [
    {"fail_plan": {1: [1]}},  # an attempt dies mid-partition, Spark retries it
    {"speculative": [0]},  # a duplicate that runs after the original commits
])
def test_exactly_once_under_retries_and_speculation(traffic, clean_fit64, pca_data,
                                                    float64_mode, monkeypatch):
    finals = []
    real = port_est._DaemonFit.finalize_guarded

    def spy(self, params, pass_rows_expected=None):
        out = real(self, params, pass_rows_expected)
        finals.append(out[1])
        return out

    monkeypatch.setattr(port_est._DaemonFit, "finalize_guarded", spy)
    model = _fit(simdf_from_numpy(pca_data, n_partitions=3, **traffic))
    assert finals == [pca_data.shape[0]]  # the daemon counted each row once
    _assert_close(model, clean_fit64, SELF_TOL)


def test_empty_dataframe_raises():
    df = simdf_from_numpy(np.empty((0, 6)), n_partitions=3)
    with pytest.raises(ValueError, match="empty"):
        SparkPCA(device="cpu").setK(2).fit(df)


def test_no_card_and_no_cpu_device_raises_before_any_task(pca_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = simdf_from_numpy(pca_data, n_partitions=2)
    monkeypatch.setattr(SimDataFrame, "mapInArrow",
                        lambda *a: pytest.fail("a task ran without a daemon"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparkPCA().setK(2).fit(df)
    assert daemon_session._owned == {}  # no CPU daemon was started instead


def _collected_output(rows):
    return np.array([r["pca_features"] for r in rows], dtype=np.float64)


def test_transform_is_served_by_the_daemon_and_locally_alike(clean_fit, pca_data, monkeypatch):
    df = simdf_from_numpy(pca_data, n_partitions=3)
    rows = clean_fit.transform(df).collect()
    daemon = daemon_session._owned["cpu"]
    assert [m.algo for m in daemon._models.values()] == ["pca"]
    y_served = _collected_output(rows)
    # x @ pc with no centring; the port computes in float32 on the CPU, so
    # the tolerance is 1e-6 of the largest Σ|x||pc| term sum.
    want = pca_data @ clean_fit.pc
    scale = float((np.abs(pca_data) @ np.abs(clean_fit.pc)).max())
    np.testing.assert_allclose(y_served, want, atol=1e-6 * scale)
    np.testing.assert_allclose(np.array([r["features"] for r in rows]), pca_data, rtol=0,
                               atol=0)  # the passthrough column is untouched
    assert df.sparkSession.driver_rows_materialized == 0

    daemon_session.shutdown()
    monkeypatch.setenv("SRML_TRANSFORM_LOCAL", "1")
    y_local = _collected_output(clean_fit.transform(df).collect())
    assert daemon_session._owned == {}  # no daemon, so no registry entry
    np.testing.assert_allclose(y_local, y_served, atol=1e-6 * scale)


def test_port_sparkpca_against_a_jax_daemon(pca_data, jax_ref, mesh8):
    with jax_ledger_off(), JaxDaemon(mesh=mesh8) as jd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % jd.address})
        df = simdf_from_numpy(pca_data, n_partitions=3, session=session)
        model = SparkPCA(device="cpu").setInputCol("features").setK(K).fit(df)
        assert jd._jobs == {}  # finalized and dropped
    assert session.driver_rows_materialized == 0
    _assert_close(model, jax_ref, JAX_TOL)


def test_jax_sparkpca_against_the_ports_daemon(pca_data, jax_ref, mesh8):
    with jax_ledger_off(), DataPlaneDaemon(device="cpu") as pd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % pd.address})
        df = simdf_from_numpy(pca_data, n_partitions=3, session=session)
        model = jax_est.SparkPCA(mesh=mesh8).setInputCol("features").setK(K).fit(df)
        assert pd._jobs == {}
    assert session.driver_rows_materialized == 0
    _assert_close(model, jax_ref, JAX_TOL)


def test_acks_naming_a_second_daemon_are_refused(pca_data, jax_ref):
    """The name is historical: acks that name a second daemon were refused
    until the multi-daemon plane. Now that daemon is a peer, its partial is
    folded into the primary's, and the fit matches the JAX fit of all rows."""
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % a.address})
        # Partition 2's executor lives on another host with its own daemon.
        df = simdf_from_numpy(pca_data, n_partitions=3, session=session,
                              env_plan={2: {"SRML_DAEMON_ADDRESS": "%s:%d" % b.address}})
        model = _fit(df)
        _assert_close(model, jax_ref, JAX_TOL)
        assert a._jobs == {} and b._jobs == {}  # both daemons' jobs were dropped


@pytest.mark.parametrize("conf", [
    {"spark.srml.fit.daemon_loss_tolerance": "1"},
    {"spark.srml.fit.daemon_join_policy": "boundary"},
])
def test_elastic_and_join_policies_are_refused_before_any_row(conf, pca_data, monkeypatch):
    df = simdf_from_numpy(pca_data, n_partitions=2, session=SimSparkSession(conf))
    monkeypatch.setattr(SimDataFrame, "mapInArrow",
                        lambda *a: pytest.fail("a task ran under a refused policy"))
    with pytest.raises(NotImplementedError, match="multi-daemon plane"):
        SparkPCA(device="cpu").setK(K).fit(df)
    assert daemon_session._owned == {}


class _RestartAfterFirstCommit:
    """A daemon that restarts, at the same address and without its jobs,
    right after it acks its first commit: the volatile restart a Spark scan
    meets when the daemon's process dies between two tasks."""

    def __init__(self):
        self.daemon = self._start(0)
        self.port = self.daemon.address[1]
        self.restarts = 0

    def _start(self, port):
        d = DataPlaneDaemon(port=port, device="cpu")
        real = d._dispatch

        def dispatch(conn, req):
            real(conn, req)
            if req.get("op") == "commit" and self.restarts == 0:
                self.restarts += 1
                d.stop()
                self.daemon = self._start(self.port)

        d._dispatch = dispatch
        return d.start()


@pytest.mark.parametrize("recovery", ["0", "1"])
def test_daemon_restart_under_the_scan(recovery, pca_data, clean_fit64, float64_mode):
    server = _RestartAfterFirstCommit()
    try:
        session = SimSparkSession({"spark.srml.daemon.address": f"127.0.0.1:{server.port}",
                                   "spark.srml.fit.recovery_attempts": recovery})
        # concurrency=1: the restart falls between partition 0's commit and
        # partition 1's first feed.
        df = simdf_from_numpy(pca_data, n_partitions=2, session=session, concurrency=1)
        est = SparkPCA(device="cpu").setInputCol("features").setK(K)
        if recovery == "0":
            with pytest.raises(RuntimeError, match="restarted mid-pass"):
                est.fit(df)
        else:
            _assert_close(est.fit(df), clean_fit64, SELF_TOL)
        assert server.restarts == 1
        assert server.daemon._jobs == {}  # the fit's job was dropped either way
    finally:
        server.daemon.stop()


def _globals(payload: bytes):
    """Every module and name string a pickle refers to."""
    return [arg for op, arg, _ in pickletools.genops(payload) if isinstance(arg, str)]


def test_task_closures_pickle_without_torch(clean_fit, pca_data):
    core = clean_fit._core
    core._device = "cpu"
    core.transform_matrix(pca_data[:4])  # the projector cache now holds a tensor closure
    assert core._project_cache
    outputs = port_est._serve_spec(core)[1]
    tasks = [
        port_est._FeedTask("h", 1, None, "job", "pca", "features", None),
        port_est._DaemonTransformTask(core, "h", 1, None, "features", "pca", outputs),
        port_est._TransformTask(core, "features", outputs),
    ]
    for task in tasks:
        payload = pickle.dumps(task)
        refs = _globals(payload)
        assert not [r for r in refs if r == "torch" or r.startswith("torch.")], \
            (type(task).__name__, refs)
        assert "_project_cache" not in refs
        pickle.loads(payload)
    arrays = tasks[1]._arrays
    assert set(arrays) == {"pc", "explainedVariance", "mean"}
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
