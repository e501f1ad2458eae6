"""The port's ``SparkLinearRegression``, ``SparkKMeans`` and
``SparkLogisticRegression`` through sparksim, against the JAX package.

sparksim (``tests/sparksim.py``) runs each partition task in its own OS
process over real TCP, with Spark's retries. The fits run in the port's
float64 mode (the daemon runs in this process, so the config reaches its
folds), so each is held to the JAX core fit of the same rows at the
reference's own tolerances (``tests/test_spark_distributed.py``:80-140,
:239-261, :402): linreg 1e-8, binomial logreg 1e-4, multinomial against
``fit_multinomial_stream`` 1e-6, kmeans against ``fit_kmeans_stream`` from
the same seed sample 1e-8. Every fit asserts what the driver materialized:
no row, or for KMeans only its seed sample.

* exactly-once across passes: a task attempt that dies in every pass and
  a speculative duplicate in every pass each give the clean fit's model
  within 1e-9 (float64 sums in another commit order);
* a daemon restart between KMeans passes fails loudly with
  ``recovery_attempts`` 0, and with 1 replays the pass from the ledger's
  iterate and gives the clean fit's model within 1e-12 (the replayed
  pass's commits may arrive in another order, so not bitwise);
* the served transform columns (KMeans' int32 prediction, LinearRegression's
  double prediction, LogisticRegression's rawPrediction, probability and
  prediction) equal ``SRML_TRANSFORM_LOCAL=1``'s;
* the JAX ``SparkKMeans`` and ``SparkLogisticRegression`` fit against the
  port's daemon; an empty DataFrame raises; the task closures pickle
  without torch.

Tasks are forkserver processes that import the port (about 2 s a pass of
three partitions), so the fits keep to a few passes.
"""

import pickle
import pickletools

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu.models import kmeans as jax_km
from spark_rapids_ml_tpu.models import linear_regression as jax_lr
from spark_rapids_ml_tpu.models import logistic_regression as jax_lg
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import kmeans as port_km
from spark_rapids_ml_tpu_torch.models import linear_regression as port_lr
from spark_rapids_ml_tpu_torch.models import logistic_regression as port_lg
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import (
    SparkKMeans,
    SparkLinearRegression,
    SparkLogisticRegression,
    daemon_session,
)
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

N, D, K, C = 480, 6, 4, 3
SEED_ROWS = port_est._kmeans_seed_rows(K)  # 128: the driver's seed sample


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_TRANSFORM_LOCAL", "SRML_FIT_RECOVERY_ATTEMPTS",
                 "SRML_FIT_DAEMON_LOSS_TOLERANCE", "SRML_FIT_DAEMON_JOIN_POLICY"):
        monkeypatch.delenv(name, raising=False)
    with jax_ledger_off(), config.option("compute_dtype", "float64"), \
            config.option("accum_dtype", "float64"):
        yield
    daemon_session.shutdown()


def _data():
    rng = np.random.default_rng(23)
    x = rng.normal(size=(N, D))
    w = rng.normal(size=D)
    blobs = rng.normal(size=(K, D)) * 8
    xk = np.concatenate([c + 0.3 * rng.normal(size=(N // K, D)) for c in blobs])
    return {
        "x": x,
        "y_lin": x @ w + 0.5 + 0.01 * rng.normal(size=N),
        "y_bin": (x @ w + 1.5 * rng.normal(size=N) > 0).astype(np.float64),
        "y_mc": np.argmax(x @ (2 * rng.normal(size=(D, C))), axis=1).astype(np.float64),
        "xk": xk[rng.permutation(N)],
        "blobs": blobs,
    }


DATA = _data()


def _linreg():
    return SparkLinearRegression(device="cpu").setRegParam(1e-4)


def _kmeans():
    return SparkKMeans(device="cpu").setK(K).setMaxIter(10).setSeed(5)


def _logreg(max_iter=2):
    """Binomial; two Newton passes where a test compares fits of the same
    settings, converged (five passes here) where it compares with the JAX
    fit."""
    return SparkLogisticRegression(device="cpu").setRegParam(1e-2).setMaxIter(max_iter) \
        .setTol(1e-3)


def _df(kind, **kw):
    if kind == "kmeans":
        return simdf_from_numpy(DATA["xk"], n_partitions=3, **kw)
    label = {"linreg": "y_lin", "logreg": "y_bin", "multinomial": "y_mc"}[kind]
    return simdf_from_numpy(DATA["x"], n_partitions=3, label=DATA[label], **kw)


def _fit(est, df, max_rows=0):
    model = est.fit(df)
    assert df.sparkSession.driver_rows_materialized <= max_rows
    return model


@pytest.fixture(scope="module")
def clean_fits():
    """Each wrapper's clean fit (no retries), computed once for the module."""
    fits = {}
    with jax_ledger_off(), config.option("compute_dtype", "float64"), \
            config.option("accum_dtype", "float64"):
        fits["kmeans"] = _fit(_kmeans(), _df("kmeans"), SEED_ROWS)
        fits["logreg"] = _fit(_logreg(), _df("logreg"))
    daemon_session.shutdown()
    return fits


def _same_model(a, b, tol):
    for attr in ("coefficients", "intercept", "centers"):
        if getattr(a, attr, None) is not None:
            np.testing.assert_allclose(getattr(a, attr), getattr(b, attr), rtol=0, atol=tol,
                                       err_msg=attr)
    assert a.summary.numIter == b.summary.numIter


# ---------------------------------------------------------------------------
# Each wrapper against the JAX core fit of the same rows
# ---------------------------------------------------------------------------


def test_linreg_fit_matches_jax_core(mesh8):
    model = _fit(_linreg(), _df("linreg"))
    assert isinstance(model, port_est._SparkModelAdapter)
    ref = jax_lr.fit_linear_regression(DATA["x"], DATA["y_lin"], reg=1e-4, mesh=mesh8)
    np.testing.assert_allclose(model.coefficients, ref.coefficients, atol=1e-8)
    np.testing.assert_allclose(model.intercept, ref.intercept, atol=1e-8)
    assert model.summary.rmse == pytest.approx(ref.summary.rmse, abs=1e-8)
    assert model.summary.r2 == pytest.approx(ref.summary.r2, abs=1e-8)
    assert model.summary.n_rows == N


def test_logreg_binomial_fit_matches_jax_core(mesh8):
    model = _fit(_logreg(max_iter=10), _df("logreg"))
    ref = jax_lg.fit_logistic_regression(DATA["x"], DATA["y_bin"], reg=1e-2, max_iter=20,
                                         mesh=mesh8)
    assert model.coefficients.shape == (D,) and model.numClasses == 2
    np.testing.assert_allclose(model.coefficients, ref.coefficients, atol=1e-4)
    np.testing.assert_allclose(model.intercept, ref.intercept, atol=1e-4)
    # the daemon loop ran real Newton passes and kept their objectives
    assert model.summary.numIter >= 2
    assert len(model.summary.objectiveHistory) == model.summary.numIter
    assert np.all(np.diff(model.summary.objectiveHistory) <= 1e-12)


def test_logreg_multinomial_fit_matches_jax_stream(mesh8):
    model = _fit(SparkLogisticRegression(device="cpu").setRegParam(1e-2).setMaxIter(3),
                 _df("multinomial"))
    assert model.coefficients.shape == (C, D) and model.numClasses == C
    x, y = DATA["x"], DATA["y_mc"]
    ref = jax_lg.fit_multinomial_stream(
        lambda: iter([(x[i:i + 160], y[i:i + 160]) for i in range(0, N, 160)]),
        D, C, reg=1e-2, max_iter=3, tol=1e-6, mesh=mesh8)
    np.testing.assert_allclose(model.coefficients, ref.coefficients, atol=1e-6)
    np.testing.assert_allclose(model.intercept, ref.intercept, atol=1e-6)


def test_kmeans_fit_matches_jax_stream(clean_fits, mesh8):
    """Seeded from the driver's prefix sample (the first SEED_ROWS rows):
    the JAX stream seeded from the same rows and generator takes the same
    Lloyd passes."""
    model = clean_fits["kmeans"]
    xk = DATA["xk"]
    parts = np.array_split(xk, 3)
    head = {"first": True}

    def source():  # the init scan reads the seed sample; the others the partitions
        return iter([xk[:SEED_ROWS]] if head.pop("first", False) else parts)

    ref = jax_km.fit_kmeans_stream(source, k=K, n_cols=D, max_iter=10, tol=1e-4, seed=5,
                                   init="k-means++", init_sample_rows=SEED_ROWS, mesh=mesh8)
    np.testing.assert_allclose(model.clusterCenters(), ref.centers, atol=1e-8)
    assert model.summary.numIter == ref.n_iter
    # The cost to tests/test_serve.py:224's 1e-5 relative: the JAX cost
    # carries about 2e-8 of rounding here.
    assert model.summary.trainingCost == pytest.approx(ref.cost, rel=1e-5)
    assert model.summary.n_rows == N and model.summary.k == K
    # every true blob centre recovered within the blob's spread
    dists = np.linalg.norm(model.centers[:, None, :] - DATA["blobs"][None], axis=-1)
    assert dists.min(axis=0).max() < 0.5


# ---------------------------------------------------------------------------
# Exactly-once across passes, and recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("traffic", [
    {"fail_plan": {1: [1]}},  # in every pass an attempt dies mid-partition, Spark retries it
    {"speculative": [0]},  # in every pass a duplicate runs after the original commits
], ids=["retried-attempt", "speculative-duplicate"])
@pytest.mark.parametrize("kind", ["kmeans", "logreg"])
def test_exactly_once_across_passes(kind, traffic, clean_fits, monkeypatch):
    steps = []
    real = port_est._DaemonFit.step

    def spy(self, pass_id, n, params=None):
        info = real(self, pass_id, n, params)
        steps.append(info["pass_rows"])
        return info

    monkeypatch.setattr(port_est._DaemonFit, "step", spy)
    est = _kmeans() if kind == "kmeans" else _logreg()
    model = _fit(est, _df(kind, **traffic), SEED_ROWS if kind == "kmeans" else 0)
    assert steps and set(steps) == {N}  # every pass counted each row once
    _same_model(model, clean_fits[kind], 1e-9)


class _RestartAfterFirstStep:
    """A daemon that restarts, at the same address and without its jobs,
    right after it acks the fit's first ``step``: the daemon's process
    dying between two passes."""

    def __init__(self):
        self.restarts = 0
        self.daemon = self._start(0)
        self.port = self.daemon.address[1]

    def _start(self, port):
        d = DataPlaneDaemon(port=port, device="cpu")
        real = d._dispatch

        def dispatch(conn, req):
            real(conn, req)
            if req.get("op") == "step" and self.restarts == 0:
                self.restarts += 1
                d.stop()
                self.daemon = self._start(self.port)

        d._dispatch = dispatch
        return d.start()


@pytest.mark.parametrize("recovery", ["0", "1"])
def test_daemon_restart_between_kmeans_passes(recovery, clean_fits):
    server = _RestartAfterFirstStep()
    try:
        session = SimSparkSession({"spark.srml.daemon.address": f"127.0.0.1:{server.port}",
                                   "spark.srml.fit.recovery_attempts": recovery})
        if recovery == "0":
            # The next pass's tasks meet a daemon that never saw the fit (one
            # task at a time, so the first failure is a task's own refusal).
            df = _df("kmeans", session=session, max_attempts=1, concurrency=1)
            with pytest.raises(RuntimeError, match="behind the fit"):
                _kmeans().fit(df)
        else:
            # The ledger's iterate is reinstalled by a creating set_iterate
            # and the pass replayed: the clean fit's model within 1e-12.
            df = _df("kmeans", session=session, max_attempts=1)
            _same_model(_kmeans().fit(df), clean_fits["kmeans"], 1e-12)
        assert server.restarts == 1
        assert server.daemon._jobs == {}  # the fit's job was dropped either way
    finally:
        server.daemon.stop()


def test_recovery_ledger_rebuilds_a_lost_logreg_job(clean_fits, monkeypatch):
    """The job vanishes after the last step (a TTL eviction): the finalize
    fails, the ledger's iterate recreates the job at that pass, and the fit
    ends at the clean model."""
    real_record, real_recover = port_est._DaemonFit.record, \
        port_est._DaemonFit.recover
    ledgers, recovered = [], []

    def record_then_lose(self):
        real_record(self)
        ledgers.append(self.ledger[1])
        if len(ledgers) == 2:
            self.client.drop(self.job)

    def recover(self, err):
        recovered.append(self.ledger[1])
        real_recover(self, err)

    monkeypatch.setattr(port_est._DaemonFit, "record", record_then_lose)
    monkeypatch.setattr(port_est._DaemonFit, "recover", recover)
    session = SimSparkSession({"spark.srml.fit.recovery_attempts": "1"})
    model = _fit(_logreg(), _df("logreg", session=session, max_attempts=1))
    assert ledgers[:2] == [1, 2] and recovered == [2]  # rebuilt at pass 2's iterate
    _same_model(model, clean_fits["logreg"], 1e-12)


def test_empty_dataframe_raises():
    for est, df in (
        (_kmeans(), simdf_from_numpy(np.empty((0, D)), n_partitions=2)),
        (_logreg(), simdf_from_numpy(np.empty((0, D)), n_partitions=2, label=np.empty(0))),
        (_linreg(), simdf_from_numpy(np.empty((0, D)), n_partitions=2, label=np.empty(0))),
    ):
        with pytest.raises(ValueError, match="empty"):
            est.fit(df)


# ---------------------------------------------------------------------------
# Served transform
# ---------------------------------------------------------------------------


def _core_model(kind):
    """A fitted core model (in memory on the CPU), wrapped as a Spark fit."""
    if kind == "kmeans":
        m = port_km.KMeans(device="cpu").setK(K).fit({"features": DATA["xk"]})
    elif kind == "linreg":
        m = port_lr.LinearRegression(device="cpu").fit(
            {"features": DATA["x"], "label": DATA["y_lin"]})
    else:
        m = port_lg.LogisticRegression(device="cpu").setMaxIter(5).fit(
            {"features": DATA["x"], "label": DATA["y_mc"]})
    return port_est._SparkModelAdapter(m)


@pytest.mark.parametrize("kind", ["kmeans", "linreg", "logreg"])
def test_served_transform_equals_local(kind, monkeypatch):
    # The default float32 config, which the executors' processes run too.
    with config.option("compute_dtype", "auto"), config.option("accum_dtype", "float32"):
        model = _core_model(kind)
        want = model.transform_matrix(DATA["xk"] if kind == "kmeans" else DATA["x"])
        algo, outputs = port_est._serve_spec(model._core)
        df = _df("kmeans" if kind == "kmeans" else "multinomial")
        served = model.transform(df).collect()
    assert [m.algo for m in daemon_session._owned["cpu"]._models.values()] == [algo]
    daemon_session.shutdown()
    monkeypatch.setenv("SRML_TRANSFORM_LOCAL", "1")
    local = model.transform(df).collect()
    assert daemon_session._owned == {}
    assert df.sparkSession.driver_rows_materialized == 0
    for role, col, kind_ in outputs:
        got_s = np.array([r[col] for r in served])
        got_l = np.array([r[col] for r in local])
        np.testing.assert_allclose(got_s, got_l, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got_s, want[role], rtol=1e-12, atol=1e-12)
        arrow = port_est._output_column(want[role], kind_, N)
        assert str(arrow.type) == {"int": "int32", "double": "double",
                                   "vec": "list<item: double>"}[kind_]
    if kind == "logreg":
        proba = np.array([r["probability"] for r in served])
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-9)
        pred = np.array([r["prediction"] for r in served])
        np.testing.assert_array_equal(pred, np.argmax(proba, axis=1).astype(np.float64))


# ---------------------------------------------------------------------------
# The JAX wrappers against the port's daemon; closures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["kmeans", "logreg"])
def test_jax_wrapper_against_the_ports_daemon(kind, clean_fits, mesh8):
    with DataPlaneDaemon(device="cpu") as pd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % pd.address})
        df = _df(kind, session=session)
        if kind == "kmeans":
            est = jax_est.SparkKMeans(mesh=mesh8).setK(K).setMaxIter(10).setSeed(5)
        else:
            est = jax_est.SparkLogisticRegression(mesh=mesh8).setRegParam(1e-2) \
                .setMaxIter(2).setTol(1e-3)
        model = est.fit(df)
        assert pd._jobs == {}  # finalized and dropped
    # The port's daemon answers the JAX driver with the port's own fit.
    _same_model(model, clean_fits[kind], 1e-9)


def _globals(payload: bytes):
    return [arg for op, arg, _ in pickletools.genops(payload) if isinstance(arg, str)]


def test_task_closures_pickle_without_torch():
    model = _core_model("logreg")._core
    model.transform_matrix(DATA["x"][:4])  # the scorer cache now holds tensors
    assert model._raw_cache
    outputs = port_est._serve_spec(model)[1]
    tasks = [
        port_est._FeedTask("h", 1, None, "job", "logreg", "features", 3, label_col="label",
                           params={"n_classes": C}),
        port_est._LabelMaxTask("label"),
        port_est._DaemonTransformTask(model, "h", 1, None, "features", "logreg", outputs),
        port_est._TransformTask(model, "features", outputs),
    ]
    for task in tasks:
        payload = pickle.dumps(task)
        refs = _globals(payload)
        assert not [r for r in refs if r == "torch" or r.startswith("torch.")], \
            (type(task).__name__, refs)
        assert "_raw_cache" not in refs
        pickle.loads(payload)
