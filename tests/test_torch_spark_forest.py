"""The port's ``SparkRandomForestClassifier`` and ``SparkRandomForestRegressor``
through sparksim, against the JAX package.

sparksim (``tests/sparksim.py``) runs each partition task in its own OS
process over real TCP, with Spark's retries. Both packages run in float64
(the daemons run in this process, so their configs reach the folds), on
three classes and integer regression targets: every histogram sum is an
integer, exact in any order, so the forests compare bitwise.

* the port's wrappers against the port's daemon equal the JAX wrappers
  against the in-process JAX daemon, every table; the driver materializes
  no row beyond the bin edges' prefix sample;
* the JAX wrapper against the port's daemon gives the same forest;
* a task attempt that dies mid-partition in every pass changes nothing;
* a daemon restarted right after the first pass's step: with
  ``recovery_attempts`` 1 the fit replays from the ledger's iterate and
  its tables equal the undisturbed fit's bitwise; with 0 it fails loudly;
* an empty DataFrame raises; a partition routed to a second daemon that
  is not configured (it never gets the iterate) fails the fit and leaves
  no job on either, and configured it is a peer of the same forest;
* the served Spark ``transform`` equals the local predict.

Tasks are forkserver processes that import the port (about 2 s a pass of
three partitions), so the forests keep to depth 3.
"""

import contextlib

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import random_forest as port_rf
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

N, D, C, PARTS = 360, 5, 3, 3


def _f64():
    stack = contextlib.ExitStack()
    stack.enter_context(jax_ledger_off())
    for cfg in (jax_config, config):
        stack.enter_context(cfg.option("compute_dtype", "float64"))
        stack.enter_context(cfg.option("accum_dtype", "float64"))
    return stack


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_TRANSFORM_LOCAL", "SRML_FIT_RECOVERY_ATTEMPTS",
                 "SRML_FIT_DAEMON_LOSS_TOLERANCE", "SRML_FIT_DAEMON_JOIN_POLICY"):
        monkeypatch.delenv(name, raising=False)
    with _f64():
        yield
    daemon_session.shutdown()


def _data():
    rng = np.random.default_rng(41)
    x = rng.normal(size=(N, D)) * np.linspace(0.5, 2.0, D)
    z = x[:, 0] - 0.7 * x[:, 2] + 0.4 * x[:, 3]
    return {
        "x": x,
        "cls": np.digitize(z + 0.3 * rng.normal(size=N), [-0.8, 0.8]).astype(np.float64),
        "int": np.round(8 * z + 2 * x[:, 1]),
    }


DATA = _data()
KINDS = {"classifier": "cls", "regressor": "int"}


def _est(pkg, kind, **kw):
    """The wrapper of ``pkg`` (the port's or the JAX estimator module) at
    the test's settings: 4 trees (3 for the regressor), depth 3, 16 bins."""
    if kind == "classifier":
        return pkg.SparkRandomForestClassifier(**kw).setNumTrees(4).setMaxDepth(3) \
            .setMaxBins(16).setSeed(7)
    return pkg.SparkRandomForestRegressor(**kw).setNumTrees(3).setMaxDepth(3).setMaxBins(16) \
        .setSeed(3).setMinInstancesPerNode(2)


def _df(kind, **kw):
    return simdf_from_numpy(DATA["x"], n_partitions=PARTS, label=DATA[KINDS[kind]], **kw)


def _fit(est, df):
    model = est.fit(df)
    # Only the bin edges' prefix sample reaches the driver.
    assert df.sparkSession.driver_rows_materialized <= N
    return model


def _assert_same_forest(a, b):
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in b.arrays:
        np.testing.assert_array_equal(np.asarray(a.arrays[k]), np.asarray(b.arrays[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def port_fits():
    """Each port wrapper's clean fit against the port's own daemon."""
    with _f64():
        fits = {kind: _fit(_est(port_est, kind, device="cpu"), _df(kind)) for kind in KINDS}
    daemon_session.shutdown()
    return fits


# ---------------------------------------------------------------------------
# Against the JAX wrappers and daemon
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_wrapper_matches_the_jax_wrapper_and_daemon(kind, port_fits, mesh8):
    with JaxDaemon(mesh=mesh8) as jd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % jd.address})
        ref = _fit(_est(jax_est, kind), _df(kind, session=session))
        assert jd._jobs == {}
    model = port_fits[kind]
    assert isinstance(model, port_est._SparkModelAdapter)
    assert isinstance(model._core, port_rf.RandomForestClassificationModel if kind == "classifier"
                      else port_rf.RandomForestRegressionModel)
    assert model.numClasses == (C if kind == "classifier" else 0)
    assert model.getMaxDepth() == 3 and model.uid.startswith("RandomForest")
    _assert_same_forest(model, ref)
    assert model.totalNumNodes > model.getNumTrees()  # the trees split


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_wrapper_against_the_ports_daemon(kind, port_fits):
    with DataPlaneDaemon(device="cpu") as pd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % pd.address})
        model = _fit(_est(jax_est, kind), _df(kind, session=session))
        assert pd._jobs == {}  # finalized and dropped
    _assert_same_forest(model, port_fits[kind])


def test_a_dying_attempt_in_every_pass_changes_nothing(port_fits, monkeypatch):
    steps = []
    real = port_est._DaemonFit.step

    def spy(self, pass_id, n, params=None):
        info = real(self, pass_id, n, params)
        steps.append((info["depth"], info["pass_rows"]))
        return info

    monkeypatch.setattr(port_est._DaemonFit, "step", spy)
    model = _fit(_est(port_est, "classifier", device="cpu"),
                 _df("classifier", fail_plan={1: [1]}))
    assert [d for d, _ in steps] == list(range(1, len(steps) + 1))
    assert {n for _, n in steps} == {N}  # every pass counted each row once
    _assert_same_forest(model, port_fits["classifier"])


# ---------------------------------------------------------------------------
# Recovery at a pass boundary
# ---------------------------------------------------------------------------


class _RestartAfterFirstStep:
    """A daemon that restarts, at the same address and without its jobs,
    right after it acks the fit's first ``step``: the daemon's process
    dying at a pass boundary."""

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
def test_forest_fit_recovers_from_a_boundary_restart_bitwise(recovery, port_fits, monkeypatch):
    """The single-daemon half of tests/test_forest.py's boundary-crash
    test: with recovery the ledger's iterate recreates the job (a creating
    set_iterate) and the pass replays, giving the undisturbed forest
    bitwise; without it the next pass's feeds meet a daemon that never saw
    the fit (a pass-1 feed into a new job at pass 0), and the fit fails
    loudly."""
    recovered = []
    real_recover = port_est._DaemonFit.recover

    def recover(self, err):
        recovered.append(int(self.ledger[1]))
        real_recover(self, err)

    monkeypatch.setattr(port_est._DaemonFit, "recover", recover)
    server = _RestartAfterFirstStep()
    try:
        session = SimSparkSession({"spark.srml.daemon.address": f"127.0.0.1:{server.port}",
                                   "spark.srml.fit.recovery_attempts": recovery})
        df = _df("classifier", session=session, max_attempts=1, concurrency=1)
        est = _est(port_est, "classifier", device="cpu")
        if recovery == "0":
            with pytest.raises(RuntimeError, match="behind the fit"):
                est.fit(df)
            assert recovered == []
        else:
            _assert_same_forest(_fit(est, df), port_fits["classifier"])
            assert recovered == [0]  # the seeded iterate, reinstalled after the restart
        assert server.restarts == 1
        assert server.daemon._jobs == {}  # the fit's job was dropped either way
    finally:
        server.daemon.stop()


# ---------------------------------------------------------------------------
# Refusals and serving
# ---------------------------------------------------------------------------


def test_empty_dataframe_raises():
    for kind in KINDS:
        df = simdf_from_numpy(np.empty((0, D)), n_partitions=2, label=np.empty(0))
        with pytest.raises(ValueError, match="empty"):
            _est(port_est, kind, device="cpu").fit(df)
    assert daemon_session._owned["cpu"]._jobs == {}


def test_a_second_daemon_fails_the_fit_and_keeps_no_job(port_fits):
    """A partition routed to a daemon that is not in
    ``spark.srml.daemon.addresses`` meets a job without the forest's
    iterate (the driver installs it on the configured daemons only): its
    task fails loudly, never binning differently, and no daemon keeps a
    job. Configured, the same daemon is a peer and the forest is the
    one-daemon forest, bitwise."""
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % a.address})
        route = {2: {"SRML_DAEMON_ADDRESS": "%s:%d" % b.address}}
        df = _df("classifier", session=session, max_attempts=1, env_plan=route)
        with pytest.raises(Exception, match="iterate is installed"):
            _est(port_est, "classifier", device="cpu").fit(df)
        assert a._jobs == {} and b._jobs == {}
        configured = SimSparkSession({
            "spark.srml.daemon.address": "%s:%d" % a.address,
            "spark.srml.daemon.addresses": "%s:%d,%s:%d" % (*a.address, *b.address)})
        model = _fit(_est(port_est, "classifier", device="cpu"),
                     _df("classifier", session=configured, env_plan=route))
        _assert_same_forest(model, port_fits["classifier"])
        assert a._jobs == {} and b._jobs == {}


@pytest.mark.parametrize("kind", list(KINDS))
def test_served_spark_transform_equals_the_local_predict(kind, port_fits):
    model = port_fits[kind]
    q = DATA["x"][:60]
    rows = model.transform(simdf_from_numpy(q, n_partitions=2)).collect()
    got = np.asarray([r["prediction"] for r in rows])
    np.testing.assert_array_equal(got, np.asarray(model.predict(q), np.float64))
    served = daemon_session._owned["cpu"]._models
    assert [m.algo for m in served.values()] == ["rf_" + kind]
