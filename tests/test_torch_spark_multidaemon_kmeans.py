"""The port's ``SparkKMeans`` across daemons, through sparksim.

The upper half of the partitions feed a second port daemon
(``device="cpu"``, in this process) named in their executors' env. KMeans
seeds its centres on every daemon of ``spark.srml.daemon.addresses`` before
the first scan; after each step the primary's centres go to every peer
(``set_iterate``) and the next scan runs against them everywhere. The
port of the KMeans cases of ``tests/test_spark_multidaemon.py``:

* two daemons equal bitwise, on integer blobs, both the JAX package's
  stream fit of the same rows (``fit_kmeans_stream`` seeded from the same
  prefix sample) and the port's one-daemon fit (the sums and counts are
  exact float32 sums, and each blob's noise sums to zero, so the fixed
  point and its cost are exact), and both keep no job;
* on gaussian blobs in float64, one partition a daemon, the collective
  reduce and the hub give the same centres and cost bitwise, in the same
  passes, within 1e-8 of the JAX wrapper's fit on a JAX daemon, and the
  path counter counts one reduce a scan on the path that ran;
* a peer that was not configured is never seeded: its tasks' feeds are
  refused, and the fit fails loudly, every time;
* a peer that restarts between two passes (losing its job) is rewound with
  the ledger's iterate when ``recovery_attempts`` is 1, and the fit
  equals the JAX stream fit and the undisturbed one bitwise.
"""

import contextlib

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import kmeans as jax_km
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import daemon_addr, jax_ledger_off, split_routing

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

K, D, PER_BLOB = 4, 6, 100
SEED_ROWS = port_est._kmeans_seed_rows(K)  # the driver's prefix sample


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_DAEMON_ADDRESSES", "SRML_FIT_RECOVERY_ATTEMPTS"):
        monkeypatch.delenv(name, raising=False)
    yield
    daemon_session.shutdown()


def _blobs(integer=True):
    """K well-separated blobs. Integer blobs: integer centres, and each
    blob's noise is half rows and half their negatives, so a blob's mean is
    its centre exactly."""
    rng = np.random.default_rng(11)
    centres = rng.integers(-12, 13, size=(K, D)) * 6
    if integer:
        noise = rng.integers(-2, 3, size=(K, PER_BLOB // 2, D))
        noise = np.concatenate([noise, -noise], axis=1)
    else:
        noise = rng.normal(size=(K, PER_BLOB, D))
    x = (centres[:, None, :] + noise).reshape(-1, D).astype(np.float64)
    return x[rng.permutation(len(x))]


def _kmeans():
    return port_est.SparkKMeans(device="cpu").setK(K).setMaxIter(5).setSeed(3)


def _jax_kmeans(x, mesh, max_iter=5):
    """The JAX stream fit of the same rows at the wrapper's settings: the
    init scan reads the driver's prefix sample, every other scan the four
    partitions."""
    head = {"first": True}

    def source():
        return iter([x[:SEED_ROWS]] if head.pop("first", False) else np.array_split(x, 4))

    with jax_ledger_off():
        return jax_km.fit_kmeans_stream(source, k=K, n_cols=D, max_iter=max_iter, seed=3,
                                        init="k-means++", init_sample_rows=SEED_ROWS, mesh=mesh)


@pytest.fixture(scope="module")
def jax_fit(mesh8):
    return _jax_kmeans(_blobs(), mesh8)


def _assert_jax(model, ref, atol=0.0):
    np.testing.assert_allclose(model.centers, ref.centers, rtol=0, atol=atol)
    assert model.summary.numIter == ref.n_iter


def _configured(a, b, **conf):
    return {"spark.srml.daemon.addresses": f"{daemon_addr(a)},{daemon_addr(b)}", **conf}


def _split_df(a, b, x, conf=None, n_partitions=4, **kw):
    session, env_plan = split_routing(a, b, n_partitions, conf=conf)
    return simdf_from_numpy(x, n_partitions=n_partitions, session=session, env_plan=env_plan,
                            **kw)


def _paths():
    return {p: port_est._M_MESH_PATHS.value(path=p) for p in ("collective", "hub")}


def _assert_same(model, ref):
    np.testing.assert_array_equal(model.centers, ref.centers)
    assert model.summary.numIter == ref.summary.numIter
    assert model.summary.trainingCost == ref.summary.trainingCost


@pytest.fixture(scope="module")
def one_daemon_fit():
    with DataPlaneDaemon(device="cpu") as a:
        df = simdf_from_numpy(_blobs(), n_partitions=4, session=SimSparkSession(
            {"spark.srml.daemon.address": daemon_addr(a)}))
        return _kmeans().fit(df)


def test_two_daemons_equal_one_daemon_bitwise(one_daemon_fit, jax_fit):
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        before = _paths()
        split = _split_df(a, b, _blobs(), conf=_configured(a, b))
        model = _kmeans().fit(split)
        assert split.sparkSession.driver_rows_materialized <= SEED_ROWS
        _assert_jax(model, jax_fit)
        assert model.summary.trainingCost == float(jax_fit.cost)
        _assert_same(model, one_daemon_fit)
        # A reduce a scan: the passes, and the final cost-only scan.
        assert _paths()["collective"] == before["collective"] + model.summary.numIter + 1
        # The fixed point is the blobs' integer centres, and its cost exact.
        x = _blobs()
        d2 = ((x[:, None, :] - model.centers[None].astype(np.float64)) ** 2).sum(-1)
        assert model.summary.trainingCost == float(d2.min(axis=1).sum())
        assert a._jobs == {} and b._jobs == {}


def _f64():
    """Both packages in float64."""
    stack = contextlib.ExitStack()
    for cfg in (jax_config, config):
        stack.enter_context(cfg.option("compute_dtype", "float64"))
        stack.enter_context(cfg.option("accum_dtype", "float64"))
    return stack


def test_collective_and_hub_give_the_same_fit_bitwise(mesh8):
    x = _blobs(integer=False)
    fits, ran = {}, {}
    with _f64(), DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        for path in ("collective", "hub"):
            before = _paths()
            with config.option("mesh_collectives", path == "collective"):
                # One partition a daemon: each daemon folds the same rows in
                # the same order in both fits.
                fits[path] = _kmeans().setMaxIter(3).fit(
                    _split_df(a, b, x, conf=_configured(a, b), n_partitions=2))
            ran[path] = {p: _paths()[p] - before[p] for p in before}
            assert a._jobs == {} and b._jobs == {}
    _assert_same(fits["collective"], fits["hub"])
    # The JAX wrapper on a JAX daemon, float64 throughout (the JAX stream
    # fit casts its host batches to float32).
    with _f64(), jax_ledger_off(), JaxDaemon(mesh=mesh8) as jd:
        ref = jax_est.SparkKMeans(mesh=mesh8).setK(K).setMaxIter(3).setSeed(3).fit(
            simdf_from_numpy(x, n_partitions=2, session=SimSparkSession(
                {"spark.srml.daemon.address": daemon_addr(jd)})))
    np.testing.assert_allclose(fits["hub"].centers, ref.centers, rtol=0, atol=1e-8)
    assert fits["hub"].summary.numIter == ref.summary.numIter
    scans = fits["hub"].summary.numIter + 1
    assert ran == {"collective": {"collective": scans, "hub": 0},
                   "hub": {"collective": 0, "hub": scans}}


def test_an_unseeded_peer_fails_the_fit_loudly():
    """No ``spark.srml.daemon.addresses``: the driver cannot seed the peer,
    whose partitioned feeds are refused before any centre exists."""
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        for _ in range(2):  # every time, never by a race
            with pytest.raises(RuntimeError, match="seed"):
                _kmeans().fit(_split_df(a, b, _blobs(), max_attempts=1))
            assert a._jobs == {} and b._jobs == {}


class _RestartAfterFirstPush:
    """A peer daemon that restarts, at the same address and without its
    jobs, right after it acks the driver's first ``set_iterate`` (the
    boundary push after pass 0's step)."""

    def __init__(self):
        self.restarts = 0
        self.daemon = self._start(0)
        self.address = self.daemon.address

    def _start(self, port):
        d = DataPlaneDaemon(port=port, device="cpu")
        real = d._dispatch

        def dispatch(conn, req):
            real(conn, req)
            if req.get("op") == "set_iterate" and self.restarts == 0:
                self.restarts += 1
                d.stop()
                self.daemon = self._start(self.address[1])

        d._dispatch = dispatch
        return d.start()


def test_a_peer_restart_between_passes_replays_to_the_same_fit(one_daemon_fit, jax_fit):
    with DataPlaneDaemon(device="cpu") as a:
        server = _RestartAfterFirstPush()
        try:
            conf = _configured(a, server.daemon, **{"spark.srml.fit.recovery_attempts": "1"})
            model = _kmeans().fit(_split_df(a, server.daemon, _blobs(), conf=conf,
                                            max_attempts=1))
            assert server.restarts == 1
            _assert_jax(model, jax_fit)
            _assert_same(model, one_daemon_fit)
            assert a._jobs == {} and server.daemon._jobs == {}
        finally:
            server.daemon.stop()
