"""The port's ``SparkNearestNeighbors`` and
``SparkApproximateNearestNeighbors`` through sparksim, against the JAX
package.

sparksim (``tests/sparksim.py``) runs each partition task in its own OS
process over real TCP, with Spark's retries. The fits feed the port's
daemon (the driver's own, ``device="cpu"``, in this process, float32 in
both packages unless a case says float64); the index is built and served
there, and every fit asserts that the driver materialized no row. The
port's counterparts of ``tests/test_spark_distributed.py``:277-399:

* exact kneighbors against float64 brute force of the float32 rows, ids
  global partition-major positions; the distributed ``transform`` columns
  ``knn_distances`` (list<double>) and ``knn_indices`` (list<long>);
* ANN recall@5 > 0.95 on clustered data (every list probed) and > 0.9
  under cosine;
* a task retry gives the clean fit's answers bitwise;

and beyond them: the port's wrappers against the JAX wrappers on the same
DataFrame (the JAX wrapper fitting the JAX daemon), ``release``,
``write``, an empty DataFrame, a second daemon in the acks (a two-shard
index), the cleanup of a failed build, and the task closure pickling
without torch.
"""

import contextlib
import pickle
import pickletools

import numpy as np
import pyarrow as pa
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.serve import daemon as jax_daemon_mod
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import (
    SparkApproximateNearestNeighbors,
    SparkNearestNeighbors,
    daemon_session,
)
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)


def _dtypes(name):
    stack = contextlib.ExitStack()
    for cfg in (jax_config, config):
        stack.enter_context(cfg.option("compute_dtype", name))
        stack.enter_context(cfg.option("accum_dtype", name))
    return stack


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_TRANSFORM_LOCAL", "SRML_FIT_RECOVERY_ATTEMPTS",
                 "SRML_FIT_DAEMON_LOSS_TOLERANCE", "SRML_FIT_DAEMON_JOIN_POLICY"):
        monkeypatch.delenv(name, raising=False)
    # The JAX daemon's ivf build at its host path, the port's only one.
    monkeypatch.setattr(jax_daemon_mod, "_IVF_DEVICE_BUILD_MAX_BYTES", 0)
    with jax_ledger_off(), _dtypes("float32"):
        yield
    daemon_session.shutdown()


@pytest.fixture(scope="module")
def normal_rows():
    return np.random.default_rng(5).normal(size=(600, 12))


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(6)
    centers = rng.normal(size=(12, 16)) * 10
    return np.concatenate([c + rng.normal(size=(80, 16)) for c in centers]).astype(np.float32)


def _fit(est, df):
    model = est.fit(df)
    assert df.sparkSession.driver_rows_materialized == 0
    return model


def _brute(x, q, k):
    """float64 squared distances to the float32-rounded rows (the index
    stores float32) and the k nearest ids, ties to the lowest id."""
    xf = np.asarray(x, np.float32).astype(np.float64)
    d2 = ((np.asarray(q, np.float64)[:, None, :] - xf[None, :, :]) ** 2).sum(-1)
    return d2, np.argsort(d2, axis=1, kind="stable")[:, :k]


def _assert_sq_close(dists, want_d2, x, q):
    """Euclidean distances against float64 squared distances, compared
    squared: the f32 ‖q‖² + ‖r‖² − 2q·r is good to a few ulps of the
    norms' sum (1e-6 of it here), which the square root would amplify near
    0 (a query that is a database row)."""
    scale = float((np.asarray(q, np.float64) ** 2).sum(1).max()
                  + (x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(dists ** 2, want_d2, rtol=0, atol=1e-6 * scale)


def _recall(idx, want):
    k = want.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(idx, want)]))


def test_exact_fit_is_distributed_and_matches_brute_force(normal_rows):
    x, k = normal_rows, 5
    model = _fit(SparkNearestNeighbors(device="cpu").setK(k), simdf_from_numpy(x, 4))
    assert isinstance(model, port_est._DaemonKNNModel)
    assert model.numRows == x.shape[0] and model.shards is None
    assert model.daemon_model_name.startswith("knnidx-")
    q = x[:32]
    dists, idx = model.kneighbors(q)
    d2, want = _brute(x, q, k)
    np.testing.assert_array_equal(idx, want)
    _assert_sq_close(dists, np.take_along_axis(d2, idx, axis=1), x, q)
    assert idx[:, 0].tolist() == list(range(32))  # each row is its own nearest
    daemon = daemon_session._owned["cpu"]
    assert daemon._jobs == {} and [m.algo for m in daemon._models.values()] == ["knn"]


def test_transform_is_distributed_with_ivec_indices(normal_rows):
    x, k = normal_rows[:400], 3
    model = _fit(SparkNearestNeighbors(device="cpu").setK(k), simdf_from_numpy(x, 3))
    qdf = simdf_from_numpy(x[:40], n_partitions=2)
    rows = model.transform(qdf).collect()
    assert qdf.sparkSession.driver_rows_materialized == 0
    idx = np.asarray([r["knn_indices"] for r in rows])
    dist = np.asarray([r["knn_distances"] for r in rows])
    assert idx.shape == (40, k) and dist.shape == (40, k)
    np.testing.assert_array_equal(idx[:, 0], np.arange(40))
    want_d, want_i = model.kneighbors(x[:40])
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_array_equal(dist, want_d)
    # The task's own batches: list<double> distances, list<int64> indices.
    task = port_est._DaemonKNNTask(*daemon_session._owned["cpu"].address, None,
                                   model.daemon_model_name, "features", k)
    (out,) = list(task(iter(simdf_from_numpy(x[:6], 1)._parts[0].to_batches())))
    assert out.schema.field("knn_distances").type == pa.list_(pa.float64())
    assert out.schema.field("knn_indices").type == pa.list_(pa.int64())
    assert out.column("features").to_pylist() == x[:6].tolist()


def test_ann_recall_on_clustered_data(blobs):
    k = 5
    model = _fit(SparkApproximateNearestNeighbors(device="cpu").setK(k).setNlist(12)
                 .setNprobe(12), simdf_from_numpy(blobs, 4))
    assert model.numRows == blobs.shape[0]
    q = blobs[:64]
    dists, idx = model.kneighbors(q)
    assert _recall(idx, _brute(blobs, q, k)[1]) > 0.95
    rows = model.transform(simdf_from_numpy(q, n_partitions=2)).collect()
    np.testing.assert_array_equal(np.asarray([r["knn_indices"] for r in rows]), idx)


def test_ann_cosine():
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(8, 12))
    x = np.concatenate([dr * rng.uniform(0.5, 3.0, size=(60, 1)) + 0.03 * rng.normal(size=(60, 12))
                        for dr in dirs]).astype(np.float32)
    k = 5
    model = _fit(SparkApproximateNearestNeighbors(device="cpu").setK(k).setNlist(8).setNprobe(8)
                 .setMetric("cosine"), simdf_from_numpy(x, 3))
    q = x[:24]
    dists, idx = model.kneighbors(q)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    want = np.argsort(1.0 - qn @ xn.T, axis=1, kind="stable")[:, :k]
    assert _recall(idx, want) > 0.9
    assert np.all(dists[np.isfinite(dists)] <= 2 + 1e-5)


def test_fit_survives_a_task_retry_bitwise(normal_rows):
    x, k = normal_rows[:300], 4
    m1 = _fit(SparkNearestNeighbors(device="cpu").setK(k), simdf_from_numpy(x, 3))
    m2 = _fit(SparkNearestNeighbors(device="cpu").setK(k),
              simdf_from_numpy(x, 3, fail_plan={1: [1]}))
    q = x[:20]
    (d1, i1), (d2, i2) = m1.kneighbors(q), m2.kneighbors(q)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_port_wrappers_match_the_jax_wrappers(kind, blobs, mesh1):
    """The same DataFrame through the JAX wrapper (fitting the JAX daemon)
    and the port's (its own daemon): the same neighbours, for 40 held-out
    queries of the same blobs. The IVF case runs in float64 in both
    packages, which train the same quantizer."""
    rng = np.random.default_rng(8)
    q = (blobs[rng.integers(0, len(blobs), 40)] + rng.normal(size=(40, 16))).astype(np.float32)
    k = 6
    dtype = _dtypes("float64") if kind == "ivf" else contextlib.nullcontext()
    with dtype, JaxDaemon(mesh=mesh1) as jd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % jd.address})
        if kind == "exact":
            jax_w, port_w = jax_est.SparkNearestNeighbors(), SparkNearestNeighbors(device="cpu")
        else:
            jax_w = jax_est.SparkApproximateNearestNeighbors().setNlist(12).setNprobe(12)
            port_w = SparkApproximateNearestNeighbors(device="cpu").setNlist(12).setNprobe(12)
        jm = _fit(jax_w.setK(k), simdf_from_numpy(blobs, 4, session=session))
        jd_, ji = jm.kneighbors(q)
        pm = _fit(port_w.setK(k), simdf_from_numpy(blobs, 4))
        pd_, pi = pm.kneighbors(q)
    np.testing.assert_array_equal(pi, ji)
    _assert_sq_close(pd_, jd_ ** 2, blobs, q)


def test_release_frees_the_index_and_write_raises(normal_rows):
    model = _fit(SparkNearestNeighbors(device="cpu").setK(3), simdf_from_numpy(normal_rows, 2))
    daemon = daemon_session._owned["cpu"]
    assert model.daemon_model_name in daemon._models
    with pytest.raises(NotImplementedError, match="cannot be persisted"):
        model.write()
    assert model.release() is True
    assert daemon._models == {}
    assert model.release() is False
    with pytest.raises(RuntimeError, match="no such model"):
        model.kneighbors(normal_rows[:2])


def test_empty_dataframe_raises():
    with pytest.raises(ValueError, match="empty"):
        SparkNearestNeighbors(device="cpu").fit(simdf_from_numpy(np.empty((0, 6)), 3))
    assert daemon_session._owned["cpu"]._models == {}


def test_acks_naming_a_second_daemon_are_refused(normal_rows):
    """The name is historical: acks that name a second daemon were refused
    until the multi-daemon plane. Now each daemon builds the shard of its
    partitions and the fan-out answers as one index would."""
    x, k = normal_rows, 5
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % a.address})
        df = simdf_from_numpy(x, n_partitions=3, session=session,
                              env_plan={2: {"SRML_DAEMON_ADDRESS": "%s:%d" % b.address}})
        model = _fit(SparkNearestNeighbors(device="cpu").setK(k), df)
        assert [n for _, n in model.shards] == [400, 200]  # the primary's shard first
        q = x[:32]
        dists, idx = model.kneighbors(q)
        d2, want = _brute(x, q, k)
        np.testing.assert_array_equal(idx, want)
        _assert_sq_close(dists, np.take_along_axis(d2, idx, axis=1), x, q)
        assert model.release()
        assert a._jobs == {} and b._jobs == {} and a._models == {} and b._models == {}


def test_a_failed_build_check_drops_the_job_and_the_index(normal_rows, monkeypatch):
    """Acks that disagree with the built index fail the fit with the
    split-brain error, and the dataset-sized index goes at once."""
    real = port_est._DaemonFit.account

    def inflated(self, acks):
        n = real(self, acks)
        self.total_fed += 1
        return n

    monkeypatch.setattr(port_est._DaemonFit, "account", inflated)
    with pytest.raises(RuntimeError, match="row-count mismatch at knn index build"):
        SparkNearestNeighbors(device="cpu").fit(simdf_from_numpy(normal_rows, 2))
    daemon = daemon_session._owned["cpu"]
    assert daemon._jobs == {} and daemon._models == {}


def test_inner_product_ivf_is_refused_before_any_row(normal_rows, monkeypatch):
    df = simdf_from_numpy(normal_rows, 2)
    monkeypatch.setattr(SimDataFrame, "mapInArrow",
                        lambda *a: pytest.fail("a task ran for a refused metric"))
    with pytest.raises(ValueError, match="inner_product"):
        SparkApproximateNearestNeighbors(device="cpu").setMetric("inner_product").fit(df)


def test_query_task_pickles_without_torch():
    task = port_est._DaemonKNNTask("h", 1, None, "knnidx-x", "features", 5)
    payload = pickle.dumps(task)
    refs = [arg for op, arg, _ in pickletools.genops(payload) if isinstance(arg, str)]
    assert not [r for r in refs if r == "torch" or r.startswith("torch.")], refs
    pickle.loads(payload)
