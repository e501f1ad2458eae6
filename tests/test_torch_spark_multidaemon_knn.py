"""The port's sharded nearest-neighbour index across daemons, through
sparksim.

A knn fit whose acks name several daemons builds one shard a daemon, its
committed partitions indexed under global partition-major ids
(``row_id_base``), and the handle's ``kneighbors`` and ``transform`` fan
each query batch out to every shard and merge the top-k. IVF shards share
one quantizer: the first daemon trains it on a sample drawn from every
daemon (``sample_rows``) and the others build against its centroids. The
port of the knn cases of ``tests/test_spark_multidaemon.py``, in float64
daemons (``device="cpu"``, in this process):

* exact kneighbors over two and over three daemons equals the JAX
  wrapper's index of the same DataFrame on a JAX daemon and the port's
  one-daemon index (ids exactly, distances within 1e-12), the driver's
  ndarray queries and the distributed ``transform`` alike; ``release``
  frees every shard;
* IVF over two daemons, with the peer holding a region the primary never
  sees, has bitwise one quantizer on both daemons with centroids in both
  regions, and with every list probed equals brute force;
* every executor routed to another daemon than the driver's: the index
  lives there, unsharded, and the handle queries and frees it there;
* a shard build that fails frees every daemon's job and shard.
"""

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import knn as jax_knn
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import daemon as port_daemon
from spark_rapids_ml_tpu_torch.spark import (
    SparkApproximateNearestNeighbors,
    SparkNearestNeighbors,
    daemon_session,
)
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import daemon_addr, jax_ledger_off, split_routing

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SRML_DAEMON_ADDRESS", raising=False)
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield
    daemon_session.shutdown()


@pytest.fixture
def two_daemons():
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
        yield a, b


def _session(a):
    return SimSparkSession({"spark.srml.daemon.address": daemon_addr(a)})


def test_exact_knn_over_two_and_three_daemons_equals_one_daemon(mesh8):
    rng = np.random.default_rng(1)
    n, d, k = 450, 8, 6
    x = rng.normal(size=(n, d))
    q = x[:30] + 0.01 * rng.normal(size=(30, d))
    # An unprimed exact-knn wrapper for the JAX daemon (see
    # tests/test_torch_multidaemon_processes.py).
    jax_knn._exact_knn_fn.cache_clear()
    with jax_ledger_off(), jax_config.option("compute_dtype", "float64"), \
            jax_config.option("accum_dtype", "float64"), JaxDaemon(mesh=mesh8) as jd:
        ref = jax_est.SparkNearestNeighbors().setK(k).fit(
            simdf_from_numpy(x, n_partitions=6, session=_session(jd)))
        jd1, ji1 = ref.kneighbors(q)
        ref.release()
    with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b, \
            DataPlaneDaemon(device="cpu") as c:
        one = SparkNearestNeighbors(device="cpu").setK(k).fit(
            simdf_from_numpy(x, n_partitions=6, session=_session(a)))
        assert one.shards is None
        d1, i1 = one.kneighbors(q)
        np.testing.assert_array_equal(i1, ji1)
        np.testing.assert_allclose(d1, jd1, rtol=0, atol=1e-12)
        for peers in ([b], [b, c]):
            plan = {2 + i: {"SRML_DAEMON_ADDRESS": daemon_addr(peers[i // 2 % len(peers)])}
                    for i in range(4)}
            split = simdf_from_numpy(x, n_partitions=6, session=_session(a), env_plan=plan)
            model = SparkNearestNeighbors(device="cpu").setK(k).fit(split)
            assert split.sparkSession.driver_rows_materialized == 0
            assert len(model.shards) == 1 + len(peers) and sum(r for _, r in model.shards) == n
            d2, i2 = model.kneighbors(q)
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_allclose(d2, d1, rtol=0, atol=1e-12)
            if len(peers) == 1:
                # The distributed query: each task fans its batch out too.
                rows = model.transform(simdf_from_numpy(q, n_partitions=2,
                                                        session=_session(a))).collect()
                np.testing.assert_array_equal(np.asarray([r["knn_indices"] for r in rows]), i1)
            for daemon in [a] + peers:
                assert model.daemon_model_name in daemon._models and not daemon._jobs
            assert model.release()
            for daemon in [a] + peers:
                assert model.daemon_model_name not in daemon._models
        one.release()


def test_ivf_shards_share_one_quantizer_trained_on_every_daemon(two_daemons):
    """The peer holds every row of region B: a quantizer trained on the
    primary's shard alone would put no centroid there."""
    a, b = two_daemons
    rng = np.random.default_rng(2)
    d, nlist, k = 8, 8, 5
    region_a = rng.normal(size=(240, d))
    region_b = rng.normal(size=(240, d)) + 40.0
    x = np.concatenate([region_a, region_b])  # partitions 0-1 A, 2-3 B (the peer's)
    session, env_plan = split_routing(a, b)
    model = SparkApproximateNearestNeighbors(device="cpu").setK(k).setNlist(nlist) \
        .setNprobe(nlist).fit(simdf_from_numpy(x, n_partitions=4, session=session,
                                                env_plan=env_plan))
    assert len(model.shards) == 2
    cen_a = np.asarray(a._models[model.daemon_model_name].model.index.centroids)
    cen_b = np.asarray(b._models[model.daemon_model_name].model.index.centroids)
    np.testing.assert_array_equal(cen_a, cen_b)
    assert (cen_a.mean(axis=1) > 20).sum() >= 1 and (cen_a.mean(axis=1) < 20).sum() >= 1
    q = np.concatenate([region_a[:8], region_b[:8]])
    dists, idx = model.kneighbors(q)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx, np.argsort(d2, axis=1, kind="stable")[:, :k])
    # The index holds float32 rows (the reference's tolerance, :465-467).
    np.testing.assert_allclose(dists, np.sqrt(np.take_along_axis(d2, idx, 1)), atol=1e-4)
    model.release()
    assert not a._models and not b._models


def test_one_other_daemon_serves_its_unsharded_index(two_daemons):
    a, b = two_daemons
    x = np.random.default_rng(3).normal(size=(200, 6))
    every = {pid: {"SRML_DAEMON_ADDRESS": daemon_addr(b)} for pid in range(4)}
    model = SparkNearestNeighbors(device="cpu").setK(3).fit(
        simdf_from_numpy(x, n_partitions=4, session=_session(a), env_plan=every))
    assert model.shards is None
    assert model.daemon_model_name in b._models and model.daemon_model_name not in a._models
    _, idx = model.kneighbors(x[:16])
    np.testing.assert_array_equal(idx[:, 0], np.arange(16))
    assert model.release() and not b._models


def test_a_failed_shard_build_frees_every_shard(two_daemons, monkeypatch):
    a, b = two_daemons
    real = port_daemon._Job.build_knn_model
    calls = []

    def flaky_build(self, params, extra_arrays=None):
        calls.append(1)
        if len(calls) == 2:  # the second shard's build dies
            raise ValueError("injected build failure")
        return real(self, params, extra_arrays)

    monkeypatch.setattr(port_daemon._Job, "build_knn_model", flaky_build)
    session, env_plan = split_routing(a, b)
    df = simdf_from_numpy(np.random.default_rng(4).normal(size=(200, 6)), n_partitions=4,
                          session=session, env_plan=env_plan)
    with pytest.raises(RuntimeError, match="injected build failure"):
        SparkNearestNeighbors(device="cpu").setK(3).fit(df)
    assert len(calls) == 2
    assert not a._jobs and not b._jobs, "the failed fit left a shard's rows"
    assert not a._models and not b._models, "the failed fit left a built shard"
