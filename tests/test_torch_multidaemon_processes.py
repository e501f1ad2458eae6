"""Two port daemons in two OS processes: the shape of two executor hosts.

Each daemon is its own interpreter (``tests/torch_daemon_worker.py``, which
imports only the port), so neither is in the other's membership registry
and every pass reduces through the driver's hub (``export_state`` from the
peer, ``merge_state`` into the primary). Executor tasks (sparksim's
processes) split their feeds between the two. The port of
``tests/test_spark_multidaemon.py::test_two_daemon_processes_end_to_end``:
the split fit equals the one-daemon fit for PCA (bitwise, integer rows),
KMeans (bitwise centres, with the address list) and exact kneighbors over
a sharded index (ids exactly; the workers compute in float32, so
distances within its tolerance). Each split fit is also held to the JAX
package's fit of the same rows: PCA's in-memory ``fit_pca`` (float64) at
PCASuite's 1e-5, KMeans's stream fit from the same seed sample (the same
passes, centres one float32 rounding apart), and the in-memory exact
``NearestNeighbors`` (ids exactly, distances at the reference's float32
tolerance).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu.models import kmeans as jax_km
from spark_rapids_ml_tpu.models import knn as jax_knn
from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu_torch.spark import SparkKMeans, SparkNearestNeighbors, SparkPCA
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_TOL = 1e-5  # PCASuite.scala:87


@pytest.fixture(scope="module")
def worker_addrs():
    env = {k: v for k, v in os.environ.items() if not k.startswith("SRML_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    # Both spawned before either READY is read: the imports overlap.
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_daemon_worker.py")],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT, env=env,
                              text=True) for _ in range(2)]
    try:
        addrs = []
        for proc in procs:
            line = proc.stdout.readline().strip()
            assert line.startswith("READY "), line
            addrs.append(f"127.0.0.1:{int(line.split()[1])}")
        yield addrs
    finally:
        for proc in procs:
            try:
                proc.stdin.close()
                proc.wait(timeout=10)
            except Exception:
                proc.kill()


def _fit(est, x, addr_a, env_plan=None, **conf):
    df = simdf_from_numpy(x, n_partitions=4, env_plan=env_plan, session=SimSparkSession(
        {"spark.srml.daemon.address": addr_a, **conf}))
    model = est.fit(df)
    assert df.sparkSession.driver_rows_materialized <= 128  # kmeans's seed sample at most
    return model


def _jax_kmeans(x, k, mesh):
    """The JAX stream fit at the wrapper's settings: the init scan reads the
    driver's prefix sample, every other scan the four partitions."""
    seed_rows = port_est._kmeans_seed_rows(k)
    head = {"first": True}

    def source():
        return iter([x[:seed_rows]] if head.pop("first", False) else np.array_split(x, 4))

    return jax_km.fit_kmeans_stream(source, k=k, n_cols=x.shape[1], max_iter=6, seed=7,
                                    init="k-means++", init_sample_rows=seed_rows, mesh=mesh)


def test_two_daemon_processes_end_to_end(worker_addrs, mesh8):
    addr_a, addr_b = worker_addrs
    to_b = {2: {"SRML_DAEMON_ADDRESS": addr_b}, 3: {"SRML_DAEMON_ADDRESS": addr_b}}
    rng = np.random.default_rng(42)
    paths = port_est._M_MESH_PATHS

    x = rng.integers(-8, 9, size=(800, 16)).astype(np.float64)
    one = _fit(SparkPCA(device="cpu").setK(4), x, addr_a)
    hub = paths.value(path="hub")
    two = _fit(SparkPCA(device="cpu").setK(4), x, addr_a, to_b)
    assert paths.value(path="hub") == hub + 1  # the peer is in another registry
    np.testing.assert_array_equal(two.pc, one.pc)
    np.testing.assert_array_equal(two.mean, one.mean)
    with jax_ledger_off():
        ref = jax_pca.fit_pca(x, k=4, mesh=mesh8)
    np.testing.assert_allclose(np.abs(two.pc), np.abs(ref.pc), atol=JAX_TOL)
    np.testing.assert_allclose(two.explainedVariance, ref.explained_variance, atol=JAX_TOL)
    np.testing.assert_allclose(two.mean, ref.mean, atol=JAX_TOL)

    # Iterative across processes, every daemon seeded from the address list.
    k, d = 3, 6
    centres = rng.integers(-12, 13, size=(k, d)) * 4
    xk = np.concatenate([c + rng.integers(-1, 2, size=(120, d)) for c in centres]) \
        .astype(np.float64)
    km_one = _fit(SparkKMeans(device="cpu").setK(k).setMaxIter(6).setSeed(7), xk, addr_a)
    km_two = _fit(SparkKMeans(device="cpu").setK(k).setMaxIter(6).setSeed(7), xk, addr_a, to_b,
                  **{"spark.srml.daemon.addresses": f"{addr_a},{addr_b}"})
    np.testing.assert_array_equal(km_two.centers, km_one.centers)
    assert km_two.summary.numIter == km_one.summary.numIter
    with jax_ledger_off():
        km_ref = _jax_kmeans(xk, k, mesh8)
    # The sums and counts are exact; a worker divides them in float32, the
    # JAX fit in float64: one float32 rounding of the quotient apart.
    np.testing.assert_allclose(km_two.centers, km_ref.centers, rtol=np.finfo(np.float32).eps,
                               atol=0)
    assert km_two.summary.numIter == km_ref.n_iter

    # The sharded index across processes: each daemon serves its own shard.
    xq = rng.normal(size=(400, 8))
    qs = xq[:24]
    nn_one = _fit(SparkNearestNeighbors(device="cpu").setK(5), xq, addr_a)
    nn_two = _fit(SparkNearestNeighbors(device="cpu").setK(5), xq, addr_a, to_b)
    assert len(nn_two.shards) == 2
    d1, i1 = nn_one.kneighbors(qs)
    d2, i2 = nn_two.kneighbors(qs)
    np.testing.assert_array_equal(i2, i1)
    # float32 in the workers: a self-distance is 0 or sqrt of f32 noise.
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=2e-3)
    # A JAX daemon of another test in this process may have AOT-primed the
    # process-wide exact-knn wrapper at these shapes, and a primed wrapper
    # asks jax.core.trace_state_clean, which jax releases from 0.9 no longer
    # have: a fresh wrapper runs the same jit unprimed.
    jax_knn._exact_knn_fn.cache_clear()
    with jax_ledger_off():
        dj, ij = jax_knn.NearestNeighbors(mesh=mesh8).setK(5).fit({"features": xq}).kneighbors(qs)
    np.testing.assert_array_equal(i2, ij)
    np.testing.assert_allclose(d2, dj, rtol=1e-5, atol=2e-3)
    assert nn_two.release() and nn_one.release()
