"""The port's Spark session helpers against the JAX package's.

Host-only and fast:

* ``spark/daemon_session.py``: every reader gives the JAX module's value
  for the same env, Spark conf and config default (neither side jits, so
  they compare directly); ``task_context`` falls back to the env and
  ``executor_daemon_address`` routes by it;
* ``spark/conf.py``: ``gpu_session_conf`` returns the upstream spark-rapids
  keys with the resource ``gpu``;
* ``spark/discovery.py``: the payload on a machine with no card, and the
  script, written executable, that runs the port's module;
* ``bridge/native.py``: its three wrappers equal the JAX loader's and
  numpy's (the library is built with ``make -C native`` if missing; the
  tests skip without a toolchain, as ``tests/test_native.py`` does); a
  lookup made before the library exists loads it once it appears; the
  Arrow bridge's ``list`` gather and multi-chunk concatenation go through
  it and give numpy's matrices;
* the wrapper's pass-through for in-memory data and its clear error for a
  Spark-shaped dataset without pyspark;
* what the Spark path reads from the client (``server_id``, the acks'
  identities, ``finalize(with_meta=True)``), as the JAX client reads it.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.bridge import native as jax_native
from spark_rapids_ml_tpu.spark import daemon_session as jax_ds
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.bridge import arrow as port_arrow
from spark_rapids_ml_tpu_torch.bridge import native as port_native
from spark_rapids_ml_tpu_torch.spark import (
    SparkPCA,
    daemon_session,
    discovery,
    discovery_payload,
    gpu_session_conf,
    write_discovery_script,
)
from spark_rapids_ml_tpu_torch.spark import estimator as port_est

from sparksim import SimSparkSession

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SO = os.path.join(REPO, "native", "build", "libsrml_tpu.so")

_FIT_ENV = (
    "SRML_FIT_RECOVERY_ATTEMPTS", "SRML_FIT_DAEMON_LOSS_TOLERANCE",
    "SRML_FIT_DAEMON_JOIN_POLICY", "SRML_DAEMON_ADDRESS",
    "SRML_DAEMON_TOKEN", "SRML_DAEMON_TIMEOUT_S", "SRML_DAEMON_OP_DEADLINE_S",
    "SRML_DAEMON_OP_ATTEMPTS", "SRML_PARTITION_ID", "SRML_ATTEMPT",
)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in _FIT_ENV:
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# daemon_session: the same values as the JAX module's
# ---------------------------------------------------------------------------

_READERS = ("recovery_attempts", "daemon_loss_tolerance", "daemon_join_policy",
            "client_kwargs")

_CASES = {
    "defaults": ({}, {}),
    "env": ({"SRML_FIT_RECOVERY_ATTEMPTS": "3", "SRML_FIT_DAEMON_LOSS_TOLERANCE": "1",
             "SRML_FIT_DAEMON_JOIN_POLICY": "Boundary", "SRML_DAEMON_TIMEOUT_S": "9",
             "SRML_DAEMON_OP_DEADLINE_S": "30", "SRML_DAEMON_OP_ATTEMPTS": "7"}, {}),
    "conf": ({}, {"spark.srml.fit.recovery_attempts": "2",
                  "spark.srml.fit.daemon_loss_tolerance": "2",
                  "spark.srml.fit.daemon_join_policy": "boundary",
                  "spark.srml.daemon.timeout_s": "5",
                  "spark.srml.daemon.op_attempts": "2"}),
    "env_before_conf": ({"SRML_FIT_RECOVERY_ATTEMPTS": "1", "SRML_DAEMON_TIMEOUT_S": "3"},
                        {"spark.srml.fit.recovery_attempts": "5",
                         "spark.srml.daemon.timeout_s": "8"}),
    "invalid_env_falls_through": ({"SRML_FIT_RECOVERY_ATTEMPTS": "many",
                                   "SRML_FIT_DAEMON_JOIN_POLICY": "sometimes",
                                   "SRML_FIT_DAEMON_LOSS_TOLERANCE": "one"},
                                  {"spark.srml.fit.recovery_attempts": "2",
                                   "spark.srml.fit.daemon_join_policy": "typo"}),
    "negative_floors": ({"SRML_FIT_RECOVERY_ATTEMPTS": "-2",
                         "SRML_FIT_DAEMON_LOSS_TOLERANCE": "-1"}, {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_readers_equal_the_jax_modules(case, monkeypatch):
    env, conf = _CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for spark in (None, SimSparkSession(conf)):
        for name in _READERS:
            assert getattr(daemon_session, name)(spark) == getattr(jax_ds, name)(spark), \
                (case, name, spark is None)


@pytest.mark.parametrize("key,value", [
    ("fit_recovery_attempts", 2), ("fit_daemon_loss_tolerance", 1),
    ("fit_daemon_join_policy", "boundary"),
])
def test_readers_fall_back_to_the_config(key, value):
    reader = {"fit_recovery_attempts": "recovery_attempts",
              "fit_daemon_loss_tolerance": "daemon_loss_tolerance",
              "fit_daemon_join_policy": "daemon_join_policy"}[key]
    assert config.get(key) == jax_config.get(key)  # the same defaults
    with config.option(key, value), jax_config.option(key, value):
        got = getattr(daemon_session, reader)(SimSparkSession({}))
        assert got == getattr(jax_ds, reader)(SimSparkSession({})) == value


@pytest.mark.parametrize("addr", ["h:1", ":9747", "gpu-host-0:9747", "[::1]:80", "nope", "h:x"])
def test_parse_addr_equals_the_jax_modules(addr):
    try:
        want = jax_ds._parse_addr(addr)
    except ValueError:
        with pytest.raises(ValueError, match="host:port"):
            daemon_session._parse_addr(addr)
        return
    assert daemon_session._parse_addr(addr) == want


def test_resolve_configured_address_and_token(monkeypatch):
    spark = SimSparkSession({"spark.srml.daemon.address": "conf-host:1234",
                             "spark.srml.daemon.token": "t0"})
    assert daemon_session.resolve(spark) == jax_ds.resolve(spark) == ("conf-host", 1234, "t0")
    monkeypatch.setenv("SRML_DAEMON_ADDRESS", "env-host:99")
    monkeypatch.setenv("SRML_DAEMON_TOKEN", "t1")
    assert daemon_session.resolve(spark) == jax_ds.resolve(spark) == ("env-host", 99, "t1")


def test_task_context_and_executor_routing(monkeypatch):
    assert daemon_session.task_context() == jax_ds.task_context() == (0, 0)
    monkeypatch.setenv("SRML_PARTITION_ID", "7")
    monkeypatch.setenv("SRML_ATTEMPT", "2")
    assert daemon_session.task_context() == jax_ds.task_context() == (7, 2)
    assert daemon_session.executor_daemon_address("drv", 5) == ("drv", 5)
    monkeypatch.setenv("SRML_DAEMON_ADDRESS", "local-gpu:9747")
    assert daemon_session.executor_daemon_address("drv", 5) == \
        jax_ds.executor_daemon_address("drv", 5) == ("local-gpu", 9747)


def test_owned_daemon_is_one_per_device_and_shut_down():
    try:
        a = daemon_session._local_daemon("cpu")
        assert daemon_session._local_daemon("cpu") is a
        assert daemon_session.resolve(None, device="cpu")[:2] == a.address
    finally:
        daemon_session.shutdown()
    assert daemon_session._owned == {}


def test_no_card_and_no_address_raises_without_starting_a_daemon(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daemon_session.resolve(SimSparkSession({}))
    assert daemon_session._owned == {}


# ---------------------------------------------------------------------------
# conf and discovery
# ---------------------------------------------------------------------------


def test_gpu_session_conf():
    conf = gpu_session_conf(executor_gpus=4, tasks_per_gpu=8,
                            discovery_script="/etc/spark/gpu_disc.sh")
    assert conf == {
        "spark.driver.memory": "20G",
        "spark.executor.memory": "30G",
        "spark.driver.maxResultSize": "8G",
        "spark.executor.resource.gpu.amount": "4",
        "spark.task.resource.gpu.amount": "0.125",
        "spark.sql.execution.arrow.pyspark.enabled": "true",
        "spark.sql.execution.arrow.maxRecordsPerBatch": "65536",
        "spark.worker.resource.gpu.discoveryScript": "/etc/spark/gpu_disc.sh",
        "spark.driver.resource.gpu.discoveryScript": "/etc/spark/gpu_disc.sh",
    }
    assert "spark.worker.resource.gpu.discoveryScript" not in gpu_session_conf()


def test_discovery_payload_without_a_card(monkeypatch):
    monkeypatch.setattr(discovery.glob, "glob", lambda pattern: [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert discovery_payload() == {"name": "gpu", "addresses": []}
    # Device files come first; control nodes are not cards.
    monkeypatch.setattr(discovery.glob, "glob",
                        lambda pattern: ["/dev/nvidia0", "/dev/nvidia1", "/dev/nvidiactl"])
    assert discovery_payload() == {"name": "gpu", "addresses": ["0", "1"]}

    def broken():
        raise RuntimeError("driver mismatch")

    monkeypatch.setattr(discovery.glob, "glob", lambda pattern: [])
    monkeypatch.setattr(torch.cuda, "device_count", broken)
    assert discovery_payload() == {"name": "gpu", "addresses": []}  # never raises


def test_discovery_script_runs_the_ports_module(tmp_path):
    path = write_discovery_script(str(tmp_path / "gpu_disc.sh"))
    assert os.access(path, os.X_OK)
    assert "python3 -m spark_rapids_ml_tpu_torch.spark.discovery" in open(path).read()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "spark_rapids_ml_tpu_torch.spark.discovery"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout.strip())
    assert payload["name"] == "gpu" and isinstance(payload["addresses"], list)


# ---------------------------------------------------------------------------
# the wrapper off the Spark path
# ---------------------------------------------------------------------------


def test_wrapper_passes_in_memory_data_through():
    x = np.random.default_rng(3).normal(size=(200, 8))
    model = SparkPCA(device="cpu").setK(2).setInputCol("features").fit({"features": x})
    ref = SparkPCA(device="cpu")._core.setK(2).fit({"features": x})
    np.testing.assert_array_equal(model.pc, ref.pc)  # the same core fit
    out = model.transform({"features": x})
    assert out["pca_features"].shape == (200, 2)


def test_wrapper_spark_df_requires_pyspark():
    if port_est._pyspark() is not None:  # pragma: no cover - the image has no pyspark
        pytest.skip("pyspark installed; the gate cannot trigger")

    class FakeSparkDF:
        sparkSession = object()

    with pytest.raises(ImportError, match="pyspark"):
        SparkPCA(device="cpu").setK(2).fit(FakeSparkDF())
    model = SparkPCA(device="cpu").setK(2).fit({"features": np.ones((10, 4)) + np.eye(10, 4)})
    with pytest.raises(ImportError, match="pyspark"):
        model.transform(FakeSparkDF())


def test_only_sparkpca_is_exported():
    """The wrappers the JAX package's ``spark`` exports are exported
    (SparkPCA, the three of the iterative jobs, the two of the knn job and
    SparkStandardScaler); the forests' are defined in ``spark.estimator``
    and, as in the JAX package, not exported. The name dates from when
    SparkPCA was the only one."""
    import spark_rapids_ml_tpu.spark as jax_spark
    from spark_rapids_ml_tpu.spark import estimator as jax_est

    import spark_rapids_ml_tpu_torch.spark as spark_pkg

    assert sorted(spark_pkg.__all__) == [
        "SparkApproximateNearestNeighbors", "SparkKMeans", "SparkLinearRegression",
        "SparkLogisticRegression", "SparkNearestNeighbors", "SparkPCA", "SparkStandardScaler",
        "daemon_session",
        "discovery_payload", "gpu_session_conf", "register_dataframe_type",
        "write_discovery_script",
    ]
    for name in ("SparkRandomForestClassifier", "SparkRandomForestRegressor"):
        assert name not in spark_pkg.__all__ and name not in jax_spark.__all__
        assert issubclass(getattr(port_est, name), port_est._SparkAdapter)
        assert getattr(port_est, name)._daemon_algo == getattr(jax_est, name)._daemon_algo


# ---------------------------------------------------------------------------
# the native host library
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_so():
    if not os.path.exists(SO):
        try:
            subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            pytest.skip(f"cannot build native library: {e}")
    if port_native.get_lib() is None or jax_native.get_lib() is None:
        pytest.skip("native library failed to load")
    return SO


def _ragged_case(rng, dtype, start):
    n, d = 300, 13
    values = rng.normal(size=start + n * d + 5).astype(dtype)
    offsets = start + np.arange(0, (n + 1) * d, d, dtype=np.int64)
    return values, offsets, d


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("start", [0, 7])
def test_flatten_ragged_equals_jax_and_numpy(native_so, dtype, start):
    values, offsets, d = _ragged_case(np.random.default_rng(1), dtype, start)
    got = port_native.flatten_ragged(values, offsets, d)
    want = values[offsets[0]:offsets[-1]].reshape(-1, d)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, jax_native.flatten_ragged(values, offsets, d))
    np.testing.assert_array_equal(got, want)
    bad = offsets.copy()
    bad[5] += 1  # a ragged row: the library refuses, the caller falls back
    assert port_native.flatten_ragged(values, bad, d) is None
    assert jax_native.flatten_ragged(values, bad, d) is None


def test_concat_equals_jax_and_numpy(native_so):
    rng = np.random.default_rng(2)
    chunks = [rng.normal(size=(r, 6)) for r in (3, 0, 100, 17)]
    got = port_native.concat_chunks_f64(chunks)
    np.testing.assert_array_equal(got, np.concatenate(chunks))
    np.testing.assert_array_equal(got, jax_native.concat_chunks_f64(chunks))
    assert port_native.concat_chunks_f64([c.astype(np.float32) for c in chunks]) is None
    assert port_native.concat_chunks_f64([chunks[0], rng.normal(size=(2, 5))]) is None


def test_lookup_before_the_library_exists_loads_it_later(native_so, tmp_path, monkeypatch):
    late = str(tmp_path / "libsrml_tpu.so")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_missed", None)
    monkeypatch.setattr(port_native, "_candidate_paths", lambda: [late])
    assert port_native.get_lib() is None
    assert port_native.get_lib() is None  # the miss is kept while nothing changes
    shutil.copy(native_so, late)
    lib = port_native.get_lib()
    assert lib is not None and lib.srml_abi_version() == 1
    assert port_native.get_lib() is lib


def test_native_bridge_switch(native_so):
    values, offsets, d = _ragged_case(np.random.default_rng(4), np.float64, 0)
    with config.option("use_native_bridge", False):
        assert port_native.get_lib() is None
        assert port_native.flatten_ragged(values, offsets, d) is None
    assert port_native.flatten_ragged(values, offsets, d) is not None


@pytest.mark.parametrize("native_on", [True, False])
def test_arrow_bridge_gathers_through_the_library(native_so, native_on, monkeypatch):
    """A ``list`` column and a multi-chunk float64 column give numpy's
    matrices with the library (which the wrappers are seen to run) and
    without it; a ragged column raises either way."""
    calls = []
    for name in ("flatten_ragged", "concat_chunks_f64"):
        real = getattr(port_native, name)
        monkeypatch.setattr(port_native, name,
                            lambda *a, _real=real, _n=name: calls.append(_n) or _real(*a))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 6))
    lst = pa.array([list(r) for r in x], pa.list_(pa.float64()))
    chunked = pa.chunked_array([pa.FixedSizeListArray.from_arrays(pa.array(c.reshape(-1)), 6)
                                for c in (x[:15], x[15:])])
    with config.option("use_native_bridge", native_on):
        np.testing.assert_array_equal(port_arrow.list_column_to_matrix(lst), x)
        np.testing.assert_array_equal(port_arrow.list_column_to_matrix(lst.slice(3, 20)),
                                      x[3:23])
        np.testing.assert_array_equal(port_arrow.list_column_to_matrix(chunked), x)
        ragged = pa.array([[1.0, 2.0], [3.0]], pa.list_(pa.float64()))
        with pytest.raises(ValueError, match="ragged"):
            port_arrow.list_column_to_matrix(ragged)
    assert set(calls) == {"flatten_ragged", "concat_chunks_f64"}
    if native_on:
        assert port_native.get_lib() is not None


# ---------------------------------------------------------------------------
# what the Spark path reads from the client
# ---------------------------------------------------------------------------


def test_client_identity_and_finalize_meta_equal_the_jax_clients():
    """``server_id``, ``last_server_id``, ``seen_boot_ids`` (state acks
    only, not pings) and ``finalize(with_meta=True)``'s ``pass_rows``: the
    port's client reads them off the port's daemon as the JAX client does."""
    from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon

    x = np.random.default_rng(6).normal(size=(60, 5))
    with DataPlaneDaemon(device="cpu") as d:
        for make, job in ((DataPlaneClient, "port"), (JaxClient, "jax")):
            with make(*d.address) as c:
                assert c.server_id() == d.instance_id
                assert c.seen_boot_ids == set()  # a ping vouches for no state
                c.feed_raw(job, x, partition=0)
                c.commit(job, partition=0)
                assert c.seen_boot_ids == {d.boot_id}
                assert c.last_server_id == d.instance_id
                arrays, rows, meta = c.finalize(job, {"k": 2}, drop=True, with_meta=True)
                assert rows == meta["pass_rows"] == 60 and arrays["pc"].shape == (5, 2)
                assert meta["boot_id"] == d.boot_id and "ok" not in meta
        assert d._jobs == {}
