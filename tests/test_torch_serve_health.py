"""The port's serving plane against the JAX package's: the bucket ladder,
``warmup``, ``health``, ``metrics`` and served answers.

On the CPU, float64 compute and accumulation in both packages, the JAX
daemon in process with its jit ledger off (``jax_ledger_off``, which also
turns its metrics off: the reference's counts are its own tests'), both
daemons batching on the ladder "8,32,128" with both packages' ``serve_aot``
off (the trace warmup; AOT at registration is
``tests/test_torch_serve_aot.py``'s):

* ``parse_buckets`` and ``reachable_buckets`` equal for the same specs;
* the warmup ack equal to the JAX daemon's;
* the ``health`` key sets equal (top level, scheduler block, mesh block);
* the same PCA transform and exact-kNN traffic, from concurrent clients,
  answered as the JAX daemon answers it (transform 1e-10, ids equal, the
  JAX serving tests' tolerances);
* the ``metrics`` op in both formats: every ported metric registered under
  the JAX name and type, and the request counts equal to the requests
  sent (the JAX ``tests/test_observability.py:311,363``).
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import knn as jax_knn
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.serve import scheduler as jax_scheduler
from spark_rapids_ml_tpu.utils import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import scheduler as port_scheduler
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

D = 16
BUCKETS = "8,32,128"

#: The serving plane's metrics the port carries, by the JAX names.
SCHEDULER_METRICS = (
    "srml_scheduler_queue_depth", "srml_scheduler_batches_total",
    "srml_scheduler_batched_requests_total", "srml_scheduler_batch_rows",
    "srml_scheduler_batch_seconds", "srml_scheduler_padded_rows_total",
    "srml_scheduler_sheds_total", "srml_scheduler_compile_misses_total",
    "srml_scheduler_compile_hits_total", "srml_scheduler_bypass_total",
)
DAEMON_METRICS = (
    "srml_daemon_requests_total", "srml_daemon_request_seconds",
    "srml_daemon_rx_bytes_total", "srml_daemon_tx_bytes_total",
    "srml_daemon_busy_sheds_total", "srml_daemon_replay_hits_total",
    "srml_daemon_active_connections", "srml_daemon_staged_bytes",
    "srml_daemon_active_jobs", "srml_daemon_served_models",
    "srml_daemon_model_evictions_total", "srml_daemon_mesh_reduces_total",
)


@pytest.fixture(autouse=True)
def _serving_config():
    """float64 both sides; both daemons batching on the test ladder."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax_ledger_off())
        for cfg in (jax_config, config):
            stack.enter_context(cfg.option("compute_dtype", "float64"))
            stack.enter_context(cfg.option("accum_dtype", "float64"))
            stack.enter_context(cfg.option("serve_batching", True))
            stack.enter_context(cfg.option("serve_batch_buckets", BUCKETS))
            stack.enter_context(cfg.option("serve_batch_window_ms", 20.0))
        stack.enter_context(jax_config.option("serve_aot", False))
        stack.enter_context(config.option("serve_aot", False))
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(19)
    basis = rng.normal(size=(D, D)) * np.logspace(0, -1.5, D)
    return rng.normal(size=(480, D)) @ basis + rng.normal(size=D)


@pytest.fixture(scope="module")
def pca_arrays(data):
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        return port_pca.PCA(device="cpu").setK(3).fit({"features": data})._model_data()


@contextlib.contextmanager
def _both(mesh1):
    # The JAX exact-kNN program is cached a (mesh, k, dtypes) key for the
    # process: a JAX ``serve_aot`` warmup earlier in the process (its own
    # serving tests) leaves AOT executables on it, and a wrapper holding
    # any asks ``jax.core.trace_state_clean`` even with the ledger off.
    # A fresh program holds none.
    jax_knn._exact_knn_fn.cache_clear()
    with DataPlaneDaemon(device="cpu") as port, JaxDaemon(mesh=mesh1) as ref:
        yield port, ref


def _concurrent(n, fn):
    outs, errs = [None] * n, []
    barrier = threading.Barrier(n)

    def worker(i):
        try:
            barrier.wait()
            outs[i] = fn(i)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return outs


@pytest.mark.parametrize("spec", [
    "64,256,1024,4096", "8,32,128", "128;8, 32", "32,8,8", (4, 2, 2), "", "garbage",
    "0,8", "-4,8",
])
def test_parse_buckets_equals_the_reference(spec):
    assert port_scheduler.parse_buckets(spec) == jax_scheduler.parse_buckets(spec)


@pytest.mark.parametrize("max_rows", [1, 4, 8, 31, 32, 100, 128, 5000])
@pytest.mark.parametrize("buckets", [(8, 32, 128), (64, 256, 1024, 4096)])
def test_reachable_buckets_equal_the_reference(buckets, max_rows):
    kw = dict(window_ms=1.0, max_batch_rows=max_rows, buckets=buckets, queue_depth=4)
    port = port_scheduler.RequestScheduler(**kw)
    ref = jax_scheduler.RequestScheduler(**kw)
    assert port.reachable_buckets() == ref.reachable_buckets()
    assert port._cap_rows == ref._cap_rows
    for n in (1, 7, 8, 9, 33, 128, 129, 4097):
        assert port.eligible(n) == ref.eligible(n)
        assert port._bucket_for(n) == ref._bucket_for(n)


def test_warmup_ack_and_health_keys_equal_the_reference(mesh1, pca_arrays):
    with _both(mesh1) as (port, ref):
        with DataPlaneClient(*port.address) as pc, JaxClient(*ref.address) as jc:
            pc.ensure_model("m", "pca", pca_arrays)
            jc.ensure_model("m", "pca", pca_arrays)
            got = pc.warmup("m", n_cols=D, dtype="float64")
            want = jc.warmup("m", n_cols=D, dtype="float64")
            assert got == want == {"enabled": True, "buckets": [8, 32, 128], "compiled": 3,
                                   "aot": False}
            ph, jh = pc.health(), jc.health()
    assert set(ph) == set(jh)
    assert set(ph["scheduler"]) == set(jh["scheduler"])
    assert set(ph["mesh"]) == set(jh["mesh"])
    for key in ("buckets", "window_ms", "max_batch_rows", "queue_depth_cap", "queued",
                "models", "enabled"):
        assert ph["scheduler"][key] == jh["scheduler"][key], key
    assert (ph["busy"], ph["durable"], ph["served_models"]) == (False, False, 1)


def test_warmup_off_answers_as_the_reference(mesh1, pca_arrays):
    with config.option("serve_batching", False), jax_config.option("serve_batching", False):
        with _both(mesh1) as (port, ref):
            with DataPlaneClient(*port.address) as pc, JaxClient(*ref.address) as jc:
                pc.ensure_model("m", "pca", pca_arrays)
                jc.ensure_model("m", "pca", pca_arrays)
                assert pc.warmup("m", n_cols=D) == jc.warmup("m", n_cols=D)
                assert pc.health()["scheduler"] == jc.health()["scheduler"] == {
                    "enabled": False}


def test_concurrent_pca_traffic_answers_as_the_reference(mesh1, data, pca_arrays):
    sizes = [1, 7, 8, 9, 31, 64, 129, 200]
    offs = np.cumsum([0] + sizes)
    slices = [data[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    with _both(mesh1) as (port, ref):
        with DataPlaneClient(*port.address) as pc, JaxClient(*ref.address) as jc:
            pc.ensure_model("m", "pca", pca_arrays)
            jc.ensure_model("m", "pca", pca_arrays)

        def run(cls, daemon):
            def one(i):
                with cls(*daemon.address) as c:
                    return c.transform("m", slices[i])["output"]
            return _concurrent(len(sizes), one)

        got, want = run(DataPlaneClient, port), run(JaxClient, ref)
    for g, w, n in zip(got, want, sizes):
        assert g.shape == w.shape == (n, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_concurrent_exact_knn_traffic_answers_as_the_reference(mesh1):
    rng = np.random.default_rng(23)
    db = rng.normal(size=(300, D))
    queries = rng.normal(size=(60, D))
    sizes = [1, 7, 8, 9, 35]
    offs = np.cumsum([0] + sizes)
    slices = [queries[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    with _both(mesh1) as (port, ref):
        for cls, daemon in ((DataPlaneClient, port), (JaxClient, ref)):
            with cls(*daemon.address) as c:
                for p, rows in enumerate(np.array_split(db, 3)):
                    c.feed("nn", rows, algo="knn", partition=p)
                    c.commit("nn", partition=p)
                c.finalize_knn("nn", register_as="idx", mode="exact")

        def run(cls, daemon):
            def one(i):
                with cls(*daemon.address) as c:
                    return c.kneighbors("idx", slices[i], k=None if i == 0 else 5)
            return _concurrent(len(sizes), one)

        got, want = run(DataPlaneClient, port), run(JaxClient, ref)
    for (gd, gi), (wd, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-10, atol=1e-10)


def test_every_ported_metric_has_the_reference_name_and_type():
    port_reg, ref_reg = metrics_mod.REGISTRY._metrics, jax_metrics.REGISTRY._metrics
    for name in SCHEDULER_METRICS + DAEMON_METRICS:
        assert name in port_reg, name
        assert port_reg[name].kind == ref_reg[name].kind, name
    # The ported metrics are the whole scheduler and daemon-telemetry set
    # of the reference, less the durability and gossip counters.
    ref_names = {n for n in ref_reg if n.startswith(("srml_scheduler_", "srml_daemon_"))}
    assert ref_names - set(SCHEDULER_METRICS + DAEMON_METRICS) == {
        "srml_daemon_job_restores_total"}


def _poll(scrape, cond, timeout_s=10.0):
    """A request's count lands once its answer is on the wire: scrape until
    the counts of traffic from other connections are in."""
    deadline = time.monotonic() + timeout_s
    while True:
        out = scrape()
        if cond(out) or time.monotonic() > deadline:
            return out
        time.sleep(0.01)


def test_metrics_op_counts_the_requests_sent(mesh1, data, pca_arrays):
    """The JSON and Prometheus forms of one scrape count every request sent,
    by op and outcome, with the scheduler's batches and the level gauges."""
    metrics_mod.reset()
    x = np.random.default_rng(29).standard_normal((256, 4))
    with DataPlaneDaemon(device="cpu") as daemon:
        host, port = daemon.address
        with DataPlaneClient(host, port) as c:
            c.ensure_model("m", "pca", pca_arrays)
            for part in range(3):
                c.feed("obs", x, algo="pca", partition=part)
                c.commit("obs", partition=part)
            c.feed("obs", x, algo="pca", partition=0)  # a committed partition again
            assert c.finalize_pca("obs", k=2)["pc"].shape == (4, 2)

        def one(i):
            with DataPlaneClient(host, port) as cc:
                return cc.transform("m", data[:i + 1])["output"]

        _concurrent(6, one)
        with DataPlaneClient(host, port) as c:
            snap = _poll(c.metrics, lambda s: sum(
                v["value"] for v in s["srml_daemon_requests_total"]["samples"]
                if v["labels"]["op"] == "transform") == 6)
            text = c.metrics(format="prometheus")
            health = c.health()
    reqs = {(s["labels"]["op"], s["labels"]["outcome"]): s["value"]
            for s in snap["srml_daemon_requests_total"]["samples"]}
    assert reqs[("ensure_model", "ok")] == 1
    assert reqs[("feed", "ok")] == 4 and reqs[("commit", "ok")] == 3
    assert reqs[("finalize", "ok")] == 1 and reqs[("transform", "ok")] == 6
    lat = {s["labels"]["op"]: s for s in snap["srml_daemon_request_seconds"]["samples"]}
    assert lat["feed"]["count"] == 4 and lat["feed"]["sum"] > 0
    rx = {s["labels"]["op"]: s["value"] for s in snap["srml_daemon_rx_bytes_total"]["samples"]}
    assert rx["feed"] > 0 and rx["transform"] > 0 and rx["ensure_model"] > 0
    tx = {s["labels"]["op"]: s["value"] for s in snap["srml_daemon_tx_bytes_total"]["samples"]}
    assert tx["finalize"] > 0 and tx["transform"] == sum(8 * 3 * (i + 1) for i in range(6))
    replays = {s["labels"]["kind"]: s["value"]
               for s in snap["srml_daemon_replay_hits_total"]["samples"]}
    assert replays == {"committed_partition": 1}
    batched = sum(s["value"] for s in snap["srml_scheduler_batched_requests_total"]["samples"])
    batches = sum(s["value"] for s in snap["srml_scheduler_batches_total"]["samples"])
    assert batched == 6 and 1 <= batches <= 6
    assert snap["srml_daemon_served_models"]["samples"][0]["value"] == 1
    assert snap["srml_daemon_active_connections"]["samples"][0]["value"] >= 1
    assert health["scheduler"]["batches"] == batches
    assert "# TYPE srml_daemon_requests_total counter" in text
    assert "# TYPE srml_scheduler_batches_total counter" in text
    assert 'srml_daemon_requests_total{op="transform",outcome="ok"} 6' in text
    assert 'srml_daemon_request_seconds_bucket{le="+Inf",op="feed"} 4' in text
    with DataPlaneDaemon(device="cpu") as daemon, DataPlaneClient(*daemon.address) as c:
        with pytest.raises(RuntimeError, match="unknown metrics format"):
            c.metrics(format="xml")
