"""The port's serving scheduler (serve/scheduler.py) and its daemon ops.

The contracts of the JAX package's ``tests/test_serve_scheduler.py`` on the
port, on the CPU (``device="cpu"``, float64 compute and accumulation), with
the JAX ladder of "8,32,128" and a 30 ms window so concurrent clients meet:

* a batched ``transform`` and a batched exact ``kneighbors`` are bitwise
  the batching-off daemon's answer across bucket boundaries (sizes 1, 7,
  8, 9), a request that omits k batching with ones that name the fitted k;
* the trace warmup bounds the shape ledger to the ladder, and is an honest
  no-op with the scheduler off; ``health``'s scheduler block;
* admission: queue overflow and deadline sheds, a drained queue releasing
  its served reference, the reachable ladder per ``serve_max_batch_rows``,
  the ``daemon.scheduler`` fault site shedding and healing to exact
  results, an oversized request and every IVF ``kneighbors`` bypassing it;
* the LRU cap evicting re-creatable models first, counted;
* the port's own: a solo transform pads to the daemon's ladder, the
  dispatch runs under the "scheduler transform" span, a stopping
  scheduler fails its queued requests with busy, and the busy and
  request counters of the daemon.

The port's ``serve_aot`` is off here: these cases hold the trace warmup
(``aot`` false), the fallback of AOT at registration, which
``tests/test_torch_serve_aot.py`` holds. Left out: the tools panel (the
port has no ``tools.top`` yet).
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import (
    DaemonBusy,
    DataPlaneClient,
    DataPlaneDaemon,
    RequestScheduler,
    SchedulerBusy,
)
from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils import profiling

torch.set_num_threads(2)

BUCKETS = "8,32,128"
BUCKET = 8
D = 24


@pytest.fixture(autouse=True)
def _f64():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"), \
            config.option("serve_aot", False):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    basis = rng.normal(size=(D, D)) * np.logspace(0, -1.5, D)
    return rng.normal(size=(500, D)) @ basis


@pytest.fixture(scope="module")
def pca_arrays(data):
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        return port_pca.PCA(device="cpu").setK(3).fit({"features": data})._model_data()


class _Batched:
    """A batching daemon on the test ladder (the JAX test's options)."""

    def __init__(self, **over):
        opts = {"serve_batching": True, "serve_batch_buckets": BUCKETS,
                "serve_batch_window_ms": 30.0, "daemon_retry_after_s": 0.05}
        opts.update(over)
        self._ctxs = [config.option(k, v) for k, v in opts.items()]

    def __enter__(self) -> DataPlaneDaemon:
        for c in self._ctxs:
            c.__enter__()
        self.daemon = DataPlaneDaemon(device="cpu").start()
        return self.daemon

    def __exit__(self, *exc):
        self.daemon.stop()
        for c in reversed(self._ctxs):
            c.__exit__()


def _solo():
    return DataPlaneDaemon(device="cpu", serve_batching=False)


def _concurrent(n, fn):
    """fn(i) on n threads behind a barrier; re-raises the first error."""
    outs = [None] * n
    errs = []
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


def _wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


def _value(snap, name, **labels):
    return sum(s["value"] for s in snap.get(name, {}).get("samples", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


@pytest.mark.parametrize("size", [1, BUCKET - 1, BUCKET, BUCKET + 1])
def test_batched_transform_bitwise_equals_solo(data, pca_arrays, size):
    """8 concurrent clients of one model coalesce, and every client gets the
    bits of the scheduler-off daemon's answer; the sizes straddle a bucket
    boundary."""
    slices = [data[i * size:(i + 1) * size] for i in range(8)]
    with _solo() as solo, DataPlaneClient(*solo.address) as c:
        c.ensure_model("m", "pca", pca_arrays)
        ref = [c.transform("m", s)["output"] for s in slices]
    with _Batched() as daemon:
        host, port = daemon.address
        with DataPlaneClient(host, port) as c0:
            c0.ensure_model("m", "pca", pca_arrays)

        def one(i):
            with DataPlaneClient(host, port) as c:
                return c.transform("m", slices[i])["output"]

        metrics_mod.reset()
        outs = _concurrent(8, one)
        snap = metrics_mod.snapshot()
    for i in range(8):
        assert np.array_equal(outs[i], ref[i]), f"client {i} (size {size}) batched != solo"
    assert _value(snap, "srml_scheduler_batched_requests_total", op="transform") == 8
    assert _value(snap, "srml_scheduler_batches_total", op="transform") < 8


def _build_knn(daemon, db):
    with DataPlaneClient(*daemon.address) as c:
        c.feed("knn-job", db, algo="knn", params={"k": 5})
        c.finalize_knn("knn-job", register_as="idx", mode="exact")


def test_batched_kneighbors_bitwise_equals_solo():
    """The same exactness for exact kNN, queries batched across connections;
    client 0 omits k, which the daemon resolves to the fitted k = 5 before
    keying the batch."""
    rng = np.random.default_rng(7)
    db = rng.normal(size=(200, D))
    queries = rng.normal(size=(40, D))
    sizes = [1, BUCKET - 1, BUCKET, BUCKET + 1]
    offs = np.cumsum([0] + sizes)
    slices = [queries[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    with _solo() as solo:
        _build_knn(solo, db)
        with DataPlaneClient(*solo.address) as c:
            ref = [c.kneighbors("idx", s, k=5) for s in slices]
    with _Batched() as daemon:
        host, port = daemon.address
        _build_knn(daemon, db)

        def one(i):
            with DataPlaneClient(host, port) as c:
                return c.kneighbors("idx", slices[i], k=None if i == 0 else 5)

        metrics_mod.reset()
        outs = _concurrent(len(sizes), one)
        snap = metrics_mod.snapshot()
    for i in range(len(sizes)):
        assert np.array_equal(outs[i][0], ref[i][0]), f"distances {i} differ"
        assert np.array_equal(outs[i][1], ref[i][1]), f"indices {i} differ"
    assert _value(snap, "srml_scheduler_batched_requests_total", op="kneighbors") == 4
    assert _value(snap, "srml_scheduler_batches_total", op="kneighbors") < 4


def test_warmup_bounds_the_shape_ledger_to_the_ladder(data, pca_arrays):
    """The trace warmup dispatches one zero batch a bucket (3 misses); a
    storm of random-sized concurrent requests adds no shape."""
    rng = np.random.default_rng(9)
    with _Batched() as daemon:
        host, port = daemon.address
        metrics_mod.reset()
        with DataPlaneClient(host, port) as c:
            c.ensure_model("m", "pca", pca_arrays)
            info = c.warmup("m", n_cols=D, dtype="float64")
        assert info == {"enabled": True, "buckets": [8, 32, 128], "compiled": 3, "aot": False}
        misses = metrics_mod.REGISTRY.counter("srml_scheduler_compile_misses_total")
        assert misses.value(op="transform") == 3.0
        sizes = rng.integers(1, 129, size=12)

        def one(i):
            with DataPlaneClient(host, port) as c:
                return c.transform("m", data[: int(sizes[i])])["output"]

        _concurrent(12, one)
        assert misses.value(op="transform") == 3.0
        hits = metrics_mod.REGISTRY.counter("srml_scheduler_compile_hits_total")
        assert hits.value(op="transform") >= 1.0
        # A second warmup finds every shape seen.
        with DataPlaneClient(host, port) as c:
            assert c.warmup("m", n_cols=D, dtype="float64")["compiled"] == 0


def test_warmup_without_scheduler_is_honest_noop(pca_arrays):
    with _solo() as daemon, DataPlaneClient(*daemon.address) as c:
        c.ensure_model("m", "pca", pca_arrays)
        assert c.warmup("m", n_cols=D) == {"enabled": False, "buckets": [], "compiled": 0}
        with pytest.raises(RuntimeError, match="no such model"):
            c.warmup("ghost", n_cols=D)


def test_warmup_refusals_keep_the_connection(pca_arrays):
    """A warmup without n_cols, or of an unknown kind, is refused; the wrong
    width stays an error (the reference's ``tests/test_serve.py:668``)."""
    with _Batched() as daemon, DataPlaneClient(*daemon.address) as c:
        c.ensure_model("m", "pca", pca_arrays)
        with pytest.raises(RuntimeError, match="n_cols"):
            c._roundtrip({"op": "warmup", "model": "m"})
        with pytest.raises(RuntimeError, match="unknown warmup kind"):
            c.warmup("m", n_cols=D, kind="fit")
        with pytest.raises(RuntimeError):
            c.warmup("m", n_cols=D + 3)
        assert c.warmup("m", n_cols=D, dtype="float64")["compiled"] == 3


def test_warmup_on_register_adds_the_ack_field(pca_arrays, data):
    """With serve_warmup_on_register a creating ensure_model warms the
    ladder before its ack, and a knn finalize warms its index; the ack's
    warmup field is the warmup op's answer."""
    rng = np.random.default_rng(13)
    with _Batched(serve_warmup_on_register=True) as daemon:
        with DataPlaneClient(*daemon.address) as c:
            resp, _ = c._op({"op": "ensure_model", "model": "m", "algo": "pca", "params": {}},
                            arrays=pca_arrays)
            assert resp["created"] is True
            assert resp["warmup"] == {"buckets": [8, 32, 128], "compiled": 3, "aot": False}
            again, _ = c._op({"op": "ensure_model", "model": "m", "algo": "pca",
                              "params": {}}, arrays=pca_arrays)
            assert "warmup" not in again  # not a creating registration
        _build_knn(daemon, rng.normal(size=(64, D)).astype(np.float32))
        assert daemon._models["idx"]._sched_seen == {
            ("kneighbors", 5, "float32", D, b) for b in (8, 32, 128)}


def test_a_failed_warmup_on_register_never_fails_the_registration(pca_arrays, monkeypatch):
    import logging

    def broken(*a, **kw):
        raise RuntimeError("no such bucket program")

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    daemon_mod.logger.addHandler(handler)
    try:
        with _Batched(serve_warmup_on_register=True) as daemon:
            monkeypatch.setattr(daemon, "_warm_model", broken)
            with DataPlaneClient(*daemon.address) as c:
                resp, _ = c._op({"op": "ensure_model", "model": "m", "algo": "pca",
                                 "params": {}}, arrays=pca_arrays)
                assert resp["created"] is True and "warmup" not in resp
                assert c.model_exists("m")
    finally:
        daemon_mod.logger.removeHandler(handler)
    assert any("warmup-on-register for 'm' failed" in r.getMessage() for r in records)


def test_health_reports_scheduler_state(pca_arrays, data):
    with _Batched() as daemon, DataPlaneClient(*daemon.address) as c:
        sched = c.health()["scheduler"]
        assert sched["enabled"] is True
        assert sched["buckets"] == [8, 32, 128]
        assert sched["queued"] == 0
        c.ensure_model("m", "pca", pca_arrays)
        c.transform("m", data[:5])
        sched = c.health()["scheduler"]
        assert sched["batches"] >= 1
        # Drained queues are pruned: only models with queued work.
        assert sched["models"] == {}
    with _solo() as plain, DataPlaneClient(*plain.address) as c:
        health = c.health()
        assert health["scheduler"] == {"enabled": False}
        assert health["durable"] is False and health["busy"] is False


class _StubServed:
    """A stand-in for _ServedModel: a row-wise transform with a service
    time (no device, no daemon)."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.calls = 0

    def transform(self, x):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return {"output": np.asarray(x) * 2.0}


def _stub_scheduler(**kw):
    opts = dict(window_ms=1.0, max_batch_rows=64, buckets=(8, 32), queue_depth=8,
                retry_after_s=0.01)
    opts.update(kw)
    return RequestScheduler(**opts).start()


def test_admission_queue_overflow_sheds():
    """A queue bounded at 2 under a slow model: a 10-thread burst sheds some
    requests (queue_full) while every admitted one completes exactly."""
    served = _StubServed(delay_s=0.05)
    sched = _stub_scheduler(queue_depth=2)
    try:
        metrics_mod.reset()
        results, sheds = [], []

        def one(i):
            x = np.full((4, 3), float(i))
            try:
                results.append((i, sched.submit("m", served, "transform", x)))
            except SchedulerBusy as e:
                sheds.append(e)

        _concurrent(10, one)
        assert sheds, "no request was shed at queue_depth=2 under a burst"
        assert results, "every request shed: admission is over-eager"
        for i, out in results:
            np.testing.assert_array_equal(out["output"], np.full((4, 3), 2.0 * i))
        shed_counter = metrics_mod.REGISTRY.counter("srml_scheduler_sheds_total")
        assert shed_counter.value(op="transform", reason="queue_full") == len(sheds)
    finally:
        sched.stop()


def test_admission_deadline_sheds_after_ewma_primes():
    """Once a dispatch of a seen shape has trained the service-time
    estimate, a request whose deadline the backlog would miss is shed at
    once (reason deadline); a fresh shape's first dispatch trains nothing."""
    served = _StubServed(delay_s=0.05)
    sched = _stub_scheduler(queue_depth=64)
    try:
        x = np.ones((2, 3))
        sched.submit("m", served, "transform", x, deadline_s=1e-9)
        sched.submit("m", served, "transform", x, deadline_s=1e-9)
        with pytest.raises(SchedulerBusy, match="deadline"):
            sched.submit("m", served, "transform", x, deadline_s=1e-9)
        out = sched.submit("m", served, "transform", x, deadline_s=30.0)
        np.testing.assert_array_equal(out["output"], x * 2.0)
    finally:
        sched.stop()


def test_drained_queue_releases_served_reference():
    """The scheduler must not pin a served model past its last queued
    request (a weakref across a gc)."""
    served = _StubServed()
    ref = weakref.ref(served)
    sched = _stub_scheduler()
    try:
        out = sched.submit("m", served, "transform", np.ones((2, 3)))
        np.testing.assert_array_equal(out["output"], np.ones((2, 3)) * 2.0)
        with sched._cv:
            assert sched._served == {} and sched._queues == {}
        del served, out
        gc.collect()
        assert ref() is None, "scheduler still pins the served model"
    finally:
        sched.stop()


@pytest.mark.parametrize("max_rows,expect", [
    (32, [8, 32]),  # the cap ON a bucket: everything above is dead
    (100, [8, 32]),  # between buckets it floors to 32: never past the cap
    (4, [8]),  # below the smallest bucket: batches still pad to 8
])
def test_warmup_compiles_only_the_reachable_ladder(max_rows, expect):
    served = _StubServed()
    sched = _stub_scheduler(max_batch_rows=max_rows, buckets=(8, 32, 128))
    try:
        info = sched.warmup("m", served, n_cols=3)
        assert info == {"buckets": expect, "compiled": len(expect)}
        assert sched._bucket_for(sched._cap_rows) == expect[-1]
        assert served.calls == len(expect)
    finally:
        sched.stop()


def test_scheduler_fault_site_sheds_and_retries_to_exact_results(data, pca_arrays):
    """The plan ``SRML_TORCH_FAULT_PLAN=seed=11;daemon.scheduler:drop:times=3``
    sheds the first submissions as busy; the client honours retry_after_s
    and the retried results are exact."""
    with _solo() as solo, DataPlaneClient(*solo.address) as c:
        c.ensure_model("m", "pca", pca_arrays)
        ref = [c.transform("m", data[i * 5:(i + 1) * 5])["output"] for i in range(4)]
    with _Batched() as daemon:
        host, port = daemon.address
        with DataPlaneClient(host, port) as c0:
            c0.ensure_model("m", "pca", pca_arrays)
        metrics_mod.reset()
        plan = faults.FaultPlan.from_spec("seed=11;daemon.scheduler:drop:times=3")
        with faults.active(plan):

            def one(i):
                with DataPlaneClient(host, port) as c:
                    out = c.transform("m", data[i * 5:(i + 1) * 5])["output"]
                    return out, dict(c.stats)

            outs = _concurrent(4, one)
        snap = metrics_mod.snapshot()
    assert plan.fired.get("daemon.scheduler", 0) == 3
    assert sum(s["busy_waits"] for _, s in outs) == 3
    assert _value(snap, "srml_scheduler_sheds_total", op="transform", reason="fault") == 3
    assert _value(snap, "srml_daemon_busy_sheds_total", op="transform") == 3
    for i in range(4):
        assert np.array_equal(outs[i][0], ref[i]), f"retried result {i} drifted"


def test_oversized_request_bypasses_the_scheduler(data, pca_arrays):
    """A request above the top bucket runs solo (it is a full dispatch of
    its own), unpadded, and is counted as a bypass."""
    with _Batched() as daemon:
        metrics_mod.reset()
        with DataPlaneClient(*daemon.address) as c:
            c.ensure_model("m", "pca", pca_arrays)
            out = c.transform("m", data[:300])["output"]
        bypass = metrics_mod.REGISTRY.counter("srml_scheduler_bypass_total")
        assert bypass.value(op="transform") == 1.0
        assert metrics_mod.REGISTRY.counter("srml_scheduler_batches_total").value(
            op="transform") == 0.0
    assert out.shape == (300, 3)


def test_model_registry_lru_cap_evicts_recreatable_first(pca_arrays):
    """max_models bounds the registry: the least recently touched
    registration goes (counted under reason=lru)."""
    metrics_mod.reset()
    with DataPlaneDaemon(device="cpu", max_models=2) as daemon:
        with DataPlaneClient(*daemon.address) as c:
            c.ensure_model("a", "pca", pca_arrays)
            c.ensure_model("b", "pca", pca_arrays)
            assert c.model_exists("a")
            c.ensure_model("a", "pca", pca_arrays)  # touches "a": "b" is the LRU
            c.ensure_model("c", "pca", pca_arrays)
            assert c.model_exists("a") and c.model_exists("c")
            assert not c.model_exists("b")
    evictions = metrics_mod.REGISTRY.counter("srml_daemon_model_evictions_total")
    assert evictions.value(reason="lru") == 1.0


def test_ann_kneighbors_bypasses_batching_and_stays_exact():
    """IVF kneighbors never coalesces (a padding or co-batched row could
    evict a real query's candidates): served solo, counted as a bypass, and
    bitwise the scheduler-off daemon's answer."""
    rng = np.random.default_rng(17)
    db = rng.normal(size=(4, D)).astype(np.float32)
    queries = db[:2]

    def serve(batching):
        with config.option("serve_batching", batching), \
                config.option("compute_dtype", "float32"), \
                config.option("accum_dtype", "float32"):
            with DataPlaneDaemon(device="cpu") as daemon:
                with DataPlaneClient(*daemon.address) as c:
                    c.feed("j", db, algo="knn", partition=0)
                    c.commit("j", 0)
                    c.finalize_knn("j", register_as="idx", mode="ivf", nlist=2,
                                   row_id_base={0: 0})

                def one(i):
                    with DataPlaneClient(*daemon.address) as c:
                        return c.kneighbors_raw("idx", queries, k=2)

                return _concurrent(3, one)

    ref = serve(False)
    metrics_mod.reset()
    got = serve(True)
    for (gd, gi), (rd, ri) in zip(got, ref):
        assert np.array_equal(gi, ri) and np.array_equal(gd, rd)
    bypass = metrics_mod.REGISTRY.counter("srml_scheduler_bypass_total")
    assert bypass.value(op="kneighbors") == 3.0
    assert metrics_mod.REGISTRY.counter("srml_scheduler_batches_total").value(
        op="kneighbors") == 0.0


def test_solo_transform_pads_to_the_daemons_ladder(pca_arrays, data, monkeypatch):
    """A solo transform of n rows runs at the smallest bucket that holds n
    (the shape a batch of that bucket runs), above the top bucket at n; the
    answer is the first n rows."""
    shapes = []
    real = port_pca.PCAModel.transform_matrix

    def spy(self, x):
        shapes.append(int(x.shape[0]))
        return real(self, x)

    monkeypatch.setattr(port_pca.PCAModel, "transform_matrix", spy)
    with config.option("serve_batch_buckets", BUCKETS), _solo() as daemon:
        with DataPlaneClient(*daemon.address) as c:
            c.ensure_model("m", "pca", pca_arrays)
            outs = [c.transform("m", data[:n])["output"] for n in (1, 8, 9, 128, 129, 300)]
    assert shapes == [8, 8, 32, 128, 129, 300]
    for n, out in zip((1, 8, 9, 128, 129, 300), outs):
        assert out.shape == (n, 3)
        np.testing.assert_allclose(out, data[:n] @ pca_arrays["pc"], rtol=0, atol=1e-10)


def test_dispatch_runs_under_the_scheduler_span_and_stop_sheds_the_queue():
    """The dispatch shows in span_totals as "scheduler transform"; a
    scheduler stopped with requests queued fails them with busy."""
    profiling.reset_span_totals()
    sched = _stub_scheduler()
    try:
        sched.submit("m", _StubServed(), "transform", np.ones((2, 3)))
    finally:
        sched.stop()
    assert profiling.span_totals()["scheduler transform"][1] == 1
    slow = _StubServed(delay_s=0.3)
    sched = _stub_scheduler(window_ms=1.0)
    done, errors = [], []

    def one(i):
        try:
            done.append(sched.submit("m", slow, "transform", np.ones((4, 3)) * i))
        except SchedulerBusy as e:
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    threads[0].start()
    _wait_for(lambda: slow.calls == 1)  # the first request is in its 0.3 s dispatch
    for t in threads[1:]:
        t.start()
    _wait_for(lambda: sched.snapshot()["queued"] == 2)  # the other two queue behind it
    sched.stop()
    for t in threads:
        t.join()
    assert len(done) == 1 and len(errors) == 2
    assert all("stopping" in str(e) for e in errors)
    with pytest.raises(SchedulerBusy, match="stopping"):
        sched.submit("m", slow, "transform", np.ones((1, 3)))


def test_busy_shed_and_request_counters_over_the_wire(pca_arrays, data):
    """A deadline the backlog misses is answered busy over the wire, without
    burning the client's attempts, and counted per op; every request is
    counted by op and outcome with its latency and payload bytes."""
    with _Batched() as daemon:
        metrics_mod.reset()
        with DataPlaneClient(*daemon.address, max_busy_wait_s=0.0,
                             max_op_attempts=1) as c:
            c.ensure_model("m", "pca", pca_arrays)
            for _ in range(3):  # the first dispatch of a shape trains nothing
                c.transform("m", data[:4])
            with pytest.raises(DaemonBusy, match="deadline"):
                c.transform("m", data[:4], deadline_s=1e-9)
            with pytest.raises(RuntimeError, match="unknown op"):
                c._roundtrip({"op": "nope"})
            # Answered on the same connection thread, so after "nope" is
            # counted (the count lands once its answer is on the wire).
            c.ping()
        snap = metrics_mod.snapshot()
    assert _value(snap, "srml_daemon_busy_sheds_total", op="transform") == 1
    assert _value(snap, "srml_scheduler_sheds_total", op="transform", reason="deadline") == 1
    assert _value(snap, "srml_daemon_requests_total", op="transform", outcome="ok") == 4
    assert _value(snap, "srml_daemon_requests_total", op="unknown", outcome="error") == 1
    assert _value(snap, "srml_daemon_requests_total", op="ensure_model", outcome="ok") == 1
    assert _value(snap, "srml_daemon_rx_bytes_total", op="transform") > 0
    assert _value(snap, "srml_daemon_tx_bytes_total", op="transform") == 3 * 4 * 3 * 8
    lat = next(s for s in snap["srml_daemon_request_seconds"]["samples"]
               if s["labels"] == {"op": "transform"})
    assert lat["count"] == 4 and lat["sum"] > 0


def test_daemon_scheduler_is_off_when_asked_and_counts_no_batch(pca_arrays, data):
    with _solo() as daemon:
        assert daemon._scheduler is None
        metrics_mod.reset()
        with DataPlaneClient(*daemon.address) as c:
            c.ensure_model("m", "pca", pca_arrays)
            c.transform("m", data[:5])
        assert metrics_mod.REGISTRY.counter("srml_scheduler_batches_total").value(
            op="transform") == 0.0
    assert daemon_mod._op_label("transform") == "transform"
    assert daemon_mod._op_label("no such op") == "unknown"


def test_stress_every_request_gets_its_own_rows():
    """More submitters than cores, the interpreter switching threads every
    microsecond: every request gets back exactly its own rows, and the
    accounting ends empty (a lost update would misroute or strand one)."""
    import sys

    served = _StubServed()
    sched = _stub_scheduler(window_ms=0.5, max_batch_rows=64, buckets=(8, 32, 64),
                            queue_depth=1024)
    n_threads, n_reqs = 24, 20
    wrong = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def one(t):
            rng = np.random.default_rng(t)
            for i in range(n_reqs):
                rows = int(rng.integers(1, 20))
                x = np.full((rows, 3), float(t * 1000 + i))
                out = sched.submit("m", served, "transform", x)["output"]
                if out.shape != (rows, 3) or not np.all(out == 2.0 * (t * 1000 + i)):
                    wrong.append((t, i))

        threads = [threading.Thread(target=one, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        with sched._cv:
            assert sched._queues == {} and sched._depth == {} and sched._krows == {}
            assert sched._served == {} and sched._qrows == {}
    finally:
        sys.setswitchinterval(old)
        sched.stop()
    assert wrong == []
    assert served.calls < n_threads * n_reqs  # requests did coalesce
