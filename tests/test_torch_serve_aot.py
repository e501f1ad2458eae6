"""AOT at registration on the port (``serve/aot.py``, the daemon's
``aot_warm``/``aot_status``) against the JAX package's contract
(``docs/protocol.md`` "AOT at registration", ``tests/test_serve.py``'s AOT
cases).

On the CPU (``device="cpu"``) a held program is the serving body run eagerly
over its static input (``aot/eager``): there is no CUDA graph here, so these
tests hold the plans, the shapes, the ledger and the fallbacks; the card's
graphs are held bitwise against the eager daemon by ``chip_smoke.py
--serving``. The ladder is "8,32,128":

* after a registration with AOT on, the first request at every reachable
  bucket of each served model (PCA, KMeans, LinearRegression, binary and
  multinomial LogisticRegression, both forests, the exact index) reports
  zero misses, its answers those of the JAX model of the same arrays and
  of the port's model served alone; ``compiled``
  counts the shapes the port dispatches: every bucket for a transform (the
  served transform pads to the ladder and the port adds no floor), where the
  JAX plans' 256-row floor folds 8, 32 and 128 into ONE program (and 64,
  256, 1024 and 4096 into three); the exact index's padded query counts;
* the ``warmup`` ack's ``aot``, true with ``serve_aot`` on and false with it
  off, equal to the live JAX daemon's (its ledger off); the scaler's
  ``compiled`` 0 as the JAX daemon's; the IVF index's ``aot`` false;
* the exact-kNN plan primes the padded shape, its answers the JAX
  ``NearestNeighbors``'; a wrong width still raises, at the warmup and at a
  request to a warmed model (a miss, never a hit);
* the kernel ledger keeps flops and bytes for primed shapes; a capture's
  kept calls credited to ``LAUNCHES``, ``ROUTES`` and the ledger a replay;
* a re-uploaded or dropped exact index drops its programs;
* ``serve_aot`` reads ``SRML_TORCH_SERVE_AOT``, never ``SRML_SERVE_AOT``.
"""

import contextlib
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import knn as jax_knn
from spark_rapids_ml_tpu.models.pca import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.serve import daemon as jax_daemon
from spark_rapids_ml_tpu_torch import NearestNeighbors, RandomForestClassifier, RandomForestRegressor
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon, aot
from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod
from spark_rapids_ml_tpu_torch.utils import xprof
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

D = 16
BUCKETS = "8,32,128"
LADDER = [8, 32, 128]
TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX serving tests' tolerances
KNN_TOL = dict(rtol=1e-5, atol=1e-5)  # test_torch_knn's, kneighbors against the JAX model
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _serving_config():
    """Both packages batching on the test ladder, AOT on, float32."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax_ledger_off())
        for cfg in (jax_config, config):
            stack.enter_context(cfg.option("compute_dtype", "float32"))
            stack.enter_context(cfg.option("accum_dtype", "float32"))
            stack.enter_context(cfg.option("serve_batching", True))
            stack.enter_context(cfg.option("serve_batch_buckets", BUCKETS))
            stack.enter_context(cfg.option("serve_aot", True))
        yield


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


@pytest.fixture(scope="module")
def registrations():
    """algo → (ensure_model arrays, params) of each served transform model."""
    rng = np.random.default_rng(7)
    x = _rows(240, 1)
    pc, _ = np.linalg.qr(rng.normal(size=(D, 3)))
    rf_c = RandomForestClassifier(device="cpu").setNumTrees(3).setMaxDepth(3).setMaxBins(8)
    rf_r = RandomForestRegressor(device="cpu").setNumTrees(3).setMaxDepth(3).setMaxBins(8)
    return {
        "pca": ({"pc": pc}, {}),
        "kmeans": ({"clusterCenters": rng.normal(size=(5, D))}, {}),
        "linreg": ({"coefficients": rng.normal(size=D), "intercept": np.asarray([0.3])}, {}),
        "logreg": ({"coefficients": rng.normal(size=D), "intercept": np.asarray([0.1])}, {}),
        "logreg-multi": ({"coefficients": rng.normal(size=(3, D)),
                          "intercept": rng.normal(size=3)}, {}),
        "rf_classifier": (rf_c.fit({"features": x, "label": (x[:, 0] > 0).astype(np.float64)})
                          ._model_data(), {}),
        "rf_regressor": (rf_r.fit({"features": x, "label": x[:, 1].astype(np.float64)})
                         ._model_data(), {}),
    }


def _algo(name):
    return "logreg" if name == "logreg-multi" else name


def _status(c, name):
    resp, _ = c._roundtrip({"op": "model_status", "model": name})
    return resp


def _solo(algo, arrays):
    """The model the daemon serves, alone on the CPU."""
    model = daemon_mod._model_class(algo)._from_model_data("solo", arrays)
    model._device = "cpu"
    return model


def _jax_model(algo, arrays):
    """The JAX package's model of the same registration arrays."""
    return jax_daemon._model_class(algo)._from_model_data("ref", arrays)


def _jax_kneighbors(x, q, k, metric="euclidean", mesh=None):
    """The JAX package's exact kneighbors of ``q`` over ``x``, fitted outside
    any daemon."""
    ref = jax_knn.NearestNeighbors(mesh=mesh).setK(k).setMetric(metric).fit({"features": x})
    return ref.kneighbors(q)


def _build_exact(c, name="idx"):
    """A daemon-built exact index of 200 rows; returns the k its tests ask."""
    c.feed_raw("kj", _rows(200, 3), algo="knn", n_cols=D)
    c.finalize_knn("kj", register_as=name, mode="exact")
    return 4


@pytest.mark.parametrize("name", ["pca", "kmeans", "linreg", "logreg", "logreg-multi",
                                  "rf_classifier", "rf_regressor"])
def test_aot_on_register_zero_compile_misses(name, registrations):
    """JAX ``test_aot_on_register_zero_compile_misses``: the registration
    ack's warmup carries aot true; the first transform at every reachable
    bucket misses nothing; the answers are the JAX model's of the same
    arrays, and the port's solo model's."""
    arrays, params = registrations[name]
    algo = _algo(name)
    ref = _jax_model(algo, arrays)
    with config.option("serve_warmup_on_register", True), DataPlaneDaemon(device="cpu") as d:
        with DataPlaneClient(*d.address) as c:
            resp, _ = c._op({"op": "ensure_model", "model": "m", "algo": algo,
                             "params": params}, arrays=arrays)
            # One program a bucket: the served transform pads to the ladder.
            assert resp["warmup"] == {"buckets": LADDER, "compiled": len(LADDER), "aot": True}
            st = _status(c, "m")["aot"]
            assert st == {"buckets": LADDER, "compiled": 3, "hits": 0, "misses": 0}
            eager0 = aot.ROUTES["aot/eager"]
            solo = _solo(algo, arrays)
            for bucket in st["buckets"]:
                q = _rows(bucket, bucket)
                got = c.transform_raw("m", q)
                want, jax_want = solo.transform_matrix(q), ref.transform_matrix(q)
                assert set(got) == set(want) == set(jax_want)
                for role in want:
                    for expect in (want[role], jax_want[role]):
                        np.testing.assert_allclose(got[role],
                                                   np.asarray(expect, got[role].dtype), **TOL)
            st = _status(c, "m")["aot"]
    assert st["misses"] == 0 and st["hits"] >= len(st["buckets"]), st
    assert aot.ROUTES["aot/eager"] - eager0 >= len(LADDER)


def test_aot_pca_answers_as_the_jax_model(registrations):
    """The PCA programs' answers against the JAX model of the same arrays."""
    arrays, _ = registrations["pca"]
    ref = JaxPCAModel._from_model_data("ref", arrays)
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        c.ensure_model("m", "pca", arrays)
        assert c.warmup("m", n_cols=D)["aot"] is True
        for n in (1, 8, 9, 100):
            q = _rows(n, n)
            np.testing.assert_allclose(c.transform_raw("m", q)["output"],
                                       np.asarray(ref.transform_matrix(q)["output"]), **TOL)
        assert _status(c, "m")["aot"]["misses"] == 0


def test_programs_answer_bitwise_as_the_eager_daemon(registrations):
    """At the same padded shape a held program runs the eager body's
    operations: every answer equals the AOT-off daemon's bit for bit."""
    sizes = (1, 7, 8, 9, 31, 33, 128)
    with DataPlaneDaemon(device="cpu") as on, DataPlaneClient(*on.address) as c_on:
        with DataPlaneDaemon(device="cpu") as off, DataPlaneClient(*off.address) as c_off:
            for name, (arrays, params) in registrations.items():
                for c, held in ((c_on, True), (c_off, False)):
                    c.ensure_model(name, _algo(name), arrays, params=params)
                    with config.option("serve_aot", held):
                        assert c.warmup(name, n_cols=D)["aot"] is held
                for n in sizes:
                    q = _rows(n, 100 + n)
                    got, want = c_on.transform_raw(name, q), c_off.transform_raw(name, q)
                    for role in want:
                        assert np.array_equal(got[role], want[role]), (name, n, role)
                assert _status(c_on, name)["aot"]["hits"] == len(sizes)
                assert _status(c_off, name)["aot"] is None


@pytest.fixture
def both(mesh1):
    """A port and a JAX daemon. The JAX exact-kNN program is cached for the
    process: its AOT executables are dropped after the test, or the next
    JAX exact query in this process would meet them."""
    jax_knn._exact_knn_fn.cache_clear()
    try:
        with DataPlaneDaemon(device="cpu") as port, JaxDaemon(mesh=mesh1) as ref:
            yield port, ref
    finally:
        jax_knn._exact_knn_fn.cache_clear()


def test_warmup_ack_aot_field_equals_the_reference(both, registrations):
    """JAX ``test_aot_warmup_op_ack_field``: aot true with ``serve_aot`` on,
    false on the trace fallback; the rest of the ack as the reference's
    except ``compiled`` (the JAX plans' 256-row floor folds the ladder into
    one program, the port holds one a bucket)."""
    port, ref = both
    arrays, _ = registrations["pca"]
    with DataPlaneClient(*port.address) as pc, JaxClient(*ref.address) as jc:
        pc.ensure_model("m", "pca", arrays)
        jc.ensure_model("m", "pca", arrays)
        # The trace warmup first: a JAX wrapper holding an AOT executable
        # asks jax.core.trace_state_clean, which this jax lacks.
        acks = {}
        for on in (False, True):
            with config.option("serve_aot", on), jax_config.option("serve_aot", on):
                acks[on] = (pc.warmup("m", n_cols=D, dtype="float32"),
                            jc.warmup("m", n_cols=D, dtype="float32"))
        for on, (got, want) in acks.items():
            assert got["aot"] is want["aot"] is on
            assert got["buckets"] == want["buckets"] == LADDER
            assert got["enabled"] is want["enabled"] is True
        assert acks[False][0]["compiled"] == acks[False][1]["compiled"] == 3
        assert acks[True][0]["compiled"] == 3 and acks[True][1]["compiled"] == 1
        for c in (pc, jc):
            st = c._roundtrip({"op": "model_status", "model": "m"})[0]["aot"]
            assert st["buckets"] == LADDER and st["hits"] == st["misses"] == 0


def test_scaler_acks_aot_with_no_program_as_the_reference(both):
    port, ref = both
    x = _rows(64, 2).astype(np.float64)
    arrays = {"mean": x.mean(0), "std": x.std(0)}
    with DataPlaneClient(*port.address) as pc, JaxClient(*ref.address) as jc:
        pc.ensure_model("sc", "scaler", arrays)
        jc.ensure_model("sc", "scaler", arrays)
        got = pc.warmup("sc", n_cols=D, dtype="float32")
        want = jc.warmup("sc", n_cols=D, dtype="float32")
        assert got == want == {"enabled": True, "buckets": LADDER, "compiled": 0, "aot": True}
        q = _rows(9, 4)
        np.testing.assert_array_equal(pc.transform_raw("sc", q)["output"],
                                      _solo("scaler", arrays).transform_matrix(q)["output"])
        # No program, so nothing to hit or miss (the JAX ledger sums no wrapper).
        assert _status(pc, "sc")["aot"] == {"buckets": LADDER, "compiled": 0, "hits": 0,
                                            "misses": 0}
        with pytest.raises(RuntimeError):
            pc.warmup("sc", n_cols=D + 1)


def test_exact_index_warmup_equals_the_reference(both, mesh1):
    """The exact index's plan on both daemons: the padded query counts of
    8, 32 and 128 are 64 and 128, two programs each side. The held
    program's answer is the JAX ``NearestNeighbors``' (fitted before the
    JAX daemon primes its AOT programs, which this jax cannot run
    directly)."""
    port, ref = both
    x = _rows(200, 3)
    q = _rows(40, 5)
    ref_d, ref_i = _jax_kneighbors(x, q, 4, mesh=mesh1)
    with DataPlaneClient(*port.address) as pc, JaxClient(*ref.address) as jc:
        for c in (pc, jc):
            c.feed("kj", x, algo="knn", partition=0)
            c.commit("kj", partition=0)
            c.finalize_knn("kj", register_as="idx", mode="exact")
        got = pc.warmup("idx", n_cols=D, k=4, dtype="float32")
        want = jc.warmup("idx", n_cols=D, k=4, dtype="float32")
        assert got == want == {"enabled": True, "buckets": LADDER, "compiled": 2, "aot": True}
        dist, idx = pc.kneighbors_raw("idx", q, k=4)
        np.testing.assert_array_equal(idx, ref_i)
        np.testing.assert_allclose(dist, ref_d, **KNN_TOL)
        assert _status(pc, "idx")["aot"]["misses"] == 0


def test_ivf_index_acks_aot_false():
    """The IVF index publishes no plan (``docs/protocol.md``): trace-warmed,
    ``aot`` false, no compile ledger."""
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        c.feed_raw("ivf", _rows(256, 6), algo="knn", n_cols=D)
        c.finalize_knn("ivf", register_as="ivf", mode="ivf", nlist=4, nprobe=2, seed=0)
        info = c.warmup("ivf", n_cols=D, k=3)
        assert info == {"enabled": True, "buckets": LADDER, "compiled": 3, "aot": False}
        assert _status(c, "ivf")["aot"] is None


def test_serve_aot_off_falls_back_to_the_trace_warmup(registrations):
    arrays, _ = registrations["kmeans"]
    with config.option("serve_aot", False), DataPlaneDaemon(device="cpu") as d, \
            DataPlaneClient(*d.address) as c:
        c.ensure_model("m", "kmeans", arrays)
        assert _status(c, "m")["aot"] is None
        assert c.warmup("m", n_cols=D) == {"enabled": True, "buckets": LADDER, "compiled": 3,
                                           "aot": False}
        assert _status(c, "m")["aot"] is None


def test_knn_plan_pads_like_kneighbors():
    """JAX ``test_knn_aot_plan_pads_like_kneighbors``: buckets 8, 32 and 48
    prime the 64-row shape kneighbors dispatches; queries of 8 and 40 rows
    are two hits."""
    model = NearestNeighbors(device="cpu").setK(5).fit({"features": _rows(320, 8)})
    for bucket in (8, 32, 48):
        (plan,) = model._serve_aot_plan(bucket, D, dtype="float32")
        assert plan.rows == 64 and plan.width == D
    served = daemon_mod._ServedModel.from_model("knn", model)
    assert served.aot_warm(D, (8, 32, 48), 5) == {"buckets": [8, 32, 48], "compiled": 1}
    prog = next(iter(served.aot.programs.values()))
    assert tuple(prog.static_in.shape) == (64, D)
    for n in (8, 40):
        q = _rows(n, n)
        d, i = served.kneighbors(q, 5)
        ref_d, ref_i = model.kneighbors(q, 5)
        assert np.array_equal(d, ref_d) and np.array_equal(i, ref_i)
    assert served.aot_status() == {"buckets": [8, 32, 48], "compiled": 1, "hits": 2,
                                   "misses": 0}
    served.kneighbors(_rows(65, 1), 5)  # 128 rows: nothing primed
    assert served.aot_status()["misses"] == 1


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine", "inner_product"])
def test_exact_programs_answer_bitwise_as_eager_kneighbors(metric, mesh1):
    """Under every metric a held exact program answers as the model's eager
    kneighbors, bit for bit (cosine: the host normalizes before the static
    input, whose width is the augmented one), zero rows included, and as
    the JAX ``NearestNeighbors`` at the kNN tests' tolerances."""
    x = _rows(300, 11)
    x[5] = 0.0
    model = NearestNeighbors(device="cpu").setK(4).setMetric(metric).fit({"features": x})
    served = daemon_mod._ServedModel.from_model("knn", model)
    assert served.aot_warm(D, LADDER, 4)["compiled"] == 2
    widths = {p.static_in.shape[1] for p in served.aot.programs.values()}
    assert widths == {D + 2 if metric == "cosine" else D}
    for n in (1, 9, 64, 100):
        q = _rows(n, 200 + n)
        q[0] = 0.0
        (got_d, got_i), (want_d, want_i) = served.kneighbors(q, 4), model.kneighbors(q, 4)
        assert np.array_equal(got_d, want_d) and np.array_equal(got_i, want_i), n
        ref_d, ref_i = _jax_kneighbors(x, q, 4, metric, mesh1)
        # A zero query is 1 from every row under cosine: its order is
        # rounding, not data (as test_torch_knn holds it).
        real = slice(1 if metric == "cosine" else 0, None)
        np.testing.assert_array_equal(got_i[real], ref_i[real])
        np.testing.assert_allclose(got_d, ref_d, **KNN_TOL)
    assert served.aot_status()["hits"] == 4 and served.aot_status()["misses"] == 0


def test_aot_warmup_wrong_width_still_errors(registrations):
    """JAX ``test_aot_warmup_wrong_width_still_errors``: the plan's width
    check raises, the fallback's zero batch surfaces the mismatch, and the
    client gets an error, never an ack."""
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        for name in ("pca", "linreg", "rf_regressor"):
            arrays, _ = registrations[name]
            c.ensure_model(name, name, arrays)
            with pytest.raises(RuntimeError):
                c.warmup(name, n_cols=D - 6, dtype="float32")
        _build_exact(c)
        with pytest.raises(RuntimeError):
            c.warmup("idx", n_cols=D - 6, k=4, dtype="float32")
    with pytest.raises(ValueError, match="does not match"):
        _solo("pca", registrations["pca"][0])._serve_aot_plan(8, D - 6)


@pytest.mark.parametrize("width", [1, D - 1])
def test_a_request_of_another_width_raises_and_misses(width, registrations):
    """A request to a warmed model whose width is not the primed one is a
    miss: the eager path raises its shape error to the client, the held
    program is never run (numpy would broadcast one column across the
    static input) and no hit is counted."""
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        names = ("pca", "kmeans", "linreg", "logreg", "rf_regressor")
        for name in names:
            c.ensure_model(name, _algo(name), registrations[name][0])
            assert c.warmup(name, n_cols=D)["aot"] is True
        k = _build_exact(c)
        assert c.warmup("idx", n_cols=D, k=k)["aot"] is True
        runs0 = aot.ROUTES["aot/eager"]
        q = _rows(8, 12)[:, :width]
        for name in names:
            with pytest.raises(RuntimeError):
                c.transform_raw(name, q)
        with pytest.raises(RuntimeError):
            c.kneighbors_raw("idx", q, k=k)
        for name in names + ("idx",):
            st = _status(c, name)["aot"]
            # The served forest refuses a width before it dispatches.
            misses = 0 if name == "rf_regressor" else 1
            assert st["hits"] == 0 and st["misses"] == misses, (name, st)
        assert aot.ROUTES["aot/eager"] == runs0


def test_primed_shapes_keep_the_ledgers_cost_analysis():
    """JAX ``test_aot_primed_shapes_keep_cost_analysis``: a request served
    by a held program still records its kernel with flops and bytes."""
    model = NearestNeighbors(device="cpu").setK(4).fit({"features": _rows(96, 9)})
    served = daemon_mod._ServedModel.from_model("knn", model)
    served.aot_warm(D, [8], 4)
    xprof.reset()
    served.kneighbors(_rows(5, 1), 4)
    (rec,) = xprof.snapshot()["dist_topk"]["signatures"]
    assert rec["flops"] == 2 * 64 * 96 * D and rec["bytes_accessed"] is not None
    assert rec["route"] == "plain" and "float32[64,16]" in rec["sig"]
    assert served.aot_status()["hits"] == 1


def test_a_capture_is_credited_on_every_replay():
    """What a capture keeps (``xprof.recording``) is credited a replay:
    ``LAUNCHES`` and ``ROUTES`` through ``kernels.credit_launches``, the
    ledger through ``xprof.credit``; a timed replay's seconds go to the
    graph's own record (``aot.REPLAY``), never to a kernel; the wrappers'
    counts during the capture are taken back."""
    db = torch.from_numpy(_rows(64, 2))
    q = torch.from_numpy(_rows(8, 3))
    ids = torch.arange(64, dtype=torch.int32)
    mask = torch.ones(64)
    xprof.reset()
    kernels.reset_launches()
    with xprof.recording() as calls:
        kernels.dist_topk(q, db, ids, mask, 3)
    assert xprof.snapshot() == {}  # kept, not recorded
    ((name, route, sig, flops, nbytes),) = calls
    assert (name, route, flops) == ("dist_topk", "plain", 2 * 8 * 64 * D)
    graph_calls = [("dist_topk", "wgmma", sig, flops, nbytes)]  # as a capture on the card keeps
    kernels.LAUNCHES["dist_topk"] += 1  # the wrapper's bump during that capture
    kernels.ROUTES["dist_topk/wgmma"] += 1
    kernels.credit_launches(graph_calls, -1)
    assert kernels.LAUNCHES["dist_topk"] == kernels.ROUTES["dist_topk/wgmma"] == 0
    replay = [(aot.REPLAY, "graph", ("graph", xprof.signature(q)), flops, nbytes)]
    for n in range(3):
        kernels.credit_launches(graph_calls)
        xprof.credit(graph_calls)
        if n == 0:  # device_timing on for the first replay only
            xprof.credit(replay, seconds=0.5)
    assert kernels.LAUNCHES["dist_topk"] == kernels.ROUTES["dist_topk/wgmma"] == 3
    led = xprof.snapshot()["dist_topk"]
    assert led["calls"] == 3 and led["routes"] == {"wgmma": 3} and led["cache_misses"] == 1
    assert led["execute_calls"] == 0 and led["execute_s"] == 0.0
    assert led["signatures"][0]["flops"] == flops
    rep = xprof.snapshot()[aot.REPLAY]
    assert rep["calls"] == rep["execute_calls"] == 1 and rep["execute_s"] == 0.5
    assert rep["routes"] == {"graph": 1} and "float32[8,16]" in rep["signatures"][0]["sig"]
    kernels.credit_launches(calls, 5)  # a plain call counts no launch
    assert kernels.LAUNCHES["dist_topk"] == 3
    kernels.reset_launches()
    xprof.reset()


def test_a_reuploaded_or_dropped_index_drops_its_programs():
    """A new compute dtype re-uploads the index (``_index_cache`` cleared):
    the program captured over the old one is released and the dispatch
    runs eagerly over the new index. ``drop_model`` releases them all."""
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        k = _build_exact(c)
        assert c.warmup("idx", n_cols=D, k=k)["compiled"] == 2
        served = d._lookup_model("idx")
        progs = dict(served.aot.programs)
        q = _rows(20, 7)
        c.kneighbors_raw("idx", q, k=k)
        assert served.aot_status()["hits"] == 1
        epoch = served.model._index_epoch
        with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
            dist, idx = c.kneighbors_raw("idx", q, k=k)
            want_d, want_i = served.model.kneighbors(q, k)
        assert served.model._index_epoch > epoch
        assert np.array_equal(idx, want_i) and np.array_equal(dist, want_d)
        assert served.aot_status()["misses"] == 1
        prog64 = progs[aot.ProgramSet.key(64, D, np.float32, k)]
        assert prog64.released and not prog64.usable()
        assert c.warmup("idx", n_cols=D, k=k)["compiled"] == 2  # rebuilt over the new index
        live = [weakref.ref(p) for p in served.aot.programs.values()]
        del progs, prog64, served
        assert c._roundtrip({"op": "drop_model", "model": "idx"})[0]["dropped"]
    gc.collect()
    assert all(r() is None or r().released for r in live)


def test_model_status_reports_null_before_a_warm(registrations):
    arrays, _ = registrations["linreg"]
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        assert _status(c, "ghost") == {"ok": True, "exists": False, "algo": None, "aot": None}
        c.ensure_model("m", "linreg", arrays)
        assert _status(c, "m")["aot"] is None
        c.warmup("m", n_cols=D)
        assert _status(c, "m")["aot"]["compiled"] == 3


def test_a_cpu_program_never_builds_a_graph(registrations):
    arrays, _ = registrations["pca"]
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        c.ensure_model("m", "pca", arrays)
        c.warmup("m", n_cols=D)
        graph0 = aot.ROUTES["aot/graph"]
        c.transform_raw("m", _rows(3, 1))
        progs = d._lookup_model("m").aot.programs.values()
        assert all(p.graph is None and p.capture_s == 0.0 for p in progs)
    assert aot.ROUTES["aot/graph"] == graph0


def test_serve_aot_reads_its_own_env_var():
    code = ("from spark_rapids_ml_tpu_torch import config; print(config.get('serve_aot'))")
    env = {k: v for k, v in os.environ.items()
           if k not in ("SRML_SERVE_AOT", "SRML_TORCH_SERVE_AOT")}
    env["PYTHONPATH"] = str(ROOT)
    seen = {}
    for var in ("SRML_TORCH_SERVE_AOT", "SRML_SERVE_AOT"):
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=120, env={**env, var: "0"})
        assert r.returncode == 0, r.stderr[-2000:]
        seen[var] = r.stdout.strip()
    assert seen == {"SRML_TORCH_SERVE_AOT": "False", "SRML_SERVE_AOT": "True"}
