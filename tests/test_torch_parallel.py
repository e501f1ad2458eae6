"""The port's parallel layer and host utilities in one process, against the
JAX package's modules on the same inputs:

* ``parallel/membership`` (the scenarios of tests/test_mesh_collectives.py
  run against both registries, with equal snapshots), ``utils/metrics``
  (one sequence of records through both modules: equal snapshots and
  Prometheus / OpenMetrics texts), the config readers,
  ``utils/retry.with_retries`` (the cases of
  tests/test_distributed_utils.py), ``bridge/native.cast_f64_to_f32``
  (bitwise to the JAX function and to numpy);
* ``parallel/distributed`` in the world of one (``initialize_cluster`` a
  no-op, ``process_local_rows``), the lockstep iterators against JAX's,
  ``make_mesh``'s errors, the mapreduce primitives at world size 1 and
  the re-exports of ``parallel``, ``core``, ``bridge``, ``ops`` and
  ``utils`` against the JAX package's.
"""

import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.parallel as jax_parallel
from spark_rapids_ml_tpu.parallel import membership as jax_membership
from spark_rapids_ml_tpu.parallel import sharding as jax_sharding
from spark_rapids_ml_tpu.utils import metrics as jax_metrics
from spark_rapids_ml_tpu.utils import retry as jax_retry
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch import parallel as port_parallel
from spark_rapids_ml_tpu_torch.parallel import distributed, mapreduce as mr
from spark_rapids_ml_tpu_torch.parallel import membership as port_membership
from spark_rapids_ml_tpu_torch.parallel import mesh as port_mesh
from spark_rapids_ml_tpu_torch.parallel import sharding as port_sharding
from spark_rapids_ml_tpu_torch.utils import metrics as port_metrics
from spark_rapids_ml_tpu_torch.utils.retry import decorrelated_jitter, with_retries

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBERSHIP = [jax_membership, port_membership]


class _Handle:  # a registrable (weakly referenceable) handle
    pass


# ------------------------------- membership ---------------------------------


def _epochs_and_snapshots(mod):
    reg = mod.MeshMembership()
    h1, h2 = _Handle(), _Handle()
    trace = [reg.epoch]
    trace.append(reg.register("a", "boot1", h1))
    trace.append(reg.register("b", "boot2", h2))
    trace.append(reg.register("a", "boot9", h1))  # a reboot bumps
    snap = reg.snapshot()
    trace.append(reg.unregister("b"))
    trace.append(reg.unregister("nope"))  # unknown id: no bump
    got = (reg.get("a", boot_id="boot1") is None, reg.get("a", boot_id="boot9") is h1)
    return trace, snap, reg.snapshot(), got


def test_membership_epochs_and_snapshots_equal_jax():
    jax_run, port_run = (_epochs_and_snapshots(m) for m in MEMBERSHIP)
    assert port_run == jax_run
    trace = port_run[0]
    assert all(b > a for a, b in zip(trace[:5], trace[1:5])) and trace[5] == trace[4]
    assert port_run[3] == (True, True)


@pytest.mark.parametrize("mod", MEMBERSHIP, ids=["jax", "port"])
def test_membership_unregister_is_incarnation_scoped(mod):
    reg = mod.MeshMembership()
    a1, a2 = _Handle(), _Handle()
    reg.register("X", "boot1", a1)
    reg.register("X", "boot2", a2)  # successor on the same durable id
    e = reg.epoch
    assert reg.unregister("X", boot_id="boot1") == e  # stale: no-op
    assert reg.get("X", boot_id="boot2") is a2
    assert reg.unregister("X", boot_id="boot2") > e
    assert reg.get("X") is None


def test_membership_dead_handles_read_as_absent_in_both():
    snaps = []
    for mod in MEMBERSHIP:
        reg = mod.MeshMembership()
        h = _Handle()
        reg.register("ghost", "b", h)
        del h
        assert reg.get("ghost") is None
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1] and snaps[1]["members"] == []
    assert isinstance(port_membership.registry(), port_membership.MeshMembership)
    assert port_membership.registry() is port_membership.registry()


# --------------------------------- metrics ----------------------------------


def _record(mod):
    reg = mod.Registry()
    c = reg.counter("srml_test_requests_total", "requests by op")
    g = reg.gauge("srml_test_staged_bytes", "staged bytes")
    h = reg.histogram("srml_test_latency_seconds", "op latency", buckets=(0.01, 0.1, 1.0))
    c.inc(op="feed")
    c.inc(2.5, op="feed")
    c.inc(op='say "hi"\n')  # escaped label values
    g.set(1024, job="a")
    g.inc(16, job="a")
    g.dec(4, job="b")
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, op="feed")
    return reg, (c.value(op="feed"), g.value(job="a"), g.value(job="b"))


def test_metrics_records_render_as_jax():
    (jreg, jvals), (preg, pvals) = _record(jax_metrics), _record(port_metrics)
    assert pvals == jvals == (3.5, 1040.0, -4.0)
    assert preg.snapshot() == jreg.snapshot()
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert preg.render_openmetrics() == jreg.render_openmetrics()
    b = {"0.01": 1, "0.1": 2, "1.0": 3, "+Inf": 4}
    assert port_metrics.quantile_from_buckets(b, 0.5) == jax_metrics.quantile_from_buckets(b, 0.5)
    assert port_metrics.__all__ == jax_metrics.__all__


def test_metrics_switch_off_records_nothing():
    reg = port_metrics.Registry()
    c = reg.counter("srml_test_off_total")
    with config.option("metrics", False):
        c.inc(op="x")
    c.inc(op="y")
    assert c.value(op="x") == 0 and c.value(op="y") == 1


# ------------------------------ config readers --------------------------------


def test_config_readers():
    assert config.get_raw("compute_dtype") == config.get("compute_dtype")
    assert config.peek("metrics") is True and config.peek("no_such_key") is None
    assert config.get("mesh_data_axis") is None and config.get("mesh_model_axis") == 1
    before = config.fingerprint()
    assert len(before) == 16 and before == config.fingerprint()
    with config.option("mesh_model_axis", 2):
        assert config.fingerprint() != before
    assert config.fingerprint() == before


def test_config_mesh_keys_read_the_torch_prefix_and_reset():
    # A fresh process: the env is read at import, and reset() restores it.
    code = (
        "from spark_rapids_ml_tpu_torch import config; "
        "config.set('mesh_data_axis', 7); config.reset(); "
        "print(config.get('mesh_data_axis'), config.get('mesh_model_axis'), config.get('metrics'))"
    )
    env = dict(os.environ, SRML_TORCH_MESH_DATA_AXIS="4", SRML_TORCH_METRICS="0",
               SRML_TPU_MESH_MODEL_AXIS="2")  # the JAX package's name: not read
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["4", "1", "False"], out.stderr


# ------------------------------- with_retries --------------------------------


def test_with_retries_succeeds_after_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert with_retries(flaky, max_attempts=5, base_delay_s=0.001) == "ok"
    assert calls["n"] == 3


def test_with_retries_exhausts_and_does_not_retry_other_errors():
    def always_fails():
        raise OSError("permanent")

    with pytest.raises(OSError):
        with_retries(always_fails, max_attempts=2, base_delay_s=0.001)
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("deterministic bug")

    with pytest.raises(ValueError):
        with_retries(bad, max_attempts=5, base_delay_s=0.001)
    assert calls["n"] == 1


def test_decorrelated_jitter_equals_jax():
    def walk(fn, seed, n=64):
        rng = random.Random(seed)
        d, out = 0.05, []
        for _ in range(n):
            d = fn(d, 0.05, 2.0, rng)
            out.append(d)
        return out

    port, ref = walk(decorrelated_jitter, 1), walk(jax_retry.decorrelated_jitter, 1)
    assert port == ref and all(0.05 <= d <= 2.0 for d in port)
    assert walk(decorrelated_jitter, 2) != port


def test_with_retries_caps_delay_and_honours_the_deadline():
    calls = {"n": 0}

    def fails_then_ok():
        calls["n"] += 1
        if calls["n"] < 5:
            raise OSError("transient")
        return "ok"

    start = time.monotonic()
    assert with_retries(fails_then_ok, max_attempts=6, base_delay_s=0.001,
                        max_delay_s=0.01, rng=random.Random(0)) == "ok"
    assert time.monotonic() - start < 1.0
    calls["n"] = 0

    def always_fails():
        calls["n"] += 1
        raise OSError("transient")

    start = time.monotonic()
    with pytest.raises(OSError):
        with_retries(always_fails, max_attempts=1000, base_delay_s=0.05, max_delay_s=0.05,
                     deadline_s=0.2, rng=random.Random(0))
    assert time.monotonic() - start < 2.0 and calls["n"] < 50


# ------------------------------- native cast ----------------------------------


def test_cast_f64_to_f32_bitwise_to_jax_and_numpy():
    from spark_rapids_ml_tpu.bridge import native as jax_native
    from spark_rapids_ml_tpu_torch.bridge import native as port_native

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1001, 37)) * 10.0 ** rng.integers(-40, 40, size=(1001, 37))
    x[0, :4] = [np.inf, -np.inf, 1e300, 5e-324]
    got = port_native.cast_f64_to_f32(x)
    if got is None:
        pytest.skip("libsrml_tpu.so is not built here")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), x.astype(np.float32).view(np.uint32))
    ref = jax_native.cast_f64_to_f32(x)
    if ref is not None:
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert port_native.cast_f64_to_f32(x.astype(np.float32)) is None
    with config.option("use_native_bridge", False):
        assert port_native.cast_f64_to_f32(x) is None


def test_shard_rows_casts_float64_feeds_in_the_world_of_one():
    x = np.random.default_rng(1).normal(size=(13, 5))
    mesh = port_mesh.default_mesh()
    xs, mask, n_true = port_sharding.shard_rows(x, mesh, dtype=np.float32, device="cpu")
    assert xs.dtype == torch.float32 and n_true == 13 and float(mask.sum()) == 13
    np.testing.assert_array_equal(xs.numpy(), x.astype(np.float32))
    xs, mask, _ = port_sharding.shard_rows(torch.from_numpy(x), mesh, with_mask=False,
                                           device="cpu")
    assert mask is None and xs.dtype == torch.float64
    rep = port_sharding.replicated_array(x[:3], mesh, device="cpu")
    np.testing.assert_array_equal(rep.numpy(), x[:3])


# -------------------------- distributed, world of one ---------------------------


def test_initialize_cluster_single_process_is_a_noop():
    assert distributed.initialize_cluster() == 0
    assert distributed.is_initialized()
    assert port_mesh.world() is port_mesh.SOLO
    mesh = distributed.global_mesh()
    assert port_mesh.mesh_shape(mesh) == (1, 1) and not mesh.collective
    assert mesh.device is None and mesh.backend is None


@pytest.mark.parametrize("n", [0, 1, 100, 603])
def test_process_local_rows_single(n):
    assert distributed.process_local_rows(n) == (0, n)
    np.testing.assert_array_equal(distributed.row_counts(n), [n])
    np.testing.assert_array_equal(distributed.process_allgather(np.arange(3)), [np.arange(3)])


def test_default_mesh_follows_the_config_and_the_world():
    m1 = port_mesh.default_mesh()
    assert port_mesh.default_mesh() is m1
    with config.option("mesh_data_axis", 1):
        m2 = port_mesh.default_mesh()
    assert m2 is not m1
    port_mesh.reset_default_mesh()
    assert port_mesh.default_mesh() is not m2
    # A model axis of 2 does not divide the world of one (the JAX message).
    with config.option("mesh_model_axis", 2), pytest.raises(ValueError,
                                                            match="not divisible by model=2"):
        port_mesh.default_mesh()


def test_make_mesh_errors_as_jax(devices):
    from spark_rapids_ml_tpu.parallel.mesh import make_mesh as jax_make_mesh

    eight = list(range(8))
    for kw in ({"model": 3}, {"data": 9}, {"data": 3, "model": 3}):
        with pytest.raises(ValueError) as jerr:
            jax_make_mesh(**kw)
        with pytest.raises(ValueError) as perr:
            port_mesh.make_mesh(devices=eight, **kw)
        assert str(perr.value) == str(jerr.value)
    # A model axis of 2: in the world of one the JAX message of one device;
    # over eight devices a 4 x 2 mesh the world of one rank cannot cover.
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(model=2, devices=devices[:1])
    with pytest.raises(ValueError) as perr:
        port_mesh.make_mesh(model=2)
    assert str(perr.value) == str(jerr.value) == "1 devices not divisible by model=2"
    with pytest.raises(ValueError, match="mesh 4x2 covers 8 of the world's 1 ranks"):
        port_mesh.make_mesh(model=2, devices=eight)
    with pytest.raises(ValueError, match="spans the whole world"):
        port_mesh.make_mesh(data=4, devices=eight)  # 4 of the world's 1 rank
    mesh = port_mesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1


# ------------------------------ lockstep iterators -------------------------------


def _pairs():
    rng = np.random.default_rng(2)
    return [(rng.normal(size=(m, 4)).astype(np.float32), rng.integers(0, 2, size=(m, 1)))
            for m in (5, 0, 3)]


def test_lockstep_iterators_single_process_equal_jax():
    port = list(port_sharding.lockstep_labeled_batches(iter(_pairs()), 4))
    ref = list(jax_sharding.lockstep_labeled_batches(iter(_pairs()), 4))
    assert len(port) == len(ref) == 3
    for (px, py), (jx, jy) in zip(port, ref):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
        assert py.ndim == 1
    xs = [x for x, _ in _pairs()]
    for p, j in zip(port_sharding.lockstep_batches(iter(xs), 4),
                    jax_sharding.lockstep_batches(iter(xs), 4)):
        np.testing.assert_array_equal(p, j)
    # Tensors pass through where they lie, bfloat16 too.
    t = torch.ones((2, 4), dtype=torch.bfloat16)
    assert next(port_sharding.lockstep_batches(iter([t]), 4)) is t


def test_lockstep_check_error_text_equals_jax():
    def check(x, y):
        return "labels must be 0/1" if (y > 1).any() else None

    pairs = [(np.ones((2, 4)), np.array([0, 1])), (np.ones((2, 4)), np.array([0, 2]))]
    with pytest.raises(ValueError) as jerr:
        list(jax_sharding.lockstep_labeled_batches(iter(pairs), 4, check=check))
    with pytest.raises(ValueError) as perr:
        list(port_sharding.lockstep_labeled_batches(iter(pairs), 4, check=check))
    assert str(perr.value) == str(jerr.value) == "labels must be 0/1"
    with pytest.raises(ValueError, match="width 3"):
        list(port_sharding.lockstep_batches(iter([np.ones((2, 3))]), 4,
                                            check=lambda x: f"width {x.shape[1]}"))


def test_require_single_process_is_silent_in_the_world_of_one():
    assert port_sharding.require_single_process("anything") is None
    assert jax_sharding.require_single_process("anything") is None


def test_placements_and_run_bucketed_as_jax(mesh8):
    mesh = port_mesh.default_mesh()
    assert port_sharding.row_sharding(mesh, 3).spec == ("data", None, None)
    assert port_sharding.replicated(mesh).spec == ()
    assert tuple(jax_sharding.row_sharding(mesh8, 3).spec) == ("data", None, None)
    x = np.arange(30, dtype=np.float64).reshape(10, 3)
    seen = []

    def fn(xp):
        seen.append(xp.shape)
        return torch.from_numpy(xp * 2.0)

    np.testing.assert_array_equal(port_sharding.run_bucketed(fn, x, min_bucket=4), x * 2.0)
    assert seen == [(16, 3)] and jax_sharding.bucket_rows(10, 4) == 16


# ------------------------- mapreduce at world size 1 ----------------------------


def test_mapreduce_primitives_in_the_world_of_one():
    mesh = port_mesh.default_mesh()
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    before = port_metrics.REGISTRY.snapshot()
    assert mr.reduce_sum(x) is x
    np.testing.assert_array_equal(mr.all_concat(x, axis=1).numpy(), x.numpy())
    np.testing.assert_array_equal(mr.all_concat(x, tiled=False).numpy(), x.numpy()[None])
    np.testing.assert_array_equal(mr.ring_shift(x, "data", [(0, 0)]).numpy(), x.numpy())
    assert float(mr.ring_shift(x, "data", []).abs().sum()) == 0.0
    d = torch.tensor([[3.0, 1.0, 1.0, 2.0]], dtype=torch.float64)
    i = torch.tensor([[7, 9, 4, 1]])
    got_d, got_i = mr.reduce_topk(d, i, 3)
    assert got_d.tolist() == [[1.0, 1.0, 2.0]] and got_i.tolist() == [[4, 9, 1]]
    pad_d, pad_i = mr.reduce_topk(d[:, :2], i[:, :2], 3)  # a short pool pads last
    assert pad_d.tolist() == [[1.0, 3.0, float("inf")]] and pad_i[0, :2].tolist() == [9, 7]
    with pytest.raises(TypeError, match="accumulators"):
        mr.reduce_sum(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mr.reduce_sum(x, "rows")
    assert mr.map_fn(lambda a: a + 1, mesh)(x).equal(x + 1)
    snap = port_metrics.REGISTRY.snapshot()["srml_parallel_collective_traces_total"]
    old = before.get("srml_parallel_collective_traces_total", {"samples": []})["samples"]

    def count(series, kind):
        return sum(s["value"] for s in series if s["labels"].get("kind") == kind)

    # One booking per call, as the JAX package books one per traced call site.
    assert count(snap["samples"], "psum") - count(old, "psum") == 3
    assert count(snap["samples"], "all_gather") - count(old, "all_gather") == 6
    assert count(snap["samples"], "ppermute") - count(old, "ppermute") == 2
    assert all(v == 0 for v in mr.STAGED.values())


# ------------------------------ the re-exports -----------------------------------


def test_parallel_all_equals_jax():
    assert port_parallel.__all__ == jax_parallel.__all__
    for name in port_parallel.__all__:
        assert getattr(port_parallel, name) is not None


@pytest.mark.parametrize("sub,missing", [
    ("core", set()),
    ("bridge", set()),
    ("ops", {"sharded_stats_2d"}),
    ("utils", set()),
])
def test_subpackage_exports_equal_jax_less_what_waits(sub, missing):
    import importlib

    port = importlib.import_module(f"spark_rapids_ml_tpu_torch.{sub}")
    ref = importlib.import_module(f"spark_rapids_ml_tpu.{sub}")
    assert port.__all__ == [n for n in ref.__all__ if n not in missing]
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_ops_exports_compute_as_jax():
    from spark_rapids_ml_tpu.ops import eigh as jax_eigh
    from spark_rapids_ml_tpu_torch import ops

    w = np.array([4.0, 1.0, -1e-12, 0.5])
    np.testing.assert_allclose(ops.explained_variance_ratio(torch.from_numpy(w)).numpy(),
                               np.asarray(jax_eigh.explained_variance_ratio(w)), rtol=1e-15)
    with ops.mm_precision(torch.float32):
        assert torch.backends.cuda.matmul.allow_tf32 is False
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(9, 4)))
    with config.option("accum_dtype", "float64"), config.option("compute_dtype", "float64"):
        count, colsum, g = ops.sharded_stats(port_mesh.default_mesh())(x)
    assert float(count) == 9
    np.testing.assert_allclose(g.numpy(), (x.T @ x).numpy(), rtol=1e-14)
    np.testing.assert_allclose(colsum.numpy(), x.sum(0).numpy(), rtol=1e-14)
