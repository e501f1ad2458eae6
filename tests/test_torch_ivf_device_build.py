"""The port's device-resident IVF-Flat build (``build_ivf_flat_device``)
and the daemon's build routes, against the JAX package's and the port's
host build, on the CPU (``device="cpu"``: the kernels' plain versions).

* The JAX package's own invariants of its device build
  (``tests/test_knn.py``): an exact partition of the rows, slots equal to
  the mask, each row in a list within 1e-2·(1 + dmin) of its nearest
  centroid with its row copied exactly, and recall@5 > 0.85 at nprobe 6.
* Against the JAX ``build_ivf_flat_device`` (float32, ledger off) under
  one frozen quantizer: each list's sorted id set, ``maxlen`` and the
  valid-slot count equal, with and without a capacity spill. The slot
  order within a list is each package's draw and is not compared.
* Against the port's ``build_ivf_flat`` on the same rows and seed:
  every field bitwise equal, frozen and trained.
* ``train_data``, a device-built index through the model (kneighbors,
  ``_model_data``, ``shard_index``, pickle), and the daemon's routes
  (``device``, ``auto`` under and over the cap, ``host``, an unknown
  build), a ``state_dir`` snapshot of a device-built index, and the env
  name of the cap.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import knn as jk
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import knn as pk
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("centroids", "lists", "list_ids", "list_mask")


@pytest.fixture(autouse=True)
def _f32_both():
    """float32 compute and accumulators in both packages (the JAX conftest
    defaults the JAX package to float64), the JAX ledger off."""
    with jax_ledger_off(), jax_config.option("compute_dtype", "float32"), \
            jax_config.option("accum_dtype", "float32"), \
            config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"):
        yield


def _blobs(seed, n, d, nlist, scale, noise, skew=0.0):
    """(rows float32, centres float32): ``nlist`` gaussian blobs; with
    ``skew`` that share of the rows goes to blob 0."""
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(nlist, d)) * scale).astype(np.float32)
    lab = rng.integers(0, nlist, size=n)
    lab[: int(skew * n)] = 0
    x = (centers[lab] + noise * rng.normal(size=(n, d))).astype(np.float32)
    return x, centers


def _host(index):
    return {f: pk._host_array(getattr(index, f)) for f in FIELDS}


def _list_sets(index):
    ids = pk._host_array(index.list_ids)
    return [sorted(row[row >= 0].tolist()) for row in ids]


# ---------------------------------------------------------------------------
# The JAX package's invariants
# ---------------------------------------------------------------------------


def test_device_build_keeps_the_jax_invariants():
    """``tests/test_knn.py::test_build_ivf_flat_device_invariants`` on the
    port's device build: its data, its checks, tensor fields."""
    n, d, nlist = 512, 16, 8
    x, _ = _blobs(42, n, d, nlist, 10.0, 0.01)  # its rng fixture's draws
    idx = pk.build_ivf_flat_device(x, nlist=nlist, seed=1, device="cpu")
    assert all(isinstance(getattr(idx, f), torch.Tensor) for f in FIELDS)
    assert (idx.lists.dtype, idx.list_ids.dtype, idx.list_mask.dtype) == (
        torch.float32, torch.int64, torch.float32)
    h = _host(idx)
    ids, mask = h["list_ids"], h["list_mask"]
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(n))
    np.testing.assert_array_equal((ids >= 0).astype(np.float32), mask)
    d2 = ((x[:, None, :] - h["centroids"][None]) ** 2).sum(-1)
    dmin = d2.min(1)
    for li in range(nlist):
        for slot in np.nonzero(ids[li] >= 0)[0]:
            rid = ids[li, slot]
            assert d2[rid, li] <= dmin[rid] + 1e-2 * (1 + dmin[rid]), (rid, li)
            np.testing.assert_array_equal(h["lists"][li, slot], x[rid])


def test_device_build_recall_through_the_model():
    """``tests/test_knn.py::test_build_ivf_flat_device_query_recall``:
    nprobe·4 < nlist, so the bucketed executor answers."""
    n, d, nlist = 2048, 32, 32
    x, _ = _blobs(42, n, d, nlist, 8.0, 0.05)
    idx = pk.build_ivf_flat_device(x, nlist=nlist, seed=2, device="cpu")
    model = pk.ApproximateNearestNeighborsModel(index=idx, device="cpu")
    model._set(k=5, nprobe=6)
    q = x[:64]
    _, ids = model.kneighbors(q)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    ref = np.argsort(d2, axis=1)[:, :5]
    recall = np.mean([len(set(ids[i]) & set(ref[i])) / 5 for i in range(len(q))])
    assert recall > 0.85, recall


# ---------------------------------------------------------------------------
# Against the JAX device build and the port's host build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [0.0, 0.4])
def test_frozen_lists_equal_the_jax_device_build(skew):
    """Under one frozen quantizer, on well-separated blobs, the same rows
    in every list. At ``skew`` 0.4 blob 0's natural list holds about 40 %
    of the rows, past ``_ivf_cap`` (2× the mean): the balancer spills it
    along the ``dist_topk`` candidates."""
    n, d, nlist = 2048, 16, 16
    x, centers = _blobs(42, n, d, nlist, 8.0, 0.05, skew)
    natural = np.bincount(np.argmin(((x[:, None] - centers[None]) ** 2).sum(-1), 1),
                          minlength=nlist)
    assert (natural.max() > pk._ivf_cap(n, nlist)) == (skew > 0)
    ref = jk.build_ivf_flat_device(jnp.asarray(x), nlist=nlist, seed=3, centroids=centers)
    out = pk.build_ivf_flat_device(x, nlist=nlist, seed=3, centroids=centers, device="cpu")
    assert _list_sets(out) == _list_sets(ref)
    assert out.lists.shape[1] == np.asarray(ref.lists).shape[1]
    assert int(out.list_mask.sum()) == int(np.asarray(ref.list_mask).sum()) == n
    np.testing.assert_array_equal(pk._host_array(out.centroids), np.asarray(ref.centroids))


@pytest.mark.parametrize("frozen, skew, train_rows, balancer_calls", [
    (True, 0.0, 2_000_000, 0),
    (True, 0.4, 2_000_000, 2),  # blob 0's list past its cap: the capacity spill
    (False, 0.0, 2_000_000, 8),  # the random init crowds lists: the balanced refine
    (False, 0.4, 2_000_000, 0),  # the quantizer splits blob 0: no list past its cap
    (False, 0.0, 1000, 8),  # a sampled quantizer
])
def test_every_field_bitwise_equals_the_host_build(frozen, skew, train_rows, balancer_calls,
                                                   monkeypatch):
    """The same kernels on the same chunks, the same balancer and the same
    permutation: bitwise in every field and dtype. Trained, both draw the
    same sample and initial centres, and the CPU sums in one order.
    ``balancer_calls`` counts both builds' (4 a balanced refine)."""
    calls = []
    real = pk._balance_assignments
    monkeypatch.setattr(pk, "_balance_assignments", lambda *a: calls.append(1) or real(*a))
    n, d, nlist = 3000, 16, 16
    x, centers = _blobs(43, n, d, nlist, 8.0, 0.5, skew)
    kw = {"centroids": centers} if frozen else {"train_rows": train_rows}
    host = pk.build_ivf_flat(x, nlist, seed=3, device="cpu", **kw)
    dev = pk.build_ivf_flat_device(x, nlist, seed=3, device="cpu", **kw)
    for f in FIELDS:
        got = pk._host_array(getattr(dev, f))
        assert got.dtype == getattr(host, f).dtype, f
        np.testing.assert_array_equal(got, getattr(host, f), err_msg=f)
    assert len(calls) == balancer_calls
    if balancer_calls:
        assert host.lists.shape[1] <= pk._ivf_cap(n, nlist)


def test_a_tensor_database_equals_host_rows():
    """Rows already on the device build where they lie; bfloat16 rows'
    lists widen to float32, as the host build's ``_host_rows``."""
    x, centers = _blobs(44, 1024, 16, 8, 8.0, 0.5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    host = pk.build_ivf_flat(xt, 8, seed=4, centroids=centers, device="cpu")
    dev = pk.build_ivf_flat_device(xt, 8, seed=4, centroids=centers, device="cpu")
    assert dev.lists.dtype == torch.float32
    for f in FIELDS:
        np.testing.assert_array_equal(pk._host_array(getattr(dev, f)), getattr(host, f))


def test_train_data_covers_both_regions():
    """``tests/test_knn.py::test_ivf_build_trains_on_explicit_cross_shard_sample``
    for the device build: a pool spanning regions A and B places centroids
    in both, the lists hold only the database's rows; a pool too narrow or
    too short raises the port's ValueError."""
    rng = np.random.default_rng(45)
    region_a = rng.normal(size=(400, 6)).astype(np.float32)
    region_b = (rng.normal(size=(400, 6)) + 40.0).astype(np.float32)
    pool = np.concatenate([region_a, region_b])
    index = pk.build_ivf_flat_device(region_a, nlist=8, seed=0, train_data=pool, device="cpu")
    cent = pk._host_array(index.centroids)
    assert (cent.mean(axis=1) > 20).any() and (cent.mean(axis=1) < 20).any()
    assert int(index.list_mask.sum()) == len(region_a)
    host = pk.build_ivf_flat(region_a, nlist=8, seed=0, train_data=pool, device="cpu")
    np.testing.assert_array_equal(cent, host.centroids)
    with pytest.raises(ValueError, match="train_data shape .* does not match"):
        pk.build_ivf_flat_device(region_a, nlist=8, seed=0, train_data=pool[:, :4], device="cpu")
    with pytest.raises(ValueError, match="train_data has 4 rows < nlist = 8"):
        pk.build_ivf_flat_device(region_a, nlist=8, seed=0, train_data=pool[:4], device="cpu")


def test_build_validates_its_inputs():
    x, _ = _blobs(46, 256, 16, 8, 8.0, 0.5)
    for build in (pk.build_ivf_flat, pk.build_ivf_flat_device):
        with pytest.raises(ValueError, match="pretrained centroids"):
            build(x, 8, centroids=np.zeros((7, 16)), device="cpu")
        with pytest.raises(ValueError, match="train_rows = 4 must be >= nlist = 8"):
            build(x, 8, train_rows=4, device="cpu")


# ---------------------------------------------------------------------------
# A device-built index through the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """(rows, queries, the device-built index) at nlist 32."""
    x, _ = _blobs(47, 2048, 32, 32, 8.0, 0.5)
    q = x[::32] + np.float32(0.01)
    with config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"):
        return x, q, pk.build_ivf_flat_device(x, 32, seed=5, device="cpu")


def _model(index, nprobe=6):
    m = pk.ApproximateNearestNeighborsModel(index=index, device="cpu")
    m._set(k=5, nprobe=nprobe)
    return m


@pytest.mark.parametrize("nprobe", [6, 16])
def test_kneighbors_equals_the_host_copy(built, nprobe):
    """The bucketed (nprobe 6) and dense (nprobe 16) executors answer a
    device-built index as its host-numpy copy, bitwise; the device index
    is used where it lies."""
    _, q, index = built
    dev_model = _model(index, nprobe)
    d1, i1 = dev_model.kneighbors(q)
    assert all(a is b for a, b in zip(dev_model._dev_index[1], index))
    d2, i2 = _model(pk.IVFFlatIndex(**_host(index)), nprobe).kneighbors(q)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_model_data_pickle_and_shard_index(built):
    """``_model_data`` holds host arrays that rebuild the same answers, as
    a pickle does; ``shard_index`` on a world of one answers as unsharded."""
    _, q, index = built
    model = _model(index)
    want = model.kneighbors(q)
    data = model._model_data()
    assert all(isinstance(v, np.ndarray) for v in data.values())
    back = pk.ApproximateNearestNeighborsModel._from_model_data("rt", data)
    back._device = "cpu"
    back._set(k=5, nprobe=6)
    for got in (back.kneighbors(q), pickle.loads(pickle.dumps(model)).kneighbors(q)):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    sharded = _model(index).shard_index()
    got = sharded.kneighbors(q)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# The daemon's routes
# ---------------------------------------------------------------------------

X, _ = _blobs(48, 480, 12, 8, 4.0, 1.0)
Q = X[::20] + np.float32(0.05)
PARTS = np.array_split(X, 4)
NLIST, SEED = 8, 7


def _feed(c, job):
    for p in (2, 0, 3, 1):
        c.feed_raw(job, PARTS[p], algo="knn", partition=p)
        c.commit(job, partition=p)


def _finalize(c, job, name, build, metric="euclidean"):
    return c.finalize(job, {"mode": "ivf", "nlist": NLIST, "nprobe": 3, "seed": SEED,
                            "metric": metric, "build": build, "register_as": name})


def _in_process(build_fn, metric="euclidean"):
    rows = pk._normalized_rows(X, zero_slot=0) if metric == "cosine" else X
    m = pk.ApproximateNearestNeighborsModel(index=build_fn(rows, NLIST, seed=SEED, device="cpu"),
                                            device="cpu")
    m._set(k=4, nprobe=3, metric=metric)
    m._index_metric = metric
    return m.kneighbors(Q)


@pytest.mark.parametrize("build, metric", [("device", "euclidean"), ("auto", "euclidean"),
                                           ("device", "cosine")])
def test_daemon_device_route_answers_as_the_in_process_device_build(build, metric):
    want = _in_process(pk.build_ivf_flat_device, metric)
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        _feed(c, "dv")
        _finalize(c, "dv", "dv-idx", build, metric)
        index = d._lookup_model("dv-idx").model.index
        assert isinstance(index.lists, torch.Tensor)  # the device route
        got = c.kneighbors("dv-idx", Q, k=4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("build, cap", [("auto", 0), ("host", 4 << 30)])
def test_daemon_host_route(monkeypatch, build, cap):
    """``auto`` past the cap (``tests/test_serve.py::test_daemon_ivf_host_build_path``,
    ``sharded`` 0 in the port) and ``host`` build host numpy lists, which
    answer as the in-process host build and as the device route."""
    monkeypatch.setattr(daemon_mod, "_IVF_DEVICE_BUILD_MAX_BYTES", cap)
    want = _in_process(pk.build_ivf_flat)
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        _feed(c, "hv")
        info = c.finalize_knn("hv", register_as="hv-idx", mode="ivf", nlist=NLIST, nprobe=3,
                              seed=SEED, return_centroids=True) if build == "auto" else \
            _finalize(c, "hv", "hv-idx", build)
        index = d._lookup_model("hv-idx").model.index
        assert isinstance(index.lists, np.ndarray)
        got = c.kneighbors("hv-idx", Q, k=4)
    if build == "auto":
        assert int(info["sharded"][0]) == 0
        np.testing.assert_array_equal(info["centroids"], index.centroids.astype(np.float32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], _in_process(pk.build_ivf_flat_device)[1])


def test_daemon_info_of_a_device_build():
    """``maxlen`` and ``return_centroids`` read the device index."""
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        _feed(c, "inf")
        info = c.finalize_knn("inf", register_as="inf-idx", mode="ivf", nlist=NLIST, nprobe=3,
                              seed=SEED, return_centroids=True)
        index = d._lookup_model("inf-idx").model.index
    assert isinstance(index.centroids, torch.Tensor)
    assert int(info["maxlen"][0]) == index.lists.shape[1]
    assert info["centroids"].dtype == np.float32
    np.testing.assert_array_equal(info["centroids"], index.centroids.float().numpy())


def test_an_unknown_build_is_refused_before_the_build():
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        _feed(c, "uk")
        with pytest.raises(RuntimeError, match=r"unknown build 'gpu' \(auto\|device\|host\)"):
            _finalize(c, "uk", "uk-idx", "gpu")
        assert c.status("uk")["rows"] == X.shape[0]
        assert not c.model_exists("uk-idx")


def test_a_snapshot_of_a_device_built_index_restores_bitwise(tmp_path):
    """A durable daemon copies the device index to the host for its
    snapshot; the lazy restore gives host arrays that answer bitwise as
    the device index did."""
    sd = str(tmp_path / "state")
    with DataPlaneDaemon(device="cpu", state_dir=sd) as d, DataPlaneClient(*d.address) as c:
        _feed(c, "sn")
        _finalize(c, "sn", "sn-idx", "device")
        assert isinstance(d._lookup_model("sn-idx").model.index.lists, torch.Tensor)
        before = c.kneighbors("sn-idx", Q, k=4)
    with DataPlaneDaemon(device="cpu", state_dir=sd) as d2, DataPlaneClient(*d2.address) as c:
        after = c.kneighbors("sn-idx", Q, k=4)
        assert isinstance(d2._lookup_model("sn-idx").model.index.lists, np.ndarray)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])


def test_each_package_reads_its_own_cap_env_var():
    """Both names set to different values in one process: each package
    reads its own. The default is the reference's 4 GiB."""
    assert daemon_mod._IVF_DEVICE_BUILD_MAX_BYTES == 4 << 30
    code = ("import spark_rapids_ml_tpu.serve.daemon as j, "
            "spark_rapids_ml_tpu_torch.serve.daemon as t; "
            "print(j._IVF_DEVICE_BUILD_MAX_BYTES, t._IVF_DEVICE_BUILD_MAX_BYTES)")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "SRML_IVF_DEVICE_BUILD_MAX": "111", "SRML_TORCH_IVF_DEVICE_BUILD_MAX": "222"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["111", "222"]
