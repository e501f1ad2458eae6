"""The PyTorch port's KMeans slice against the JAX package, on the CPU.

Both packages get the same numpy inputs and the same seed, so their
initial centres are the same (host numpy init, copied) and the fits
follow the same path. The parity runs are in float64 (the JAX conftest's
x64 profile; the port gets compute_dtype = accum_dtype = float64):
centres and cost to 1e-8 relative, the same iteration count. A float32 run
holds the port's kernel route (``lloyd_step`` / ``assign_min_dist``; their
plain versions on the CPU) against the same reference.
"""

import os

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import KMeans as JaxKMeans
from spark_rapids_ml_tpu import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.models import kmeans as jax_km
from spark_rapids_ml_tpu.ops.distances import sq_euclidean as jax_sq_euclidean
from spark_rapids_ml_tpu_torch import KMeans, KMeansModel, config
from spark_rapids_ml_tpu_torch.convert import kmeans_model_from_jax
from spark_rapids_ml_tpu_torch.models import kmeans as port_km
from spark_rapids_ml_tpu_torch.ops.distances import sq_euclidean
from spark_rapids_ml_tpu_torch.ops import kernels
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

RTOL = 1e-8


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


@pytest.fixture
def f64():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield


@pytest.fixture
def blobs():
    """Five gaussian blobs of unequal sizes in 8-d, 803 rows (ragged: the
    JAX fit pads them over 8 devices)."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(5, 8)) * 6.0
    sizes = (300, 200, 150, 100, 53)
    pts = np.concatenate([c + rng.normal(size=(s, 8)) for c, s in zip(centers, sizes)])
    return pts[rng.permutation(len(pts))]


def _assert_same_fit(out, ref, rtol=RTOL):
    np.testing.assert_allclose(out.centers, ref.centers, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=rtol)
    assert out.n_iter == ref.n_iter
    assert out.n_rows == ref.n_rows


@pytest.mark.parametrize("init", ["k-means++", "random"])
@pytest.mark.parametrize("k", [3, 5, 9])
def test_fit_kmeans_matches_jax(blobs, mesh8, f64, init, k):
    ref = jax_km.fit_kmeans(blobs, k, max_iter=30, seed=4, init=init, mesh=mesh8)
    out = port_km.fit_kmeans(blobs, k, max_iter=30, seed=4, init=init, device="cpu")
    _assert_same_fit(out, ref)


def test_init_sample_draws_match_above_the_sample_size(mesh8, f64):
    """Over 65,536 rows k-means++ seeds on a drawn sample: the port draws
    its indices with the same generator call, so the fits still agree."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(70_001, 3)) + rng.integers(0, 4, size=(70_001, 1)) * 5.0
    ref = jax_km.fit_kmeans(x, 4, max_iter=5, seed=9, mesh=mesh8)
    out = port_km.fit_kmeans(x, 4, max_iter=5, seed=9, device="cpu")
    _assert_same_fit(out, ref)


def test_tensor_input_gathers_the_same_init_rows(blobs, f64):
    """x handed over as a tensor (as when it already lies on the card): the
    sampled rows are gathered from it, and the fit equals the numpy one."""
    a = port_km.fit_kmeans(blobs, 5, seed=2, device="cpu")
    b = port_km.fit_kmeans(torch.from_numpy(blobs), 5, seed=2, device="cpu")
    _assert_same_fit(a, b, rtol=0)


def test_float32_kernel_route_matches_jax(blobs, mesh8):
    """Default dtypes on the CPU (float32): each iteration goes through the
    ``lloyd_step`` wrapper and the cost through ``assign_min_dist`` (their
    plain versions here, which launch nothing)."""
    ref = jax_km.fit_kmeans(blobs, 5, max_iter=30, seed=4, mesh=mesh8)
    before = dict(kernels.LAUNCHES)
    out = port_km.fit_kmeans(blobs, 5, max_iter=30, seed=4, device="cpu")
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(out.centers, ref.centers, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-5)
    assert out.n_iter == ref.n_iter


def test_empty_cluster_keeps_its_center(mesh8, f64):
    """k = 3 over two distinct points: one cluster stays empty and keeps
    its centre (tests/test_kmeans.py:107), as in the JAX fit."""
    pts = np.array([[0.0, 0.0], [10.0, 10.0]] * 50)
    ref = jax_km.fit_kmeans(pts, 3, max_iter=5, init="random", seed=0, mesh=mesh8)
    out = port_km.fit_kmeans(pts, 3, max_iter=5, init="random", seed=0, device="cpu")
    _assert_same_fit(out, ref)
    assert np.all(np.isfinite(out.centers))


@pytest.mark.parametrize("kwargs", [dict(k=0), dict(k=11), dict(k=3, init="bogus")])
def test_bad_k_or_init_raises(kwargs):
    pts = np.random.default_rng(0).normal(size=(10, 3))
    with pytest.raises(ValueError):
        port_km.fit_kmeans(pts, device="cpu", **kwargs)


def _source(pts, rows=200):
    def source():
        for i in range(0, len(pts), rows):
            yield pts[i:i + rows]
    return source


def test_fit_kmeans_stream_matches_jax(blobs, mesh8, f64):
    kw = dict(k=5, n_cols=8, max_iter=30, seed=1, init_sample_rows=len(blobs))
    # The JAX stream takes batches that divide over its 8 devices.
    pts = blobs[:800]
    ref = jax_km.fit_kmeans_stream(_source(pts), mesh=mesh8, **kw)
    out = port_km.fit_kmeans_stream(_source(pts), device="cpu", **kw)
    _assert_same_fit(out, ref)


def test_fit_kmeans_stream_resumes_from_a_checkpoint(blobs, mesh8, f64, tmp_path):
    """A stream that fails in its 4th scan leaves its checkpoint; the
    resumed fit (with another seed, ignored on resume) ends where the
    uninterrupted one does, and removes the file."""
    pts = blobs[:800]
    kw = dict(k=9, n_cols=8, max_iter=20, tol=0.0, init_sample_rows=len(pts))
    ck = str(tmp_path / "km.ckpt")
    full = port_km.fit_kmeans_stream(_source(pts), seed=1, device="cpu", **kw)
    ref = jax_km.fit_kmeans_stream(_source(pts), seed=1, mesh=mesh8, **kw)
    _assert_same_fit(full, ref)
    assert full.n_iter > 3  # the failure below comes mid-fit

    class Stop(Exception):
        pass

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 4:
            raise Stop()
        return _source(pts)()

    with pytest.raises(Stop):
        port_km.fit_kmeans_stream(flaky, seed=1, checkpoint_path=ck, device="cpu", **kw)
    assert os.path.exists(ck)
    resumed = port_km.fit_kmeans_stream(_source(pts), seed=999, checkpoint_path=ck,
                                        device="cpu", **kw)
    assert not os.path.exists(ck)
    _assert_same_fit(resumed, full, rtol=1e-12)


def test_stream_update_folds_a_batch_in_place(blobs, f64):
    """One batch's (sums, counts, cost) at fixed centres, folded into the
    state's own tensors, equal the in-memory statistics."""
    centers = torch.from_numpy(blobs[:4].copy())
    state = port_km.stream_zero_state(4, 8, torch.float64)
    ptrs = [t.data_ptr() for t in state]
    x = torch.from_numpy(blobs)
    port_km._stream_update(state, centers, x[:300], torch.float64, torch.float64)
    port_km._stream_update(state, centers, x[300:], torch.float64, torch.float64)
    assert [t.data_ptr() for t in state] == ptrs
    sums, counts = port_km._lloyd_stats(x, centers, torch.float64, torch.float64, kernel=False)
    np.testing.assert_allclose(state[0].numpy(), sums.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(state[1].numpy(), counts.numpy())
    assert float(state[1].sum()) == len(blobs)


def test_model_predict_from_a_jax_model(blobs, mesh8, f64):
    ref = JaxKMeans(mesh=mesh8).setK(5).setSeed(3).fit({"features": blobs})
    model = kmeans_model_from_jax(ref._model_data(), device="cpu")
    pred = model.predict(blobs)
    assert pred.dtype == np.int32
    np.testing.assert_array_equal(pred, ref.predict(blobs))
    np.testing.assert_array_equal(model.transform_matrix(blobs)["prediction"],
                                  ref.transform_matrix(blobs)["prediction"])
    t = model.predict(torch.from_numpy(blobs))
    assert isinstance(t, torch.Tensor) and (t.numpy() == pred).all()


def test_predict_ties_go_to_the_lowest_index(f64):
    centers = np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 0.0], [-1.0, 0.0]])
    x = np.array([[0.0, 0.0], [0.0, 3.0], [0.9, 0.0]])
    np.testing.assert_array_equal(KMeansModel(centers, device="cpu").predict(x), [1, 1, 0])


def test_save_load_across_packages(blobs, mesh8, tmp_path, f64):
    port = KMeans(device="cpu").setK(5).setSeed(3).setMaxIter(7).fit({"features": blobs})
    port.save(str(tmp_path / "port"))
    back_jax = JaxKMeansModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(back_jax.centers, port.centers, rtol=1e-12)
    assert back_jax.getK() == 5 and back_jax.getMaxIter() == 7
    back_jax.save(str(tmp_path / "jax"))
    back = KMeansModel.load(str(tmp_path / "jax"))
    np.testing.assert_allclose(back.centers, port.centers, rtol=1e-12)
    assert back.getK() == 5 and back.getMaxIter() == 7 and back.uid == port.uid


def test_estimator_summary_matches_jax(blobs, mesh8, f64):
    ds = {"features": blobs}
    model = KMeans(device="cpu").setK(5).setSeed(3).fit(ds)
    ref = JaxKMeans(mesh=mesh8).setK(5).setSeed(3).fit(ds)
    np.testing.assert_allclose(model.clusterCenters(), ref.clusterCenters(), rtol=RTOL)
    np.testing.assert_allclose(model.trainingCost, ref.trainingCost, rtol=RTOL)
    assert model.summary.numIter == ref.summary.numIter and model.summary.k == 5
    assert model.summary.n_rows == len(blobs) and model.hasSummary
    out = model.transform(ds)
    np.testing.assert_array_equal(out["prediction"], ref.transform(ds)["prediction"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sq_euclidean_matches_jax(dtype):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(37, 9)).astype(dtype)
    y = np.concatenate([x[:3], rng.normal(size=(5, 9))]).astype(dtype)  # zero distances
    ref = np.asarray(jax_sq_euclidean(x, y, accum_dtype=dtype))
    out = sq_euclidean(torch.from_numpy(x), torch.from_numpy(y), accum_dtype=getattr(torch, dtype))
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == "float64" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, **tol)
    assert (out >= 0).all()  # clipped at 0 where rounding crosses it
