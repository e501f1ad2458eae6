"""The PyTorch port's PCA slice against the JAX package, on the CPU.

Both packages get the same numpy inputs. The parity runs are in float64
(the JAX conftest's x64 profile; the port gets compute_dtype = accum_dtype
= float64) at PCASuite's absolute tolerance 1e-5 on sign-invariant
components (PCASuite.scala:80-87). A float32 run holds the port's kernel
route (the wrappers' plain versions on the CPU) against the same
reference at float32 tolerance.
"""

import os

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu.ops import eigh as jax_eigh
from spark_rapids_ml_tpu.ops import gram as jax_gram
from spark_rapids_ml_tpu_torch import PCA, PCAModel, config
from spark_rapids_ml_tpu_torch.convert import pca_model_from_jax, stats_from_jax
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.ops import eigh as port_eigh
from spark_rapids_ml_tpu_torch.ops import gram as port_gram
from spark_rapids_ml_tpu_torch.ops import kernels
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

ABS_TOL = 1e-5  # PCASuite.scala:87


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


@pytest.fixture
def f64():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield


@pytest.fixture
def data():
    """Anisotropic data with well-separated directions and a ragged row
    count (501 rows: the JAX fit pads it over 8 devices)."""
    rng = np.random.default_rng(7)
    n, d = 501, 64
    basis = rng.normal(size=(d, d))
    return rng.normal(size=(n, d)) @ (basis * np.logspace(0, -2, d)) + rng.normal(size=d)


def _assert_same_fit(a, b, atol=ABS_TOL, spectrum=True):
    np.testing.assert_allclose(np.abs(a.pc), np.abs(b.pc), atol=atol)
    np.testing.assert_allclose(a.explained_variance, b.explained_variance, atol=atol)
    np.testing.assert_allclose(a.mean, b.mean, atol=atol)
    if spectrum:
        np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-7, atol=1e-7)
    assert a.n_rows == b.n_rows


@pytest.mark.parametrize("mean_center", [True, False])
@pytest.mark.parametrize("solver", ["full", "randomized"])
def test_fit_pca_matches_jax(data, mesh8, f64, solver, mean_center):
    k = 5
    ref = jax_pca.fit_pca(data, k, mean_center=mean_center, mesh=mesh8)  # exact
    out = port_pca.fit_pca(data, k, mean_center=mean_center, solver=solver, device="cpu")
    if solver == "full":
        _assert_same_fit(out, ref)
        return
    # Randomized: components, mean and top-k σ are held to the exact fit.
    # Its explained variance divides by an ESTIMATED Σσ (the trace spread
    # over the d − k − p values it never resolves), which depends on the
    # random start block; the two packages draw different blocks, so it is
    # held to the JAX randomized fit.
    np.testing.assert_allclose(np.abs(out.pc), np.abs(ref.pc), atol=ABS_TOL)
    np.testing.assert_allclose(out.mean, ref.mean, atol=ABS_TOL)
    np.testing.assert_allclose(out.sigma[:k], ref.sigma[:k], rtol=1e-7)
    jr = jax_pca.fit_pca(data, k, mean_center=mean_center, mesh=mesh8, solver="randomized")
    np.testing.assert_allclose(out.explained_variance, jr.explained_variance, atol=ABS_TOL)


def test_fit_pca_float32_kernel_route(data, mesh8, monkeypatch):
    """Default dtypes on the CPU (float32 compute and accumulators): the
    Gram goes through the ``gram`` wrapper (its plain version on the CPU)
    with no mask, since one device pads nothing, and the fit stays within
    float32 tolerance of the float64 reference."""
    calls = []
    real = kernels.gram

    def spy(x, mask=None):
        calls.append((x.dtype, mask))
        return real(x, mask)

    monkeypatch.setattr(kernels, "gram", spy)
    out = port_pca.fit_pca(data.astype(np.float32), 5, device="cpu")
    assert calls == [(torch.float32, None)]
    ref = jax_pca.fit_pca(data, 5, mesh=mesh8)
    _assert_same_fit(out, ref, atol=1e-3, spectrum=False)


def test_bf16_compute_routes_through_the_kernels(monkeypatch):
    """bfloat16 compute with float32 state: the in-memory Gram is the
    masked ``gram`` kernel and each streamed batch ONE seeded
    ``gram_colsum`` launch folding into the caller's state in place."""
    seen = []
    real_g, real_gc = kernels.gram, kernels.gram_colsum
    monkeypatch.setattr(kernels, "gram", lambda x, m: seen.append(("gram", x.dtype)) or real_g(x, m))

    def gc(x, n_valid, state=None):
        seen.append(("gram_colsum", x.dtype, n_valid, state is not None))
        return real_gc(x, n_valid, state)

    monkeypatch.setattr(kernels, "gram_colsum", gc)
    x = np.random.default_rng(3).normal(size=(300, 16)).astype(np.float32)
    with config.option("compute_dtype", "bfloat16"):
        port_pca.fit_pca(x, 2, device="cpu")
        port_pca.fit_pca_stream([x[:200], x[200:]], 2, 16, device="cpu")
    assert seen == [
        ("gram", torch.bfloat16),
        ("gram_colsum", torch.bfloat16, 200, True),
        ("gram_colsum", torch.bfloat16, 100, True),
    ]


def test_fit_pca_stream_matches_jax(data, mesh8, f64):
    batches = [data[:100], data[100:117], data[117:400], data[400:]]
    ref = jax_pca.fit_pca_stream(batches, 4, data.shape[1], mesh=mesh8)
    out = port_pca.fit_pca_stream(batches, 4, data.shape[1], device="cpu")
    _assert_same_fit(out, ref)


def _interrupted(batches, after):
    for i, b in enumerate(batches):
        if i == after:
            raise KeyboardInterrupt("preempted")
        yield b


@pytest.mark.parametrize("first", ["port", "jax"])
def test_fit_pca_stream_resumes_from_checkpoint(data, mesh8, f64, tmp_path, first):
    """A stream cut after 3 batches (checkpoint every 2) resumes in the
    port — from its own checkpoint or from the JAX package's (the same
    npz layout) — and ends equal to the uninterrupted JAX fit."""
    batches = [data[i:i + 60] for i in range(0, data.shape[0], 60)]
    path = str(tmp_path / "pca.ckpt.npz")
    with pytest.raises(KeyboardInterrupt):
        if first == "port":
            port_pca.fit_pca_stream(_interrupted(batches, 3), 4, data.shape[1],
                                    checkpoint_path=path, checkpoint_every=2, device="cpu")
        else:
            jax_pca.fit_pca_stream(_interrupted(batches, 3), 4, data.shape[1], mesh=mesh8,
                                   checkpoint_path=path, checkpoint_every=2)
    assert os.path.exists(path)
    out = port_pca.fit_pca_stream(batches, 4, data.shape[1], checkpoint_path=path,
                                  checkpoint_every=2, device="cpu")
    assert not os.path.exists(path)  # consumed on success
    ref = jax_pca.fit_pca_stream(batches, 4, data.shape[1], mesh=mesh8)
    _assert_same_fit(out, ref)


@pytest.mark.parametrize("mean_center", [True, False])
def test_finalize_pca_stats_on_a_jax_state(data, mesh8, f64, mean_center):
    count, colsum, gram = (np.asarray(a) for a in jax_gram.local_stats(data))
    ref = jax_pca.finalize_pca_stats((count, colsum, gram), 3, mean_center, mesh8, len(data))
    state = stats_from_jax((count, colsum, gram), device="cpu")
    assert [t.dtype for t in state] == [torch.float64] * 3
    out = port_pca.finalize_pca_stats(state, 3, mean_center, len(data))
    _assert_same_fit(out, ref)


def test_local_stats_match_jax(data, f64):
    mask = (np.random.default_rng(4).random(len(data)) < 0.8).astype(np.float64)
    ref = jax_gram.local_stats(data, mask)
    out = port_gram.local_stats(torch.from_numpy(data), torch.from_numpy(mask))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-9)


def test_masked_streaming_update_matches_jax(data, mesh1, f64):
    """The masked fold (``streaming_update``) over two batches, each with
    padding rows masked out, equals the JAX package's."""
    rng = np.random.default_rng(6)
    batches = [(data[:250], rng.random(250) < 0.9), (data[250:], rng.random(251) < 0.9)]
    update = jax_gram.streaming_update(mesh1)
    ref = jax_gram.init_stats(data.shape[1])
    state = port_gram.init_stats(data.shape[1])
    for x, m in batches:
        ref = update(ref, x, m.astype(np.float64))
        out = port_gram.streaming_update(state, torch.from_numpy(x), torch.from_numpy(m.astype(np.float64)))
        assert out is state  # folded in place
    for a, b in zip(state, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n", [0, 1, 7, 256, 300])
def test_pad_and_bucket_rows_match_jax(n):
    from spark_rapids_ml_tpu.parallel import sharding as jax_sharding
    from spark_rapids_ml_tpu_torch.parallel import sharding as port_sharding

    x = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    for a, b in zip(port_sharding.pad_rows(x, 8), jax_sharding.pad_rows(x, 8)):
        np.testing.assert_array_equal(a, b)
    assert port_sharding.bucket_rows(n) == jax_sharding.bucket_rows(n)


def test_transform_of_a_carried_model_matches_jax(data, mesh8, f64):
    jm = JaxPCA(mesh=mesh8).setK(4).fit({"features": data})
    pm = pca_model_from_jax(jm._model_data(), device="cpu")
    np.testing.assert_allclose(pm.explainedVariance, jm.explainedVariance)
    y_ref = jm.transform_matrix(data)["output"]
    y = pm.transform_matrix(data)["output"]
    assert isinstance(y, np.ndarray) and y.dtype == np.float64
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-10)
    yt = pm.transform_matrix(torch.from_numpy(data))["output"]  # tensor in, tensor out
    np.testing.assert_allclose(yt.numpy(), y_ref, rtol=1e-12, atol=1e-10)


def test_transform_float32_accumulates_rounded_operands(data, mesh8):
    """bf16 compute: both operands rounded to bf16, the product summed in
    float32 (the JAX package's preferred_element_type=accum), not a bf16
    result."""
    rng = np.random.default_rng(5)
    pc = np.linalg.qr(rng.normal(size=(data.shape[1], 3)))[0]
    m = PCAModel(pc=pc, device="cpu")
    with config.option("compute_dtype", "bfloat16"):
        y = m.transform_matrix(data)["output"]
    xb = torch.from_numpy(data).to(torch.bfloat16).double()
    pb = torch.from_numpy(pc).to(torch.bfloat16).double()
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, (xb @ pb).numpy(), rtol=1e-5, atol=1e-5)


def test_port_save_loads_in_jax_and_back(data, mesh8, f64, tmp_path):
    model = PCA(device="cpu").setK(3).setOutputCol("proj").fit({"features": data})
    model.save(str(tmp_path / "port"))
    jm = JaxPCAModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(jm.pc, model.pc, atol=1e-12)
    np.testing.assert_allclose(jm.mean, model.mean, atol=1e-12)
    assert jm.getOutputCol() == "proj" and jm.getK() == 3
    jm.save(str(tmp_path / "jax"))
    back = PCAModel.load(str(tmp_path / "jax"))
    np.testing.assert_allclose(back.pc, model.pc, atol=1e-12)
    assert isinstance(back, PCAModel) and back.uid == model.uid


def test_sign_flip_first_max_wins():
    u = np.array([
        [-2.0, 1.0, 0.0, 3.0],
        [2.0, -1.0, 0.0, -3.0],
        [1.0, 0.5, 0.0, 0.0],
    ])
    ref = np.asarray(jax_eigh.sign_flip(u))
    out = port_eigh.sign_flip(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(out, ref)
    # Ties: the FIRST maximum decides; an all-zero column stays.
    np.testing.assert_array_equal(out[:, 0], [2.0, -2.0, -1.0])
    np.testing.assert_array_equal(out[:, 1], [1.0, -1.0, 0.5])
    np.testing.assert_array_equal(out[:, 2], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(out[:, 3], [3.0, -3.0, 0.0])


def test_pca_from_gram_matches_jax(data):
    g = data.T @ data
    for a, b in zip(port_eigh.pca_from_gram(torch.from_numpy(g), 6), jax_eigh.pca_from_gram(g, 6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)
    for a, b in zip(port_eigh.pca_from_gram_host(g, 6), jax_eigh.pca_from_gram_host(g, 6)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_host_finalize_matches_device(data, f64):
    a = port_pca.fit_pca(data, 4, device="cpu")
    with config.option("finalize", "host"):
        b = port_pca.fit_pca(data, 4, device="cpu")
    _assert_same_fit(a, b, atol=1e-10)


@pytest.mark.parametrize("k", [0, 65])
def test_k_out_of_range(data, k):
    with pytest.raises(ValueError, match="out of range"):
        port_pca.fit_pca(data, k, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        port_pca.fit_pca_stream([data], k, data.shape[1], device="cpu")
    state = port_gram.init_stats(data.shape[1])
    with pytest.raises(ValueError, match="out of range"):
        port_pca.finalize_pca_stats(state, k, True, 0)
    with pytest.raises(ValueError):
        PCA(device="cpu").setK(k).fit({"features": data})


def test_solver_and_finalize_validation(data):
    with pytest.raises(ValueError, match="solver"):
        port_pca.fit_pca(data, 2, solver="bogus", device="cpu")
    with config.option("finalize", "nowhere"), pytest.raises(ValueError, match="finalize"):
        port_pca.fit_pca(data, 2, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        port_pca.fit_pca_stream([data[:, :5]], 2, data.shape[1], device="cpu")
