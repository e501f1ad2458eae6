"""The PyTorch port's Gram kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their kernels' plain versions; those
are held here against ``gram_colsum_pallas`` / ``gram_pallas`` run in
interpret mode, on the same numpy inputs (as tests/test_pallas.py runs
them). The CUDA kernels themselves are held against the plain versions on
the card, by ``chip_smoke.py`` and by the ``cuda``-marked test of
tests/test_torch_package.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_kernels import gram_colsum_pallas, gram_pallas
from spark_rapids_ml_tpu_torch.ops import _build, kernels
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


N, D = 1024, 256
# f32: the kernels' tolerance in tests/test_pallas.py. bf16-rounded input:
# products are exact in f32 in both, but the f32 sums run in another order.
TOL = {"float32": dict(rtol=1e-5, atol=1e-2), "bfloat16": dict(rtol=1e-3, atol=1e-2)}


def _inputs(seed, dtype):
    x = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(xt.float().numpy(), dtype=dtype), xt


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("n_valid", [N, 700, 300])
def test_gram_colsum_matches_pallas(impl, dtype, seeded, n_valid):
    xj, xt = _inputs(11, dtype)
    rng = np.random.default_rng(12)
    g0 = rng.normal(size=(D, D)).astype(np.float32)
    cs0 = rng.normal(size=(D,)).astype(np.float32)
    state_j = (jnp.asarray(g0), jnp.asarray(cs0), jnp.asarray(37.0, jnp.float32))
    state_t = (torch.from_numpy(g0.copy()), torch.from_numpy(cs0.copy()),
               torch.tensor(37.0)) if seeded else None
    g, cs, c = gram_colsum_pallas(
        xj, n_valid, block_n=256, state=state_j if seeded else None, interpret=True
    )
    fn = kernels.gram_colsum if impl == "wrapper" else kernels.gram_colsum_plain
    before = dict(kernels.LAUNCHES)
    gt, cst, ct = fn(xt, n_valid, state_t)
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    if seeded:  # folded in place into the caller's state
        assert gt.data_ptr() == state_t[0].data_ptr()
        assert cst.data_ptr() == state_t[1].data_ptr()
    assert gt.dtype == cst.dtype == ct.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(g), **TOL[dtype])
    np.testing.assert_allclose(cst.numpy(), np.asarray(cs), **TOL[dtype])
    assert float(ct) == float(c) == (37.0 if seeded else 0.0) + n_valid


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matches_pallas(impl, dtype):
    xj, xt = _inputs(13, dtype)
    mask = (np.random.default_rng(14).random(N) < 0.7).astype(np.float32)
    ref = gram_pallas(xj, jnp.asarray(mask, dtype), block_n=256, block_d=128, interpret=True)
    fn = kernels.gram if impl == "wrapper" else kernels.gram_plain
    out = fn(xt, torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (D, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL[dtype])


def test_gram_colsum_n_valid_clamps():
    """n_valid past either end: all rows, or none (the kernel's clamp)."""
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(64, 8)).astype(np.float32))
    g_all, _, c_all = kernels.gram_colsum(x, 10_000)
    np.testing.assert_allclose(g_all.numpy(), (x.T @ x).numpy(), rtol=1e-5, atol=1e-4)
    assert float(c_all) == 64.0
    g0, cs0, c0 = kernels.gram_colsum(x, -5)
    assert float(c0) == 0.0 and not g0.any() and not cs0.any()


def test_ragged_shapes_need_no_padding():
    """Any n and d: the Pallas demands (n % block_n, d % 128) are tiling
    artefacts the port does not carry over."""
    x = torch.from_numpy(np.random.default_rng(16).normal(size=(37, 13)).astype(np.float32))
    mask = torch.ones(37)
    mask[-5:] = 0
    xm = x * mask[:, None]
    np.testing.assert_allclose(kernels.gram(x, mask).numpy(), (xm.T @ xm).numpy(),
                               rtol=1e-5, atol=1e-4)
    # No mask: every row, with weight one.
    np.testing.assert_allclose(kernels.gram(x).numpy(), (x.T @ x).numpy(), rtol=1e-5, atol=1e-4)
    g, cs, c = kernels.gram_colsum(x, 32)
    np.testing.assert_allclose(g.numpy(), (x[:32].T @ x[:32]).numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cs.numpy(), x[:32].sum(0).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad, err", [
    (lambda x: (x.double(), torch.ones(8)), TypeError),          # dtype
    (lambda x: (x[0], torch.ones(8)), ValueError),                # not a matrix
    (lambda x: (x, torch.ones(7)), ValueError),                   # mask length
    (lambda x: (x, torch.ones(8, dtype=torch.float64)), TypeError),  # mask dtype
])
def test_gram_wrapper_rejects_bad_inputs(bad, err):
    x = torch.ones((8, 4))
    with pytest.raises(err):
        kernels.gram(*bad(x))


@pytest.mark.parametrize("state, err", [
    (lambda d: (torch.zeros((d, d), dtype=torch.float64), torch.zeros(d), torch.zeros(())), TypeError),
    (lambda d: (torch.zeros((d, d + 1)), torch.zeros(d), torch.zeros(())), ValueError),
    (lambda d: (torch.zeros((d, d)), torch.zeros(d), torch.zeros(1)), ValueError),
    (lambda d: (torch.zeros((d, 2 * d))[:, ::2], torch.zeros(d), torch.zeros(())), ValueError),
])
def test_gram_colsum_wrapper_checks_state(state, err):
    x = torch.ones((8, 4))
    with pytest.raises(err):
        kernels.gram_colsum(x, 8, state(4))


def test_kernel_source_exports_the_bound_symbols():
    """The C symbols and argument counts the ctypes binding declares exist
    in the CUDA source (the source compiles only on the card)."""
    src = (_build.CSRC / "gram.cu").read_text()
    for name, n_args in (("srml_gram", 7), ("srml_gram_colsum", 9)):
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == n_args, name
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_build_paths_and_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("SRML_TORCH_BUILD_DIR", str(tmp_path))
    path = _build.library_path("gram")
    assert path.parent == tmp_path and re.fullmatch(r"gram-[0-9a-f]{16}\.so", path.name)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("gram")
    assert list(tmp_path.iterdir()) == []
