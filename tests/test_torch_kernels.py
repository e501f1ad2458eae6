"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their kernels' plain versions; those
are held here against ``gram_colsum_pallas``, ``gram_pallas``,
``linreg_stats_pallas``, ``lloyd_step_pallas``, ``assign_min_dist_pallas``,
``newton_stats_pallas``, ``softmax_curvature_pallas``, ``dist_topk_pallas``,
``probe_select_pallas`` and ``ivf_scan_select_pallas`` run in interpret
mode, on the same numpy inputs (as tests/test_pallas.py runs them), and
against float64 numpy oracles. The CUDA kernels themselves are held
against the plain versions on the card, by ``chip_smoke.py`` and by the
``cuda``-marked test of tests/test_torch_package.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import pallas_kernels as pk
from spark_rapids_ml_tpu.ops.pallas_kernels import (
    assign_min_dist_pallas,
    dist_topk_pallas,
    gram_colsum_pallas,
    gram_pallas,
    linreg_stats_pallas,
    lloyd_step_pallas,
    ivf_scan_select_pallas,
    newton_stats_pallas,
    probe_select_pallas,
    softmax_curvature_pallas,
)
from spark_rapids_ml_tpu_torch.ops import _build, kernels
from spark_rapids_ml_tpu_torch.ops import selection as sel
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
    for name, n_args in (("srml_gram", 11), ("srml_gram_colsum", 13)):
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == n_args, name
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("source, name, n_args", [
    ("gram", "srml_linreg_stats", 17),
    ("kmeans", "srml_lloyd_step", 11),
    ("kmeans", "srml_assign_min_dist", 10),
    ("gram", "srml_newton_stats", 20),
    ("gram", "srml_softmax_curvature", 13),
    ("gram", "srml_gram_colsum_tc", 13),
    ("gram", "srml_linreg_stats_tc", 17),
    ("gram", "srml_newton_stats_tc", 20),
    ("gram", "srml_softmax_curvature_tc", 13),
    ("kmeans", "srml_lloyd_step_tc", 12),
    ("kmeans", "srml_assign_min_dist_tc", 12),
    ("kmeans", "srml_lloyd_sums", 12),
    ("kmeans", "srml_kmeans_tc_smem", 6),
    ("gram", "srml_gram", 11),
    ("gram", "srml_gram_colsum", 13),
    ("gram", "srml_gram_tc", 10),
    ("knn", "srml_ivf_scan_select", 15),
    ("knn", "srml_ivf_scan_select_tc", 14),
    ("knn", "srml_ivf_scan_tc_smem", 2),
])
def test_new_kernel_sources_export_the_bound_symbols(source, name, n_args):
    """As above, for the LinearRegression and KMeans kernels; the count
    also matches the ctypes binding's argument list."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf"int {name}\(([^)]*)\)", src)
    assert m, name
    assert len(m.group(1).split(",")) == n_args, name
    binding = (_build.CSRC.parent / "kernels.py").read_text()
    m = re.search(rf"lib\.{name}\.argtypes = \[([^\]]*)\]", binding)
    assert m and len(m.group(1).split(",")) == n_args, name


def test_build_paths_and_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("SRML_TORCH_BUILD_DIR", str(tmp_path))
    path = _build.library_path("gram")
    assert path.parent == tmp_path and re.fullmatch(r"gram-[0-9a-f]{16}\.so", path.name)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("gram")
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# linreg_stats vs linreg_stats_pallas (tests/test_pallas.py:473-491)
# ---------------------------------------------------------------------------


def _linreg_inputs(dtype):
    rng = np.random.default_rng(21)
    xj, xt = _inputs(22, dtype)
    y = rng.normal(size=(N,)).astype(np.float32)
    mask = np.ones((N,), np.float32)
    mask[-100:] = 0.0
    return xj, xt, y, mask


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linreg_stats_matches_pallas(impl, dtype):
    xj, xt, y, mask = _linreg_inputs(dtype)
    ref = linreg_stats_pallas(xj, y, mask, block_n=256, interpret=True)
    fn = kernels.linreg_stats if impl == "wrapper" else kernels.linreg_stats_plain
    before = dict(kernels.LAUNCHES)
    out = fn(xt, torch.from_numpy(y), torch.from_numpy(mask))
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert all(t.dtype == torch.float32 for t in out)
    for a, b in zip(out[:5], ref[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-2)
    assert float(out[5]) == float(ref[5]) == N - 100  # exact count


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
def test_linreg_stats_seeded_folds_in_place(impl):
    xj, xt, y, mask = _linreg_inputs("float32")
    rng = np.random.default_rng(23)
    seed = [rng.normal(size=s).astype(np.float32) for s in ((D, D), (D,), (D,), (), ())]
    state = [torch.from_numpy(np.array(a)) for a in seed] + [torch.tensor(37.0)]
    fn = kernels.linreg_stats if impl == "wrapper" else kernels.linreg_stats_plain
    out = fn(xt, torch.from_numpy(y), torch.from_numpy(mask), state)
    assert all(o.data_ptr() == s.data_ptr() for o, s in zip(out, state))
    ref = linreg_stats_pallas(xj, y, mask, block_n=256, interpret=True)
    for a, b, s0 in zip(out[:5], ref[:5], seed):
        np.testing.assert_allclose(a.numpy(), np.asarray(b) + s0, rtol=1e-5, atol=1e-2)
    assert float(out[5]) == 37.0 + N - 100


def test_linreg_stats_no_mask_counts_every_row():
    x = torch.from_numpy(np.random.default_rng(24).normal(size=(37, 13)).astype(np.float32))
    y = torch.arange(37, dtype=torch.float32)
    xtx, xty, sx, sy, syy, n = kernels.linreg_stats(x, y)
    np.testing.assert_allclose(xty.numpy(), (x.T @ y).numpy(), rtol=1e-5, atol=1e-3)
    assert float(sy) == float(y.sum()) and float(syy) == float((y * y).sum())
    assert float(n) == 37.0


# ---------------------------------------------------------------------------
# lloyd_step / assign_min_dist vs their Pallas kernels (test_pallas.py:261-307)
# ---------------------------------------------------------------------------


def _lloyd_inputs(dtype):
    """Well-separated clusters (argmin margins >> f32 GEMM error)."""
    rng = np.random.default_rng(31)
    m, d, k = 1024, 128, 60
    centers = (rng.normal(size=(k, d)) * 10).astype(np.float32)
    lab = rng.integers(0, k, size=m)
    x = (centers[lab] + 0.01 * rng.normal(size=(m, d))).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ct = torch.from_numpy(centers).to(getattr(torch, dtype))
    return xt, ct, lab


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [1024, 700])
def test_lloyd_step_matches_pallas(impl, dtype, n_valid):
    xt, ct, lab = _lloyd_inputs(dtype)
    k, d = ct.shape
    cpad = np.zeros((128, d), np.float32)
    cpad[:k] = ct.float().numpy()
    sums_j, counts_j = lloyd_step_pallas(
        jnp.asarray(xt.float().numpy(), dtype), jnp.asarray(cpad, dtype), n_valid,
        k=k, block_n=256, interpret=True,
    )
    fn = kernels.lloyd_step if impl == "wrapper" else kernels.lloyd_step_plain
    sums, counts = fn(xt, ct, n_valid)
    assert sums.shape == (k, d) and counts.shape == (k,)  # exactly k lanes
    assert sums.dtype == counts.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j)[:k])
    np.testing.assert_array_equal(counts.numpy(), np.bincount(lab[:n_valid], minlength=k))
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j)[:k], rtol=1e-4, atol=1e-2)


def test_lloyd_step_n_valid_past_either_end():
    xt, ct, lab = _lloyd_inputs("float32")
    _, counts = kernels.lloyd_step(xt, ct, 10_000)
    assert float(counts.sum()) == 1024.0
    sums, counts = kernels.lloyd_step(xt, ct, -3)
    assert not counts.any() and not sums.any()


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assign_min_dist_matches_pallas(impl, dtype):
    rng = np.random.default_rng(41)
    m, d, k = 512, 32, 128
    xt = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(getattr(torch, dtype))
    ct = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(getattr(torch, dtype))
    idx_j, part_j = assign_min_dist_pallas(
        jnp.asarray(xt.float().numpy(), dtype), jnp.asarray(ct.float().numpy(), dtype),
        block_m=128, block_k=64, interpret=True,
    )
    fn = kernels.assign_min_dist if impl == "wrapper" else kernels.assign_min_dist_plain
    idx, part = fn(xt, ct)
    assert idx.dtype == torch.int32 and part.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(part.numpy(), np.asarray(part_j), rtol=1e-4, atol=1e-2)


def test_duplicate_centres_tie_to_the_lowest_index():
    """Equal scores go to the lowest centre index (``jnp.argmin``'s rule),
    in the port and in the Pallas kernel, across centre blocks too."""
    rng = np.random.default_rng(42)
    m, d, k = 256, 16, 128
    x = rng.normal(size=(m, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    c[70] = c[5]  # another block of 64 in the Pallas kernel
    c[6] = c[5]
    x[:40] = c[5]  # rows sitting on the duplicated centre
    idx_j, _ = assign_min_dist_pallas(x, c, block_m=128, block_k=64, interpret=True)
    idx, _ = kernels.assign_min_dist(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert (idx[:40] == 5).all()
    _, counts = kernels.lloyd_step(torch.from_numpy(x), torch.from_numpy(c), m)
    assert counts[6] == 0 and counts[70] == 0 and counts[5] >= 40


@pytest.mark.parametrize("bad, err", [
    (lambda x, c: (x, c.double()), TypeError),              # centre dtype
    (lambda x, c: (x, c[:, :3]), ValueError),               # centre width
    (lambda x, c: (x, c[:0]), ValueError),                  # k = 0
    (lambda x, c: (x, c.T.contiguous().T), ValueError),     # not contiguous
    (lambda x, c: (x.double(), c.double()), TypeError),     # x dtype
])
def test_kmeans_wrappers_reject_bad_inputs(bad, err):
    x, c = torch.ones((8, 4)), torch.ones((5, 4))
    with pytest.raises(err):
        kernels.assign_min_dist(*bad(x, c))
    with pytest.raises(err):
        kernels.lloyd_step(*bad(x, c), 8)


@pytest.mark.parametrize("bad, err", [
    (lambda x: (x, torch.ones(7)), ValueError),                       # y length
    (lambda x: (x, torch.ones(8, dtype=torch.float64)), TypeError),   # y dtype
    (lambda x: (x, torch.ones(8), torch.ones(8, dtype=torch.int32)), TypeError),  # mask
    (lambda x: (x, torch.ones(8), None, [torch.zeros(4, 4)] * 6), ValueError),     # state
])
def test_linreg_stats_wrapper_rejects_bad_inputs(bad, err):
    x = torch.ones((8, 4))
    with pytest.raises(err):
        kernels.linreg_stats(*bad(x))


# ---------------------------------------------------------------------------
# newton_stats / softmax_curvature vs their Pallas kernels
# (tests/test_pallas.py:319-378, :513-537) and float64 oracles
# ---------------------------------------------------------------------------


def _newton_inputs(dtype, n=1024, d=256, seed=51):
    """x (as the rounded values in ``dtype``), labels, a mask whose 100
    masked rows end off a 256-row block boundary, w and b."""
    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(getattr(torch, dtype))
    y = (rng.random(n) > 0.5).astype(np.float32)
    mask = np.ones((n,), np.float32)
    mask[-100:] = 0.0
    w = (rng.normal(size=(d,)) / np.sqrt(d)).astype(np.float32)
    return xt, y, mask, w, np.float32(0.3)


def _newton_oracle(x, y, mask, w, b):
    """float64 (Xᵀr, Σr, Xᵀdiag(wgt)X, Xᵀwgt, Σwgt) and the largest
    absolute sum of terms of each (the scale of an f32 sum's error)."""
    x, y, mask, w = (np.asarray(a, np.float64) for a in (x, y, mask, w))
    p = 1.0 / (1.0 + np.exp(-(x @ w + float(b))))
    r = (p - y) * mask
    wgt = np.maximum(p * (1.0 - p), 1e-10) * mask
    ax = np.abs(x)
    out = (x.T @ r, r.sum(), (x * wgt[:, None]).T @ x, x.T @ wgt, wgt.sum())
    scales = ((ax.T @ np.abs(r)).max(), np.abs(r).sum(), (ax * wgt[:, None]).T @ ax,
              ax.T @ wgt, wgt.sum())
    return out, [float(np.max(s)) for s in scales]


def _newton_call(impl, xt, y, mask, w, b):
    fn = kernels.newton_stats if impl == "wrapper" else kernels.newton_stats_plain
    m = None if mask is None else torch.from_numpy(mask)
    return fn(xt, torch.from_numpy(y), m, torch.from_numpy(w), torch.tensor(b))


# Tolerances of tests/test_pallas.py:319-378. In bf16 the Pallas kernel
# rounds w, r and wgt to bf16 before its GEMMs; the port keeps them f32.
NEWTON_TOL = {
    "float32": [dict(rtol=1e-4, atol=1e-2)] * 5,
    "bfloat16": [dict(rtol=2e-2, atol=2e-1), dict(rtol=1e-3, atol=1e-2),
                 dict(rtol=2e-2, atol=5e-1), dict(rtol=2e-2, atol=2e-1),
                 dict(rtol=1e-3, atol=1e-2)],
}


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_newton_stats_matches_pallas(impl, dtype):
    xt, y, mask, w, b = _newton_inputs(dtype)
    xj = jnp.asarray(xt.float().numpy(), dtype)
    ref = newton_stats_pallas(xj, y, mask, w, b, block_n=256, interpret=True)
    before = dict(kernels.LAUNCHES)
    out = _newton_call(impl, xt, y, mask, w, b)
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert [tuple(t.shape) for t in out] == [(256,), (), (256, 256), (256,), ()]
    assert all(t.dtype == torch.float32 for t in out)
    for a, r, tol in zip(out, ref, NEWTON_TOL[dtype]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_newton_stats_matches_float64(impl, dtype):
    """Against float64 on the same (rounded) x: f32 sums within 1e-5 of
    each output's largest absolute sum of terms."""
    xt, y, mask, w, b = _newton_inputs(dtype, seed=52)
    out = _newton_call(impl, xt, y, mask, w, b)
    ref, scales = _newton_oracle(xt.float().numpy(), y, mask, w, b)
    for a, r, sc in zip(out, ref, scales):
        assert np.abs(a.numpy() - r).max() <= 1e-5 * sc


def _softmax_inputs(n, d, c, seed, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = rng.normal(size=(n, c))
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    mask = np.ones((n,), np.float32)
    if masked:
        mask[-200:] = 0.0
    return x, (p * mask[:, None]).astype(np.float32)


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
def test_softmax_curvature_matches_pallas(impl):
    """C = 5 over class groups of 2 in the Pallas kernel; masked rows."""
    x, pm = _softmax_inputs(1024, 128, 5, seed=53)
    hw_j, hwb_j = softmax_curvature_pallas(x, pm, block_n=256, block_c=2, interpret=True)
    fn = kernels.softmax_curvature if impl == "wrapper" else kernels.softmax_curvature_plain
    before = dict(kernels.LAUNCHES)
    hw, hwb = fn(torch.from_numpy(x), torch.from_numpy(pm))
    assert kernels.LAUNCHES == before
    assert hw.shape == (5, 128, 128) and hwb.shape == (5, 128)
    assert hw.dtype == hwb.dtype == torch.float32
    np.testing.assert_allclose(hw.numpy(), np.asarray(hw_j), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(hwb.numpy(), np.asarray(hwb_j), rtol=1e-5, atol=1e-2)


def _softmax_oracle_check(hw, hwb, x, pm):
    """float64 per-class Xᵀdiag(p_c)X and Xᵀp_c; f32 sums within 1e-5 of
    the largest Σ p_c x² and Σ p_c |x| (p_c stays f32 in the port, where the
    Pallas kernel rounds it to x's dtype)."""
    x, pm = np.asarray(x, np.float64), np.asarray(pm, np.float64)
    for c in range(pm.shape[1]):
        xw = x * pm[:, c:c + 1]
        scale = float((np.abs(xw) * np.abs(x)).sum(0).max())
        assert np.abs(hw[c].numpy() - xw.T @ x).max() <= 1e-5 * max(scale, 1e-30)
        assert np.abs(hwb[c].numpy() - xw.sum(0)).max() <= 1e-5 * float(np.abs(xw).sum(0).max())


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
def test_softmax_curvature_bf16_matches_float64(impl):
    x, pm = _softmax_inputs(1024, 128, 5, seed=54)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    fn = kernels.softmax_curvature if impl == "wrapper" else kernels.softmax_curvature_plain
    hw, hwb = fn(xt, torch.from_numpy(pm))
    _softmax_oracle_check(hw, hwb, xt.float().numpy(), pm)


@pytest.mark.parametrize("n, d, c", [(37, 13, 1), (37, 13, 3), (301, 129, 3)])
def test_logreg_kernels_ragged_shapes(n, d, c):
    """Any n, d and C: the Pallas block_n / block_c / lane demands were
    tiling artefacts the port does not carry over."""
    x, pm = _softmax_inputs(n, d, c, seed=55 + n + c, masked=False)
    hw, hwb = kernels.softmax_curvature(torch.from_numpy(x), torch.from_numpy(pm))
    assert hw.shape == (c, d, d) and hwb.shape == (c, d)
    _softmax_oracle_check(hw, hwb, x, pm)
    rng = np.random.default_rng(56)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = (rng.normal(size=(d,)) / np.sqrt(d)).astype(np.float32)
    out = _newton_call("wrapper", torch.from_numpy(x), y, None, w, np.float32(-0.2))
    ref, scales = _newton_oracle(x, y, np.ones(n), w, -0.2)
    for a, r, sc in zip(out, ref, scales):
        assert np.abs(a.numpy() - r).max() <= 1e-5 * sc


@pytest.mark.parametrize("bad, err", [
    (lambda x, y, m, w, b: (x.double(), y, m, w, b), TypeError),        # x dtype
    (lambda x, y, m, w, b: (x, y[:7], m, w, b), ValueError),            # y length
    (lambda x, y, m, w, b: (x, y.double(), m, w, b), TypeError),        # y dtype
    (lambda x, y, m, w, b: (x, y, m.int(), w, b), TypeError),           # mask dtype
    (lambda x, y, m, w, b: (x, y, m, w[:3], b), ValueError),            # w length
    (lambda x, y, m, w, b: (x, y, m, w, b.reshape(1)), ValueError),     # b not a scalar
])
def test_newton_stats_wrapper_rejects_bad_inputs(bad, err):
    args = (torch.ones((8, 4)), torch.ones(8), torch.ones(8), torch.ones(4), torch.tensor(0.0))
    with pytest.raises(err):
        kernels.newton_stats(*bad(*args))


@pytest.mark.parametrize("bad, err", [
    (lambda x, p: (x, p[:7]), ValueError),                      # rows
    (lambda x, p: (x, p[:, 0]), ValueError),                    # not a matrix
    (lambda x, p: (x, p[:, :0]), ValueError),                   # C = 0
    (lambda x, p: (x, p.double()), TypeError),                  # p dtype
    (lambda x, p: (x, p.T.contiguous().T), ValueError),         # not contiguous
    (lambda x, p: (x.half(), p), TypeError),                    # x dtype
])
def test_softmax_curvature_wrapper_rejects_bad_inputs(bad, err):
    x, p = torch.ones((8, 4)), torch.full((8, 3), 1.0 / 3)
    with pytest.raises(err):
        kernels.softmax_curvature(*bad(x, p))


@pytest.mark.parametrize("binding", ["_lib", "_kmeans_lib", "_knn_lib"])
def test_kernel_bindings_raise_without_nvcc(monkeypatch, tmp_path, binding):
    """A CUDA tensor's wrapper binds its library first; without nvcc that
    raises (there is no fallback to the plain version) and builds nothing."""
    monkeypatch.setenv("SRML_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(kernels, binding).__wrapped__()
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# Nearest neighbours: dist_topk, probe_select, ivf_scan_select
# ---------------------------------------------------------------------------
# Inputs are small integers: every product and sum is exact in f32 in any
# order, so ids, positions and (floored) values must agree bitwise, ties
# included (integer distances tie often).


def _ints(rng, *shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def _both(a, dtype):
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), dtype=dtype), t


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["basic", "masked", "k_past_valid", "duplicates"])
def test_dist_topk_matches_pallas(impl, dtype, case):
    rng = np.random.default_rng(21)
    q, m, d, k = 37, 300, 24, 6
    qs, db = _ints(rng, q, d), _ints(rng, m, d)
    ids = (rng.permutation(m) + 100).astype(np.int32)
    mask = np.ones(m, np.float32)
    if case == "masked":
        mask = (rng.random(m) < 0.6).astype(np.float32)
    elif case == "k_past_valid":
        mask[:] = 0
        mask[[3, 150, 299]] = 1  # 3 valid rows < k: (+inf, −1) tail
    elif case == "duplicates":
        db[5] = db[200]
        db[30] = db[31]
        qs[:4] = db[[5, 30, 200, 31]]
    qj, qt = _both(qs, dtype)
    dj, dt = _both(db, dtype)
    ref_d, ref_i = dist_topk_pallas(qj, dj, jnp.asarray(ids), jnp.asarray(mask), k,
                                    interpret=True)
    fn = kernels.dist_topk if impl == "wrapper" else kernels.dist_topk_plain
    out_d, out_i = fn(qt, dt, torch.from_numpy(ids), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_d.numpy(), np.asarray(ref_d))
    if case == "k_past_valid":
        assert (out_i.numpy()[:, 3:] == -1).all() and np.isinf(out_d.numpy()[:, 3:]).all()


def test_dist_topk_ties_go_to_the_lowest_id():
    """Equal rows under different ids: ascending (distance, id), whatever
    the rows' positions."""
    db = np.zeros((6, 3), np.float32)
    db[:, 0] = [1, 1, 1, 2, 2, 0]
    ids = np.array([9, 4, 7, 1, 0, 5], np.int32)
    d, i = kernels.dist_topk(torch.zeros((1, 3)), torch.from_numpy(db), torch.from_numpy(ids),
                             torch.ones(6), 6)
    np.testing.assert_array_equal(i.numpy()[0], [5, 4, 7, 9, 0, 1])
    np.testing.assert_array_equal(d.numpy()[0], [0, 1, 1, 1, 4, 4])


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("nlist, q, nprobe", [(37, 64, 5), (300, 128, 300), (8, 5, 1)])
def test_probe_select_matches_pallas(impl, nlist, q, nprobe):
    rng = np.random.default_rng(22)
    cent, qs = _ints(rng, nlist, 20), _ints(rng, q, 20)
    cent[7 % nlist] = cent[0]  # duplicate centroids: ties to the lower index
    ref_p, ref_d = probe_select_pallas(jnp.asarray(cent), jnp.asarray(qs), nprobe,
                                       interpret=True)
    fn = kernels.probe_select if impl == "wrapper" else kernels.probe_select_plain
    out_p, out_d = fn(torch.from_numpy(cent), torch.from_numpy(qs), nprobe)
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(out_d.numpy(), np.asarray(ref_d))


@pytest.mark.parametrize("impl", ["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("maxlen, blk_k", [(37, 11), (64, 8), (300, 40), (9, 9)])
def test_ivf_scan_select_matches_pallas(impl, dtype, maxlen, blk_k):
    """Scores r2 − 2·qr, negative ones included; list 1 holds 5 valid rows
    (fewer than blk_k): its sentinel rows come out in position order."""
    rng = np.random.default_rng(23)
    nlist, c, d = 4, 24, 16
    qv, rows = _ints(rng, nlist, c, d), _ints(rng, nlist, maxlen, d)
    r2 = np.sum(rows * rows, axis=2).astype(np.float32) * 0.5
    r2[1, 5:] = 1e30
    qj, qt = _both(qv, dtype)
    rj, rt = _both(rows, dtype)
    ref_d, ref_p = ivf_scan_select_pallas(qj, rj, jnp.asarray(r2), blk_k, keep_pad=True,
                                          interpret=True)
    fn = kernels.ivf_scan_select if impl == "wrapper" else kernels.ivf_scan_select_plain
    out_d, out_p = fn(qt, rt, torch.from_numpy(r2), blk_k)
    assert tuple(out_d.shape) == (nlist, sel.ceil_to(blk_k, 8), c)
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(out_d.numpy(), np.asarray(ref_d))
    assert (out_d.numpy() < 0).any()


def test_sortable_int_matches_jax_and_orders_floats():
    vals = np.array([-3e38, -2.5, -1.0 - 2**-23, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0,
                     1.0 + 2**-23, 7.5, 1e30, 3e38], np.float32)
    bits = vals.view(np.int32)
    out = sel.sortable_int(torch.from_numpy(bits.copy())).numpy()
    np.testing.assert_array_equal(out, np.asarray(pk._sortable_int(jnp.asarray(bits))))
    assert (np.diff(out.astype(np.int64)) >= 0).all()
    assert (out[[0, 1, 2, 3, 4]] < 0).all()  # negatives map below zero
    np.testing.assert_array_equal(sel.sortable_int(torch.from_numpy(out)).numpy(), bits)


@pytest.mark.parametrize("pos_bits", [3, 4, 11, 16])  # 8 positions need 3
def test_packed_keys_match_jax_floor_and_decode(pos_bits):
    """Hand-built scores, negative ones included: the keys equal the JAX
    helper's (positions on its sublane axis), each decoded value is the
    score floored within 2^(pos_bits − 23) of its magnitude, and ties of
    the floored value go to the lower position."""
    scores = np.array([[-1.0 - 2**-23, -1.0, 3.0, 3.0, 1.0 + 2**-22, -0.5, 2.0**-10, 1e30]],
                      np.float32)
    keys = sel.packed_keys(torch.from_numpy(scores), pos_bits)
    ref = np.asarray(pk._packed_keys(jnp.asarray(scores.T), pos_bits)).T
    np.testing.assert_array_equal(keys.numpy(), ref)
    vals, pos = sel.decode_keys(keys, pos_bits)
    np.testing.assert_array_equal(pos.numpy()[0], np.arange(8))
    v, s = vals.numpy()[0].astype(np.float64), scores[0].astype(np.float64)
    assert (v <= s).all()
    assert (s - v <= np.abs(s) * 2.0 ** (pos_bits - 23)).all()
    top_v, top_p = sel.packed_extract(keys, 4, pos_bits)
    # −1 − 2⁻²³ and −1 floor together from 11 bits on: the lower position first.
    assert top_p.numpy()[0].tolist() == [0, 1, 5, 6]
    assert (np.diff(top_v.numpy()[0]) >= 0).all()


@pytest.mark.parametrize("n, bits", [(1, 3), (8, 3), (9, 4), (1000, 10), (65536, 16)])
def test_pos_bits_follow_the_8_padded_length(n, bits):
    assert sel.pos_bits_for(n) == bits


def test_pos_bits_raise_past_16():
    with pytest.raises(ValueError, match="too many"):
        sel.pos_bits_for(65537)


def test_lex_and_stable_topk_orders():
    d = torch.tensor([[2.0, 1.0, 1.0, float("inf"), 1.0]])
    ids = torch.tensor([[0, 9, 3, -1, 5]])
    ld, li = sel.lex_topk(d, ids, 4)
    assert li.tolist() == [[3, 5, 9, 0]] and ld.tolist() == [[1.0, 1.0, 1.0, 2.0]]
    sv, sp = sel.stable_topk(d, 3)
    assert sp.tolist() == [[1, 2, 4]]


def test_dist_topk_splits_fill_the_card():
    assert kernels.dist_topk_splits(4096, 1 << 20, 132) == 33
    assert kernels.dist_topk_splits(262144, 1024, 132) == 1
    assert kernels.dist_topk_splits(37, 300, 132) == 3  # at most one split per 128 rows


@pytest.mark.parametrize("bad, err", [
    (lambda q, db, i, m: (q, db, i, m, 65), ValueError),              # k > 64
    (lambda q, db, i, m: (q, db, i, m, 0), ValueError),               # k < 1
    (lambda q, db, i, m: (q.double(), db, i, m, 3), ValueError),      # dtype mismatch
    (lambda q, db, i, m: (q[:, :3], db, i, m, 3), ValueError),        # width
    (lambda q, db, i, m: (q, db, i.long(), m, 3), ValueError),        # id dtype
    (lambda q, db, i, m: (q, db, i, m[:5], 3), ValueError),           # mask shape
])
def test_dist_topk_rejects_bad_inputs(bad, err):
    args = (torch.ones((4, 6)), torch.ones((70, 6)), torch.arange(70, dtype=torch.int32),
            torch.ones(70))
    with pytest.raises(err):
        kernels.dist_topk(*bad(*args))


@pytest.mark.parametrize("bad, err", [
    (lambda qv, rows, r2: (qv, rows, r2, 11), ValueError),           # blk_k > maxlen
    (lambda qv, rows, r2: (qv.bfloat16(), rows, r2, 3), TypeError),  # dtype mismatch
    (lambda qv, rows, r2: (qv[:2], rows, r2, 3), ValueError),        # nlist mismatch
    (lambda qv, rows, r2: (qv, rows, r2[:, :4], 3), ValueError),     # r2 shape
])
def test_ivf_scan_select_rejects_bad_inputs(bad, err):
    args = (torch.ones((3, 5, 4)), torch.ones((3, 10, 4)), torch.ones((3, 10)))
    with pytest.raises(err):
        kernels.ivf_scan_select(*bad(*args))


@pytest.mark.parametrize("bad, err", [
    (lambda c, q: (c, q, 9), ValueError),                 # nprobe > nlist
    (lambda c, q: (c.double(), q, 2), TypeError),         # full f32 only
    (lambda c, q: (c, q[:, :2], 2), ValueError),          # width
])
def test_probe_select_rejects_bad_inputs(bad, err):
    with pytest.raises(err):
        kernels.probe_select(*bad(torch.ones((8, 3)), torch.ones((5, 3))))
