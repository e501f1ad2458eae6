"""The PyTorch port's LogisticRegression slice against the JAX package, on the CPU.

Both packages get the same numpy inputs. The parity runs are in float64
(the JAX conftest's x64 profile; the port gets compute_dtype = accum_dtype
= float64): the same Newton and MM-Newton iterations, so coefficients
agree to 1e-9 and iteration counts exactly. Float32 runs hold the port's
kernel routes (``newton_stats`` / ``softmax_curvature``; their plain
versions on the CPU) against the same references at float32 tolerance.
The JAX streaming fits take batches whose row counts divide over the 8
test devices.
"""

import os

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import LogisticRegressionModel as JaxLogisticRegressionModel
from spark_rapids_ml_tpu.models import logistic_regression as jax_lg
from spark_rapids_ml_tpu_torch import LogisticRegression, LogisticRegressionModel, config
from spark_rapids_ml_tpu_torch.convert import logreg_model_from_jax
from spark_rapids_ml_tpu_torch.models import logistic_regression as port_lg
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops.linalg import solve_newton_system
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

ATOL = 1e-9


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


@pytest.fixture
def f64():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield


@pytest.fixture
def binary_data():
    """Noisy labels of a logistic model, 600 rows (the JAX in-memory fit
    pads nothing; its streams take batches of 200)."""
    rng = np.random.default_rng(3)
    n, d = 600, 6
    x = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w + 0.5)))).astype(np.float64)
    return x, y


@pytest.fixture
def multi_data():
    rng = np.random.default_rng(4)
    n, d, c = 600, 5, 3
    x = rng.normal(size=(n, d))
    w = rng.normal(size=(d, c)) * 2
    y = np.argmax(x @ w + rng.normal(size=(n, c)) * 0.5, axis=1).astype(np.float64)
    return x, y


def _one_hot_data(seed=5):
    """regParam = 0 with one-hot features: rows sum to 1 (the intercept's
    null direction), a collinear duplicate and a dead column."""
    rng = np.random.default_rng(seed)
    n = 600
    cat = rng.integers(0, 3, n)
    x = np.zeros((n, 5))
    x[np.arange(n), cat] = 1.0
    x[:, 3] = x[:, 0]
    x[:, 4] = 0.0
    return x, cat


def _batched(x, y, size=200):
    return lambda: iter([(x[i:i + size], y[i:i + size]) for i in range(0, len(x), size)])


def _assert_same(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.coefficients, ref.coefficients, rtol=0, atol=atol)
    np.testing.assert_allclose(out.intercept, ref.intercept, rtol=0, atol=atol)
    assert out.n_iter == ref.n_iter and out.n_rows == ref.n_rows
    assert np.shape(out.coefficients) == np.shape(ref.coefficients)
    assert np.shape(out.intercept) == np.shape(ref.intercept)


# ---------------------------------------------------------------------------
# In-memory fits
# ---------------------------------------------------------------------------


BINARY_CASES = {
    "ridge": dict(reg=0.01, fit_intercept=True),
    "ridge_no_intercept": dict(reg=0.01, fit_intercept=False),
    "small_reg": dict(reg=1e-4, fit_intercept=True),
    "unregularized": dict(reg=0.0, fit_intercept=True),
}


@pytest.mark.parametrize("case", sorted(BINARY_CASES))
def test_binary_fit_matches_jax(binary_data, mesh8, f64, case):
    x, y = binary_data
    ref = jax_lg.fit_logistic_regression(x, y, mesh=mesh8, **BINARY_CASES[case])
    out = port_lg.fit_logistic_regression(x, y, device="cpu", **BINARY_CASES[case])
    _assert_same(out, ref)
    np.testing.assert_allclose(out.loss, ref.loss, rtol=1e-12)


def test_binary_float32_kernel_route_matches_jax(binary_data, mesh8):
    """Default dtypes on the CPU (float32 compute and accumulators): every
    iteration goes through the ``newton_stats`` wrapper (its plain version
    here) and lands within float32 error of the float64 reference."""
    x, y = binary_data
    ref = jax_lg.fit_logistic_regression(x, y, reg=0.01, mesh=mesh8)
    calls = []
    orig = kernels.newton_stats

    def counted(*args):
        calls.append(args[0].dtype)
        return orig(*args)

    before = dict(kernels.LAUNCHES)
    try:
        kernels.newton_stats = counted
        out = port_lg.fit_logistic_regression(x, y, reg=0.01, device="cpu")
    finally:
        kernels.newton_stats = orig
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert calls == [torch.float32] * out.n_iter and out.n_iter == ref.n_iter
    np.testing.assert_allclose(out.coefficients, ref.coefficients, atol=1e-4)
    np.testing.assert_allclose(out.intercept, ref.intercept, atol=1e-4)
    np.testing.assert_allclose(out.loss, ref.loss, rtol=1e-5)


def test_binary_bf16_stops_at_the_rounding_floor(binary_data):
    """bfloat16 x through the kernel route: with tol > 0 the loop stops at
    a step of max(tol, 2⁻⁸·‖w‖), within that of the float64 optimum of the
    same rounded rows; tol = 0 runs exactly maxIter steps."""
    x, y = binary_data
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        exact = port_lg.fit_logistic_regression(xb, y, reg=0.01, tol=1e-12, device="cpu")
    with config.option("compute_dtype", "bfloat16"):
        out = port_lg.fit_logistic_regression(x, y, reg=0.01, tol=1e-6, device="cpu")
        fixed = port_lg.fit_logistic_regression(x, y, reg=0.01, tol=0.0, max_iter=7,
                                                device="cpu")
    assert out.n_iter < exact.n_iter and fixed.n_iter == 7
    wn = np.linalg.norm(exact.coefficients)
    assert np.linalg.norm(out.coefficients - exact.coefficients) <= 2.0**-8 * wn
    np.testing.assert_allclose(fixed.coefficients, exact.coefficients, atol=1e-5 * wn)


def test_binary_unregularized_one_hot_stays_finite(mesh8, f64):
    """regParam = 0, one-hot features + intercept: the floored bordered
    Cholesky keeps every iterate finite, separates the classes, and
    follows the JAX package's direct solve."""
    x, cat = _one_hot_data()
    y = (cat == 0).astype(np.float64)
    ref = jax_lg.fit_logistic_regression(x, y, reg=0.0, max_iter=30, mesh=mesh8)
    out = port_lg.fit_logistic_regression(x, y, reg=0.0, max_iter=30, device="cpu")
    assert np.isfinite(out.coefficients).all() and np.isfinite(out.intercept)
    assert ((x @ out.coefficients + out.intercept > 0) == (y > 0.5)).all()
    assert out.n_iter == ref.n_iter
    scale = np.abs(ref.coefficients).max()
    np.testing.assert_allclose(out.coefficients, ref.coefficients, atol=1e-6 * scale)


MULTI_CASES = {
    "ridge": dict(reg=0.01, fit_intercept=True),
    "ridge_no_intercept": dict(reg=0.01, fit_intercept=False),
    "unregularized": dict(reg=0.0, fit_intercept=True),
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multinomial_fit_matches_jax(multi_data, mesh8, f64, case):
    """C = 3, eight MM-Newton passes at tol 0 in both packages."""
    x, y = multi_data
    kw = dict(max_iter=8, tol=0.0, **MULTI_CASES[case])
    ref = jax_lg.fit_logistic_regression(x, y, mesh=mesh8, **kw)
    out = port_lg.fit_logistic_regression(x, y, device="cpu", **kw)
    assert out.coefficients.shape == (3, 5) and out.intercept.shape == (3,)
    _assert_same(out, ref)
    assert out.loss is None and ref.loss is None


def test_multinomial_float32_kernel_route_matches_jax(multi_data, mesh8):
    """float32 accumulators: each pass's curvature goes through the
    ``softmax_curvature`` wrapper once (its plain version here), the
    reported objective never increases, and the fit lands within float32
    error of the float64 reference."""
    x, y = multi_data
    ref = jax_lg.fit_logistic_regression(x, y, reg=0.01, max_iter=8, tol=0.0, mesh=mesh8)
    calls = []
    orig = kernels.softmax_curvature

    def counted(*args):
        calls.append(tuple(args[1].shape))
        return orig(*args)

    try:
        kernels.softmax_curvature = counted
        out = port_lg.fit_logistic_regression(x, y, reg=0.01, max_iter=8, tol=0.0,
                                              device="cpu")
    finally:
        kernels.softmax_curvature = orig
    assert calls == [(600, 3)] * 8
    np.testing.assert_allclose(out.coefficients, ref.coefficients, atol=1e-4)
    np.testing.assert_allclose(out.intercept, ref.intercept, atol=1e-4)
    hist = out.objective_history
    assert len(hist) == 8 and hist[0] == pytest.approx(np.log(3), rel=1e-6)
    assert all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:]))


def test_multinomial_unregularized_one_hot_stays_finite(mesh8, f64):
    x, cat = _one_hot_data(6)
    y = cat.astype(np.float64)
    for fit_intercept in (True, False):
        kw = dict(reg=0.0, max_iter=50, tol=1e-8, fit_intercept=fit_intercept)
        ref = jax_lg.fit_multinomial_stream(_batched(x, y), 5, 3, mesh=mesh8, **kw)
        out = port_lg.fit_multinomial_stream(_batched(x, y), 5, 3, device="cpu", **kw)
        assert np.isfinite(out.coefficients).all() and np.isfinite(out.intercept).all()
        assert ((x @ out.coefficients.T + out.intercept).argmax(axis=1) == cat).all()
        assert out.n_iter == ref.n_iter
        # The duplicated columns make w0 and w3 one direction: compare the
        # margins, which the data determine. At regParam 0 they grow every
        # pass through near-singular floored systems, which compound the
        # two LAPACKs' roundings: 1e-5 of the largest margin.
        margins = x @ out.coefficients.T + out.intercept
        ref_margins = x @ ref.coefficients.T + ref.intercept
        scale = np.abs(ref_margins).max()
        np.testing.assert_allclose(margins, ref_margins, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# Streams and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reg, fit_intercept", [(1e-3, True), (0.0, False)])
def test_binary_stream_matches_jax(binary_data, mesh8, f64, reg, fit_intercept):
    x, y = binary_data
    kw = dict(reg=reg, fit_intercept=fit_intercept, max_iter=30, tol=1e-8)
    ref = jax_lg.fit_logistic_stream(_batched(x, y), n_cols=6, mesh=mesh8, **kw)
    out = port_lg.fit_logistic_stream(_batched(x, y), n_cols=6, device="cpu", **kw)
    _assert_same(out, ref)
    np.testing.assert_allclose(out.loss, ref.loss, rtol=1e-10)
    assert len(out.objective_history) == out.n_iter


@pytest.mark.parametrize("reg, fit_intercept", [(0.01, True), (0.02, False)])
def test_multinomial_stream_matches_jax(multi_data, mesh8, f64, reg, fit_intercept):
    x, y = multi_data
    kw = dict(reg=reg, fit_intercept=fit_intercept, max_iter=40, tol=1e-9)
    ref = jax_lg.fit_multinomial_stream(_batched(x, y), 5, 3, mesh=mesh8, **kw)
    out = port_lg.fit_multinomial_stream(_batched(x, y), 5, 3, device="cpu", **kw)
    _assert_same(out, ref)
    np.testing.assert_allclose(out.loss, ref.loss, rtol=1e-10)


def test_streams_are_batch_invariant(binary_data, multi_data, f64):
    """The same optimum whatever the batching (additive statistics)."""
    x, y = binary_data
    a = port_lg.fit_logistic_stream(_batched(x, y, 150), 6, reg=0.02, device="cpu")
    b = port_lg.fit_logistic_stream(_batched(x, y, 600), 6, reg=0.02, device="cpu")
    np.testing.assert_allclose(a.coefficients, b.coefficients, atol=1e-10)
    xm, ym = multi_data
    a = port_lg.fit_multinomial_stream(_batched(xm, ym, 150), 5, 3, reg=0.02, device="cpu")
    b = port_lg.fit_multinomial_stream(_batched(xm, ym, 600), 5, 3, reg=0.02, device="cpu")
    np.testing.assert_allclose(a.coefficients, b.coefficients, atol=1e-10)
    np.testing.assert_allclose(a.intercept, b.intercept, atol=1e-10)


def test_binary_stream_matches_in_memory_fit(binary_data, f64):
    """The stream rounds batches to float32 (the JAX placement); the
    in-memory fit reads the float64 rows: the optima agree to 1e-4."""
    x, y = binary_data
    mem = port_lg.fit_logistic_regression(x, y, reg=1e-3, tol=1e-8, device="cpu")
    st = port_lg.fit_logistic_stream(_batched(x, y, 256), 6, reg=1e-3, tol=1e-8, device="cpu")
    assert st.n_rows == 600 and np.isfinite(st.loss)
    np.testing.assert_allclose(st.coefficients, mem.coefficients, atol=1e-4)
    np.testing.assert_allclose(st.intercept, mem.intercept, atol=1e-4)


class _Stop(Exception):
    pass


def _stops_on_scan(x, y, scan, size=200):
    """A batch source whose ``scan``-th scan raises (an interrupted fit)."""
    calls = {"n": 0}

    def source():
        calls["n"] += 1
        if calls["n"] == scan:
            raise _Stop()
        return _batched(x, y, size)()

    return source


def test_binary_stream_checkpoint_resume(binary_data, f64, tmp_path):
    x, y = binary_data
    ck = str(tmp_path / "lr.ckpt")
    kw = dict(n_cols=6, reg=1e-3, max_iter=25, tol=1e-10, device="cpu")
    full = port_lg.fit_logistic_stream(_batched(x, y), **kw)
    with pytest.raises(_Stop):
        port_lg.fit_logistic_stream(_stops_on_scan(x, y, 3), checkpoint_path=ck, **kw)
    assert os.path.exists(ck)
    resumed = port_lg.fit_logistic_stream(_batched(x, y), checkpoint_path=ck, **kw)
    assert not os.path.exists(ck)
    np.testing.assert_allclose(resumed.coefficients, full.coefficients, atol=ATOL)
    assert resumed.n_iter == full.n_iter and len(resumed.objective_history) == full.n_iter - 2


@pytest.mark.parametrize("kind", ["binary", "multinomial"])
def test_jax_checkpoint_resumes_in_the_port(binary_data, multi_data, mesh8, f64, tmp_path,
                                            kind):
    """A JAX fit interrupted on its third scan leaves its (w, b) / (W, b)
    checkpoint; the port resumes it and ends where the JAX fit ends."""
    ck = str(tmp_path / f"{kind}.ckpt")
    if kind == "binary":
        x, y = binary_data
        jfit, pfit, args = jax_lg.fit_logistic_stream, port_lg.fit_logistic_stream, (6,)
    else:
        x, y = multi_data
        jfit, pfit, args = jax_lg.fit_multinomial_stream, port_lg.fit_multinomial_stream, (5, 3)
    kw = dict(reg=0.01, max_iter=12, tol=0.0)
    full = jfit(_batched(x, y), *args, mesh=mesh8, **kw)
    with pytest.raises(_Stop):
        jfit(_stops_on_scan(x, y, 3), *args, mesh=mesh8, checkpoint_path=ck, **kw)
    assert os.path.exists(ck)
    resumed = pfit(_batched(x, y), *args, device="cpu", checkpoint_path=ck, **kw)
    assert not os.path.exists(ck)
    _assert_same(resumed, full)


def test_port_checkpoint_resumes_in_jax(binary_data, mesh8, f64, tmp_path):
    x, y = binary_data
    ck = str(tmp_path / "port.ckpt")
    kw = dict(reg=0.01, max_iter=10, tol=0.0)
    full = jax_lg.fit_logistic_stream(_batched(x, y), 6, mesh=mesh8, **kw)
    with pytest.raises(_Stop):
        port_lg.fit_logistic_stream(_stops_on_scan(x, y, 4), 6, device="cpu",
                                    checkpoint_path=ck, **kw)
    resumed = jax_lg.fit_logistic_stream(_batched(x, y), 6, mesh=mesh8, checkpoint_path=ck, **kw)
    _assert_same(resumed, full)


def test_resume_past_max_iter_evaluates_once(binary_data, f64, tmp_path):
    """A checkpoint at or past maxIter: no step, one scan for the loss."""
    x, y = binary_data
    ck = str(tmp_path / "done.ckpt")
    with pytest.raises(_Stop):
        port_lg.fit_logistic_stream(_stops_on_scan(x, y, 4), 6, reg=0.01, tol=0.0,
                                    device="cpu", checkpoint_path=ck)
    out = port_lg.fit_logistic_stream(_batched(x, y), 6, reg=0.01, max_iter=2,
                                      device="cpu", checkpoint_path=ck)
    assert out.n_iter == 3 and out.n_rows == 600 and np.isfinite(out.loss)
    assert out.objective_history == () and not os.path.exists(ck)


@pytest.mark.parametrize("kind", ["binary", "multinomial"])
def test_checkpoint_of_another_shape_raises(binary_data, f64, tmp_path, kind):
    x, y = binary_data
    ck = str(tmp_path / "ck")
    with pytest.raises(_Stop):
        port_lg.fit_logistic_stream(_stops_on_scan(x, y, 2), 6, device="cpu",
                                    checkpoint_path=ck)
    with pytest.raises(ValueError, match="checkpoint at"):
        if kind == "binary":
            port_lg.fit_logistic_stream(_batched(x[:, :5], y), 5, device="cpu",
                                        checkpoint_path=ck)
        else:
            port_lg.fit_multinomial_stream(_batched(x, y), 6, 2, device="cpu",
                                           checkpoint_path=ck)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def _rng_x(n=20, d=3):
    return np.random.default_rng(9).normal(size=(n, d))


@pytest.mark.parametrize("call, match", [
    (lambda: port_lg.fit_logistic_regression(_rng_x(), np.zeros(20), device="cpu"),
     "at least 2"),
    (lambda: port_lg.fit_logistic_regression(_rng_x(), np.tile([1.0, 5.0], 10), device="cpu"),
     r"labels must be 0\.\.1"),
    (lambda: port_lg.fit_logistic_regression(_rng_x(), np.tile([0.0, 1.0], 9), device="cpu"),
     "rows"),
    (lambda: port_lg.fit_logistic_stream(_batched(_rng_x(64, 4), np.arange(64) % 3.0), 4,
                                         max_iter=2, device="cpu"), "binary"),
    (lambda: port_lg.fit_multinomial_stream(_batched(_rng_x(100, 4), np.full(100, 5.0)), 4, 3,
                                            max_iter=2, device="cpu"), r"in \[0, 3\)"),
    (lambda: port_lg.fit_multinomial_stream(_batched(_rng_x(100, 4), np.full(100, 0.5)), 4, 3,
                                            max_iter=2, device="cpu"), "integers"),
    (lambda: port_lg.fit_multinomial_stream(_batched(_rng_x(), np.zeros(20)), 3, 1,
                                            device="cpu"), "n_classes must be"),
    (lambda: port_lg.fit_logistic_stream(_batched(_rng_x(20, 4), np.zeros(20)), 3,
                                         device="cpu"), r"expected \(m, 3\)"),
    (lambda: port_lg.fit_logistic_regression(np.zeros((6, 9460)), np.arange(6) % 3,
                                             device="cpu"), "too large"),
])
def test_validation_errors(f64, call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_validation_messages_match_jax(mesh8):
    """The label checks raise the JAX package's messages."""
    y = np.array([0.0, 1.0, 2.0, 1.0])
    for port_fn, jax_fn in ((port_lg.validate_binary_labels, jax_lg.validate_binary_labels),):
        with pytest.raises(ValueError) as a:
            port_fn(y)
        with pytest.raises(ValueError) as b:
            jax_fn(y)
        assert str(a.value) == str(b.value)
    for bad in (np.array([0.0, 3.0]), np.array([0.0, 1.5]), np.array([-1.0, 1.0])):
        with pytest.raises(ValueError) as a:
            port_lg.validate_multiclass_labels(bad, 3)
        with pytest.raises(ValueError) as b:
            jax_lg.validate_multiclass_labels(bad, 3)
        assert str(a.value) == str(b.value)
    port_lg.validate_multiclass_labels(np.zeros(0), 3)  # nothing to check
    port_lg.validate_binary_labels(torch.tensor([0.0, 1.0]))


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _spd_system(rng, d, singular=False, fit_intercept=True):
    """A bordered Newton system as the statistics make it: joint = AᵀA/m
    for A = [X, 1]. Singular: a duplicated column, so only the floored
    solve works, and a right-hand side in the range of the system solved
    (as a gradient of those rows is), so its solution is determined."""
    m = rng.normal(size=(3 * d, d))
    if singular:
        m[:, -1] = m[:, 0]
    a = np.concatenate([m, np.ones((3 * d, 1))], axis=1)
    joint = a.T @ a / (3 * d)
    rhs = rng.normal(size=d + 1)
    if singular:
        rhs = joint @ rhs if fit_intercept else np.append(joint[:d, :d] @ rhs[:d], rhs[d])
    return joint[:d, :d], joint[:d, d], joint[d, d], rhs[:d], rhs[d]


@pytest.mark.parametrize("reg, fit_intercept", [(0.1, True), (0.1, False), (0.0, True),
                                                (0.0, False)])
def test_solve_newton_system_matches_jax(reg, fit_intercept):
    rng = np.random.default_rng(10)
    h, hwb, hbb, gw, gb = _spd_system(rng, 7, reg == 0.0, fit_intercept)
    h = h + reg * np.eye(7)
    ref = jax_lg._solve_newton_system(h, hwb, np.float64(hbb), gw, np.float64(gb), reg,
                                      fit_intercept, np.float64)
    out = solve_newton_system(*(torch.as_tensor(np.asarray(a)) for a in (h, hwb, hbb, gw, gb)),
                              reg, fit_intercept)
    dw, dw_ref = out[0].numpy(), np.asarray(ref[0])
    if reg == 0.0:
        # The duplicated column's null direction e0 − e6 is left to the
        # floor and the rounding: compare what the system determines.
        null = np.zeros(7)
        null[0], null[6] = 2 ** -0.5, -(2 ** -0.5)
        dw, dw_ref = dw - (dw @ null) * null, dw_ref - (dw_ref @ null) * null
    np.testing.assert_allclose(dw, dw_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("reg, fit_intercept", [(0.05, True), (0.0, True)])
def test_batched_class_step_matches_jax(reg, fit_intercept):
    """The multinomial step, batched over the class axis, equals the JAX
    package's vmapped per-class solve."""
    rng = np.random.default_rng(11)
    d, c = 6, 4
    parts = [_spd_system(rng, d) for _ in range(c)]  # reg 0: floored, nonsingular
    hw = np.stack([p[0] for p in parts]) * 50
    hwb = np.stack([p[1] for p in parts]) * 50
    hbb = np.array([p[2] for p in parts]) * 50
    gw = np.stack([p[3] for p in parts], axis=1) * 50
    gb = np.array([p[4] for p in parts]) * 50
    W, b, n = rng.normal(size=(d, c)), rng.normal(size=c), 50.0
    step = jax_lg._stream_multinomial_step_fn(reg, fit_intercept, "float64")
    ref = step(gw, gb, hw, hwb, hbb, np.float64(n), W, b)
    state = tuple(torch.as_tensor(a) for a in (gw, gb, hw, hwb, hbb, np.float64(0.0),
                                                np.float64(n)))
    out = port_lg._softmax_step(state, torch.as_tensor(W), torch.as_tensor(b), reg,
                                fit_intercept)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# Estimator, model, persistence
# ---------------------------------------------------------------------------


def test_estimator_and_model_api(binary_data, mesh8, f64):
    x, y = binary_data
    est = LogisticRegression(device="cpu")
    assert (est.getRegParam(), est.getFitIntercept(), est.getMaxIter(), est.getTol()) == (
        0.0, True, 100, 1e-6)
    assert (est.getFeaturesCol(), est.getLabelCol(), est.getPredictionCol(),
            est.getProbabilityCol(), est.getRawPredictionCol()) == (
        "features", "label", "prediction", "probability", "rawPrediction")
    est.setRegParam(0.01).setMaxIter(50).setTol(1e-8).setFitIntercept(True)
    est.setProbabilityCol("p").setRawPredictionCol("raw").setPredictionCol("pred")
    copied = est.copy({"maxIter": 40})
    assert copied.getMaxIter() == 40 and copied._device == "cpu" and copied.uid == est.uid
    ds = {"features": x, "label": y}
    model = est.fit(ds)
    ref = jax_lg.LogisticRegression(mesh=mesh8).setRegParam(0.01).setTol(1e-8).fit(ds)
    np.testing.assert_allclose(model.coefficients, ref.coefficients, atol=ATOL)
    assert model.uid == est.uid and model.numClasses == 2 and model.getRegParam() == 0.01
    assert model.summary.numIter == ref.summary.numIter and model.summary.n_rows == 600
    np.testing.assert_allclose(model.summary.loss, ref.summary.loss, rtol=1e-12)
    out = model.transform(ds)
    assert out["raw"].shape == (600, 2) and out["p"].shape == (600, 2)
    assert out["pred"].shape == (600,) and np.mean(out["pred"] == y) > 0.7
    assert LogisticRegressionModel().numClasses == 0
    with pytest.raises(RuntimeError, match="unfitted"):
        LogisticRegressionModel(device="cpu").transform_matrix(x)


@pytest.mark.parametrize("kind", ["binary", "multinomial"])
def test_model_outputs_match_jax(binary_data, multi_data, mesh8, f64, kind):
    """predict_raw / predict_proba / predict / transform_matrix / transform
    of a model built from the JAX model's data, on the same rows."""
    x, y = binary_data if kind == "binary" else multi_data
    ds = {"features": x, "label": y}
    ref = jax_lg.LogisticRegression(mesh=mesh8).setRegParam(0.01).setMaxIter(20).fit(ds)
    model = logreg_model_from_jax(ref._model_data(), device="cpu")
    assert model.numClasses == ref.numClasses
    np.testing.assert_allclose(model.predict_raw(x), ref.predict_raw(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(model.predict_proba(x), ref.predict_proba(x), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(model.predict(x), ref.predict(x))
    out, jout = model.transform_matrix(x), ref.transform_matrix(x)
    for key in ("rawPrediction", "probability", "prediction"):
        assert out[key].dtype == np.float64
        np.testing.assert_allclose(out[key], jout[key], rtol=1e-12, atol=1e-12)
    t, jt = model.transform(ds), ref.transform(ds)
    np.testing.assert_array_equal(t["prediction"], jt["prediction"])
    np.testing.assert_allclose(t["probability"], jt["probability"], rtol=1e-12, atol=1e-14)


def test_transform_matrix_tensor_in_tensor_out(multi_data):
    """A tensor in gives tensors on the model's device; compute and
    accumulator dtypes apply to the margins (float32 on the CPU)."""
    x, y = multi_data
    coef = np.random.default_rng(12).normal(size=(3, 5))
    model = LogisticRegressionModel(coefficients=coef, intercept=np.array([0.1, 0.0, -0.1]),
                                    device="cpu")
    out = model.transform_matrix(torch.from_numpy(x))
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    np.testing.assert_allclose(out["rawPrediction"].numpy(), model.predict_raw(x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["probability"].sum(1).numpy(), 1.0, atol=1e-12)
    assert out["prediction"].dtype == torch.float64 and len(model._raw_cache) == 1


@pytest.mark.parametrize("kind", ["binary", "multinomial"])
def test_save_load_across_packages(binary_data, multi_data, tmp_path, f64, kind):
    x, y = binary_data if kind == "binary" else multi_data
    port = LogisticRegression(device="cpu").setRegParam(0.02).setMaxIter(30).fit(
        {"features": x, "label": y})
    port.save(str(tmp_path / "port"))
    back_jax = JaxLogisticRegressionModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(back_jax.coefficients, port.coefficients, rtol=1e-12)
    np.testing.assert_allclose(back_jax.intercept, port.intercept, rtol=1e-12)
    assert back_jax.getRegParam() == 0.02 and back_jax.numClasses == port.numClasses
    back_jax.save(str(tmp_path / "jax"))
    back = LogisticRegressionModel.load(str(tmp_path / "jax"))
    np.testing.assert_allclose(back.coefficients, port.coefficients, rtol=1e-12)
    assert np.shape(back.intercept) == np.shape(port.intercept)
    assert back.getMaxIter() == 30 and back.summary is None
    np.testing.assert_array_equal(back.predict(x), port.predict(x))
