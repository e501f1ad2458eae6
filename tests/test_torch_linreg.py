"""The PyTorch port's LinearRegression slice against the JAX package, on the CPU.

Both packages get the same numpy inputs. The parity runs are in float64
(the JAX conftest's x64 profile; the port gets compute_dtype = accum_dtype
= float64): coefficients and intercept to 1e-6 absolute, the summary's
rmse and r2 to 1e-6 relative. A float32 run holds the port's kernel route
(``linreg_stats``; its plain version on the CPU) against the same
reference at float32 tolerance.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import LinearRegressionModel as JaxLinearRegressionModel
from spark_rapids_ml_tpu.models import linear_regression as jax_lr
from spark_rapids_ml_tpu.ops.linalg import solve_spd as jax_solve_spd
from spark_rapids_ml_tpu_torch import LinearRegression, LinearRegressionModel, config
from spark_rapids_ml_tpu_torch.convert import linreg_model_from_jax, normal_eq_stats_from_jax
from spark_rapids_ml_tpu_torch.models import linear_regression as port_lr
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops.linalg import solve_spd
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

ATOL = 1e-6


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
    """y = Xw + b + noise at a ragged row count (503: the JAX fit pads it
    over 8 devices); a few coefficients are small, so the L1 fits zero
    some of them."""
    rng = np.random.default_rng(5)
    n, d = 503, 12
    x = rng.normal(size=(n, d)) * np.linspace(0.5, 2.0, d) + rng.normal(size=d)
    w = rng.normal(size=d)
    w[::4] *= 0.01
    y = x @ w + 1.5 + 0.1 * rng.normal(size=n)
    return x, y


CASES = {
    "ols": dict(reg=0.0, elastic_net=0.0, fit_intercept=True),
    "no_intercept": dict(reg=0.0, elastic_net=0.0, fit_intercept=False),
    "ridge": dict(reg=0.3, elastic_net=0.0, fit_intercept=True),
    "lasso": dict(reg=0.05, elastic_net=1.0, fit_intercept=True),
    "elastic_net": dict(reg=0.1, elastic_net=0.5, fit_intercept=True),
}


def _assert_same_solution(out, ref, atol=ATOL, rtol_summary=1e-6):
    np.testing.assert_allclose(out.coefficients, ref.coefficients, rtol=0, atol=atol)
    np.testing.assert_allclose(out.intercept, ref.intercept, rtol=0, atol=atol)
    np.testing.assert_allclose(out.summary.rmse, ref.summary.rmse, rtol=rtol_summary)
    np.testing.assert_allclose(out.summary.r2, ref.summary.r2, rtol=rtol_summary)
    assert out.n_rows == ref.n_rows == out.summary.n_rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_linear_regression_matches_jax(data, mesh8, f64, case):
    x, y = data
    ref = jax_lr.fit_linear_regression(x, y, mesh=mesh8, **CASES[case])
    out = port_lr.fit_linear_regression(x, y, device="cpu", **CASES[case])
    _assert_same_solution(out, ref)
    if CASES[case]["elastic_net"] > 0:
        assert np.sum(out.coefficients == 0.0) == np.sum(ref.coefficients == 0.0)


def test_float32_kernel_route_matches_jax(data, mesh8):
    """Default dtypes on the CPU (float32 compute and accumulators): the
    statistics go through the ``linreg_stats`` wrapper (its plain version
    here) and land within float32 error of the float64 reference."""
    x, y = data
    ref = jax_lr.fit_linear_regression(x, y, mesh=mesh8)
    before = dict(kernels.LAUNCHES)
    out = port_lr.fit_linear_regression(x, y, device="cpu")
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.coefficients, ref.coefficients, atol=1e-3)
    np.testing.assert_allclose(out.intercept, ref.intercept, atol=1e-2)


def test_row_count_mismatch_raises(data):
    x, y = data
    with pytest.raises(ValueError, match="rows"):
        port_lr.fit_linear_regression(x, y[:-1], device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_streaming_batches_equal_in_memory_stats(data, dtype):
    """Three ragged batches folded in place equal one in-memory pass."""
    x, y = data
    with config.option("compute_dtype", dtype), config.option("accum_dtype", dtype):
        whole = port_lr.normal_eq_stats(torch.from_numpy(x), torch.from_numpy(y))
        state = port_lr.init_normal_eq_stats(x.shape[1], device="cpu")
        ptrs = [t.data_ptr() for t in state]
        for lo, hi in ((0, 200), (200, 201), (201, 503)):
            port_lr.streaming_normal_eq_update(state, x[lo:hi], y[lo:hi])
    assert [t.data_ptr() for t in state] == ptrs  # folded in place
    tol = dict(rtol=1e-12, atol=1e-9) if dtype == "float64" else dict(rtol=1e-5, atol=1e-3)
    for a, b in zip(state, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    assert float(state[5]) == 503.0


def test_streaming_update_with_mask_matches_jax(data, mesh8, f64):
    """A masked batch: the port's fold equals the JAX package's donated
    update on the same batch and mask (496 rows: the JAX update takes
    rows that divide over its 8 devices)."""
    x, y = (a[:496] for a in data)
    mask = np.ones(len(y))
    mask[-37:] = 0.0
    update = jax_lr.streaming_normal_eq_update(mesh8)
    ref = update(jax_lr.init_normal_eq_stats(x.shape[1]), x, y, mask)
    state = port_lr.init_normal_eq_stats(x.shape[1], device="cpu")
    port_lr.streaming_normal_eq_update(state, x, y, mask)
    for a, b in zip(state, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-9)
    assert float(state[5]) == len(y) - 37


@pytest.mark.parametrize("case", ["ols", "elastic_net"])
def test_finalize_of_a_jax_state_matches_jax(data, mesh8, f64, case):
    x, y = (a[:496] for a in data)
    update = jax_lr.streaming_normal_eq_update(mesh8)
    state = update(jax_lr.init_normal_eq_stats(x.shape[1]), x, y, np.ones(len(y)))
    kw = CASES[case]
    args = (kw["reg"], kw["elastic_net"], kw["fit_intercept"], 500, 1e-6, len(y))
    ref = jax_lr.finalize_normal_eq_stats(state, *args)
    out = port_lr.finalize_normal_eq_stats(normal_eq_stats_from_jax(state), *args)
    _assert_same_solution(out, ref)


def test_singular_system_takes_the_jittered_factor():
    """A rank-deficient XᵀX (a repeated column) fails the plain Cholesky;
    the jittered refactor gives a finite solution that fits the data."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(50, 3))
    x = np.concatenate([x, x[:, :1]], axis=1)
    y = x[:, 0] + 2 * x[:, 1]
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        sol = port_lr.fit_linear_regression(x, y, fit_intercept=False, device="cpu")
    assert np.all(np.isfinite(sol.coefficients))
    np.testing.assert_allclose(x @ sol.coefficients, y, atol=1e-4)


def test_model_transform_from_a_jax_model(data, mesh8, f64):
    x, y = data
    ref = jax_lr.LinearRegression(mesh=mesh8).setRegParam(0.1).fit({"features": x, "label": y})
    model = linreg_model_from_jax(ref._model_data(), device="cpu")
    np.testing.assert_allclose(model.coefficients, ref.coefficients)
    assert model.intercept == ref.intercept
    out = model.transform_matrix(x)["prediction"]
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref.transform_matrix(x)["prediction"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(model.predict(x), ref.predict(x), rtol=1e-12, atol=1e-12)
    t = model.transform_matrix(torch.from_numpy(x))["prediction"]
    assert isinstance(t, torch.Tensor) and t.shape == (len(y),)


def test_save_load_across_packages(data, tmp_path, f64):
    x, y = data
    port = LinearRegression(device="cpu").setRegParam(0.2).setFitIntercept(True).fit(
        {"features": x, "label": y})
    port.save(str(tmp_path / "port"))
    back_jax = JaxLinearRegressionModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(back_jax.coefficients, port.coefficients, rtol=1e-12)
    assert back_jax.intercept == pytest.approx(port.intercept, rel=1e-12)
    assert back_jax.getRegParam() == 0.2
    back_jax.save(str(tmp_path / "jax"))
    back = LinearRegressionModel.load(str(tmp_path / "jax"))
    np.testing.assert_allclose(back.coefficients, port.coefficients, rtol=1e-12)
    assert back.getRegParam() == 0.2 and back.summary is None


def test_estimator_summary_and_params(data, mesh8, f64):
    x, y = data
    ds = {"features": x, "label": y}
    est = LinearRegression(device="cpu").setRegParam(0.05).setElasticNetParam(0.5)
    model = est.fit(ds)
    ref = jax_lr.LinearRegression(mesh=mesh8).setRegParam(0.05).setElasticNetParam(0.5).fit(ds)
    np.testing.assert_allclose(model.coefficients, ref.coefficients, atol=ATOL)
    np.testing.assert_allclose(model.summary.r2, ref.summary.r2, rtol=1e-6)
    out = model.transform(ds)
    assert out["prediction"].shape == (len(y),)
    assert model.uid == est.uid and model.getElasticNetParam() == 0.5


@pytest.mark.parametrize("singular", [False, True])
def test_solve_spd_matches_jax(singular):
    """The Cholesky solve, and its jittered refactor of a matrix that is
    not positive definite, equal the JAX package's branchless version."""
    rng = np.random.default_rng(9)
    m = rng.normal(size=(30, 6))
    if singular:
        m[:, 5] = m[:, 0]
    a, b = m.T @ m, rng.normal(size=6)
    if singular:  # an eigenvalue of -1e-8: both Cholesky factorizations fail
        a -= 1e-8 * np.eye(6)
    ref = np.asarray(jax_solve_spd(a, b, reg=0.0 if singular else 0.1))
    out = solve_spd(torch.from_numpy(a), torch.from_numpy(b), reg=0.0 if singular else 0.1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9)
