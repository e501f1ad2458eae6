"""The port's ``SparkStandardScaler`` through sparksim, against the JAX
package.

sparksim (``tests/sparksim.py``) runs each partition task in its own OS
process over real TCP, with Spark's retries. The fits run in the port's
float64 mode (the driver's own daemon runs in this process, so the config
reaches its folds) over 600 x 12 rows.

* the fit (one scan into a pca job, finalized to raw moments) against the
  in-process JAX daemon's ``raw_moments`` finalize of the same partitions,
  with the reference's mean/std formula: mean and std to 1e-12 relative;
  a retried task changes nothing; the driver materializes no row;
* the served transform, through ``ensure_model`` with the serving params,
  bitwise equal to ``transform_matrix``; a ``withMean=True`` copy of the
  same fit registers under a second name and serves its own output;
  ``SRML_TRANSFORM_LOCAL=1`` applies the params too;
* the cross pairings (the port's wrapper against a JAX daemon, the JAX
  wrapper against the port's daemon), at the same tolerance;
* an empty DataFrame raises.
"""

import numpy as np
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import SparkStandardScaler, daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

PARTS = 3
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_TRANSFORM_LOCAL", "SRML_FIT_RECOVERY_ATTEMPTS"):
        monkeypatch.delenv(name, raising=False)
    with jax_ledger_off(), config.option("compute_dtype", "float64"), \
            config.option("accum_dtype", "float64"):
        yield
    daemon_session.shutdown()


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(600, 12)) * np.linspace(0.5, 4.0, 12) + np.linspace(-2.0, 3.0, 12)
    x[:, 7] = -1.5  # a constant feature: std 0
    return x


@pytest.fixture(scope="module")
def jax_moments(x, mesh8):
    """(mean, std) from an in-process JAX daemon's raw_moments finalize of
    the same partitions, with the reference's formula."""
    with jax_ledger_off(), JaxDaemon(mesh=mesh8) as jd, JaxClient(*jd.address) as c:
        for p, part in enumerate(np.array_split(x, PARTS)):
            c.feed("sc", part, algo="pca", partition=p)
            c.commit("sc", partition=p)
        arrays, rows = c.finalize("sc", {"raw_moments": True})
    assert rows == x.shape[0]
    cnt = float(arrays["count"][0])
    mean = np.asarray(arrays["colsum"], np.float64) / cnt
    var = (np.asarray(arrays["gram_diag"], np.float64) - cnt * mean * mean) / max(cnt - 1.0, 1.0)
    return mean, np.sqrt(np.maximum(var, 0.0))


def _fit(df, **kw):
    model = SparkStandardScaler(device="cpu", **kw).setInputCol("features").fit(df)
    assert df.sparkSession.driver_rows_materialized == 0
    return model


def _assert_moments(model, jax_moments):
    mean, std = jax_moments
    np.testing.assert_allclose(model.mean, mean, rtol=RTOL, atol=0)
    np.testing.assert_allclose(model.std, std, rtol=RTOL, atol=1e-300)
    assert model.std[7] == std[7] == 0.0


@pytest.mark.parametrize("traffic", [{}, {"fail_plan": {1: [1]}}])
def test_fit_matches_the_jax_daemons_raw_moments(x, jax_moments, traffic):
    model = _fit(simdf_from_numpy(x, n_partitions=PARTS, **traffic))
    assert isinstance(model, port_est._SparkModelAdapter)
    _assert_moments(model, jax_moments)
    assert (model.getWithMean(), model.getWithStd()) == (False, True)


def _served(model, df):
    return np.array([r["scaled_features"] for r in model.transform(df).collect()], np.float64)


def test_served_transform_carries_the_serving_params(x, monkeypatch):
    df = simdf_from_numpy(x, n_partitions=PARTS)
    model = _fit(df)
    daemon = daemon_session._owned["cpu"]
    y_std = _served(model, df)
    want = model.transform_matrix(x)["output"]
    assert np.array_equal(y_std, want.astype(np.float64))
    centred = port_est._SparkModelAdapter(model._core.copy({"withMean": True}))
    y_mean = _served(centred, df)
    assert np.array_equal(y_mean, centred.transform_matrix(x)["output"].astype(np.float64))
    assert not np.array_equal(y_mean, y_std)
    names = sorted(daemon._models)
    assert len(names) == 2 and all(n.startswith(model.uid) for n in names)
    assert {m.algo for m in daemon._models.values()} == {"scaler"}
    assert {m.model.getWithMean() for m in daemon._models.values()} == {False, True}
    assert port_est._model_fingerprint(model._core) != port_est._model_fingerprint(centred._core)
    assert df.sparkSession.driver_rows_materialized == 0
    # Executor-side scoring applies the params as well.
    monkeypatch.setenv("SRML_TRANSFORM_LOCAL", "1")
    assert np.array_equal(_served(centred, df), y_mean)


def test_port_wrapper_against_a_jax_daemon(x, jax_moments, mesh8):
    with jax_ledger_off(), JaxDaemon(mesh=mesh8) as jd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % jd.address})
        model = _fit(simdf_from_numpy(x, n_partitions=PARTS, session=session))
        assert jd._jobs == {}  # finalized and dropped
    _assert_moments(model, jax_moments)


def test_jax_wrapper_against_the_ports_daemon(x, jax_moments, mesh8):
    with jax_ledger_off(), DataPlaneDaemon(device="cpu") as pd:
        session = SimSparkSession({"spark.srml.daemon.address": "%s:%d" % pd.address})
        df = simdf_from_numpy(x, n_partitions=PARTS, session=session)
        model = jax_est.SparkStandardScaler(mesh=mesh8).setInputCol("features").fit(df)
        assert pd._jobs == {}
        # The JAX model registered on the port's daemon serves its own output.
        y = np.array([r["scaled_features"] for r in model.transform(df).collect()], np.float64)
        assert [m.algo for m in pd._models.values()] == ["scaler"]
    _assert_moments(model, jax_moments)
    assert np.array_equal(y, model.transform_matrix(x)["output"].astype(np.float64))


def test_empty_dataframe_raises():
    df = simdf_from_numpy(np.empty((0, 4)), n_partitions=PARTS)
    with pytest.raises(ValueError, match="empty"):
        SparkStandardScaler(device="cpu").fit(df)
