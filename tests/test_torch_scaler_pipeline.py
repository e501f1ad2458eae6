"""The port's StandardScaler, Pipeline, tuning, evaluation and feature
modules against the JAX package, on the CPU.

Both packages get the same numpy inputs; the port runs on ``device="cpu"``
in float64 (compute and accumulation) and the JAX side in the conftest's
float64 profile over 8 CPU devices, under ``jax_ledger_off()``.

Tolerances:

* scaler: mean and std to 1e-12 relative; the transform bitwise (both are
  host float64 elementwise, cast to float32), the zero-variance rule
  (scale by 0) included;
* Pipeline(StandardScaler → PCA): components sign-aligned to 1e-10;
* evaluators: every metric equal to the JAX value exactly, on tied and
  untied scores;
* CrossValidator and TrainValidationSplit: ``avgMetrics`` /
  ``validationMetrics`` within 1e-9 relative, the same best index;
* persistence, both directions: fitted arrays bitwise; a JAX-saved
  PipelineModel loads in a process where the JAX package cannot be
  imported.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import spark_rapids_ml_tpu as jax_pkg
import spark_rapids_ml_tpu.feature as jax_feature
from spark_rapids_ml_tpu.core import dataset as jax_dataset
import spark_rapids_ml_tpu_torch as port
import spark_rapids_ml_tpu_torch.feature as port_feature
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.convert import model_from_jax, scaler_model_from_jax
from spark_rapids_ml_tpu_torch.core import dataset as port_dataset
from spark_rapids_ml_tpu_torch.core.persistence import DefaultParamsReader
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


@pytest.fixture
def f64():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield


@pytest.fixture(scope="module")
def x():
    """Columns of different scales and means, one of them constant."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(301, 9)) * np.linspace(0.1, 30.0, 9) + rng.normal(size=9) * 5
    x[:, 4] = 2.5
    return x


def _reg_data(seed=3, n=240, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = x @ rng.normal(size=d) + 0.7 + 0.5 * rng.normal(size=n)
    return {"features": x, "label": y}


def _bin_data(seed=4, n=260, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    z = x @ rng.normal(size=d) * 0.8 + 0.2
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return {"features": x, "label": y}


# ---------------------------------------------------------------------------
# StandardScaler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_mean, with_std",
                         [(False, True), (True, True), (True, False), (False, False)])
def test_scaler_fit_and_transform_match_jax(x, mesh8, f64, with_mean, with_std):
    ref = jax_pkg.StandardScaler(mesh=mesh8).setWithMean(with_mean).setWithStd(with_std)
    ref = ref.fit({"features": x})
    out = port.StandardScaler(device="cpu").setWithMean(with_mean).setWithStd(with_std)
    out = out.fit({"features": x})
    np.testing.assert_allclose(out.mean, ref.mean, rtol=1e-12, atol=0)
    np.testing.assert_allclose(out.std, ref.std, rtol=1e-12, atol=1e-300)
    assert out.std[4] == ref.std[4] == 0.0
    # The transform is host float64 elementwise in both: bitwise on the
    # same statistics.
    carried = scaler_model_from_jax(ref._model_data())._set(withMean=with_mean, withStd=with_std)
    got = carried.transform({"features": x})["scaled_features"]
    want = ref.transform({"features": x})["scaled_features"]
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert (out.getWithMean(), out.getWithStd(), out.getOutputCol()) == (
        with_mean, with_std, "scaled_features")


def test_scaler_zero_variance_scales_by_zero(mesh8, f64):
    xc = np.tile(np.array([[1.0, -3.0, 7.0]]), (50, 1))
    xc[:, 0] += np.arange(50)
    model = port.StandardScaler(device="cpu").setWithMean(True).fit({"features": xc})
    ref = jax_pkg.StandardScaler(mesh=mesh8).setWithMean(True).fit({"features": xc})
    assert np.array_equal(model.std[1:], [0.0, 0.0]) and np.array_equal(ref.std[1:], [0.0, 0.0])
    y = model.transform_matrix(xc)["output"]
    assert np.all(np.isfinite(y)) and np.all(y[:, 1:] == 0.0)
    assert np.array_equal(y, ref.transform_matrix(xc)["output"])


def test_scaler_float32_moments_and_tensor_input(x, mesh8):
    # The default float32 accumulation on the entry point's device, against
    # the float64 reference at float32 tolerance: the variance's Σx² − nμ²
    # form loses float32 digits of E[x²], so it is held to 1e-6 of E[x²]
    # (the mean to 1e-6 of E|x|). A tensor in reads alike.
    ref = jax_pkg.StandardScaler(mesh=mesh8).fit({"features": x})
    out = port.StandardScaler(device="cpu").fit({"features": torch.from_numpy(x)})
    assert np.all(np.abs(out.mean - ref.mean) <= 1e-6 * np.abs(x).mean(0))
    assert np.all(np.abs(out.std ** 2 - ref.std ** 2) <= 1e-6 * (x ** 2).mean(0))
    y = out.transform_matrix(torch.from_numpy(x))["output"]
    assert isinstance(y, np.ndarray) and y.dtype == np.float32 and y.shape == x.shape


def test_scaler_entry_point_raises_without_a_card(x, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.StandardScaler().fit({"features": x})


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def _sign_aligned(a, b):
    s = np.sign(np.sum(a * b, axis=0))
    return np.abs(a * s - b).max()


def _pipelines(mesh8, k=3):
    jp = jax_pkg.Pipeline(stages=[
        jax_pkg.StandardScaler(mesh=mesh8).setWithMean(True).setOutputCol("scaled"),
        jax_pkg.PCA(mesh=mesh8).setInputCol("scaled").setK(k),
    ])
    pp = port.Pipeline(stages=[
        port.StandardScaler(device="cpu").setWithMean(True).setOutputCol("scaled"),
        port.PCA(device="cpu").setInputCol("scaled").setK(k),
    ])
    return jp, pp


def test_pipeline_scaler_then_pca_matches_jax(x, mesh8, f64):
    jp, pp = _pipelines(mesh8)
    ref = jp.fit({"features": x})
    out = pp.fit({"features": x})
    assert [type(s).__name__ for s in out.stages] == ["StandardScalerModel", "PCAModel"]
    assert out.uid == pp.uid
    assert _sign_aligned(out.stages[1].pc, ref.stages[1].pc) <= 1e-10
    np.testing.assert_allclose(out.stages[0].std, ref.stages[0].std, rtol=1e-12)
    # A stage-by-stage fit gives the same components, bitwise.
    scaled = out.stages[0].transform({"features": x})
    alone = port.PCA(device="cpu").setInputCol("scaled").setK(3).fit(scaled)
    assert np.array_equal(alone.pc, out.stages[1].pc)
    y = out.transform({"features": x})
    assert set(y) == {"features", "scaled", "pca_features"} and y["pca_features"].shape == (301, 3)


def test_pipeline_feeds_each_stage_and_never_consumes_the_last_output(x):
    seen = []

    class Probe(port.StandardScaler):
        def _fit(self, dataset):
            seen.append(sorted(dataset))
            return super()._fit(dataset)

    class Last(port.PCAModel):
        def _transform(self, dataset):
            raise AssertionError("the last stage's output must not be computed at fit")

    last = Last(pc=np.eye(9)[:, :2])
    pm = port.Pipeline(stages=[Probe(device="cpu").setOutputCol("s1"),
                               Probe(device="cpu").setInputCol("s1").setOutputCol("s2"),
                               last]).fit({"features": x})
    assert seen == [["features"], ["features", "s1"]]
    assert pm.stages[2] is last
    with pytest.raises(TypeError, match="neither an Estimator"):
        port.Pipeline(stages=[object()]).fit({"features": x})


def test_pipeline_copy_carries_a_grid_through_its_stages(x, mesh8):
    sc = port.StandardScaler(device="cpu")
    pca = port.PCA(device="cpu").setInputCol("scaled_features").setK(2)
    pipe = port.Pipeline(stages=[sc, pca])
    copied = pipe.copy({pca.k: 4, sc.withMean: True})
    assert copied.uid == pipe.uid and copied.getStages()[1].getK() == 4
    assert copied.getStages()[0].getWithMean() and not sc.getWithMean()
    assert pca.getK() == 2  # the original is untouched
    model = pipe.fit({"features": x}, params={pca.k: 3})
    assert model.stages[1].pc.shape == (9, 3)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pipeline_model_persistence_both_directions(x, mesh8, f64, tmp_path, direction):
    jp, pp = _pipelines(mesh8)
    path = str(tmp_path / "pm")
    if direction == "port_to_jax":
        fitted = pp.fit({"features": x})
        fitted.save(path)
        back = jax_pkg.PipelineModel.load(path)
    else:
        fitted = jp.fit({"features": x})
        fitted.save(path)
        back = port.PipelineModel.load(path)
        assert isinstance(back.stages[0], port.StandardScalerModel)
        assert isinstance(back.stages[1], port.PCAModel)
    assert back.uid == fitted.uid
    assert [s.uid for s in back.stages] == [s.uid for s in fitted.stages]
    assert np.array_equal(back.stages[0].mean, fitted.stages[0].mean)
    assert np.array_equal(back.stages[0].std, fitted.stages[0].std)
    assert np.array_equal(back.stages[1].pc, fitted.stages[1].pc)
    assert back.stages[0].getWithMean() and back.stages[1].getInputCol() == "scaled"
    # The untyped load names each package's own class.
    generic = DefaultParamsReader.load_instance(os.path.join(path, "stages",
                                                             f"0_{fitted.stages[0].uid}"))
    assert isinstance(generic, port.StandardScalerModel)


def test_unsaved_pipeline_estimator_round_trips(tmp_path, mesh8):
    pipe = port.Pipeline(stages=[port.StandardScaler().setWithMean(True),
                                 port.PCA().setK(2)])
    pipe.save(str(tmp_path / "p"))
    back = port.Pipeline.load(str(tmp_path / "p"))
    assert [type(s).__name__ for s in back.getStages()] == ["StandardScaler", "PCA"]
    assert back.getStages()[0].getWithMean() and back.getStages()[1].getK() == 2
    ref = jax_pkg.Pipeline.load(str(tmp_path / "p"))
    assert [type(s).__module__ for s in ref.getStages()] == [
        "spark_rapids_ml_tpu.models.scaler", "spark_rapids_ml_tpu.models.pca"]
    with pytest.raises(FileExistsError):
        pipe.save(str(tmp_path / "p"))


def test_jax_saved_pipeline_loads_with_the_jax_package_unimportable(x, mesh8, f64, tmp_path):
    jp, _ = _pipelines(mesh8)
    fitted = jp.fit({"features": x})
    path = str(tmp_path / "pm")
    fitted.save(path)
    np.save(str(tmp_path / "x.npy"), x)
    want = fitted.stages[0].transform_matrix(x)["output"]
    np.save(str(tmp_path / "want.npy"), want)
    code = (
        "import sys; sys.modules['spark_rapids_ml_tpu'] = None\n"
        "import numpy as np\n"
        "from spark_rapids_ml_tpu_torch import PipelineModel, StandardScalerModel, PCAModel\n"
        f"m = PipelineModel.load({path!r})\n"
        "assert [type(s) for s in m.stages] == [StandardScalerModel, PCAModel], m.stages\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "assert np.array_equal(m.stages[0].transform_matrix(x)['output'], want)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] == 'jax' or "
        "(k.startswith('spark_rapids_ml_tpu') and not k.startswith('spark_rapids_ml_tpu_torch')"
        " and sys.modules[k] is not None)]\n"
        "assert not bad, bad\n"
        "print('ok', m.uid)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok", fitted.uid]


def test_an_unknown_jax_class_is_refused_and_never_imported(tmp_path, monkeypatch):
    port.StandardScalerModel(mean=np.zeros(2), std=np.ones(2)).save(str(tmp_path / "m"))
    meta = tmp_path / "m" / "metadata" / "part-00000"
    meta.write_text(meta.read_text().replace(
        "spark_rapids_ml_tpu.models.scaler.StandardScalerModel",
        "spark_rapids_ml_tpu.models.fancy.FancyModel"))
    import importlib

    real = importlib.import_module
    monkeypatch.setattr(importlib, "import_module",
                        lambda name, *a: pytest.fail(f"imported {name}") if name.startswith(
                            "spark_rapids_ml_tpu.") else real(name, *a))
    with pytest.raises(ValueError, match="FancyModel belongs to the JAX package"):
        DefaultParamsReader.load_instance(str(tmp_path / "m"))


def test_every_persisted_class_names_the_jax_class():
    from spark_rapids_ml_tpu_torch.core.persistence import _PERSISTED

    for name, cls in _PERSISTED.items():
        module, _, cls_name = name.rpartition(".")
        jax_cls = getattr(__import__(module, fromlist=[cls_name]), cls_name)
        assert jax_cls.__name__ == cls.__name__ == cls_name
    wanted = {"PCA", "PCAModel", "KMeans", "KMeansModel", "LinearRegression",
              "LinearRegressionModel", "LogisticRegression", "LogisticRegressionModel",
              "NearestNeighbors", "NearestNeighborsModel", "ApproximateNearestNeighbors",
              "ApproximateNearestNeighborsModel", "StandardScaler", "StandardScalerModel",
              "RandomForestClassifier", "RandomForestClassificationModel",
              "RandomForestRegressor", "RandomForestRegressionModel", "Pipeline",
              "PipelineModel", "CrossValidatorModel", "TrainValidationSplitModel"}
    assert {n.rpartition(".")[2] for n in _PERSISTED} == wanted


def test_convert_carries_a_jax_pipeline_stage_by_stage(x, mesh8, f64):
    jp, _ = _pipelines(mesh8)
    fitted = jp.fit({"features": x})
    carried = model_from_jax(fitted, device="cpu")
    assert isinstance(carried, port.PipelineModel) and carried.uid == fitted.uid
    assert [s.uid for s in carried.stages] == [s.uid for s in fitted.stages]
    got = carried.transform({"features": x})
    want = fitted.transform({"features": x})
    assert np.array_equal(got["scaled"], want["scaled"])
    np.testing.assert_allclose(got["pca_features"], want["pca_features"], rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------


def _scores(tied: bool):
    rng = np.random.default_rng(8)
    y = (rng.random(200) < 0.4).astype(np.float64)
    s = rng.normal(size=200) + y
    if tied:
        s = np.round(s * 2) / 2  # many equal scores
    return y, s


@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2"])
def test_regression_evaluator_equals_jax(metric):
    rng = np.random.default_rng(2)
    y = rng.normal(size=150)
    ds = {"label": y, "prediction": y + rng.normal(size=150) * 0.3}
    out = port.RegressionEvaluator().setMetricName(metric)
    ref = jax_pkg.RegressionEvaluator().setMetricName(metric)
    assert out.evaluate(ds) == ref.evaluate(ds)
    assert out.isLargerBetter() == ref.isLargerBetter() == (metric == "r2")
    t = {k: torch.from_numpy(v) for k, v in ds.items()}
    assert out.evaluate(t) == ref.evaluate(ds)  # tensor columns read alike


@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("column", ["vector", "scalar", "prediction"])
def test_binary_evaluator_equals_jax(metric, tied, column):
    y, s = _scores(tied)
    if column == "vector":
        ds = {"label": y, "rawPrediction": np.stack([-s, s], axis=1)}
    elif column == "scalar":
        ds = {"label": y, "rawPrediction": s}
    else:
        ds = {"label": y, "prediction": (s > 0.5).astype(np.float64)}
    out = port.BinaryClassificationEvaluator().setMetricName(metric)
    ref = jax_pkg.BinaryClassificationEvaluator().setMetricName(metric)
    assert out.evaluate(ds) == ref.evaluate(ds)
    assert out.evaluate(pd.DataFrame({k: list(v) for k, v in ds.items()})) == ref.evaluate(ds)


@pytest.mark.parametrize("metric", ["accuracy", "f1"])
def test_multiclass_evaluator_equals_jax(metric):
    rng = np.random.default_rng(6)
    y = rng.integers(0, 4, 300).astype(np.float64)
    p = np.where(rng.random(300) < 0.7, y, rng.integers(0, 5, 300)).astype(np.float64)
    ds = {"label": y, "prediction": p}
    out = port.MulticlassClassificationEvaluator().setMetricName(metric)
    ref = jax_pkg.MulticlassClassificationEvaluator().setMetricName(metric)
    assert out.evaluate(ds) == ref.evaluate(ds)


def test_evaluators_refuse_unknown_metrics_and_one_class():
    ds = {"label": np.ones(5), "prediction": np.ones(5), "rawPrediction": np.arange(5.0)}
    assert port.BinaryClassificationEvaluator().evaluate(ds) == 0.0
    for ev in (port.RegressionEvaluator(), port.BinaryClassificationEvaluator(),
               port.MulticlassClassificationEvaluator()):
        with pytest.raises(ValueError, match="unknown"):
            ev.setMetricName("nope").evaluate({"label": np.array([0.0, 1.0]),
                                               "prediction": np.array([0.0, 1.0]),
                                               "rawPrediction": np.array([0.2, 0.9])})


# ---------------------------------------------------------------------------
# Tuning
# ---------------------------------------------------------------------------


def _close_rel(a, b, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=0)


def test_param_grid_builder_matches_jax():
    lr = port.LinearRegression()
    grid = (port.ParamGridBuilder().baseOn({lr.fitIntercept: True})
            .addGrid(lr.regParam, [0.0, 0.1]).addGrid(lr.elasticNetParam, [0.0, 0.5]).build())
    assert [(m[lr.regParam], m[lr.elasticNetParam]) for m in grid] == [
        (0.0, 0.0), (0.0, 0.5), (0.1, 0.0), (0.1, 0.5)]
    assert all(m[lr.fitIntercept] for m in grid)
    with pytest.raises(TypeError, match="expects a Param"):
        port.ParamGridBuilder().addGrid("regParam", [1])


@pytest.mark.parametrize("metric", ["rmse", "r2"])
def test_cross_validator_matches_jax(mesh8, f64, metric):
    data = _reg_data()
    jlr = jax_pkg.LinearRegression(mesh=mesh8)
    plr = port.LinearRegression(device="cpu")
    jgrid = jax_pkg.ParamGridBuilder().addGrid(jlr.regParam, [0.0, 0.3, 3.0]).build()
    pgrid = port.ParamGridBuilder().addGrid(plr.regParam, [0.0, 0.3, 3.0]).build()
    ref = jax_pkg.CrossValidator(jlr, jgrid, jax_pkg.RegressionEvaluator().setMetricName(metric),
                                 numFolds=3, seed=7).fit(data)
    out = port.CrossValidator(plr, pgrid, port.RegressionEvaluator().setMetricName(metric),
                              numFolds=3, seed=7).fit(data)
    _close_rel(out.avgMetrics, ref.avgMetrics)
    best = int(np.argmax(ref.avgMetrics) if metric == "r2" else np.argmin(ref.avgMetrics))
    assert out.bestModel.getRegParam() == ref.bestModel.getRegParam() == [0.0, 0.3, 3.0][best]
    np.testing.assert_allclose(out.bestModel.coefficients, ref.bestModel.coefficients, atol=1e-9)
    assert out.uid == out.uid and isinstance(out, port.CrossValidatorModel)
    y = out.transform(data)["prediction"]
    np.testing.assert_allclose(y, ref.transform(data)["prediction"], atol=1e-9)


def test_train_validation_split_matches_jax(mesh8, f64):
    data = _bin_data()
    jlg = jax_pkg.LogisticRegression(mesh=mesh8)
    plg = port.LogisticRegression(device="cpu")
    jgrid = jax_pkg.ParamGridBuilder().addGrid(jlg.regParam, [0.0, 0.01, 0.5]).build()
    pgrid = port.ParamGridBuilder().addGrid(plg.regParam, [0.0, 0.01, 0.5]).build()
    ref = jax_pkg.TrainValidationSplit(jlg, jgrid, jax_pkg.BinaryClassificationEvaluator(),
                                       trainRatio=0.7, seed=5).fit(data)
    out = port.TrainValidationSplit(plg, pgrid, port.BinaryClassificationEvaluator(),
                                    trainRatio=0.7, seed=5).fit(data)
    _close_rel(out.validationMetrics, ref.validationMetrics)
    assert out.bestModel.getRegParam() == ref.bestModel.getRegParam()


def test_cross_validator_tunes_a_pipeline_stage(x, mesh8, f64):
    """A grid keyed on a stage's param reaches the stage through the
    Pipeline's copy (Spark's ParamMap semantics), in both packages."""
    rng = np.random.default_rng(9)
    y = x @ rng.normal(size=9) + rng.normal(size=301)
    data = {"features": x, "label": y}
    jsc, plr_j = jax_pkg.StandardScaler(mesh=mesh8), jax_pkg.LinearRegression(mesh=mesh8)
    psc, plr_p = port.StandardScaler(device="cpu"), port.LinearRegression(device="cpu")
    jpipe = jax_pkg.Pipeline(stages=[jsc, plr_j.setFeaturesCol("scaled_features")])
    ppipe = port.Pipeline(stages=[psc, plr_p.setFeaturesCol("scaled_features")])
    jgrid = jax_pkg.ParamGridBuilder().addGrid(plr_j.regParam, [0.0, 5.0]).addGrid(
        jsc.withMean, [False, True]).build()
    pgrid = port.ParamGridBuilder().addGrid(plr_p.regParam, [0.0, 5.0]).addGrid(
        psc.withMean, [False, True]).build()
    ref = jax_pkg.CrossValidator(jpipe, jgrid, jax_pkg.RegressionEvaluator(), seed=1).fit(data)
    out = port.CrossValidator(ppipe, pgrid, port.RegressionEvaluator(), seed=1).fit(data)
    _close_rel(out.avgMetrics, ref.avgMetrics)
    assert len(set(out.avgMetrics)) == 4  # every map reached its stage
    assert isinstance(out.bestModel, port.PipelineModel)


@pytest.mark.parametrize("kind", ["cv", "tvs"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_tuned_model_persistence_both_directions(mesh8, f64, tmp_path, kind, direction):
    data = _reg_data(n=90)
    pkg = port if direction == "port_to_jax" else jax_pkg
    other = jax_pkg if direction == "port_to_jax" else port
    lr = pkg.LinearRegression(device="cpu") if pkg is port else pkg.LinearRegression(mesh=mesh8)
    grid = pkg.ParamGridBuilder().addGrid(lr.regParam, [0.0, 1.0]).build()
    if kind == "cv":
        tuned = pkg.CrossValidator(lr, grid, pkg.RegressionEvaluator(), numFolds=2).fit(data)
        cls, attr = other.CrossValidatorModel, "avgMetrics"
    else:
        tuned = pkg.TrainValidationSplit(lr, grid, pkg.RegressionEvaluator()).fit(data)
        cls, attr = other.TrainValidationSplitModel, "validationMetrics"
    tuned.save(str(tmp_path / "t"))
    back = cls.load(str(tmp_path / "t"))
    assert back.uid == tuned.uid and getattr(back, attr) == getattr(tuned, attr)
    assert np.array_equal(back.bestModel.coefficients, tuned.bestModel.coefficients)
    assert type(back.bestModel).__module__.split(".")[0] == other.__name__
    with pytest.raises(FileExistsError):
        tuned.save(str(tmp_path / "t"))


def test_tuners_validate_their_arguments():
    data = _reg_data(n=20)
    lr, ev = port.LinearRegression(device="cpu"), port.RegressionEvaluator()
    with pytest.raises(ValueError, match="must both be set"):
        port.CrossValidator(lr).fit(data)
    with pytest.raises(ValueError, match="numFolds = 1"):
        port.CrossValidator(lr, evaluator=ev, numFolds=1).fit(data)
    with pytest.raises(ValueError, match="trainRatio = 1.0"):
        port.TrainValidationSplit(lr, evaluator=ev, trainRatio=1.0).fit(data)
    with pytest.raises(ValueError, match="no bestModel"):
        port.CrossValidatorModel().save("/nonexistent/never-written")


# ---------------------------------------------------------------------------
# Dataset helpers, namespaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dict", "pandas", "arrow", "matrix", "tensor"])
def test_take_rows_and_has_column_match_jax(kind):
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(12, 3)), rng.normal(size=12)
    idx = np.array([5, 0, 11, 5])
    if kind == "dict":
        ds = {"features": x, "label": y}
    elif kind == "pandas":
        ds = pd.DataFrame({"features": list(x), "label": y})
    elif kind == "arrow":
        ds = pa.table({"features": pa.array(list(x), pa.list_(pa.float64())), "label": y})
    else:
        ds = x
    got = port_dataset.take_rows(torch.from_numpy(x) if kind == "tensor" else ds, idx)
    if kind == "tensor":
        assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), x[idx])
        assert not port_dataset.has_column(got, "features")
        return
    want = jax_dataset.take_rows(ds, idx)
    assert type(got) is type(want)
    for col in ("features", "label"):
        assert port_dataset.has_column(ds, col) == jax_dataset.has_column(ds, col)
    assert port_dataset.has_column(ds, "nope") == jax_dataset.has_column(ds, "nope") is False
    if kind != "matrix":
        assert np.array_equal(port_dataset.as_matrix(got, "features"),
                              jax_dataset.as_matrix(want, "features"))
        assert np.array_equal(port_dataset.as_column(got, "label"), y[idx])
    else:
        assert np.array_equal(got, want)


def test_namespaces_mirror_the_jax_package():
    assert sorted(port.__all__) == sorted(set(jax_pkg.__all__) - {"__version__"})
    assert port_feature.__all__ == jax_feature.__all__
    for name in port_feature.__all__:
        assert getattr(port_feature, name) is getattr(port, name)
    assert {k: config.get(k) for k in ("forest_seed_sample_rows", "forest_hist_budget_mb")} == {
        k: jax_pkg.config.get(k) for k in ("forest_seed_sample_rows", "forest_hist_budget_mb")}
