"""The port's histogram RandomForest (``ops/histogram.py``,
``models/random_forest.py``) against the JAX package, on the CPU.

Both packages get the same numpy inputs. The JAX side runs under
``jax_ledger_off()`` in the conftest's float64 profile, its fits padded over
the 8 CPU devices (the pad rows carry mask 0); the port runs on
``device="cpu"`` with float64 compute and accumulation.

Tolerances:

* bin edges and bin ids, ``_hash_u32`` and ``bootstrap_weights`` (at keys
  that include 0 and 2³² − 1), the feature-subset mask and the descent:
  equal;
* one histogram pass against the JAX ``hist_update_fn``: classification
  and integer-label regression bitwise (integer sums are exact in float64
  in any order), gaussian labels to 1e-12 relative;
* the split scorer: chosen (feature, bin) and the child and node stats
  equal, scores to 1e-12 relative;
* whole classifier and regressor fits: every table bitwise on integer
  labels; on gaussian labels features and thresholds equal, values to
  1e-12 relative;
* ``predict`` equal, ``predict_proba`` and the regression means to 1e-12;
* the capacity gate and the spec errors raise as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu as jax_pkg
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import random_forest as jax_rf
from spark_rapids_ml_tpu.ops import histogram as jax_hist
import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.convert import forest_model_from_jax
from spark_rapids_ml_tpu_torch.models import random_forest as port_rf
from spark_rapids_ml_tpu_torch.ops import histogram as port_hist
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

EDGE_KEYS = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B1, 0xFFFFFFFE, 0xFFFFFFFF],
                     np.uint32)


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


@pytest.fixture
def f64():
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        yield


def _keys(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE_KEYS, rng.integers(0, 1 << 32, n, dtype=np.uint64)
                           .astype(np.uint32)])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def data():
    """803 rows (ragged over 8 devices) x 7 features; a constant feature and
    a heavily tied one; labels: 3 classes, integer regression targets and
    gaussian ones, all driven by a few features."""
    rng = np.random.default_rng(21)
    n, d = 803, 7
    x = rng.normal(size=(n, d)) * np.linspace(0.5, 3.0, d)
    x[:, 5] = 1.25
    x[:, 6] = np.round(x[:, 6])
    z = x[:, 0] + 0.7 * x[:, 1] - 0.4 * x[:, 3]
    y_cls = np.digitize(z + 0.3 * rng.normal(size=n), [-1.0, 1.0]).astype(np.float64)
    y_int = np.round(10 * z + 3 * x[:, 2])
    y_gauss = 2.0 * z + 0.5 * x[:, 4] ** 2 + rng.normal(size=n)
    return x, {"cls": y_cls, "int": y_int, "gauss": y_gauss}


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_bins", [2, 16, 32, 256])
def test_bin_edges_and_bins_equal_jax(data, max_bins):
    x = data[0]
    edges = port_hist.quantile_bin_edges(x, max_bins)
    assert np.array_equal(edges, jax_hist.quantile_bin_edges(x, max_bins))
    want = np.asarray(jax_hist.bin_matrix(jnp.asarray(x), jnp.asarray(edges)))
    got = port_hist.bin_matrix(torch.from_numpy(x), torch.from_numpy(edges))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # In chunks as small as a row, and against searchsorted on sorted edges.
    old = port_hist.BIN_BUDGET
    try:
        port_hist.BIN_BUDGET = 1
        assert np.array_equal(port_hist.bin_matrix(torch.from_numpy(x),
                                                   torch.from_numpy(edges)).numpy(), want)
    finally:
        port_hist.BIN_BUDGET = old
    ss = torch.searchsorted(torch.from_numpy(edges), torch.from_numpy(x.T.copy()), right=False)
    assert np.array_equal(ss.T.numpy(), want)


def test_bin_edges_refuse_bad_inputs():
    with pytest.raises(ValueError, match="edge sample"):
        port_hist.quantile_bin_edges(np.zeros((0, 3)), 8)
    with pytest.raises(ValueError, match="max_bins = 257"):
        port_hist.quantile_bin_edges(np.zeros((4, 3)), 257)


def test_hash_u32_is_bitwise_jax():
    keys = _keys()
    want = np.asarray(jax_hist._hash_u32(jnp.asarray(keys))).astype(np.int64)
    got = port_hist._hash_u32(_t(keys))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF, -3])
def test_bootstrap_weights_are_bitwise_jax(seed):
    keys = _keys(seed=3)
    want = np.asarray(jax_hist.bootstrap_weights(jnp.asarray(keys), 5, seed))
    got = port_hist.bootstrap_weights(_t(keys), 5, seed)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert 0.9 < float(got.mean()) < 1.1 and float(got.max()) <= 6


@pytest.mark.parametrize("m", [1, 3, 7, 9])
@pytest.mark.parametrize("depth", [0, 3])
def test_feature_subset_mask_equals_jax(m, depth):
    w = 1 << depth
    want = np.asarray(jax_hist.feature_subset_mask(6, w, depth, 9, m, 11))
    got = port_hist.feature_subset_mask(6, w, depth, 9, m, 11)
    assert np.array_equal(got.numpy(), want)
    assert np.all(got.sum(-1).numpy() == min(m, 9))


def _grown_tables(x, y, depth, spec):
    """Node tables of an in-memory fit cut to ``depth`` levels (the port's,
    which ``test_whole_fit_tables_equal_jax`` holds to the JAX fit's)."""
    with config.option("accum_dtype", "float64"):
        sol = port_rf._fit_forest(x, y, spec.n_classes, spec.num_trees, depth, spec.max_bins,
                                  "all", spec.seed, spec.bootstrap, 1, "cpu")
    return sol.arrays


def test_descend_to_frontier_equals_jax(data):
    x, ys = data
    arrays = _grown_tables(x, ys["cls"], 4, port_rf.ForestSpec(4, 4, 16, 3, 7, 5, True, 1))
    edges = arrays["bin_edges"]
    bins = np.array(jax_hist.bin_matrix(jnp.asarray(x), jnp.asarray(edges)))
    for depth in range(5):
        wi, wa = jax_hist.descend_to_frontier(jnp.asarray(bins), jnp.asarray(arrays["feature"]),
                                              jnp.asarray(arrays["threshold"]), depth)
        gi, ga = port_hist.descend_to_frontier(torch.from_numpy(bins).to(torch.uint8),
                                               torch.from_numpy(arrays["feature"]),
                                               torch.from_numpy(arrays["threshold"]), depth)
        assert np.array_equal(gi.numpy(), np.asarray(wi)) and np.array_equal(ga.numpy(),
                                                                             np.asarray(wa))


def _jax_pass(mesh8, x, y, keys, tables, spec):
    depth = int(tables["depth"][0])
    update = jax_hist.hist_update_fn(mesh8, spec.num_trees, spec.max_bins, depth,
                                     spec.n_classes, spec.bootstrap, spec.seed, "float64")
    hist = jax_hist.zero_hist(spec.num_trees, depth, x.shape[1], spec.max_bins, spec.n_stats,
                              "float64")
    xs, ys, ms, ks = jax_rf._place_batch(x, y, np.ones(len(y), np.float32), keys, mesh8)
    out = update(hist, jnp.asarray(tables["bin_edges"]), jnp.asarray(tables["feature"]),
                 jnp.asarray(tables["threshold"]), xs, ys, ms, ks)
    return np.asarray(jax.device_get(out))


def _port_pass(x, y, keys, tables, spec, mask=None):
    depth = int(tables["depth"][0])
    hist = port_hist.zero_hist(spec.num_trees, depth, x.shape[1], spec.max_bins, spec.n_stats,
                               torch.float64, "cpu")
    bins = port_hist.bin_matrix(torch.from_numpy(x), torch.from_numpy(tables["bin_edges"]))
    return port_rf.accumulate_histogram(hist, tables, bins, torch.from_numpy(y), mask,
                                        _t(keys), spec)


@pytest.mark.parametrize("labels", ["cls", "int", "gauss"])
def test_histogram_passes_and_splits_equal_jax(data, mesh8, f64, labels):
    """Three level passes from the root: each pass's histogram against
    ``hist_update_fn``, the scorer's choice, then both grow steps."""
    x, ys = data
    y = ys[labels]
    spec = port_rf.forest_spec_from_params(
        {"num_trees": 3, "max_depth": 4, "max_bins": 16, "seed": 9,
         "n_classes": 3 if labels == "cls" else 0, "subset": "sqrt"}, x.shape[1])
    keys = port_rf.row_identity_keys(4, 100, x.shape[0])
    edges = port_hist.quantile_bin_edges(x, spec.max_bins)
    jt = jax_rf.init_forest_arrays(spec, edges)
    pt = port_rf.init_forest_arrays(spec, edges)
    old = port_hist.KEY_BUDGET
    port_hist.KEY_BUDGET = 3 * 7 * 100  # several row chunks per pass
    try:
        for depth in range(3):
            hj = _jax_pass(mesh8, x, y, keys, jt, spec)
            hp = _port_pass(x, y, keys, pt, spec)
            if labels == "gauss":
                np.testing.assert_allclose(hp.numpy(), hj, rtol=1e-12, atol=1e-9)
            else:
                assert np.array_equal(hp.numpy(), hj)
            sj = jax_hist.best_splits_fn(spec.num_trees, depth, spec.n_classes, spec.subset_m,
                                         spec.seed, 1, "float64")(jnp.asarray(hj))
            sp = port_hist.best_splits(torch.tensor(hj), depth, spec.n_classes,
                                       spec.subset_m, spec.seed, 1)
            sj = [np.asarray(a) for a in sj]
            fin = np.isfinite(sj[0])
            assert np.array_equal(np.isfinite(sp[0].numpy()), fin)
            np.testing.assert_allclose(sp[0].numpy()[fin], sj[0][fin], rtol=1e-12, atol=1e-12)
            for got, want in zip(sp[1:], sj[1:]):
                assert np.array_equal(got.numpy(), want)
            info_j = jax_rf.grow_level(jt, jnp.asarray(hj), spec)
            info_p = port_rf.grow_level(pt, hp, spec)
            assert info_p == info_j
            for k in jt:
                if labels == "gauss" and k == "value":
                    np.testing.assert_allclose(pt[k], jt[k], rtol=1e-12, atol=1e-9)
                else:
                    assert np.array_equal(pt[k], jt[k]), k
    finally:
        port_hist.KEY_BUDGET = old


def test_a_masked_row_adds_nothing(data, f64):
    x, ys = data
    spec = port_rf.forest_spec_from_params({"num_trees": 2, "n_classes": 3}, x.shape[1])
    tables = port_rf.init_forest_arrays(spec, port_hist.quantile_bin_edges(x, 32))
    keys = port_rf.row_identity_keys(None, 0, x.shape[0])
    mask = torch.ones(x.shape[0], dtype=torch.float64)
    mask[::3] = 0
    h = _port_pass(x, ys["cls"], keys, tables, spec, mask=mask)
    keep = mask.numpy() > 0
    h2 = _port_pass(x[keep], ys["cls"][keep], keys[keep], tables, spec)
    assert np.array_equal(h.numpy(), h2.numpy())


# ---------------------------------------------------------------------------
# Whole fits, predict, persistence
# ---------------------------------------------------------------------------


FIT_CASES = {
    "classifier": ("cls", dict(num_trees=5, max_depth=4, max_bins=16, seed=3)),
    "classifier-nobag": ("cls", dict(num_trees=3, max_depth=3, max_bins=8, seed=1,
                                     bootstrap=False, feature_subset="all")),
    "regressor-int": ("int", dict(num_trees=5, max_depth=4, max_bins=16, seed=3)),
    "regressor-int-minrows": ("int", dict(num_trees=4, max_depth=5, max_bins=32, seed=2,
                                          min_instances=20, feature_subset="0.5")),
    "regressor-gauss": ("gauss", dict(num_trees=4, max_depth=4, max_bins=16, seed=3)),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_whole_fit_tables_equal_jax(data, mesh8, f64, case):
    x, ys = data
    labels, kw = FIT_CASES[case]
    if labels == "cls":
        ref = jax_rf.fit_random_forest_classifier(x, ys[labels], mesh=mesh8, **kw)
        out = port_rf.fit_random_forest_classifier(x, ys[labels], device="cpu", **kw)
    else:
        ref = jax_rf.fit_random_forest_regressor(x, ys[labels], mesh=mesh8, **kw)
        out = port_rf.fit_random_forest_regressor(x, ys[labels], device="cpu", **kw)
    assert (out.n_classes, out.n_rows, out.n_passes) == (ref.n_classes, ref.n_rows, ref.n_passes)
    assert sorted(out.arrays) == sorted(ref.arrays)
    for k in ref.arrays:
        if labels == "gauss" and k == "value":
            np.testing.assert_allclose(out.arrays[k], ref.arrays[k], rtol=1e-12, atol=1e-9)
        else:
            assert np.array_equal(out.arrays[k], ref.arrays[k]), k
    assert np.sum(out.arrays["feature"] >= 0) > out.arrays["feature"].shape[0]  # trees grew


def test_estimators_predict_like_jax(data, mesh8, f64, tmp_path):
    x, ys = data
    ds_c = {"features": x, "label": ys["cls"]}
    ds_r = {"features": x, "label": ys["int"]}
    jc = jax_pkg.RandomForestClassifier(mesh=mesh8).setNumTrees(6).setMaxDepth(4).setSeed(4)
    pc = port.RandomForestClassifier(device="cpu").setNumTrees(6).setMaxDepth(4).setSeed(4)
    jr = jax_pkg.RandomForestRegressor(mesh=mesh8).setNumTrees(6).setMaxDepth(4).setSeed(4)
    pr = port.RandomForestRegressor(device="cpu").setNumTrees(6).setMaxDepth(4).setSeed(4)
    mjc, mpc, mjr, mpr = jc.fit(ds_c), pc.fit(ds_c), jr.fit(ds_r), pr.fit(ds_r)
    assert isinstance(mpc, port.RandomForestClassificationModel) and mpc.uid == pc.uid
    assert (mpc.numClasses, mpc.getNumTrees(), mpc.totalNumNodes) == (
        mjc.numClasses, mjc.getNumTrees(), mjc.totalNumNodes)
    assert (mpr.numClasses, mpr.totalNumNodes) == (0, mjr.totalNumNodes)
    q = np.random.default_rng(5).normal(size=(97, 7)) * 2
    assert np.array_equal(mpc.predict(q), np.asarray(mjc.predict(q)))
    np.testing.assert_allclose(mpc.predict_proba(q), mjc.predict_proba(q), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(mpr.predict(q), mjr.predict(q), rtol=1e-12)
    np.testing.assert_allclose(mpc.predict_proba(q).sum(1), 1.0, rtol=1e-12)
    out = mpr.transform({"features": q})
    assert set(out) == {"features", "prediction"}
    got = mpc.transform_matrix(torch.from_numpy(q))["prediction"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert np.array_equal(got.numpy(), mjc.transform_matrix(q)["prediction"])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("role", ["classifier", "regressor"])
def test_forest_persistence_both_directions(data, mesh8, f64, tmp_path, direction, role):
    x, ys = data
    ds = {"features": x, "label": ys["cls" if role == "classifier" else "int"]}
    name = "RandomForestClassifier" if role == "classifier" else "RandomForestRegressor"
    model_name = ("RandomForestClassificationModel" if role == "classifier"
                  else "RandomForestRegressionModel")
    if direction == "port_to_jax":
        fitted = getattr(port, name)(device="cpu").setNumTrees(3).setMaxBins(8).fit(ds)
        fitted.save(str(tmp_path / "m"))
        back = getattr(jax_pkg, model_name).load(str(tmp_path / "m"))
    else:
        fitted = getattr(jax_pkg, name)(mesh=mesh8).setNumTrees(3).setMaxBins(8).fit(ds)
        fitted.save(str(tmp_path / "m"))
        back = getattr(port, model_name).load(str(tmp_path / "m"))
        back._device = "cpu"
        assert isinstance(back, getattr(port, model_name))
    assert back.uid == fitted.uid and back.getMaxBins() == 8 and back.getNumTrees() == 3
    for k in fitted.arrays:
        assert np.array_equal(np.asarray(back.arrays[k], np.float64),
                              np.asarray(fitted.arrays[k], np.float64)), k
    got, want = np.asarray(back.predict(x)), np.asarray(fitted.predict(x))
    if role == "classifier":
        assert np.array_equal(got, want)
    else:  # the mean over trees may sum in another order
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # The estimator's params round-trip too.
    est = getattr(port, name)().setMaxDepth(3).setFeatureSubsetStrategy("log2")
    est.save(str(tmp_path / "e"))
    loaded = getattr(jax_pkg, name).load(str(tmp_path / "e"))
    assert (loaded.getMaxDepth(), loaded.getFeatureSubsetStrategy()) == (3, "log2")


def test_convert_carries_a_jax_forest(data, mesh8, f64):
    x, ys = data
    ref = jax_pkg.RandomForestClassifier(mesh=mesh8).setNumTrees(4).setMaxDepth(3).fit(
        {"features": x, "label": ys["cls"]})
    model = forest_model_from_jax(ref._model_data(), device="cpu")
    assert isinstance(model, port.RandomForestClassificationModel) and model.numClasses == 3
    assert np.array_equal(model.predict(x), np.asarray(ref.predict(x)))
    reg = jax_pkg.RandomForestRegressor(mesh=mesh8).setNumTrees(2).setMaxDepth(2).fit(
        {"features": x, "label": ys["int"]})
    assert isinstance(forest_model_from_jax(reg._model_data()), port.RandomForestRegressionModel)


def test_float32_fit_on_the_cpu_route(data):
    """The default float32 accumulation: the classifier's integer counts
    stay exact, so its tables equal the float64 fit's."""
    x, ys = data
    kw = dict(num_trees=4, max_depth=4, max_bins=16, seed=3, device="cpu")
    f32 = port_rf.fit_random_forest_classifier(x, ys["cls"], **kw)
    with config.option("accum_dtype", "float64"):
        f64_ = port_rf.fit_random_forest_classifier(x.astype(np.float32), ys["cls"], **kw)
    for k in ("feature", "threshold", "value"):
        assert np.array_equal(f32.arrays[k], f64_.arrays[k]), k


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params, match", [
    ({"num_trees": 0}, "num_trees = 0"),
    ({"max_depth": 0}, "max_depth = 0 out of range"),
    ({"max_depth": 17}, "max_depth = 17 out of range"),
    ({"max_bins": 1}, "max_bins = 1 out of range"),
    ({"n_classes": 1}, "n_classes = 1 must be"),
    ({"min_instances": 0}, "min_instances = 0"),
    ({"subset": "most"}, "unknown featureSubsetStrategy"),
    ({"subset": "1.5"}, "must be a strategy name"),
])
def test_spec_errors_match_jax(params, match):
    for mod in (port_rf, jax_rf):
        with pytest.raises(ValueError, match=match):
            mod.forest_spec_from_params(params, 10)


@pytest.mark.parametrize("strategy", ["auto", "all", "sqrt", "onethird", "log2", "3", "0.25"])
def test_subset_size_equals_jax(strategy):
    for d in (1, 7, 28, 90):
        for clf in (True, False):
            assert port_rf.subset_size(strategy, d, clf) == jax_rf.subset_size(strategy, d, clf)


def test_capacity_gate_and_label_checks(data, f64):
    x, ys = data
    spec = port_rf.forest_spec_from_params({"num_trees": 20, "max_depth": 10}, 90)
    with config.option("forest_hist_budget_mb", 2):
        port_rf.require_hist_capacity(spec, 0, 90)
        with pytest.raises(port_rf.ForestCapacityError, match="exceeds forest_hist_budget_mb"):
            port_rf.require_hist_capacity(spec, 6, 90)
        with jax_config.option("forest_hist_budget_mb", 2), \
                jax_config.option("accum_dtype", "float64"):
            with pytest.raises(jax_rf.ForestCapacityError):
                jax_rf.require_hist_capacity(spec, 6, 90)
    with config.option("forest_hist_budget_mb", 0):
        port_rf.require_hist_capacity(spec, 10, 90)  # 0 = unbounded
    with pytest.raises(ValueError, match="classifier labels must be integers"):
        port_rf.fit_random_forest_classifier(x, ys["cls"] + 0.5, device="cpu")
    with pytest.raises(ValueError, match="labels length"):
        port_rf.fit_random_forest_regressor(x, ys["int"][:-1], device="cpu")
    with pytest.raises(RuntimeError, match="no trees"):
        port.RandomForestRegressionModel().predict(x)


def test_forest_entry_points_raise_without_a_card(data, monkeypatch):
    x, ys = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.RandomForestClassifier().fit({"features": x, "label": ys["cls"]})
    model = port.RandomForestClassifier(device="cpu").setNumTrees(2).fit(
        {"features": x, "label": ys["cls"]})
    model._device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.predict(x)


def test_validate_and_open_frontier_match_jax(data):
    x, ys = data
    spec = port_rf.forest_spec_from_params({"num_trees": 2, "max_depth": 3, "max_bins": 8}, 7)
    arrays = port_rf.init_forest_arrays(spec, port_hist.quantile_bin_edges(x, 8))
    assert port_rf.open_frontier_nodes(arrays["feature"], 0) == 2
    assert port_rf.open_frontier_nodes(arrays["feature"], 5) == 0
    out = port_rf.validate_forest_arrays(arrays, spec, 7)
    assert all(np.array_equal(out[k], arrays[k]) for k in arrays)
    bad = dict(arrays, value=np.zeros((2, 15, 2)))
    for mod in (port_rf, jax_rf):
        with pytest.raises(ValueError, match="'value' shape"):
            mod.validate_forest_arrays(bad, spec, 7)
    assert np.array_equal(port_rf.row_identity_keys(3, 7, 5), jax_rf.row_identity_keys(3, 7, 5))
