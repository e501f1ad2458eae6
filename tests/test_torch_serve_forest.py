"""The port daemon's rf job and served forests against the JAX package's.

On the CPU (``device="cpu"``), in float64 on both sides (both packages'
compute and accumulator dtypes set to float64, so both bin the rows and
sum the histograms in float64), the same numpy feeds made from a seed go to the port's daemon and to an
in-process JAX ``DataPlaneDaemon`` under ``jax_ledger_off()``. Labels are
three classes and integer regression targets, so every histogram sum is an
integer, exact in float64 in any order, and the comparisons are bitwise:

* op by op, for the classifier and the regressor: the creating
  ``set_iterate``, then per depth four partitions fed in two frames each
  (an abandoned attempt with other rows, a speculative duplicate, a
  replayed ``feed_id``, a duplicate commit), ``export_state``'s ``s0``,
  ``step``, ``get_iterate``; the step infos equal, the histograms, the
  tables and the finalize arrays bitwise; in both cross pairings too;
* exactly-once: that traffic gives the clean fit's forest; an attempt
  that dies after one frame and is replayed, a fold that fails and is
  resent, and a replayed ``feed_id`` before a partition's next frame all
  key their bags as the clean fit does;
* the direct-feed fit bitwise equal to the port's in-process
  ``fit_random_forest_classifier`` and ``fit_random_forest_regressor``;
* the refusals (a feed before the iterate, without labels, with bad
  classifier labels, with another ``n_classes``; a step, ``get_iterate``
  or finalize before the iterate; an empty pass; a depth over
  ``forest_hist_budget_mb`` at the pass boundary), each leaving no job
  where the reference leaves none; a grown-out forest's empty pass state;
* the served ``rf_classifier`` and ``rf_regressor`` bitwise equal to
  ``transform_matrix``, and to the JAX daemon's served transform (the
  classes bitwise; the regression means, summed over the trees in another
  order, to 1e-12 relative, as ``tests/test_torch_forest.py`` holds
  them).
"""

import contextlib

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import random_forest as port_rf
from spark_rapids_ml_tpu_torch.ops import histogram as port_hist
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import daemon as port_daemon
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

N, D, C = 480, 6, 3
PARTS, FRAMES = 4, 2
SAMPLE = 256  # the driver's prefix sample of the bin edges


def _f64():
    """Both packages' compute and accumulator dtypes at float64, the JAX
    ledger off."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax_ledger_off())
    for cfg in (jax_config, config):
        stack.enter_context(cfg.option("compute_dtype", "float64"))
        stack.enter_context(cfg.option("accum_dtype", "float64"))
    return stack


@pytest.fixture(autouse=True)
def _f64_and_ledger_off():
    with _f64():
        yield


@pytest.fixture
def daemon():
    with DataPlaneDaemon(device="cpu") as d:
        yield d


def _data():
    """Seeded rows (a tied feature among them), three classes and integer
    regression targets driven by a few features."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(N, D)) * np.linspace(0.5, 2.5, D)
    x[:, 4] = np.round(x[:, 4])
    z = x[:, 0] + 0.8 * x[:, 1] - 0.5 * x[:, 3]
    return {
        "x": x,
        "cls": np.digitize(z + 0.3 * rng.normal(size=N), [-1.0, 1.0]).astype(np.float64),
        "int": np.round(10 * z + 3 * x[:, 2]),
    }


DATA = _data()

#: name → (labels key, feed params)
JOBS = {
    "classifier": ("cls", {"num_trees": 4, "max_depth": 3, "max_bins": 8, "n_classes": C,
                           "subset": "auto", "seed": 5, "bootstrap": True, "min_instances": 1}),
    "regressor": ("int", {"num_trees": 3, "max_depth": 4, "max_bins": 16, "n_classes": 0,
                          "subset": "onethird", "seed": 9, "bootstrap": True,
                          "min_instances": 2}),
}


def _client(daemon, **kw):
    return DataPlaneClient(*daemon.address, **kw)


def _init_arrays(params, x=None):
    """The driver's depth-0 iterate: the sample's quantile edges, every
    root open."""
    x = DATA["x"] if x is None else x
    spec = port_rf.forest_spec_from_params(params, x.shape[1])
    return port_rf.init_forest_arrays(spec, port_hist.quantile_bin_edges(x[:SAMPLE],
                                                                         spec.max_bins))


def _frames(x, y):
    """Partition p's frames: PARTS row blocks in order, FRAMES frames each."""
    return [[(xf, yf) for xf, yf in zip(np.array_split(xp, FRAMES), np.array_split(yp, FRAMES))]
            for xp, yp in zip(np.array_split(x, PARTS), np.array_split(y, PARTS))]


def _raw(c, job, frame, params, feed_id=None, **kw):
    """One feed_raw of an (x, y) frame, with an explicit feed_id when given."""
    if feed_id is None:
        return c.feed_raw(job, frame[0], frame[1], algo="rf", params=params, **kw)
    req = {"op": "feed_raw", "job": job, "algo": "rf", "params": params, "feed_id": feed_id,
           "attempt": 0, **kw}
    return c._send_arrays_op(req, {"x": frame[0], "y": frame[1]})


def _clean_pass(c, job, parts, params, pass_id):
    """Every partition's frames once, then its commit; the job's rows."""
    rows = 0
    for p, frames in enumerate(parts):
        for fr in frames:
            _raw(c, job, fr, params, partition=p, pass_id=pass_id)
        rows = c.commit(job, partition=p, pass_id=pass_id)
    return rows


def _exactly_once_pass(c, job, parts, params, pass_id):
    """Partition 0's attempt 0 feeds OTHER rows and is abandoned; partition
    1 runs a speculative duplicate that commits after the original;
    partition 2's first frame is replayed with its feed_id before its
    second; partition 3's commit is sent twice."""
    kw = {"pass_id": pass_id}
    for fr in parts[0]:
        _raw(c, job, (3.0 * fr[0] + 1.0, fr[1]), params, partition=0, attempt=0, **kw)
    for fr in parts[0]:
        _raw(c, job, fr, params, partition=0, attempt=1, **kw)
    c.commit(job, partition=0, attempt=1, pass_id=pass_id)
    for attempt in (0, 1):
        for fr in parts[1]:
            _raw(c, job, fr, params, partition=1, attempt=attempt, **kw)
    c.commit(job, partition=1, attempt=0, pass_id=pass_id)
    c.commit(job, partition=1, attempt=1, pass_id=pass_id)
    first, second = parts[2]
    _raw(c, job, first, params, feed_id=f"f2-{pass_id}", partition=2, **kw)
    _raw(c, job, first, params, feed_id=f"f2-{pass_id}", partition=2, **kw)  # a lost ack
    _raw(c, job, second, params, partition=2, **kw)
    c.commit(job, partition=2, pass_id=pass_id)
    for fr in parts[3]:
        _raw(c, job, fr, params, partition=3, **kw)
    c.commit(job, partition=3, pass_id=pass_id)
    return c.commit(job, partition=3, pass_id=pass_id)


def _run_forest(c, name, traffic=_exactly_once_pass):
    """The whole rf protocol through client ``c``: the creating set_iterate,
    then per depth a pass of ``traffic``, the committed state, the step
    and the iterate, until no node is open; then finalize. Returns
    (per-pass records, finalize arrays)."""
    ykey, params = JOBS[name]
    x, y = DATA["x"], DATA[ykey]
    job = f"rf-{name}"
    c.set_iterate(job, _init_arrays(params), 0, algo="rf", n_cols=D, params=params)
    parts = _frames(x, y)
    records = []
    for it in range(params["max_depth"] + 1):
        assert traffic(c, job, parts, params, it) == N * (it + 1)
        state, meta = c.export_state(job)
        info = c.step(job)
        iterate, iteration = c.get_iterate(job)
        assert iteration == it + 1 and meta["pass_rows"] == N
        records.append({"state": state, "info": {k: info[k] for k in
                                                 ("iteration", "depth", "open_nodes", "splits",
                                                  "pass_rows")},
                        "iterate": iterate})
        if info["open_nodes"] == 0:
            break
    out, rows = c.finalize(job, {})
    assert rows == N * len(records)
    return records, out


def _assert_runs_equal(got, want):
    g_recs, g_out = got
    w_recs, w_out = want
    assert [r["info"] for r in g_recs] == [r["info"] for r in w_recs]
    for g, w in zip(g_recs, w_recs):
        assert sorted(g["state"]) == sorted(w["state"]) == ["s0"]
        assert g["state"]["s0"].dtype == w["state"]["s0"].dtype == np.float64
        np.testing.assert_array_equal(g["state"]["s0"], w["state"]["s0"])
        assert sorted(g["iterate"]) == sorted(w["iterate"])
        for k in w["iterate"]:
            np.testing.assert_array_equal(g["iterate"][k], w["iterate"][k], err_msg=k)
    assert sorted(g_out) == sorted(w_out)
    for k in w_out:
        assert g_out[k].dtype == w_out[k].dtype, k
        np.testing.assert_array_equal(g_out[k], w_out[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_runs():
    """Both forests through the JAX client and the in-process JAX daemon."""
    with _f64(), JaxDaemon() as jd, JaxClient(*jd.address) as c:
        return {name: _run_forest(c, name) for name in JOBS}


# ---------------------------------------------------------------------------
# Op by op against the JAX daemon, and the cross pairings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JOBS))
def test_forest_job_matches_the_jax_daemon_op_by_op(name, daemon, jax_runs):
    with _client(daemon) as c:
        run = _run_forest(c, name)
    _assert_runs_equal(run, jax_runs[name])
    recs, out = run
    assert int(out["n_iter"][0]) == len(recs) and int(out["n_classes"][0]) == JOBS[name][1][
        "n_classes"]
    assert recs[-1]["info"]["open_nodes"] == 0 and recs[0]["info"]["splits"] > 0
    assert not daemon._jobs  # finalize dropped the job


@pytest.mark.parametrize("name", list(JOBS))
@pytest.mark.parametrize("direction", ["port_client_jax_daemon", "jax_client_port_daemon"])
def test_forest_cross_pairing(direction, name, jax_runs):
    if direction == "port_client_jax_daemon":
        server, make_client = JaxDaemon(), DataPlaneClient
    else:
        server, make_client = DataPlaneDaemon(device="cpu"), JaxClient
    with server, make_client(*server.address) as c:
        run = _run_forest(c, name)
    _assert_runs_equal(run, jax_runs[name])


# ---------------------------------------------------------------------------
# Exactly-once and the bag offsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JOBS))
def test_exactly_once_traffic_gives_the_clean_forest(name, daemon, jax_runs):
    with _client(daemon) as c:
        clean = _run_forest(c, name, traffic=_clean_pass)
    _assert_runs_equal(clean, jax_runs[name])


def test_bag_offsets_survive_replays_and_a_failed_fold(daemon, jax_runs, monkeypatch):
    """An attempt replayed from its start, a fold that fails (its offset
    not advanced) and is resent, and a replayed feed_id (no offset moved)
    all give the clean fit's histograms, tables and forest."""
    fail_once = []
    real = port_rf.accumulate_histogram

    def flaky(*a, **kw):
        if fail_once:
            fail_once.clear()
            raise RuntimeError("injected fold failure")
        return real(*a, **kw)

    monkeypatch.setattr(port_rf, "accumulate_histogram", flaky)
    name = "classifier"
    _, params = JOBS[name]

    def traffic(c, job, parts, params, pass_id):
        kw = {"pass_id": pass_id}
        _raw(c, job, parts[0][0], params, partition=0, attempt=0, **kw)
        for fr in parts[0]:
            _raw(c, job, fr, params, partition=0, attempt=1, **kw)
        c.commit(job, partition=0, attempt=1, pass_id=pass_id)
        assert not daemon._jobs[job].staged  # the dead attempt's stage freed at the commit
        _raw(c, job, parts[1][0], params, partition=1, **kw)
        fail_once.append(True)
        with pytest.raises(RuntimeError, match="injected fold failure"):
            _raw(c, job, parts[1][1], params, feed_id=f"f1-{pass_id}", partition=1, **kw)
        _raw(c, job, parts[1][1], params, feed_id=f"f1-{pass_id}", partition=1, **kw)
        c.commit(job, partition=1, pass_id=pass_id)
        _raw(c, job, parts[2][0], params, feed_id=f"f2-{pass_id}", partition=2, **kw)
        _raw(c, job, parts[2][0], params, feed_id=f"f2-{pass_id}", partition=2, **kw)
        _raw(c, job, parts[2][1], params, partition=2, **kw)
        c.commit(job, partition=2, pass_id=pass_id)
        for fr in parts[3]:
            _raw(c, job, fr, params, partition=3, **kw)
        return c.commit(job, partition=3, pass_id=pass_id)

    with _client(daemon) as c:
        run = _run_forest(c, name, traffic=traffic)
    _assert_runs_equal(run, jax_runs[name])


def test_staged_bytes_count_the_frontier_histogram(daemon):
    """A stage holds one whole frontier histogram; staged_bytes counts it
    and the partition's commit frees every attempt's."""
    _, params = JOBS["classifier"]
    parts = _frames(DATA["x"], DATA["cls"])
    with _client(daemon) as c:
        c.set_iterate("sb", _init_arrays(params), 0, algo="rf", n_cols=D, params=params)
        for attempt in (0, 1):
            _raw(c, "sb", parts[0][0], params, partition=0, attempt=attempt, pass_id=0)
        job = daemon._jobs["sb"]
        one = params["num_trees"] * 1 * D * params["max_bins"] * C * 8
        assert job.staged_bytes == 2 * one
        c.commit("sb", partition=0, attempt=1, pass_id=0)
        assert job.staged_bytes == 0 and not job.staged


# ---------------------------------------------------------------------------
# Direct feeds against the in-process fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JOBS))
def test_direct_feed_fit_equals_the_in_process_fit(name, daemon):
    """Unpartitioned feeds key their bags as partition 0 at the pass's row
    offset: the in-process fit's keys, so the forests are bitwise equal."""
    ykey, params = JOBS[name]
    x, y = DATA["x"], DATA[ykey]
    arrays = _init_arrays(params, x)
    with _client(daemon) as c:
        c.set_iterate("d", arrays, 0, algo="rf", n_cols=D, params=params)
        for it in range(params["max_depth"] + 1):
            for xf, yf in zip(np.array_split(x, 5), np.array_split(y, 5)):
                c.feed_raw("d", xf, yf, algo="rf", params=params, pass_id=it)
            if c.step("d")["open_nodes"] == 0:
                break
        out, _ = c.finalize("d", {})
    kw = {k: params[k] for k in ("num_trees", "max_depth", "max_bins", "seed", "bootstrap")}
    kw.update(feature_subset=params["subset"], min_instances=params["min_instances"],
              device="cpu")
    with config.option("forest_seed_sample_rows", SAMPLE):
        if params["n_classes"]:
            sol = port_rf.fit_random_forest_classifier(x, y, n_classes=C, **kw)
        else:
            sol = port_rf.fit_random_forest_regressor(x, y, **kw)
    assert int(out.pop("n_iter")[0]) == sol.n_passes
    assert sorted(out) == sorted(sol.arrays)
    for k in sol.arrays:
        np.testing.assert_array_equal(out[k], sol.arrays[k], err_msg=k)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_feed_before_the_iterate_is_refused_without_a_job(daemon):
    _, params = JOBS["classifier"]
    with _client(daemon) as c:
        for partition in (None, 0):
            with pytest.raises(RuntimeError, match="before the forest iterate is installed"):
                c.feed_raw("nf", DATA["x"], DATA["cls"], algo="rf", params=params,
                           partition=partition)
        with pytest.raises(RuntimeError, match="before the forest iterate is installed"):
            c.feed("nf", (DATA["x"], DATA["cls"]), algo="rf", params=params)
    assert not daemon._jobs


def test_feed_without_labels_is_refused(daemon):
    _, params = JOBS["regressor"]
    with _client(daemon) as c:
        c.set_iterate("nl", _init_arrays(params), 0, algo="rf", n_cols=D, params=params)
        with pytest.raises(RuntimeError, match="rf feed needs a label"):
            c.feed_raw("nl", DATA["x"], algo="rf", params=params)
        with pytest.raises(RuntimeError, match="label"):
            c.feed("nl", DATA["x"], algo="rf", params=params)
        assert c.status("nl")["rows"] == 0


def test_bad_classifier_labels_are_refused_before_a_job_registers(daemon):
    _, params = JOBS["classifier"]
    x, y = DATA["x"], DATA["cls"]
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match=r"labels must be in \[0, 3\)"):
            c.feed_raw("bl", x, y + 1, algo="rf", params=params)
        with pytest.raises(RuntimeError, match="integers"):
            c.feed_raw("bl", x, y + 0.5, algo="rf", params=params)
    assert not daemon._jobs


def test_n_classes_mismatch_is_refused(daemon):
    _, params = JOBS["classifier"]
    x, y = DATA["x"][:64], DATA["cls"][:64]
    with _client(daemon) as c:
        c.set_iterate("m", _init_arrays(params), 0, algo="rf", n_cols=D, params=params)
        for n_classes in (4, 0):
            with pytest.raises(RuntimeError, match="has n_classes=3; feed carried"):
                c.feed_raw("m", x, y, algo="rf", params={**params, "n_classes": n_classes})
        assert c.status("m")["rows"] == 0


def test_step_get_iterate_and_finalize_before_the_iterate_are_refused():
    job = port_daemon._Job("rf", D, torch.device("cpu"), JOBS["classifier"][1])
    assert job.state == () and job.rf_tables is None
    with pytest.raises(ValueError, match="step before the forest iterate is installed"):
        job.step({})
    with pytest.raises(ValueError, match="no iterate yet \\(set_iterate first\\)"):
        job.get_iterate()
    with pytest.raises(ValueError, match="finalize before any feed: no forest iterate"):
        job.finalize({})


def test_empty_pass_step_is_refused(daemon):
    _, params = JOBS["classifier"]
    with _client(daemon) as c:
        c.set_iterate("e", _init_arrays(params), 0, algo="rf", n_cols=D, params=params)
        with pytest.raises(RuntimeError, match="no rows fed"):
            c.step("e")
        assert c.status("e")["iteration"] == 0


def test_bad_iterate_shape_is_refused(daemon):
    _, params = JOBS["classifier"]
    bad = _init_arrays(params)
    bad["value"] = bad["value"][:, :, :2]
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="array 'value' shape"):
            c.set_iterate("bi", bad, 0, algo="rf", n_cols=D, params=params)
    assert not daemon._jobs


def _capacity_params():
    """16 trees x 16 features x 64 bins x 3 classes in float64: 0.375 MiB a
    node, so depths 0 and 1 fit 1 MiB and depth 2 does not."""
    return {"num_trees": 16, "max_depth": 4, "max_bins": 64, "n_classes": C, "subset": "all",
            "seed": 2, "bootstrap": False, "min_instances": 1}


def test_capacity_error_at_the_pass_boundary(daemon):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(400, 16))
    y = (np.digitize(x[:, 0], [-0.5, 0.5])).astype(np.float64)
    params = _capacity_params()
    with config.option("forest_hist_budget_mb", 1), _client(daemon) as c:
        c.set_iterate("cap", _init_arrays(params, x), 0, algo="rf", n_cols=16, params=params)
        for it in range(2):
            c.feed_raw("cap", x, y, algo="rf", params=params, partition=0, pass_id=it)
            c.commit("cap", partition=0, pass_id=it)
            if it == 0:
                assert c.step("cap")["open_nodes"] > 0
        with pytest.raises(RuntimeError, match="depth-2 frontier histogram.*forest_hist_budget_mb"):
            c.step("cap")
        # A creating set_iterate whose depth is over the budget is refused at
        # that boundary and registers nothing.
        deep = _init_arrays(params, x)
        deep["feature"][:, 0] = port_hist.LEAF
        deep["feature"][:, 3] = port_hist.OPEN
        deep["depth"] = np.asarray([2], np.int64)
        with pytest.raises(RuntimeError, match="ForestCapacityError|forest_hist_budget_mb"):
            c.set_iterate("cap2", deep, 2, algo="rf", n_cols=16, params=params)
    assert "cap2" not in daemon._jobs
    with pytest.raises(port_rf.ForestCapacityError):
        with config.option("forest_hist_budget_mb", 1):
            port_daemon._Job("rf", 16, torch.device("cpu"), {**params, "max_bins": 256})


def test_grown_out_forest_holds_no_pass_state(daemon):
    _, params = JOBS["classifier"]
    x, y = DATA["x"], DATA["cls"]
    with _client(daemon) as c:
        c.set_iterate("g", _init_arrays(params), 0, algo="rf", n_cols=D, params=params)
        for it in range(params["max_depth"] + 1):
            c.feed_raw("g", x, y, algo="rf", params=params, pass_id=it)
            info = c.step("g")
            if info["open_nodes"] == 0:
                break
        job = daemon._jobs["g"]
        assert job.state == () and job._zero_state() == ()
        arrays, meta = c.export_state("g")
        assert arrays == {} and meta["pass_rows"] == 0
        with pytest.raises(RuntimeError, match="grew out"):
            c.feed_raw("g", x, y, algo="rf", params=params, pass_id=info["iteration"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _fitted(role):
    ykey, params = JOBS["classifier" if role == "rf_classifier" else "regressor"]
    x, y = DATA["x"], DATA[ykey]
    cls = (port_rf.RandomForestClassifier if role == "rf_classifier"
           else port_rf.RandomForestRegressor)
    est = cls(device="cpu").setNumTrees(params["num_trees"]).setMaxDepth(params["max_depth"]) \
        .setMaxBins(params["max_bins"]).setSeed(params["seed"])
    return est.fit({"features": x, "label": y})


@pytest.mark.parametrize("role", ["rf_classifier", "rf_regressor"])
def test_served_forest_equals_transform_matrix_and_the_jax_daemon(role, daemon):
    model = _fitted(role)
    assert model._serve_algo == role
    q = DATA["x"][::3]
    with _client(daemon) as c:
        assert c.ensure_model("m", role, model._model_data()) is True
        outs = c.transform("m", q)
        with pytest.raises(RuntimeError, match="width 5 != the forest's 6"):
            c.transform("m", q[:, :5])
        with pytest.raises(RuntimeError, match="algo"):
            c.ensure_model("m", "pca", model._model_data())
    want = model.transform_matrix(q)
    assert sorted(outs) == sorted(want) == ["prediction"]
    assert outs["prediction"].dtype == want["prediction"].dtype == np.float64
    np.testing.assert_array_equal(outs["prediction"], want["prediction"])
    with JaxDaemon() as jd, JaxClient(*jd.address) as jc:
        jc.ensure_model("m", role, model._model_data())
        ref = jc.transform("m", q)
    if role == "rf_classifier":
        np.testing.assert_array_equal(outs["prediction"], np.asarray(ref["prediction"]))
    else:  # the mean over the trees sums in another order (tests/test_torch_forest.py)
        np.testing.assert_allclose(outs["prediction"], np.asarray(ref["prediction"]),
                                   rtol=1e-12, atol=0)
