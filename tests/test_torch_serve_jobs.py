"""The port daemon's iterative and labelled jobs against the JAX package's.

On the CPU (``device="cpu"``), in float64 on both sides (the JAX conftest's
x64 profile; the port's compute and accumulator dtypes set to float64), the
same numpy feeds made from a seed go to the port's daemon and to an
in-process JAX ``DataPlaneDaemon`` under ``jax_ledger_off()``:

* linreg, kmeans (k-means++ and random init), binomial and multinomial
  logreg, each over partitioned traffic with a retried attempt, a
  speculative duplicate, a replayed ``feed_id`` and a duplicate commit in
  every pass: the step infos (``moved2``, ``cost``, ``delta``, ``loss``,
  ``pass_rows``, ``iteration``) within 1e-9 relative and the finalize
  arrays within the tolerances of ``tests/test_serve.py`` (linreg 1e-6 and
  r2 1e-8, :73-84; kmeans centres 1e-3 and cost 1e-5 relative, binomial
  1e-5, :184-254; multinomial 1e-9, :344-379);
* the same jobs within 1e-6 of the port's own in-process stream fits of
  the same batches (``streaming_normal_eq_update`` with
  ``finalize_normal_eq_stats``, ``fit_kmeans_stream``,
  ``fit_logistic_stream``, ``fit_multinomial_stream``);
* the cross pairings: the port's client against the JAX daemon and the JAX
  client against the port's daemon;
* the reference's refusals (``tests/test_serve.py`` :123, :129, :255,
  :262, :271, :281, :380), the iterate shape checks, the creating
  ``set_iterate``, the ``step_id`` replay, the seed's idempotency and raw
  form, and the served kmeans, linreg and logreg predictions, equal to
  ``transform_matrix``;
* the device rule: the linreg fold reaches ``streaming_normal_eq_update``
  (one ``linreg_stats`` launch on the card) and the multinomial fold
  ``softmax_stats_update`` (one ``softmax_curvature`` launch) once per
  folded feed, never for a replay.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import kmeans as port_km
from spark_rapids_ml_tpu_torch.models import linear_regression as port_lr
from spark_rapids_ml_tpu_torch.models import logistic_regression as port_lg
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

N, D, C = 480, 8, 3
INFO_RTOL = 1e-9  # step infos: float64 on both sides
SELF_TOL = 1e-6  # the port's daemon against its own in-process stream fits
REG = 1e-2


@pytest.fixture(autouse=True)
def _f64_and_ledger_off():
    with jax_ledger_off(), config.option("compute_dtype", "float64"), \
            config.option("accum_dtype", "float64"):
        yield


@pytest.fixture
def daemon():
    with DataPlaneDaemon(device="cpu") as d:
        yield d


def _client(daemon, **kw):
    return DataPlaneClient(*daemon.address, **kw)


def _data():
    """Seeded rows and labels: linear targets, separable-with-noise binary
    labels, three classes, and four gaussian blobs for kmeans."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D))
    w = rng.normal(size=D)
    blobs = rng.normal(size=(4, D)) * 6
    xk = np.concatenate([c + 0.5 * rng.normal(size=(N // 4, D)) for c in blobs])
    return {
        "x": x,
        "y_lin": x @ w + 0.5 + 0.05 * rng.normal(size=N),
        "y_bin": (x @ w + 0.7 * rng.normal(size=N) > 0).astype(np.float64),
        "y_mc": np.argmax(x @ rng.normal(size=(D, C)) + 0.3 * rng.normal(size=(N, C)),
                          axis=1).astype(np.float64),
        "xk": xk[rng.permutation(N)],
    }


DATA = _data()

#: name → (algo, rows key, labels key, feed params, step params, passes)
JOBS = {
    "linreg": ("linreg", "x", "y_lin", {}, None, 1),
    "kmeans-k-means++": ("kmeans", "xk", None, {"k": 4, "seed": 3, "init": "k-means++"}, None, 4),
    "kmeans-random": ("kmeans", "xk", None, {"k": 4, "seed": 5, "init": "random"}, None, 4),
    "logreg-binomial": ("logreg", "x", "y_bin", {"n_classes": 2},
                        {"reg": REG, "fit_intercept": True}, 5),
    "logreg-multinomial": ("logreg", "x", "y_mc", {"n_classes": C},
                           {"reg": REG, "fit_intercept": True}, 5),
}


def _feed(c, job, algo, x, y, params, **kw):
    """One feed: the Arrow ``feed`` (an (x, y) pair when labelled)."""
    return c.feed(job, x if y is None else (x, y), algo=algo, params=params, **kw)


def _exactly_once_pass(c, job, algo, x, y, params, pass_id):
    """One pass of four partitions with every exactly-once case: partition
    0's attempt 0 feeds WRONG rows and is abandoned (a retried task);
    partition 1 runs a speculative duplicate (attempt 1) that commits after
    the original; partition 2's feed is replayed with its feed_id;
    partition 3's commit is sent twice. Returns the rows acked."""
    parts = np.array_split(np.arange(x.shape[0]), 4)
    sub = lambda i: (x[parts[i]], None if y is None else y[parts[i]])  # noqa: E731
    kw = {"pass_id": pass_id}
    x0, y0 = sub(0)
    _feed(c, job, algo, 3.0 * x0 + 1.0, y0, params, partition=0, attempt=0, **kw)
    _feed(c, job, algo, x0, y0, params, partition=0, attempt=1, **kw)
    c.commit(job, partition=0, attempt=1, pass_id=pass_id)
    x1, y1 = sub(1)
    for attempt in (0, 1):
        _feed(c, job, algo, x1, y1, params, partition=1, attempt=attempt, **kw)
    c.commit(job, partition=1, attempt=0, pass_id=pass_id)
    c.commit(job, partition=1, attempt=1, pass_id=pass_id)  # the late duplicate
    x2, y2 = sub(2)
    payload = c._to_ipc(x2 if y2 is None else (x2, y2), "features", "label")
    req = {"op": "feed", "job": job, "algo": algo, "params": params, "partition": 2,
           "attempt": 0, "pass_id": pass_id, "feed_id": f"replayed-{pass_id}"}
    c._roundtrip(dict(req), payload=payload)
    c._roundtrip(dict(req), payload=payload)  # the replay of a lost ack
    c.commit(job, partition=2, pass_id=pass_id)
    x3, y3 = sub(3)
    _feed(c, job, algo, x3, y3, params, partition=3, **kw)
    c.commit(job, partition=3, pass_id=pass_id)
    return c.commit(job, partition=3, pass_id=pass_id)  # duplicate commit


def _run_job(c, name):
    """The whole protocol of one job through client ``c``: kmeans seeded
    from the first 64 rows; ``passes`` scans, each stepped (kmeans then one
    unstepped scan for the cost); finalize. Returns (infos, arrays)."""
    algo, xkey, ykey, params, step_params, passes = JOBS[name]
    x, y = DATA[xkey], (None if ykey is None else DATA[ykey])
    job = f"j-{name}"
    infos = []
    if algo == "kmeans":
        c.seed_kmeans(job, x[:64], k=params["k"], params=params)
    if algo == "linreg":
        assert _exactly_once_pass(c, job, algo, x, y, params, None) == N
        return infos, c.finalize_linreg(job, reg=1e-6)
    for it in range(passes):
        assert _exactly_once_pass(c, job, algo, x, y, params, it) == N * (it + 1)
        infos.append(c.step(job, params=step_params))
    if algo == "kmeans":
        _exactly_once_pass(c, job, algo, x, y, params, passes)
        return infos, c.finalize_kmeans(job)
    return infos, c.finalize_logreg(job)


def _assert_infos_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["iteration"] == w["iteration"] and g["pass_rows"] == w["pass_rows"] == N
        for key in ("moved2", "cost", "delta", "loss"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=INFO_RTOL, atol=1e-12,
                                           err_msg=key)


def _assert_arrays_match_jax(name, out, ref):
    algo = JOBS[name][0]
    if algo == "linreg":  # tests/test_serve.py:73-84
        np.testing.assert_allclose(out["coefficients"], ref["coefficients"], atol=1e-6)
        np.testing.assert_allclose(out["intercept"], ref["intercept"], atol=1e-6)
        np.testing.assert_allclose(out["r2"], ref["r2"], atol=1e-8)
        np.testing.assert_allclose(out["rmse"], ref["rmse"], atol=1e-8)
    elif algo == "kmeans":  # :184-224, from the same seeded centres
        np.testing.assert_allclose(out["centers"], ref["centers"], atol=1e-3)
        np.testing.assert_allclose(out["cost"], ref["cost"], rtol=1e-5)
        assert int(out["n_iter"][0]) == int(ref["n_iter"][0])
    else:  # binomial :227-254 (1e-5); multinomial :344-379 (1e-9)
        tol = 1e-9 if JOBS[name][3]["n_classes"] > 2 else 1e-5
        assert out["coefficients"].shape == ref["coefficients"].shape
        np.testing.assert_allclose(out["coefficients"], ref["coefficients"], atol=tol)
        np.testing.assert_allclose(out["intercept"], ref["intercept"], atol=tol)
        assert int(out["n_iter"][0]) == int(ref["n_iter"][0])


@pytest.fixture(scope="module")
def jax_runs():
    """Every job through the JAX client and the in-process JAX daemon."""
    with jax_ledger_off(), JaxDaemon() as jd, JaxClient(*jd.address) as c:
        return {name: _run_job(c, name) for name in JOBS}


# ---------------------------------------------------------------------------
# Parity: the port's daemon against the JAX daemon, and its own stream fits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JOBS))
def test_job_matches_the_jax_daemon(name, daemon, jax_runs):
    with _client(daemon) as c:
        infos, out = _run_job(c, name)
    want_infos, ref = jax_runs[name]
    _assert_infos_equal(infos, want_infos)
    _assert_arrays_match_jax(name, out, ref)
    assert not daemon._jobs  # finalize dropped the job


def _batches(name):
    """The four partitions' (x[, y]) batches of the exactly-once pass."""
    _, xkey, ykey, *_ = JOBS[name]
    parts = np.array_split(np.arange(N), 4)
    x = DATA[xkey]
    if ykey is None:
        return [x[p] for p in parts]
    return [(x[p], DATA[ykey][p]) for p in parts]


@pytest.mark.parametrize("name", list(JOBS))
def test_float64_job_matches_the_ports_stream_fit(name, daemon):
    """Within 1e-6 of the port's in-process stream fit of the same batches
    (the kmeans stream seeded from the same 64 rows)."""
    algo, _, _, params, step_params, passes = JOBS[name]
    with _client(daemon) as c:
        _, out = _run_job(c, name)
    batches = _batches(name)
    if algo == "linreg":
        state = port_lr.init_normal_eq_stats(D, torch.float64, "cpu")
        for xb, yb in batches:
            port_lr.streaming_normal_eq_update(state, torch.from_numpy(xb),
                                               torch.from_numpy(yb))
        sol = port_lr.finalize_normal_eq_stats(state, 1e-6, 0.0, True, 500, 1e-6, N)
        np.testing.assert_allclose(out["coefficients"], sol.coefficients, atol=SELF_TOL)
        np.testing.assert_allclose(out["intercept"][0], sol.intercept, atol=SELF_TOL)
        np.testing.assert_allclose(out["r2"][0], sol.summary.r2, atol=SELF_TOL)
    elif algo == "kmeans":
        # The stream seeds from the head of its first scan: that scan is the
        # daemon's 64 seed rows; every later scan is the batches.
        head = {"first": True}

        def source():
            if head.pop("first", False):
                return iter([DATA["xk"][:64]])
            return iter(batches)

        sol = port_km.fit_kmeans_stream(
            source, k=params["k"], n_cols=D, max_iter=passes, tol=0.0, seed=params["seed"],
            init=params["init"], init_sample_rows=64, device="cpu")
        np.testing.assert_allclose(out["centers"], sol.centers, atol=SELF_TOL)
        np.testing.assert_allclose(out["cost"][0], sol.cost, rtol=SELF_TOL)
    elif params["n_classes"] > 2:
        sol = port_lg.fit_multinomial_stream(lambda: iter(batches), D, C, reg=REG,
                                             max_iter=passes, tol=0.0, device="cpu")
        np.testing.assert_allclose(out["coefficients"], sol.coefficients, atol=SELF_TOL)
        np.testing.assert_allclose(out["intercept"], sol.intercept, atol=SELF_TOL)
    else:
        sol = port_lg.fit_logistic_stream(lambda: iter(batches), D, reg=REG,
                                          max_iter=passes, tol=0.0, device="cpu")
        np.testing.assert_allclose(out["coefficients"], sol.coefficients, atol=SELF_TOL)
        np.testing.assert_allclose(out["intercept"][0], sol.intercept, atol=SELF_TOL)


@pytest.mark.parametrize("name", ["linreg", "kmeans-k-means++", "logreg-multinomial"])
@pytest.mark.parametrize("direction", ["port_client_jax_daemon", "jax_client_port_daemon"])
def test_cross_pairing(direction, name, jax_runs):
    """Either package's client drives the other's daemon through the whole
    protocol: the step infos and finalize arrays of the JAX pair."""
    if direction == "port_client_jax_daemon":
        server, make_client = JaxDaemon(), DataPlaneClient
    else:
        server, make_client = DataPlaneDaemon(device="cpu"), JaxClient
    with server, make_client(*server.address) as c:
        infos, out = _run_job(c, name)
    want_infos, ref = jax_runs[name]
    _assert_infos_equal(infos, want_infos)
    _assert_arrays_match_jax(name, out, ref)


def test_raw_seed_gives_the_arrow_seeds_centres(daemon):
    """``seed_kmeans_raw`` (raw frames, for a driver without Arrow) seeds
    the same centres as the Arrow ``seed``; a retried seed keeps the first
    centres and no seed folds a row."""
    params = JOBS["kmeans-k-means++"][3]
    x = DATA["xk"]
    with _client(daemon) as c:
        c.seed_kmeans("a", x[:64], k=4, params=params)
        c.seed_kmeans_raw("b", x[:64], k=4, params=params)
        c.seed_kmeans_raw("b", x[64:128], k=4, params=params)  # a retry: ignored
        ca, ita = c.get_iterate("a")
        cb, itb = c.get_iterate("b")
        assert c.status("b")["rows"] == 0 and ita == itb == 0
    np.testing.assert_array_equal(ca["centers"], cb["centers"])
    want = port_km._kmeans_plus_plus(x[:64], 4, np.random.default_rng(params["seed"]))
    np.testing.assert_array_equal(ca["centers"], want)


def test_unpartitioned_first_feed_seeds_the_centres(daemon):
    """Without a seed op, the first unpartitioned feed seeds the centres
    from its own rows (and folds them)."""
    x = DATA["xk"]
    with _client(daemon) as c:
        c.feed("u", x[:100], algo="kmeans", params={"k": 4, "seed": 9, "init": "random"})
        centers, _ = c.get_iterate("u")
        assert c.status("u")["pass_rows"] == 100
    want = port_km._random_init(x[:100], 4, np.random.default_rng(9))
    np.testing.assert_array_equal(centers["centers"], want)


# ---------------------------------------------------------------------------
# Refusals (tests/test_serve.py)
# ---------------------------------------------------------------------------


def test_linreg_missing_label_rejected(daemon):
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="label"):
            c.feed("lr2", DATA["x"], algo="linreg")
        with pytest.raises(RuntimeError, match="label"):
            c.feed_raw("lr2", DATA["x"], algo="linreg")
        with pytest.raises(RuntimeError, match="no such job"):
            c.status("lr2")


def test_algo_conflict_rejected(daemon):
    with _client(daemon) as c:
        c.feed("j", DATA["x"], algo="pca")
        with pytest.raises(RuntimeError, match="algo 'pca'"):
            c.feed("j", (DATA["x"], DATA["y_lin"]), algo="linreg")


def test_step_on_single_pass_job_rejected(daemon):
    with _client(daemon) as c:
        c.feed("job-p", DATA["x"][:64], algo="pca")
        with pytest.raises(RuntimeError, match="single-pass"):
            c.step("job-p")
        c.feed_raw("job-l", DATA["x"][:64], DATA["y_lin"][:64], algo="linreg")
        with pytest.raises(RuntimeError, match="single-pass"):
            c.step("job-l")


def test_step_with_empty_pass_rejected(daemon):
    # A duplicate or premature step must error, not corrupt the iterate.
    with _client(daemon) as c:
        c.feed("job-km2", DATA["xk"][:64], algo="kmeans", params={"k": 4})
        c.step("job-km2")  # the legitimate pass boundary
        with pytest.raises(RuntimeError, match="no rows fed"):
            c.step("job-km2")
        assert c.status("job-km2")["iteration"] == 1


def test_kmeans_first_batch_smaller_than_k_rejected_cleanly(daemon):
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="seeds the centers"):
            c.feed("job-km3", DATA["xk"][:3], algo="kmeans", params={"k": 8})
        assert not daemon._jobs  # no orphan job: a retry starts from scratch
        c.feed("job-km3", DATA["xk"][:64], algo="kmeans", params={"k": 8})
        assert c.step("job-km3")["iteration"] == 1


def test_partitioned_kmeans_feed_before_seed_rejected(daemon):
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="before centers are seeded"):
            c.feed("km-p", DATA["xk"][:64], algo="kmeans", params={"k": 4}, partition=0)
        assert not daemon._jobs
        with pytest.raises(RuntimeError, match="unknown init"):
            c.feed("km-i", DATA["xk"][:64], algo="kmeans", params={"k": 4, "init": "kmeans||"})
        with pytest.raises(RuntimeError, match="rows < k"):
            c.seed_kmeans_raw("km-s", DATA["xk"][:3], k=4)
        assert not daemon._jobs


def test_logreg_nonbinary_labels_rejected(daemon):
    y = np.random.default_rng(1).integers(0, 3, size=N).astype(np.float64)
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="binary"):
            c.feed("job-lr2", (DATA["x"], y), algo="logreg")
        with pytest.raises(RuntimeError, match=r"labels must be in \[0, 3\)"):
            c.feed_raw("job-lr3", DATA["x"], y + 1, algo="logreg", params={"n_classes": 3})
        with pytest.raises(RuntimeError, match="integers"):
            c.feed_raw("job-lr4", DATA["x"], y + 0.5, algo="logreg", params={"n_classes": 3})
    assert not daemon._jobs


def test_logreg_n_classes_mismatch_rejected(daemon):
    x, y = DATA["x"][:60], DATA["y_bin"][:60]
    with _client(daemon) as c:
        c.feed("cls-job", (x, y), algo="logreg", params={"n_classes": 3})
        with pytest.raises(RuntimeError, match="n_classes"):
            c.feed("cls-job", (x, y), algo="logreg", params={"n_classes": 4})


def test_stale_pass_id_is_fenced(daemon):
    """A zombie task of a stepped pass, and a task of a pass the daemon
    never opened, are both refused."""
    x, y = DATA["x"][:64], DATA["y_bin"][:64]
    with _client(daemon) as c:
        c.feed_raw("z", x, y, algo="logreg", partition=0, pass_id=0)
        c.commit("z", partition=0, pass_id=0)
        c.step("z", params={"reg": REG})
        with pytest.raises(RuntimeError, match="zombie"):
            c.feed_raw("z", x, y, algo="logreg", partition=1, pass_id=0)
        with pytest.raises(RuntimeError, match="behind the fit"):
            c.feed_raw("z", x, y, algo="logreg", partition=1, pass_id=5)
        assert c.status("z")["pass_rows"] == 0


# ---------------------------------------------------------------------------
# Iterates, the step_id replay, status
# ---------------------------------------------------------------------------


def _iterate_case(c, case):
    """A job in the shape ``case`` needs, and the bad iterate it refuses."""
    if case == "kmeans-centers":
        c.seed_kmeans_raw("it", DATA["xk"][:64], k=4)
        return {"centers": np.zeros((3, D))}, "centers shape"
    n_classes = 3 if case.startswith("multinomial") else 2
    c.feed_raw("it", DATA["x"][:16], DATA["y_mc" if n_classes > 2 else "y_bin"][:16],
               algo="logreg", params={"n_classes": n_classes})
    if case == "binomial-w":
        return {"w": np.zeros(D + 1), "b": np.zeros(1)}, "coefficients shape"
    if case == "binomial-b":
        return {"w": np.zeros(D), "b": np.zeros(2)}, "intercept length"
    return {"w": np.zeros((D, 2)), "b": np.zeros(3)}, "coefficients shape"


@pytest.mark.parametrize("case", ["kmeans-centers", "binomial-w", "binomial-b",
                                  "multinomial-w"])
def test_set_iterate_validates_the_iterate_shape(case, daemon):
    with _client(daemon) as c:
        bad, match = _iterate_case(c, case)
        before, it = c.get_iterate("it")
        with pytest.raises(RuntimeError, match=match):
            c.set_iterate("it", bad, 1)
        after, it2 = c.get_iterate("it")  # nothing was installed
        assert it == it2 == 0
        for key in before:
            np.testing.assert_array_equal(before[key], after[key])


def test_single_pass_jobs_have_no_iterate(daemon):
    with _client(daemon) as c:
        c.feed_raw("l", DATA["x"][:16], DATA["y_lin"][:16], algo="linreg")
        with pytest.raises(RuntimeError, match="single-pass"):
            c.get_iterate("l")
        with pytest.raises(RuntimeError, match="single-pass"):
            c.set_iterate("l", {"w": np.zeros(D), "b": np.zeros(1)}, 1)


def test_creating_set_iterate_recreates_a_lost_job(daemon):
    """The recovery path: an unknown job is created at the pushed iterate
    and pass, once the request carries n_cols/algo/params; without them it
    stays unknown, and a rejected iterate leaves no orphan job."""
    x, y = DATA["x"], DATA["y_mc"]
    iterate = {"w": 0.1 * np.ones((D, C)), "b": np.zeros(C)}
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="no such job"):
            c.set_iterate("r", iterate, 3)
        with pytest.raises(RuntimeError, match="coefficients shape"):
            c.set_iterate("r", {"w": np.ones((D, 2)), "b": np.zeros(C)}, 3, algo="logreg",
                          n_cols=D, params={"n_classes": C})
        assert not daemon._jobs
        c.set_iterate("r", iterate, 3, algo="logreg", params={"n_classes": C})  # width from w
        st = c.status("r")
        assert (st["algo"], st["n_cols"], st["iteration"], st["rows"]) == ("logreg", D, 3, 0)
        c.feed_raw("r", x, y, algo="logreg", params={"n_classes": C}, partition=0, pass_id=3)
        c.commit("r", partition=0, pass_id=3)
        info = c.step("r", params={"reg": REG})
    # The step from the installed iterate equals one from a fresh job that
    # reached it: the MM step of the same statistics.
    state = port_lg.stream_softmax_zero_state(D, C, torch.float64)
    w0, b0 = torch.from_numpy(iterate["w"]), torch.from_numpy(iterate["b"])
    port_lg.softmax_stats_update(state, w0, b0, torch.from_numpy(x), torch.from_numpy(y))
    _, _, delta = port_lg._softmax_step(state, w0, b0, REG, True)
    assert info["iteration"] == 4 and info["pass_rows"] == N
    np.testing.assert_allclose(info["delta"], float(delta), rtol=1e-12)


def test_step_id_replay_returns_the_cached_info(daemon):
    x, y = DATA["x"], DATA["y_bin"]
    with _client(daemon) as c:
        c.feed_raw("s", x, y, algo="logreg")
        req = {"op": "step", "job": "s", "params": {"reg": REG}, "step_id": "step-1"}
        first, _ = c._roundtrip(dict(req))
        w1, _ = c.get_iterate("s")
        again, _ = c._roundtrip(dict(req))  # the replay of a lost ack: no second step
        w2, it = c.get_iterate("s")
        assert it == 1 and again["iteration"] == first["iteration"] == 1
        assert again["delta"] == first["delta"]
        np.testing.assert_array_equal(w1["w"], w2["w"])


def test_client_step_heals_with_the_same_step_id(daemon, monkeypatch):
    """A connection that drops after the daemon stepped but before the ack
    arrived: the client replays with the step_id it minted once, and the
    job steps once."""
    from spark_rapids_ml_tpu_torch.serve import protocol

    with _client(daemon, backoff_base_s=0.001, backoff_max_s=0.002) as c:
        c.feed("h", DATA["xk"][:64], algo="kmeans", params={"k": 4})
        real = protocol.recv_json
        dropped = []

        def lose_first_step_ack(sock):
            resp = real(sock)
            if not dropped and resp is not None and "moved2" in resp:
                dropped.append(resp)
                raise ConnectionResetError("ack lost")
            return resp

        monkeypatch.setattr(protocol, "recv_json", lose_first_step_ack)
        info = c.step("h")
        monkeypatch.setattr(protocol, "recv_json", real)
        assert dropped and c.stats["replays"] == 1
        assert info["iteration"] == dropped[0]["iteration"] == 1
        assert c.status("h")["iteration"] == 1


def test_status_and_export_state_report_the_pass(daemon):
    x = DATA["xk"]
    with _client(daemon) as c:
        c.seed_kmeans_raw("st", x[:64], k=4)
        for p in range(2):
            c.feed_raw("st", x[p * 100:(p + 1) * 100], algo="kmeans", partition=p, pass_id=0)
        c.commit("st", partition=0, pass_id=0)  # partition 1 stays staged
        st = c.status("st")
        assert (st["rows"], st["pass_rows"], st["iteration"]) == (100, 100, 0)
        c.commit("st", partition=1, pass_id=0)
        c.step("st")
        arrays, meta = c.export_state("st")
        assert (meta["rows"], meta["pass_rows"], meta["iteration"]) == (200, 0, 1)
        assert meta["committed"] == {} and sorted(arrays) == ["s0", "s1", "s2"]
        assert float(arrays["s1"].sum()) == 0.0  # the next pass's state is zero


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _fitted(kind):
    x = DATA["x"]
    if kind == "kmeans":
        return "kmeans", port_km.KMeansModel(centers=DATA["xk"][:4], device="cpu")
    if kind == "linreg":
        sol = port_lr.fit_linear_regression(x, DATA["y_lin"], device="cpu")
        return "linreg", port_lr.LinearRegressionModel(sol.coefficients, sol.intercept,
                                                       device="cpu")
    y = DATA["y_bin"] if kind == "logreg-binomial" else DATA["y_mc"]
    sol = port_lg.fit_logistic_regression(x, y, reg=REG, max_iter=5, device="cpu")
    return "logreg", port_lg.LogisticRegressionModel(sol.coefficients, sol.intercept,
                                                     device="cpu")


@pytest.mark.parametrize("kind", ["kmeans", "linreg", "logreg-binomial", "logreg-multinomial"])
def test_served_predictions_equal_transform_matrix(kind, daemon):
    algo, model = _fitted(kind)
    assert model._serve_algo == algo
    q = DATA["x"][:100] if algo != "kmeans" else DATA["xk"][:100]
    with _client(daemon) as c:
        assert c.ensure_model("m", algo, model._model_data()) is True
        outs = c.transform("m", q)
        with pytest.raises(RuntimeError, match="algo"):
            c.ensure_model("m", "pca", model._model_data())
    want = model.transform_matrix(q)
    assert sorted(outs) == sorted(role for role, _, _ in model._serve_outputs)
    for role in outs:
        assert outs[role].dtype == want[role].dtype
        np.testing.assert_array_equal(outs[role], want[role])


def test_unported_algos_refused_without_a_job(daemon):
    """An algo neither daemon knows: refused as a job and as a served model,
    with nothing registered."""
    with _client(daemon) as c:
        for feed in (c.feed_raw, c.feed):
            with pytest.raises(RuntimeError, match="unknown algo 'svm'"):
                feed("u", DATA["x"], algo="svm")
        with pytest.raises(RuntimeError, match="unknown model algo 'svm'"):
            c.ensure_model("svm", "svm", {"bin_edges": np.zeros((D, 3)),
                                          "value": np.ones((2, 3, 2))})
        assert c.ping()
    assert not daemon._jobs and not daemon._models


# ---------------------------------------------------------------------------
# Device rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo, fold", [
    ("linreg", "streaming_normal_eq_update"),
    ("logreg", "softmax_stats_update"),
])
def test_fold_reaches_its_kernel_path_once_per_folded_feed(algo, fold, daemon, monkeypatch):
    mod = port_lr if algo == "linreg" else port_lg
    calls = []
    real = getattr(mod, fold)

    def counting(state, *args, **kw):
        calls.append(int(args[-1].shape[0]))
        return real(state, *args, **kw)

    monkeypatch.setattr(mod, fold, counting)
    y = DATA["y_lin"] if algo == "linreg" else DATA["y_mc"]
    params = {} if algo == "linreg" else {"n_classes": C}
    x = DATA["x"]
    with _client(daemon) as c:
        req = {"op": "feed_raw", "job": "cnt", "algo": algo, "params": params, "partition": 0,
               "feed_id": "f-1"}
        c._send_arrays_op(dict(req), {"x": x[:100], "y": y[:100]})
        c._send_arrays_op(dict(req), {"x": x[:100], "y": y[:100]})  # replay: no fold
        c.commit("cnt", partition=0)
        c.feed_raw("cnt", x[:100], y[:100], algo=algo, params=params, partition=0,
                   attempt=4)  # committed partition: no fold
        c.feed_raw("cnt", x[100:], y[100:], algo=algo, params=params)
        assert c.status("cnt")["rows"] == N
    assert calls == [100, N - 100]


@pytest.mark.parametrize("name, kernel", [
    ("linreg", "linreg_stats"),
    ("logreg-multinomial", "softmax_curvature"),
    ("logreg-binomial", None),
    ("kmeans-k-means++", None),
])
def test_each_fold_reaches_only_its_kernel(name, kernel, daemon, monkeypatch):
    """In the kernels' dtypes (float32 compute and accumulators), each
    folded feed calls its kernel's wrapper once (the plain version on a CPU
    tensor, the launch on the card) and no other; the kmeans and binomial
    folds call none, as the reference's daemon folds them without a
    kernel. Replays and committed-partition duplicates call nothing."""
    from spark_rapids_ml_tpu_torch.ops import kernels

    calls = {k: 0 for k in kernels.LAUNCHES}
    for k in calls:
        real = getattr(kernels, k)

        def counted(*a, _real=real, _k=k, **kw):
            calls[_k] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(kernels, k, counted)
    algo, xkey, ykey, params, step_params, _ = JOBS[name]
    x, y = DATA[xkey], (None if ykey is None else DATA[ykey])
    with config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"), \
            _client(daemon) as c:
        if algo == "kmeans":
            c.seed_kmeans_raw("k", x[:64], k=params["k"], params=params)
        _exactly_once_pass(c, "k", algo, x, y, params, None if algo == "linreg" else 0)
        assert c.status("k")["pass_rows"] == N
    folded = 6  # two attempts of partitions 0 and 1, one of 2 (not its replay) and of 3
    want = {k: (folded if k == kernel else 0) for k in calls}
    assert calls == want
