"""The PyTorch port's data plane (serve/) against the JAX package's.

On the CPU (``device="cpu"``), in float64 on both sides (the JAX conftest's
x64 profile; the port's compute and accumulator dtypes set to float64):

* cross-package: a JAX client against the port's daemon, and the port's
  client against an in-process JAX daemon, fit the same PCA (absTol 1e-5,
  sign-invariant, σ/Σσ equal within it, PCASuite.scala:80-87) and
  transform alike, over partitioned feeds with a retried attempt, a
  speculative duplicate, a replayed ``feed_id`` and a duplicate commit;
* a JAX-fitted model registered in the port's daemon serves the JAX
  daemon's transform;
* the daemon's contracts, ported as cases from the PCA tests of
  ``tests/test_serve.py`` and ``tests/test_serve_reliability.py`` (batch-fit
  tolerances as there: components 1e-8, means 1e-10);
* the device rule: the fold reaches ``ops/gram.streaming_update_rows``
  once per folded feed and never for a replay (the card's own fit through
  the daemon is ``tests/test_torch_package.py``'s, which imports no JAX).
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.ops import gram as port_gram
from spark_rapids_ml_tpu_torch.serve import DaemonBusy, DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import protocol
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

ABS_TOL = 1e-5  # PCASuite.scala:87


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


@pytest.fixture
def data():
    """480 x 16 rows with a decaying spectrum (test_serve_reliability.py's)."""
    rng = np.random.default_rng(11)
    n, d = 480, 16
    basis = rng.normal(size=(d, d)) * np.logspace(0, -1.5, d)
    return rng.normal(size=(n, d)) @ basis + rng.normal(size=d)


def _batch_fit(data, k=3):
    return port_pca.fit_pca(data, k, device="cpu")


def _assert_matches_batch_fit(out, data, k=3):
    ref = _batch_fit(data, k)
    np.testing.assert_allclose(np.abs(out["pc"]), np.abs(ref.pc), atol=1e-8)
    np.testing.assert_allclose(out["mean"], ref.mean, atol=1e-10)
    np.testing.assert_allclose(out["explained_variance"], ref.explained_variance, atol=1e-10)


# ---------------------------------------------------------------------------
# Cross-package: a JAX client against the port's daemon, and back
# ---------------------------------------------------------------------------


def _exactly_once_traffic(client, data):
    """Four partitions fed over the wire, with every exactly-once case:
    partition 0's attempt 0 feeds WRONG rows and is abandoned (a retried
    task); partition 1 runs a speculative duplicate (attempt 1) that
    commits after the original; partition 2's feed is replayed with its
    feed_id; partition 3's commit is sent twice. Returns the rows acked."""
    parts = np.array_split(data, 4)
    client.feed("xp", np.full_like(parts[0], 1e3), algo="pca", partition=0, attempt=0)
    client.feed("xp", parts[0], algo="pca", partition=0, attempt=1)
    client.commit("xp", partition=0, attempt=1)
    for attempt in (0, 1):
        client.feed("xp", parts[1], algo="pca", partition=1, attempt=attempt)
    client.commit("xp", partition=1, attempt=0)
    client.commit("xp", partition=1, attempt=1)  # the late duplicate: discarded
    payload = client._to_ipc(parts[2], "features", "label") if isinstance(client, JaxClient) \
        else client._to_ipc(parts[2], "features")
    req = {"op": "feed", "job": "xp", "algo": "pca", "partition": 2, "attempt": 0,
           "feed_id": "replayed-1"}
    client._roundtrip(dict(req), payload=payload)
    client._roundtrip(dict(req), payload=payload)  # the replay of a lost ack
    client.commit("xp", partition=2)
    client.feed("xp", parts[3], algo="pca", partition=3)
    client.commit("xp", partition=3)
    return client.commit("xp", partition=3)  # duplicate commit


def _assert_same_fit_as_jax(out, data, mesh8, k=3):
    ref = jax_pca.fit_pca(data, k, mesh=mesh8)
    np.testing.assert_allclose(np.abs(out["pc"]), np.abs(ref.pc), atol=ABS_TOL)
    np.testing.assert_allclose(out["explained_variance"], ref.explained_variance, atol=ABS_TOL)
    np.testing.assert_allclose(out["mean"], ref.mean, atol=ABS_TOL)
    np.testing.assert_allclose(out["sigma"], ref.sigma, rtol=1e-7, atol=1e-7)
    return ref


@pytest.mark.parametrize("direction", ["jax_client_port_daemon", "port_client_jax_daemon"])
def test_cross_package_fit_and_transform(direction, data, mesh8):
    k = 3
    if direction == "jax_client_port_daemon":
        server, make_client = DataPlaneDaemon(device="cpu"), JaxClient
    else:
        server, make_client = JaxDaemon(mesh=mesh8), DataPlaneClient
    with server, make_client(*server.address) as c:
        assert c.ping()
        assert _exactly_once_traffic(c, data) == data.shape[0]
        assert c.status("xp")["rows"] == data.shape[0]
        out = c.finalize_pca("xp", k=k)
        ref = _assert_same_fit_as_jax(out, data, mesh8, k)
        model = {"pc": out["pc"], "explainedVariance": out["explained_variance"],
                 "mean": out["mean"]}
        assert c.ensure_model("srv", "pca", model) is True
        y = c.transform("srv", data[:100])["output"]
    np.testing.assert_allclose(np.abs(y), np.abs(data[:100] @ ref.pc), atol=ABS_TOL)


def test_jax_fitted_weights_served_by_the_port(data, mesh8):
    """A JAX-fitted model registered in the port's daemon through
    ensure_model(_model_data()) transforms as the JAX daemon does with the
    same arrays."""
    from spark_rapids_ml_tpu.models.pca import PCA as JaxPCA

    model = JaxPCA(mesh=mesh8).setK(3).fit({"features": data})
    outs = []
    for server in (JaxDaemon(mesh=mesh8), DataPlaneDaemon(device="cpu")):
        with server, DataPlaneClient(*server.address) as c:
            assert c.ensure_model("jx", "pca", model._model_data())
            outs.append(c.transform("jx", data[:64])["output"])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(outs[1], model.transform_matrix(data[:64])["output"], atol=1e-12)


# ---------------------------------------------------------------------------
# Contracts (tests/test_serve.py, PCA)
# ---------------------------------------------------------------------------


def test_pca_concurrent_executors_match_batch_fit(daemon, data):
    errs = []

    def executor(part):
        try:
            with _client(daemon) as c:
                for sub in np.array_split(part, 2):  # repeat feeds on one connection
                    c.feed("job-pca", sub, algo="pca")
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=executor, args=(p,)) for p in np.array_split(data, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    with _client(daemon) as c:
        assert c.status("job-pca")["rows"] == data.shape[0]
        _assert_matches_batch_fit(c.finalize_pca("job-pca", k=4), data, k=4)


def test_finalize_drops_job_by_default(daemon, data):
    with _client(daemon) as c:
        c.feed_raw("ephemeral", data)
        c.finalize_pca("ephemeral", k=2)
        with pytest.raises(RuntimeError, match="no such job"):
            c.status("ephemeral")


def test_two_jobs_interleave(daemon, data):
    a, b = data[:300], data[300:]
    with _client(daemon) as c:
        c.feed("a", a)
        c.feed_raw("b", b)
        c.feed("a", a)
        assert c.status("a")["rows"] == 2 * a.shape[0]
        assert c.status("b")["rows"] == b.shape[0]
        assert c.drop("a")
        assert not c.drop("a")  # already gone


def test_feed_width_mismatch_rejected(daemon, data):
    with _client(daemon) as c:
        c.feed("w", data)
        with pytest.raises(RuntimeError, match="width"):
            c.feed("w", data[:, :10])
        assert c.status("w")["rows"] == data.shape[0]  # the connection lives on


def test_unknown_op_and_unknown_job(daemon):
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="unknown op"):
            c._roundtrip({"op": "nope"})
        with pytest.raises(RuntimeError, match="no such job"):
            c.status("never-created")


def test_straggler_fold_after_finalize_rejected(daemon, data):
    """A task holding the OLD job object (grabbed before finalize popped it)
    errors on fold instead of losing its rows into a returned model."""
    with _client(daemon) as c:
        c.feed("s", data)
        straggler_job = daemon._jobs["s"]
        c.finalize_pca("s", k=2)
    with pytest.raises(KeyError, match="finalized"):
        straggler_job.fold(data)


def test_finalize_k_out_of_range(daemon, data):
    with _client(daemon) as c:
        c.feed("kk", data)
        with pytest.raises(RuntimeError, match="out of range"):
            c.finalize_pca("kk", k=data.shape[1] + 1)


def test_result_arrays_writable(daemon, data):
    with _client(daemon) as c:
        c.feed("wr", data)
        out = c.finalize_pca("wr", k=2)
    out["pc"] *= -1.0  # callers own the result


def test_model_serving_roundtrip(daemon, data):
    """ensure_model/transform/drop_model: the served copy reproduces the
    model's transform, stays registered across calls, and refuses
    transforms after drop."""
    model = port_pca.PCA(device="cpu").setK(3).fit({"features": data})
    with _client(daemon) as c:
        assert c.ensure_model("srv", "pca", model._model_data()) is True
        assert c.ensure_model("srv", "pca", model._model_data()) is False  # first wins
        assert c.model_exists("srv")
        outs = c.transform("srv", data[:100])
        np.testing.assert_array_equal(outs["output"],
                                      model.transform_matrix(data[:100])["output"])
        assert c.transform("srv", data[100:350])["output"].shape == (250, 3)
        assert c.drop_model("srv") is True
        assert not c.model_exists("srv")
        with pytest.raises(RuntimeError, match="no such model"):
            c.transform("srv", data[:10])


def test_model_cap_evicts_least_recently_used(data):
    clk = {"t": 0.0}
    model = port_pca.PCA(device="cpu").setK(2).fit({"features": data})._model_data()
    with DataPlaneDaemon(device="cpu", max_models=2, clock=lambda: clk["t"]) as d:
        with _client(d) as c:
            for i, name in enumerate(("m0", "m1", "m2")):
                clk["t"] = float(i)
                c.ensure_model(name, "pca", model)
            assert not c.model_exists("m0") and c.model_exists("m1") and c.model_exists("m2")


# ---------------------------------------------------------------------------
# Contracts (tests/test_serve_reliability.py, PCA)
# ---------------------------------------------------------------------------


def _partitioned_feed_commit(c, data):
    def task(pid, part):
        with DataPlaneClient(*c._addr) as tc:
            for sub in np.array_split(part, 2):
                tc.feed("j", sub, algo="pca", partition=pid)
            tc.commit("j", partition=pid)

    threads = [threading.Thread(target=task, args=(i, p))
               for i, p in enumerate(np.array_split(data, 4))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def _uncommitted_stage(c, data):
    """A task that fed its stage but died before commit contributes nothing."""
    parts = np.array_split(data, 3)
    c.feed("j", np.full_like(parts[0], 1e6), algo="pca", partition=0, attempt=0)
    c.feed("j", parts[0], algo="pca", partition=0, attempt=1)
    c.commit("j", partition=0, attempt=1)
    for pid, part in enumerate(parts[1:], start=1):
        c.feed("j", part, algo="pca", partition=pid)
        c.commit("j", partition=pid)


def _duplicate_feed_and_commit(c, data):
    """A speculative duplicate of a committed task does not double-count."""
    parts = np.array_split(data, 2)
    c.feed("j", parts[0], algo="pca", partition=0)
    c.commit("j", partition=0)
    c.feed("j", parts[0], algo="pca", partition=0, attempt=0)
    c.feed("j", parts[0], algo="pca", partition=0, attempt=7)
    c.commit("j", partition=0, attempt=7)
    c.feed_raw("j", parts[1], partition=1)
    c.commit("j", partition=1)


def _concurrent_speculative_attempts(c, data):
    """Interleaved feeds of two live attempts accumulate apart; the first to
    commit wins with its COMPLETE data, the loser is discarded."""
    parts = np.array_split(data, 2)
    sub = np.array_split(parts[0], 2)
    c.feed("j", sub[0], algo="pca", partition=0, attempt=0)
    c.feed("j", sub[0], algo="pca", partition=0, attempt=1)
    c.feed("j", sub[1], algo="pca", partition=0, attempt=0)
    c.feed("j", sub[1], algo="pca", partition=0, attempt=1)
    c.commit("j", partition=0, attempt=0)
    c.commit("j", partition=0, attempt=1)
    c.feed("j", parts[1], algo="pca", partition=1)
    c.commit("j", partition=1)


def _feed_replay_same_feed_id(c, data):
    """Lost-ack replay: the same feed_id folds at most once per stage."""
    parts = np.array_split(data, 2)
    payload = c._to_ipc(parts[0], "features")
    req = {"op": "feed", "job": "j", "algo": "pca", "partition": 0, "attempt": 0,
           "feed_id": "dup-1"}
    c._roundtrip(dict(req), payload=payload)
    c._roundtrip(dict(req), payload=payload)
    c.commit("j", partition=0)
    c.feed("j", parts[1], algo="pca", partition=1)
    c.commit("j", partition=1)


def _unpartitioned_feed_replay(c, data):
    """Direct feeds fold at once; their replay dedupe is the job's memory."""
    payload = c._to_ipc(data, "features")
    req = {"op": "feed", "job": "j", "algo": "pca", "feed_id": "u-1"}
    assert c._roundtrip(dict(req), payload=payload)[0]["rows"] == data.shape[0]
    assert c._roundtrip(dict(req), payload=payload)[0]["rows"] == data.shape[0]


@pytest.mark.parametrize("traffic", [
    _partitioned_feed_commit, _uncommitted_stage, _duplicate_feed_and_commit,
    _concurrent_speculative_attempts, _feed_replay_same_feed_id, _unpartitioned_feed_replay,
], ids=lambda f: f.__name__.strip("_"))
def test_exactly_once_traffic_matches_batch_fit(daemon, data, traffic):
    with _client(daemon) as c:
        traffic(c, data)
        assert c.status("j")["rows"] == data.shape[0]
        _assert_matches_batch_fit(c.finalize_pca("j", k=3), data)


def test_commit_without_stage_rejected(daemon, data):
    with _client(daemon) as c:
        c.feed("j", data, algo="pca", partition=0)
        with pytest.raises(RuntimeError, match="no staged feed"):
            c.commit("j", partition=3)


def test_commit_attempt_mismatch_rejected(daemon, data):
    with _client(daemon) as c:
        c.feed("j", data, algo="pca", partition=0, attempt=2)
        with pytest.raises(RuntimeError, match="attempt"):
            c.commit("j", partition=0, attempt=1)
        # the stage survives a bad commit; the right attempt still lands
        assert c.commit("j", partition=0, attempt=2) == data.shape[0]


def _spec_count_capped(sock):
    x = np.zeros((4, 4), np.float32)
    protocol.send_arrays(sock, {f"a{i}": x for i in range(17)},
                         {"v": 1, "op": "feed_raw", "job": "caps", "algo": "pca"})
    return "array frames"


def _declared_bytes_capped(sock):
    protocol.send_json(sock, {"v": 1, "op": "feed_raw", "job": "caps2", "algo": "pca",
                              "arrays": [{"name": "x", "dtype": "float32",
                                          "shape": [1 << 20, 1 << 10]}]})  # 4 GB declared
    protocol.send_frame(sock, b"tiny")
    return "MAX_FRAME"


def _frame_size_must_match_spec(sock):
    protocol.send_json(sock, {"v": 1, "op": "feed_raw", "job": "caps3", "algo": "pca",
                              "arrays": [{"name": "x", "dtype": "float32", "shape": [2, 2]}]})
    protocol.send_frame(sock, b"\x00" * 64)  # declared 16 bytes
    return "declared"


def _bad_spec_drains_before_error(sock):
    protocol.send_json(sock, {"v": 1, "op": "feed_raw", "job": "caps4", "algo": "pca",
                              "arrays": [{"name": "x", "dtype": "flaot32", "shape": [2, 2]}]})
    protocol.send_frame(sock, b"\x00" * 16)
    return "bad array spec"


def _version_mismatch_with_payload(sock):
    protocol.send_json(sock, {"v": 99, "op": "feed", "job": "x", "algo": "pca"})
    protocol.send_frame(sock, DataPlaneClient._to_ipc(np.ones((4, 3)), "features"))
    return "protocol version mismatch: server speaks v1"


def _unported_op_with_payload(sock):
    # The name is historical: merge_state answered "unknown op" until the
    # multi-daemon plane. Its arrays are still read before the rejection of
    # a merge into an unknown job without n_cols.
    protocol.send_arrays(sock, {"s0": np.ones((4, 3))},
                         {"v": 1, "op": "merge_state", "job": "x", "rows": 4})
    return "merge_state into an unknown job needs n_cols"


@pytest.mark.parametrize("bad_request", [
    _spec_count_capped, _declared_bytes_capped, _frame_size_must_match_spec,
    _bad_spec_drains_before_error, _version_mismatch_with_payload, _unported_op_with_payload,
], ids=lambda f: f.__name__.strip("_"))
def test_rejected_request_keeps_the_framing(daemon, bad_request):
    """Each rejection drains the request's frames: the error is answered and
    the next request on the same socket parses."""
    sock = socket.create_connection(daemon.address, timeout=30)
    try:
        match = bad_request(sock)
        resp = protocol.recv_json(sock)
        assert resp is not None and resp["ok"] is False and match in resp["error"]
        protocol.send_json(sock, {"v": 1, "op": "ping"})
        assert protocol.recv_json(sock)["ok"] is True
    finally:
        sock.close()
    assert not daemon._jobs


def test_non_pca_algo_refused_without_a_job(daemon, data):
    """An algo neither daemon knows is refused, as a job and as a served
    model, before a job or model is registered."""
    with _client(daemon) as c:
        for feed in (c.feed, c.feed_raw):
            with pytest.raises(RuntimeError, match="unknown algo 'svm' .*rf\\|knn"):
                feed("nn", data, algo="svm")
        with pytest.raises(RuntimeError, match="no such job"):
            c.status("nn")
        with pytest.raises(RuntimeError, match="unknown model algo 'svm' .*rf_regressor"):
            c.ensure_model("svm", "svm", {"bin_edges": data[:2], "value": data[2:4]})
        assert c.ping()
    assert not daemon._jobs and not daemon._models


def test_stale_first_feed_leaves_no_job(daemon, data):
    """A rejected FIRST fold (a pass_id this single-pass job never reaches)
    unregisters the job it created."""
    with _client(daemon) as c:
        with pytest.raises(RuntimeError, match="stale pass_id"):
            c.feed("late", data, pass_id=3)
        with pytest.raises(RuntimeError, match="no such job"):
            c.status("late")


def test_ttl_evicts_abandoned_job(data):
    # Injected clock, one reaper tick run directly: no wall sleeps.
    clk = {"t": 0.0}
    with DataPlaneDaemon(device="cpu", ttl=60.0, clock=lambda: clk["t"],
                         reap_interval=3600.0) as d:
        with _client(d) as c:
            c.feed("abandoned", data, algo="pca")
            d._reap_once()
            assert c.status("abandoned")["rows"] == data.shape[0]
            clk["t"] = 61.0  # idle past the TTL
            d._reap_once()
            with pytest.raises(RuntimeError, match="no such job"):
                c.finalize_pca("abandoned", k=2)


def test_active_job_survives_ttl(data):
    clk = {"t": 0.0}
    with DataPlaneDaemon(device="cpu", ttl=60.0, clock=lambda: clk["t"],
                         reap_interval=3600.0) as d:
        with _client(d) as c:
            c.feed("active", data[:200], algo="pca")
            # Touch just inside the TTL at every tick, alternating a direct
            # feed and a partitioned feed + commit, so both exit stamps
            # (fold's and commit's) are what keeps the job alive.
            for i in range(4):
                clk["t"] += 50.0
                d._reap_once()
                if i % 2 == 0:
                    c.feed("active", data[:50], algo="pca")
                else:
                    c.feed("active", data[200 + i * 50:250 + i * 50], algo="pca", partition=i)
                    clk["t"] += 50.0
                    d._reap_once()
                    c.commit("active", partition=i)
            assert c.finalize_pca("active", k=2)["pc"].shape == (data.shape[1], 2)


def test_token_required_when_configured(data):
    with DataPlaneDaemon(device="cpu", token="s3cret") as d:
        with _client(d) as c:
            with pytest.raises(RuntimeError, match="unauthorized"):
                c.ping()
        with _client(d, token="wrong") as c:
            with pytest.raises(RuntimeError, match="unauthorized"):
                c.feed("j", data, algo="pca")
            with pytest.raises(RuntimeError, match="unauthorized"):  # framing intact
                c.ping()
        with _client(d, token="s3cret") as c:
            assert c.ping()
            c.feed("j", data, algo="pca")
            assert c.finalize_pca("j", k=2)["pc"].shape == (data.shape[1], 2)


def test_raw_moments_finalize_for_scaler(daemon, data):
    """A scaler fit rides the pca job: finalize with raw_moments returns
    (count, Σx, diag XᵀX) without an eigensolve."""
    with _client(daemon) as c:
        for pid, part in enumerate(np.array_split(data, 3)):
            c.feed("sc", part, algo="pca", partition=pid)
            c.commit("sc", partition=pid)
        arrays, rows = c.finalize("sc", {"raw_moments": True})
    assert rows == data.shape[0]
    assert float(arrays["count"][0]) == data.shape[0]
    np.testing.assert_allclose(arrays["colsum"], data.sum(axis=0), rtol=1e-10)
    np.testing.assert_allclose(arrays["gram_diag"], (data * data).sum(axis=0), rtol=1e-10)


def test_export_state_is_the_committed_statistics(daemon, data):
    with _client(daemon) as c:
        c.feed("ex", data[:100], partition=0)
        c.commit("ex", partition=0)
        c.feed("ex", data[100:], partition=1)  # staged, not committed
        arrays, meta = c.export_state("ex")
    assert meta == {"rows": 100, "pass_rows": 100, "iteration": 0, "algo": "pca",
                    "n_cols": data.shape[1], "committed": {"0": 100}}
    assert float(arrays["s0"]) == 100.0
    np.testing.assert_allclose(arrays["s1"], data[:100].sum(axis=0), rtol=1e-12)
    np.testing.assert_allclose(arrays["s2"], data[:100].T @ data[:100], rtol=1e-12)


# ---------------------------------------------------------------------------
# The client's self-healing loop
# ---------------------------------------------------------------------------


def test_busy_is_honoured_without_burning_attempts(data):
    """Over the staged-bytes watermark, feeds are shed with busy: the client
    waits the hint (not an attempt), and gives up only past its busy cap;
    commit is never shed and relieves the pressure."""
    with DataPlaneDaemon(device="cpu", max_staged_bytes=1, retry_after_s=0.01) as d:
        with _client(d, max_busy_wait_s=0.05, max_op_attempts=1) as c:
            c.feed("b", data[:100], partition=0)  # stages ~2 KiB: over the mark
            with pytest.raises(DaemonBusy):
                c.feed("b", data[100:], partition=1)
            assert c.stats["busy_waits"] >= 1 and c.stats["reconnects"] == 0
            c.commit("b", partition=0)
            c.feed("b", data[100:], partition=1)
            c.commit("b", partition=1)
            assert c.status("b")["rows"] == data.shape[0]


def test_reconnect_replays_with_the_same_feed_id(daemon, data, monkeypatch):
    """A connection that drops after the daemon folded the feed but before
    the ack arrived: the client reconnects and replays the op with the
    feed_id it minted once, and the daemon does not fold it twice."""
    with _client(daemon, backoff_base_s=0.001, backoff_max_s=0.002) as c:
        real = protocol.recv_json
        dropped = []

        def lose_first_feed_ack(sock):
            resp = real(sock)
            if not dropped and resp is not None and "rows" in resp:
                dropped.append(resp)
                raise ConnectionResetError("ack lost")
            return resp

        monkeypatch.setattr(protocol, "recv_json", lose_first_feed_ack)
        c.feed("rp", data[:100], partition=0)
        monkeypatch.setattr(protocol, "recv_json", real)
        assert dropped and c.stats["reconnects"] == 1 and c.stats["replays"] == 1
        assert c.commit("rp", partition=0) == 100


def test_frame_too_large_is_never_replayed(daemon, data, monkeypatch):
    monkeypatch.setattr(protocol, "MAX_FRAME", 4096)
    with _client(daemon) as c:
        with pytest.raises(protocol.FrameTooLarge):
            c.feed_raw("big", data)  # 61 KiB > the patched MAX_FRAME
        assert c.stats["reconnects"] == 0 and c.stats["replays"] == 0
        monkeypatch.undo()
        assert c.ping()  # the half-sent request's connection was dropped


def test_op_deadline_bounds_the_healing():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens: every connect is refused
    with DataPlaneClient("127.0.0.1", port, op_deadline_s=0.3, max_op_attempts=1000,
                         backoff_base_s=0.01, backoff_max_s=0.05) as c:
        t0 = time.monotonic()
        with pytest.raises(OSError):
            c.ping()
        assert time.monotonic() - t0 < 2.0 and c.stats["reconnects"] >= 1


# ---------------------------------------------------------------------------
# Device rules
# ---------------------------------------------------------------------------


def test_fold_reaches_streaming_update_rows_once_per_folded_feed(daemon, data, monkeypatch):
    calls = []
    real = port_gram.streaming_update_rows

    def counting(state, x, n_valid, compute_dtype=None):
        calls.append(int(n_valid))
        return real(state, x, n_valid, compute_dtype=compute_dtype)

    monkeypatch.setattr(port_gram, "streaming_update_rows", counting)
    parts = np.array_split(data, 3)
    with _client(daemon) as c:
        payload = c._to_ipc(parts[0], "features")
        req = {"op": "feed", "job": "cnt", "algo": "pca", "partition": 0, "feed_id": "f-1"}
        c._roundtrip(dict(req), payload=payload)
        c._roundtrip(dict(req), payload=payload)  # replay: no fold
        c.commit("cnt", partition=0)
        c.feed("cnt", parts[0], partition=0, attempt=5)  # committed partition: no fold
        c.feed_raw("cnt", parts[1])
        c.feed("cnt", parts[2], partition=2, attempt=0)
        c.feed("cnt", parts[2], partition=2, attempt=1)  # a second attempt folds too
        c.commit("cnt", partition=2, attempt=1)
        assert c.status("cnt")["rows"] == data.shape[0]
        _assert_matches_batch_fit(c.finalize_pca("cnt", k=3), data)
    assert calls == [len(parts[0]), len(parts[1]), len(parts[2]), len(parts[2])]
