"""The port's daemon-built nearest-neighbour index (the ``knn`` job)
against the JAX package's.

On the CPU (``device="cpu"``), each case held against the in-process JAX
daemon (``jax_ledger_off()``) on the same numpy rows, in float32 in both
packages (the JAX conftest defaults the JAX package to float64) unless a
case says float64:

* exact: a fit over 4 partitions and ``kneighbors`` under each metric,
  in both cross pairings (the JAX client with the port's daemon, the
  port's client with the JAX daemon): indices equal, distances within
  1e-5 (inner_product descending);
* IVF against the JAX host build (the JAX daemon's device build is
  switched off by patching its ``_IVF_DEVICE_BUILD_MAX_BYTES`` in this
  process, as ``tests/test_serve.py`` does; the port's "auto" build runs
  its device build, bitwise its host build), every list probed: ``list_ids`` and the
  served ids equal in float64 (the same trained quantizer, as
  ``tests/test_torch_knn.py::test_build_trains_the_same_quantizer``) and
  in float32 with frozen ``centroids``; ``row_id_base``,
  ``return_centroids`` and ``train_rows``;
* exactly-once staging, ``sample_rows`` and its refusals, first-wins
  ``register_as``, raw against Arrow ``kneighbors``, the 8x TTL and the
  model cap's order, and the refusals the reference makes;
* the frozen serving transcript's knn part, replayed byte for byte.
"""

import socket
import threading

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.serve import daemon as jax_daemon_mod
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon, protocol
from spark_rapids_ml_tpu_torch.serve import daemon as port_daemon_mod
from test_torch_protocol import FIXTURE_SERVING, _recorded_requests
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
DIRECTIONS = ["jax_client_port_daemon", "port_client_jax_daemon"]


def _dtypes(name):
    """Both packages' compute and accumulator dtypes set to ``name``."""
    import contextlib

    stack = contextlib.ExitStack()
    for cfg in (jax_config, config):
        stack.enter_context(cfg.option("compute_dtype", name))
        stack.enter_context(cfg.option("accum_dtype", name))
    return stack


@pytest.fixture(autouse=True)
def _f32_host_build_ledger_off(monkeypatch):
    # The JAX daemon's ivf "auto" build runs its host build here, whose
    # seeded shuffle the port's builds share.
    monkeypatch.setattr(jax_daemon_mod, "_IVF_DEVICE_BUILD_MAX_BYTES", 0)
    with jax_ledger_off(), _dtypes("float32"):
        yield


@pytest.fixture
def daemon():
    with DataPlaneDaemon(device="cpu") as d:
        yield d


@pytest.fixture
def jax_daemon(mesh1):
    with JaxDaemon(mesh=mesh1) as d:
        yield d


def _rows():
    """320 x 12 float32 rows of 8 gaussian blobs, and 24 queries."""
    rng = np.random.default_rng(13)
    centres = rng.normal(size=(8, 12)) * 2.0
    x = (centres[rng.integers(0, 8, 320)] + rng.normal(size=(320, 12))).astype(np.float32)
    q = (centres[rng.integers(0, 8, 24)] + rng.normal(size=(24, 12))).astype(np.float32)
    return x, q


X, Q = _rows()
PARTS = np.array_split(X, 4)


def _feed_partitions(c, job, order=(2, 0, 3, 1), parts=PARTS):
    """Every partition fed and committed, out of order: the ids must still
    be partition-major."""
    for p in order:
        c.feed(job, parts[p], algo="knn", partition=p)
        c.commit(job, partition=p)


def _reference(jax_daemon, mode, k, **fin):
    """The in-process JAX daemon's answer to the same traffic:
    (distances, indices, finalize info)."""
    with JaxClient(*jax_daemon.address) as c:
        _feed_partitions(c, "ref")
        info = c.finalize_knn("ref", register_as="ref-idx", mode=mode, **fin)
        d, i = c.kneighbors("ref-idx", Q, k=k)
    return d, i, info


def _pair(direction, mesh1):
    """(server, client class) of a cross pairing."""
    if direction == "jax_client_port_daemon":
        return DataPlaneDaemon(device="cpu"), JaxClient
    return JaxDaemon(mesh=mesh1), DataPlaneClient


# ---------------------------------------------------------------------------
# Exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine", "inner_product"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_exact_fit_and_kneighbors_cross_pairing(direction, metric, jax_daemon, mesh1):
    want_d, want_i, _ = _reference(jax_daemon, "exact", 7, metric=metric)
    server, make_client = _pair(direction, mesh1)
    with server, make_client(*server.address) as c:
        _feed_partitions(c, "nn")
        assert c.status("nn")["rows"] == X.shape[0]
        info = c.finalize_knn("nn", register_as="idx", mode="exact", metric=metric)
        assert int(info["n_rows"][0]) == X.shape[0] and int(info["n_cols"][0]) == X.shape[1]
        d, i = c.kneighbors("idx", Q, k=7)
        assert not server._jobs  # consumed by the build
    assert d.dtype == np.float64 and i.dtype == np.int64 and i.shape == (len(Q), 7)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(d, want_d, **TOL)
    if metric == "inner_product":
        assert (np.diff(d, axis=1) <= 0).all()  # similarities, descending


# ---------------------------------------------------------------------------
# IVF
# ---------------------------------------------------------------------------


def _ivf_both(jax_daemon, daemon, fin, k=6, **extra):
    """The same ivf traffic through the JAX daemon (JAX client) and the
    port's (port client): ((port ids, list_ids, info), (JAX's))."""
    out = []
    for server, make_client in ((daemon, DataPlaneClient), (jax_daemon, JaxClient)):
        with make_client(*server.address) as c:
            _feed_partitions(c, "ivf")
            info = c.finalize_knn("ivf", register_as="ivf-idx", mode="ivf", **fin, **extra)
            d, i = c.kneighbors("ivf-idx", Q, k=k)
        list_ids = np.asarray(server._models["ivf-idx"].model.index.list_ids)
        out.append((d, i, list_ids, info))
    return out


def test_ivf_float64_trains_the_same_quantizer(jax_daemon, daemon):
    with _dtypes("float64"):
        (pd, pi, pl, pinfo), (jd, ji, jl, jinfo) = _ivf_both(
            jax_daemon, daemon, dict(nlist=8, nprobe=8, seed=5))
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, **TOL)
    for key in ("n_rows", "n_cols", "nlist", "maxlen"):
        np.testing.assert_array_equal(pinfo[key], jinfo[key])
    assert int(pinfo["sharded"][0]) == 0


def test_ivf_float32_frozen_centroids(jax_daemon, daemon):
    cent = X[np.random.default_rng(3).choice(len(X), 8, replace=False)]
    (pd, pi, pl, _), (jd, ji, jl, _) = _ivf_both(
        jax_daemon, daemon, dict(nlist=8, nprobe=8, seed=2), centroids=cent)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, **TOL)
    np.testing.assert_array_equal(daemon._models["ivf-idx"].model.index.centroids, cent)


def test_ivf_return_centroids_and_train_rows(jax_daemon, daemon):
    train = X[::3]
    with _dtypes("float64"):
        (_, pi, pl, pinfo), (_, ji, jl, jinfo) = _ivf_both(
            jax_daemon, daemon, dict(nlist=8, nprobe=8, seed=1), return_centroids=True,
            train_rows_sample=train)
    np.testing.assert_allclose(pinfo["centroids"], jinfo["centroids"], rtol=1e-6, atol=1e-6)
    assert pinfo["centroids"].dtype == np.float32
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pi, ji)


def test_row_id_base_gives_global_ids(jax_daemon, daemon):
    """A daemon holding partitions 1 and 3 only answers in the global
    partition-major ids of the whole DataFrame."""
    base = {p: sum(len(PARTS[j]) for j in range(p)) for p in range(4)}
    got = []
    for server, make_client in ((daemon, DataPlaneClient), (jax_daemon, JaxClient)):
        with make_client(*server.address) as c:
            _feed_partitions(c, "sh", order=(3, 1))
            c.finalize_knn("sh", register_as="sh-idx", row_id_base=base)
            got.append(c.kneighbors("sh-idx", Q, k=4))
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_allclose(got[0][0], got[1][0], **TOL)
    held = np.concatenate([np.arange(base[p], base[p] + len(PARTS[p])) for p in (1, 3)])
    assert np.isin(got[0][1], held).all()
    d2 = ((Q[:, None, :].astype(np.float64) - X[None, held]) ** 2).sum(-1)
    np.testing.assert_array_equal(got[0][1], held[np.argsort(d2, axis=1, kind="stable")[:, :4]])


# ---------------------------------------------------------------------------
# The job's contracts
# ---------------------------------------------------------------------------


def _exactly_once(c, job):
    """Every partition once, with a dead attempt's stage (partition 0's
    attempt 0 feeds wrong rows and never commits), a replayed feed_id
    (partition 1) and a duplicate commit (partition 3)."""
    c.feed(job, np.full_like(PARTS[0], 99.0), algo="knn", partition=0, attempt=0)
    c.feed(job, PARTS[0], algo="knn", partition=0, attempt=1)
    c.commit(job, partition=0, attempt=1)
    payload = c._to_ipc(PARTS[1], "features", "label") if isinstance(c, JaxClient) \
        else c._to_ipc(PARTS[1], "features")
    req = {"op": "feed", "job": job, "algo": "knn", "partition": 1, "attempt": 0,
           "feed_id": "replayed-1"}
    c._roundtrip(dict(req), payload=payload)
    c._roundtrip(dict(req), payload=payload)
    c.commit(job, partition=1)
    for p in (2, 3):
        c.feed(job, PARTS[p], algo="knn", partition=p)
        c.commit(job, partition=p)
    return c.commit(job, partition=3)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_exactly_once_adds_no_row(direction, jax_daemon, mesh1):
    want_d, want_i, _ = _reference(jax_daemon, "exact", 5)
    server, make_client = _pair(direction, mesh1)
    with server, make_client(*server.address) as c:
        assert _exactly_once(c, "eo") == X.shape[0]
        assert c.status("eo")["rows"] == X.shape[0]
        info = c.finalize_knn("eo", register_as="eo-idx")
        d, i = c.kneighbors("eo-idx", Q, k=5)
    assert int(info["n_rows"][0]) == X.shape[0]
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(d, want_d, **TOL)


def test_staged_bytes_count_the_host_blocks(daemon):
    with DataPlaneClient(*daemon.address) as c:
        c.feed_raw("sb", PARTS[0], algo="knn", partition=0)
        job = daemon._jobs["sb"]
        assert job.staged_bytes == PARTS[0].astype(np.float32).nbytes
        c.commit("sb", partition=0)
        assert job.staged_bytes == 0 and job.rows == len(PARTS[0])


def test_knn_feeds_take_no_device_lock(daemon, monkeypatch):
    """The rows stay on the host until finalize: feeds and commits never
    take the device lock."""
    taken = []

    class _Counting:
        def __enter__(self):
            taken.append(1)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(port_daemon_mod, "_DEVICE_LOCK", _Counting())
    with DataPlaneClient(*daemon.address) as c:
        _feed_partitions(c, "nolock")
        c.feed_raw("nolock", X[:10], algo="knn")  # a direct feed too
        assert c.status("nolock")["rows"] == X.shape[0] + 10
    assert taken == []


def test_sample_rows_matches_the_reference(jax_daemon, daemon):
    got = []
    for server, make_client in ((daemon, DataPlaneClient), (jax_daemon, JaxClient)):
        with make_client(*server.address) as c:
            _feed_partitions(c, "smp")
            got.append([c.sample_rows("smp", n, seed=7) for n in (50, 10_000)])
    for mine, ref in zip(*got):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine, ref)
    assert got[0][0].shape == (50, 12) and got[0][1].shape == X.shape  # clamped


@pytest.mark.parametrize("case", ["non_knn_job", "n_not_positive", "before_any_commit"])
def test_sample_rows_refusals(case, jax_daemon, daemon):
    errors = []
    for server, make_client in ((daemon, DataPlaneClient), (jax_daemon, JaxClient)):
        with make_client(*server.address) as c:
            if case == "non_knn_job":
                c.feed("j", X.astype(np.float64), algo="pca")
            else:
                c.feed("j", X, algo="knn", partition=0)
                if case == "n_not_positive":
                    c.commit("j", partition=0)
            with pytest.raises(RuntimeError) as e:
                c.sample_rows("j", 0 if case == "n_not_positive" else 5)
            errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_register_as_is_first_wins(daemon, monkeypatch):
    with DataPlaneClient(*daemon.address) as c:
        _feed_partitions(c, "a")
        c.finalize_knn("a", register_as="taken")
        first = c.kneighbors("taken", Q, k=3)
        _feed_partitions(c, "b", parts=[p + 100.0 for p in PARTS])
        with pytest.raises(RuntimeError, match="'taken' is already registered"):
            c.finalize_knn("b", register_as="taken")
        assert c.status("b")["rows"] == X.shape[0]  # refused before the build
        # A registration that lands while the build runs: refused after it.
        real = port_daemon_mod._Job.build_knn_model

        def racing(job, params, extra=None):
            out = real(job, params, extra)
            daemon._models["late"] = daemon._models["taken"]
            return out

        monkeypatch.setattr(port_daemon_mod._Job, "build_knn_model", racing)
        with pytest.raises(RuntimeError, match="'late' is already registered"):
            c.finalize_knn("b", register_as="late")
        again = c.kneighbors("taken", Q, k=3)
    np.testing.assert_array_equal(first[1], again[1])


def test_raw_kneighbors_equals_arrow_bitwise(daemon):
    with DataPlaneClient(*daemon.address) as c:
        _feed_partitions(c, "r")
        c.finalize_knn("r", register_as="r-idx", metric="cosine")
        for k in (1, 9, None):
            arrow = c.kneighbors("r-idx", Q, k=k)
            raw = c.kneighbors_raw("r-idx", Q, k=k)
            for a, b in zip(arrow, raw):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert arrow[1].shape == (len(Q), 5)  # k None: the index's fitted k


def test_daemon_built_index_outlives_the_ttl_eightfold():
    clk = {"t": 0.0}
    with DataPlaneDaemon(device="cpu", ttl=60.0, clock=lambda: clk["t"],
                         reap_interval=3600.0) as d, DataPlaneClient(*d.address) as c:
        _feed_partitions(c, "t")
        c.finalize_knn("t", register_as="built")
        c.ensure_model("plain", "pca", {"pc": np.eye(12)[:, :2], "mean": np.zeros(12),
                                        "explainedVariance": np.ones(2)})
        clk["t"] = 61.0
        d._reap_once()
        assert sorted(d._models) == ["built"]
        clk["t"] = 60.0 * 8 - 1.0
        d._reap_once()
        assert sorted(d._models) == ["built"]
        clk["t"] = 60.0 * 8 + 1.0
        d._reap_once()
        assert d._models == {}
        with pytest.raises(RuntimeError, match="evicted; refit"):
            c.kneighbors("built", Q, k=2)


def test_model_cap_evicts_re_creatable_registrations_first():
    clk = {"t": 0.0}
    pca = {"pc": np.eye(12)[:, :2], "mean": np.zeros(12), "explainedVariance": np.ones(2)}
    with DataPlaneDaemon(device="cpu", max_models=2, clock=lambda: clk["t"]) as d, \
            DataPlaneClient(*d.address) as c:
        _feed_partitions(c, "cap")
        c.finalize_knn("cap", register_as="built")  # the oldest
        for t, name in ((1.0, "p1"), (2.0, "p2")):
            clk["t"] = t
            c.ensure_model(name, "pca", pca)
        assert sorted(d._models) == ["built", "p2"]  # p1 went, not the older index
        clk["t"] = 3.0
        _feed_partitions(c, "cap2")
        c.finalize_knn("cap2", register_as="built2")
        assert sorted(d._models) == ["built", "built2"]
        clk["t"] = 4.0
        c.ensure_model("p3", "pca", pca)
        assert sorted(d._models) == ["built2", "p3"]  # no plain one left: the oldest index


def _refusal(case, c, job):
    if case == "inner_product_ivf":
        _feed_partitions(c, job)
        c.finalize_knn(job, register_as="x", mode="ivf", nlist=4, metric="inner_product")
    elif case == "finalize_before_any_feed":
        c.feed(job, X, algo="knn", partition=0)  # staged, never committed
        c.finalize_knn(job, register_as="x")
    elif case == "export_state":
        _feed_partitions(c, job)
        c.export_state(job)
    elif case == "step":
        _feed_partitions(c, job)
        c.step(job)
    elif case == "get_iterate":
        _feed_partitions(c, job)
        c.get_iterate(job)
    elif case == "set_iterate":
        _feed_partitions(c, job)
        c.set_iterate(job, {"centers": np.zeros((2, 12))}, 1)
    elif case == "kneighbors_on_pca":
        c.ensure_model("pca-m", "pca", {"pc": np.eye(12)[:, :2], "mean": np.zeros(12),
                                        "explainedVariance": np.ones(2)})
        c.kneighbors("pca-m", Q, k=2)


@pytest.mark.parametrize("case", ["inner_product_ivf", "finalize_before_any_feed",
                                  "export_state", "step", "get_iterate", "set_iterate",
                                  "kneighbors_on_pca"])
def test_refusals_match_the_reference(case, jax_daemon, daemon):
    errors = []
    for server, make_client in ((daemon, DataPlaneClient), (jax_daemon, JaxClient)):
        with make_client(*server.address) as c:
            with pytest.raises(RuntimeError) as e:
                _refusal(case, c, "rj")
            errors.append(str(e.value))
            assert c.ping()
    assert errors[0] == errors[1]


def test_device_build_is_refused(daemon):
    """Only an unknown build is refused (the reference's message), before
    the build, with the rows intact and no model registered; ``"device"``
    registers a device-resident index that answers."""
    with DataPlaneClient(*daemon.address) as c:
        _feed_partitions(c, "dv")
        with pytest.raises(RuntimeError, match=r"unknown build 'tpu' \(auto\|device\|host\)"):
            c.finalize("dv", {"mode": "ivf", "nlist": 4, "build": "tpu",
                              "register_as": "dv-idx"})
        assert c.status("dv")["rows"] == X.shape[0]  # refused before the build
        assert not c.model_exists("dv-idx")
        c.finalize("dv", {"mode": "ivf", "nlist": 4, "nprobe": 4, "build": "device",
                          "register_as": "dv-idx"})
        assert isinstance(daemon._lookup_model("dv-idx").model.index.lists, torch.Tensor)
        d, i = c.kneighbors("dv-idx", Q, k=3)
    assert i.shape == (len(Q), 3) and (i >= 0).all() and np.isfinite(d).all()


def test_kneighbors_rejections_keep_the_framing(daemon):
    sock = socket.create_connection(daemon.address, timeout=30)
    try:
        for arrays in (None, {"x": Q}):
            req = {"v": 1, "op": "kneighbors", "model": "missing", "k": 2}
            if arrays is None:
                protocol.send_json(sock, req)
                protocol.send_frame(sock, DataPlaneClient._to_ipc(Q, "features"))
            else:
                protocol.send_arrays(sock, arrays, req)
            resp = protocol.recv_json(sock)
            assert resp["ok"] is False and "no such model 'missing'" in resp["error"]
        protocol.send_json(sock, {"v": 1, "op": "ping"})
        assert protocol.recv_json(sock)["ok"] is True
    finally:
        sock.close()


def test_concurrent_partition_feeds_stay_partition_major(daemon):
    """Partitions fed and committed from threads in any order give the
    ids of the partition-major concatenation."""
    parts = np.array_split(X, 8)

    def task(p):
        with DataPlaneClient(*daemon.address) as c:
            for half in np.array_split(parts[p], 2):
                c.feed_raw("cc", half, algo="knn", partition=p)
            c.commit("cc", partition=p)

    threads = [threading.Thread(target=task, args=(p,)) for p in reversed(range(8))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with DataPlaneClient(*daemon.address) as c:
        c.finalize_knn("cc", register_as="cc-idx", metric="sqeuclidean")
        d, i = c.kneighbors("cc-idx", X[:16], k=1)
    np.testing.assert_array_equal(i[:, 0], np.arange(16))
    # Each row is its own nearest neighbour: f32 ‖q‖² + ‖r‖² − 2q·r leaves
    # a residual of a few ulps of ‖q‖² (about 15 here) instead of 0.
    np.testing.assert_allclose(d[:, 0], np.zeros(16), atol=1e-5 * float((X[:16] ** 2).sum(1).max()))


def test_replay_serving_transcript_knn_part():
    """protocol_v1_serving.bin whole: after its PCA prefix, the knn job's
    partitioned Arrow feeds, commits, the build-and-serve finalize, the
    kneighbors and both drop_models, against the transcript's responses."""
    from make_protocol_golden import golden_matrix, serving_transcript_frames

    _, expect = serving_transcript_frames()
    requests = _recorded_requests(FIXTURE_SERVING)
    assert len(requests) == len(expect) == 12
    with _dtypes("float64"), DataPlaneDaemon(device="cpu") as daemon:
        sock = socket.create_connection(daemon.address, timeout=60)
        try:
            sock.sendall(b"".join(raw for _, raw in requests))
            results = []
            for kind, checks in expect:
                resp = protocol.recv_json(sock)
                for key, want in checks.items():
                    assert resp.get(key) == want, f"response {resp}: {key}={want!r}"
                if kind == "arrays":
                    results.append(protocol.recv_arrays(sock, resp))
        finally:
            sock.close()
    info, nbrs = results[1], results[2]
    x = golden_matrix()
    assert int(info["n_rows"][0]) == 8 and int(info["n_cols"][0]) == x.shape[1]
    d2 = ((x[:3, None, :] - x[None, :, :].astype(np.float32)) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :2]
    np.testing.assert_array_equal(nbrs["indices"], want)
    np.testing.assert_allclose(nbrs["distances"],
                               np.sqrt(np.take_along_axis(d2, want, axis=1)), atol=1e-6)
