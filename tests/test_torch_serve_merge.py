"""The port daemon's cross-daemon merge ops against the JAX package's.

``merge_state`` (the driver's hub: a peer's ``export_state`` folded into
the primary), ``mesh_info`` and ``reduce_mesh`` (the collective path: the
pass partials of peers in the primary's process folded on its device),
on the CPU (``device="cpu"``):

* ``merge_state`` creates the job, a replayed ``merge_id`` folds once, and
  a rejected payload leaves no orphan job (the reference's
  ``tests/test_spark_multidaemon.py:317``); a knn job refuses every merge;
* ``mesh_info``'s epoch bumps on a daemon's start, stop and
  re-registration, and its members are the live daemons;
* ``reduce_mesh`` over two peers equals the hub's two ``merge_state``s
  bitwise, for every mergeable algo, on gaussian float32 rows: the same
  additions in the same sorted-id order. Every refusal the reference makes
  before folding (a stale epoch, a row mismatch, an orphan or lost
  partition, pass skew, the target among the peers) leaves the target and
  its peers as they were, and a refused reduce into a daemon that had no
  job leaves none; a replay after ``drop_peers`` returns the cached ack; a
  commit that lands on a peer after the checks read it is not folded;
* the JAX client gets the same responses from the port's daemons as from
  the JAX daemons, for all three ops, and in float64 the port's merged
  states equal the JAX daemons' after the same feeds and merges.
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
from spark_rapids_ml_tpu_torch.ops.histogram import quantile_bin_edges
from spark_rapids_ml_tpu_torch.parallel import membership
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.utils import metrics
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

N, D, PARTS = 240, 6, 4
RF_PARAMS = {"num_trees": 3, "max_depth": 3, "max_bins": 8, "n_classes": 3,
             "subset": "all", "seed": 5, "bootstrap": True, "min_instances": 1}

#: name → (algo, feed params, labelled)
JOBS = {
    "pca": ("pca", {}, False),
    "linreg": ("linreg", {}, True),
    "kmeans": ("kmeans", {"k": 4, "seed": 3, "init": "k-means++"}, False),
    "logreg-binomial": ("logreg", {"n_classes": 2}, True),
    "logreg-multinomial": ("logreg", {"n_classes": 3}, True),
    "rf": ("rf", RF_PARAMS, True),
}


def _rows(seed, integer=False):
    """(x, y) of one daemon's partitions: gaussian float32 rows (or small
    integers), labels in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-4, 5, size=(N, D)).astype(np.float64)
    else:
        x = rng.normal(size=(N, D)).astype(np.float32)
    return x, rng.integers(0, 3, size=N).astype(np.float64)


def _labels(name, y):
    """Binary labels for the binomial job, the class ids otherwise."""
    return (y > 0).astype(np.float64) if name == "logreg-binomial" else y


def _open(c, name, job):
    """What the driver sends before the first scan: kmeans seeds (the same
    integer rows on every daemon), a forest's iterate."""
    algo, params, _ = JOBS[name]
    if algo == "kmeans":
        c.seed_kmeans(job, _rows(99, integer=True)[0][:32], k=params["k"], params=params)
    elif algo == "rf":
        spec = port_rf.forest_spec_from_params(params, D)
        arrays = port_rf.init_forest_arrays(spec, quantile_bin_edges(_rows(99)[0],
                                                                     spec.max_bins))
        c.set_iterate(job, arrays, 0, algo="rf", n_cols=D, params=params)


def _feed_partitions(c, name, job, seed, parts, integer=False):
    """Partitions ``parts`` of the rows of ``seed``, fed and committed in
    order (pass 0 for the iterative jobs). Returns the rows committed."""
    algo, params, labelled = JOBS[name]
    x, y = _rows(seed, integer)
    y = _labels(name, y)
    pass_id = 0 if algo in ("kmeans", "logreg", "rf") else None
    chunks = np.array_split(np.arange(N), PARTS)
    rows = 0
    for p in parts:
        xi = x[chunks[p]]
        c.feed(job, (xi, y[chunks[p]]) if labelled else xi, algo=algo, params=params,
               partition=p, pass_id=pass_id)
        c.commit(job, partition=p, pass_id=pass_id)
        rows += len(chunks[p])
    return rows


@contextlib.contextmanager
def _daemons(n, cls=DataPlaneDaemon, **kw):
    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(cls(**kw)) for _ in range(n)]


def _port_daemons(n):
    return _daemons(n, device="cpu")


def _setup(daemons, name, job="j", integer=False, client_cls=DataPlaneClient):
    """The primary (daemons[0]) fed partitions 0-1, each peer its own rows
    in partitions 2-3 (the i-th peer by instance id: partitions of seed i,
    so two setups fold the same rows in the same order). Returns (primary
    client, [(peer daemon, peer client, rows, partitions)])."""
    ca = client_cls(*daemons[0].address)
    _open(ca, name, job)
    _feed_partitions(ca, name, job, 0, [0, 1], integer)
    peers = []
    for i, d in enumerate(sorted(daemons[1:], key=lambda d: d.instance_id), start=1):
        c = client_cls(*d.address)
        _open(c, name, job)
        peers.append((d, c, _feed_partitions(c, name, job, i, [2, 3], integer), [2, 3]))
    return ca, peers


def _hub(ca, name, peers, job="j"):
    """The driver's hub: each peer's export merged into the primary, in
    sorted instance-id order."""
    algo, params, _ = JOBS[name]
    for d, c, _rows_, _parts in sorted(peers, key=lambda p: p[0].instance_id):
        arrays, meta = c.export_state(job)
        ca.merge_state(job, arrays, rows=int(meta["pass_rows"]), algo=algo,
                       n_cols=int(meta["n_cols"]), params=params)


def _spec(peers, **override):
    return {d.instance_id: {"boot_id": d.boot_id, "rows": rows, "partitions": parts,
                            **override}
            for d, _c, rows, parts in peers}


def _reduce(ca, name, peers, job="j", **kw):
    algo, params, _ = JOBS[name]
    epoch = ca.mesh_info()["epoch"]
    return ca.reduce_mesh(job, epoch=epoch, peers=_spec(peers), algo=algo, params=params, **kw)


def _export(c, job="j"):
    arrays, meta = c.export_state(job)
    return [arrays[f"s{i}"] for i in range(len(arrays))], meta


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# merge_state
# ---------------------------------------------------------------------------


def test_merge_state_creates_the_job_and_a_replayed_merge_id_folds_once():
    with _port_daemons(2) as (a, b):
        cb = DataPlaneClient(*b.address)
        n = _feed_partitions(cb, "pca", "j", 1, [0, 1, 2, 3])
        arrays, meta = cb.export_state("j")
        assert meta["pass_rows"] == n and sorted(meta["committed"]) == ["0", "1", "2", "3"]
        ca = DataPlaneClient(*a.address)
        req = {"op": "merge_state", "job": "j", "algo": "pca", "n_cols": D, "params": {},
               "rows": n, "merge_id": "m-1"}
        assert ca._send_arrays_op(dict(req), arrays)["rows"] == n  # created the job
        assert ca._send_arrays_op(dict(req), arrays)["rows"] == n  # the replay: no fold
        got, meta_a = _export(ca)
        _assert_same_arrays(got, _export(cb)[0])
        assert meta_a["rows"] == meta_a["pass_rows"] == n and meta_a["committed"] == {}
        # A fresh merge_id (the client mints one a call) folds again.
        assert ca.merge_state("j", arrays, rows=n, n_cols=D) == 2 * n


@pytest.mark.parametrize("arrays, match", [
    ({"s0": np.zeros((3, 3))}, "carried 1 arrays"),
    ({"s0": np.zeros(()), "s1": np.zeros(D), "s2": np.zeros((D + 1, D + 1))}, "shape"),
    ({"s0": np.zeros(()), "s1": np.zeros(D), "s9": np.zeros((D, D))}, "missing array 's2'"),
], ids=["count", "shape", "name"])
def test_a_rejected_merge_leaves_no_orphan_job(arrays, match):
    with _port_daemons(1) as (a,):
        c = DataPlaneClient(*a.address)
        with pytest.raises(RuntimeError, match=match):
            c.merge_state("fresh", arrays, rows=5, algo="pca", n_cols=D)
        assert "fresh" not in a._jobs
        x = _rows(0)[0][:16]
        c.feed("fresh", x, algo="pca")
        res, rows = c.finalize("fresh", {"k": 2})
        assert rows == 16 and res["pc"].shape == (D, 2)


def test_a_knn_job_refuses_every_merge():
    with _port_daemons(2) as (a, b):
        ca, cb = DataPlaneClient(*a.address), DataPlaneClient(*b.address)
        x = _rows(0)[0]
        for c in (ca, cb):
            c.feed("k", x[:40], algo="knn", partition=0)
            c.commit("k", partition=0)
        with pytest.raises(RuntimeError, match="knn"):
            ca.merge_state("k", {"s0": x[:4]}, rows=4, algo="knn", n_cols=D)
        with pytest.raises(RuntimeError, match="dataset"):
            cb.export_state("k")
        epoch = ca.mesh_info()["epoch"]
        with pytest.raises(RuntimeError, match="dataset"):
            ca.reduce_mesh("k", epoch=epoch, algo="knn", peers={
                b.instance_id: {"boot_id": b.boot_id, "rows": 40, "partitions": [0]}})
        assert a._jobs["k"].rows == 40 and b._jobs["k"].rows == 40


# ---------------------------------------------------------------------------
# mesh_info
# ---------------------------------------------------------------------------


def test_mesh_info_epoch_bumps_on_start_stop_and_reregistration():
    reg = membership.registry()
    with _port_daemons(1) as (a,):
        c = DataPlaneClient(*a.address)
        info = c.mesh_info()
        assert info["id"] == a.instance_id and info["boot_id"] == a.boot_id
        assert info["n_devices"] == 1 and info["epoch"] == reg.epoch
        assert {"id": a.instance_id, "boot_id": a.boot_id} in [
            {k: m[k] for k in ("id", "boot_id")} for m in info["members"]]
        b = DataPlaneDaemon(device="cpu").start()
        after_start = c.mesh_info()
        assert after_start["epoch"] > info["epoch"]
        assert b.instance_id in {m["id"] for m in after_start["members"]}
        b.stop()
        after_stop = c.mesh_info()
        assert after_stop["epoch"] > after_start["epoch"]
        assert b.instance_id not in {m["id"] for m in after_stop["members"]}
        # A reboot under the same durable id re-registers: another bump, and
        # the member carries the new boot.
        reg.register(a.instance_id, "reboot", a)
        rebooted = c.mesh_info()
        assert rebooted["epoch"] > after_stop["epoch"]
        assert {m["id"]: m["boot_id"] for m in rebooted["members"]}[a.instance_id] == "reboot"
        # The superseded incarnation's stop does not unregister the live one.
        reg.unregister(a.instance_id, boot_id=a.boot_id)
        assert a.instance_id in {m["id"] for m in c.mesh_info()["members"]}
        reg.register(a.instance_id, a.boot_id, a)
    assert a.instance_id not in {m["id"] for m in reg.snapshot()["members"]}


# ---------------------------------------------------------------------------
# reduce_mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(JOBS))
def test_reduce_mesh_equals_the_hub_bitwise(name):
    before = metrics.REGISTRY.counter("srml_daemon_mesh_reduces_total").value(
        algo=JOBS[name][0])
    with _port_daemons(3) as hub_daemons, _port_daemons(3) as mesh_daemons:
        ca_hub, peers_hub = _setup(hub_daemons, name)
        _hub(ca_hub, name, peers_hub)
        ca, peers = _setup(mesh_daemons, name)
        resp = _reduce(ca, name, peers)
        n = N // 2 + 2 * (N // 2)
        assert resp["rows"] == n and resp["reduced"] == 2
        assert resp["id"] == mesh_daemons[0].instance_id
        got, meta = _export(ca)
        want, meta_hub = _export(ca_hub)
        _assert_same_arrays(got, want)
        assert meta["rows"] == meta_hub["rows"] == n
        assert meta["pass_rows"] == meta_hub["pass_rows"] == n
        for d, _c, _r, _p in peers:
            assert "j" in d._jobs  # drop_peers was off
    after = metrics.REGISTRY.counter("srml_daemon_mesh_reduces_total").value(algo=JOBS[name][0])
    assert after == before + 1


def _skew(peers):
    """The peer opens pass 1 (a missed boundary on the target's side) and
    commits the same partitions there."""
    d, c, rows, parts = peers[0]
    arrays, _ = c.get_iterate("j")
    c.set_iterate("j", arrays, 1)
    _feed_pass1(c, parts)


def _feed_pass1(c, parts):
    x, _ = _rows(1)
    chunks = np.array_split(np.arange(N), PARTS)
    for p in parts:
        c.feed("j", x[chunks[p]], algo="kmeans", params=JOBS["kmeans"][1], partition=p,
               pass_id=1)
        c.commit("j", partition=p, pass_id=1)


REFUSALS = {
    "stale-epoch": (lambda ca, peers: {"epoch": ca.mesh_info()["epoch"] - 1},
                    "membership changed"),
    "row-mismatch": (lambda ca, peers: {"peers": _spec(peers, rows=peers[0][2] + 1)},
                     "row-count mismatch"),
    "orphan-partition": (lambda ca, peers: {"peers": _spec(peers, partitions=[2])},
                         r"partitions \[3\] committed on peer .* acked elsewhere"),
    "lost-partition": (lambda ca, peers: {"peers": _spec(peers, partitions=[1, 2, 3])},
                       r"partitions \[1\] acked on peer .* not committed"),
    "pass-skew": (lambda ca, peers: (_skew(peers), {})[1], "missed a pass boundary"),
    "target-is-a-peer": (lambda ca, peers: {"peers": {
        **_spec(peers), ca.mesh_info()["id"]: {"boot_id": ca.mesh_info()["boot_id"],
                                               "rows": N // 2, "partitions": [0, 1]}}},
        "must not include the target"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_reduce_mesh_refuses_before_anything_folds(case):
    make, match = REFUSALS[case]
    with _port_daemons(2) as daemons:
        ca, peers = _setup(daemons, "kmeans")
        overrides = make(ca, peers)
        target_before = _export(ca)
        peers_before = [_export(c) for _d, c, _r, _p in peers]
        req = {"epoch": ca.mesh_info()["epoch"], "peers": _spec(peers), **overrides}
        with pytest.raises(RuntimeError, match=match):
            ca.reduce_mesh("j", epoch=req["epoch"], peers=req["peers"], algo="kmeans",
                           params=JOBS["kmeans"][1], drop_peers=True)
        got, meta = _export(ca)
        _assert_same_arrays(got, target_before[0])
        assert meta == target_before[1]
        for (d, c, _r, _p), (arrays, pmeta) in zip(peers, peers_before):
            assert "j" in d._jobs  # drop_peers did not run
            now, now_meta = _export(c)
            _assert_same_arrays(now, arrays)
            assert now_meta == pmeta


def test_a_replay_after_drop_peers_returns_the_cached_ack():
    with _port_daemons(2) as daemons:
        ca, peers = _setup(daemons, "pca")
        epoch = ca.mesh_info()["epoch"]
        req = {"op": "reduce_mesh", "job": "j", "epoch": epoch, "peers": _spec(peers),
               "algo": "pca", "params": {}, "drop_peers": True, "reduce_id": "r-1"}
        first, _ = ca._roundtrip(dict(req))
        assert not daemons[1]._jobs  # the peer's job went with the reduce
        # The replay meets no peer job and a stale epoch, and must still ack.
        daemons.append(DataPlaneDaemon(device="cpu").start())
        try:
            replay, _ = ca._roundtrip(dict(req))
        finally:
            daemons.pop().stop()
        assert replay["rows"] == first["rows"] == N and replay["reduced"] == 1
        assert _export(ca)[1]["rows"] == N


def test_reduce_mesh_creates_a_target_that_was_fed_no_row():
    with _port_daemons(2) as (a, b):
        cb = DataPlaneClient(*b.address)
        n = _feed_partitions(cb, "linreg", "j", 1, [0, 1, 2, 3])
        ca = DataPlaneClient(*a.address)
        ca.reduce_mesh("j", epoch=ca.mesh_info()["epoch"], algo="linreg", peers={
            b.instance_id: {"boot_id": b.boot_id, "rows": n, "partitions": [0, 1, 2, 3]}})
        _assert_same_arrays(_export(ca)[0], _export(cb)[0])
        assert a._jobs["j"].algo == "linreg" and a._jobs["j"].rows == n


def _peer_on_pass1(cb):
    """A kmeans peer job on pass 1 that committed partitions 0-1 there."""
    _open(cb, "kmeans", "j")
    arrays, _ = cb.get_iterate("j")
    cb.set_iterate("j", arrays, 1)
    _feed_pass1(cb, [0, 1])
    return "kmeans", N // 2, "missed a pass boundary"  # the new target opens pass 0


def _peer_of_another_algo(cb):
    return "pca", _feed_partitions(cb, "linreg", "j", 1, [0, 1]), r"job is \(linreg"


@pytest.mark.parametrize("make_peer", [_peer_on_pass1, _peer_of_another_algo],
                         ids=["pass-skew", "algo-mismatch"])
def test_a_refused_reduce_into_no_job_leaves_no_orphan(make_peer):
    """The target had no job: the one ``reduce_mesh`` would create is
    checked and folded before it is published, so a refusal leaves none."""
    with _port_daemons(2) as (a, b):
        cb = DataPlaneClient(*b.address)
        algo, n, match = make_peer(cb)
        ca = DataPlaneClient(*a.address)
        with pytest.raises(Exception, match=match):
            ca.reduce_mesh("j", epoch=ca.mesh_info()["epoch"], algo=algo,
                           params=JOBS[algo][1], peers={
                               b.instance_id: {"boot_id": b.boot_id, "rows": n,
                                               "partitions": [0, 1]}})
        assert a._jobs == {}
        assert "j" in b._jobs


def test_a_commit_between_the_peek_and_the_fold_is_not_folded():
    """A late commit on the peer (a fenced zombie, a speculative duplicate
    of another partition) that lands after the pre-reduce checks read the
    peer's job: the fold adds the state those checks saw, not the peer's
    live state, so the target equals the hub's merge of the checked rows."""
    with _port_daemons(2) as hub_daemons, _port_daemons(2) as daemons:
        ca_hub, peers_hub = _setup(hub_daemons, "pca")
        _hub(ca_hub, "pca", peers_hub)
        ca, peers = _setup(daemons, "pca")
        d, c, _rows_, _parts = peers[0]
        c.feed("j", _rows(7)[0][:40], algo="pca", partition=9)  # staged, not committed
        pjob = d._jobs["j"]
        real_peek = pjob.peek_pass_state

        def peek_then_commit():
            out = real_peek()
            pjob.commit(9)  # lands after the checks' read, before the fold
            return out

        pjob.peek_pass_state = peek_then_commit
        _reduce(ca, "pca", peers)
        assert 9 in pjob.committed  # the late commit did land on the peer
        got, meta = _export(ca)
        want, meta_hub = _export(ca_hub)
        _assert_same_arrays(got, want)
        assert meta["rows"] == meta_hub["rows"] == N


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_daemons(n):
    return _daemons(n, cls=JaxDaemon)


def _responses(daemons, client_cls):
    """merge_state, mesh_info and reduce_mesh responses, through
    ``client_cls``, of a pca job on three daemons: peer 1 by the hub, peer 2
    by the collective reduce."""
    ca, peers = _setup(daemons, "pca", integer=True, client_cls=client_cls)
    arrays, meta = peers[0][1].export_state("j")
    merged = ca.merge_state("j", arrays, rows=int(meta["pass_rows"]), algo="pca",
                            n_cols=int(meta["n_cols"]), params={})
    info = ca.mesh_info()
    reduced = ca.reduce_mesh("j", epoch=info["epoch"], peers=_spec(peers[1:]), algo="pca",
                             params={}, drop_peers=True)
    return merged, info, reduced, _export(ca)


def test_the_jax_client_gets_the_jax_daemons_responses():
    with jax_ledger_off(), _jax_daemons(3) as jds, _port_daemons(3) as pds:
        j_merged, j_info, j_reduced, j_state = _responses(jds, JaxClient)
        p_merged, p_info, p_reduced, p_state = _responses(pds, JaxClient)
    assert p_merged == j_merged == 2 * (N // 2)
    assert set(p_info) == set(j_info)
    assert set(p_info["members"][0]) == set(j_info["members"][0])
    assert {m["id"] for m in p_info["members"]} >= {d.instance_id for d in pds}
    assert set(p_reduced) == set(j_reduced)
    assert p_reduced["rows"] == j_reduced["rows"] == 3 * (N // 2)
    assert p_reduced["reduced"] == j_reduced["reduced"] == 1
    assert p_state[1]["rows"] == j_state[1]["rows"]


@pytest.fixture
def float64_both():
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax_ledger_off())
        for cfg in (jax_config, config):
            stack.enter_context(cfg.option("compute_dtype", "float64"))
            stack.enter_context(cfg.option("accum_dtype", "float64"))
        yield


@pytest.mark.parametrize("name", ["pca", "linreg", "kmeans"])
@pytest.mark.parametrize("path", ["hub", "collective"])
def test_merged_state_equals_the_jax_daemons(name, path, float64_both):
    """Integer rows: every statistic is an exact float64 sum, so the two
    packages' merged states agree bitwise whatever order each adds in."""
    states = []
    for open_daemons, client_cls in ((_jax_daemons, JaxClient), (_port_daemons, DataPlaneClient)):
        with open_daemons(3) as daemons:
            ca, peers = _setup(daemons, name, integer=True, client_cls=client_cls)
            if path == "hub":
                _hub(ca, name, peers)
            else:
                _reduce(ca, name, peers)
            states.append(_export(ca))
    (jax_arrays, jax_meta), (port_arrays, port_meta) = states
    assert len(port_arrays) == len(jax_arrays)
    for p, j in zip(port_arrays, jax_arrays):
        np.testing.assert_array_equal(p.astype(np.float64), np.asarray(j, np.float64))
    for key in ("rows", "pass_rows", "iteration", "algo", "n_cols"):
        assert port_meta[key] == jax_meta[key], key


@pytest.mark.parametrize("env, conf", [
    (None, None),
    ("127.0.0.1:7077, gpu-host-1:7078,", None),
    (None, "gpu-host-0:7077,gpu-host-1:7077"),
    ("a:1", "b:2"),
], ids=["unset", "env", "conf", "env-before-conf"])
def test_resolve_all_equals_the_jax_module(env, conf, monkeypatch):
    """The configured daemons a seeded fit seeds before its first scan."""
    from sparksim import SimSparkSession
    from spark_rapids_ml_tpu.spark import daemon_session as jax_ds
    from spark_rapids_ml_tpu_torch.spark import daemon_session

    monkeypatch.delenv("SRML_DAEMON_ADDRESSES", raising=False)
    if env is not None:
        monkeypatch.setenv("SRML_DAEMON_ADDRESSES", env)
    spark = SimSparkSession({} if conf is None else {"spark.srml.daemon.addresses": conf})
    for s in (None, spark):
        assert daemon_session.resolve_all(s) == jax_ds.resolve_all(s)
    want = {(None, None): [], ("a:1", "b:2"): [("a", 1)]}.get((env, conf))
    if want is not None:
        assert daemon_session.resolve_all(spark) == want
