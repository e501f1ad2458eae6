"""Durable daemons (a ``state_dir``) and the version fence of the port's
daemon, against the JAX daemon where both answer the same requests.

* The instance identity survives a restart on the same ``state_dir``;
  ``boot_id`` does not; ``health`` answers ``durable``; the flight recorder
  writes its bundles under ``state_dir/incidents/``.
* A kmeans, a logreg and an rf fit through the port's driver loops, the
  daemon stopped at a pass boundary and a new one started on the same port
  and ``state_dir``: the job restores lazily at the boundary
  (``srml_daemon_job_restores_total`` counts it once) and the resumed fit
  is bitwise the unbroken one's. A crash at ``daemon.pass_boundary`` leaves
  the stepped boundary's snapshot. ``drop`` and ``finalize`` delete it.
* The snapshots' metadata keys equal those the JAX daemon writes for the
  same ops (a seeded kmeans job; a built exact index).
* The reaper sweeps orphan job snapshots and crashed writes' temp files
  past the TTL, keeps an evicted index's snapshot 8× the TTL, and never
  sweeps a live index's.
* An exact and an IVF index built by a daemon process
  (``tests/torch_daemon_worker.py``) answer bitwise the same after a
  SIGKILL and a restart on the same ``state_dir``: the first mention
  restores them.
* The version fence: the JAX and the port daemon refuse the same
  mismatches, echo the same ``version`` and ``fleet_epoch``, refuse a
  second version under one name and adopt a late pin.
"""

import contextlib
import os
import signal
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.core import checkpoint as jax_checkpoint
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu_torch import (
    KMeans,
    LogisticRegression,
    RandomForestClassifier,
    config,
)
from spark_rapids_ml_tpu_torch.core import checkpoint
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
D = 6


def _restores(algo):
    snap = metrics_mod.snapshot().get("srml_daemon_job_restores_total", {}).get("samples", [])
    return sum(s["value"] for s in snap if s["labels"].get("algo") == algo)


def _files(state_dir, prefix):
    return sorted(f for f in os.listdir(state_dir) if f.startswith(prefix))


def test_identity_survives_a_restart_and_health_is_durable(tmp_path):
    sd = str(tmp_path / "state")
    with DataPlaneDaemon(device="cpu", state_dir=sd) as a, DataPlaneClient(*a.address) as c:
        first = c.server_info()
        h = c.health()
        assert h["durable"] is True and h["id"] == a.instance_id
        bundle = a._flight.trigger("manual", {"why": "test"}, force=True)
        assert bundle is not None and os.path.dirname(bundle) == os.path.join(sd, "incidents")
    with config.option("daemon_state_dir", sd), DataPlaneDaemon(device="cpu") as b, \
            DataPlaneClient(*b.address) as c:
        again = c.server_info()
    assert again["id"] == first["id"] and again["boot_id"] != first["boot_id"]
    with DataPlaneDaemon(device="cpu") as v, DataPlaneClient(*v.address) as c:
        assert c.health()["durable"] is False and c.server_id() != first["id"]
        assert v._flight.trigger("manual", force=True) is None  # no state_dir: no bundle


def _data(kind):
    rng = np.random.default_rng({"kmeans": 1, "logreg": 2, "rf": 3}[kind])
    x = rng.normal(size=(240, D)).astype(np.float32)
    if kind == "kmeans":
        x += np.repeat(rng.normal(size=(3, D)) * 4, 80, axis=0).astype(np.float32)
        return x, None
    return x, (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)


def _fit(kind, addr, restart=None):
    """One fit through the port's driver loop over ``addr`` with the four
    partition tasks in this process; ``restart(pass_id)`` runs before each
    scan."""
    x, y = _data(kind)
    job = f"dur-{kind}-{uuid.uuid4().hex[:6]}"
    fit = port_est._DaemonFit(*addr, job)
    parts = np.array_split(np.arange(x.shape[0]), 4)

    def run_pass(pass_id):
        if restart is not None:
            restart(pass_id)
        acks = []
        for p, idx in enumerate(parts):
            with DataPlaneClient(*addr) as c:
                def send(b, c=c, p=p):
                    c.feed_raw(job, b[0], b[1], algo=fit.algo, n_cols=D, params=fit.params,
                               partition=p, pass_id=pass_id)

                batch = (x[idx], None if y is None else y[idx])
                acks.append(port_est._feed_partition(c, [batch], send, job, p, 0, pass_id,
                                                     addr))
        return acks

    try:
        if kind == "kmeans":
            core = KMeans(device="cpu").setK(3).setMaxIter(3).setTol(0.0).setSeed(5)
            model = port_est._drive_kmeans(fit, run_pass, core, x[:64])
            return {"centers": np.asarray(model.centers)}
        if kind == "logreg":
            core = LogisticRegression(device="cpu").setMaxIter(3).setTol(0.0).setRegParam(0.01)
            model = port_est._drive_logreg(fit, run_pass, core, 2)
            return {"w": np.asarray(model.coefficients), "b": np.asarray(model.intercept)}
        core = (RandomForestClassifier(device="cpu").setNumTrees(3).setMaxDepth(2)
                .setMaxBins(8).setSeed(7))
        model = port_est._drive_forest(fit, run_pass, core, x[:120], 2)
        return dict(model.arrays)
    finally:
        fit.close()
        port_est._evict_daemon_id_cache(job)


@pytest.mark.parametrize("kind", ["kmeans", "logreg", "rf"])
def test_a_job_restores_at_its_pass_boundary_bitwise(kind, tmp_path):
    with DataPlaneDaemon(device="cpu") as plain:
        want = _fit(kind, plain.address)
    sd = str(tmp_path / "state")
    box = {"daemon": DataPlaneDaemon(device="cpu", state_dir=sd).start()}
    port = box["daemon"].address[1]
    before = _restores(kind)
    seen = {}

    def restart(pass_id):
        if pass_id == 1:
            old = box["daemon"]
            seen["files"] = _files(sd, "job-")
            seen["id"], seen["boot"] = old.instance_id, old.boot_id
            old.stop()
            box["daemon"] = DataPlaneDaemon(port=port, device="cpu", state_dir=sd).start()

    try:
        got = _fit(kind, box["daemon"].address, restart)
        new = box["daemon"]
    finally:
        box["daemon"].stop()
    assert len(seen["files"]) == 1  # the boundary's snapshot, before the stop
    assert new.instance_id == seen["id"] and new.boot_id != seen["boot"]
    assert _restores(kind) - before == 1
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert _files(sd, "job-") == []  # finalize deleted the snapshot


def test_a_crash_at_the_pass_boundary_leaves_the_stepped_snapshot(tmp_path):
    sd = str(tmp_path / "state")
    x, _ = _data("kmeans")
    with DataPlaneDaemon(device="cpu", state_dir=sd) as d, DataPlaneClient(
            *d.address, max_op_attempts=1) as c:
        c.seed_kmeans_raw("j", x[:64], k=3, params={"k": 3, "seed": 5})
        path = d._job_state_path("j")
        assert checkpoint.load_state(path)[1]["iteration"] == 0
        c.feed_raw("j", x, algo="kmeans", n_cols=D, params={"k": 3, "seed": 5}, pass_id=0)
        hits = []
        with faults.active(faults.FaultPlan().rule("daemon.pass_boundary", "crash")
                           .on_crash(lambda: hits.append(checkpoint.load_state(path)))):
            with pytest.raises(OSError):
                c.step("j")
        assert len(hits) == 1 and hits[0][1]["iteration"] == 1
        assert np.array_equal(hits[0][0]["centers"], d._jobs["j"].centers.numpy())
    with DataPlaneDaemon(device="cpu", state_dir=sd) as d2, DataPlaneClient(*d2.address) as c:
        assert c.status("j")["iteration"] == 1
        assert c.drop("j") and not os.path.exists(path)
        # A drop with no live job still deletes an orphan snapshot.
        checkpoint.save_state(d2._job_state_path("ghost"), {}, {"algo": "kmeans"})
        assert not c.drop("ghost") and _files(sd, "job-") == []


def _jax_meta(state_dir, prefix):
    (name,) = _files(state_dir, prefix)
    arrays, meta = jax_checkpoint.load_state(os.path.join(state_dir, name))
    return sorted(arrays), meta


def test_snapshot_metadata_equals_the_reference(tmp_path, mesh1):
    x, _ = _data("kmeans")
    q = x[:5]
    out = {}
    with jax_ledger_off():
        for name in ("port", "jax"):
            sd = str(tmp_path / name)
            if name == "port":
                ctx = DataPlaneDaemon(device="cpu", state_dir=sd)
            else:
                ctx = JaxDaemon(mesh=mesh1, state_dir=sd)
            with ctx as d, (DataPlaneClient if name == "port" else JaxClient)(*d.address) as c:
                params = {"k": 3, "seed": 5, "init": "k-means++"}
                if name == "port":
                    c.seed_kmeans_raw("km", x[:64], k=3, params=params)
                else:
                    c.seed_kmeans("km", x[:64], k=3, params=params)
                job = _jax_meta(sd, "job-")
                for p in range(2):
                    c.feed("nn", x[p * 100:(p + 1) * 100], algo="knn", partition=p)
                    c.commit("nn", partition=p)
                c.finalize_knn("nn", register_as="idx", mode="exact")
                model = _jax_meta(sd, "model-")
                out[name] = (job, model, c.kneighbors("idx", q, k=3))
    (pj, pm, pk), (jj, jm, jk) = out["port"], out["jax"]
    assert pj[0] == jj[0] and sorted(pj[1]) == sorted(jj[1])
    for key in ("name", "algo", "n_cols", "iteration", "rows"):
        assert pj[1][key] == jj[1][key], key
    assert pj[1]["params"] == jj[1]["params"]
    assert pm[0] == jm[0] and sorted(pm[1]) == sorted(jm[1])
    for key in ("name", "algo", "params", "sharded"):
        assert pm[1][key] == jm[1][key], key
    np.testing.assert_array_equal(pk[1], jk[1])


def test_the_reaper_sweeps_orphans_and_keeps_the_evicted_window(tmp_path):
    sd = str(tmp_path / "state")
    now = [0.0]
    x, _ = _data("kmeans")
    with DataPlaneDaemon(device="cpu", state_dir=sd, ttl=10.0, reap_interval=3600.0,
                         clock=lambda: now[0]) as d, DataPlaneClient(*d.address) as c:
        for p in range(2):
            c.feed_raw("nn", x[p * 100:(p + 1) * 100], algo="knn", n_cols=D, partition=p)
            c.commit("nn", partition=p)
        c.finalize_knn("nn", register_as="live", mode="exact")
        c.feed_raw("nn2", x[:50], algo="knn", n_cols=D)
        c.finalize_knn("nn2", register_as="evicted", mode="exact")
        live, evicted = d._model_state_path("live"), d._model_state_path("evicted")
        assert d._models["live"].ttl_scale == 1.0  # the snapshot re-creates it
        old = time.time() - 1000.0
        orphan, fresh = d._job_state_path("orphan"), d._job_state_path("fresh")
        checkpoint.save_state(orphan, {}, {"algo": "kmeans"})
        checkpoint.save_state(fresh, {}, {"algo": "kmeans"})
        tmp = os.path.join(sd, "job-x-0123456789.npz.abc.tmp")
        open(tmp, "wb").close()
        for path in (orphan, tmp, live, evicted):
            os.utime(path, (old, old))
        # "live" stays touched; "evicted" idles past the TTL.
        now[0] = 11.0
        d._models["live"].touched = now[0]
        d._reap_once()
        assert not os.path.exists(orphan) and not os.path.exists(tmp)
        assert os.path.exists(fresh)
        assert "evicted" not in d._models and os.path.exists(evicted)  # the 8x window
        assert os.path.getmtime(live) > old + 500  # a live index's snapshot is refreshed
        os.utime(evicted, (time.time() - 70.0,) * 2)  # 7x the TTL: kept
        d._reap_once()
        assert os.path.exists(evicted)
        os.utime(evicted, (time.time() - 90.0,) * 2)  # 9x the TTL: swept
        os.utime(live, (old, old))
        d._models["live"].touched = now[0]
        d._reap_once()
        assert not os.path.exists(evicted) and os.path.exists(live)
        # An evicted index within its window restores at its next mention
        # (model_status included: a deliberate difference, ROADMAP Queue 3).
        now[0] = 30.0
        d._reap_once()
        assert "live" not in d._models and os.path.exists(live)
        assert c.model_exists("live") and "live" in d._models
        assert c.drop_model("live") and not os.path.exists(live)
        assert not c.model_exists("live")


@contextlib.contextmanager
def _worker(state_dir, port=0):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SRML_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_daemon_worker.py"), "--state-dir",
         state_dir, "--port", str(port)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT, env=env, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY"), line
        yield proc, int(line.split()[1])
    finally:
        if proc.poll() is None:
            proc.stdin.close()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def test_indexes_restore_bitwise_after_a_sigkill(tmp_path):
    sd = str(tmp_path / "state")
    rng = np.random.default_rng(11)
    centres = rng.normal(size=(8, D)) * 3
    x = (centres[rng.integers(0, 8, 400)] + rng.normal(size=(400, D))).astype(np.float32)
    q = (centres[rng.integers(0, 8, 30)] + rng.normal(size=(30, D))).astype(np.float32)
    with _worker(sd) as (proc, port):
        with DataPlaneClient("127.0.0.1", port) as c:
            for job, reg, kw in (("e", "exact", {"mode": "exact"}),
                                 ("i", "ivf", {"mode": "ivf", "nlist": 8, "nprobe": 3})):
                for p in range(4):
                    c.feed_raw(job, x[p * 100:(p + 1) * 100], algo="knn", n_cols=D, partition=p)
                    c.commit(job, partition=p)
                c.finalize_knn(job, register_as=reg, **kw)
            before = {reg: c.kneighbors_raw(reg, q, k=5) for reg in ("exact", "ivf")}
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert len(_files(sd, "model-")) == 2
    with _worker(sd) as (_, port2), DataPlaneClient("127.0.0.1", port2) as c:
        assert c.health()["served_models"] == 0  # nothing is restored before it is named
        for reg in ("exact", "ivf"):
            d2, i2 = c.kneighbors_raw(reg, q, k=5)
            assert np.array_equal(d2, before[reg][0]) and np.array_equal(i2, before[reg][1])
        assert c.health()["served_models"] == 2


def _pca_arrays():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, D))
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        return port_pca.PCA(device="cpu").setK(2).fit({"features": x})._model_data(), x[:7]


def _fence_answers(c, pca, xq, knn_rows):
    """The answers of one daemon to the fence's requests: echoes, refusals
    (the error's key phrase) and adoption."""
    def attempt(fn):
        try:
            out = fn()
        except RuntimeError as e:
            msg = str(e)
            for key in ("version mismatch", "versions are immutable"):
                if key in msg:
                    return ("refused", key)
            return ("error", msg)
        return out

    def meta(**kw):
        _, m = c.transform("p@v1", xq, with_meta=True, **kw)
        return {k: m.get(k) for k in ("version", "fleet_epoch", "rows")}

    out = [c.ensure_model("p@v1", "pca", pca, version=1)]
    out.append(meta(version=1, fleet_epoch=7))
    out.append(meta())
    out.append(attempt(lambda: meta(version=2, fleet_epoch=8)))
    out.append(attempt(lambda: c.ensure_model("p@v1", "pca", pca, version=2)))
    out.append(c.ensure_model("p@v1", "pca", pca, version=1))
    out.append(c.ensure_model("q", "pca", pca))
    out.append(c.ensure_model("q", "pca", pca, version=3))  # the late pin is adopted
    out.append(attempt(lambda: c.transform("q", xq, version=4)))
    with config.option("serve_version_strict", False), \
            jax_config.option("serve_version_strict", False):
        out.append(meta(version=2, fleet_epoch=9))
    for p in range(2):
        c.feed("nn", knn_rows[p * 50:(p + 1) * 50], algo="knn", partition=p)
        c.commit("nn", partition=p)
    c.finalize_knn("nn", register_as="idx", mode="exact")
    out.append(c.kneighbors("idx", xq, k=2, version=5, fleet_epoch=3)[1].tolist())
    return out


def test_the_version_fence_answers_as_the_reference(mesh1):
    pca, xq = _pca_arrays()
    knn_rows = np.random.default_rng(4).normal(size=(100, D)).astype(np.float32)
    answers = {}
    with jax_ledger_off(), contextlib.ExitStack() as stack:
        for cfg in (jax_config, config):
            stack.enter_context(cfg.option("compute_dtype", "float64"))
            stack.enter_context(cfg.option("accum_dtype", "float64"))
            stack.enter_context(cfg.option("serve_batching", False))
        with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
            answers["port"] = _fence_answers(c, pca, xq, knn_rows)
        with JaxDaemon(mesh=mesh1) as d, JaxClient(*d.address) as c:
            answers["jax"] = _fence_answers(c, pca, xq, knn_rows)
    assert answers["port"] == answers["jax"]
    assert answers["port"][3] == ("refused", "version mismatch")
    assert answers["port"][4] == ("refused", "versions are immutable")
    assert answers["port"][8] == ("refused", "version mismatch")
    assert answers["port"][1] == {"version": 1, "fleet_epoch": 7, "rows": 7}
