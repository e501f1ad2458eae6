"""The port's fleet control plane (``serve/fleet.py``) against the JAX
package's, over port daemons on the CPU.

* The JAX ``ModelFleet`` (ledger off) and the port's each drive a trio of
  port daemons through register → rollout → register → scale_out →
  scale_in: the results, every daemon's gossiped model table (active
  version, fleet epoch, tombstoned versions, intent) and replica liveness,
  the controller's own view and ``status`` are equal, addresses, ids and
  timestamps aside.
* Routed answers through a rollout, an interrupted and resumed rollout and
  a scale-in under concurrent threads: every one equal, bitwise, to the
  solo answer of a version, each thread's versions never going back, none
  dropped.
* A drain timeout keeps the old version registered; a fleet whose replicas
  are all dead raises ``FleetRolloutError`` and keeps serving the old
  version's record.
* Rollouts interrupted through ``fleet.rollout`` before and after the flip,
  finished or aborted by a successor bootstrapped from one seed; a
  controller in a process of its own dying at its first gossiped intent.
* An exact index rolls out warmed (the port's deliberate difference).
* ``daemon_session.fleet_seeds`` reads its ladder as the JAX reader does.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.serve import fleet as jax_fleet
from spark_rapids_ml_tpu.serve.daemon import _model_width as jax_model_width
from spark_rapids_ml_tpu.spark import daemon_session as jax_session
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import fleet as port_fleet
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from torch_port_helpers import daemon_addr, jax_ledger_off

torch.set_num_threads(2)

D = 12
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    faults.deactivate()
    assert faults.active_plan() is None


@pytest.fixture(scope="module")
def versions():
    """Three PCA versions' arrays (float32) and query rows."""
    rng = np.random.default_rng(22)
    x = rng.normal(size=(300, D)).astype(np.float32)
    out = [port_pca.PCA(device="cpu").setK(k).fit({"features": x * s + s})._model_data()
           for k, s in ((3, 1.0), (4, 2.0), (2, 3.0))]
    return out, rng.normal(size=(24, D)).astype(np.float32)


def _daemons(n, **kw):
    return [DataPlaneDaemon(device="cpu", serve_batching=False, **kw).start()
            for _ in range(n)]


def _stop(daemons):
    for d in daemons:
        d.stop()


def _solo(daemon, name, x):
    with DataPlaneClient(*daemon.address) as c:
        return c.transform_raw(name, x)["output"]


def _counter(name, **labels):
    snap = metrics_mod.snapshot().get(name, {}).get("samples", [])
    return sum(s["value"] for s in snap
               if all(s["labels"].get(k) == v for k, v in labels.items()))


# ---------------------------------------------------------------------------
# the gossiped state after one control-plane sequence, JAX fleet vs port fleet
# ---------------------------------------------------------------------------


def _canon(obj, names):
    """``obj`` with every daemon address spelled by its daemon's index."""
    if isinstance(obj, dict):
        return {_canon(k, names): _canon(v, names) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v, names) for v in obj]
    return names.get(obj, obj) if isinstance(obj, str) else obj


def _tables(wire, names):
    models = {
        name: {"active_version": r["active_version"], "fleet_epoch": r["fleet_epoch"],
               "tombstones": sorted(r.get("tombstones") or {}, key=int),
               "intent": None if not r.get("intent") else
               {k: r["intent"][k] for k in ("model", "from_version", "to_version", "phase")}}
        for name, r in (wire.get("models") or {}).items()}
    replicas = sorted((names.get(r["addr"], r["addr"]), r["liveness"])
                      for r in (wire.get("replicas") or {}).values())
    return {"models": models, "replicas": replicas}


def _sequence(fleet_cls, daemons, arrays):
    """register → rollout → register → scale_out → scale_in over the first
    three of ``daemons`` (the fourth is the newcomer); everything the
    controller and the daemons show after each step."""
    names = {daemon_addr(d): f"d{i}" for i, d in enumerate(daemons)}
    out = []

    def views(fleet):
        out.append([_tables(_pull(d), names) for d in daemons])
        out.append(_tables(fleet.view.to_wire(), names))

    with fleet_cls([d.address for d in daemons[:3]]) as fleet:
        out.append(fleet.register("m", "pca", arrays[0], version=1))
        views(fleet)
        out.append(fleet.rollout("m", "pca", arrays[1]))
        views(fleet)
        out.append(fleet.register("n", "pca", arrays[2], version=5))
        out.append(fleet.scale_out(daemon_addr(daemons[3])))
        views(fleet)
        out.append(fleet.scale_in(daemon_addr(daemons[0])))
        views(fleet)
        _settle(daemons)
        status = fleet.status("m")
        for entry in status["replicas"].values():
            entry["health"] = {k: entry["health"][k] for k in ("queue_depth", "busy")}
        out.append(status)
        out.append((fleet.table.snapshot("m"), fleet.table.snapshot("n"),
                    sorted(names[r.key] for r in fleet.table.replicas())))
    return _canon(out, names)


def _pull(daemon):
    with DataPlaneClient(*daemon.address) as c:
        return c.gossip_pull()


def _settle(daemons, timeout_s=10.0):
    """Wait until no daemon holds a connection. A closed client's
    connection counts in the daemon's ``queue_depth`` until its thread
    ends, which on a loaded host can outlast the next op: the status's
    health would then read 2 on one replica in one of the two runs."""
    deadline = time.monotonic() + timeout_s
    while any(d._active_conns for d in daemons) and time.monotonic() < deadline:
        time.sleep(0.005)


def test_the_gossiped_state_follows_the_reference(versions):
    arrays, _ = versions
    results = []
    for fleet_cls in (jax_fleet.ModelFleet, port_fleet.ModelFleet):
        daemons = _daemons(4)
        try:
            with jax_ledger_off():
                results.append(_sequence(fleet_cls, daemons, arrays))
        finally:
            _stop(daemons)
    want, got = results
    assert got == want
    # Not vacuous: the sequence ends with m at v3 and n at v6 on d1–d3, the
    # retired versions tombstoned and d0 a tombstone in the controller's view.
    final = got[-3]
    assert final["models"] == {
        "m": {"active_version": 3, "fleet_epoch": 3, "tombstones": ["1", "2"], "intent": None},
        "n": {"active_version": 6, "fleet_epoch": 2, "tombstones": ["5"], "intent": None}}
    assert final["replicas"] == [["d0", "tombstone"], ["d1", "up"], ["d2", "up"], ["d3", "up"]]
    assert got[-2]["model"] == {"name": "m", "active": 3, "epoch": 3, "installed": [3]}
    assert sorted(got[-2]["replicas"]) == ["d1", "d2", "d3"]
    assert got[-1] == [[3, 3, "m@v3"], [6, 2, "n@v6"], ["d1", "d2", "d3"]]


# ---------------------------------------------------------------------------
# routed answers through rollouts, a resumed rollout and a scale-in
# ---------------------------------------------------------------------------


def test_routed_answers_stay_bitwise_through_rollouts_resume_and_scale_in(versions):
    """Eight routing threads keep sending transforms while the fleet rolls
    v1 → v2, dies in the v2 → v3 rollout after the flip (a successor from one
    seed completes it) and scales in: every answer is one version's solo
    answer, bitwise, a thread never goes back a version, none fails."""
    arrays, x = versions
    daemons = _daemons(3)
    try:
        with DataPlaneClient(*daemons[0].address) as c:
            for v, a in enumerate(arrays, start=1):
                c.ensure_model(f"ref@v{v}", "pca", a, version=v)
        refs = [_solo(daemons[0], f"ref@v{v}", x) for v in (1, 2, 3)]
        stop = threading.Event()
        seen = [[] for _ in range(8)]
        with port_fleet.ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", arrays[0], version=1)

            def pound(i):
                with fleet.client() as fc:
                    while True:
                        last = stop.is_set()
                        try:
                            out = fc.transform("m", x, route_key=f"t{i}-{len(seen[i])}")["output"]
                            hit = [v for v, r in enumerate(refs, 1) if np.array_equal(out, r)]
                            seen[i].append(hit[0] if hit else "mixed")
                        except Exception as e:  # noqa: BLE001 - counted, the test fails
                            seen[i].append(repr(e))
                        if last:
                            return

            threads = [threading.Thread(target=pound, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            try:
                res = fleet.rollout("m", "pca", arrays[1])
                assert res["drained"] and res["version"] == 2
                plan = faults.FaultPlan().rule("fleet.rollout", "drop", after=2, times=1)
                with faults.active(plan):
                    with pytest.raises(ConnectionError):
                        fleet.rollout("m", "pca", arrays[2], warm=False)
                with port_fleet.ModelFleet.from_seeds([daemon_addr(daemons[1])]) as successor:
                    assert successor.table.intent("m")["phase"] == "draining"
                    res = successor.resume_rollout("m")
                    assert res["action"] == "completed" and res["drained"]
                res = fleet.scale_in(daemon_addr(daemons[2]))
                assert res["drained"] and res["replicas"] == 2
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=60)
                    assert not t.is_alive()
        flat = [v for s in seen for v in s]
        assert all(v in (1, 2, 3) for v in flat), [v for v in flat if v not in (1, 2, 3)][:3]
        for s in seen:
            assert s and s == sorted(s), s[:20]
            assert s[-1] == 3
        assert {1, 2, 3} <= set(flat)
        # scale_in rolled m one version forward: v3's arrays as v4 on d0, d1.
        with DataPlaneClient(*daemons[0].address) as c:
            assert c.model_exists("m@v4") and not c.model_exists("m@v3")
    finally:
        _stop(daemons)


def test_a_drain_timeout_keeps_the_old_version_registered(versions):
    arrays, x = versions
    daemons = _daemons(2)
    try:
        with port_fleet.ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", arrays[0], version=1)
            pinned = fleet.table.acquire("m")  # a request in flight on v1
            d0 = _counter("srml_fleet_drains_total", outcome="timeout")
            res = fleet.rollout("m", "pca", arrays[1], drain_timeout_s=0.05)
            assert res == {"version": 2, "previous": 1, "epoch": 2, "replicas": 2,
                           "failed": [], "drained": False}
            assert _counter("srml_fleet_drains_total", outcome="timeout") - d0 == 1
            for d in daemons:
                with DataPlaneClient(*d.address) as c:
                    assert c.model_exists("m@v1") and c.model_exists("m@v2")
            assert np.array_equal(_solo(daemons[1], "m@v1", x), _solo(daemons[0], "m@v1", x))
            assert fleet.table.versions("m") == [1, 2]
            assert "1" not in _pull(daemons[0])["models"]["m"]["tombstones"]
            fleet.table.done("m", pinned[0])
            assert fleet.table.wait_drained("m", 1, 1.0)
    finally:
        _stop(daemons)


def test_all_replicas_dead_raise_and_the_old_version_keeps_its_record(versions):
    arrays, _ = versions
    daemons = _daemons(2)
    kw = {"client_kwargs": {"timeout": 2.0, "op_deadline_s": 2.0, "max_op_attempts": 1}}
    try:
        with port_fleet.ModelFleet([d.address for d in daemons], **kw) as fleet:
            fleet.register("m", "pca", arrays[0], version=1)
            _stop(daemons)
            fleet.close()  # drop the pooled connections to the stopped daemons
            with pytest.raises(port_fleet.FleetRolloutError, match="v1 keeps serving"):
                fleet.rollout("m", "pca", arrays[1])
            assert fleet.table.snapshot("m") == (1, 1, "m@v1")
            assert fleet.table.intent("m") is None and fleet.table.versions("m") == [1]
            assert fleet.view.model("m")["intent"] is None
            with pytest.raises(port_fleet.FleetRolloutError, match="no replica accepted"):
                fleet.register("n", "pca", arrays[0])
            assert "n" not in fleet.table.models()
            assert all(not r.alive for r in fleet.table.replicas())
    finally:
        _stop(daemons)


# ---------------------------------------------------------------------------
# interrupted rollouts and their successors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("after, phase, action", [(0, "registering", "aborted"),
                                                  (1, "warming", "aborted"),
                                                  (2, "flipped", "completed"),
                                                  (3, "draining", "completed")])
def test_an_interrupted_rollout_is_finished_by_a_successor(versions, after, phase, action):
    """The controller dies at the ``fleet.rollout`` site of one phase (warm
    on: registering, warming, flipped, draining); a successor bootstrapped
    from one seed aborts before the flip (v1 serves bitwise, v2 dropped and
    tombstoned, a retried rollout to v2 works) and completes after it (v2
    serves, v1 dropped and tombstoned)."""
    arrays, x = versions
    daemons = _daemons(3)
    try:
        want = []
        with DataPlaneClient(*daemons[0].address) as c:
            for v in (1, 2):
                c.ensure_model(f"ref@v{v}", "pca", arrays[v - 1], version=v)
                want.append(c.transform_raw(f"ref@v{v}", x)["output"])
        with port_fleet.ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", arrays[0], version=1)
            plan = faults.FaultPlan().rule("fleet.rollout", "drop", after=after, times=1)
            with faults.active(plan), pytest.raises(ConnectionError):
                fleet.rollout("m", "pca", arrays[1], version=2)
        seed = daemon_addr(daemons[after % 3])
        with port_fleet.ModelFleet.from_seeds([seed]) as successor:
            intent = successor.table.intent("m")
            assert intent["phase"] == phase and intent["to_version"] == 2
            res = successor.resume_rollout("m")
            assert res["action"] == action and res["version"] == 2
            active = 1 if action == "aborted" else 2
            with successor.client() as fc:
                assert np.array_equal(fc.transform("m", x)["output"], want[active - 1])
            assert successor.resume_rollout("m") == {"action": "none", "model": "m"}
            gone = 2 if action == "aborted" else 1
            for d in daemons:
                rec = _pull(d)["models"]["m"]
                assert rec["active_version"] == active and rec["intent"] is None
                assert str(gone) in rec["tombstones"]
                with DataPlaneClient(*d.address) as c:
                    assert not c.model_exists(f"m@v{gone}") and c.model_exists(f"m@v{active}")
            if action == "aborted":
                # A retried rollout to the tombstoned version number.
                successor.rollout("m", "pca", arrays[1], version=2)
                with successor.client() as fc:
                    assert np.array_equal(fc.transform("m", x)["output"], want[1])
    finally:
        _stop(daemons)


def test_a_controller_process_dying_at_its_first_intent_is_aborted(versions, tmp_path):
    """A controller that is a process of its own (its gossip clock starts at
    zero) dies at the ``registering`` intent, its first gossiped write: the
    intent is on every daemon all the same, so a successor aborts it. The
    reference's ``from_seeds`` stamps that write below the records the
    daemons hold, and the fleet keeps theirs."""
    arrays, _ = versions
    daemons = _daemons(3)
    try:
        with port_fleet.ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", arrays[0], version=1)
            for _ in range(20):  # the fleet's records far above a fresh clock
                fleet._push_view()
        npz = tmp_path / "v2.npz"
        np.savez(npz, **arrays[1])
        env = {k: v for k, v in os.environ.items() if not k.startswith("SRML_")}
        env["SRML_TORCH_FAULT_PLAN"] = "fleet.rollout:crash:times=1"
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "torch_rollout_worker.py"),
             daemon_addr(daemons[0]), str(npz), "m", "2"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 17, proc.stdout + proc.stderr
        for d in daemons:
            assert _pull(d)["models"]["m"]["intent"]["phase"] == "registering"
        with port_fleet.ModelFleet.from_seeds([daemon_addr(daemons[2])]) as successor:
            assert successor.resume_rollout("m")["action"] == "aborted"
            assert successor.table.snapshot("m") == (1, 1, "m@v1")
    finally:
        _stop(daemons)


# ---------------------------------------------------------------------------
# the exact index, the seeds ladder
# ---------------------------------------------------------------------------


def test_an_exact_index_rolls_out_warmed_beyond_the_reference():
    """The port's fleet warms an exact index at registration and rollout (the
    port's ``_model_width`` gives it a width; the reference's gives none and
    skips the warmup); the routed kneighbors answers as the replica does."""
    rng = np.random.default_rng(5)
    rows = [rng.normal(size=(200, D)).astype(np.float32) for _ in range(2)]
    q = rng.normal(size=(7, D)).astype(np.float32)
    assert jax_model_width("knn", {"database": rows[0]}) is None
    assert port_fleet._model_width("knn", {"database": rows[0]}) == D
    with config.option("serve_batch_buckets", "8,16"), \
            config.option("serve_max_batch_rows", 16):
        daemons = [DataPlaneDaemon(device="cpu").start() for _ in range(2)]
    try:
        with port_fleet.ModelFleet([d.address for d in daemons]) as fleet:
            w0 = _counter("srml_daemon_requests_total", op="warmup")
            fleet.register("e", "knn", {"database": rows[0]}, params={"k": 3})
            res = fleet.rollout("e", "knn", {"database": rows[1]}, params={"k": 3})
            assert res["drained"] and res["version"] == 2
            assert _counter("srml_daemon_requests_total", op="warmup") - w0 == 4
            with DataPlaneClient(*daemons[1].address) as c:
                info = c.warmup("e@v2", n_cols=D)
                assert info["enabled"] and info["compiled"] == 0  # the ladder already seen
                want = c.kneighbors_raw("e@v2", q)
            with fleet.client() as fc:
                got = fc.kneighbors("e", q)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    finally:
        _stop(daemons)


class _Conf:
    def __init__(self, values):
        self.conf = self
        self._values = values

    def get(self, key):
        if key not in self._values:
            raise KeyError(key)
        return self._values[key]


@pytest.mark.parametrize("env, conf, cfg", [
    (None, None, None),
    (None, None, "10.0.0.1:7000, 10.0.0.2:7000"),
    (None, "h1:1,h2:2", "10.0.0.1:7000"),
    ("e1:1,,e2:2 ", "h1:1", "10.0.0.1:7000"),
])
def test_fleet_seeds_reads_its_ladder_as_the_reference(monkeypatch, env, conf, cfg):
    from spark_rapids_ml_tpu import config as jax_config

    spark = _Conf({} if conf is None else {"spark.srml.fleet.seed_addresses": conf})
    for name in ("SRML_FLEET_SEED_ADDRESSES", "SRML_TORCH_FLEET_SEED_ADDRESSES"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    with config.option("fleet_seed_addresses", cfg), \
            jax_config.option("fleet_seed_addresses", cfg):
        got = daemon_session.fleet_seeds(spark)
        want = jax_session.fleet_seeds(spark)
        assert daemon_session.fleet_seeds() == jax_session.fleet_seeds()
    assert got == want
    assert got == [a.strip() for a in (env or conf or cfg or "").split(",") if a.strip()]
