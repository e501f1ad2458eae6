"""The port's gossiped fleet view (``serve/gossip.py``) and the daemon's
gossip plane against the JAX package's.

* ``dominates`` equal to the reference's on a grid of (epoch, boot) pairs;
* ``FleetView.merge`` of the same seeded wire dicts, in every order, gives
  the JAX view's ``to_wire`` (each view on a deterministic epoch source and
  clock), with the same adoption counts (records that tie on (epoch, boot)
  with other contents keep the first merged, in both);
* tombstones never resurrect (a stale island's record loses; a strictly
  newer epoch is a genuine re-join), a stale model record pointing at a
  retired version degrades to no active version, and the TTL prune follows
  the reference's (``0`` keeps them);
* the daemon: its own replica record after the bind, ``gossip_push`` and
  ``gossip_pull`` answered as the JAX daemon answers them, the flight
  recorder's ``gossip`` provider, three daemons converging on one view by
  their gossip threads, and the ``gossip.push`` fault site dropping a tick.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.serve import gossip as jax_gossip
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import gossip as port_gossip
from spark_rapids_ml_tpu_torch.utils import faults
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)


class _Epochs:
    """A deterministic Lamport clock with the membership plane's
    ``tick``/``observe``."""

    def __init__(self, start=100):
        self.e = start

    def tick(self):
        self.e += 1
        return self.e

    def observe(self, epoch):
        self.e = max(self.e, int(epoch))
        return self.e


def _views(ttl=600.0, now=1000.0):
    return (jax_gossip.FleetView(epoch_source=_Epochs(), tombstone_ttl_s=ttl, clock=lambda: now),
            port_gossip.FleetView(epoch_source=_Epochs(), tombstone_ttl_s=ttl, clock=lambda: now))


def _wires(seed, n=4):
    """``n`` seeded wire dicts over 5 replicas and 3 models: random epochs,
    boots, liveness (tombstones too), active versions, version tombstones
    (some older than a 600 s TTL at clock 1000), and one malformed record."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        reps = {}
        for r in range(5):
            if rng.random() < 0.7:
                reps[f"r{r}"] = {
                    "addr": f"127.0.0.1:{7000 + r}", "boot_id": str(rng.choice(["a", "b", "c"])),
                    "liveness": str(rng.choice(["up", "up", "down", "tombstone"])),
                    "last_seen": float(rng.choice([100.0, 900.0, 950.0])),
                    "epoch": int(rng.integers(1, 7)),
                }
        models = {}
        for m in range(3):
            if rng.random() < 0.7:
                tombs = {str(v): {"epoch": int(rng.integers(1, 9)),
                                  "at": float(rng.choice([50.0, 800.0]))}
                         for v in (1, 2, 3) if rng.random() < 0.3}
                av = rng.integers(0, 4)
                models[f"m{m}"] = {
                    "active_version": None if av == 0 else int(av),
                    "fleet_epoch": int(rng.integers(0, 4)),
                    "intent": {"to": int(rng.integers(1, 4))} if rng.random() < 0.3 else None,
                    "tombstones": tombs, "epoch": int(rng.integers(1, 7)),
                    "boot_id": str(rng.choice(["a", "b"])),
                }
        if w == n - 1:
            reps["bad"] = {"epoch": "not-an-int"}
            models["bad"] = "not-a-dict"
        out.append({"wire_v": 1, "epoch": 7, "replicas": reps, "models": models})
    return out


@pytest.mark.parametrize("a", [(0, ""), (3, "a"), (3, "b"), (4, "a")])
@pytest.mark.parametrize("b", [(0, ""), (3, "a"), (3, "b"), (4, "a")])
def test_dominates_equals_the_reference(a, b):
    assert port_gossip.dominates(*a, *b) == jax_gossip.dominates(*a, *b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_in_every_order_equals_the_reference(seed):
    wires = _wires(seed)
    for order in itertools.permutations(range(len(wires))):
        jv, pv = _views()
        for i in order:
            assert pv.merge(wires[i]) == jv.merge(wires[i])
        assert pv.to_wire() == jv.to_wire()
        assert pv.snapshot() == jv.snapshot() and pv.epoch() == jv.epoch()


def test_tombstones_never_resurrect_and_prune_as_the_reference():
    for ttl, now in ((600.0, 1000.0), (0.0, 1e9)):
        jv, pv = _views(ttl=ttl, now=now)
        for v in (jv, pv):
            v.observe_replica("r1", "127.0.0.1:1", "a", epoch=10)
            v.tombstone_replica("r1")  # epoch 101 from the source
            v.set_model("m", 2, fleet_epoch=3, boot_id="a", tombstone_versions=(1,))
        stale = {"epoch": 50, "replicas": {
            "r1": {"addr": "127.0.0.1:1", "boot_id": "z", "liveness": "up", "last_seen": now,
                   "epoch": 60}},
            "models": {"m": {"active_version": 1, "fleet_epoch": 9, "epoch": 40,
                             "boot_id": "z", "tombstones": {}}}}
        assert pv.merge(stale) == jv.merge(stale)
        assert pv.to_wire() == jv.to_wire()
        for v in (jv, pv):
            assert v.replicas()[0]["liveness"] == "tombstone"  # the stale island lost
            assert v.model("m")["active_version"] == 2
        rejoin = {"epoch": 500, "replicas": {
            "r1": {"addr": "127.0.0.1:1", "boot_id": "b", "liveness": "up", "last_seen": now,
                   "epoch": 500}},
            "models": {"m": {"active_version": 1, "fleet_epoch": 9, "epoch": 90,
                             "boot_id": "z", "tombstones": {}}}}
        assert pv.merge(rejoin) == jv.merge(rejoin)
        assert pv.to_wire() == jv.to_wire()
        # A strictly newer epoch is a genuine re-join; the model record that
        # lost to the newer one keeps its retired version off.
        assert pv.replicas()[0]["liveness"] == "up"
        assert pv.model("m")["active_version"] == 2 and "1" in pv.model("m")["tombstones"]
    # The prune: a 600 s TTL at clock 1000 drops tombstones written before 400.
    jv, pv = _views(ttl=600.0, now=1000.0)
    old = {"epoch": 5, "replicas": {
        "r9": {"addr": "h:9", "boot_id": "a", "liveness": "tombstone", "last_seen": 100.0,
               "epoch": 5}},
        "models": {"m": {"active_version": 2, "fleet_epoch": 1, "epoch": 5, "boot_id": "a",
                         "tombstones": {"1": {"epoch": 4, "at": 100.0},
                                        "3": {"epoch": 4, "at": 900.0}}}}}
    assert pv.merge(old) == jv.merge(old)
    assert pv.to_wire() == jv.to_wire()
    assert pv.replicas() == [] and set(pv.model("m")["tombstones"]) == {"3"}


def test_local_writes_and_epochs_follow_the_reference():
    jv, pv = _views()
    for v in (jv, pv):
        v.observe_replica("r2", "127.0.0.1:2", "b")
        v.observe_replica("r1", "127.0.0.1:1", "a", liveness="down")
        v.set_model("m", 1, fleet_epoch=1, boot_id="a", intent={"from": 0, "to": 1})
        v.set_model("m", 2, fleet_epoch=2, boot_id="a", tombstone_versions=(1,))
        v.tombstone_replica("r3")
    assert pv.to_wire() == jv.to_wire() and pv.epoch() == jv.epoch() == 105
    assert [r["server_id"] for r in pv.replicas()] == ["r1", "r2", "r3"]
    with pytest.raises(ValueError):
        pv.observe_replica("r4", "h:4", "a", liveness="gone")


def _wire_shape(view):
    """A view's wire with the values that differ between two daemons (ids,
    boots, addresses, epochs, times) replaced by their types."""
    return {
        "keys": sorted(view),
        "replica_fields": sorted({f for r in view["replicas"].values() for f in r}),
        "liveness": sorted({r["liveness"] for r in view["replicas"].values()}),
    }


def test_the_daemons_gossip_ops_answer_as_the_reference(mesh1):
    with jax_ledger_off(), DataPlaneDaemon(device="cpu") as port, JaxDaemon(mesh=mesh1) as ref:
        answers = {}
        for name, daemon, client in (("port", port, DataPlaneClient), ("jax", ref, JaxClient)):
            with client(*daemon.address) as c:
                pulled = c.gossip_pull()
                own = pulled["replicas"][daemon.instance_id]
                assert own["addr"] == "%s:%d" % daemon.address
                assert own["boot_id"] == daemon.boot_id and own["liveness"] == "up"
                remote = {"epoch": 10**6, "replicas": {"peer": {
                    "addr": "127.0.0.1:1", "boot_id": "x", "liveness": "up",
                    "last_seen": 1.0, "epoch": 10**6}}, "models": {}}
                ack = c.gossip_push(remote)
                assert ack["merged"] == 1 and "peer" in ack["view"]["replicas"]
                assert ack["id"] == daemon.instance_id and ack["boot_id"] == daemon.boot_id
                again = c.gossip_push(remote)
                answers[name] = (_wire_shape(pulled), sorted(ack), again["merged"],
                                 _wire_shape(c.gossip_pull()))
        assert answers["port"] == answers["jax"]
        # The flight recorder's gossip provider is the view's wire.
        assert port._flight.providers["gossip"]() == port.fleet_view.to_wire()


def test_three_daemons_converge_and_a_faulted_push_drops_its_tick():
    daemons = [DataPlaneDaemon(device="cpu", gossip_interval_s=0.05, gossip_fanout=2).start()
               for _ in range(3)]
    try:
        # The control plane's seed: one view naming all three, pushed to one.
        view = port_gossip.FleetView()
        for d in daemons:
            view.merge(d.fleet_view.to_wire())
        view.set_model("m", 1, fleet_epoch=1, boot_id="ctl")
        with DataPlaneClient(*daemons[0].address) as c:
            c.gossip_push(view.to_wire())
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            wires = [d.fleet_view.to_wire() for d in daemons]
            if all(w["replicas"] == wires[0]["replicas"] and w["models"] == wires[0]["models"]
                   for w in wires) and len(wires[0]["replicas"]) == 3:
                break
            time.sleep(0.05)
        assert all(d.fleet_view.model("m")["active_version"] == 1 for d in daemons)
        assert len({d.fleet_view.epoch() for d in daemons}) == 1
        with faults.active(faults.FaultPlan(seed=3).rule("gossip.push", "drop")):
            out = daemons[1]._gossip_tick()
        assert out == {"pushed": 0, "dropped": 2}
        assert daemons[1]._gossip_tick()["dropped"] == 0
    finally:
        for d in daemons:
            d.stop()
