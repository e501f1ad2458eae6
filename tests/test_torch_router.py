"""The port's fleet router (``serve/router.py``) against the JAX package's,
and routed serving over port daemons on the CPU.

* ``ConsistentHashRing.primary`` and ``ordered`` equal to the reference's
  for 1,000 keys over 3–5 members, and after a member is removed or added;
* ``RoutingTable``'s epochs, snapshots, ``acquire`` pins, drain refcounts,
  membership changes and ``apply_view`` equal to the reference's over one
  scripted sequence;
* ``bootstrap_table`` from one seed, through a faulted seed
  (``fleet.bootstrap``) and a dead one, and ``FleetUnavailable`` when none
  answers;
* a bootstrapped ``FleetClient`` answers bitwise as one daemon does, past
  a dead replica and a busy one, re-registers a replica that lost the
  registration (in-band repair), and a client left on a retired version
  resyncs from the replica that refused it.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.serve import router as jax_router
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import gossip as port_gossip
from spark_rapids_ml_tpu_torch.serve import router as port_router
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

torch.set_num_threads(2)

D = 12


def _members(n):
    return [f"127.0.0.1:{7100 + 7 * i}" for i in range(n)]


@pytest.mark.parametrize("n", [3, 4, 5])
def test_ring_routes_as_the_reference(n):
    keys = [f"user-{i}" for i in range(1000)]
    members = _members(n + 1)
    for ring_members in (members[:n], members[:n - 1], members[:n + 1]):
        port = port_router.ConsistentHashRing(ring_members, vnodes=64)
        ref = jax_router.ConsistentHashRing(ring_members, vnodes=64)
        assert port.members == ref.members
        assert [port.primary(k) for k in keys] == [ref.primary(k) for k in keys]
        assert [port.ordered(k) for k in keys] == [ref.ordered(k) for k in keys]
    assert port_router._h64("x#0") == jax_router._h64("x#0")
    with pytest.raises(ValueError):
        port_router.ConsistentHashRing([])


def _script(mod):
    """One scripted control-plane and request sequence; everything it can
    observe, in order."""
    arrays = {"pc": np.eye(3)}
    t = mod.RoutingTable(_members(3), vnodes=16)
    out = [sorted(r.key for r in t.replicas())]
    out.append(t.install("m", 1, "pca", arrays))
    out.append(t.activate("m", 1))
    out.append(t.acquire("m"))
    out.append(t.inflight("m", 1))
    out.append(t.install("m", 2, "pca", arrays, params={"k": 3}))
    out.append(t.activate("m", 2))
    out.append(t.snapshot("m"))
    out.append(t.acquire("m"))
    out.append((t.inflight("m", 1), t.inflight("m", 2)))
    out.append(t.wait_drained("m", 1, 0.01))
    t.done("m", 1)
    out.append(t.wait_drained("m", 1, 0.01))
    t.retire("m", 1)
    out.append(t.versions("m"))
    with pytest.raises(ValueError):
        t.retire("m", 2)
    t.done("m", 2)
    out.append(t.inflight("m", 2))
    out.append({k: v for k, v in t.version_info("m", 2).items() if k != "arrays"})
    out.append(t.ensure_version("m", 3))
    out.append(t.models())
    key = sorted(r.key for r in t.replicas())[0]
    t.begin_replica(key)
    t.begin_replica(key)
    t.done_replica(key)
    out.append(t.replica(key).inflight)
    out.append(t.add_replica("127.0.0.1:7999"))
    t.remove_replica(_members(3)[1])
    out.append(sorted(r.key for r in t.replicas()))
    out.append([t.ring.ordered(f"k{i}") for i in range(50)])
    out.append(t.apply_view({
        "epoch": 42,
        "replicas": {
            "a": {"addr": "127.0.0.1:8001", "liveness": "up"},
            "b": {"addr": "127.0.0.1:7999", "liveness": "tombstone"},
            "c": {"addr": "127.0.0.1:8002", "liveness": "down"},
        },
        "models": {
            "m": {"active_version": 4, "fleet_epoch": 9, "epoch": 40,
                  "tombstones": {"3": {"epoch": 30, "at": 0.0}},
                  "intent": {"to": 4}},
            "n": {"active_version": 1, "fleet_epoch": 1, "epoch": 41, "tombstones": {}},
        },
    }))
    out.append((t.view_epoch, t.snapshot("m"), t.snapshot("n"), t.intent("m"), t.intents()))
    out.append(sorted(r.key for r in t.replicas()))
    out.append([t.ring.ordered(f"k{i}") for i in range(50)])
    stale = {"epoch": 5, "models": {"m": {"active_version": 2, "fleet_epoch": 1, "epoch": 3}}}
    out.append((t.apply_view(stale), t.snapshot("m")))
    t.set_intent("n", {"to": 2})
    out.append(t.intents())
    with pytest.raises(KeyError):
        t.snapshot("nope")
    with pytest.raises(KeyError):
        t.activate("m", 99)
    return out


def test_routing_table_follows_the_reference():
    assert _script(port_router) == _script(jax_router)


@pytest.fixture(scope="module")
def served():
    """(PCA v1 arrays, PCA v2 arrays, query rows) in float32."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(400, D)).astype(np.float32)
    m1 = port_pca.PCA(device="cpu").setK(3).fit({"features": x})._model_data()
    m2 = port_pca.PCA(device="cpu").setK(4).fit({"features": x * 2 + 1})._model_data()
    return m1, m2, rng.normal(size=(40, D)).astype(np.float32)


def _counter(name, **labels):
    snap = metrics_mod.snapshot().get(name, {}).get("samples", [])
    return sum(s["value"] for s in snap if all(s["labels"].get(k) == v
                                              for k, v in labels.items()))


def _fleet(n, served, **kw):
    """n daemons each holding PCA v1 under ``m@v1``, every view naming all
    of them with ``m`` active at v1."""
    m1 = served[0]
    daemons = [DataPlaneDaemon(device="cpu", serve_batching=False, **kw).start()
               for _ in range(n)]
    view = port_gossip.FleetView()
    for d in daemons:
        with DataPlaneClient(*d.address) as c:
            c.ensure_model("m@v1", "pca", m1, version=1)
        view.merge(d.fleet_view.to_wire())
    view.set_model("m", 1, fleet_epoch=1, boot_id="ctl")
    for d in daemons:
        with DataPlaneClient(*d.address) as c:
            c.gossip_push(view.to_wire())
    return daemons, view


def _solo(daemon, x, name="m@v1"):
    with DataPlaneClient(*daemon.address) as c:
        return c.transform_raw(name, x)["output"]


def test_bootstrap_from_one_seed_through_dead_and_faulted_seeds(served):
    daemons, _ = _fleet(3, served)
    try:
        addrs = ["%s:%d" % d.address for d in daemons]
        ok0, err0 = (_counter("srml_fleet_bootstraps_total", outcome=o) for o in ("ok", "error"))
        with faults.active(faults.FaultPlan(seed=1).rule("fleet.bootstrap", "drop", times=1)):
            table = port_router.bootstrap_table([addrs[0], "127.0.0.1:1", addrs[2]])
        assert sorted(r.key for r in table.replicas()) == sorted(addrs)
        assert table.snapshot("m") == (1, 1, "m@v1") and table.view_epoch > 0
        assert _counter("srml_fleet_bootstraps_total", outcome="ok") - ok0 == 1
        assert _counter("srml_fleet_bootstraps_total", outcome="error") - err0 == 2
        with pytest.raises(port_router.FleetUnavailable):
            port_router.bootstrap_table(["127.0.0.1:1"], passes=1)
        with pytest.raises(ValueError), config.option("fleet_seed_addresses", None):
            port_router.bootstrap_table(None)
        with config.option("fleet_seed_addresses", addrs[1]):
            assert port_router.bootstrap_table(None).snapshot("m") == (1, 1, "m@v1")
    finally:
        for d in daemons:
            d.stop()


def test_fleet_client_fails_over_bitwise_past_a_dead_and_a_busy_replica(served):
    x = served[2]
    daemons, _ = _fleet(3, served)
    busy = DataPlaneDaemon(device="cpu", serve_batching=False, max_connections=1).start()
    hold = None
    try:
        want = _solo(daemons[0], x)
        with DataPlaneClient(*busy.address) as c:
            c.ensure_model("m@v1", "pca", served[0], version=1)
        seed = "%s:%d" % daemons[0].address
        # A long poll interval: the health snapshots stay as first polled, so
        # each request meets the replica's state itself.
        with port_router.FleetClient.from_seeds(seed, health_poll_s=60.0) as fc:
            for i in range(6):
                assert np.array_equal(fc.transform("m", x, route_key=f"u{i}")["output"], want)
            table = fc._table
            # The busy replica joins the ring; a second open connection puts
            # it over its watermark, so it sheds every transform.
            table.add_replica("%s:%d" % busy.address)
            hold = DataPlaneClient(*busy.address)
            hold.ping()
            key = next(f"b{i}" for i in range(1000)
                       if table.ring.primary(f"b{i}") == "%s:%d" % busy.address)
            f0 = _counter("srml_router_failovers_total", reason="busy")
            got = fc.transform("m", x, route_key=key)["output"]
            assert np.array_equal(got, want)
            assert _counter("srml_router_failovers_total", reason="busy") - f0 >= 1
            hold.close()
            hold = None
            table.remove_replica("%s:%d" % busy.address)
            # A dead replica: the primary of a key stops; the request fails
            # over bitwise and the replica is marked dead.
            dead = daemons[1]
            dkey = next(f"d{i}" for i in range(1000)
                        if table.ring.primary(f"d{i}") == "%s:%d" % dead.address)
            dead.stop()
            d0 = _counter("srml_router_failovers_total", reason="dead")
            for _ in range(3):
                assert np.array_equal(fc.transform("m", x, route_key=dkey)["output"], want)
            assert _counter("srml_router_failovers_total", reason="dead") - d0 >= 1
            assert not table.replica("%s:%d" % dead.address).alive
            assert sum(fc.stats.values()) == 6 + 1 + 3
    finally:
        if hold is not None:
            hold.close()
        busy.stop()
        for d in daemons:
            d.stop()


def test_repair_and_resync(served):
    m1, m2, x = served
    daemons, view = _fleet(3, served)
    try:
        want1 = _solo(daemons[0], x)
        addrs = ["%s:%d" % d.address for d in daemons]
        # A table with the payload repairs a replica that lost the version.
        table = port_router.RoutingTable(addrs, vnodes=16)
        table.install("m", 1, "pca", m1)
        table.activate("m", 1)
        victim = daemons[2]
        with DataPlaneClient(*victim.address) as c:
            assert c.drop_model("m@v1")
        key = next(f"r{i}" for i in range(1000) if table.ring.primary(f"r{i}") == addrs[2])
        r0 = _counter("srml_router_repairs_total")
        with port_router.FleetClient(table, health_poll_s=0.05) as fc:
            assert np.array_equal(fc.transform("m", x, route_key=key)["output"], want1)
        assert _counter("srml_router_repairs_total") - r0 == 1
        with DataPlaneClient(*victim.address) as c:
            assert c.model_exists("m@v1")
        # A bootstrapped (payload-less) client left on v1 after a rollout to
        # v2 (v1's registrations retired everywhere) resyncs from the replica
        # that refused it and answers from v2.
        stale = port_router.FleetClient.from_seeds(addrs[0], health_poll_s=0.05)
        for d in daemons:
            with DataPlaneClient(*d.address) as c:
                c.ensure_model("m@v2", "pca", m2, version=2)
        want2 = _solo(daemons[0], x, "m@v2")
        view.set_model("m", 2, fleet_epoch=2, boot_id="ctl", tombstone_versions=(1,))
        for d in daemons:
            with DataPlaneClient(*d.address) as c:
                c.gossip_push(view.to_wire())
                c.drop_model("m@v1")
        s0 = _counter("srml_fleet_bootstraps_total", outcome="resync")
        with stale:
            assert np.array_equal(stale.transform("m", x)["output"], want2)
            assert stale._table.snapshot("m") == (2, 2, "m@v2")
        assert _counter("srml_fleet_bootstraps_total", outcome="resync") - s0 == 1
    finally:
        for d in daemons:
            d.stop()


def test_ensure_model_registers_an_exact_index_beyond_the_reference(mesh1):
    """A fleet serves an exact index from every replica through
    ``ensure_model`` (algo "knn", ``{"database"}``): answered as the
    in-process model answers; the JAX daemon refuses the algo."""
    from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
    from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
    from spark_rapids_ml_tpu_torch.models.knn import NearestNeighborsModel
    from torch_port_helpers import jax_ledger_off

    rng = np.random.default_rng(41)
    rows = rng.normal(size=(300, D)).astype(np.float32)
    q = rng.normal(size=(9, D)).astype(np.float32)
    with DataPlaneDaemon(device="cpu") as d, DataPlaneClient(*d.address) as c:
        assert c.ensure_model("e@v1", "knn", {"database": rows}, params={"k": 4}, version=1)
        got = c.kneighbors_raw("e@v1", q, version=1)
    want = NearestNeighborsModel(database=rows, device="cpu")._set(k=4).kneighbors(q)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with jax_ledger_off(), JaxDaemon(mesh=mesh1) as jd, JaxClient(*jd.address) as jc:
        with pytest.raises(RuntimeError, match="unknown model algo"):
            jc.ensure_model("e@v1", "knn", {"database": rows}, version=1)
