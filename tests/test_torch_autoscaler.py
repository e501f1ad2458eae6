"""The port's serve autoscaler (``serve/autoscaler.py``) against the JAX
package's.

Each case feeds the same telemetry samples and the same hand-cranked clock
to the JAX ``AutoScaler`` and to the port's, each over a recording fake
fleet, and holds everything either can observe equal: every tick's
decision (verdict, reason, load, shed delta, action, result), the fleet's
scale calls, the decision, crossing and action counters, the cooldown and
``status()``. The cases mirror the reference's unit tests: the hold band,
a load flapping at a watermark, sheds, p99 over the deadline, an SLO
breach, the replica bounds, a refused action (the ``autoscale.action``
fault site), the drain callback, orphaned-intent adoption and inverted
watermarks. Then the port's default telemetry is read from a real fleet of
port daemons.
"""

import time
import types

import pytest

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.serve import autoscaler as jax_autoscaler
from spark_rapids_ml_tpu.utils import faults as jax_faults
from spark_rapids_ml_tpu.utils import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import autoscaler as port_autoscaler
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

PKGS = {
    "jax": types.SimpleNamespace(autoscaler=jax_autoscaler, faults=jax_faults,
                                 metrics=jax_metrics, config=jax_config),
    "port": types.SimpleNamespace(autoscaler=port_autoscaler, faults=faults,
                                  metrics=metrics_mod, config=config),
}
COUNTERS = ("srml_autoscale_decisions_total", "srml_autoscale_crossings_total",
            "srml_autoscale_actions_total")


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    for pkg in PKGS.values():
        pkg.faults.deactivate()
        assert pkg.faults.active_plan() is None


def _samples(mods):
    """{(counter, sorted labels): value} of the autoscaler's counters."""
    snap = mods.metrics.snapshot()
    return {(name, tuple(sorted(s["labels"].items()))): float(s["value"])
            for name in COUNTERS for s in (snap.get(name) or {}).get("samples", [])}


def _deltas(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


class _FakeReplica:
    def __init__(self, key):
        self.key, self.alive, self.health = key, True, {}

    def load(self):
        return 0.0


class _FakeTable:
    def __init__(self, n):
        self._r = [_FakeReplica(f"10.0.0.{i}:7000") for i in range(n)]

    def replicas(self):
        return list(self._r)


class _FakeFleet:
    """Records its scale calls; grows and shrinks like the real one."""

    def __init__(self, n):
        self.table = _FakeTable(n)
        self.calls = []
        self.drained = True

    def scale_out(self, endpoint):
        r = _FakeReplica(str(endpoint))
        self.table._r.append(r)
        self.calls.append(("out", str(endpoint)))
        return {"replica": r.key, "replicas": len(self.table._r)}

    def scale_in(self, key=None):
        victim = self.table._r.pop()
        self.calls.append(("in", victim.key))
        return {"replica": victim.key, "drained": self.drained, "rollouts": {},
                "replicas": len(self.table._r)}


class _Run:
    """One package's autoscaler over a fake fleet and a fake clock, and the
    log of everything it shows."""

    def __init__(self, mods, n, sample, **kw):
        kw.setdefault("high_watermark", 5.0)
        kw.setdefault("low_watermark", 1.0)
        kw.setdefault("cooldown_s", 10.0)
        kw.setdefault("tick_s", 0.01)
        kw.setdefault("min_replicas", 1)
        kw.setdefault("max_replicas", 8)
        self.mods, self.fleet, self.sample, self.t = mods, _FakeFleet(n), sample, [0.0]
        self.released = []
        spawned = iter(range(10 ** 6))
        self.scaler = mods.autoscaler.AutoScaler(
            self.fleet, spawn=lambda: f"10.0.1.{next(spawned)}:7000",
            drain=self.released.append,
            telemetry=lambda: dict(self.sample, replicas=len(self.fleet.table.replicas())),
            clock=lambda: self.t[0], **kw)
        self.base = _samples(mods)
        self.log = []

    def tick(self):
        d = self.scaler.tick()
        self.log.append((d, self.scaler.cooldown_remaining(), list(self.fleet.calls),
                         list(self.released)))
        return d

    def result(self):
        return {"log": self.log, "counters": _deltas(self.base, _samples(self.mods)),
                "status": self.scaler.status()}


def _hold_band(mods):
    run = _Run(mods, 2, {"queued": 6.0, "sheds_total": 0.0, "p99_s": None})
    for _ in range(20):
        run.tick()
        run.t[0] += 1.0
    return run


def _flap(mods):
    run = _Run(mods, 1, {"queued": 0.0, "sheds_total": 0.0, "p99_s": None})
    for i in range(30):
        n = len(run.fleet.table.replicas())
        run.sample["queued"] = 6.0 * n if i % 2 == 0 else 0.5 * n
        run.tick()
        run.t[0] += 1.0
    return run


def _sheds(mods):
    run = _Run(mods, 2, {"queued": 0.0, "sheds_total": 5.0, "p99_s": None})
    run.tick()
    run.t[0] += 11.0
    run.sample["sheds_total"] = 9.0
    run.tick()
    run.t[0] += 1.0
    run.tick()
    return run


def _p99(mods):
    run = _Run(mods, 2, {"queued": 4.0, "sheds_total": 0.0, "p99_s": 0.9}, p99_deadline_s=0.5)
    run.tick()
    run.t[0] += 11.0
    run.sample["p99_s"] = 0.4
    run.tick()
    return run


def _p99_off(mods):
    run = _Run(mods, 2, {"queued": 4.0, "sheds_total": 0.0, "p99_s": 0.9}, p99_deadline_s=0.0)
    run.tick()
    return run


def _slo(mods):
    run = _Run(mods, 3, {"queued": 0.0, "sheds_total": 0.0, "p99_s": None, "slo_breaches": 2})
    run.tick()
    return run


def _bounds(mods):
    run = _Run(mods, 2, {"queued": 100.0, "sheds_total": 0.0, "p99_s": None},
               max_replicas=2, min_replicas=2)
    run.tick()
    run.sample["queued"] = 0.0
    run.tick()
    return run


def _action_fault(mods):
    run = _Run(mods, 1, {"queued": 50.0, "sheds_total": 0.0, "p99_s": None})
    plan = mods.faults.FaultPlan(seed=7).rule("autoscale.action", "refuse", times=1)
    with mods.faults.active(plan):
        run.tick()
    run.log.append(("fired", plan.fired.get("autoscale.action")))
    run.tick()
    return run


def _drain_callback(mods):
    run = _Run(mods, 3, {"queued": 0.0, "sheds_total": 0.0, "p99_s": None})
    run.fleet.drained = False
    run.tick()
    run.t[0] += 11.0
    run.fleet.drained = True
    run.tick()
    return run


def _orphaned_intent(mods):
    horizon = float(mods.config.get("fleet_drain_timeout_s"))
    now = time.time()
    intents = {
        "orphan": {"model": "orphan", "from_version": 1, "to_version": 2,
                   "phase": "flipped", "by": "ctl-dead", "at": now - horizon - 60.0},
        "young": {"model": "young", "from_version": 1, "to_version": 2,
                  "phase": "registering", "by": "ctl-live", "at": now},
        "failing": {"model": "failing", "from_version": 3, "to_version": 4,
                    "phase": "warming", "by": "ctl-dead", "at": now - horizon - 1.0},
    }
    run = _Run(mods, 2, {"queued": 4.0, "sheds_total": 0.0, "p99_s": None})
    run.fleet.table.intents = lambda: dict(intents)
    resumed = []

    def resume(model):
        resumed.append(model)
        if model == "failing":
            raise RuntimeError("replica refused")
        return {"action": "completed", "model": model, "version": 2}

    run.fleet.resume_rollout = resume
    run.tick()
    run.log.append(("resumed", resumed))
    return run


SCENARIOS = {"hold band": _hold_band, "flap": _flap, "sheds": _sheds, "p99": _p99,
             "p99 off": _p99_off, "slo": _slo, "bounds": _bounds,
             "action fault": _action_fault, "drain callback": _drain_callback,
             "orphaned intent": _orphaned_intent}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_follow_the_reference(name):
    want = SCENARIOS[name](PKGS["jax"]).result()
    got = SCENARIOS[name](PKGS["port"]).result()
    assert got == want


def test_the_scenarios_show_what_the_reference_tests_pin():
    """The shared log is not vacuous: the port shows the reference's
    claims (one action a cooldown window, the shed and p99 overrides, the
    bounds, a refused action retried at once, the drain hook only after a
    full drain, the orphan adopted)."""
    port = PKGS["port"]
    flap = _flap(port)
    acts = [(i, d["action"]) for i, (d, *_rest) in enumerate(flap.log)
            if d["action"] in ("scale_up", "scale_down")]
    assert len(acts) == 3 and all(b - a >= 10 for (a, _), (b, _) in zip(acts, acts[1:]))
    assert flap.result()["counters"][("srml_autoscale_decisions_total",
                                      (("verdict", "up"),))] == 15
    sheds = _sheds(port)
    assert [d["verdict"] for d, *_ in sheds.log] == ["down", "up", "down"]
    assert sheds.log[1][0]["reason"] == "sheds" and sheds.log[2][0]["action"] == "cooldown"
    p99 = _p99(port)
    assert p99.log[0][0]["reason"] == "p99" and p99.log[1][0]["verdict"] == "hold"
    assert _slo(port).log[0][0]["reason"] == "slo"
    bounds = _bounds(port)
    assert [d["action"] for d, *_ in bounds.log] == ["bounded", "bounded"]
    assert bounds.scaler.cooldown_remaining() == 0.0
    fault = _action_fault(port)
    assert fault.log[0][0]["action"] == "error" and fault.log[1] == ("fired", 1)
    assert fault.log[2][0]["action"] == "scale_up" and len(fault.fleet.calls) == 1
    drain = _drain_callback(port)
    assert drain.log[0][3] == [] and drain.log[1][3] == [drain.fleet.calls[-1][1]]
    orphan = _orphaned_intent(port)
    assert orphan.log[-1] == ("resumed", ["orphan", "failing"])
    status = _hold_band(port).result()["status"]
    assert status["high_watermark"] == 5.0 and status["last_decision"]["verdict"] == "hold"


@pytest.mark.parametrize("high, low", [(1.0, 2.0), (0.5, 0.75)])
def test_inverted_watermarks_are_refused_as_the_reference(high, low):
    errors = []
    for mods in PKGS.values():
        with pytest.raises(ValueError, match="hysteresis") as e:
            _Run(mods, 1, {}, high_watermark=high, low_watermark=low)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_knobs_default_from_the_ports_config():
    attrs = ("high", "low", "cooldown_s", "tick_s", "min_replicas", "max_replicas",
             "p99_deadline_s")
    fleet = _FakeFleet(1)
    got = port_autoscaler.AutoScaler(fleet, spawn=lambda: "h:1", telemetry=dict)
    want = jax_autoscaler.AutoScaler(fleet, spawn=lambda: "h:1", telemetry=dict)
    assert [getattr(got, a) for a in attrs] == [getattr(want, a) for a in attrs]
    with config.option("autoscale_high_watermark", 3.5), config.option("autoscale_min_replicas", 0):
        s = port_autoscaler.AutoScaler(fleet, spawn=lambda: "h:1", telemetry=dict)
        assert s.high == 3.5 and s.min_replicas == 1  # the floor of one replica


def test_default_telemetry_reads_the_fleet_and_the_registry():
    """The port's default sample over a real fleet of port daemons: live
    replicas, the routed requests in flight plus the scheduler queues of
    the polled health, busy replicas, the registry's sheds, the routed p99
    and breaching SLOs; a replica tombstoned in the gossiped view does not
    count."""
    from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon, ModelFleet

    daemons = [DataPlaneDaemon(device="cpu", serve_batching=False).start() for _ in range(3)]
    try:
        with ModelFleet([d.address for d in daemons]) as fleet:
            scaler = port_autoscaler.AutoScaler(fleet, spawn=lambda: None)
            reps = {r.key: r for r in fleet.table.replicas()}
            keys = sorted(reps)
            reps[keys[0]].inflight = 2
            reps[keys[1]].health = {"busy": True, "scheduler": {"models": {"m@v1": 3, "n@v1": 1}}}
            sample = scaler._default_telemetry()
            assert sample["replicas"] == 3 and sample["queued"] == 6.0 and sample["busy"] == 1
            snap = metrics_mod.snapshot()
            sheds = sum(s["value"] for s in
                        (snap.get("srml_scheduler_sheds_total") or {}).get("samples", []))
            assert sample["sheds_total"] == sheds
            fleet.view.observe_replica("gone", keys[2], "b", liveness="tombstone")
            assert scaler._default_telemetry()["replicas"] == 2
            assert scaler._default_telemetry()["queued"] == 6.0
            reps[keys[1]].alive = False
            assert scaler._default_telemetry() == {**sample, "replicas": 1, "queued": 2.0,
                                                   "busy": 0}
    finally:
        for d in daemons:
            d.stop()
