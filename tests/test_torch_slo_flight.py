"""The port's SLO evaluator and flight recorder
(``spark_rapids_ml_tpu_torch/utils/{slo,flight}.py``) against the JAX
package's.

* ``parse_objectives`` accepts and rejects the same specs, into the same
  objectives; ``count_le`` and the fast and slow burn rates are equal on the
  synthetic snapshots of ``tests/test_telemetry.py``, and the port publishes
  them in its ``srml_slo_*`` gauges.
* The flight recorder debounces per reason and caps its directory; without a
  ``state_dir`` it writes nothing, as the reference; a fired fault site
  dumps a bundle through ``faults.subscribe``; a port bundle loads in the
  JAX ``load_bundle`` and reads as a JAX ``tools/trace.py`` source.
"""

import os
import time

import pytest

from spark_rapids_ml_tpu.tools import trace as jax_trace
from spark_rapids_ml_tpu.utils import flight as jax_flight
from spark_rapids_ml_tpu.utils import slo as jax_slo
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.utils import faults, flight, journal, slo
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod


@pytest.fixture(autouse=True)
def _closed_journal():
    journal.close()
    yield
    journal.close()


def _snap(total, err, buckets=None, shed=0):
    """One synthetic cumulative registry snapshot for op=transform (the JAX
    ``tests/test_telemetry.py`` helper, with a shed counter)."""
    snap = {
        "srml_daemon_requests_total": {"samples": [
            {"labels": {"op": "transform", "outcome": "ok"}, "value": float(total - err)},
            {"labels": {"op": "transform", "outcome": "error"}, "value": float(err)},
        ]},
        "srml_scheduler_sheds_total": {"samples": [
            {"labels": {"op": "transform", "reason": "deadline"}, "value": float(shed)},
        ]},
    }
    if buckets is not None:
        snap["srml_daemon_request_seconds"] = {"samples": [
            {"labels": {"op": "transform"}, "buckets": buckets, "sum": 0.0,
             "count": buckets.get("+Inf", 0.0)},
        ]}
    return snap


SPECS = [
    "transform:p99_ms=50@0.01; kneighbors:error ;transform:shed@0.05",
    "  ",
    "",
    "transform:p99_ms=0.001",
    "a:error@0.5;b:shed",
    "transform",
    "transform:p99_ms",
    "transform:error@2.0",
    "transform:latency@0.1",
    "transform:p99_ms=-3",
    "transform:error@x",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_objectives_accepts_and_rejects_as_jax(spec):
    def parse(mod):
        try:
            return [(o.name, o.op, o.kind, o.target, o.budget, repr(o))
                    for o in mod.parse_objectives(spec)]
        except ValueError as e:
            return ("ValueError", type(e).__name__)

    assert parse(slo) == parse(jax_slo)


@pytest.mark.parametrize("x", [0.0, 0.05, 0.1, 0.3, 0.5, 0.75, 5.0])
def test_count_le_equals_jax(x):
    for buckets in ({"0.1": 50.0, "0.5": 90.0, "+Inf": 100.0},
                    {"0.025": 100.0, "0.1": 190.0, "+Inf": 200.0},
                    {"+Inf": 7.0}, {}):
        assert slo.count_le(buckets, x) == jax_slo.count_le(buckets, x)


SCENARIOS = {
    # The JAX tests' error storm: it starts, then stops (fast forgives).
    "error": (slo.Objective("transform", "error", None, 0.001),
              [(0.0, _snap(1000, 0)), (60.0, _snap(1100, 3)), (120.0, _snap(1200, 3))]),
    # The p99 interpolation inside the target's bucket.
    "p99": (slo.Objective("transform", "p99_ms", 50.0, 0.01),
            [(0.0, _snap(100, 0, {"0.025": 100.0, "0.1": 100.0, "+Inf": 100.0})),
             (60.0, _snap(200, 0, {"0.025": 100.0, "0.1": 190.0, "+Inf": 200.0})),
             (400.0, _snap(260, 0, {"0.025": 150.0, "0.1": 250.0, "+Inf": 260.0}))]),
    # Sheds, with the slow window past its horizon.
    "shed": (slo.Objective("transform", "shed", None, 0.01),
             [(0.0, _snap(10, 0, shed=0)), (30.0, _snap(110, 0, shed=40)),
              (500.0, _snap(210, 0, shed=41))]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_burn_rates_equal_jax_on_synthetic_snapshots(scenario):
    obj, ticks = SCENARIOS[scenario]
    kw = dict(fast_window_s=60.0, slow_window_s=300.0, burn_threshold=14.4)
    port = slo.SloEvaluator(objectives=[obj], **kw)
    ref = jax_slo.SloEvaluator(
        objectives=[jax_slo.Objective(obj.op, obj.kind, obj.target, obj.budget)], **kw)
    breached = False
    for now, snap in ticks:
        got, want = port.tick(snap, now=now), ref.tick(snap, now=now)
        assert got == want
        breached = breached or got[0]["breach"]
    assert breached  # every scenario breaches at least once
    assert port.breaches() == ref.breaches()
    samples = metrics_mod.snapshot()["srml_slo_burn_rate"]["samples"]
    burns = {s["labels"]["window"]: s["value"] for s in samples
             if s["labels"]["objective"] == obj.name}
    assert burns == {"fast": got[0]["fast_burn"], "slow": got[0]["slow_burn"]}
    (breach,) = [s for s in metrics_mod.snapshot()["srml_slo_breach"]["samples"]
                 if s["labels"]["objective"] == obj.name]
    assert breach["value"] == (1.0 if got[0]["breach"] else 0.0)


def test_the_evaluator_reads_the_ports_config():
    with config.option("slo_objectives", "kneighbors:p99_ms=5@0.02"), \
            config.option("slo_fast_window_s", 7.0), config.option("slo_slow_window_s", 70.0), \
            config.option("slo_burn_threshold", 2.0):
        ev = slo.SloEvaluator()
    assert [repr(o) for o in ev.objectives] == ["kneighbors:p99_ms=5@0.02"]
    assert (ev.fast_window_s, ev.slow_window_s, ev.burn_threshold) == (7.0, 70.0, 2.0)


def test_trigger_debounce_and_directory_rotation(tmp_path):
    journal.ring_arm(16)
    try:
        rec = flight.FlightRecorder(state_dir=str(tmp_path))
        with config.option("incident_min_interval_s", 3600.0):
            assert rec.trigger("shed_storm") is not None
            assert rec.trigger("shed_storm") is None  # debounced
            assert rec.trigger("deadline_breach") is not None  # per reason
            assert rec.trigger("shed_storm", force=True) is not None
        with config.option("incident_min_interval_s", 0.0), \
                config.option("incident_max_bundles", 2):
            for _ in range(4):
                assert rec.trigger("slo_breach") is not None
                time.sleep(0.002)  # distinct unix-ms file names
        bundles = sorted(os.listdir(tmp_path / "incidents"))
        assert len(bundles) == 2 and all(b.startswith("incident-") for b in bundles)
        with config.option("incident_max_bundles", 0):
            assert rec.trigger("slo_breach", force=True) is None
    finally:
        journal.ring_disarm()


def test_no_state_dir_writes_nothing_and_record_needs_a_default(tmp_path):
    rec = flight.FlightRecorder(state_dir=None)
    assert rec.trigger("fault_site", force=True) is None
    flight.set_default(None)
    assert flight.record("rollout_abort") is None
    rec = flight.FlightRecorder(state_dir=str(tmp_path))
    flight.set_default(rec)
    try:
        path = flight.record("rollout_abort", {"model": "m"})
    finally:
        flight.set_default(None)
    assert path and flight.load_bundle(path)["detail"] == {"model": "m"}


def test_a_fired_fault_site_dumps_a_bundle(tmp_path):
    rec = flight.FlightRecorder(state_dir=str(tmp_path))
    faults.subscribe(rec.on_fault)
    try:
        with faults.active(faults.FaultPlan(3).rule("client.op", "drop", times=1)):
            with pytest.raises(faults.InjectedDrop):
                faults.checkpoint("client.op")
    finally:
        faults.unsubscribe(rec.on_fault)
    (name,) = os.listdir(tmp_path / "incidents")
    b = flight.load_bundle(str(tmp_path / "incidents" / name))
    assert b["reason"] == "fault_site" and b["detail"] == {"site": "client.op", "fault": "drop"}


def test_a_port_bundle_loads_in_the_jax_reader_and_trace_tool(tmp_path):
    """The bundle keeps the reference's kind, version and fields: the JAX
    ``load_bundle`` reads it, and ``tools/trace.py`` merges its events with a
    journal file into one ordered stream."""
    p = tmp_path / "j.jsonl"
    with config.option("run_journal", str(p)):
        with journal.run("file-run"):
            journal.mark("from-file")
    journal.close()
    journal.ring_arm(100)
    try:
        with journal.run("ring-run"):
            journal.mark("from-ring")
        rec = flight.FlightRecorder(state_dir=str(tmp_path),
                                    providers={"identity": lambda: {"id": "x"},
                                               "gossip": lambda: None,
                                               "broken": lambda: 1 / 0})
        rec.observe(_snap(10, 1), now=time.time() - 5.0)
        bpath = rec.trigger("fault_site", {"site": "unit"})
    finally:
        journal.ring_disarm()
    b = jax_flight.load_bundle(bpath)
    assert b == flight.load_bundle(bpath)
    assert b["kind"] == "srml_incident_bundle" and b["v"] == 1
    assert set(b) >= {"reason", "detail", "ts", "pid", "fingerprint", "events", "seq",
                      "metrics", "op_deltas", "xprof", "identity", "gossip"}
    assert b["fingerprint"] == config.fingerprint() and b["broken"] is None
    assert b["gossip"] is None and b["identity"] == {"id": "x"}
    assert [e["name"] for e in b["events"]] == ["ring-run", "from-ring", "ring-run"]
    merged = jax_trace.load([str(p), bpath])
    names = [e.get("name") for e in merged]
    assert names.index("from-file") < names.index("from-ring")
    assert merged == sorted(merged, key=jax_trace._sort_key)
    with pytest.raises(ValueError):
        flight.load_bundle(str(p))
