"""The port's fault injection (``spark_rapids_ml_tpu_torch/utils/faults.py``)
against the JAX package's (``spark_rapids_ml_tpu/utils/faults.py``).

* The same plan (seed, rules, ``p``, ``after``, ``times``), hit 1,000
  times at each site, fires on the same arrivals in both packages, with the
  same jittered latency delays, the same truncation cuts and the same
  ``fired``.
* ``from_spec`` parses the same spec strings into the same plans, and
  refuses the same malformed ones.
* A ``partial`` rule outside ``wire.send_frame`` is refused, as in JAX.
* With no plan, the hooks are no-ops; ``active`` nests; a crash rule runs
  its callback and then drops.
* ``SRML_TORCH_FAULT_PLAN`` arms the port's plan and not the JAX one, and
  ``SRML_FAULT_PLAN`` the JAX one and not the port's.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from spark_rapids_ml_tpu.utils import faults as jax_faults
from spark_rapids_ml_tpu_torch.utils import faults

ROOT = Path(__file__).resolve().parent.parent

SITES = ("client.connect", "client.op", "daemon.conn", "daemon.op", "daemon.pass_boundary",
         "daemon.vanish", "daemon.join", "wire.send_frame", "bridge.to_matrix",
         "bridge.to_ipc")


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    faults.deactivate()
    jax_faults.deactivate()
    assert faults.active_plan() is None and jax_faults.active_plan() is None


def _rules(plan):
    """A mixed plan: every kind but crash, with p, after and times."""
    return (plan
            .rule("client.op", "drop", p=0.05)
            .rule("client.op", "latency", p=0.3, delay_s=0.25)
            .rule("client.connect", "refuse", p=0.2, after=10, times=7)
            .rule("daemon.op", "latency", p=0.25, delay_s=0.002)
            .rule("daemon.vanish", "drop", after=3, times=2)
            .rule("daemon.join", "refuse", p=0.5, times=4)
            .rule("daemon.pass_boundary", "drop", p=0.01)
            .rule("bridge.to_matrix", "drop", p=0.1, after=100)
            .rule("wire.send_frame", "partial", p=0.02)
            .rule("wire.send_frame", "drop", p=0.01, times=3))


def _trace(mod, plan, monkeypatch, hits=1000):
    """Every site hit ``hits`` times, round robin: the (site, arrival,
    outcome) of every fault, with latency delays and partial cuts."""
    delays = []
    monkeypatch.setattr(mod.time, "sleep", delays.append)
    out = []
    with mod.active(plan):
        for i in range(hits):
            for site in SITES:
                before = len(delays)
                try:
                    mod.checkpoint(site)
                    outcome = "ok"
                except ConnectionRefusedError as e:
                    outcome = ("refuse", type(e).__name__)
                except ConnectionError as e:
                    outcome = ("drop", type(e).__name__)
                if len(delays) > before:
                    out.append((site, i, "latency", tuple(delays[before:])))
                if outcome != "ok":
                    out.append((site, i, outcome))
                cut = mod.truncation(site, 4096)
                if cut is not None:
                    out.append((site, i, "partial", cut))
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_the_same_plan_fires_on_the_same_arrivals(seed, monkeypatch):
    port_plan, jax_plan = _rules(faults.FaultPlan(seed)), _rules(jax_faults.FaultPlan(seed))
    got = _trace(faults, port_plan, monkeypatch)
    want = _trace(jax_faults, jax_plan, monkeypatch)
    assert got == want
    assert port_plan.fired == jax_plan.fired
    # The plan exercised every kind it has.
    kinds = {e[2] if isinstance(e[2], str) else e[2][0] for e in got}
    assert kinds == {"latency", "drop", "refuse", "partial"}
    assert port_plan.fired["daemon.vanish"] == 2
    assert port_plan.fired["client.connect"] == 7


def test_a_rules_firing_sequence_ignores_its_siblings(monkeypatch):
    """Per-rule generators: adding a rule at another site moves nothing."""
    alone = _trace(faults, faults.FaultPlan(5).rule("client.op", "drop", p=0.1), monkeypatch,
                   hits=300)
    mixed = _trace(faults, faults.FaultPlan(5).rule("client.op", "drop", p=0.1)
                   .rule("daemon.op", "drop", p=0.5), monkeypatch, hits=300)
    assert alone == [e for e in mixed if e[0] == "client.op"]


SPECS = [
    "",
    "client.op:drop",
    "seed=7;client.op:drop:p=0.1;daemon.op:crash:after=20,times=1",
    " seed=3 ; wire.send_frame:partial:p=0.02 ; daemon.op:latency:p=0.25,delay_s=0.002 ;",
    "daemon.vanish:crash:after=1,times=1",
    "client.op:drop:p=0.05;wire.send_frame:partial:p=0.02;daemon.op:latency:p=0.25,delay_s=0.002",
]


def _shape(plan):
    return (plan.seed, {site: [(r.site, r.kind, r.p, r.after, r.times, r.delay_s) for r in rules]
                        for site, rules in plan._rules.items()})


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_parses_as_jax(spec):
    assert _shape(faults.FaultPlan.from_spec(spec)) == _shape(jax_faults.FaultPlan.from_spec(spec))


@pytest.mark.parametrize("spec", ["client.op", "client.op:drop:q=1", "client.op:explode",
                                  "client.op:drop:p=x", "daemon.op:partial"])
def test_from_spec_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as jax_err:
        jax_faults.FaultPlan.from_spec(spec)
    with pytest.raises(ValueError) as port_err:
        faults.FaultPlan.from_spec(spec)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("site", ["client.op", "daemon.op", "bridge.to_ipc"])
def test_partial_only_at_the_frame_layer(site):
    with pytest.raises(ValueError, match="only apply at site 'wire.send_frame'"):
        faults.FaultPlan().rule(site, "partial")
    with pytest.raises(ValueError, match="only apply at site 'wire.send_frame'"):
        jax_faults.FaultPlan().rule(site, "partial")
    faults.FaultPlan().rule("wire.send_frame", "partial")  # the one place it applies


def test_no_plan_is_a_no_op():
    assert faults.active_plan() is None
    for site in SITES:
        assert faults.checkpoint(site) is None
        assert faults.truncation(site, 100) is None


def test_active_nests_and_restores():
    outer = faults.FaultPlan(1).rule("client.op", "drop")
    inner = faults.FaultPlan(2)
    with faults.active(outer) as p:
        assert p is outer and faults.active_plan() is outer
        with faults.active(inner):
            assert faults.active_plan() is inner
            faults.checkpoint("client.op")  # the inner plan has no rule there
        assert faults.active_plan() is outer
        with pytest.raises(faults.InjectedDrop):
            faults.checkpoint("client.op")
    assert faults.active_plan() is None
    assert outer.fired == {"client.op": 1} and inner.fired == {}


def test_crash_runs_its_callback_then_drops_and_subscribers_hear_first():
    events = []

    def sub(site, kind):
        events.append(("notified", site, kind))

    plan = (faults.FaultPlan().rule("daemon.vanish", "crash", after=1, times=1)
            .on_crash(lambda: events.append(("crashed",))))
    faults.subscribe(sub)
    try:
        with faults.active(plan):
            faults.checkpoint("daemon.vanish")
            with pytest.raises(faults.InjectedDrop, match="daemon crashed at daemon.vanish"):
                faults.checkpoint("daemon.vanish")
            faults.checkpoint("daemon.vanish")  # the budget is spent
    finally:
        faults.unsubscribe(sub)
    faults.unsubscribe(sub)  # unsubscribing twice is harmless
    assert events == [("notified", "daemon.vanish", "crash"), ("crashed",)]
    assert plan.fired == {"daemon.vanish": 1}
    assert issubclass(faults.InjectedDrop, ConnectionError)
    assert issubclass(faults.InjectedRefusal, ConnectionRefusedError)


def test_a_crash_without_callback_exits_17():
    code = ("from spark_rapids_ml_tpu_torch.utils import faults; "
            "faults.activate(faults.FaultPlan().rule('daemon.op', 'crash')); "
            "faults.checkpoint('daemon.op'); print('survived')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=60, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 17 and "survived" not in r.stdout


def test_each_package_reads_its_own_env_var():
    spec = "seed=4;client.op:drop:p=0.5"
    code = ("import spark_rapids_ml_tpu.utils.faults as j, "
            "spark_rapids_ml_tpu_torch.utils.faults as t; "
            "print(j.active_plan() is not None, t.active_plan() is not None)")
    env = {k: v for k, v in os.environ.items() if k not in ("SRML_FAULT_PLAN", faults.ENV_VAR)}
    env["PYTHONPATH"] = str(ROOT)
    runs = {}
    for var in (faults.ENV_VAR, "SRML_FAULT_PLAN"):
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=120, env={**env, var: spec})
        assert r.returncode == 0, r.stderr[-2000:]
        runs[var] = r.stdout.split()
    assert runs == {faults.ENV_VAR: ["False", "True"], "SRML_FAULT_PLAN": ["True", "False"]}
    assert faults.ENV_VAR == "SRML_TORCH_FAULT_PLAN"
