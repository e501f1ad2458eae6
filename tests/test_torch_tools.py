"""The port's operator tools (``tools/top.py``, ``tools/trace.py``) against
the JAX package's.

* ``top`` renders the same lines as the JAX ``top`` from the same inputs:
  a port daemon's ``health`` and ``metrics`` (with rates against an earlier
  snapshot), the fleet panel with a DOWN replica, the gossiped ``--fleet``
  panel of a port fleet with a rollout intent in flight, the autoscaler
  panel from the port autoscaler's gauges, and the fleet telemetry panel;
  ``--once --fleet`` against a live port fleet prints what the JAX CLI
  prints.
* ``trace``'s ``load``, ``runs``, ``tree``, ``flame`` and ``chrome_trace``
  give the JAX tool's result on a journal the port wrote (a run across a
  port daemon, its spans stitched through ``trace_ctx``) and an incident
  bundle of the port's flight recorder; ``fleet_load`` drains a port
  fleet's rings as the JAX one does; ``main`` prints the same.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.tools import top as jax_top
from spark_rapids_ml_tpu.tools import trace as jax_trace
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon, ModelFleet
from spark_rapids_ml_tpu_torch.serve.autoscaler import AutoScaler
from spark_rapids_ml_tpu_torch.tools import top, trace
from spark_rapids_ml_tpu_torch.utils import faults, flight, journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from torch_port_helpers import daemon_addr

torch.set_num_threads(2)

D = 8


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(120, D)).astype(np.float32)
    return ([port_pca.PCA(device="cpu").setK(k).fit({"features": x + k})._model_data()
             for k in (2, 3)], rng.normal(size=(5, D)).astype(np.float32))


@pytest.fixture(autouse=True)
def _closed_journal():
    journal.close()
    yield
    faults.deactivate()
    journal.close()


def test_top_renders_a_daemon_as_the_reference(arrays):
    (v1, _), x = arrays
    with config.option("serve_batch_buckets", "8,16"), DataPlaneDaemon(device="cpu") as d, \
            DataPlaneClient(*d.address) as c:
        c.ensure_model("m@v1", "pca", v1, version=1)
        c.warmup("m@v1", n_cols=D)
        prev = c.metrics()
        for _ in range(3):
            c.transform_raw("m@v1", x)
        c.feed_raw("top-job", x, n_cols=D)
        health, snap = c.health(), c.metrics()
    for args in ((health, snap), (health, snap, prev, 2.0), ({"id": "d0"}, {}),
                 (dict(health, busy=True, busy_reason="connections"), snap)):
        assert top.render(*args) == jax_top.render(*args)
    body = top.render(health, snap, prev, 2.0)
    assert "\ntransform " in body and body.splitlines()[0].startswith("daemon ")
    assert any(line.startswith("scheduler") for line in body.splitlines())


def test_top_renders_the_fleet_panels_as_the_reference(arrays):
    (v1, v2), _ = arrays
    daemons = [DataPlaneDaemon(device="cpu", serve_batching=False).start() for _ in range(3)]
    try:
        with ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", v1, version=1)
            fleet.rollout("m", "pca", v2)
            with faults.active(faults.FaultPlan().rule("fleet.rollout", "drop", after=1,
                                                       times=1)):
                with pytest.raises(ConnectionError):
                    fleet.rollout("m", "pca", v1, warm=False)
        daemons[2].stop()
        addrs = [daemon_addr(d) for d in daemons]
        healths = {}
        for a, d in zip(addrs, daemons):
            try:
                with DataPlaneClient(*d.address, timeout=2.0, max_op_attempts=1) as c:
                    healths[a] = c.health()
            except Exception:  # noqa: BLE001 - the stopped replica
                healths[a] = None
        assert healths[addrs[2]] is None
        assert top.render_fleet(healths) == jax_top.render_fleet(healths)
        assert top.render_fleet(healths).count("DOWN") == 1
        with DataPlaneClient(*daemons[0].address) as c:
            view = c.gossip_pull()
        panel = top.render_fleet_view(view, healths)
        assert panel == jax_top.render_fleet_view(view, healths)
        assert top.render_fleet_view(view) == jax_top.render_fleet_view(view)
        assert "flipped v2→v3 by ctl-" in panel and "v2" in panel.splitlines()[-1]
        pulls = {}
        for a, d in zip(addrs, daemons):
            if healths[a] is not None:
                with DataPlaneClient(*d.address) as c:
                    pulls[a] = c.telemetry_pull()
            else:
                pulls[a] = None
        assert top.render_fleet_telemetry(pulls) == jax_top.render_fleet_telemetry(pulls)
        assert top.render_fleet_telemetry(pulls).startswith("fleet telemetry — 2/3 replicas up")
    finally:
        for d in daemons:
            d.stop()


def test_top_renders_the_autoscaler_panel_as_the_reference():
    class _Replica:
        def __init__(self, key):
            self.key, self.alive, self.health = key, True, {}

    class _Fleet:
        def __init__(self):
            self.table = self
            self._r = [_Replica("10.0.0.1:1"), _Replica("10.0.0.2:1")]

        def replicas(self):
            return list(self._r)

        def scale_out(self, endpoint):
            self._r.append(_Replica(endpoint))
            return {"replica": endpoint, "replicas": len(self._r)}

    t = [0.0]
    scaler = AutoScaler(_Fleet(), spawn=lambda: "10.0.0.3:1", high_watermark=5.0,
                        low_watermark=1.0, cooldown_s=10.0, clock=lambda: t[0],
                        telemetry=lambda: {"replicas": 2, "queued": 100.0})
    scaler.tick()
    snap = metrics_mod.snapshot()
    body = top.render({"id": "d0"}, snap)
    assert body == jax_top.render({"id": "d0"}, snap)
    head = next(line for line in body.splitlines() if line.startswith("autoscaler"))
    assert "decision up" in head and "(low 1.00 / high 5.00)" in head
    assert "replicas 3" in head and "cooldown 10.0s" in head
    assert top._autoscale_lines({}) == [] == jax_top._autoscale_lines({})


def test_top_cli_prints_the_gossiped_fleet_as_the_reference(arrays, capsys):
    (v1, _), _ = arrays
    daemons = [DataPlaneDaemon(device="cpu", serve_batching=False).start() for _ in range(2)]
    try:
        with ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", v1, version=1)
        seed = daemon_addr(daemons[1])
        assert top.main([seed, "--once", "--fleet"]) == 0
        got = capsys.readouterr().out
        assert jax_top.main([seed, "--once", "--fleet"]) == 0
        assert got == capsys.readouterr().out
        assert "replicas up:2" in got and got.count(" ok") == 2
        addrs = ",".join([seed, "127.0.0.1:1"])
        assert top.main([addrs, "--once"]) == 0
        fleet_panel = capsys.readouterr().out
        assert "fleet — 1/2 replicas up" in fleet_panel and "DOWN" in fleet_panel
    finally:
        for d in daemons:
            d.stop()


def _write_journal(path, arrays):
    """A run across a port daemon (its spans stitched through
    ``trace_ctx``) and loose spans and marks, into ``path``."""
    (v1, _), x = arrays
    with config.option("run_journal", str(path)):
        with DataPlaneDaemon(device="cpu", serve_batching=False) as d:
            with journal.run("fit", estimator="SparkPCA"):
                with journal.span("feed pass", job="j"):
                    with DataPlaneClient(*d.address) as c:
                        c.ensure_model("m@v1", "pca", v1, version=1)
                        for _ in range(3):
                            c.transform_raw("m@v1", x)
                    journal.mark("tick", i=1)
                with journal.span("finalize"):
                    journal.mark("done")
            with journal.span("standalone"):
                pass
    journal.close()


def test_trace_reads_a_port_journal_and_bundle_as_the_reference(arrays, tmp_path, capsys):
    path = tmp_path / "j.jsonl"
    _write_journal(path, arrays)
    journal.ring_arm(64)
    try:
        with journal.run("incident-run"):
            journal.mark("before the incident")
        bundle = flight.FlightRecorder(state_dir=str(tmp_path)).trigger("fault_site",
                                                                       {"site": "unit"})
    finally:
        journal.ring_disarm()
    sources = [str(path), bundle]
    events = trace.load(sources)
    assert events == jax_trace.load(sources)
    assert trace.runs(events) == jax_trace.runs(events)
    assert {"fit", "incident-run"} <= set(trace.runs(events).values())

    def shape(nodes):
        return [(n.name, n.event.get("span_id"), shape(n.children)) for n in nodes]

    for run_id in (None, *trace.runs(events)):
        assert shape(trace.tree(events, run_id)) == shape(jax_trace.tree(events, run_id))
        assert trace.flame(events, run_id) == jax_trace.flame(events, run_id)
        assert trace.chrome_trace(events, run_id) == jax_trace.chrome_trace(events, run_id)
    (fit,) = [n for n in trace.tree(events) if n.name == "fit"]
    feed = next(n for n in fit.children if n.name == "feed pass")
    assert [n.name for n in feed.children].count("daemon.transform") == 3
    out = tmp_path / "trace.json"
    for tool in (trace, jax_trace):
        assert tool.main([str(path), bundle, "--out", str(out), "--flame"]) == 0
        printed = capsys.readouterr().out
        if tool is trace:
            got, got_json = printed, json.loads(out.read_text())
    assert printed == got and json.loads(out.read_text()) == got_json
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert trace.main([str(empty)]) == 1 == jax_trace.main([str(empty)])


def test_trace_drains_a_port_fleet_as_the_reference(arrays):
    (v1, _), x = arrays
    daemons = [DataPlaneDaemon(device="cpu", serve_batching=False).start() for _ in range(2)]
    try:
        with ModelFleet([d.address for d in daemons]) as fleet:
            fleet.register("m", "pca", v1, version=1)
            with journal.run("routed"):
                with fleet.client() as fc:
                    for i in range(4):
                        fc.transform("m", x, route_key=f"k{i}")
        seed = daemon_addr(daemons[0])
        got = trace.fleet_load(seed)
        assert got == jax_trace.fleet_load(seed)
        names = {e.get("name") for e in got}
        assert "daemon.transform" in names and "daemon.ensure_model" in names
        assert trace.tree(got)
    finally:
        for d in daemons:
            d.stop()
