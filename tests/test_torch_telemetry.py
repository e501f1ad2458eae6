"""The telemetry plane of the port's daemon and client: ``trace_ctx``
stitching, ``trace_pull``, ``telemetry_pull``, exemplars, the telemetry
thread, and the fits that journal one tree across processes (the port's
counterparts of the JAX ``tests/test_trace_distributed.py`` and
``tests/test_telemetry.py``).

* A client op inside a run parents the daemon's ``daemon.<op>`` span into
  the caller's frame; outside any run the client stamps nothing; a fixed
  constructor ``trace_ctx`` wins, and a replayed request carries its first
  attempt's context; liveness and scrape ops journal nothing.
* ``trace_pull`` streams the ring from a cursor without duplicates;
  ``telemetry_pull``'s latency exemplar names a span ``trace_pull``
  returns; both answer with the JAX daemon's keys and are never shed.
* The telemetry thread publishes the ``srml_slo_*`` gauges, and a
  deadline-breach storm makes it write an incident bundle under its
  recorder's ``state_dir``.
* Across packages: the JAX client in a JAX run against the port daemon, and
  the port client in a port run against the JAX daemon, parent each
  daemon's span to the caller's.
* A sparksim ``SparkPCA`` fit over two port daemons, and a two-daemon
  ``SparkApproximateNearestNeighbors`` fit whose shard builds run on pool
  threads, each journal one tree under the driver's fit span, which the JAX
  ``tools/trace.py`` merges into one Chrome trace.
* The recorded transcripts replay unchanged with the journal on and off.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_protocol as golden
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.tools import trace as jax_trace
from spark_rapids_ml_tpu.utils import journal as jax_journal
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon, protocol
from spark_rapids_ml_tpu_torch.serve import client as client_mod
from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod
from spark_rapids_ml_tpu_torch.serve import scheduler as scheduler_mod
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from spark_rapids_ml_tpu_torch.utils import faults, flight, journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from sparksim import SimDataFrame, simdf_from_numpy
from torch_port_helpers import jax_ledger_off, split_routing

torch.set_num_threads(2)
port_est.register_dataframe_type(SimDataFrame)

D = 4


@pytest.fixture(autouse=True)
def _closed_journals(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_DAEMON_ADDRESSES"):
        monkeypatch.delenv(name, raising=False)
    journal.close()
    jax_journal.close()
    yield
    journal.close()
    jax_journal.close()
    daemon_session.shutdown()


def _phases(path):
    journal.close()
    return [e for e in journal.read(str(path)) if e.get("event") == "phase"]


def _rows(n=8):
    return np.arange(n * D, dtype=np.float64).reshape(n, D) % 5


def test_a_request_carrying_trace_ctx_is_served_with_the_journal_off():
    with DataPlaneDaemon(device="cpu") as d:
        with socket.create_connection(d.address, timeout=5.0) as s:
            protocol.send_json(s, {"v": 1, "op": "ping",
                                   "trace_ctx": {"run": "ab" * 8, "span": "cd" * 8}})
            assert protocol.recv_json(s)["ok"] is True


def test_a_client_outside_any_run_stamps_nothing(tmp_path, monkeypatch):
    sent = []
    real = client_mod.protocol.send_json
    monkeypatch.setattr(client_mod.protocol, "send_json",
                        lambda sock, obj: sent.append(obj) or real(sock, obj))
    p = tmp_path / "daemon.jsonl"
    with DataPlaneDaemon(device="cpu") as d:
        with config.option("run_journal", str(p)):
            with DataPlaneClient(*d.address) as c:
                c.feed_raw("solo", _rows(), n_cols=D)
    assert sent and all("trace_ctx" not in req for req in sent)
    ops = [e for e in _phases(p) if e["name"] == "daemon.feed_raw"]
    assert len(ops) == 1 and ops[0]["parent_id"] is None


def test_the_daemon_op_span_parents_into_the_callers_frame(tmp_path):
    p = tmp_path / "both.jsonl"
    with DataPlaneDaemon(device="cpu") as d:
        with config.option("run_journal", str(p)):
            with DataPlaneClient(*d.address) as c:
                with journal.run("fit") as run_id:
                    with journal.span("feed pass") as span_id:
                        c.feed_raw("job", _rows(16), n_cols=D)
    phases = _phases(p)
    (op,) = [e for e in phases if e["name"] == "daemon.feed_raw"]
    assert op["run_id"] == run_id and op["parent_id"] == span_id and op["job"] == "job"
    # The op's inner trace_spans are its children, in the same run.
    inner = [e for e in phases if e["parent_id"] == op["span_id"]]
    assert {e["name"] for e in inner} >= {"daemon host to device", "daemon fold"}
    assert all(e["run_id"] == run_id for e in inner)


def test_unjournaled_ops_stay_quiet(tmp_path):
    p = tmp_path / "quiet.jsonl"
    with DataPlaneDaemon(device="cpu") as d:
        with config.option("run_journal", str(p)):
            with DataPlaneClient(*d.address) as c:
                with journal.run("fit"):
                    c.ping()
                    c.health()
                    c.metrics()
                    c.model_exists("none")
                    c.trace_pull()
                    c.telemetry_pull()
    assert not any(e["name"].startswith("daemon.") for e in _phases(p))


def test_a_fixed_trace_ctx_wins_and_a_replay_carries_it(tmp_path, monkeypatch):
    """The executor path: a client built with the driver's frame stamps it
    although its thread opened no run (and inside a run of its own); a
    request replayed after a dropped attempt carries the same context."""
    sent = []
    real = client_mod.protocol.send_json
    monkeypatch.setattr(client_mod.protocol, "send_json",
                        lambda sock, obj: sent.append(obj) or real(sock, obj))
    p = tmp_path / "exec.jsonl"
    ctx = {"run": "12" * 8, "span": "34" * 8}
    with DataPlaneDaemon(device="cpu") as d:
        with config.option("run_journal", str(p)):
            with DataPlaneClient(*d.address, trace_ctx=ctx, backoff_base_s=0.01) as c:
                with journal.run("another run"):
                    with faults.active(faults.FaultPlan(1).rule("wire.send_frame", "partial",
                                                                times=1)):
                        c.feed_raw("job", _rows(), n_cols=D)
    feeds = [r for r in sent if r.get("op") == "feed_raw"]
    assert len(feeds) == 2 and all(r["trace_ctx"] == ctx for r in feeds)
    assert feeds[0]["feed_id"] == feeds[1]["feed_id"]
    ops = [e for e in _phases(p) if e["name"] == "daemon.feed_raw"]
    assert ops and all(e["run_id"] == ctx["run"] and e["parent_id"] == ctx["span"] for e in ops)


def test_stop_joins_connection_threads_so_trailing_spans_land(tmp_path):
    before = {t for t in threading.enumerate() if t.name.startswith("srml-dataplane-")}
    p = tmp_path / "flush.jsonl"
    with DataPlaneDaemon(device="cpu") as d:
        with config.option("run_journal", str(p)):
            with DataPlaneClient(*d.address) as c:
                c.feed_raw("flush", _rows(), n_cols=D)
    leftovers = [t for t in threading.enumerate()
                 if t.name.startswith("srml-dataplane-") and t not in before]
    assert not leftovers
    assert "daemon.feed_raw" in [e["name"] for e in _phases(p)]


def test_trace_pull_streams_from_a_cursor_without_duplicates():
    with DataPlaneDaemon(device="cpu") as d:
        with journal.run("cursor-demo"):
            with DataPlaneClient(*d.address) as c:
                c.feed_raw("tcur-a", _rows(), n_cols=D)
                first = c.trace_pull()
                assert first["seq"] > 0 and first["events"] and first["boot_id"] == d.boot_id
                second = c.trace_pull(cursor=first["seq"])
                assert all(e["seq"] > first["seq"] for e in second["events"])
                c.feed_raw("tcur-b", _rows(), n_cols=D)
                third = c.trace_pull(cursor=second["seq"])
                assert "daemon.feed_raw" in {e.get("name") for e in third["events"]}
                assert all(e["seq"] > second["seq"] for e in third["events"])
                replay = c.trace_pull(cursor=0)
    seen = [e["seq"] for e in replay["events"]]
    assert len(seen) == len(set(seen))
    for pull in (first, second, third):
        assert {e["seq"] for e in pull["events"]} <= set(seen)
    # Stopped: the ring's last holder disarmed it.
    assert not journal.active()


def test_the_telemetry_pull_exemplar_names_a_span_trace_pull_returns():
    metrics_mod.reset()
    with DataPlaneDaemon(device="cpu") as d:
        fp = config.fingerprint()
        with journal.run("telemetry-demo") as run_id:
            with DataPlaneClient(*d.address) as c:
                c.feed_raw("texj", _rows(), n_cols=D)
                pull = c.telemetry_pull()
                traced = c.trace_pull()
    assert pull["boot_id"] == d.boot_id and pull["fingerprint"] == fp and pull["uptime_s"] >= 0
    assert isinstance(pull["xprof"], dict) and "gram_colsum" in pull["xprof"]
    assert pull["text"].rstrip().endswith("# EOF") and "srml_daemon_requests_total" in pull["text"]
    lat = pull["metrics"]["srml_daemon_request_seconds"]["samples"]
    (feed,) = [s for s in lat if s["labels"].get("op") == "feed_raw"]
    ex = next(iter(feed["exemplars"].values()))
    spans = {e["span_id"]: e for e in traced["events"] if e.get("event") == "phase"}
    assert ex["run"] == run_id and spans[ex["span"]]["name"] == "daemon.feed_raw"


def test_the_pull_ops_answer_the_jax_daemons_keys_and_are_never_shed(mesh8):
    with jax_ledger_off():
        with JaxDaemon(mesh=mesh8) as jd, JaxClient(*jd.address) as jc:
            ref = {"trace_pull": set(jc.trace_pull()), "telemetry_pull": set(jc.telemetry_pull())}
    with DataPlaneDaemon(device="cpu", max_connections=1, retry_after_s=0.01) as d:
        with DataPlaneClient(*d.address) as hold, \
                DataPlaneClient(*d.address, max_busy_wait_s=0.0) as c:
            hold.ping()  # one connection open: the second is over the watermark
            got = {"trace_pull": set(c.trace_pull()), "telemetry_pull": set(c.telemetry_pull())}
            with pytest.raises(client_mod.DaemonBusy):
                c.feed_raw("shed", _rows(), n_cols=D)
    assert got == ref


def test_the_telemetry_tick_publishes_the_slo_gauges():
    with config.option("telemetry_eval_interval_s", 0.05), \
            config.option("slo_objectives", "ping:p99_ms=0.0001@0.01;ping:error"):
        with DataPlaneDaemon(device="cpu") as d:
            with DataPlaneClient(*d.address) as c:
                for _ in range(20):
                    c.ping()
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                snap = metrics_mod.snapshot()
                breach = {s["labels"]["objective"]: s["value"]
                          for s in snap.get("srml_slo_breach", {}).get("samples", [])}
                if breach.get("ping:p99_ms") == 1.0:
                    break
                time.sleep(0.02)
    assert breach["ping:p99_ms"] == 1.0 and breach["ping:error"] == 0.0
    burns = [s for s in snap["srml_slo_burn_rate"]["samples"]
             if s["labels"]["objective"] == "ping:p99_ms"]
    assert {s["labels"]["window"] for s in burns} == {"fast", "slow"}
    assert all(s["value"] >= 14.4 for s in burns)


def test_a_deadline_breach_storm_makes_the_telemetry_thread_write_a_bundle(tmp_path):
    """The recorder given a ``state_dir`` (the daemon has none of its own
    until ROADMAP 7a-ii): seeded deadline sheds cross the rate and the
    daemon's own thread dumps a bundle whose exemplar names a span of its
    own event ring."""
    metrics_mod.reset()
    p = tmp_path / "j.jsonl"
    with config.option("telemetry_eval_interval_s", 0.05), \
            config.option("incident_deadline_rate", 1.0), \
            config.option("incident_min_interval_s", 0.0), config.option("run_journal", str(p)):
        fp = config.fingerprint()
        with DataPlaneDaemon(device="cpu") as d:
            assert d._flight.state_dir is None
            d._flight.state_dir = str(tmp_path / "sd")
            with journal.run("storm-demo") as run_id:
                with DataPlaneClient(*d.address) as c:
                    c.feed_raw("storm-job", _rows(), n_cols=D)
                for _ in range(200):
                    scheduler_mod._M_SHEDS.inc(op="transform", reason="deadline")
                inc_dir = tmp_path / "sd" / "incidents"
                deadline = time.monotonic() + 10.0
                bundle = None
                while bundle is None and time.monotonic() < deadline:
                    hits = sorted(f for f in os.listdir(inc_dir)
                                  if "deadline_breach" in f and f.endswith(".json")) \
                        if inc_dir.is_dir() else []
                    if hits:
                        bundle = flight.load_bundle(str(inc_dir / hits[0]))
                    time.sleep(0.02)
    assert bundle is not None, "the storm wrote no bundle"
    assert bundle["reason"] == "deadline_breach" and bundle["detail"]["breaches"] >= 200.0
    assert bundle["fingerprint"] == fp and bundle["identity"]["boot_id"] == d.boot_id
    # The gossip provider is the daemon's FleetView (its own replica record).
    assert bundle["gossip"]["replicas"][d.instance_id]["boot_id"] == d.boot_id
    assert isinstance(bundle["xprof"], dict)
    feed = next(s for s in bundle["metrics"]["srml_daemon_request_seconds"]["samples"]
                if s["labels"].get("op") == "feed_raw")
    ex = next(iter(feed["exemplars"].values()))
    assert ex["run"] == run_id
    assert ex["span"] in {e["span_id"] for e in bundle["events"] if e.get("event") == "phase"}
    assert jax_trace.tree(jax_trace.load([str(inc_dir / hits[0])]))


def test_the_jax_client_in_a_jax_run_parents_the_port_daemons_span(tmp_path):
    with DataPlaneDaemon(device="cpu") as d:
        with jax_config.option("run_journal", str(tmp_path / "jax.jsonl")):
            with jax_journal.run("jax fit") as run_id:
                with jax_journal.span("jax pass") as span_id:
                    with JaxClient(*d.address) as jc:
                        assert jc.drop("no-such-job") is False
        with DataPlaneClient(*d.address) as c:
            events = c.trace_pull()["events"]
    (op,) = [e for e in events if e.get("name") == "daemon.drop"]
    assert op["run_id"] == run_id and op["parent_id"] == span_id


def test_the_port_client_in_a_port_run_parents_the_jax_daemons_span(mesh8, tmp_path):
    with jax_ledger_off():
        with JaxDaemon(mesh=mesh8) as jd:
            with config.option("run_journal", str(tmp_path / "port.jsonl")):
                with journal.run("port fit") as run_id:
                    with journal.span("port pass") as span_id:
                        with DataPlaneClient(*jd.address) as c:
                            assert c.drop("no-such-job") is False
            with JaxClient(*jd.address) as jc:
                events = jc.trace_pull()["events"]
    (op,) = [e for e in events if e.get("name") == "daemon.drop"]
    assert op["run_id"] == run_id and op["parent_id"] == span_id


def _descendants(node, out):
    for c in node.children:
        out.append(c)
        _descendants(c, out)
    return out


def test_a_two_daemon_spark_pca_fit_merges_into_one_chrome_trace(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.integers(-8, 9, size=(400, 6)).astype(np.float64)
    p = tmp_path / "fit.jsonl"
    with DataPlaneDaemon(device="cpu", ttl=600.0) as a, DataPlaneDaemon(device="cpu",
                                                                       ttl=600.0) as b:
        with config.option("run_journal", str(p)):
            session, env_plan = split_routing(a, b, 4)
            df = simdf_from_numpy(x, n_partitions=4, session=session, env_plan=env_plan)
            port_est.SparkPCA(device="cpu").setInputCol("features").setK(3).fit(df)
    journal.close()
    events = jax_trace.load([str(p)])
    (fit,) = [e for e in events if e.get("event") == "run_end" and e["name"] == "fit"]
    assert fit["estimator"] == "SparkPCA" and fit["algo"] == "pca"
    daemon_spans = [e for e in events
                    if e.get("event") == "phase" and e["name"].startswith("daemon.")]
    assert {e["name"] for e in daemon_spans} >= {"daemon.feed", "daemon.commit",
                                                 "daemon.finalize"}
    assert all(e["run_id"] == fit["run_id"] for e in daemon_spans)
    (root,) = jax_trace.tree(events)
    assert root.name == "fit"
    names = [n.name for n in _descendants(root, [])]
    assert sum(1 for n in names if n.startswith("daemon.")) == len(daemon_spans)
    out = tmp_path / "trace.json"
    assert jax_trace.main([str(p), "--out", str(out)]) == 0
    xs = [e for e in json.loads(out.read_text())["traceEvents"] if e["ph"] == "X"]
    assert {"fit", "daemon.feed", "daemon.finalize"} <= {e["name"] for e in xs}
    assert all(e["args"]["run_id"] == fit["run_id"] for e in xs
               if e["name"].startswith("daemon."))


def test_the_knn_fits_pool_thread_clients_stay_in_the_fit_tree(tmp_path):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(400, 6))
    p = tmp_path / "knn.jsonl"
    with DataPlaneDaemon(device="cpu", ttl=600.0) as a, DataPlaneDaemon(device="cpu",
                                                                       ttl=600.0) as b:
        with config.option("run_journal", str(p)):
            session, env_plan = split_routing(a, b, 4)
            df = simdf_from_numpy(x, n_partitions=4, session=session, env_plan=env_plan)
            model = port_est.SparkApproximateNearestNeighbors(device="cpu").setK(3) \
                .setNlist(4).setNprobe(4).fit(df)
        model.release()  # outside the journal: not part of the fit
    journal.close()
    events = jax_trace.load([str(p)])
    (fit,) = [e for e in events if e.get("event") == "run_end" and e["name"] == "fit"]
    daemon_spans = [e for e in events
                    if e.get("event") == "phase" and e["name"].startswith("daemon.")]
    assert {"daemon.feed", "daemon.sample_rows", "daemon.finalize"} <= {
        e["name"] for e in daemon_spans}
    assert [(e["name"], e["run_id"]) for e in daemon_spans
            if e["run_id"] != fit["run_id"]] == []


TRANSCRIPTS = {
    "golden": lambda: (golden.FIXTURE, golden.transcript_frames()[1], 10),
    "serving": lambda: (golden.FIXTURE_SERVING, golden.serving_transcript_frames()[1], 4),
    "multihost": lambda: (golden.FIXTURE_MULTIHOST, golden.multihost_transcript_frames()[1], 8),
}


@pytest.mark.parametrize("journal_on", [True, False], ids=["journal_on", "journal_off"])
@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_the_golden_transcripts_replay_unchanged(name, journal_on, tmp_path):
    """The recorded requests carry no ``trace_ctx``: the daemon answers them
    as before whether it journals (a file and the ring: its op spans root
    themselves) or not (neither)."""
    path, expect, n = TRANSCRIPTS[name]()
    p = tmp_path / "replay.jsonl"
    opts = ({"run_journal": str(p)} if journal_on else {"telemetry_trace_buffer": 0})
    saved = {k: config.get(k) for k in opts}
    try:
        for k, v in opts.items():
            config.set(k, v)
        golden._replay_prefix(path, expect, n)
    finally:
        for k, v in saved.items():
            config.set(k, v)
    journal.close()
    if journal_on:
        ops = [e for e in journal.read(str(p))
               if e.get("event") == "phase" and e["name"].startswith("daemon.")]
        want = [req["op"] for req, _ in golden._recorded_requests(path)[:n]
                if req["op"] not in daemon_mod._UNJOURNALED_OPS]
        assert sorted(e["name"] for e in ops) == sorted(f"daemon.{op}" for op in want)
        assert all(e["parent_id"] is None for e in ops)
    else:
        assert not p.exists() and not journal.active()
