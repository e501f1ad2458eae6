"""The port's run journal (``spark_rapids_ml_tpu_torch/utils/journal.py``)
against the JAX package's.

* The same sequence of ``run``/``span``/``mark``/``adopt`` calls journals
  the same tree in both packages: event kinds, names, fields, parent links
  (ids compared by their first appearance, never by value) and a dense
  monotonic ``seq``.
* The JAX ``journal.read`` and ``tools/trace.py`` read a port journal and
  give the Chrome-trace structure they give a JAX journal of the same calls.
* Rotation reads back as one stream; the ring is refcounted and its
  ``tail`` cursor streams; a bad path disables the journal without failing
  the caller; with neither a file nor the ring nothing is allocated or
  written.
* ``trace_span`` writes its phase line and feeds the phase histogram.

Each test disarms the ring it arms; none touches the JAX package's ring.
"""

import os

import pytest

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.tools import trace as jax_trace
from spark_rapids_ml_tpu.utils import journal as jax_journal
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.utils import journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

#: Fields that differ between any two runs: times, the process and thread.
VOLATILE = ("ts", "pid", "tid", "duration_s", "seq")
IDS = ("run_id", "span_id", "parent_id")


@pytest.fixture(autouse=True)
def _closed_journals():
    journal.close()
    jax_journal.close()
    yield
    journal.close()
    jax_journal.close()


def _drive(j):
    """One fixed sequence of journal calls through module ``j``."""
    with j.run("fit", estimator="SparkPCA", algo="pca"):
        with j.span("feed pass", job="job-a"):
            j.mark("tick", i=1)
            with j.span("daemon fold"):
                pass
        with j.adopt("ab" * 8, "cd" * 8):
            with j.span("adopted", model="m"):
                j.mark("inside adopted")
        with j.adopt(None):
            with j.span("after a null adopt"):
                pass
        j.mark("done", rows=8)
    with j.span("standalone"):
        pass
    j.mark("loose mark")


def _journal_of(j, cfg, path):
    with cfg.option("run_journal", str(path)):
        _drive(j)
    j.close()
    return j.read(str(path))


def _canonical(events):
    """The events with volatile fields dropped and ids renamed by first
    appearance (the adopted foreign ids kept: both sides see the same)."""
    names = {}

    def canon(v):
        if v is None or v in ("ab" * 8, "cd" * 8):
            return v
        return names.setdefault(v, f"id{len(names)}")

    out = []
    for e in events:
        c = {k: v for k, v in e.items() if k not in VOLATILE}
        for k in IDS:
            c[k] = canon(e.get(k))
        out.append(c)
    return out


def test_the_same_calls_journal_the_same_tree(tmp_path):
    port = _journal_of(journal, config, tmp_path / "port.jsonl")
    ref = _journal_of(jax_journal, jax_config, tmp_path / "jax.jsonl")
    assert len(port) == len(ref) == 11
    assert _canonical(port) == _canonical(ref)
    assert [set(e) for e in port] == [set(e) for e in ref]
    seqs = [e["seq"] for e in port]
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))  # dense, monotonic
    assert all(e["pid"] == os.getpid() for e in port)
    spans = {e["name"]: e for e in port if e["event"] == "phase"}
    run = next(e for e in port if e["event"] == "run_start")
    assert spans["feed pass"]["parent_id"] == run["span_id"]
    assert spans["daemon fold"]["parent_id"] == spans["feed pass"]["span_id"]
    assert spans["adopted"]["run_id"] == "ab" * 8 and spans["adopted"]["parent_id"] == "cd" * 8
    assert spans["standalone"]["parent_id"] is None
    assert spans["standalone"]["run_id"] != run["run_id"]


def test_the_jax_reader_and_trace_tool_read_a_port_journal(tmp_path):
    """``journal.read`` and ``tools/trace.py`` of the JAX package take the
    port's file: the same Chrome-trace events (kinds, names, args keys) and
    the same stitched tree as for a JAX journal of the same calls."""
    _journal_of(journal, config, tmp_path / "port.jsonl")
    _journal_of(jax_journal, jax_config, tmp_path / "jax.jsonl")
    port = jax_trace.load([str(tmp_path / "port.jsonl")])
    ref = jax_trace.load([str(tmp_path / "jax.jsonl")])
    assert jax_journal.read(str(tmp_path / "port.jsonl")) == journal.read(
        str(tmp_path / "port.jsonl"))

    def chrome_shape(events):
        return [(e["ph"], e["name"], e.get("cat"), sorted(e.get("args", {})))
                for e in jax_trace.chrome_trace(events)["traceEvents"] if e["ph"] != "M"]

    def tree_shape(nodes):
        return [(n.name, tree_shape(n.children)) for n in nodes]

    assert chrome_shape(port) == chrome_shape(ref)
    assert tree_shape(jax_trace.tree(port)) == tree_shape(jax_trace.tree(ref))
    assert sorted(jax_trace.runs(port).values()) == sorted(jax_trace.runs(ref).values())


def test_rotation_reads_back_as_one_stream(tmp_path):
    p = tmp_path / "rot.jsonl"
    with config.option("run_journal", str(p)), config.option("run_journal_max_bytes", 2000), \
            config.option("run_journal_keep", 3):
        with journal.run("rotation"):
            for i in range(120):
                journal.mark("tick", i=i)
    journal.close()
    segs = journal.segments(str(p))
    assert 2 <= len(segs) <= 4 and segs[-1] == str(p)
    events = journal.read(str(p))
    idx = [e["i"] for e in events if e.get("name") == "tick"]
    assert idx == list(range(idx[0], 120))  # the surviving tail, in order
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs)
    # The JAX reader concatenates the port's segments the same way.
    assert jax_journal.read(str(p)) == events


def test_the_ring_is_refcounted_and_its_tail_streams():
    assert journal.tail(0) == ([], journal.last_seq())
    journal.ring_arm(4)
    journal.ring_arm(8)  # the largest cap wins while any holder is armed
    try:
        assert journal.active() and not journal.enabled()
        for i in range(10):
            journal.mark("tick", i=i)
        events, seq = journal.tail(0)
        assert [e["i"] for e in events] == list(range(2, 10)) and seq == events[-1]["seq"]
        newer, seq2 = journal.tail(seq)
        assert newer == [] and seq2 == seq
        journal.mark("after", i=10)
        newer, seq3 = journal.tail(seq)
        assert [e["i"] for e in newer] == [10] and seq3 == seq + 1
        journal.ring_disarm()
        assert journal.active()  # one holder left: the ring keeps its events
        assert len(journal.tail(0)[0]) == 8
    finally:
        journal.ring_disarm()
    assert not journal.active() and journal.tail(0)[0] == []


def test_a_bad_path_disables_the_journal_without_failing_the_caller(tmp_path):
    bad = tmp_path / "missing-dir" / "j.jsonl"
    with config.option("run_journal", str(bad)):
        with journal.run("fit") as run_id:
            assert run_id is not None
            with journal.span("phase"):
                x = 1 + 1
        assert x == 2
        assert not journal.enabled()  # disabled itself after the first write
        with journal.span("later") as sid:
            assert sid is None
    journal.close()  # re-arms
    good = tmp_path / "j.jsonl"
    with config.option("run_journal", str(good)):
        journal.mark("back")
    journal.close()
    assert [e["name"] for e in journal.read(str(good))] == ["back"]


def test_off_means_no_allocation_and_no_io(tmp_path, monkeypatch):
    assert not journal.active()
    before = journal.last_seq()
    opened = []
    monkeypatch.setattr("builtins.open", lambda *a, **k: opened.append(a) or None)
    with journal.run("fit") as run_id:
        with journal.span("phase") as span_id:
            journal.mark("tick")
    assert run_id is None and span_id is None
    assert journal.trace_ctx() is None
    assert journal.last_seq() == before and opened == [] and journal._files == {}


def _phase_count(phase):
    samples = metrics_mod.snapshot().get("srml_phase_duration_seconds", {}).get("samples", [])
    return sum(s["count"] for s in samples if s["labels"].get("phase") == phase)


def test_trace_span_journals_and_feeds_the_phase_histogram(tmp_path):
    p = tmp_path / "span.jsonl"
    name = "torch journal test phase"
    n0 = _phase_count(name)
    with config.option("run_journal", str(p)):
        with journal.run("fit"):
            with trace_span(name):
                pass
    journal.close()
    assert _phase_count(name) == n0 + 1
    (line,) = [e for e in journal.read(str(p)) if e["event"] == "phase"]
    assert line["name"] == name and line["parent_id"] is not None
    with config.option("metrics", False):
        with trace_span(name):
            pass
    assert _phase_count(name) == n0 + 1


def test_the_port_reads_its_own_env_names():
    """``SRML_TORCH_*`` and never the JAX package's deployment names
    (``SRML_RUN_JOURNAL``, ``SRML_SLO_OBJECTIVES``, ``SRML_DEVICE_TIMING``):
    a process that imports both packages must not arm both journals from one
    variable."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("from spark_rapids_ml_tpu_torch import config; "
            "print(repr([config.get(k) for k in ('run_journal', 'slo_objectives', "
            "'device_timing', 'telemetry_eval_interval_s', 'incident_on_fatal', "
            "'daemon_state_dir', 'gossip_interval_s', 'serve_version_strict', "
            "'fleet_seed_addresses', 'gossip_fanout', 'fleet_vnodes', 'fleet_drain_timeout_s', "
            "'autoscale_high_watermark', 'autoscale_max_replicas', 'serve_aot')]"
            " + [__import__('spark_rapids_ml_tpu_torch.spark.daemon_session', fromlist=['x'])"
            ".fleet_seeds()]))")
    # The durable daemon's and the fleet's keys too: the JAX package's
    # SRML_DAEMON_STATE_DIR, SRML_GOSSIP_*, SRML_SERVE_* and SRML_FLEET_* are
    # ignored, SRML_TORCH_GOSSIP_FANOUT and SRML_TORCH_FLEET_VNODES read. The
    # control plane's: SRML_FLEET_DRAIN_TIMEOUT_S and SRML_AUTOSCALE_* ignored,
    # SRML_TORCH_AUTOSCALE_MAX_REPLICAS read, and fleet_seeds() empty under
    # the JAX package's SRML_FLEET_SEED_ADDRESSES.
    env = dict(os.environ, SRML_RUN_JOURNAL="/nonexistent/jax.jsonl",
               SRML_SLO_OBJECTIVES="transform:error", SRML_DEVICE_TIMING="1",
               SRML_TORCH_TELEMETRY_EVAL_INTERVAL_S="0.25", SRML_TORCH_INCIDENT_ON_FATAL="on",
               SRML_DAEMON_STATE_DIR="/nonexistent/jax-state", SRML_GOSSIP_INTERVAL_S="0.5",
               SRML_SERVE_VERSION_STRICT="0", SRML_FLEET_SEED_ADDRESSES="127.0.0.1:1",
               SRML_TORCH_GOSSIP_FANOUT="3", SRML_TORCH_FLEET_VNODES="16",
               SRML_FLEET_DRAIN_TIMEOUT_S="5", SRML_AUTOSCALE_HIGH_WATERMARK="2",
               SRML_AUTOSCALE_MAX_REPLICAS="2", SRML_TORCH_AUTOSCALE_MAX_REPLICAS="5",
               SRML_SERVE_AOT="0")
    for k in ("SRML_TORCH_RUN_JOURNAL", "SRML_TORCH_SLO_OBJECTIVES", "SRML_TORCH_DEVICE_TIMING",
              "SRML_TORCH_DAEMON_STATE_DIR", "SRML_TORCH_GOSSIP_INTERVAL_S",
              "SRML_TORCH_SERVE_VERSION_STRICT", "SRML_TORCH_FLEET_SEED_ADDRESSES",
              "SRML_TORCH_FLEET_DRAIN_TIMEOUT_S", "SRML_TORCH_AUTOSCALE_HIGH_WATERMARK",
              "SRML_TORCH_SERVE_AOT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ("[None, '', False, 0.25, True, None, 0.0, True, None, 3, 16, "
                                  "30.0, 8.0, 5, True, []]"), \
        out.stderr
