"""Perf regression gate: a fresh BENCH record vs the recorded trajectory.

The port's copy of ``spark_rapids_ml_tpu/tools/perfcheck.py``: the same
gates, constants, record families and field names (``mode``,
``interpret``, ``backend``, ``xla``, ``metric``, ``value``; the port's
kernel ledger keeps the jit ledger's ``xla`` breakdown), so the port's
benchmark can write its records unchanged. Standard library only.

Five rounds of BENCH_r*.json gave the repo a throughput history; this
tool makes that history a GATE instead of a graph. It compares one fresh
``bench.py`` record against the trajectory and exits nonzero when:

* **throughput regressed**: the fresh value is more than
  ``--max-regression`` (default 15%) below the MEDIAN of the matching
  history records (median, not max: one lucky round must not ratchet the
  gate above what the hardware repeatably does);
* **steady-state compile storm**: the record's jit-ledger breakdown
  (``xla.steady`` — everything after the warmup fit) shows ANY ledgered
  entry compiling during the timed region. A compile in steady state
  means a shape leaked into the hot loop; it silently eats device time
  that the host-side clock attributes to "compute". ``--allow-compile
  FN`` exempts a named entry (for a PR that knowingly adds a shape).

Only history records whose ``metric`` matches the fresh record's are
compared (the metric name embeds the workload shape, e.g.
``..._d2048_k32``): a smoke run at toy shapes gates ONLY on the compile
storm, with a note that no comparable history exists.

Usage::

    python bench.py > fresh.json
    python -m spark_rapids_ml_tpu_torch.tools.perfcheck fresh.json \
        [--history 'BENCH_r*.json'] [--max-regression 0.15]

``-`` reads the fresh record from stdin (pipe bench straight in).
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

DEFAULT_MAX_REGRESSION = 0.15

#: Absolute scaling-efficiency floor for multichip fit records — the
#: acceptance bar of the pod-scale fit work (docs/mesh.md): below it the
#: collective path is eating more than 20% of the hardware, regardless
#: of what the trajectory once recorded.
MULTICHIP_MIN_EFFICIENCY = 0.8

#: Absolute QPS scaling-efficiency floor for fleet serving records
#: (``bench.py --serve --fleet``): QPS_N / (N × QPS_1) must keep at
#: least 70% of each added replica — below it the router or the
#: replicas serialize somewhere and "scale-out" is mostly overhead.
FLEET_MIN_EFFICIENCY = 0.7

#: Cap on the telemetry plane's serving cost (``bench.py --serve``
#: ``telemetry_overhead``: fractional QPS lost with SLO evaluation
#: ticking, the span ring armed, and a live telemetry_pull/trace_pull
#: scraper vs the plain scheduler-on run). Observability that eats more
#: than 2% of the thing it observes is a tax, not a plane.
TELEMETRY_MAX_OVERHEAD = 0.02


def parse_record(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize either record shape to {metric, value, ...}: the raw
    ``bench.py`` JSON line, or the harness's BENCH_r*.json wrapper
    that nests it under ``parsed``."""
    if "parsed" in obj and isinstance(obj["parsed"], dict):
        inner = dict(obj["parsed"])
        # The wrapper keeps the ledger outside `parsed` on some rounds;
        # carry whichever copy exists.
        if "xla" not in inner and isinstance(obj.get("xla"), dict):
            inner["xla"] = obj["xla"]
        return inner
    return obj


def load_history(patterns: Iterable[str]) -> List[Dict[str, Any]]:
    recs = []
    for pat in patterns:
        for path in sorted(glob_mod.glob(pat)):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    recs.append(parse_record(json.load(f)))
            except (OSError, ValueError) as e:
                print(f"perfcheck: skipping unreadable {path}: {e}",
                      file=sys.stderr)
    return recs


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def check(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
    allow_compiles: Tuple[str, ...] = (),
    require_xla: bool = False,
) -> Tuple[bool, List[str]]:
    """(ok, report lines). ``fresh``/``history`` are parse_record output.

    ``require_xla``: a fresh record with NO ``xla`` breakdown at all is
    SKIP-not-pass (overall FAIL) — set for plain BENCH records, where
    every post-r06 bench embeds the ledger; the fleet/chaos record
    families legitimately carry none and keep the soft SKIP."""
    lines: List[str] = []
    ok = True

    metric = fresh.get("metric")
    value = fresh.get("value")
    if metric is None or value is None:
        return False, ["fresh record has no metric/value — not a BENCH "
                       "record?"]
    value = float(value)
    matching = [
        float(h["value"]) for h in history
        if h.get("metric") == metric and h.get("value") is not None
    ]
    if matching:
        base = _median(matching)
        floor = (1.0 - max_regression) * base
        delta = (value - base) / base if base else 0.0
        verdict = "OK" if value >= floor else "REGRESSION"
        lines.append(
            f"throughput [{verdict}] {metric}: {value:,.1f} vs median "
            f"{base:,.1f} over {len(matching)} record(s) "
            f"({delta:+.1%}; gate at -{max_regression:.0%})"
        )
        if value < floor:
            ok = False
    else:
        lines.append(
            f"throughput [SKIP] no history records match metric {metric!r} "
            f"({len(history)} record(s) examined) — compile gate only"
        )

    xla = fresh.get("xla")
    if require_xla and (not isinstance(xla, dict) or not xla):
        # A BENCH record MISSING the xla breakdown entirely is
        # SKIP-not-pass: since the jit ledger exists (r06), every bench
        # run embeds it, so its absence means the record cannot prove
        # the no-compile-storm property at all — the overall verdict
        # must be FAIL, not a quiet pass on throughput alone.
        # (Pre-ledger BENCH_r01–r05 are HISTORY, never the fresh record
        # — they are unaffected.)
        lines.append(
            "compile storm [SKIP-not-pass] fresh record embeds no `xla` "
            "ledger breakdown at all — post-r06 BENCH records must embed "
            "warmup/steady (re-run bench.py with metrics on); nothing "
            "gated, NOT a pass"
        )
        return False, lines
    steady = (xla or {}).get("steady")
    if not isinstance(steady, dict) or not steady:
        # An EMPTY steady dict means the ledger measured nothing (bench
        # run with metrics off) — that must read as "not checked", never
        # as a clean pass.
        lines.append(
            "compile storm [SKIP] record embeds no xla.steady ledger "
            "breakdown (pre-jit-ledger bench, or metrics were off)"
        )
        return ok, lines
    storms = {
        fn: a for fn, a in steady.items()
        if a.get("compiles", 0) > 0 and fn not in allow_compiles
    }
    if storms:
        ok = False
        for fn, a in sorted(storms.items()):
            lines.append(
                f"compile storm [FAIL] {fn}: {a['compiles']} steady-state "
                f"compile(s), {a.get('compile_s', 0.0):.3f}s — a shape "
                "leaked into the timed hot loop (or pass --allow-compile "
                f"{fn} with a reason in the PR)"
            )
    else:
        total_warm = sum(
            a.get("compile_s", 0.0)
            for a in ((xla or {}).get("warmup") or {}).values()
        )
        lines.append(
            f"compile storm [OK] 0 steady-state compiles across "
            f"{len(steady)} ledgered fn(s) (warmup compiled "
            f"{total_warm:.2f}s as expected)"
        )
    return ok, lines


def _is_dryrun(rec: Dict[str, Any]) -> bool:
    """The MULTICHIP_r01–r05 era records are smoke dryruns ({n_devices,
    rc, ok, tail}) with no measured value; a fresh record can also mark
    itself ``dryrun``. Either way: nothing to gate on."""
    return bool(rec.get("dryrun")) or (
        rec.get("value") is None and "tail" in rec
    )


def check_multichip(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
    allow_compiles: Tuple[str, ...] = (),
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --multichip`` record: the SCALING-EFFICIENCY
    floor (absolute ``MULTICHIP_MIN_EFFICIENCY``, plus the trajectory
    median like the throughput gate), then throughput vs matching
    history. Dryrun records — fresh or historical — SKIP, never pass:
    a smoke run proves the plumbing, not the scaling."""
    lines: List[str] = []
    if _is_dryrun(fresh):
        lines.append(
            "multichip [SKIP] fresh record is a dryrun (no measured "
            "scaling) — nothing gated, NOT a pass"
        )
        return True, lines
    eff = fresh.get("scaling_efficiency")
    if eff is None:
        return False, [
            "multichip record has no scaling_efficiency — not a "
            "bench.py --multichip record?"
        ]
    ok = True
    eff = float(eff)
    dryruns = sum(1 for h in history if _is_dryrun(h))
    if dryruns:
        lines.append(
            f"multichip [SKIP] {dryruns} dryrun history record(s) carry "
            "no scaling number and are excluded from the trajectory"
        )
    # Like-for-like: simulated-mesh efficiencies and real-pod
    # efficiencies are different quantities (docs/mesh.md).
    matching = [
        float(h["scaling_efficiency"]) for h in history
        if not _is_dryrun(h)
        and h.get("metric") == fresh.get("metric")
        and h.get("scaling_efficiency") is not None
        and bool(h.get("simulated")) == bool(fresh.get("simulated"))
    ]
    floor = MULTICHIP_MIN_EFFICIENCY
    if matching:
        floor = max(floor, (1.0 - max_regression) * _median(matching))
    verdict = "OK" if eff >= floor else "REGRESSION"
    lines.append(
        f"scaling efficiency [{verdict}] {eff:.4f} at "
        f"{fresh.get('n_devices')} device(s) "
        f"({'simulated' if fresh.get('simulated') else 'real'} mesh) vs "
        f"floor {floor:.4f} (abs {MULTICHIP_MIN_EFFICIENCY}, "
        f"{len(matching)} trajectory record(s))"
    )
    if eff < floor:
        ok = False
    # Throughput gate on like-for-like history only: the metric name
    # carries d/k but not the mesh, and a simulated-CPU rows/s is a
    # different quantity from a real pod's (as is a different device
    # count) — mixing them would fail good records or mask regressions.
    t_ok, t_lines = check(
        fresh,
        [
            h for h in history
            if not _is_dryrun(h)
            and bool(h.get("simulated")) == bool(fresh.get("simulated"))
            and h.get("n_devices") == fresh.get("n_devices")
        ],
        max_regression=max_regression,
        # Multichip steady keys are mesh-prefixed ("8dev:gram...") —
        # pass the name exactly as the failure line prints it.
        allow_compiles=allow_compiles,
    )
    return ok and t_ok, lines + t_lines


def check_telemetry_overhead(fresh: Dict[str, Any]) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --serve`` record's telemetry cost: the
    fractional QPS lost to the hot telemetry plane must stay under
    :data:`TELEMETRY_MAX_OVERHEAD`. Absolute, not trajectory-relative —
    the bound is a product promise (docs/observability.md), so a slow
    round must not ratchet it."""
    ov = fresh.get("telemetry_overhead")
    if ov is None:
        return True, [
            "telemetry [SKIP] record carries no telemetry_overhead "
            "(pre-telemetry bench.py --serve round) — nothing gated"
        ]
    ov = float(ov)
    ok = ov < TELEMETRY_MAX_OVERHEAD
    scrapes = (fresh.get("telemetry_on") or {}).get("scrapes")
    return ok, [
        f"telemetry [{'OK' if ok else 'REGRESSION'}] overhead "
        f"{ov * 100:.2f}% of serving QPS (SLO eval + ring + "
        f"{scrapes} wire scrapes) vs cap "
        f"{TELEMETRY_MAX_OVERHEAD * 100:.0f}%"
    ]


def check_serve_fleet(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --serve --fleet`` record: the QPS
    scaling-efficiency floor (absolute :data:`FLEET_MIN_EFFICIENCY`,
    raised by the trajectory median like every other gate), then
    throughput vs like-for-like history (same metric + replica count).
    Dryrun records — the in-process smoke mode, whose replicas share one
    device lock — SKIP, never pass: they prove plumbing, not scaling."""
    lines: List[str] = []
    if bool(fresh.get("dryrun")):
        lines.append(
            "fleet [SKIP] fresh record is a dryrun (in-process replicas "
            "share one device lock; no measured scaling) — nothing "
            "gated, NOT a pass"
        )
        return True, lines
    eff = fresh.get("scaling_efficiency")
    if eff is None:
        return False, [
            "fleet record has no scaling_efficiency — not a "
            "bench.py --serve --fleet record?"
        ]
    ok = True
    eff = float(eff)
    wire_limited = bool(fresh.get("wire_limited"))
    key = "fabric_relative_efficiency" if wire_limited else "scaling_efficiency"
    matching = [
        float(h[key]) for h in history
        if not bool(h.get("dryrun"))
        and h.get("metric") == fresh.get("metric")
        and h.get("n_replicas") == fresh.get("n_replicas")
        and bool(h.get("wire_limited")) == wire_limited
        and h.get(key) is not None
    ]
    floor = FLEET_MIN_EFFICIENCY
    if matching:
        floor = max(floor, (1.0 - max_regression) * _median(matching))
    if wire_limited:
        # The host's raw loopback cannot even carry N x QPS_1 (the
        # record's `wire` microphase, protocol-faithful frame pattern)
        # — a single-box transport ceiling no networked service can
        # beat. The ABSOLUTE gate is therefore unmeasurable here: SKIP,
        # never pass. What IS measurable is the fleet layer's own
        # overhead on top of that fabric — gate the fabric-relative
        # efficiency (QPS_N / min(N x QPS_1, fabric capacity)) instead.
        wire_cap = (fresh.get("wire") or {}).get("reqs_per_s_n")
        lines.append(
            f"fleet scaling [SKIP] absolute QPS efficiency {eff:.4f} "
            f"unmeasurable: the raw wire fabric carries {wire_cap} "
            f"req/s across {fresh.get('n_replicas')} process pairs, "
            "below the N x QPS_1 ideal (single-box transport ceiling) "
            "— NOT a pass"
        )
        rel = fresh.get("fabric_relative_efficiency")
        if rel is None:
            return False, lines + [
                "fleet scaling [FAIL] wire_limited record carries no "
                "fabric_relative_efficiency"
            ]
        rel = float(rel)
        verdict = "OK" if rel >= floor else "REGRESSION"
        lines.append(
            f"fabric-relative [{verdict}] {rel:.4f} (QPS scaling / wire "
            f"scaling) vs floor {floor:.4f} (abs {FLEET_MIN_EFFICIENCY}, "
            f"{len(matching)} trajectory record(s))"
        )
        if rel < floor:
            ok = False
    else:
        verdict = "OK" if eff >= floor else "REGRESSION"
        lines.append(
            f"fleet scaling [{verdict}] QPS efficiency {eff:.4f} at "
            f"{fresh.get('n_replicas')} replica(s) vs floor {floor:.4f} "
            f"(abs {FLEET_MIN_EFFICIENCY}, {len(matching)} trajectory "
            "record(s))"
        )
        if eff < floor:
            ok = False
    t_ok, t_lines = check(
        fresh,
        [
            h for h in history
            if not bool(h.get("dryrun"))
            and h.get("n_replicas") == fresh.get("n_replicas")
        ],
        max_regression=max_regression,
    )
    return ok and t_ok, lines + t_lines


def check_chaos_elastic(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --chaos-elastic`` record (the 3→2 daemon
    kmeans degrade). Correctness gates are ABSOLUTE — a record whose
    degraded fit was not bitwise-equal to the surviving-topology oracle,
    or that replayed no rows, FAILS regardless of history. The COST
    gates are trajectory-relative: replay throughput (``value``) must
    stay within ``max_regression`` of the metric-matched median, and
    ``recovery_overhead`` (time-to-recover / steady pass) must not grow
    past (1 + max_regression) × its median. No history → cost gates
    SKIP with a note (first record seeds the trajectory)."""
    lines: List[str] = []
    if fresh.get("mode") != "chaos_elastic":
        return False, [
            "record has no mode=chaos_elastic — not a "
            "bench.py --chaos-elastic record?"
        ]
    ok = True
    if not bool(fresh.get("bitwise_equal_oracle")):
        ok = False
        lines.append(
            "elastic correctness [FAIL] the degraded fit was NOT "
            "bitwise-equal to the surviving-topology oracle — the "
            "recovery itself is broken; no cost number matters"
        )
    else:
        lines.append(
            "elastic correctness [OK] degraded fit bitwise-equal to the "
            f"{fresh.get('n_survivors')}-daemon oracle"
        )
    replayed = int(fresh.get("replayed_rows") or 0)
    if replayed <= 0:
        ok = False
        lines.append(
            "elastic correctness [FAIL] record replayed 0 rows — the "
            "degrade path never ran"
        )
    matching = [
        h for h in history
        if h.get("mode") == "chaos_elastic"
        and h.get("metric") == fresh.get("metric")
    ]
    value = float(fresh.get("value") or 0.0)
    overhead = fresh.get("recovery_overhead")
    if not matching:
        lines.append(
            f"recovery cost [SKIP] no CHAOS_r* history matches metric "
            f"{fresh.get('metric')!r} — recorded "
            f"{fresh.get('time_to_recover_s')}s to recover "
            f"({replayed:,} rows; overhead {overhead}×), nothing gated"
        )
        return ok, lines
    base_v = _median([
        float(h["value"]) for h in matching if h.get("value") is not None
    ] or [value])
    floor = (1.0 - max_regression) * base_v
    verdict = "OK" if value >= floor else "REGRESSION"
    lines.append(
        f"replay throughput [{verdict}] {value:,.1f} rows/s vs median "
        f"{base_v:,.1f} over {len(matching)} record(s) "
        f"(gate at -{max_regression:.0%})"
    )
    if value < floor:
        ok = False
    ovs = [
        float(h["recovery_overhead"]) for h in matching
        if h.get("recovery_overhead") is not None
    ]
    if overhead is not None and ovs:
        ceil = (1.0 + max_regression) * _median(ovs)
        verdict = "OK" if float(overhead) <= ceil else "REGRESSION"
        lines.append(
            f"recovery overhead [{verdict}] {float(overhead):.3f}x a "
            f"steady pass vs ceiling {ceil:.3f}x "
            f"(median {_median(ovs):.3f}x)"
        )
        if float(overhead) > ceil:
            ok = False
    return ok, lines


def check_chaos_grow(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --chaos-grow`` record (the 2→3→2 daemon
    kmeans grow/shrink — docs/protocol.md "Mid-fit daemon join").
    Correctness gates are ABSOLUTE — a record whose grown fit was not
    bitwise-equal to the static-topology oracle, or that rebalanced no
    rows onto the joiner, FAILS regardless of history. The COST gates
    are trajectory-relative: admission throughput (``value``,
    rebalanced rows / time-to-grow) must stay within ``max_regression``
    of the metric-matched median, and ``grow_overhead`` (admit + first
    grown pass / steady pass) must not grow past
    (1 + max_regression) × its median. Grow records share the CHAOS_r*
    glob with the degrade family; the mode+metric filter keeps the
    trajectories separate. No history → cost gates SKIP with a note
    (first record seeds the trajectory) — never a silent pass."""
    lines: List[str] = []
    if fresh.get("mode") != "chaos_grow":
        return False, [
            "record has no mode=chaos_grow — not a "
            "bench.py --chaos-grow record?"
        ]
    ok = True
    if not bool(fresh.get("bitwise_equal_oracle")):
        ok = False
        lines.append(
            "grow correctness [FAIL] the grown 2→3→2 fit was NOT "
            "bitwise-equal to the static-topology oracle — the "
            "admission itself is broken; no cost number matters"
        )
    else:
        lines.append(
            "grow correctness [OK] grown fit bitwise-equal to the "
            f"static {fresh.get('n_daemons')}-daemon oracle"
        )
    rebalanced = int(fresh.get("rebalanced_rows") or 0)
    if rebalanced <= 0:
        ok = False
        lines.append(
            "grow correctness [FAIL] record rebalanced 0 rows — the "
            "joiner never took work"
        )
    matching = [
        h for h in history
        if h.get("mode") == "chaos_grow"
        and h.get("metric") == fresh.get("metric")
    ]
    value = float(fresh.get("value") or 0.0)
    overhead = fresh.get("grow_overhead")
    if not matching:
        lines.append(
            f"grow cost [SKIP] no CHAOS_r* history matches metric "
            f"{fresh.get('metric')!r} — recorded "
            f"{fresh.get('time_to_admit_s')}s to admit "
            f"({rebalanced:,} rows rebalanced; overhead {overhead}×), "
            "nothing gated"
        )
        return ok, lines
    base_v = _median([
        float(h["value"]) for h in matching if h.get("value") is not None
    ] or [value])
    floor = (1.0 - max_regression) * base_v
    verdict = "OK" if value >= floor else "REGRESSION"
    lines.append(
        f"admission throughput [{verdict}] {value:,.1f} rows/s vs median "
        f"{base_v:,.1f} over {len(matching)} record(s) "
        f"(gate at -{max_regression:.0%})"
    )
    if value < floor:
        ok = False
    ovs = [
        float(h["grow_overhead"]) for h in matching
        if h.get("grow_overhead") is not None
    ]
    if overhead is not None and ovs:
        ceil = (1.0 + max_regression) * _median(ovs)
        verdict = "OK" if float(overhead) <= ceil else "REGRESSION"
        lines.append(
            f"grow overhead [{verdict}] {float(overhead):.3f}x a "
            f"steady pass vs ceiling {ceil:.3f}x "
            f"(median {_median(ovs):.3f}x)"
        )
        if float(overhead) > ceil:
            ok = False
    return ok, lines


def check_chaos_partition(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --chaos-partition`` record (the 2-island
    gossip split + heal — docs/protocol.md "Fleet gossip &
    bootstrap"). Correctness gates are ABSOLUTE — a record whose four
    views did not converge after the bridge push, whose partitioned
    traffic failed or wobbled (``failed_during_partition`` /
    ``mismatched_during_partition`` nonzero, or no traffic routed at
    all), or whose stale version was not tombstoned on every view
    (``tombstones_clean``) FAILS regardless of history: a partition
    may degrade freshness, never correctness, and a heal must never
    resurrect the losing island's version. The COST gate is
    trajectory-relative: ``time_to_converge_s`` (``value``, lower is
    better) must not grow past (1 + max_regression) × the
    metric-matched median. Partition records share the CHAOS_r* glob
    with the elastic degrade/grow families; the mode+metric filter
    keeps the trajectories separate. No history → the cost gate SKIPs
    with a note (first record seeds the trajectory) — never a silent
    pass."""
    lines: List[str] = []
    if fresh.get("mode") != "chaos_partition":
        return False, [
            "record has no mode=chaos_partition — not a "
            "bench.py --chaos-partition record?"
        ]
    ok = True
    if not bool(fresh.get("converged")):
        ok = False
        lines.append(
            "partition correctness [FAIL] the four FleetViews did NOT "
            "converge after the bridge push — anti-entropy itself is "
            "broken; no cost number matters"
        )
    else:
        lines.append(
            "partition correctness [OK] all "
            f"{fresh.get('n_daemons')} views converged "
            "(one active version, one epoch, stale version tombstoned)"
        )
    routed = int(fresh.get("routed_during_partition") or 0)
    failed = int(fresh.get("failed_during_partition") or 0)
    wobbled = int(fresh.get("mismatched_during_partition") or 0)
    if routed <= 0:
        ok = False
        lines.append(
            "partition correctness [FAIL] record routed 0 requests "
            "inside the split — the bench never exercised the "
            "partitioned data plane"
        )
    elif failed or wobbled:
        ok = False
        lines.append(
            f"partition correctness [FAIL] traffic inside the split "
            f"failed={failed} mismatched={wobbled} over {routed:,} "
            "routed — a partition must degrade freshness, never "
            "correctness"
        )
    else:
        lines.append(
            f"partition correctness [OK] {routed:,} requests routed "
            "inside the split, zero failed, bitwise-stable"
        )
    if not bool(fresh.get("tombstones_clean")):
        ok = False
        lines.append(
            "partition correctness [FAIL] the losing island's version "
            "is not tombstoned on every view — the heal can resurrect "
            "it"
        )
    matching = [
        h for h in history
        if h.get("mode") == "chaos_partition"
        and h.get("metric") == fresh.get("metric")
    ]
    value = float(fresh.get("value") or 0.0)
    if not matching:
        lines.append(
            f"partition cost [SKIP] no CHAOS_r* history matches metric "
            f"{fresh.get('metric')!r} — recorded {value}s to converge "
            f"(interval {fresh.get('gossip_interval_s')}s, fanout "
            f"{fresh.get('gossip_fanout')}), nothing gated"
        )
        return ok, lines
    base = _median([
        float(h["value"]) for h in matching if h.get("value") is not None
    ] or [value])
    ceil = (1.0 + max_regression) * base
    verdict = "OK" if value <= ceil else "REGRESSION"
    lines.append(
        f"time to converge [{verdict}] {value:.4f}s vs ceiling "
        f"{ceil:.4f}s (median {base:.4f}s over {len(matching)} "
        f"record(s), gate at +{max_regression:.0%})"
    )
    if value > ceil:
        ok = False
    return ok, lines


def check_forest(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --forest`` record (histogram tree ensembles —
    FOREST_r*). Correctness gates are ABSOLUTE: ``accuracy_ok`` (ours
    within 0.05 of the sklearn-CPU baseline, or over the 0.9 synthetic
    floor when sklearn is absent) and a non-empty fit (passes >= 1,
    positive throughput) FAIL regardless of history. The THROUGHPUT
    gates are trajectory-relative: fit scan rows/s (``value``) and
    ``transform_rows_per_s`` must each stay within ``max_regression``
    of the metric-matched FOREST_r* median. No history → throughput
    gates SKIP with a note (first record seeds the trajectory) — never
    a silent pass."""
    lines: List[str] = []
    if fresh.get("mode") != "forest":
        return False, [
            "record has no mode=forest — not a bench.py --forest record?"
        ]
    ok = True
    value = float(fresh.get("value") or 0.0)
    passes = int(fresh.get("passes") or 0)
    if passes < 1 or value <= 0.0:
        ok = False
        lines.append(
            "forest correctness [FAIL] the fit grew no levels "
            f"(passes={passes}, value={value}) — the bench never ran"
        )
    base = fresh.get("baseline") or {}
    if not bool(fresh.get("accuracy_ok")):
        ok = False
        lines.append(
            f"forest accuracy [FAIL] held-out accuracy "
            f"{fresh.get('accuracy')} failed the absolute gate (baseline "
            f"{base.get('impl') or 'synthetic floor'}: "
            f"{base.get('accuracy', 0.9)}) — no throughput number matters"
        )
    else:
        lines.append(
            f"forest accuracy [OK] {fresh.get('accuracy')} vs "
            f"{base.get('impl') or 'synthetic floor'} baseline "
            f"{base.get('accuracy', 0.9)}"
        )
    matching = [
        h for h in history
        if h.get("mode") == "forest"
        and h.get("metric") == fresh.get("metric")
        # Never mix backends in one trajectory (the check_multichip
        # simulated/real rule): a CPU record gated against a
        # TPU median is a spurious regression, and the converse hides
        # a real one.
        and h.get("backend") == fresh.get("backend")
    ]
    if not matching:
        lines.append(
            f"forest throughput [SKIP] no FOREST_r* history matches "
            f"metric {fresh.get('metric')!r} on backend "
            f"{fresh.get('backend')!r} — recorded {value:,.0f} "
            f"fit rows/s, {fresh.get('transform_rows_per_s')} transform "
            "rows/s, nothing gated"
        )
        return ok, lines
    for key, fval in (
        ("value", value),
        ("transform_rows_per_s",
         float(fresh.get("transform_rows_per_s") or 0.0)),
    ):
        hist_vals = [
            float(h[key]) for h in matching if h.get(key) is not None
        ]
        if not hist_vals:
            lines.append(f"forest {key} [SKIP] no history values")
            continue
        med = _median(hist_vals)
        floor = (1.0 - max_regression) * med
        verdict = "OK" if fval >= floor else "REGRESSION"
        lines.append(
            f"forest {key} [{verdict}] {fval:,.1f} vs median {med:,.1f} "
            f"over {len(matching)} record(s) (gate at -{max_regression:.0%})"
        )
        if fval < floor:
            ok = False
    return ok, lines


#: Noise band for the fused-vs-unfused kernel gate: "never slower" with a
#: small measurement allowance so a same-speed kernel doesn't flap the CI.
KERNELS_MIN_SPEEDUP = 0.97


def check_kernels(
    fresh: Dict[str, Any],
    history: List[Dict[str, Any]],
    max_regression: float = DEFAULT_MAX_REGRESSION,
) -> Tuple[bool, List[str]]:
    """Gate a ``bench.py --kernels`` record (metric ``kernel_*``): the
    fused Pallas path must be never-slower-than-unfused ON THE SAME
    BACKEND (``speedup`` ≥ ~1 within the noise band), plus the standard
    throughput-vs-history gate on the fused rows/s. Interpret-mode
    records (on a CPU: the fused kernel runs the Pallas interpreter,
    which measures nothing about the TPU kernel) take the dryrun
    convention of the multichip/fleet gates: annotated "NOT a pass",
    nothing gated, exit 0 — the environment, not the kernel, is what
    can't be measured (unlike a BENCH record missing its xla breakdown,
    which is a fixable omission and FAILS via ``require_xla``)."""
    lines: List[str] = []
    if fresh.get("mode") != "kernels":
        return False, [
            "record has no mode=kernels — not a bench.py --kernels record?"
        ]
    if bool(fresh.get("interpret")):
        lines.append(
            f"kernel fusion [SKIP] {fresh.get('kernel')}: fused path ran "
            f"the Pallas interpreter on backend {fresh.get('backend')!r} "
            "— fused-vs-unfused is unmeasurable off-TPU; nothing gated, "
            "NOT a pass"
        )
        return True, lines
    ok = True
    speedup = fresh.get("speedup")
    if speedup is None:
        return False, ["kernels record has no speedup field"]
    verdict = "OK" if float(speedup) >= KERNELS_MIN_SPEEDUP else "REGRESSION"
    lines.append(
        f"kernel fusion [{verdict}] {fresh.get('kernel')}: fused "
        f"{fresh.get('value'):,.1f} vs unfused "
        f"{fresh.get('unfused_rows_per_s'):,.1f} {fresh.get('unit')} "
        f"(speedup {float(speedup):.3f}x; floor {KERNELS_MIN_SPEEDUP}x — "
        "fused must never be slower than unfused on the same backend)"
    )
    if float(speedup) < KERNELS_MIN_SPEEDUP:
        ok = False
    t_ok, t_lines = check(
        fresh,
        [h for h in history
         if h.get("mode") == "kernels"
         and h.get("backend") == fresh.get("backend")
         and not bool(h.get("interpret"))],
        max_regression=max_regression,
    )
    return ok and t_ok, lines + t_lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_ml_tpu_torch.tools.perfcheck",
        description="Gate a fresh bench record of the PyTorch port against "
        "the BENCH_r* trajectory.",
    )
    ap.add_argument(
        "record",
        help="fresh bench.py JSON record (file path, or - for stdin)",
    )
    ap.add_argument(
        "--history", action="append", default=None,
        metavar="GLOB",
        help="history record glob(s); default BENCH_r*.json",
    )
    ap.add_argument(
        "--max-regression", type=float, default=DEFAULT_MAX_REGRESSION,
        help="fail when fresh < (1 - this) x median(history); default 0.15",
    )
    ap.add_argument(
        "--allow-compile", action="append", default=[], metavar="FN",
        help="exempt a ledgered fn from the steady-state compile gate",
    )
    args = ap.parse_args(argv)

    if args.record == "-":
        raw = sys.stdin.read()
    else:
        with open(args.record, "r", encoding="utf-8") as f:
            raw = f.read()
    # bench.py prints exactly one JSON line, but a piped run may carry
    # log noise around it — take the last parseable line. A whole-file
    # JSON document (a harness's MULTICHIP_r*/BENCH_r* wrapper, pretty-
    # printed over many lines) parses first.
    fresh = None
    try:
        doc = json.loads(raw)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        fresh = parse_record(doc)
    else:
        # Non-object documents (a JSON array, a bare scalar) are not
        # records — fall through to the line scan, which skips them and
        # exits with the graceful "no JSON record" message.
        for line in raw.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    candidate = json.loads(line)
                except ValueError:
                    continue
                if isinstance(candidate, dict):
                    fresh = parse_record(candidate)
    if fresh is None:
        print("perfcheck: no JSON record found in input", file=sys.stderr)
        return 2

    multichip = str(fresh.get("metric", "")).startswith("multichip_") or (
        _is_dryrun(fresh) and "n_devices" in fresh
    )
    fleet = str(fresh.get("metric", "")).startswith("serve_fleet_")
    chaos = str(fresh.get("metric", "")).startswith("chaos_elastic_")
    grow = str(fresh.get("metric", "")).startswith("chaos_grow_")
    partition = str(fresh.get("metric", "")).startswith("chaos_partition_")
    forest = str(fresh.get("metric", "")).startswith("forest_")
    kernels = str(fresh.get("metric", "")).startswith("kernel_")
    default_glob = (
        "KERNELS_r*.json" if kernels
        else "FOREST_r*.json" if forest
        else "CHAOS_r*.json" if chaos or grow or partition
        else "FLEET_r*.json" if fleet
        else "MULTICHIP_r*.json" if multichip else "BENCH_r*.json"
    )
    history = load_history(args.history or [default_glob])
    if kernels:
        ok, lines = check_kernels(
            fresh, history, max_regression=args.max_regression,
        )
    elif forest:
        ok, lines = check_forest(
            fresh, history, max_regression=args.max_regression,
        )
    elif chaos:
        ok, lines = check_chaos_elastic(
            fresh, history, max_regression=args.max_regression,
        )
    elif grow:
        ok, lines = check_chaos_grow(
            fresh, history, max_regression=args.max_regression,
        )
    elif partition:
        ok, lines = check_chaos_partition(
            fresh, history, max_regression=args.max_regression,
        )
    elif fleet:
        ok, lines = check_serve_fleet(
            fresh, history, max_regression=args.max_regression,
        )
    elif multichip:
        ok, lines = check_multichip(
            fresh, history, max_regression=args.max_regression,
            allow_compiles=tuple(args.allow_compile),
        )
    else:
        ok, lines = check(
            fresh, history,
            max_regression=args.max_regression,
            allow_compiles=tuple(args.allow_compile),
            # Only the fit-bench family must embed the ledger; plain
            # `bench.py --serve` records (serve_transform_qps_*) land in
            # this default branch too and legitimately carry no `xla` —
            # they keep the soft SKIP like the fleet/chaos families.
            require_xla=not str(fresh.get("metric", "")).startswith("serve_"),
        )
        if str(fresh.get("metric", "")).startswith("serve_"):
            t_ok, t_lines = check_telemetry_overhead(fresh)
            ok, lines = ok and t_ok, lines + t_lines
    for line in lines:
        print(line)
    print("perfcheck:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
