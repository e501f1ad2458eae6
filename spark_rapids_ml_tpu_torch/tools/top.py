"""``top`` for the data-plane daemon: live queue depth, op rates, latency.

The port's copy of ``spark_rapids_ml_tpu/tools/top.py``, speaking to the
port's daemons through its client.

Polls a running daemon's additive ``health`` + ``metrics`` wire ops
(docs/protocol.md) and renders a per-op table — request totals, rates
since the previous poll, latency quantiles interpolated from the
cumulative histogram buckets, and payload byte rates — plus the
trace_span phase breakdown. Nothing here is privileged: it reads exactly
what any scraper reads, so the number an operator stares at IS the
number the dashboard records.

Usage::

    python -m spark_rapids_ml_tpu_torch.tools.top [host:port[,host:port...]] \
        [--interval 2] [--count N] [--once] [--token SECRET]

``host:port`` defaults to ``$SRML_DAEMON_ADDRESS``. ``--once`` prints a
single snapshot and exits (scripts/tests); the default loop redraws in
place until interrupted.

A comma-separated address list renders the FLEET panel instead: one row
per replica daemon (identity, boot, uptime, connections, served models,
scheduler queue, busy state), with dead replicas shown as DOWN rather
than killing the poll — the operator view of a serve/fleet.py
deployment. The single-address view is unchanged.

``--fleet`` renders the GOSSIPED fleet panel from ONE seed address: it
pulls the seed's FleetView (the ``gossip_pull`` wire op) and shows every
replica record (liveness, boot, record epoch) and every model's version
table (active version, fleet epoch, tombstoned versions, any live
rollout intent) the fleet itself knows — no roster to maintain, and if
the seed dies the next pull fails over to any replica the last view
listed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Tuple

# The quantile estimator lives in utils/metrics.py (the serve
# autoscaler's p99 objective reads the same interpolation this panel
# renders).
from spark_rapids_ml_tpu_torch.utils.metrics import quantile_from_buckets

REQ = "srml_daemon_requests_total"
LAT = "srml_daemon_request_seconds"
RX = "srml_daemon_rx_bytes_total"
TX = "srml_daemon_tx_bytes_total"
PHASES = "srml_phase_duration_seconds"
RESTORES = "srml_daemon_job_restores_total"
RECOVERIES = "srml_fit_recoveries_total"
LOSSES = "srml_fit_daemon_losses_total"
REROUTES = "srml_fit_reroutes_total"
SCHED_QUEUE = "srml_scheduler_queue_depth"
SCHED_BATCH_ROWS = "srml_scheduler_batch_rows"
SCHED_BATCHED = "srml_scheduler_batched_requests_total"
SCHED_PADDED = "srml_scheduler_padded_rows_total"
SCHED_MISSES = "srml_scheduler_compile_misses_total"
SCHED_HITS = "srml_scheduler_compile_hits_total"
SCHED_SHEDS = "srml_scheduler_sheds_total"
AUTO_LAST = "srml_autoscale_last_decision"
AUTO_LOAD = "srml_autoscale_load"
AUTO_WATERMARK = "srml_autoscale_watermark"
AUTO_COOLDOWN = "srml_autoscale_cooldown_seconds"
AUTO_REPLICAS = "srml_autoscale_replicas"
AUTO_ACTIONS = "srml_autoscale_actions_total"
SLO_BURN = "srml_slo_burn_rate"
SLO_BREACH = "srml_slo_breach"




def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TB"


def _fmt_secs(s: Optional[float]) -> str:
    if s is None:
        return "-"
    if s < 1e-3:
        return f"{s * 1e6:.0f}us"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


def _sum_by_op(metric: Optional[Dict[str, Any]], value_key: str = "value"
               ) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in (metric or {}).get("samples", []):
        op = s["labels"].get("op", "")
        out[op] = out.get(op, 0.0) + float(s.get(value_key, 0.0))
    return out


def _hist_by_label(metric: Optional[Dict[str, Any]], label: str
                   ) -> Dict[str, Dict[str, Any]]:
    return {
        s["labels"].get(label, ""): s
        for s in (metric or {}).get("samples", [])
    }


def render(
    health: Dict[str, Any],
    snap: Dict[str, Any],
    prev: Optional[Dict[str, Any]] = None,
    dt: Optional[float] = None,
) -> str:
    """One screenful from a health dict + metrics snapshot; ``prev``/
    ``dt`` (the previous snapshot and the seconds between them) turn
    totals into rates. Pure function — the unit under test."""
    lines: List[str] = []
    busy = " [BUSY: %s]" % health.get("busy_reason") if health.get("busy") else ""
    lines.append(
        "daemon %s — up %.0fs  conns %d  staged %s  jobs %d  models %d%s"
        % (
            health.get("id", "?"),
            float(health.get("uptime_s", 0.0)),
            int(health.get("queue_depth", 0)),
            _fmt_bytes(float(health.get("staged_bytes", 0))),
            int(health.get("active_jobs", 0)),
            int(health.get("served_models", 0)),
            busy,
        )
    )
    # Incarnation line: boot_id changes on every restart (with durable
    # state the instance id above stays put), so a restart — and any jobs
    # resurrected or fits replayed since — is visible at a glance.
    boot = health.get("boot_id")
    restores = sum(
        float(s.get("value", 0.0))
        for s in (snap.get(RESTORES) or {}).get("samples", [])
    )
    recoveries = sum(
        float(s.get("value", 0.0))
        for s in (snap.get(RECOVERIES) or {}).get("samples", [])
    )
    losses = sum(
        float(s.get("value", 0.0))
        for s in (snap.get(LOSSES) or {}).get("samples", [])
    )
    reroutes = sum(
        float(s.get("value", 0.0))
        for s in (snap.get(REROUTES) or {}).get("samples", [])
    )
    if boot or restores or recoveries or losses or reroutes:
        bits = []
        if boot:
            durable = "durable" if health.get("durable") else "volatile"
            bits.append(f"boot {boot} ({durable})")
        if restores:
            bits.append(f"jobs restored {int(restores)}")
        if recoveries:
            bits.append(f"fit recoveries {int(recoveries)}")
        if losses:
            # An operator must see an amputation at a glance: each one
            # is a daemon the fleet permanently lost mid-fit.
            bits.append(f"daemons lost {int(losses)}")
        if reroutes:
            bits.append(f"passes rerouted {int(reroutes)}")
        lines.append("  ".join(bits))
    reqs = _sum_by_op(snap.get(REQ))
    prev_reqs = _sum_by_op((prev or {}).get(REQ))
    lat = _hist_by_label(snap.get(LAT), "op")
    rx = _sum_by_op(snap.get(RX))
    tx = _sum_by_op(snap.get(TX))
    lines.append("")
    lines.append(
        f"{'op':<14}{'reqs':>8}{'rate/s':>9}{'p50':>9}{'p90':>9}"
        f"{'p99':>9}{'rx':>10}{'tx':>10}"
    )
    for op in sorted(reqs):
        h = lat.get(op)
        buckets = h.get("buckets", {}) if h else {}
        rate = ""
        if prev is not None and dt:
            rate = f"{max(reqs[op] - prev_reqs.get(op, 0.0), 0.0) / dt:.1f}"
        lines.append(
            f"{op:<14}{int(reqs[op]):>8}{rate:>9}"
            f"{_fmt_secs(quantile_from_buckets(buckets, 0.50)):>9}"
            f"{_fmt_secs(quantile_from_buckets(buckets, 0.90)):>9}"
            f"{_fmt_secs(quantile_from_buckets(buckets, 0.99)):>9}"
            f"{_fmt_bytes(rx.get(op, 0.0)):>10}"
            f"{_fmt_bytes(tx.get(op, 0.0)):>10}"
        )
    sched = _sched_lines(health, snap)
    if sched:
        lines.append("")
        lines.extend(sched)
    autoscale = _autoscale_lines(snap)
    if autoscale:
        lines.append("")
        lines.extend(autoscale)
    slo = _slo_lines(snap)
    if slo:
        lines.append("")
        lines.extend(slo)
    phases = _hist_by_label(snap.get(PHASES), "phase")
    if phases:
        lines.append("")
        lines.append(f"{'phase':<22}{'count':>8}{'total':>10}{'p50':>9}{'p99':>9}")
        for name in sorted(phases):
            s = phases[name]
            lines.append(
                f"{name:<22}{int(s.get('count', 0)):>8}"
                f"{_fmt_secs(float(s.get('sum', 0.0))):>10}"
                f"{_fmt_secs(quantile_from_buckets(s.get('buckets', {}), 0.50)):>9}"
                f"{_fmt_secs(quantile_from_buckets(s.get('buckets', {}), 0.99)):>9}"
            )
    return "\n".join(lines)


def _sched_lines(health: Dict[str, Any], snap: Dict[str, Any]) -> List[str]:
    """The serving-scheduler panel (docs/protocol.md "Serving
    scheduler"): per-model queue depth, batch-occupancy quantiles +
    mean, padding-waste ratio, compile-cache hits/misses, sheds. Empty
    when the daemon runs unbatched — top never renders a dead panel."""
    sched_health = (health or {}).get("scheduler") or {}
    occ = _hist_by_label(snap.get(SCHED_BATCH_ROWS), "op")
    if not sched_health.get("enabled") and not occ:
        return []
    lines: List[str] = []
    models = sched_health.get("models") or {
        s["labels"].get("model", "?"): s.get("value", 0)
        for s in (snap.get(SCHED_QUEUE) or {}).get("samples", [])
    }
    head = "scheduler"
    if sched_health:
        head += (
            f"  window {float(sched_health.get('window_ms', 0.0)):.0f}ms"
            f"  buckets {','.join(str(b) for b in sched_health.get('buckets', []))}"
            f"  batches {int(sched_health.get('batches', 0))}"
        )
    if models:
        head += "  queued " + " ".join(
            f"{m}:{int(d)}" for m, d in sorted(models.items())
        )
    lines.append(head)
    reqs = _sum_by_op(snap.get(SCHED_BATCHED))
    padded = _sum_by_op(snap.get(SCHED_PADDED))
    misses = _sum_by_op(snap.get(SCHED_MISSES))
    hits = _sum_by_op(snap.get(SCHED_HITS))
    sheds: Dict[str, float] = {}
    for s in (snap.get(SCHED_SHEDS) or {}).get("samples", []):
        op = s["labels"].get("op", "")
        sheds[op] = sheds.get(op, 0.0) + float(s.get("value", 0.0))
    if occ:
        lines.append(
            f"{'op':<14}{'reqs':>8}{'batches':>9}{'occ p50':>9}"
            f"{'occ p99':>9}{'mean':>7}{'waste':>7}{'miss/hit':>10}{'sheds':>7}"
        )
        for op in sorted(occ):
            s = occ[op]
            count = int(s.get("count", 0))
            total_rows = float(s.get("sum", 0.0))
            mean = total_rows / count if count else 0.0
            pad = padded.get(op, 0.0)
            waste = pad / (pad + total_rows) if (pad + total_rows) else 0.0
            p50 = quantile_from_buckets(s.get("buckets", {}), 0.50)
            p99 = quantile_from_buckets(s.get("buckets", {}), 0.99)
            lines.append(
                f"{op:<14}{int(reqs.get(op, 0)):>8}{count:>9}"
                f"{(p50 if p50 is not None else 0):>9.1f}"
                f"{(p99 if p99 is not None else 0):>9.1f}"
                f"{mean:>7.1f}{waste:>7.0%}"
                f"{int(misses.get(op, 0)):>5}/{int(hits.get(op, 0)):<4}"
                f"{int(sheds.get(op, 0)):>7}"
            )
    return lines


def _autoscale_lines(snap: Dict[str, Any]) -> List[str]:
    """The autoscaler panel (docs/protocol.md "Serve autoscaler"): last
    decision, live load against the high/low watermarks, replica count,
    cooldown remaining, and cumulative action tallies — all read from
    the gauges/counters the AutoScaler publishes, so the panel works
    over any daemon sharing its metrics registry. Empty when no
    autoscaler has ever run in the scraped process."""
    last = _hist_by_label(snap.get(AUTO_LAST), "verdict")
    if not last:
        return []
    decision = next(
        (v for v in sorted(last) if float(last[v].get("value", 0.0)) >= 1.0),
        "-",
    )
    marks = _hist_by_label(snap.get(AUTO_WATERMARK), "bound")

    def _gauge(name: str) -> float:
        return sum(
            float(s.get("value", 0.0))
            for s in (snap.get(name) or {}).get("samples", [])
        )

    head = (
        f"autoscaler  decision {decision}"
        f"  load {_gauge(AUTO_LOAD):.2f}"
        f" (low {float(marks.get('low', {}).get('value', 0.0)):.2f}"
        f" / high {float(marks.get('high', {}).get('value', 0.0)):.2f})"
        f"  replicas {int(_gauge(AUTO_REPLICAS))}"
        f"  cooldown {_gauge(AUTO_COOLDOWN):.1f}s"
    )
    lines = [head]
    actions: Dict[str, float] = {}
    for s in (snap.get(AUTO_ACTIONS) or {}).get("samples", []):
        key = "%s/%s" % (
            s["labels"].get("action", "?"),
            s["labels"].get("outcome", "?"),
        )
        actions[key] = actions.get(key, 0.0) + float(s.get("value", 0.0))
    if actions:
        lines.append(
            "  actions "
            + "  ".join(f"{k}:{int(n)}" for k, n in sorted(actions.items()))
        )
    return lines


def _slo_lines(snap: Dict[str, Any]) -> List[str]:
    """The SLO panel (docs/observability.md "SLO burn rates"): per
    objective, the fast- and slow-window error-budget burn rates and
    whether the objective is currently breaching (both windows over
    ``slo_burn_threshold``). Burn 1.0 = spending exactly the budget;
    14.4 = the classic page-worthy fast burn. Empty when no SloEvaluator
    runs in the scraped process."""
    burn = snap.get(SLO_BURN)
    if not burn or not burn.get("samples"):
        return []
    breach: Dict[Tuple[str, str], float] = {}
    for s in (snap.get(SLO_BREACH) or {}).get("samples", []):
        key = (s["labels"].get("objective", ""), s["labels"].get("op", ""))
        breach[key] = float(s.get("value", 0.0))
    rows: Dict[Tuple[str, str], Dict[str, float]] = {}
    for s in burn.get("samples", []):
        labels = s["labels"]
        key = (labels.get("objective", ""), labels.get("op", ""))
        rows.setdefault(key, {})[labels.get("window", "")] = float(
            s.get("value", 0.0)
        )
    lines = [
        f"{'slo objective':<24}{'op':<14}{'fast burn':>11}"
        f"{'slow burn':>11}{'state':>9}"
    ]
    for key in sorted(rows):
        w = rows[key]
        state = "BREACH" if breach.get(key, 0.0) >= 1.0 else "ok"
        lines.append(
            f"{key[0]:<24}{key[1]:<14}{w.get('fast', 0.0):>11.2f}"
            f"{w.get('slow', 0.0):>11.2f}{state:>9}"
        )
    return lines


def render_fleet_telemetry(
    pulls: Dict[str, Optional[Dict[str, Any]]],
) -> str:
    """The one-seed fleet METRICS panel (``--fleet --telemetry``):
    one row per replica from its ``telemetry_pull`` answer (None =
    unreachable → DOWN) — request totals, error count, serving p99,
    SLO breach count, and the config fingerprint. Differing
    fingerprints are the classic silent-drift incident, so the header
    calls them out. Pure function — the unit under test."""
    lines: List[str] = []
    up = sum(1 for p in pulls.values() if p is not None)
    prints = {
        str(p.get("fingerprint", "?"))
        for p in pulls.values() if p is not None
    }
    drift = "" if len(prints) <= 1 else \
        "  CONFIG DRIFT: %d distinct fingerprints" % len(prints)
    lines.append(f"fleet telemetry — {up}/{len(pulls)} replicas up{drift}")
    lines.append(
        f"{'replica':<22}{'id':<14}{'up':>7}{'reqs':>9}{'errs':>7}"
        f"{'p99':>9}{'breach':>8}  fingerprint"
    )
    for addr in sorted(pulls):
        p = pulls[addr]
        if p is None:
            lines.append(
                f"{addr:<22}{'-':<14}{'-':>7}{'-':>9}{'-':>7}{'-':>9}"
                f"{'-':>8}  DOWN"
            )
            continue
        snap = p.get("metrics") or {}
        reqs = errs = 0.0
        for s in (snap.get(REQ) or {}).get("samples", []):
            v = float(s.get("value", 0.0))
            reqs += v
            if s["labels"].get("outcome") in ("error", "transport"):
                errs += v
        buckets: Dict[str, float] = {}
        for s in (snap.get(LAT) or {}).get("samples", []):
            for le, n in (s.get("buckets") or {}).items():
                buckets[le] = buckets.get(le, 0.0) + float(n)
        breaches = sum(
            1 for s in (snap.get(SLO_BREACH) or {}).get("samples", [])
            if float(s.get("value", 0.0)) >= 1.0
        )
        lines.append(
            f"{addr:<22}{str(p.get('id', '?')):<14}"
            f"{float(p.get('uptime_s', 0.0)):>6.0f}s"
            f"{int(reqs):>9}{int(errs):>7}"
            f"{_fmt_secs(quantile_from_buckets(buckets, 0.99)):>9}"
            f"{breaches:>8}  {p.get('fingerprint', '?')}"
        )
    return "\n".join(lines)


def render_fleet(healths: Dict[str, Optional[Dict[str, Any]]]) -> str:
    """The fleet panel: one line per replica from its ``health``
    response (None = unreachable → DOWN). Pure function — the unit under
    test; ``main`` feeds it live polls when given a comma-separated
    address list."""
    lines: List[str] = []
    up = sum(1 for h in healths.values() if h is not None)
    lines.append(f"fleet — {up}/{len(healths)} replicas up")
    lines.append(
        f"{'replica':<22}{'id':<14}{'boot':<14}{'up':>7}{'conns':>7}"
        f"{'models':>8}{'queued':>8}{'state':>8}"
    )
    for addr in sorted(healths):
        h = healths[addr]
        if h is None:
            lines.append(f"{addr:<22}{'-':<14}{'-':<14}{'-':>7}{'-':>7}"
                         f"{'-':>8}{'-':>8}{'DOWN':>8}")
            continue
        sched = h.get("scheduler") or {}
        state = "BUSY" if h.get("busy") else "ok"
        lines.append(
            f"{addr:<22}{str(h.get('id', '?')):<14}"
            f"{str(h.get('boot_id', '?')):<14}"
            f"{float(h.get('uptime_s', 0.0)):>6.0f}s"
            f"{int(h.get('queue_depth', 0)):>7}"
            f"{int(h.get('served_models', 0)):>8}"
            f"{int(sched.get('queued', 0) or 0):>8}"
            f"{state:>8}"
        )
    return "\n".join(lines)


def render_fleet_view(
    view: Dict[str, Any],
    healths: Optional[Dict[str, Optional[Dict[str, Any]]]] = None,
) -> str:
    """The GOSSIPED fleet panel (``--fleet``): rendered from ONE seed
    daemon's FleetView wire dict (``gossip_pull``) — per-replica
    liveness records and the per-model version table with any live
    rollout intent — optionally joined with live ``health`` polls
    (``healths``: addr → health dict or None). Pure function — the
    unit under test; ``main`` feeds it live pulls."""
    healths = healths or {}
    lines: List[str] = []
    reps = (view or {}).get("replicas") or {}
    models = (view or {}).get("models") or {}
    counts: Dict[str, int] = {}
    for r in reps.values():
        lv = str(r.get("liveness", "?"))
        counts[lv] = counts.get(lv, 0) + 1
    tally = "  ".join(f"{k}:{n}" for k, n in sorted(counts.items()))
    lines.append(
        f"fleet (gossiped) — view epoch {int((view or {}).get('epoch', 0))}"
        f"  replicas {tally or '-'}"
    )
    lines.append(
        f"{'replica':<16}{'addr':<22}{'boot':<14}{'liveness':>10}"
        f"{'epoch':>7}{'health':>8}"
    )
    for sid in sorted(reps):
        r = reps[sid]
        h = healths.get(str(r.get("addr") or ""))
        if r.get("liveness") == "tombstone":
            state = "-"
        elif h is None:
            state = "DOWN" if str(r.get("addr") or "") in healths else "?"
        else:
            state = "BUSY" if h.get("busy") else "ok"
        lines.append(
            f"{str(sid):<16}{str(r.get('addr') or '-'):<22}"
            f"{str(r.get('boot_id') or '-'):<14}"
            f"{str(r.get('liveness', '?')):>10}"
            f"{int(r.get('epoch', 0)):>7}{state:>8}"
        )
    if models:
        lines.append("")
        lines.append(
            f"{'model':<16}{'active':>8}{'fleet ep':>10}{'tombs':>12}"
            f"  intent"
        )
        for name in sorted(models):
            m = models[name]
            av = m.get("active_version")
            tombs = ",".join(
                f"v{v}" for v in sorted(
                    (m.get("tombstones") or {}), key=int
                )
            )
            intent = m.get("intent")
            if intent:
                itxt = (
                    f"{intent.get('phase', '?')} "
                    f"v{intent.get('from_version')}→"
                    f"v{intent.get('to_version')} by "
                    f"{intent.get('by', '?')}"
                )
            else:
                itxt = "-"
            lines.append(
                f"{name:<16}{('v%d' % av) if av is not None else '-':>8}"
                f"{int(m.get('fleet_epoch', 0)):>10}{(tombs or '-'):>12}"
                f"  {itxt}"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_ml_tpu_torch.tools.top",
        description="Live telemetry for a data-plane daemon "
        "(health + metrics wire ops).",
    )
    ap.add_argument(
        "address", nargs="?", default=os.environ.get("SRML_DAEMON_ADDRESS"),
        help="daemon host:port (default: $SRML_DAEMON_ADDRESS)",
    )
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls (default 2)")
    ap.add_argument("--count", type=int, default=0,
                    help="number of polls, 0 = until interrupted")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no screen redraw)")
    ap.add_argument("--token", default=os.environ.get("SRML_DAEMON_TOKEN"),
                    help="shared-secret daemon token (default: "
                    "$SRML_DAEMON_TOKEN)")
    ap.add_argument("--fleet", action="store_true",
                    help="render the GOSSIPED fleet panel from ONE seed "
                    "address: pull the seed's FleetView (gossip_pull) "
                    "and show every replica and model the fleet knows — "
                    "no roster needed")
    ap.add_argument("--telemetry", action="store_true",
                    help="with --fleet: render the fleet METRICS panel "
                    "instead of health — one telemetry_pull per "
                    "up-replica from the gossiped view (request/error "
                    "totals, p99, SLO breaches, config fingerprint "
                    "drift)")
    args = ap.parse_args(argv)
    if not args.address:
        ap.error("no daemon address: pass host:port or set $SRML_DAEMON_ADDRESS")

    from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
    from spark_rapids_ml_tpu_torch.spark.daemon_session import _parse_addr

    if args.fleet:
        # Gossiped-fleet mode: ONE seed is enough — the view names every
        # replica; health is polled per up-replica from the view, and if
        # the seed itself dies, the next pull fails over to any replica
        # the last view listed (the same resilience a FleetClient has).
        seeds = [a.strip() for a in args.address.split(",") if a.strip()]
        last_view: Dict[str, Any] = {}
        polls = 0
        while True:
            view: Dict[str, Any] = {}
            candidates = list(seeds) + sorted(
                r["addr"] for r in (last_view.get("replicas") or {}).values()
                if r.get("liveness") == "up" and r.get("addr")
                and r["addr"] not in seeds
            )
            for a in candidates:
                try:
                    with DataPlaneClient(
                        *_parse_addr(a), token=args.token,
                        timeout=5.0, max_op_attempts=1,
                    ) as c:
                        view = c.gossip_pull()
                    break
                except Exception:
                    continue
            last_view = view or last_view
            healths: Dict[str, Optional[Dict[str, Any]]] = {}
            for r in (view.get("replicas") or {}).values():
                if r.get("liveness") != "up" or not r.get("addr"):
                    continue
                try:
                    with DataPlaneClient(
                        *_parse_addr(r["addr"]), token=args.token,
                        timeout=5.0, max_op_attempts=1,
                    ) as c:
                        healths[r["addr"]] = (
                            c.telemetry_pull() if args.telemetry
                            else c.health()
                        )
                except Exception:
                    healths[r["addr"]] = None
            body = (
                render_fleet_telemetry(healths) if args.telemetry
                else render_fleet_view(view, healths)
            )
            if args.once or args.count:
                print(body)
                print()
            else:
                print("\x1b[2J\x1b[H" + body, flush=True)
            polls += 1
            if args.once or (args.count and polls >= args.count):
                return 0
            time.sleep(args.interval)

    if "," in args.address:
        # Fleet mode: one health poll per replica per tick, rendered as
        # the per-replica panel. An unreachable replica reports DOWN.
        addrs = [a.strip() for a in args.address.split(",") if a.strip()]
        clients = {
            a: DataPlaneClient(*_parse_addr(a), token=args.token,
                               timeout=5.0, max_op_attempts=1)
            for a in addrs
        }
        polls = 0
        try:
            while True:
                healths: Dict[str, Optional[Dict[str, Any]]] = {}
                for a, c in clients.items():
                    try:
                        healths[a] = c.health()
                    except Exception:
                        healths[a] = None
                body = render_fleet(healths)
                if args.once or args.count:
                    print(body)
                    print()
                else:
                    print("\x1b[2J\x1b[H" + body, flush=True)
                polls += 1
                if args.once or (args.count and polls >= args.count):
                    return 0
                time.sleep(args.interval)
        finally:
            for c in clients.values():
                c.close()

    host, port = _parse_addr(args.address)
    prev_snap: Optional[Dict[str, Any]] = None
    prev_t: Optional[float] = None
    polls = 0
    with DataPlaneClient(host, port, token=args.token) as client:
        while True:
            health = client.health()
            snap = client.metrics()
            now = time.monotonic()
            dt = None if prev_t is None else now - prev_t
            body = render(health, snap, prev_snap, dt)
            if args.once or args.count:
                print(body)
                print()
            else:
                # In-place redraw: clear + home, like top(1).
                print("\x1b[2J\x1b[H" + body, flush=True)
            polls += 1
            if args.once or (args.count and polls >= args.count):
                return 0
            prev_snap, prev_t = snap, now
            time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
