"""Stitch run-journal files into one distributed trace.

The port's copy of ``spark_rapids_ml_tpu/tools/trace.py``, reading the
port's journals (``utils/journal.py``), incident bundles
(``utils/flight.py``) and daemons.

One fit writes journal lines from several processes: the driver's
``journal.run`` + phase spans, each executor task's client ops, and every
daemon's ``daemon.<op>`` spans — all carrying the same ``run_id`` because
the client stamps its frame as an additive ``trace_ctx`` on every wire op
and the daemon adopts it (docs/protocol.md). This tool merges one or more
journal files (processes may share a file via O_APPEND, or write their
own) and emits:

* **Chrome-trace JSON** (``--out trace.json``): complete ``X`` events on
  (pid, tid) tracks — loads in ``chrome://tracing`` or Perfetto
  (https://ui.perfetto.dev).
* **a text flame summary** (default to stdout): the span tree aggregated
  by name-path, with total seconds, call counts, and the share of the
  root — ``why is fit flat`` as a terminal one-liner.

Usage::

    python -m spark_rapids_ml_tpu_torch.tools.trace journal.jsonl [more.jsonl ...] \
        [--out trace.json] [--run RUN_ID] [--flame]
    python -m spark_rapids_ml_tpu_torch.tools.trace --fleet HOST:PORT [--flame]

Three kinds of source, freely mixable:

* **journal files** — rotated segments (``journal.jsonl.1`` …) are
  folded in transparently (utils/journal.py ``segments``);
* **incident bundles** — a flight-recorder dump
  (``state_dir/incidents/incident-*.json``, utils/flight.py) loads as a
  trace source through its ``events`` list, so a daemon that died five
  minutes ago stitches into the tree like a live one;
* **the fleet itself** — ``--fleet HOST:PORT`` needs ONE gossip seed
  and ZERO filesystem access: it pulls the seed's FleetView
  (``gossip_pull``), then drains every live replica's in-memory span
  ring over the wire (``trace_pull``), and stitches the union.

Merged events sort by ``(ts, pid, seq)`` — the per-process monotonic
``seq`` breaks wall-clock ties, so the merge order is stable no matter
how many processes share a timestamp. Spans whose ``parent_id`` is not
in the merged set (a daemon span whose parent lives in a journal file
you did not pass) root at their run — the tree degrades, it never drops
events.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Iterable, List, Optional

from spark_rapids_ml_tpu_torch.utils import flight, journal

#: Events that appear in the trace: phases and run_ends carry durations;
#: marks become instants. run_start is the run_end's open bracket — it
#: carries no duration, so it is used only to name the run.
_SPAN_EVENTS = ("phase", "run_end")


def _sort_key(e: Dict[str, Any]):
    """Stable merge order: wall clock, then pid, then the per-process
    monotonic ``seq`` — two events stamped in the same clock tick by the
    same process keep their emission order."""
    return (
        float(e.get("ts", 0.0)),
        int(e.get("pid", 0)),
        int(e.get("seq", 0)),
    )


def _load_source(path: str) -> List[Dict[str, Any]]:
    """One source file → its events: an incident bundle (a single JSON
    object with ``kind: srml_incident_bundle``) contributes its
    ``events`` list; anything else is read as a journal file, rotated
    segments included."""
    try:
        bundle = flight.load_bundle(path)
    except (ValueError, OSError):
        return journal.read(str(path))
    events = bundle.get("events")
    return [e for e in events if isinstance(e, dict)] \
        if isinstance(events, list) else []


def load(paths: Iterable[str]) -> List[Dict[str, Any]]:
    """Merge journal files and/or incident bundles into one event list,
    sorted by ``(ts, pid, seq)``."""
    events: List[Dict[str, Any]] = []
    for p in paths:
        events.extend(_load_source(str(p)))
    events.sort(key=_sort_key)
    return events


def fleet_load(
    seed: str,
    token: Optional[str] = None,
    timeout: float = 5.0,
) -> List[Dict[str, Any]]:
    """Drain the whole fleet's span rings from ONE gossip seed — zero
    filesystem access. ``gossip_pull`` on the seed names every replica;
    each up-replica answers ``trace_pull`` with its in-memory journal
    ring. A replica that dies mid-drain is skipped (its spans may still
    arrive via the others' rings or an incident bundle); duplicate
    addresses collapse by server id."""
    from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
    from spark_rapids_ml_tpu_torch.spark.daemon_session import _parse_addr

    with DataPlaneClient(
        *_parse_addr(seed), token=token, timeout=timeout, max_op_attempts=1,
    ) as c:
        view = c.gossip_pull()
    addrs: Dict[str, str] = {}  # server_id → addr (view wins over seed)
    for sid, rec in (view.get("replicas") or {}).items():
        if rec.get("liveness") == "up" and rec.get("addr"):
            addrs[str(sid)] = str(rec["addr"])
    if not addrs:  # pre-gossip daemon: the seed is the whole "fleet"
        addrs[""] = seed
    events: List[Dict[str, Any]] = []
    for sid in sorted(addrs):
        try:
            with DataPlaneClient(
                *_parse_addr(addrs[sid]), token=token,
                timeout=timeout, max_op_attempts=1,
            ) as c:
                pulled = c.trace_pull()
        except Exception as e:
            print(f"trace: replica {addrs[sid]} unreachable: {e}",
                  file=sys.stderr)
            continue
        evs = pulled.get("events")
        if isinstance(evs, list):
            events.extend(ev for ev in evs if isinstance(ev, dict))
    events.sort(key=_sort_key)
    return events


def runs(events: List[Dict[str, Any]]) -> Dict[str, str]:
    """run_id → run name for every run that appears in the events.
    Runs seen only through adopted spans (their run_start/run_end lives
    in a journal file not passed) list as ``?``."""
    out: Dict[str, str] = {}
    for e in events:
        rid = e.get("run_id")
        if not rid:
            continue
        if e.get("event") in ("run_start", "run_end"):
            out[rid] = str(e.get("name", "?"))
        else:
            out.setdefault(rid, "?")
    return out


def _filter_run(
    events: List[Dict[str, Any]], run_id: Optional[str]
) -> List[Dict[str, Any]]:
    if run_id is None:
        return events
    return [e for e in events if e.get("run_id") == run_id]


def chrome_trace(
    events: List[Dict[str, Any]], run_id: Optional[str] = None
) -> Dict[str, Any]:
    """Merged events → a Chrome-trace/Perfetto JSON object.

    ``X`` (complete) events for phases and runs, ``i`` (instant) events
    for marks; ``ts``/``dur`` in microseconds as the format requires;
    tracks are the journal's (pid, tid). Extra journal fields ride in
    ``args`` so nothing recorded is lost in the conversion."""
    events = _filter_run(events, run_id)
    out: List[Dict[str, Any]] = []
    seen_tracks = set()
    for e in events:
        ev = e.get("event")
        base = {
            "name": str(e.get("name", "?")),
            "pid": int(e.get("pid", 0)),
            "tid": int(e.get("tid", e.get("pid", 0))),
            "ts": float(e.get("ts", 0.0)) * 1e6,
            "cat": ev or "?",
            "args": {
                k: v for k, v in e.items()
                if k not in ("ts", "pid", "tid", "event", "name")
            },
        }
        seen_tracks.add((base["pid"], base["tid"]))
        if ev in _SPAN_EVENTS:
            out.append({
                **base, "ph": "X",
                "dur": float(e.get("duration_s", 0.0)) * 1e6,
            })
        elif ev == "mark":
            out.append({**base, "ph": "i", "s": "t"})
        # run_start: subsumed by its run_end X event.
    for pid, tid in sorted(seen_tracks):
        out.append({
            "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": f"pid {pid} / tid {tid}"},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


class Node:
    """One span in the stitched tree (spans only — marks are leaves of
    convenience, they carry no duration)."""

    __slots__ = ("event", "children")

    def __init__(self, event: Dict[str, Any]):
        self.event = event
        self.children: List["Node"] = []

    @property
    def span_id(self) -> Optional[str]:
        return self.event.get("span_id")

    @property
    def name(self) -> str:
        return str(self.event.get("name", "?"))

    @property
    def duration_s(self) -> float:
        return float(self.event.get("duration_s", 0.0))


def tree(
    events: List[Dict[str, Any]], run_id: Optional[str] = None
) -> List[Node]:
    """Stitch spans into parent→children trees; returns the roots.

    A span parents to the node owning its ``parent_id`` — REGARDLESS of
    which process/file it came from; that is the whole point of the
    trace_ctx stamp. Orphans (parent span not in the merged set) become
    roots rather than vanishing."""
    events = _filter_run(events, run_id)
    nodes = [Node(e) for e in events if e.get("event") in _SPAN_EVENTS]
    by_span: Dict[str, Node] = {}
    for n in nodes:
        sid = n.span_id
        if sid:
            # A replayed op can journal the same span name twice; last
            # write wins for identity, both still render as children.
            by_span.setdefault(sid, n)
    roots: List[Node] = []
    for n in nodes:
        parent = n.event.get("parent_id")
        p = by_span.get(parent) if parent else None
        if p is not None and p is not n:
            p.children.append(n)
        else:
            roots.append(n)
    for n in nodes:
        n.children.sort(key=lambda c: _sort_key(c.event))
    roots.sort(key=lambda r: _sort_key(r.event))
    return roots


def flame(
    events: List[Dict[str, Any]], run_id: Optional[str] = None
) -> str:
    """Text flame summary: the span tree aggregated by name-path.

    Sibling spans with the same name fold into one line (count ×, total
    seconds, % of their root) — 384 identical feed passes read as one
    line, not 384. Multi-process paths show ``pid@`` so a daemon-side
    span is visibly remote."""
    roots = tree(events, run_id)
    lines: List[str] = []

    def total(node: Node) -> float:
        return node.duration_s

    def walk(nodes: List[Node], depth: int, root_s: float) -> None:
        groups: Dict[str, List[Node]] = {}
        for n in nodes:
            groups.setdefault(n.name, []).append(n)
        ordered = sorted(
            groups.items(), key=lambda kv: -sum(total(n) for n in kv[1])
        )
        for name, group in ordered:
            secs = sum(total(n) for n in group)
            pids = sorted({int(n.event.get("pid", 0)) for n in group})
            where = f" [pid {','.join(str(p) for p in pids)}]" if depth else ""
            pct = f" {100 * secs / root_s:5.1f}%" if root_s > 0 else ""
            count = f" x{len(group)}" if len(group) > 1 else ""
            lines.append(
                f"{'  ' * depth}{name:<{max(1, 36 - 2 * depth)}}"
                f" {secs:9.3f}s{pct}{count}{where}"
            )
            children = [c for n in group for c in n.children]
            if children:
                walk(children, depth + 1, root_s)

    for root in roots:
        root_s = total(root) or sum(c.duration_s for c in root.children)
        walk([root], 0, root_s)
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_ml_tpu_torch.tools.trace",
        description="Merge run-journal files into a Chrome trace and/or "
        "a text flame summary.",
    )
    ap.add_argument(
        "journals", nargs="*",
        help="journal .jsonl file(s) and/or incident bundle .json file(s)",
    )
    ap.add_argument(
        "--fleet", metavar="HOST:PORT",
        help="pull the whole fleet's spans over the wire from ONE gossip "
        "seed (gossip_pull + trace_pull per replica) — no files needed; "
        "mixes with file sources",
    )
    ap.add_argument(
        "--token", default=os.environ.get("SRML_DAEMON_TOKEN"),
        help="shared-secret daemon token for --fleet (default: "
        "$SRML_DAEMON_TOKEN)",
    )
    ap.add_argument("--out", "-o", help="write Chrome-trace JSON here")
    ap.add_argument("--run", help="restrict to one run_id")
    ap.add_argument(
        "--flame", action="store_true",
        help="print the flame summary (default when --out is not given)",
    )
    ap.add_argument(
        "--list-runs", action="store_true",
        help="print run_id → name and exit",
    )
    args = ap.parse_args(argv)
    if not args.journals and not args.fleet:
        ap.error("no sources: pass journal/bundle files and/or --fleet")

    events = load(args.journals)
    if args.fleet:
        events.extend(fleet_load(args.fleet, token=args.token))
        events.sort(key=_sort_key)
    if not events:
        print("no journal events found", file=sys.stderr)
        return 1
    if args.list_runs:
        for rid, name in sorted(runs(events).items()):
            n = sum(1 for e in events if e.get("run_id") == rid)
            print(f"{rid}  {name}  ({n} events)")
        return 0
    if args.out:
        obj = chrome_trace(events, args.run)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(obj, f)
        print(
            f"wrote {len(obj['traceEvents'])} trace events to {args.out} "
            "(load in chrome://tracing or https://ui.perfetto.dev)"
        )
    if args.flame or not args.out:
        print(flame(events, args.run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
