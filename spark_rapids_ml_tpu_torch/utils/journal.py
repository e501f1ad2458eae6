"""Structured run journal: one JSON line per run, phase or mark event.

The port's copy of ``spark_rapids_ml_tpu/utils/journal.py``: the same
line schema, functions and ring, so one tool reads the journals of both
packages and one fit's lines from a driver of either package stitch with
daemons of the other. Where ``utils/metrics.py`` answers "how is the
system doing in aggregate", the journal answers "what did THIS fit do":
every ``trace_span`` phase (the fold, the eigensolve, a Lloyd pass, a
daemon op) becomes one line carrying ``run_id`` / ``span_id`` /
``parent_id``.

Activation: env ``SRML_TORCH_RUN_JOURNAL=/path/to/journal.jsonl`` (the
port's prefix: a process that imports both packages must not arm both
journals from one variable), or ``config.set("run_journal", path)``.
Unset, and with the ring unarmed, every hook is one config read and an
early return: no event dict, no JSON encoding, no I/O.

Line schema (all events)::

    {"ts": <unix seconds, event START>, "pid": int, "tid": int,
     "event": "run_start" | "run_end" | "phase" | "mark",
     "run_id": hex, "span_id": hex, "parent_id": hex | null,
     "name": str, "seq": int, ...}

``tid`` is the OS thread id (the Chrome-trace track). ``run_end`` and
``phase`` also carry ``duration_s``. Extra keyword fields pass through
verbatim (estimator class, algo, job name). Nesting is per thread: spans
opened inside a ``run()`` (or another span) parent to it; a span on a
thread with no open frame roots itself (a fresh ``run_id``, ``parent_id``
null). ``adopt`` parents a thread's spans under a frame that arrived over
the wire or in a task closure (``trace_ctx``). Lines are written whole,
append-mode, under a lock, so threads, and processes sharing one file,
interleave lines, never halves. ``seq`` is a per-process monotonic
sequence number: merge tools order same-timestamp events by
``(ts, pid, seq)``.

The in-memory ring: ``ring_arm(cap)`` keeps the last ``cap`` events of
every hook, with or without a file (the daemon arms it for ``trace_pull``
and the flight recorder); ``tail(since_seq)`` reads it cursor-style.
Arming is refcounted (several daemons in one process share the ring).

Rotation: ``run_journal_max_bytes`` > 0 rotates the file logrotate-style
(``path`` -> ``path.1`` -> ... -> ``path.K``, ``run_journal_keep``
segments kept) before a line would cross the cap; ``read()`` concatenates
the segments oldest first. Rotation is single-writer: processes that
share a path leave the cap at 0.

A write failure (a bad path, a full disk) logs one warning and disables
the journal for the process: telemetry never takes a fit down. ``close()``
re-arms it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "enabled", "active", "run", "span", "mark", "read", "close", "adopt",
    "trace_ctx", "ring_arm", "ring_disarm", "tail", "last_seq", "segments",
]

_lock = threading.Lock()
_files: Dict[str, Any] = {}  # path -> [open append handle, bytes written]
_tls = threading.local()
#: Latched True after a write failure (bad path, disk full, read-only
#: FS): telemetry must NEVER take the workload down — the journal logs
#: one warning, disables itself for the process, and every fit keeps
#: running. close() re-arms (a fresh path can be configured after).
_broken = False
#: Per-process monotonic event sequence (under ``_lock``): the merge
#: tiebreaker for same-``ts`` events and the ``trace_pull`` cursor.
_seq = 0
#: Bounded in-memory event buffer; captures only while ``_ring_arms`` > 0.
_ring: Deque[Dict[str, Any]] = deque()
_ring_arms = 0
_ring_cap = 0


def _path() -> Optional[str]:
    if _broken:
        return None
    from spark_rapids_ml_tpu_torch import config

    p = config.peek("run_journal")
    return str(p) if p else None


def enabled() -> bool:
    """True when a journal path is configured for this process."""
    return _path() is not None


def active() -> bool:
    """True when ANY sink would record an event: a journal file is
    configured or the in-memory ring is armed."""
    return _path() is not None or _ring_on()


def ring_arm(cap: int) -> None:
    """Enable the in-memory event ring (≤ ``cap`` most-recent events).
    Refcounted: each ``ring_arm`` needs a matching ``ring_disarm``; the
    largest requested cap wins while any holder is armed."""
    global _ring_arms, _ring_cap
    cap = int(cap)
    with _lock:
        _ring_arms += 1
        _ring_cap = max(_ring_cap, cap)
        while len(_ring) > _ring_cap:
            _ring.popleft()


def ring_disarm() -> None:
    """Drop one arm; the ring empties when the last holder disarms."""
    global _ring_arms, _ring_cap
    with _lock:
        _ring_arms = max(0, _ring_arms - 1)
        if _ring_arms == 0:
            _ring.clear()
            _ring_cap = 0


def _ring_on() -> bool:
    return _ring_arms > 0 and _ring_cap > 0


def tail(since_seq: int = 0) -> Tuple[List[Dict[str, Any]], int]:
    """(events with ``seq`` > ``since_seq`` still in the ring, current
    last seq). The ``trace_pull`` primitive: a caller holding the
    returned seq as its cursor streams without duplication; events that
    aged out of the bounded ring before a pull are simply gone."""
    with _lock:
        events = [dict(e) for e in _ring if e.get("seq", 0) > since_seq]
        return events, _seq


def last_seq() -> int:
    """Current per-process sequence number (0 before any event)."""
    with _lock:
        return _seq


def _stack() -> List[Tuple[str, str]]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> Tuple[Optional[str], Optional[str]]:
    """(run_id, span_id) of this thread's innermost open frame."""
    s = _stack()
    return s[-1] if s else (None, None)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def _rotation() -> Tuple[int, int]:
    from spark_rapids_ml_tpu_torch import config

    return (
        int(config.peek("run_journal_max_bytes") or 0),
        max(1, int(config.peek("run_journal_keep") or 1)),
    )


def _rotate_locked(path: str) -> None:
    """Shift ``path`` → ``path.1`` → … under ``_lock`` (handle already
    closed by the caller). Best-effort: a missing segment is fine."""
    _, keep = _rotation()
    for i in range(keep, 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        dst = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, dst)
    extra = f"{path}.{keep + 1}"
    if os.path.exists(extra):  # keep shrank between rotations
        os.remove(extra)


def _write(path: str, line: str) -> None:
    global _broken
    try:
        with _lock:
            entry = _files.get(path)
            if entry is None:
                f = open(path, "a", encoding="utf-8")
                entry = _files[path] = [f, f.tell()]
            max_bytes, _ = _rotation()
            nbytes = len(line.encode("utf-8"))
            if max_bytes > 0 and entry[1] + nbytes > max_bytes and entry[1] > 0:
                entry[0].close()
                del _files[path]
                _rotate_locked(path)
                f = open(path, "a", encoding="utf-8")
                entry = _files[path] = [f, f.tell()]
            entry[0].write(line)
            entry[0].flush()
            entry[1] += nbytes
    except (OSError, ValueError) as e:  # ValueError: write on closed file
        # Emitted from finally blocks (span/run exits): raising here would
        # MASK the workload's own in-flight exception — and an unwritable
        # journal path must not fail fits. Warn once, self-disable.
        _broken = True
        from spark_rapids_ml_tpu_torch.utils.logging import get_logger

        get_logger("utils.journal").warning(
            "run journal disabled: cannot write %s (%s)", path, e
        )


def _active() -> Tuple[Optional[str], bool]:
    """(journal path or None, ring armed?) — an event is emitted when
    either sink is on; neither on is the zero-allocation early return."""
    return _path(), _ring_on()


def _event(
    path: Optional[str],
    event: str,
    name: str,
    run_id: str,
    span_id: str,
    parent_id: Optional[str],
    ts: float,
    fields: Dict[str, Any],
    duration_s: Optional[float] = None,
) -> None:
    global _seq
    obj: Dict[str, Any] = {
        "ts": ts,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "event": event,
        "run_id": run_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "name": name,
    }
    if duration_s is not None:
        obj["duration_s"] = duration_s
    obj.update(fields)
    with _lock:
        _seq += 1
        obj["seq"] = _seq
        if _ring_on():
            _ring.append(obj)
            while len(_ring) > _ring_cap:
                _ring.popleft()
    if path is not None:
        _write(path, json.dumps(obj, separators=(",", ":"), default=str) + "\n")


@contextlib.contextmanager
def run(name: str, **fields: Any) -> Iterator[Optional[str]]:
    """Open a named run (one estimator fit, one bench iteration): emits
    ``run_start`` now and ``run_end`` (with ``duration_s``) on exit;
    spans on this thread inside the block parent to it. Yields the
    run_id (None when the journal is off)."""
    path, ring = _active()
    if path is None and not ring:
        yield None
        return
    run_id = _new_id()
    span_id = _new_id()
    _, parent = current()
    ts = time.time()
    t0 = time.perf_counter()
    _event(path, "run_start", name, run_id, span_id, parent, ts, fields)
    stack = _stack()
    stack.append((run_id, span_id))
    try:
        yield run_id
    finally:
        stack.pop()
        _event(
            path, "run_end", name, run_id, span_id, parent, ts, fields,
            duration_s=time.perf_counter() - t0,
        )


@contextlib.contextmanager
def span(name: str, **fields: Any) -> Iterator[Optional[str]]:
    """One phase: emits a single ``phase`` line on exit (ts = phase
    start). ``trace_span`` routes here, so every instrumented phase in
    the package journals for free when the journal is on."""
    path, ring = _active()
    if path is None and not ring:
        yield None
        return
    stack = _stack()
    if stack:
        run_id, parent = stack[-1]
    else:
        run_id, parent = _new_id(), None
    span_id = _new_id()
    ts = time.time()
    t0 = time.perf_counter()
    stack.append((run_id, span_id))
    try:
        yield span_id
    finally:
        stack.pop()
        _event(
            path, "phase", name, run_id, span_id, parent, ts, fields,
            duration_s=time.perf_counter() - t0,
        )


def trace_ctx() -> Optional[Dict[str, str]]:
    """This thread's innermost open frame as an over-the-wire context:
    ``{"run": run_id, "span": span_id}``, or None outside any run/span.
    The data-plane client stamps it on every request (additive
    ``trace_ctx`` field, docs/protocol.md) and the estimator captures it
    into executor-side task closures — how one fit's journal lines from
    driver, executors, and N daemons stitch into a single tree
    (``tools/trace.py``)."""
    run_id, span_id = current()
    if run_id is None:
        return None
    return {"run": run_id, "span": span_id}


@contextlib.contextmanager
def adopt(
    run_id: Optional[str], span_id: Optional[str] = None
) -> Iterator[None]:
    """Parent this thread's subsequent spans under a FOREIGN frame — a
    ``trace_ctx`` that arrived over the wire (daemon side) or through a
    task closure (executor side). Emits no event itself; spans opened
    inside the block carry the adopted ``run_id`` and parent to
    ``span_id``. No-op when ``run_id`` is falsy, so callers can pass a
    request's (possibly absent) context straight through."""
    if not run_id:
        yield
        return
    stack = _stack()
    stack.append((str(run_id), str(span_id) if span_id else None))
    try:
        yield
    finally:
        stack.pop()


def mark(name: str, **fields: Any) -> None:
    """One-shot event (no duration) under the current run, if any."""
    path, ring = _active()
    if path is None and not ring:
        return
    run_id, parent = current()
    _event(
        path, "mark", name, run_id or _new_id(), _new_id(), parent,
        time.time(), fields,
    )


def segments(path: str) -> List[str]:
    """Existing on-disk segments of a journal, OLDEST first:
    ``path.K … path.2 path.1 path`` (rotation shifts upward, so higher
    suffixes are older). The live file is last even when absent peers
    leave suffix gaps."""
    out: List[str] = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    out.reverse()
    if os.path.exists(path) or not out:
        out.append(path)
    return out


def read(path: str) -> List[Dict[str, Any]]:
    """Parse a journal file back into event dicts (tools and tests),
    transparently concatenating rotated segments oldest-first. Blank
    lines are skipped; a torn final line (killed process) raises — the
    journal's whole-line write discipline makes that a real error."""
    out: List[Dict[str, Any]] = []
    for seg in segments(path):
        with open(seg, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def close() -> None:
    """Flush and close every open journal handle (tests; idempotent —
    the next event reopens append-mode). Also re-arms a journal that
    self-disabled after a write failure."""
    global _broken
    with _lock:
        files = [entry[0] for entry in _files.values()]
        _files.clear()
        _broken = False
    for f in files:
        try:
            f.close()
        except OSError:
            pass
