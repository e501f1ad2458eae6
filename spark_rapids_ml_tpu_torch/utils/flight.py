"""Flight recorder: triggered incident bundles from in-memory context.

The port's copy of ``spark_rapids_ml_tpu/utils/flight.py``: the same
bundle kind and version, so a port bundle loads in either package's
``load_bundle`` and reads in the JAX ``tools/trace.py`` as a trace source.
An incident (a deadline-breach storm, a shed cascade, an injected fault, a
dying process) is the moment pull-based telemetry fails: by the time
someone scrapes, the storm is over. Each daemon holds a bounded ring of
recent journal events (utils/journal.py ``ring_arm``) and a rolling per-op
metrics delta; a **trigger** dumps them as one JSON bundle under
``state_dir/incidents/``::

    incident-<unix_ms>-<reason>.json
    { "kind": "srml_incident_bundle", "v": 1,
      "reason": ..., "detail": ..., "ts": ..., "pid": ...,
      "identity": {...daemon id / boot_id / address...},
      "fingerprint": "<config fingerprint>",
      "events":  [ ...journal ring, newest last... ],   "seq": <last seq>,
      "metrics": { ...registry snapshot, with exemplars... },
      "op_deltas": { op: {total, err, shed} over the recorder window },
      "xprof":   { ...the kernel ledger's snapshot... },
      "gossip":  null }

Without a ``state_dir`` nothing is written (``trigger`` returns None), as
in the reference. Triggers are debounced per reason
(``incident_min_interval_s``), the directory is capped
(``incident_max_bundles``, oldest deleted), writes are tmp-file + rename
atomic, and every failure is swallowed after one log line: the recorder
never takes the daemon down. The daemon's telemetry thread drives the
automatic triggers (SLO breach, shed storm, deadline-breach rate); fired
fault sites arrive through ``faults.subscribe``; other layers call
:func:`record` on the process-default recorder.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.utils.logging import get_logger

__all__ = ["FlightRecorder", "set_default", "record", "load_bundle"]

logger = get_logger("utils.flight")

BUNDLE_KIND = "srml_incident_bundle"


class FlightRecorder:
    """One per daemon process (or any process worth black-boxing).

    ``providers`` maps bundle field names to zero-arg callables
    returning JSON-able values — the daemon wires ``identity`` to its
    id/boot_id/address and ``gossip`` to None (the port has no fleet view
    yet); a provider that raises contributes ``null``.
    """

    def __init__(
        self,
        state_dir: Optional[str] = None,
        providers: Optional[Dict[str, Callable[[], Any]]] = None,
    ):
        self.state_dir = str(state_dir) if state_dir else None
        self.providers = dict(providers or {})
        self._lock = threading.Lock()
        self._last_by_reason: Dict[str, float] = {}
        #: Rolling per-op stats baseline (ts, {op: {total, err, shed}}):
        #: refreshed by observe(); bundles report deltas against it.
        self._baseline: Optional[Tuple[float, Dict[str, Any]]] = None
        self._fatal_armed = False

    # -- rolling metrics delta ---------------------------------------

    def observe(self, snap: Dict[str, Any], now: Optional[float] = None
                ) -> Dict[str, Dict[str, float]]:
        """Feed one metrics snapshot (the telemetry tick). Returns the
        per-op deltas since the previous observe — the same numbers the
        daemon's automatic triggers rate-check — and rolls the baseline
        forward."""
        from spark_rapids_ml_tpu_torch.utils.slo import _op_stats

        if now is None:
            now = time.time()
        stats = _op_stats(snap)
        deltas: Dict[str, Dict[str, float]] = {}
        with self._lock:
            prev = self._baseline[1] if self._baseline else {}
            for op, cur in stats.items():
                old = prev.get(op, {})
                deltas[op] = {
                    "total": cur["total"] - float(old.get("total", 0.0)),
                    "err": cur["err"] - float(old.get("err", 0.0)),
                    "shed": cur["shed"] - float(old.get("shed", 0.0)),
                }
            self._baseline = (
                now,
                {op: {k: v for k, v in cur.items() if k != "buckets"}
                 for op, cur in stats.items()},
            )
        return deltas

    # -- triggering ---------------------------------------------------

    def trigger(
        self,
        reason: str,
        detail: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Dump one bundle for ``reason`` (debounced per reason unless
        ``force``). Returns the bundle path, or None when not dumped
        (no state_dir, cap 0, debounced, or a swallowed write error)."""
        from spark_rapids_ml_tpu_torch import config

        if self.state_dir is None:
            return None
        cap = int(config.get("incident_max_bundles") or 0)
        if cap <= 0:
            return None
        now = time.time()
        with self._lock:
            if not force:
                min_gap = float(config.get("incident_min_interval_s") or 0.0)
                last = self._last_by_reason.get(reason, 0.0)
                if now - last < min_gap:
                    return None
            self._last_by_reason[reason] = now
        try:
            return self._dump(reason, detail, now, cap)
        except Exception as e:  # never take the daemon down
            logger.warning("flight recorder: bundle for %r failed: %s",
                           reason, e)
            return None

    def _dump(self, reason: str, detail: Optional[Dict[str, Any]],
              now: float, cap: int) -> str:
        from spark_rapids_ml_tpu_torch import config
        from spark_rapids_ml_tpu_torch.utils import journal
        from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
        from spark_rapids_ml_tpu_torch.utils import xprof

        events, seq = journal.tail(0)
        snap = metrics_mod.snapshot()
        with self._lock:
            base = self._baseline
        op_deltas: Dict[str, Any] = {}
        if base is not None:
            from spark_rapids_ml_tpu_torch.utils.slo import _op_stats

            cur = _op_stats(snap)
            for op, row in cur.items():
                old = base[1].get(op, {})
                op_deltas[op] = {
                    "total": row["total"] - float(old.get("total", 0.0)),
                    "err": row["err"] - float(old.get("err", 0.0)),
                    "shed": row["shed"] - float(old.get("shed", 0.0)),
                    "window_s": now - base[0],
                }
        bundle: Dict[str, Any] = {
            "kind": BUNDLE_KIND,
            "v": 1,
            "reason": str(reason),
            "detail": detail,
            "ts": now,
            "pid": os.getpid(),
            "fingerprint": config.fingerprint(),
            "events": events,
            "seq": seq,
            "metrics": snap,
            "op_deltas": op_deltas,
            "xprof": xprof.snapshot(),
        }
        for name, provider in sorted(self.providers.items()):
            try:
                bundle[name] = provider()
            except Exception:
                bundle[name] = None

        inc_dir = os.path.join(self.state_dir, "incidents")
        os.makedirs(inc_dir, exist_ok=True)
        fname = f"incident-{int(now * 1000)}-{_slug(reason)}.json"
        path = os.path.join(inc_dir, fname)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, separators=(",", ":"), default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._rotate(inc_dir, cap)
        logger.info("flight recorder: incident bundle %s (%s, %d events)",
                    path, reason, len(events))
        return path

    @staticmethod
    def _rotate(inc_dir: str, cap: int) -> None:
        bundles = sorted(
            f for f in os.listdir(inc_dir)
            if f.startswith("incident-") and f.endswith(".json")
        )
        for stale in bundles[:-cap] if cap > 0 else []:
            try:
                os.remove(os.path.join(inc_dir, stale))
            except OSError:
                pass

    # -- fatal-teardown arming ---------------------------------------

    def arm_fatal(self) -> None:
        """Dump a ``fatal`` bundle on SIGTERM / interpreter exit, gated
        by ``incident_on_fatal``. SIGKILL is uncatchable by design —
        that case is covered by the bundles the AUTOMATIC triggers
        already dumped while the incident was unfolding."""
        from spark_rapids_ml_tpu_torch import config

        if self._fatal_armed or not config.get("incident_on_fatal"):
            return
        self._fatal_armed = True
        import atexit

        atexit.register(self._on_fatal, "atexit")
        try:  # only the main thread may install signal handlers
            import signal

            prev = signal.getsignal(signal.SIGTERM)

            def _handler(signum, frame):
                self._on_fatal("sigterm")
                if callable(prev):
                    prev(signum, frame)
                else:
                    raise SystemExit(128 + signum)

            signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError, RuntimeError):
            pass

    def _on_fatal(self, what: str) -> None:
        self.trigger("fatal", {"via": what}, force=True)

    # -- fault-site subscription --------------------------------------

    def on_fault(self, site: str, kind: str) -> None:
        """``faults.subscribe`` adapter: an injected fault FIRING is an
        incident (the bundle lands before a crash-kind fault kills the
        process — faults notifies pre-perform)."""
        self.trigger("fault_site", {"site": site, "fault": kind})


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)[:48]


#: Process-default recorder (the daemon installs its own at start):
#: lets distant layers — the fleet controller's rollout abort path —
#: record incidents without threading a recorder handle through.
_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def set_default(rec: Optional[FlightRecorder]) -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = rec


def record(reason: str, detail: Optional[Dict[str, Any]] = None
           ) -> Optional[str]:
    """Trigger on the process-default recorder; no-op when none is
    installed (a controller without a state_dir just moves on)."""
    rec = _DEFAULT
    if rec is None:
        return None
    return rec.trigger(reason, detail)


def load_bundle(path: str) -> Dict[str, Any]:
    """Read one incident bundle back (tools/trace.py, tests)."""
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    if obj.get("kind") != BUNDLE_KIND:
        raise ValueError(f"{path}: not an incident bundle")
    return obj
