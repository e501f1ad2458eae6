"""Metrics-driven replica autoscaler for the serving fleet.

The port's copy of ``spark_rapids_ml_tpu/serve/autoscaler.py``.
``serve/fleet.py`` scales a replica set by hand (``scale_out`` /
``scale_in``); this module closes the loop: a small controller that reads
telemetry the fleet already emits (the replicas' scheduler queues and busy
state from the router's polled ``health``, the routed requests in flight,
``srml_scheduler_sheds_total``, the routed p99 from
``srml_router_request_seconds`` and ``srml_slo_breach``) and scales the
fleet between a floor and a ceiling.

Control law (docs/protocol.md "Serve autoscaler"):

* **Signal.** ``load = queued requests / live replicas``. Two pressure
  overrides force a high verdict whatever the queue: a positive delta of
  ``srml_scheduler_sheds_total`` since the last tick, and, when
  ``autoscale_p99_deadline_s`` is set, a routed p99 over the deadline; a
  breaching SLO forces it before either.
* **Hysteresis.** Scale up at or above ``autoscale_high_watermark``,
  down at or below ``autoscale_low_watermark``, hold between them.
* **Cooldown.** At most one action a ``autoscale_cooldown_s`` window;
  decisions and crossings are still counted while it holds.
* **Actions.** Only through the fleet's register → warm → flip → drain
  machinery: ``scale_out`` seeds and warms every active model on the
  newcomer before ring admission; ``scale_in`` removes the victim from the
  ring and rolls every model one version forward, so the drain barrier
  waits out requests pinned to the old version. A failed action (the
  ``autoscale.action`` fault site sits between decide and act) counts as
  an error and is retried on a later tick.

The sheds and the routed latency come from THIS process's metrics
registry, as in the reference: they see the daemons and routers that run
in the controller's process. Replicas in processes of their own carry load
to it only through their polled ``health`` (scheduler queues, ``busy``)
and the routed requests in flight.

Decisions, crossings and actions count as ``srml_autoscale_*`` metrics,
actions run as journal spans, and :meth:`AutoScaler.status` feeds the
``tools/top`` autoscaler panel.

Threads: the controller owns one daemon thread (``start``/``stop``);
``tick`` may also be driven by hand. Concurrent ``tick`` calls are
serialized by ``_tick_lock``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.metrics import quantile_from_buckets

logger = get_logger("serve.autoscaler")

__all__ = ["AutoScaler"]

#: Autoscaler telemetry (docs/observability.md catalogs all of these).
_M_DECISIONS = metrics_mod.counter(
    "srml_autoscale_decisions_total",
    "Control-loop decisions, by verdict (up|down|hold)",
)
_M_CROSSINGS = metrics_mod.counter(
    "srml_autoscale_crossings_total",
    "Watermark crossings observed, by watermark (high|low) — counted "
    "even when cooldown or the replica bounds hold the action back",
)
_M_ACTIONS = metrics_mod.counter(
    "srml_autoscale_actions_total",
    "Scale actions attempted, by action (scale_up|scale_down) and "
    "outcome (ok|error|bounded)",
)
_M_REPLICAS = metrics_mod.gauge(
    "srml_autoscale_replicas",
    "Live replicas in the autoscaled fleet's ring",
)
_M_LOAD = metrics_mod.gauge(
    "srml_autoscale_load",
    "Last observed load signal (queued requests per live replica)",
)
_M_COOLDOWN = metrics_mod.gauge(
    "srml_autoscale_cooldown_seconds",
    "Seconds of action cooldown remaining (0 = the controller may act)",
)
_M_LAST_DECISION = metrics_mod.gauge(
    "srml_autoscale_last_decision",
    "One-hot last verdict, by verdict (up|down|hold) — the tools/top "
    "panel renders the verdict whose series reads 1",
)
_M_WATERMARK = metrics_mod.gauge(
    "srml_autoscale_watermark",
    "Configured load watermarks, by bound (high|low) — exported so the "
    "tools/top panel can show the thresholds next to the live load",
)


class AutoScaler:
    """Close the loop between fleet telemetry and fleet membership.

    ``fleet``: the :class:`~spark_rapids_ml_tpu_torch.serve.fleet.ModelFleet`
    to scale (actions go through its ``scale_out``/``scale_in``).
    ``spawn``: zero-arg callable returning a new replica endpoint
    (``"host:port"`` or ``(host, port)``) with a daemon LISTENING on it
    — the deployment's "grant me a host" hook (a test spawns an
    in-process :class:`DataPlaneDaemon`; a real deployment asks its
    cluster manager). ``drain``: optional callable invoked with the
    victim's replica key after a FULLY drained scale-in — the "release
    the host" hook; it is never called when the drain barrier timed
    out, because stopping a daemon with pinned in-flight requests IS
    the dropped request the barrier prevents.

    Every knob defaults from config (``autoscale_*`` keys, env
    ``SRML_TORCH_AUTOSCALE_*``); constructor arguments override per instance.
    """

    def __init__(
        self,
        fleet,
        spawn: Callable[[], Any],
        drain: Optional[Callable[[str], None]] = None,
        *,
        high_watermark: Optional[float] = None,
        low_watermark: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        tick_s: Optional[float] = None,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        p99_deadline_s: Optional[float] = None,
        telemetry: Optional[Callable[[], Dict[str, Any]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        def _knob(value, key, cast):
            return cast(config.get(key) if value is None else value)

        self._fleet = fleet
        self._spawn = spawn
        self._drain = drain
        self.high = _knob(high_watermark, "autoscale_high_watermark", float)
        self.low = _knob(low_watermark, "autoscale_low_watermark", float)
        if self.low > self.high:
            raise ValueError(
                f"autoscale_low_watermark ({self.low}) must not exceed "
                f"autoscale_high_watermark ({self.high}) — the band "
                "between them is the hysteresis"
            )
        self.cooldown_s = _knob(cooldown_s, "autoscale_cooldown_s", float)
        self.tick_s = _knob(tick_s, "autoscale_tick_s", float)
        self.min_replicas = max(
            _knob(min_replicas, "autoscale_min_replicas", int), 1
        )
        self.max_replicas = _knob(max_replicas, "autoscale_max_replicas", int)
        self.p99_deadline_s = _knob(
            p99_deadline_s, "autoscale_p99_deadline_s", float
        )
        self._telemetry = telemetry or self._default_telemetry
        self._clock = clock
        _M_WATERMARK.set(self.high, bound="high")
        _M_WATERMARK.set(self.low, bound="low")
        self._tick_lock = threading.Lock()
        self._last_action_at: Optional[float] = None
        self._last_sheds: Optional[float] = None
        self._last_decision: Dict[str, Any] = {}
        self._last_action: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- telemetry ---------------------------------------------------------

    def _default_telemetry(self) -> Dict[str, Any]:
        """One sample from sources the fleet already maintains — the
        router-shared replica view (in-flight routed requests, health
        snapshots; no extra wire ops) plus this process's metrics
        registry. ``queued`` is WORK in the system: requests currently
        executing (``_Replica.inflight``, counted live on the router's
        request path) plus the serving scheduler's per-model queue
        depths from the last health snapshot. Deliberately NOT health's
        ``queue_depth``: that counts open CONNECTIONS, and idle fleet
        clients keep theirs open — an idle fleet would read permanent
        load and the controller would never vote down. A replica with
        NO snapshot yet contributes only its in-flight count — the
        controller never scales on imagined load."""
        table = self._fleet.table
        queued = 0.0
        busy = 0
        replicas = table.replicas()
        # Membership comes from the GOSSIPED view when the fleet has
        # one: a replica some other controller already tombstoned (a
        # scale-in this process has not merged into its ring yet) must
        # not count toward capacity — the load signal would read low
        # against phantom replicas and the controller would under-scale.
        view = getattr(self._fleet, "view", None)
        tombstoned = set()
        if view is not None:
            tombstoned = {
                r["addr"] for r in view.replicas(liveness="tombstone")
                if r.get("addr")
            }
        live = [r for r in replicas if r.alive and r.key not in tombstoned]
        for r in live:
            queued += float(getattr(r, "inflight", 0) or 0)
            h = r.health or {}
            sched = h.get("scheduler") or {}
            models = sched.get("models") or {}
            if isinstance(models, dict):
                queued += sum(float(v or 0) for v in models.values())
            if h.get("busy"):
                busy += 1
        snap = metrics_mod.snapshot()
        sheds = sum(
            float(s.get("value", 0.0))
            for s in (snap.get("srml_scheduler_sheds_total") or {}).get(
                "samples", []
            )
        )
        p99 = None
        lat = snap.get("srml_router_request_seconds")
        if lat:
            merged: Dict[str, int] = {}
            for s in lat.get("samples", []):
                for le, n in (s.get("buckets") or {}).items():
                    merged[le] = merged.get(le, 0) + int(n)
            p99 = quantile_from_buckets(merged, 0.99)
        # SLO burn (utils/slo.py, exported into this same registry):
        # objectives currently breaching — fast AND slow window both over
        # slo_burn_threshold. A leading indicator: the burn crosses while
        # the raw queue still sits below the high watermark.
        slo_breaches = sum(
            1 for s in (snap.get("srml_slo_breach") or {}).get("samples", [])
            if float(s.get("value", 0.0)) >= 1.0
        )
        return {
            "replicas": len(live),
            "queued": queued,
            "busy": busy,
            "sheds_total": sheds,
            "p99_s": p99,
            "slo_breaches": slo_breaches,
        }

    # -- decision ----------------------------------------------------------

    def evaluate(self, sample: Dict[str, Any],
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Pure decision step: sample → verdict. Counts decisions and
        crossings; mutates only the shed high-water mark. The verdict
        says what the load ASKS for — ``tick`` separately decides
        whether cooldown/bounds allow acting on it."""
        now = self._clock() if now is None else now
        n = max(int(sample.get("replicas") or 0), 1)
        load = float(sample.get("queued") or 0.0) / n
        sheds_total = float(sample.get("sheds_total") or 0.0)
        shed_delta = (
            0.0 if self._last_sheds is None
            else max(sheds_total - self._last_sheds, 0.0)
        )
        self._last_sheds = sheds_total
        p99 = sample.get("p99_s")
        over_deadline = bool(
            self.p99_deadline_s and p99 is not None
            and p99 > self.p99_deadline_s
        )
        slo_breaches = int(sample.get("slo_breaches") or 0)
        reason = "load"
        if slo_breaches > 0:
            # A burning SLO (utils/slo.py: fast AND slow window both over
            # slo_burn_threshold) forces up BEFORE the raw watermarks
            # trip: the burn rate is budget-relative, so it pages on a
            # p99 regression the absolute queue signal cannot see yet.
            verdict, reason = "up", "slo"
        elif load >= self.high:
            verdict = "up"
        elif shed_delta > 0:
            # Sheds are refused requests: the fleet is ALREADY over
            # capacity whatever the instantaneous queue reads.
            verdict, reason = "up", "sheds"
        elif over_deadline:
            verdict, reason = "up", "p99"
        elif load <= self.low:
            verdict = "down"
        else:
            verdict = "hold"
        _M_DECISIONS.inc(verdict=verdict)
        _M_LOAD.set(load)
        for v in ("up", "down", "hold"):
            _M_LAST_DECISION.set(1.0 if v == verdict else 0.0, verdict=v)
        if verdict == "up":
            _M_CROSSINGS.inc(watermark="high")
            journal.mark(
                "autoscale crossing", watermark="high", load=round(load, 3),
                reason=reason, replicas=n,
            )
        elif verdict == "down":
            _M_CROSSINGS.inc(watermark="low")
            journal.mark(
                "autoscale crossing", watermark="low", load=round(load, 3),
                reason=reason, replicas=n,
            )
        decision = {
            "verdict": verdict,
            "reason": reason,
            "load": load,
            "p99_s": p99,
            "shed_delta": shed_delta,
            "replicas": int(sample.get("replicas") or 0),
            "at": now,
        }
        self._last_decision = decision
        return decision

    def cooldown_remaining(self, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        if self._last_action_at is None:
            return 0.0
        return max(self._last_action_at + self.cooldown_s - now, 0.0)

    # -- act ---------------------------------------------------------------

    def _adopt_orphaned_rollouts(self) -> None:
        """Crash-safe rollouts, closed loop: a rollout intent gossiped
        by a controller that then DIED sits in the view until someone
        finishes it. The autoscaler is the fleet's resident control
        loop, so it adopts any intent older than
        ``fleet_drain_timeout_s`` — a live controller advances its
        phases well inside one drain window — and completes or aborts
        it through ``ModelFleet.resume_rollout`` (the phase decides
        which). Fleets without the gossip plane (bare stubs in tests)
        are skipped."""
        resume = getattr(self._fleet, "resume_rollout", None)
        intents = getattr(self._fleet.table, "intents", None)
        if resume is None or intents is None:
            return
        horizon = float(config.get("fleet_drain_timeout_s"))
        now = time.time()
        for model, intent in intents().items():
            age = now - float(intent.get("at") or 0.0)
            if age <= horizon:
                continue
            try:
                res = resume(model)
            except Exception as e:
                _M_ACTIONS.inc(action="resume_rollout", outcome="error")
                logger.warning(
                    "adopting the orphaned rollout of %r failed (will "
                    "retry on a later tick): %s", model, e,
                )
                continue
            if res.get("action") != "none":
                _M_ACTIONS.inc(action="resume_rollout", outcome="ok")
                logger.warning(
                    "adopted an orphaned rollout of %r: %s v%s→v%s "
                    "(died in phase %r, %.1fs ago)",
                    model, res.get("action"), intent.get("from_version"),
                    intent.get("to_version"), intent.get("phase"), age,
                )

    def tick(self) -> Dict[str, Any]:
        """One full control iteration: adopt orphaned rollouts, then
        sample → decide → maybe act. Returns the decision dict with an
        ``action`` field describing what (if anything) was done.
        Thread-safe; callable manually."""
        with self._tick_lock:
            self._adopt_orphaned_rollouts()
            sample = self._telemetry()
            now = self._clock()
            decision = self.evaluate(sample, now=now)
            n_live = len([
                r for r in self._fleet.table.replicas() if r.alive
            ])
            _M_REPLICAS.set(n_live)
            remaining = self.cooldown_remaining(now)
            _M_COOLDOWN.set(round(remaining, 3))
            verdict = decision["verdict"]
            if verdict == "hold":
                decision["action"] = "none"
                return decision
            if remaining > 0:
                # The hysteresis' second half: pressure is recorded
                # (crossing counted above), the fleet is not churned.
                decision["action"] = "cooldown"
                return decision
            if verdict == "up" and n_live >= self.max_replicas:
                _M_ACTIONS.inc(action="scale_up", outcome="bounded")
                decision["action"] = "bounded"
                return decision
            if verdict == "down" and n_live <= self.min_replicas:
                _M_ACTIONS.inc(action="scale_down", outcome="bounded")
                decision["action"] = "bounded"
                return decision
            action = "scale_up" if verdict == "up" else "scale_down"
            try:
                # The decide→act seam: a controller dying or being
                # refused HERE (the autoscale.action fault site) must
                # leave the fleet exactly as it was — the action is
                # counted as an error and retried on a later tick.
                faults.checkpoint("autoscale.action")
                with journal.span(
                    f"autoscale.{action}",
                    load=round(decision["load"], 3),
                    reason=decision["reason"], replicas=n_live,
                ):
                    if action == "scale_up":
                        endpoint = self._spawn()
                        res = self._fleet.scale_out(endpoint)
                    else:
                        res = self._fleet.scale_in()
                        if res["drained"] and self._drain is not None:
                            self._drain(res["replica"])
            except Exception as e:
                _M_ACTIONS.inc(action=action, outcome="error")
                self._last_action = {
                    "action": action, "outcome": "error",
                    "error": str(e)[:300], "at": now,
                }
                logger.warning("autoscale %s failed (will retry on a "
                               "later tick): %s", action, e)
                decision["action"] = "error"
                return decision
            self._last_action_at = now
            _M_ACTIONS.inc(action=action, outcome="ok")
            _M_REPLICAS.set(int(res.get("replicas", n_live)))
            _M_COOLDOWN.set(round(self.cooldown_s, 3))
            self._last_action = {
                "action": action, "outcome": "ok",
                "replica": res.get("replica"), "at": now,
            }
            logger.info(
                "autoscale %s: load %.2f (%s) → %s replicas",
                action, decision["load"], decision["reason"],
                res.get("replicas"),
            )
            decision["action"] = action
            decision["result"] = res
            return decision

    # -- loop --------------------------------------------------------------

    def start(self) -> "AutoScaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="srml-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(self.tick_s * 4, 5.0))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                # The loop must outlive any single bad tick: telemetry
                # sources flap, fleets lose replicas mid-sample.
                logger.exception("autoscaler tick failed")
            self._stop.wait(self.tick_s)

    # -- observability -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The tools/top panel's source: watermarks, last decision,
        last action, cooldown remaining, live replica count."""
        return {
            "high_watermark": self.high,
            "low_watermark": self.low,
            "cooldown_s": self.cooldown_s,
            "cooldown_remaining_s": round(self.cooldown_remaining(), 3),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "replicas": len([
                r for r in self._fleet.table.replicas() if r.alive
            ]),
            "last_decision": dict(self._last_decision),
            "last_action": dict(self._last_action),
        }
