"""Deterministic fault injection for the data plane.

The port's copy of ``spark_rapids_ml_tpu/utils/faults.py`` (standard
library only). The client, the daemon, the wire framing and the Arrow
bridge call :func:`checkpoint` at named sites; a :class:`FaultPlan`
(seeded, activated explicitly or by the ``SRML_TORCH_FAULT_PLAN``
environment spec) decides at each call whether to add latency, drop the
connection, refuse it, truncate the frame in flight or crash the process.
The chaos and elastic tests inject faults into the real code paths this
way, and hold the healed result to the fault-free one.

With no plan active every hook is one module-global load and an ``is
None`` test.

The port reads ``SRML_TORCH_FAULT_PLAN``, not the JAX package's
``SRML_FAULT_PLAN``: a process that imports both packages (every parity
test does) must not arm both plans from one variable.

Sites instrumented in the port (a rule naming a site that no code calls
never fires):

========================  ====================================================
``client.connect``        before the client's TCP connect
``client.op``             before each client request attempt
``daemon.conn``           daemon side, once per accepted connection
``daemon.op``             daemon side, per dispatched request, after the
                          version check and before the watermark shed
``daemon.scheduler``      serving-scheduler admission (``submit``), before
                          the queue lock: an injected fault becomes a
                          ``busy`` shed the client retries
``daemon.pass_boundary``  after an iterative job's ``step`` applied, before
                          its ack: a crash here is a daemon dying exactly
                          between two passes
``daemon.vanish``         daemon side, at the cross-daemon coordination ops
                          (``export_state``, ``reduce_mesh``,
                          ``set_iterate``): a crash here is a PEER daemon
                          dying while the fit coordinates across daemons,
                          the permanent-loss site
``daemon.join``           the mid-fit admission handshake, both ends: the
                          driver before the joiner's seeding
                          ``set_iterate``, the daemon on the job-creating
                          ``set_iterate`` path
``gossip.push``           the daemon's gossip thread, before each peer
                          exchange: a fault drops that exchange for the tick
``fleet.bootstrap``       the router's ``bootstrap_table``, before each seed
                          attempt
``fleet.rollout``         ``serve/fleet.py``, after each rollout phase's
                          intent is gossiped and before the phase runs: a
                          crash here is the controller dying mid-rollout
                          with its intent already on the wire, which a
                          successor completes or aborts
``autoscale.action``      ``serve/autoscaler.py``, between a scale decision
                          and its action: the loop counts the failure and
                          retries on a later tick, never half-scaling
``wire.send_frame``       every outbound frame, both directions
``bridge.to_matrix``      Arrow list column → matrix conversion
``bridge.to_ipc``         matrix → Arrow list column (the feed path)
========================  ====================================================

Rule kinds: ``latency`` (sleep ``delay_s`` with ±50 % jitter from the
rule's generator), ``drop`` (raise :class:`InjectedDrop`, a
``ConnectionError``), ``refuse`` (raise :class:`InjectedRefusal`, a
``ConnectionRefusedError``), ``partial`` (at ``wire.send_frame`` only:
promise the whole frame, send a prefix, then drop the connection),
``crash`` (call the plan's crash callback when one is set, which tests use
to stop or restart an in-process daemon, else ``os._exit(17)``).

Determinism: each rule has its own ``random.Random`` seeded from ``(plan
seed, site, kind)`` and its own call counter, so a rule fires on the same
N-th arrivals whatever the other rules do, and on the same arrivals as the
JAX package's rule of the same seed. Under concurrency the arrival order
at a site may differ from run to run; the chaos tests hold the healed
result to the fault-free one exactly, whichever ops failed.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional

__all__ = [
    "FaultPlan",
    "InjectedDrop",
    "InjectedRefusal",
    "activate",
    "deactivate",
    "active_plan",
    "active",
    "checkpoint",
    "truncation",
    "subscribe",
    "unsubscribe",
]

#: The environment variable whose spec arms a plan at import.
ENV_VAR = "SRML_TORCH_FAULT_PLAN"


class InjectedDrop(ConnectionError):
    """An injected connection drop (a ``ConnectionError``, so the healing
    paths treat it exactly as a real peer failure)."""


class InjectedRefusal(ConnectionRefusedError):
    """An injected connection refusal."""


class _Rule:
    __slots__ = ("site", "kind", "p", "after", "times", "delay_s", "rng", "lock", "calls",
                 "fired")

    def __init__(self, plan_seed: int, site: str, kind: str, p: float, after: int,
                 times: Optional[int], delay_s: float):
        if kind not in ("latency", "drop", "refuse", "partial", "crash"):
            raise ValueError(f"unknown fault kind {kind!r} (latency|drop|refuse|partial|crash)")
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.after = int(after)
        self.times = times if times is None else int(times)
        self.delay_s = float(delay_s)
        # Per-rule generator and counter: a rule's firing sequence depends
        # only on its own arrivals.
        self.rng = random.Random(f"{plan_seed}:{site}:{kind}")
        self.lock = threading.Lock()
        self.calls = 0
        self.fired = 0

    def fires(self) -> bool:
        with self.lock:
            self.calls += 1
            if self.calls <= self.after:
                return False
            if self.times is not None and self.fired >= self.times:
                return False
            if self.p < 1.0 and self.rng.random() >= self.p:
                return False
            self.fired += 1
            return True

    def jittered_delay(self) -> float:
        with self.lock:
            return self.delay_s * (0.5 + self.rng.random())


class FaultPlan:
    """A seeded registry of fault rules, keyed by checkpoint site."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: Dict[str, list] = {}
        self._crash_cb: Optional[Callable[[], None]] = None

    def rule(self, site: str, kind: str, p: float = 1.0, after: int = 0,
             times: Optional[int] = None, delay_s: float = 0.0) -> "FaultPlan":
        """Register one rule; returns the plan for chaining.

        ``p``: the firing probability of an eligible call; ``after``: the
        first N calls at the site never fire (crash on the N-th op:
        ``after=N-1, times=1``); ``times``: the firing budget (None:
        unbounded); ``delay_s``: the base sleep of a ``latency`` rule."""
        if kind == "partial" and site != "wire.send_frame":
            # A truncation exists only at the framing layer: a partial rule
            # elsewhere would never fire, a chaos test that proves nothing.
            raise ValueError(
                f"'partial' rules only apply at site 'wire.send_frame', not {site!r} "
                "(use 'drop' for connection-level faults)"
            )
        self._rules.setdefault(site, []).append(
            _Rule(self.seed, site, kind, p, after, times, delay_s))
        return self

    def on_crash(self, cb: Callable[[], None]) -> "FaultPlan":
        """The callback of ``crash`` rules (an in-process test stops or
        restarts its daemon here). Unset, a crash rule ``os._exit(17)``s:
        the honest simulation of a daemon that runs as its own process."""
        self._crash_cb = cb
        return self

    @property
    def fired(self) -> Dict[str, int]:
        """site → rules fired there, for the tests' proof that the plan
        exercised the healing paths."""
        out: Dict[str, int] = {}
        for site, rules in self._rules.items():
            n = sum(r.fired for r in rules)
            if n:
                out[site] = out.get(site, 0) + n
        return out

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the environment grammar::

            seed=7;client.op:drop:p=0.1;daemon.op:crash:after=20,times=1

        Entries separated by semicolons; an optional ``seed=N``; each rule
        ``site:kind[:key=val,...]`` with the keys ``p``, ``after``,
        ``times`` and ``delay_s``."""
        seed = 0
        rules = []
        for e in (e.strip() for e in spec.split(";")):
            if not e:
                continue
            if e.startswith("seed="):
                seed = int(e[len("seed="):])
                continue
            parts = e.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault rule {e!r}: want site:kind[:key=val,...]")
            kw: Dict[str, float] = {}
            if len(parts) > 2:
                for item in parts[2].split(","):
                    k, _, v = item.partition("=")
                    if k not in ("p", "after", "times", "delay_s"):
                        raise ValueError(f"bad fault rule key {k!r} in {e!r}")
                    kw[k] = float(v)
            rules.append((parts[0], parts[1], {
                "p": kw.get("p", 1.0),
                "after": int(kw.get("after", 0)),
                "times": None if "times" not in kw else int(kw["times"]),
                "delay_s": kw.get("delay_s", 0.0),
            }))
        plan = cls(seed=seed)
        for site, kind, plan_kw in rules:
            plan.rule(site, kind, **plan_kw)
        return plan

    # -- execution ---------------------------------------------------------

    def _perform(self, rule: _Rule, site: str) -> None:
        if rule.kind == "latency":
            time.sleep(rule.jittered_delay())
        elif rule.kind == "drop":
            raise InjectedDrop(f"injected fault: connection dropped at {site}")
        elif rule.kind == "refuse":
            raise InjectedRefusal(f"injected fault: connection refused at {site}")
        elif rule.kind == "crash":
            cb = self._crash_cb
            if cb is not None:
                cb()
                raise InjectedDrop(f"injected fault: daemon crashed at {site}")
            os._exit(17)  # a real process death, as a real crash would be

    def hit(self, site: str) -> None:
        for rule in self._rules.get(site, ()):
            if rule.kind != "partial" and rule.fires():
                # Subscribers hear of it BEFORE it is performed: a crash may
                # end the process inside _perform.
                _notify(site, rule.kind)
                self._perform(rule, site)

    def cut(self, site: str, n: int) -> Optional[int]:
        for rule in self._rules.get(site, ()):
            if rule.kind == "partial" and rule.fires():
                with rule.lock:
                    return rule.rng.randrange(0, max(n, 1))
        return None


# -- process-wide activation -------------------------------------------------

#: The active plan; None: every hook is a no-op.
_PLAN: Optional[FaultPlan] = None

#: Fired-fault subscribers ``cb(site, kind)``, called when a rule fires,
#: before the fault is performed. Their errors are swallowed: observing a
#: fault must never change what it does.
_SUBSCRIBERS: list = []


def subscribe(cb) -> None:
    """Register a fired-fault callback ``cb(site, kind)``."""
    if cb not in _SUBSCRIBERS:
        _SUBSCRIBERS.append(cb)


def unsubscribe(cb) -> None:
    try:
        _SUBSCRIBERS.remove(cb)
    except ValueError:
        pass


def _notify(site: str, kind: str) -> None:
    for cb in list(_SUBSCRIBERS):
        try:
            cb(site, kind)
        except Exception:
            pass


def activate(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def deactivate() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


class active:
    """``with faults.active(plan): ...``: scoped activation; nests, and
    restores the plan it replaced on exit."""

    def __init__(self, plan: FaultPlan):
        self._plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        global _PLAN
        self._prev, _PLAN = _PLAN, self._plan
        return self._plan

    def __exit__(self, *exc) -> None:
        global _PLAN
        _PLAN = self._prev


def checkpoint(site: str) -> None:
    """Fault hook: a no-op unless a plan is active and has a rule here.
    May sleep, raise :class:`InjectedDrop` or :class:`InjectedRefusal`, or
    crash the process."""
    plan = _PLAN
    if plan is None:
        return
    plan.hit(site)


def truncation(site: str, n: int) -> Optional[int]:
    """The wire layer's partial-frame hook: None, or the number of the
    ``n`` payload bytes to send before dropping the connection."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.cut(site, n)


# Activation from the environment, parsed once at import: a daemon process
# or an executor's task process inherits the spec from its parent.
_spec = os.environ.get(ENV_VAR)
if _spec:
    activate(FaultPlan.from_spec(_spec))
del _spec
