"""Client-side fleet routing: consistent hashing, failover, version pinning.

The port's copy of ``spark_rapids_ml_tpu/serve/router.py``. One daemon
serves one host's card; a :class:`FleetClient` routes each ``transform``
or ``kneighbors`` request to one of N replica daemons, with the routing
decision in the client, so the fleet needs no load-balancer tier
(docs/protocol.md "Fleet & versioned serving"):

* **Consistent hashing.** Replicas are points on a hash ring
  (``fleet_vnodes`` virtual nodes each, keyed by a stable SHA-1 digest,
  never Python's salted ``hash``). A request's ``route_key`` (a user or
  session id; by default a fresh nonce a request, which spreads load)
  picks the primary replica. Sticky keys keep a replica's serving ladder
  hot for the traffic hashed to it; adding or removing a replica moves
  about 1/N of the key space.
* **Least-loaded failover.** A primary that sheds with ``busy`` or is dead
  hands the request to the least-loaded other replica, by the polled
  ``health`` (``queue_depth`` plus the scheduler's queued requests),
  refreshed at most every ``fleet_health_poll_s``. A replica that fails at
  the transport is marked dead until that interval re-probes it.
* **Exactly-once.** The serving ops are pure reads of a registered model,
  so a failover retry cannot double-apply anything; the router returns one
  response a request, and the :class:`DataPlaneClient`'s healing
  (reconnect, backoff, deadline) runs per attempt.
* **Version pinning.** A request takes ONE ``(version, epoch)`` snapshot of
  the routing table before it routes and stamps it on the wire; replicas
  echo it and, with ``serve_version_strict``, refuse a version they do not
  hold under the routed name, so retries and failovers of one request stay
  on the version it started on.

Each routed request is a ``router.<op>`` journal span on the calling
thread; the daemon's ``daemon.<op>`` span, stamped through the client's
``trace_ctx``, parents under it.

Beyond the reference: an ndarray ``transform`` or ``kneighbors`` goes out
as raw ``arrays`` frames (``transform_raw``, ``kneighbors_raw``), since a
card's host may have no Arrow library; an Arrow table goes as Arrow IPC.

Threads: a :class:`FleetClient` is single-threaded like the
:class:`DataPlaneClient` it wraps (one socket a replica); give each worker
thread its own. The :class:`RoutingTable` and its health view are shared
and thread-safe.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import protocol
from spark_rapids_ml_tpu_torch.serve.client import DaemonBusy, DataPlaneClient
from spark_rapids_ml_tpu_torch.utils import faults, journal
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils.retry import decorrelated_jitter

logger = get_logger("serve.router")

__all__ = [
    "ConsistentHashRing",
    "FleetClient",
    "FleetUnavailable",
    "RoutingTable",
    "bootstrap_table",
]

#: Router telemetry (docs/observability.md catalogs all of these).
_M_REQUESTS = metrics_mod.counter(
    "srml_router_requests_total",
    "Fleet-routed serving requests, by op and outcome (ok|unroutable)",
)
_M_REQ_SECONDS = metrics_mod.histogram(
    "srml_router_request_seconds",
    "End-to-end routed request latency (all failover attempts), by op",
)
_M_FAILOVERS = metrics_mod.counter(
    "srml_router_failovers_total",
    "Requests rerouted off a replica, by reason (busy|dead|error)",
)
_M_HEALTH_REFRESHES = metrics_mod.counter(
    "srml_router_health_refreshes_total",
    "Replica health polls issued by the router, by outcome (ok|dead)",
)
_M_REPAIRS = metrics_mod.counter(
    "srml_router_repairs_total",
    "Replicas re-registered in-band after answering 'no such model' "
    "(a restarted replica lost its registry; the routing table re-seeds "
    "it from the fleet's stored model payload)",
)
_M_BOOTSTRAPS = metrics_mod.counter(
    "srml_fleet_bootstraps_total",
    "Client pulls of the gossiped FleetView, by outcome (ok = a "
    "bootstrap built a routing table from one seed; error = a seed "
    "attempt failed; resync = a serving ack's version/epoch mismatch "
    "re-pulled the view mid-traffic)",
)


class FleetUnavailable(RuntimeError):
    """Every candidate replica refused (busy/dead/error) within the
    failover budget. Carries the last per-replica error as context."""


def _h64(s: str) -> int:
    """Stable 64-bit point on the ring. Python's ``hash`` is salted per
    process — two clients would disagree about the whole ring."""
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """The standard fixed ring: each replica key contributes ``vnodes``
    points; a request key routes to the first point clockwise. Immutable
    — membership changes (a dead replica) are handled by SKIPPING at
    route time, not rebuilding, so a flapping daemon cannot churn every
    client's key→replica mapping."""

    def __init__(self, keys, vnodes: int = 64):
        keys = list(keys)
        if not keys:
            raise ValueError("hash ring needs at least one replica key")
        points = []
        for k in keys:
            for i in range(max(int(vnodes), 1)):
                points.append((_h64(f"{k}#{i}"), k))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._keys = [k for _, k in points]
        self._members = tuple(dict.fromkeys(keys))

    @property
    def members(self) -> Tuple[str, ...]:
        return self._members

    def primary(self, key: str) -> str:
        """The replica owning ``key``."""
        return self.ordered(key)[0]

    def ordered(self, key: str) -> List[str]:
        """Every member, in ring order from ``key``'s point (the
        primary first, then the natural successor chain — the order a
        pure ring failover would walk)."""
        i = bisect.bisect_right(self._hashes, _h64(key)) % len(self._keys)
        out: List[str] = []
        seen = set()
        for j in range(len(self._keys)):
            k = self._keys[(i + j) % len(self._keys)]
            if k not in seen:
                seen.add(k)
                out.append(k)
                if len(out) == len(self._members):
                    break
        return out


class _Replica:
    """One fleet member: endpoint + the router-shared liveness/load view.
    Mutated only under the owning table's lock."""

    __slots__ = ("key", "host", "port", "alive", "recheck_at", "health",
                 "health_ts", "last_error", "retired", "inflight")

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self.key = f"{host}:{port}"
        self.alive = True
        self.recheck_at = 0.0  # monotonic: when a dead replica re-probes
        self.health: Dict[str, Any] = {}
        self.health_ts = 0.0
        self.last_error: Optional[str] = None
        # Scale-in tombstone: a retired replica left the ring (no NEW
        # request routes to it) but its entry survives, so an in-flight
        # request that snapshotted the OLD ring can still resolve the
        # key it routed to — removal must never turn a live request
        # into a KeyError.
        self.retired = False
        # Routed requests currently executing against THIS replica
        # (begin_replica/done_replica) — the router's live work-in-system
        # view, distinct from the per-VERSION refcounts the drain
        # barrier uses. The autoscaler's default telemetry reads it as
        # the offered-load signal: health's ``queue_depth`` counts open
        # CONNECTIONS (idle fleet clients keep theirs open), which
        # would read as permanent load and pin the controller at "up".
        self.inflight = 0

    def load(self) -> float:
        """Comparable load score: live in-flight routed requests plus
        the last health snapshot's open connections + queued scheduler
        requests (all grow under pressure); a busy replica sorts after
        every non-busy one."""
        h = self.health
        q = float(self.inflight)
        q += float(h.get("queue_depth", 0) or 0)
        sched = h.get("scheduler") or {}
        q += float(sched.get("queued", 0) or 0)
        if h.get("busy"):
            q += 1e6
        return q


class RoutingTable:
    """The fleet's shared state: replicas + per-model version table.

    One table is shared by the control plane (serve/fleet.py) and every
    :class:`FleetClient`; all access is lock-protected and cheap. The
    version table is the zero-downtime rollout mechanism:

    * ``install`` adds a version's registration (name, payload) without
      routing to it;
    * ``activate`` atomically flips the active version and bumps the
      fleet ``epoch`` — requests snapshot ``(version, epoch)`` ONCE at
      entry, so every request is pinned to exactly one version;
    * ``begin``/``done`` refcount in-flight requests per version, and
      ``wait_drained`` blocks until a retired version's count reaches
      zero — the drain barrier that lets v1 finish before it is dropped.
    """

    def __init__(self, endpoints, vnodes: Optional[int] = None):
        reps = []
        for ep in endpoints:
            if isinstance(ep, str):
                host, _, port = ep.rpartition(":")
                reps.append(_Replica(host or "127.0.0.1", int(port)))
            else:
                reps.append(_Replica(ep[0], int(ep[1])))
        if not reps:
            raise ValueError("a fleet needs at least one replica endpoint")
        keys = [r.key for r in reps]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate replica endpoints: {sorted(keys)}")
        self._replicas: Dict[str, _Replica] = {r.key: r for r in reps}
        self._vnodes = int(
            config.get("fleet_vnodes") if vnodes is None else vnodes
        )
        self.ring = ConsistentHashRing(keys, vnodes=self._vnodes)
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        #: model → {"active": int|None, "epoch": int,
        #:          "versions": {int: version-info dict}}
        self._models: Dict[str, Dict[str, Any]] = {}
        # Highest gossiped FleetView epoch this table has merged
        # (apply_view) — the client's convergence probe; 0 until the
        # table first sees a gossiped view.
        self._view_epoch = 0

    # -- replicas ----------------------------------------------------------

    def replicas(self) -> List[_Replica]:
        """The CURRENT fleet members (retired scale-in tombstones are
        excluded — the control plane must not register new versions on
        a replica that already left the ring)."""
        with self._lock:
            return [r for r in self._replicas.values() if not r.retired]

    def replica(self, key: str) -> _Replica:
        return self._replicas[key]

    def _rebuild_ring_locked(self) -> None:
        """Swap in a fresh ring over the non-retired members. The ring
        object itself stays immutable — readers grab ``self.ring`` once
        (one atomic attribute load) and route against a consistent
        snapshot; membership changes move only ~1/N of the key space."""
        keys = [k for k, r in self._replicas.items() if not r.retired]
        self.ring = ConsistentHashRing(keys, vnodes=self._vnodes)

    def add_replica(self, endpoint) -> str:
        """Elastic scale-UP (serve/autoscaler.py): admit a new replica
        into the ring. The caller (ModelFleet.scale_out) registers and
        warms every active model version on it FIRST — admission is the
        flip, so the first request routed here finds a warm
        registration, never a cold daemon. Re-admitting a retired key
        clears its tombstone. Returns the replica key."""
        if isinstance(endpoint, str):
            host, _, port = endpoint.rpartition(":")
            r = _Replica(host or "127.0.0.1", int(port))
        else:
            r = _Replica(endpoint[0], int(endpoint[1]))
        with self._lock:
            existing = self._replicas.get(r.key)
            if existing is not None and not existing.retired:
                raise ValueError(f"replica {r.key} is already in the fleet")
            # A re-admitted endpoint gets a FRESH entry: the tombstone's
            # stale health/dead-state must not haunt the newcomer.
            self._replicas[r.key] = r
            self._rebuild_ring_locked()
        return r.key

    def remove_replica(self, key: str) -> None:
        """Elastic scale-DOWN: retire a replica from the ring so no NEW
        request routes to it. In-flight requests that already routed
        there finish normally (the entry survives as a tombstone; the
        daemon itself is only stopped after the version-drain barrier —
        ModelFleet.scale_in). The last live replica cannot be removed:
        an empty ring would make every request unroutable."""
        with self._lock:
            r = self._replicas.get(key)
            if r is None or r.retired:
                raise KeyError(f"no live replica {key!r} in the fleet")
            live = sum(
                1 for rep in self._replicas.values() if not rep.retired
            )
            if live <= 1:
                raise ValueError(
                    f"cannot remove {key!r}: it is the last replica in "
                    "the ring"
                )
            r.retired = True
            self._rebuild_ring_locked()

    def mark_dead(self, key: str, error: str, recheck_s: float) -> None:
        with self._lock:
            r = self._replicas[key]
            r.alive = False
            r.last_error = error
            r.recheck_at = time.monotonic() + max(recheck_s, 0.05)

    def mark_alive(self, key: str, health: Optional[Dict[str, Any]] = None
                   ) -> None:
        with self._lock:
            r = self._replicas[key]
            r.alive = True
            r.last_error = None
            if health is not None:
                r.health = health
                r.health_ts = time.monotonic()

    # -- gossiped fleet view (serve/gossip.py; docs/protocol.md) -----------

    @property
    def view_epoch(self) -> int:
        with self._lock:
            return self._view_epoch

    def apply_view(self, wire: Dict[str, Any]) -> Dict[str, int]:
        """Merge a gossiped FleetView wire dict into this table: admit
        unknown live replicas, retire tombstoned ones (never the last
        live member), and adopt each model's active version/epoch when
        the view's fleet epoch is AHEAD of the local one — the fleet
        epoch only ever moves forward, so a stale island's view can
        never rewind a table past a flip it already saw.

        Version entries created here are PAYLOAD-LESS (``arrays=None``):
        the client can route to them — the replicas already hold the
        registration — but in-band repair refuses, because there is
        nothing local to re-seed a replica from; the client resyncs
        instead. Tolerant by design: this is the bootstrap/resync path
        and must never throw on a half-converged view."""
        out = {"replicas_added": 0, "replicas_retired": 0, "models": 0}
        wire = wire or {}
        with self._lock:
            self._view_epoch = max(
                self._view_epoch, int(wire.get("epoch", 0) or 0)
            )
            for rec in (wire.get("replicas") or {}).values():
                addr = str(rec.get("addr") or "")
                if ":" not in addr:
                    continue
                liveness = rec.get("liveness")
                existing = self._replicas.get(addr)
                if liveness == "tombstone":
                    if existing is not None and not existing.retired:
                        live = sum(
                            1 for r in self._replicas.values()
                            if not r.retired
                        )
                        if live > 1:
                            existing.retired = True
                            out["replicas_retired"] += 1
                elif liveness == "up":
                    if existing is None or existing.retired:
                        host, _, port = addr.rpartition(":")
                        self._replicas[addr] = _Replica(
                            host or "127.0.0.1", int(port)
                        )
                        out["replicas_added"] += 1
                # liveness == "down": keep the member — gossip decides
                # MEMBERSHIP; the router's own health probes decide
                # moment-to-moment aliveness.
            if out["replicas_added"] or out["replicas_retired"]:
                self._rebuild_ring_locked()
            for name, rec in (wire.get("models") or {}).items():
                entry = self._models.setdefault(
                    name, {"active": None, "epoch": 0, "versions": {}}
                )
                # Lamport-dominance per record: a record this table
                # already merged (or wrote) at a higher gossip epoch
                # wins over a stale island's copy.
                ge = int(rec.get("epoch", 0) or 0)
                if ge < int(entry.get("_gossip_epoch", 0)):
                    continue
                entry["_gossip_epoch"] = ge
                out["models"] += 1
                active = rec.get("active_version")
                active = None if active is None else int(active)
                fe = int(rec.get("fleet_epoch", 0) or 0)
                if (
                    active is not None
                    and active not in entry["versions"]
                    and fe >= entry["epoch"]
                ):
                    entry["versions"][active] = {
                        "reg_name": self.reg_name(name, active),
                        "algo": None, "arrays": None, "params": {},
                        "inflight": 0,
                    }
                for vs in (rec.get("tombstones") or {}):
                    v = int(vs)
                    info = entry["versions"].get(v)
                    if (
                        v != active and v != entry["active"]
                        and info is not None and info["inflight"] <= 0
                    ):
                        entry["versions"].pop(v, None)
                if fe > entry["epoch"] or (
                    fe == entry["epoch"] and entry["active"] is None
                ):
                    entry["active"] = active
                    entry["epoch"] = fe
                entry["intent"] = rec.get("intent")
        return out

    def intent(self, model: str) -> Optional[Dict[str, Any]]:
        """The model's gossiped rollout-intent record, or None — what a
        successor controller reads to complete or abort an interrupted
        rollout (ModelFleet.resume_rollout)."""
        with self._lock:
            entry = self._models.get(model)
            return None if entry is None else entry.get("intent")

    def set_intent(self, model: str,
                   intent: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            entry = self._models.setdefault(
                model, {"active": None, "epoch": 0, "versions": {}}
            )
            entry["intent"] = intent

    def intents(self) -> Dict[str, Dict[str, Any]]:
        """Every model with a live rollout intent — what the
        autoscaler's orphan-adoption sweep iterates. Includes models
        with NO active version (a rollout interrupted while
        registering a brand-new model)."""
        with self._lock:
            return {
                m: dict(e["intent"]) for m, e in self._models.items()
                if e.get("intent")
            }

    # -- version table -----------------------------------------------------

    @staticmethod
    def reg_name(model: str, version: int) -> str:
        """The daemon-side registration name of one model version. The
        '@v' convention IS the isolation mechanism: two versions are two
        registry entries, so an in-flight v1 request addressed to
        ``m@v1`` can never be answered from v2's arrays."""
        return f"{model}@v{int(version)}"

    def install(self, model: str, version: int, algo: str,
                arrays: Dict[str, np.ndarray],
                params: Optional[Dict[str, Any]] = None) -> str:
        """Add (or refresh) a version entry without routing to it.
        Returns the daemon registration name."""
        version = int(version)
        with self._lock:
            entry = self._models.setdefault(
                model, {"active": None, "epoch": 0, "versions": {}}
            )
            # Re-installing an existing version (an operator re-seeding a
            # fleet) refreshes the payload but PRESERVES the in-flight
            # refcount: resetting it to 0 would let a later drain declare
            # "drained" while those requests still fly — exactly the
            # yanked-arrays failure the barrier exists to prevent.
            prev = entry["versions"].get(version)
            entry["versions"][version] = {
                "reg_name": self.reg_name(model, version),
                "algo": str(algo),
                "arrays": dict(arrays),
                "params": dict(params or {}),
                "inflight": 0 if prev is None else prev["inflight"],
            }
        return self.reg_name(model, version)

    def ensure_version(self, model: str, version: int) -> str:
        """Make sure a version ENTRY exists, creating a payload-less
        one (``arrays=None`` — routable, not repairable) when absent.
        A successor controller completing a gossiped rollout intent
        needs the to-version activatable even though the payload died
        with its predecessor: the replicas still hold the registration.
        Returns the registration name."""
        version = int(version)
        with self._lock:
            entry = self._models.setdefault(
                model, {"active": None, "epoch": 0, "versions": {}}
            )
            if version not in entry["versions"]:
                entry["versions"][version] = {
                    "reg_name": self.reg_name(model, version),
                    "algo": None, "arrays": None, "params": {},
                    "inflight": 0,
                }
        return self.reg_name(model, version)

    def activate(self, model: str, version: int) -> int:
        """Atomically flip the model's active version; bumps and returns
        the fleet epoch. Requests that snapshotted before the flip keep
        their old (version, epoch) pin to completion."""
        version = int(version)
        with self._lock:
            entry = self._models[model]
            if version not in entry["versions"]:
                raise KeyError(
                    f"version {version} of {model!r} was never installed"
                )
            entry["active"] = version
            entry["epoch"] += 1
            return entry["epoch"]

    def retire(self, model: str, version: int) -> None:
        with self._lock:
            entry = self._models.get(model)
            if entry is None:
                return
            if entry.get("active") == int(version):
                raise ValueError(
                    f"cannot retire the ACTIVE version {version} of "
                    f"{model!r}; activate a successor first"
                )
            entry["versions"].pop(int(version), None)

    def snapshot(self, model: str) -> Tuple[int, int, str]:
        """(active version, epoch, daemon registration name) — a
        read-only view for control-plane callers. Requests must use
        :meth:`acquire` instead: a snapshot alone does not hold the
        version against a concurrent drain."""
        with self._lock:
            return self._snapshot_locked(model)

    def _snapshot_locked(self, model: str) -> Tuple[int, int, str]:
        entry = self._models.get(model)
        if entry is None or entry["active"] is None:
            raise KeyError(
                f"no active version for model {model!r} (register it "
                "through the fleet first)"
            )
        v = entry["active"]
        return v, entry["epoch"], entry["versions"][v]["reg_name"]

    def acquire(self, model: str) -> Tuple[int, int, str]:
        """Atomically snapshot the active (version, epoch, reg_name) AND
        take an in-flight reference on that version — ONE lock
        acquisition, so a concurrent rollout can never flip-drain-retire
        the version between a request's read and its refcount (the
        zero-downtime contract's linchpin). Pair with :meth:`done`."""
        with self._lock:
            v, epoch, reg = self._snapshot_locked(model)
            self._models[model]["versions"][v]["inflight"] += 1
            return v, epoch, reg

    def version_info(self, model: str, version: int) -> Dict[str, Any]:
        """Registration payload of one version (the in-band repair
        source). Returns a shallow copy; arrays are shared read-only."""
        with self._lock:
            info = self._models[model]["versions"][int(version)]
            return {k: v for k, v in info.items() if k != "inflight"}

    def versions(self, model: str) -> List[int]:
        with self._lock:
            entry = self._models.get(model)
            return sorted(entry["versions"]) if entry else []

    def models(self) -> List[str]:
        """Model names with an ACTIVE version — the set a scale-out
        must re-seed on a joining replica (ModelFleet.scale_out)."""
        with self._lock:
            return sorted(
                m for m, e in self._models.items()
                if e["active"] is not None
            )

    def begin_replica(self, key: str) -> None:
        """Count a routed request in on ``key`` (see _Replica.inflight);
        unknown keys no-op — a replica removed mid-request still gets
        its ``done_replica`` via the same tolerant path."""
        with self._lock:
            r = self._replicas.get(key)
            if r is not None:
                r.inflight += 1

    def done_replica(self, key: str) -> None:
        with self._lock:
            r = self._replicas.get(key)
            if r is not None and r.inflight > 0:
                r.inflight -= 1

    def begin(self, model: str, version: int) -> None:
        with self._lock:
            self._models[model]["versions"][int(version)]["inflight"] += 1

    def done(self, model: str, version: int) -> None:
        with self._lock:
            entry = self._models.get(model)
            info = entry and entry["versions"].get(int(version))
            if info is None:
                return  # retired while we flew — drain already gave up on us
            info["inflight"] -= 1
            if info["inflight"] <= 0:
                self._drained.notify_all()

    def inflight(self, model: str, version: int) -> int:
        with self._lock:
            entry = self._models.get(model)
            info = entry and entry["versions"].get(int(version))
            return 0 if info is None else int(info["inflight"])

    def wait_drained(self, model: str, version: int,
                     timeout_s: float) -> bool:
        """Block until no request is in flight on ``version`` (True) or
        the timeout passes (False) — the rollout's drain barrier."""
        deadline = time.monotonic() + float(timeout_s)
        with self._lock:
            while True:
                entry = self._models.get(model)
                info = entry and entry["versions"].get(int(version))
                if info is None or info["inflight"] <= 0:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._drained.wait(timeout=remaining)


def _seed_list(seeds) -> List[str]:
    """Normalize a seeds argument — None (fall back to the
    ``fleet_seed_addresses`` config key, env ``SRML_TORCH_FLEET_SEED_ADDRESSES``), one
    comma-separated string, or an iterable — into a list of
    ``host:port`` strings."""
    if seeds is None:
        seeds = config.get("fleet_seed_addresses")
    if isinstance(seeds, str):
        seeds = [s.strip() for s in seeds.split(",") if s.strip()]
    out: List[str] = []
    for s in seeds or []:
        if isinstance(s, str):
            out.append(s)
        else:  # ("host", port) pairs — daemon.address and friends
            out.append(f"{s[0]}:{int(s[1])}")
    return out


def bootstrap_table(
    seeds=None,
    token: Optional[str] = None,
    vnodes: Optional[int] = None,
    client_kwargs: Optional[Dict[str, Any]] = None,
    passes: int = 3,
) -> RoutingTable:
    """Build a :class:`RoutingTable` from ONE reachable seed daemon.

    The fleet's membership and version tables live IN the daemons
    (gossiped FleetView, serve/gossip.py), so a fresh client needs no
    endpoint roster and no surviving predecessor: it pulls the view
    from the first seed that answers and builds its ring from the live
    replicas in it. Seeds are tried in order; after each full failed
    pass the client backs off on the decorrelated-jitter ladder
    (utils/retry.py) before the next, up to ``passes`` passes. Each
    attempt crosses the ``fleet.bootstrap`` fault site first, so chaos
    tests can fail seeds deterministically (docs/fault_injection.md).

    Raises :class:`FleetUnavailable` when no seed yields a usable view.
    """
    seeds = _seed_list(seeds)
    if not seeds:
        raise ValueError(
            "fleet bootstrap needs at least one seed address: pass "
            "seeds=, or set fleet_seed_addresses / "
            "SRML_TORCH_FLEET_SEED_ADDRESSES"
        )
    kw: Dict[str, Any] = {
        "timeout": 5.0, "op_deadline_s": 10.0, "max_op_attempts": 1,
    }
    kw.update(client_kwargs or {})
    last_err: Optional[BaseException] = None
    delay = 0.0
    for p in range(max(int(passes), 1)):
        if p:
            delay = decorrelated_jitter(delay, 0.05, 2.0)
            time.sleep(delay)
        for addr in seeds:
            host, _, port = str(addr).rpartition(":")
            try:
                faults.checkpoint("fleet.bootstrap")
                with DataPlaneClient(
                    host or "127.0.0.1", int(port), token=token, **kw
                ) as c:
                    view = c.gossip_pull()
                endpoints = sorted(
                    r["addr"] for r in (view.get("replicas") or {}).values()
                    if r.get("liveness") == "up" and r.get("addr")
                )
                if not endpoints:
                    raise FleetUnavailable(
                        f"seed {addr} answered with no live replicas in "
                        "its view"
                    )
                table = RoutingTable(endpoints, vnodes=vnodes)
                table.apply_view(view)
                _M_BOOTSTRAPS.inc(outcome="ok")
                logger.info(
                    "bootstrapped fleet from seed %s: %d replica(s), "
                    "%d model(s), view epoch %d",
                    addr, len(endpoints), len(table.models()),
                    table.view_epoch,
                )
                return table
            except (OSError, ValueError, protocol.ProtocolError,
                    RuntimeError) as e:
                last_err = e
                _M_BOOTSTRAPS.inc(outcome="error")
                logger.warning("fleet bootstrap via seed %s failed: %s",
                               addr, e)
    raise FleetUnavailable(
        f"no seed of {seeds} yielded a usable fleet view "
        f"(last error: {last_err})"
    ) from last_err


class FleetClient:
    """Route serving requests across a fleet's replicas (module
    docstring has the routing contract). Constructed from a shared
    :class:`RoutingTable` — usually via ``ModelFleet.client()``, or
    bootstrapped from one seed daemon via :meth:`from_seeds`."""

    def __init__(
        self,
        table: RoutingTable,
        token: Optional[str] = None,
        health_poll_s: Optional[float] = None,
        failover_attempts: Optional[int] = None,
        client_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self._table = table
        self._token = token
        self._poll_s = float(
            config.get("fleet_health_poll_s")
            if health_poll_s is None else health_poll_s
        )
        n = int(
            config.get("fleet_failover_attempts")
            if failover_attempts is None else failover_attempts
        )
        # 0 = one attempt per replica: every CURRENT member gets exactly
        # one chance before the request is declared unroutable — read
        # per request, not frozen at construction, so a client created
        # before an autoscaler grew the fleet failovers across the
        # grown membership too.
        self._attempts = n if n > 0 else None
        # Inner-client defaults tuned for FAILOVER, not solo healing: a
        # busy shed must surface immediately (max_busy_wait_s=0 — the
        # router's reroute IS the retry), and a dead replica must fail
        # in seconds, not socket-default minutes. Callers can override
        # any of these per fleet.
        kw: Dict[str, Any] = {
            "timeout": 10.0,
            "op_deadline_s": 15.0,
            "max_op_attempts": 2,
            "max_busy_wait_s": 0.0,
        }
        kw.update(client_kwargs or {})
        self._client_kwargs = kw
        self._clients: Dict[str, DataPlaneClient] = {}
        self._nonce = uuid.uuid4().hex[:12]
        self._seq = 0
        #: replica key → requests this client had ANSWERED there — the
        #: per-client routing distribution (chaos tests and affinity
        #: debugging read it; the process-wide aggregate lives in the
        #: srml_router_* registry metrics).
        self.stats: Dict[str, int] = {}

    @classmethod
    def from_seeds(
        cls,
        seeds=None,
        token: Optional[str] = None,
        health_poll_s: Optional[float] = None,
        failover_attempts: Optional[int] = None,
        client_kwargs: Optional[Dict[str, Any]] = None,
        vnodes: Optional[int] = None,
    ) -> "FleetClient":
        """A fully routable client from ONE seed address (or the
        ``fleet_seed_addresses`` ladder) — no endpoint roster, no
        surviving predecessor client: the table comes from the seed's
        gossiped FleetView (:func:`bootstrap_table`)."""
        table = bootstrap_table(
            seeds, token=token, vnodes=vnodes,
            client_kwargs=client_kwargs,
        )
        return cls(
            table, token=token, health_poll_s=health_poll_s,
            failover_attempts=failover_attempts,
            client_kwargs=client_kwargs,
        )

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
        self._clients.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- replica selection -------------------------------------------------

    def _client(self, key: str) -> DataPlaneClient:
        c = self._clients.get(key)
        if c is None:
            r = self._table.replica(key)
            c = DataPlaneClient(
                r.host, r.port, token=self._token, **self._client_kwargs
            )
            self._clients[key] = c
        return c

    def _refresh_health(self, key: str) -> None:
        """Poll one replica's health when its snapshot is stale; a
        failed poll marks it dead until the next poll interval."""
        r = self._table.replica(key)
        now = time.monotonic()
        if r.alive and now - r.health_ts < self._poll_s:
            return
        if not r.alive and now < r.recheck_at:
            return
        try:
            health = self._client(key).health()
        except (OSError, protocol.ProtocolError, RuntimeError) as e:
            _M_HEALTH_REFRESHES.inc(outcome="dead")
            self._table.mark_dead(key, str(e), self._poll_s)
            return
        _M_HEALTH_REFRESHES.inc(outcome="ok")
        self._table.mark_alive(key, health)

    def _candidates(self, route_key: str) -> List[str]:
        """Attempt order for one request: the ring primary first (cache
        affinity), then every other live replica least-loaded-first —
        the failover half of the contract. Dead replicas past their
        recheck time still appear (at the end): the router must be able
        to REDISCOVER a healed replica without an operator poke."""
        order = self._table.ring.ordered(route_key)
        for k in order:
            self._refresh_health(k)
        now = time.monotonic()
        primary = order[0]
        rest = order[1:]
        live = [k for k in rest if self._table.replica(k).alive]
        live.sort(key=lambda k: self._table.replica(k).load())
        dead = [
            k for k in rest
            if not self._table.replica(k).alive
            and now >= self._table.replica(k).recheck_at
        ]
        head = [primary] if (
            self._table.replica(primary).alive
            or now >= self._table.replica(primary).recheck_at
        ) else []
        return (head + live + dead) if head else (live + dead + [primary])

    def _route_key(self, route_key: Optional[str]) -> str:
        if route_key is not None:
            return str(route_key)
        self._seq += 1
        return f"{self._nonce}-{self._seq}"

    # -- serving ops -------------------------------------------------------

    def transform(
        self,
        model: str,
        data,
        route_key: Optional[str] = None,
        input_col: str = "features",
        n_cols: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, np.ndarray]:
        """Routed :meth:`DataPlaneClient.transform` against the model's
        ACTIVE version. Returns the role-keyed output arrays."""
        return self._request(
            "transform", model, route_key,
            lambda c, reg, v, e: (
                c.transform_raw(reg, data, deadline_s=deadline_s, version=v,
                                fleet_epoch=e)
                if isinstance(data, np.ndarray) else
                c.transform(reg, data, input_col=input_col, n_cols=n_cols,
                            deadline_s=deadline_s, version=v, fleet_epoch=e)
            ),
        )

    def kneighbors(
        self,
        model: str,
        queries,
        k: Optional[int] = None,
        route_key: Optional[str] = None,
        input_col: str = "features",
        n_cols: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Routed :meth:`DataPlaneClient.kneighbors`: (distances,
        indices) from the model's ACTIVE version."""
        return self._request(
            "kneighbors", model, route_key,
            lambda c, reg, v, e: (
                c.kneighbors_raw(reg, queries, k=k, deadline_s=deadline_s,
                                 version=v, fleet_epoch=e)
                if isinstance(queries, np.ndarray) else
                c.kneighbors(reg, queries, k=k, input_col=input_col,
                             n_cols=n_cols, deadline_s=deadline_s, version=v,
                             fleet_epoch=e)
            ),
        )

    def _repair(self, key: str, model: str, version: int) -> bool:
        """Re-register a version on a replica that answered "no such
        model" — a restarted replica lost its (re-creatable) registry.
        The payload comes from the routing table; failure just means the
        failover continues."""
        try:
            info = self._table.version_info(model, version)
        except KeyError:
            return False
        if info.get("arrays") is None:
            # A PAYLOAD-LESS entry adopted from a gossiped view
            # (RoutingTable.apply_view) — nothing local to re-seed the
            # replica from; the caller falls through to a resync.
            return False
        try:
            self._client(key).ensure_model(
                info["reg_name"], info["algo"], info["arrays"],
                params=info["params"], version=version,
            )
        except (OSError, protocol.ProtocolError, RuntimeError) as e:
            logger.warning(
                "in-band repair of %s v%d on %s failed: %s",
                model, version, key, e,
            )
            return False
        _M_REPAIRS.inc()
        logger.warning(
            "re-registered %s v%d on replica %s (it had lost the "
            "registration)", model, version, key,
        )
        return True

    def _resync(self, key: str, model: str) -> bool:
        """Re-pull the gossiped FleetView from the ANSWERING replica
        after a ``version mismatch`` ack or an unrepairable "no such
        model" — the replica that refused KNOWS the fleet state this
        client's table missed (a rollout it slept through), so resyncing
        from it beats erroring out (docs/protocol.md "Fleet gossip &
        bootstrap"). Never raises; False just continues the failover."""
        try:
            view = self._client(key).gossip_pull()
        except (OSError, protocol.ProtocolError, RuntimeError) as e:
            logger.warning("fleet resync from %s failed: %s", key, e)
            return False
        if not view:
            return False
        self._table.apply_view(view)
        _M_BOOTSTRAPS.inc(outcome="resync")
        logger.info(
            "resynced routing table from %s for model %r (view epoch %d)",
            key, model, self._table.view_epoch,
        )
        return True

    def _request(self, kind: str, model: str, route_key, attempt_fn):
        # ONE atomic snapshot-and-refcount pins this request — and every
        # failover retry of it — to a single version (docs/protocol.md
        # "Fleet & versioned serving"); taken in one lock acquisition so
        # a concurrent rollout cannot drain-and-retire the version
        # between the read and the refcount.
        version, epoch, reg_name = self._table.acquire(model)
        t0 = time.perf_counter()
        key = self._route_key(route_key)
        last_err: Optional[BaseException] = None
        tried = 0
        resynced = False
        attempts = self._attempts or len(self._table.ring.members)
        try:
            with journal.span(
                f"router.{kind}", model=model, version=version, epoch=epoch,
            ):
                for rk in self._candidates(key):
                    if tried >= attempts:
                        break
                    tried += 1
                    repaired = False
                    self._table.begin_replica(rk)
                    try:
                        while True:
                            try:
                                out = attempt_fn(
                                    self._client(rk), reg_name, version, epoch
                                )
                                self._table.mark_alive(rk)
                                self.stats[rk] = self.stats.get(rk, 0) + 1
                                _M_REQUESTS.inc(op=kind, outcome="ok")
                                return out
                            except DaemonBusy as e:
                                last_err = e
                                _M_FAILOVERS.inc(reason="busy")
                                break
                            except (OSError, protocol.ProtocolError) as e:
                                last_err = e
                                _M_FAILOVERS.inc(reason="dead")
                                self._table.mark_dead(
                                    rk, str(e), self._poll_s
                                )
                                break
                            except RuntimeError as e:
                                last_err = e
                                msg = str(e)
                                if (
                                    not repaired
                                    and "no such model" in msg
                                    and self._repair(rk, model, version)
                                ):
                                    repaired = True
                                    continue  # retry THIS replica once
                                if (
                                    not resynced
                                    and ("version mismatch" in msg
                                         or "no such model" in msg)
                                    and self._resync(rk, model)
                                ):
                                    # The replica refused because OUR
                                    # pin is stale (a rollout flipped
                                    # while this client slept). Re-pin
                                    # on the resynced table — acquire
                                    # the NEW version before releasing
                                    # the old, so the drain refcounts
                                    # stay exactly-once — and retry
                                    # this replica on the fresh pin.
                                    resynced = True
                                    try:
                                        nv, ne, nr = (
                                            self._table.acquire(model)
                                        )
                                    except KeyError:
                                        _M_FAILOVERS.inc(reason="error")
                                        break
                                    self._table.done(model, version)
                                    version, epoch, reg_name = nv, ne, nr
                                    continue
                                _M_FAILOVERS.inc(reason="error")
                                break
                    finally:
                        self._table.done_replica(rk)
            _M_REQUESTS.inc(op=kind, outcome="unroutable")
            raise FleetUnavailable(
                f"no replica could serve {kind} for {model!r} v{version} "
                f"({tried} attempt(s); last error: {last_err})"
            ) from last_err
        finally:
            self._table.done(model, version)
            _M_REQ_SECONDS.observe(time.perf_counter() - t0, op=kind)
