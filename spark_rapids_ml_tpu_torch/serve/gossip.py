"""Gossiped fleet state: the daemon-resident ``FleetView``.

The port's copy of ``spark_rapids_ml_tpu/serve/gossip.py`` (standard
library only). Every :class:`~.daemon.DataPlaneDaemon` keeps a
:class:`FleetView` (replica records plus the per-model version table) and
exchanges it with ``gossip_fanout`` peers every ``gossip_interval_s`` over
the ``gossip_push``/``gossip_pull`` wire ops (docs/protocol.md "Fleet
gossip & bootstrap"). Clients are stateless observers: a
:class:`~.router.FleetClient` bootstraps its routing table from ONE seed
daemon's view and resyncs from whichever replica answers it.

The merge rule, per record, is ``(epoch, boot_id)`` dominance:

* Every record carries the ``epoch`` it was written at, minted from the
  membership epoch plane (``parallel/membership.py``: gossip writes and
  join/leave/reboot bumps share one Lamport counter a process, and
  :meth:`FleetView.merge` runs the Lamport receive rule, so the local
  clock advances past every remote record it has seen).
* The record with the strictly higher epoch wins; an epoch tie breaks on
  ``boot_id`` (lexicographic: the same arbitrary choice everywhere, so two
  islands healing a partition converge on one winner).
* Deletions are tombstones, never absences: a retired replica keeps a
  ``liveness="tombstone"`` record, a retired model version an entry in the
  model record's ``tombstones`` map, each at the epoch of its retirement.
  Resurrecting one needs a strictly newer epoch (a genuine re-join), so a
  stale island never gossips a dead thing back. Tombstones are pruned
  after ``gossip_tombstone_ttl_s``, which must exceed any partition.

Each tick a daemon pushes its view to ``gossip_fanout`` peers and merges
the peer's view from the ack (push-pull in one round trip), so a write
reaches the fleet within ``gossip_interval_s`` × the ring's diameter.

Threads: a ``FleetView`` is shared by the daemon's connection threads,
its gossip thread and in-process control planes. Its state lives behind
``self._lock``, a leaf lock: no method calls out (no sockets, no device
work, no other lock) while holding it; epochs are minted outside it.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.parallel import membership as membership_mod
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

__all__ = ["FleetView", "dominates"]

#: Gossip telemetry (docs/observability.md).
_M_MERGES = metrics_mod.counter(
    "srml_gossip_merges_total",
    "FleetView records adopted from a merged remote view, by kind "
    "(replica|model) — zero-adoption merges mean the views agree",
)
_M_VIEW_EPOCH = metrics_mod.gauge(
    "srml_gossip_view_epoch",
    "Highest record epoch in this process's FleetView (converged "
    "fleets report one value everywhere)",
)

#: Liveness states a replica record may carry. ``tombstone`` is the
#: retired state — it gossips like any record and never resurrects.
_LIVENESS = ("up", "down", "tombstone")


def dominates(a_epoch: int, a_boot: str, b_epoch: int, b_boot: str) -> bool:
    """The ONE merge rule: does record A dominate record B?
    ``(epoch, boot_id)`` lexicographic — strictly higher epoch wins,
    ties break on boot_id so every process picks the same winner."""
    return (int(a_epoch), str(a_boot)) > (int(b_epoch), str(b_boot))


class FleetView:
    """One process's view of the fleet: replica records keyed by
    ``server_id`` plus the per-model version table, every record
    stamped ``(epoch, boot_id)`` for the dominance merge.

    ``epoch_source``: the shared Lamport clock — anything with
    ``tick()``/``observe()`` (defaults to the process-wide
    :func:`~spark_rapids_ml_tpu_torch.parallel.membership.registry`).
    """

    #: Wire-format version of ``to_wire`` (additive evolution only,
    #: like the protocol itself).
    WIRE_V = 1

    def __init__(
        self,
        epoch_source=None,
        tombstone_ttl_s: Optional[float] = None,
        clock=time.time,
    ):
        self._epochs = (
            membership_mod.registry() if epoch_source is None else epoch_source
        )
        self._ttl = float(
            config.get("gossip_tombstone_ttl_s")
            if tombstone_ttl_s is None else tombstone_ttl_s
        )
        self._clock = clock
        self._lock = threading.Lock()
        #: server_id → {"server_id","addr","boot_id","liveness",
        #:              "last_seen","epoch"}
        self._replicas: Dict[str, Dict[str, Any]] = {}
        #: model → {"model","active_version","fleet_epoch","intent",
        #:          "tombstones": {str(version): {"epoch","at"}},
        #:          "epoch","boot_id"}
        self._models: Dict[str, Dict[str, Any]] = {}

    # -- local writes (each mints a fresh epoch OUTSIDE the lock) -----------

    def observe_replica(
        self,
        server_id: str,
        addr: str,
        boot_id: str,
        liveness: str = "up",
        epoch: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Write (or refresh) one replica record at a freshly minted
        epoch. ``epoch`` overrides only for record REPLAY (tests, the
        control plane echoing a record it already holds)."""
        if liveness not in _LIVENESS:
            raise ValueError(
                f"unknown liveness {liveness!r} (one of {_LIVENESS})"
            )
        e = self._epochs.tick() if epoch is None else int(epoch)
        rec = {
            "server_id": str(server_id),
            "addr": str(addr),
            "boot_id": str(boot_id),
            "liveness": liveness,
            "last_seen": float(self._clock()),
            "epoch": e,
        }
        with self._lock:
            self._replicas[str(server_id)] = rec
            self._refresh_epoch_gauge_locked()
        return dict(rec)

    def tombstone_replica(self, server_id: str) -> None:
        """Retire a replica: its record flips to a tombstone at a fresh
        epoch (it keeps gossiping — absence would let a stale island
        resurrect it)."""
        e = self._epochs.tick()
        with self._lock:
            rec = self._replicas.get(str(server_id))
            if rec is None:
                rec = {
                    "server_id": str(server_id), "addr": "",
                    "boot_id": "", "liveness": "tombstone",
                    "last_seen": float(self._clock()), "epoch": e,
                }
                self._replicas[str(server_id)] = rec
            else:
                rec["liveness"] = "tombstone"
                rec["last_seen"] = float(self._clock())
                rec["epoch"] = e
            self._refresh_epoch_gauge_locked()

    def set_model(
        self,
        model: str,
        active_version: Optional[int],
        fleet_epoch: int,
        boot_id: str,
        intent: Optional[Dict[str, Any]] = None,
        tombstone_versions: Tuple[int, ...] = (),
    ) -> Dict[str, Any]:
        """Write one model's version-table record (active version, the
        model's own fleet epoch from the rollout flip, and the current
        ``rollout_intent`` — None when no rollout is in flight) at a
        fresh gossip epoch. ``tombstone_versions`` adds retired
        versions to the record's tombstone map (they never re-install
        on a bootstrap)."""
        e = self._epochs.tick()
        now = float(self._clock())
        with self._lock:
            prev = self._models.get(str(model)) or {}
            tombs = dict(prev.get("tombstones") or {})
            for v in tombstone_versions:
                tombs[str(int(v))] = {"epoch": e, "at": now}
            rec = {
                "model": str(model),
                "active_version": (
                    None if active_version is None else int(active_version)
                ),
                "fleet_epoch": int(fleet_epoch),
                "intent": copy.deepcopy(intent) if intent else None,
                "tombstones": tombs,
                "epoch": e,
                "boot_id": str(boot_id),
            }
            self._models[str(model)] = rec
            self._refresh_epoch_gauge_locked()
        return copy.deepcopy(rec)

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Deep copy of the whole view (tools/top, tests)."""
        with self._lock:
            return {
                "epoch": self._max_epoch_locked(),
                "replicas": copy.deepcopy(self._replicas),
                "models": copy.deepcopy(self._models),
            }

    def replicas(self, liveness: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = [copy.deepcopy(r) for r in self._replicas.values()]
        if liveness is not None:
            recs = [r for r in recs if r["liveness"] == liveness]
        return sorted(recs, key=lambda r: r["server_id"])

    def model(self, model: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._models.get(str(model))
            return None if rec is None else copy.deepcopy(rec)

    def epoch(self) -> int:
        """Highest record epoch held — the convergence probe: two views
        that agree report the same value (srml_gossip_view_epoch)."""
        with self._lock:
            return self._max_epoch_locked()

    def _max_epoch_locked(self) -> int:
        epochs = [int(r["epoch"]) for r in self._replicas.values()]
        epochs += [int(m["epoch"]) for m in self._models.values()]
        for m in self._models.values():
            epochs += [int(t["epoch"]) for t in (m.get("tombstones") or {}).values()]
        return max(epochs, default=0)

    def _refresh_epoch_gauge_locked(self) -> None:
        _M_VIEW_EPOCH.set(self._max_epoch_locked())

    # -- wire codec ----------------------------------------------------------

    def to_wire(self) -> Dict[str, Any]:
        """JSON-safe view for the ``gossip_push``/``gossip_pull`` acks
        (docs/protocol.md has the schema)."""
        snap = self.snapshot()
        return {
            "wire_v": self.WIRE_V,
            "epoch": snap["epoch"],
            "replicas": snap["replicas"],
            "models": snap["models"],
        }

    # -- anti-entropy merge --------------------------------------------------

    def merge(self, wire: Dict[str, Any]) -> int:
        """Fold a remote view in under ``(epoch, boot_id)`` dominance;
        returns how many records were adopted (0 = the views already
        agreed on everything the remote carried). Malformed records are
        skipped — one bad peer must not poison the view. Runs the
        Lamport receive rule on the shared epoch plane FIRST (outside
        the view lock), so every local write after this merge dominates
        every record the remote view carried."""
        if not isinstance(wire, dict):
            return 0
        self._epochs.observe(int(wire.get("epoch") or 0))
        adopted_replicas = 0
        adopted_models = 0
        remote_reps = wire.get("replicas")
        remote_models = wire.get("models")
        with self._lock:
            if isinstance(remote_reps, dict):
                for sid, rec in remote_reps.items():
                    if self._merge_replica_locked(str(sid), rec):
                        adopted_replicas += 1
            if isinstance(remote_models, dict):
                for name, rec in remote_models.items():
                    if self._merge_model_locked(str(name), rec):
                        adopted_models += 1
            self._prune_tombstones_locked()
            self._refresh_epoch_gauge_locked()
        if adopted_replicas:
            _M_MERGES.inc(adopted_replicas, kind="replica")
        if adopted_models:
            _M_MERGES.inc(adopted_models, kind="model")
        return adopted_replicas + adopted_models

    def _merge_replica_locked(self, sid: str, rec: Any) -> bool:
        if not isinstance(rec, dict):
            return False
        try:
            incoming = {
                "server_id": sid,
                "addr": str(rec.get("addr") or ""),
                "boot_id": str(rec.get("boot_id") or ""),
                "liveness": str(rec.get("liveness") or "up"),
                "last_seen": float(rec.get("last_seen") or 0.0),
                "epoch": int(rec.get("epoch") or 0),
            }
        except (TypeError, ValueError):
            return False
        if incoming["liveness"] not in _LIVENESS:
            return False
        held = self._replicas.get(sid)
        if held is not None and not dominates(
            incoming["epoch"], incoming["boot_id"],
            held["epoch"], held["boot_id"],
        ):
            return False
        self._replicas[sid] = incoming
        return True

    def _merge_model_locked(self, name: str, rec: Any) -> bool:
        if not isinstance(rec, dict):
            return False
        try:
            av = rec.get("active_version")
            incoming = {
                "model": name,
                "active_version": None if av is None else int(av),
                "fleet_epoch": int(rec.get("fleet_epoch") or 0),
                "intent": (
                    copy.deepcopy(rec["intent"])
                    if isinstance(rec.get("intent"), dict) else None
                ),
                "tombstones": {},
                "epoch": int(rec.get("epoch") or 0),
                "boot_id": str(rec.get("boot_id") or ""),
            }
        except (TypeError, ValueError):
            return False
        held = self._models.get(name)
        # Tombstones merge by UNION-at-max-epoch regardless of which
        # record wins: a version retirement seen by EITHER side holds —
        # this is what "tombstones never resurrect" means across a
        # partition heal.
        tombs: Dict[str, Dict[str, Any]] = dict(
            (held or {}).get("tombstones") or {}
        )
        for v, t in (rec.get("tombstones") or {}).items():
            try:
                te = int((t or {}).get("epoch") or 0)
                ta = float((t or {}).get("at") or 0.0)
            except (TypeError, ValueError):
                continue
            mine = tombs.get(str(v))
            if mine is None or te > int(mine["epoch"]):
                tombs[str(v)] = {"epoch": te, "at": ta}
        adopted = held is None or dominates(
            incoming["epoch"], incoming["boot_id"],
            held["epoch"], held["boot_id"],
        )
        winner = incoming if adopted else held
        winner["tombstones"] = tombs
        # A STALE record pointing at a retired version degrades to "no
        # active version" rather than resurrecting it — but only when
        # the tombstone is NEWER than the record (Lamport order): a
        # record written after the tombstone that re-activates the same
        # version number is a genuine re-deploy, not a resurrection.
        av = winner.get("active_version")
        if av is not None:
            t = tombs.get(str(int(av)))
            if t is not None and int(t["epoch"]) > int(winner["epoch"]):
                winner["active_version"] = None
        self._models[name] = winner
        return bool(adopted)

    def _prune_tombstones_locked(self) -> None:
        """Drop tombstones older than the ttl (measured from their
        write time): they exist to outlive partitions, not forever. A
        ttl of 0 keeps them indefinitely."""
        if self._ttl <= 0:
            return
        cutoff = float(self._clock()) - self._ttl
        for sid in [
            s for s, r in self._replicas.items()
            if r["liveness"] == "tombstone" and r["last_seen"] < cutoff
        ]:
            del self._replicas[sid]
        for rec in self._models.values():
            tombs = rec.get("tombstones") or {}
            for v in [v for v, t in tombs.items() if float(t["at"]) < cutoff]:
                del tombs[v]
