"""Fleet control plane: replicated models and zero-downtime version rollout.

The port's copy of ``spark_rapids_ml_tpu/serve/fleet.py``.
``serve/router.py`` routes requests; this module manages what they route
to: one model registered as versioned replicas on N daemons, and the
register → warm → flip → drain sequence that swaps a live model version
without dropping a request (docs/protocol.md "Fleet & versioned serving").

The lifecycle of one rollout, v1 → v2:

1. **register v2** under its versioned daemon name (``model@v2``, the
   routing table's ``reg_name``) on every live replica. v1 keeps serving;
   a replica that fails the registration is marked dead (the router skips
   it) and the rollout goes on with the rest.
2. **warm** each registration through the daemon's ``warmup`` op (the
   serving scheduler's bucket ladder), so the first routed v2 request is a
   dispatch of a seen shape. A daemon with batching off answers it as a
   no-op.
3. **atomically flip**: one ``RoutingTable.activate`` moves the active
   version and bumps the fleet epoch. Requests that took their snapshot
   before the flip finish on v1 (their pinned version); later ones route
   to v2. The versioned daemon names make a cross-version answer
   impossible.
4. **drain v1**: wait (``fleet_drain_timeout_s``) for v1's in-flight
   count to reach zero, then ``drop_model`` v1 everywhere and retire it
   from the table. A drain timeout leaves v1 registered rather than pull
   its arrays from under a live request.

Each phase's intent is gossiped before the phase runs (``fleet.rollout``
fault site right after), so a successor controller bootstrapped from one
seed (:meth:`ModelFleet.from_seeds`) completes or aborts a rollout whose
controller died (:meth:`ModelFleet.resume_rollout`).

Beyond the reference: the port's daemon registers and warms an exact index
(algo ``"knn"``), and its ``_model_width`` gives one a width, so a rollout
of an index is warmed where the reference skips the warmup. A successor
bootstrapped by :meth:`ModelFleet.from_seeds` advances its gossip clock to
the seed view's epoch, so its first gossiped write dominates the records
it read even when the controller is a fresh process.

``ModelFleet`` is single-threaded, like the admin clients it holds.
Serving traffic goes through ``fleet.client()``: one
:class:`~.router.FleetClient` per worker thread, all sharing this fleet's
routing table and health view.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import gossip as gossip_mod
from spark_rapids_ml_tpu_torch.serve import protocol
from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
from spark_rapids_ml_tpu_torch.serve.daemon import _model_width
from spark_rapids_ml_tpu_torch.serve.router import (
    FleetClient,
    RoutingTable,
    bootstrap_table,
)
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils import flight
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.fleet")

__all__ = ["ModelFleet", "FleetRolloutError"]

#: Fleet control-plane telemetry (docs/observability.md).
_M_REPLICAS = metrics_mod.gauge(
    "srml_fleet_replicas",
    "Replicas serving a model's active version, by model (set at "
    "register/rollout time)",
)
_M_EPOCH = metrics_mod.gauge(
    "srml_fleet_version_epoch",
    "The fleet routing epoch, by model (bumps on every version flip)",
)
_M_REGISTRATIONS = metrics_mod.counter(
    "srml_fleet_registrations_total",
    "Per-replica version registrations, by outcome (ok|error)",
)
_M_ROLLOUTS = metrics_mod.counter(
    "srml_fleet_rollouts_total",
    "Version rollouts, by outcome (ok|partial — some replica failed "
    "registration and was routed around)",
)
_M_DRAINS = metrics_mod.counter(
    "srml_fleet_drains_total",
    "Retired-version drains, by outcome (drained|timeout)",
)


class FleetRolloutError(RuntimeError):
    """No replica accepted the new version — the rollout did NOT flip;
    the old version keeps serving."""




class ModelFleet:
    """Replicated versioned model serving across N daemons.

    ``endpoints``: ``[(host, port)]`` (or ``"host:port"`` strings) of
    the replica daemons. All replicas are equals — there is no primary;
    the consistent-hash ring (router.py) spreads models and traffic.
    """

    def __init__(
        self,
        endpoints=None,
        token: Optional[str] = None,
        vnodes: Optional[int] = None,
        client_kwargs: Optional[Dict[str, Any]] = None,
        table: Optional[RoutingTable] = None,
    ):
        if table is None:
            table = RoutingTable(endpoints, vnodes=vnodes)
        elif endpoints is not None:
            raise ValueError("pass endpoints OR a pre-built table, not both")
        self._table = table
        self._token = token
        # Admin-op client settings: fail a dead replica in seconds (it
        # gets marked dead and routed around), don't heal for minutes.
        kw: Dict[str, Any] = {
            "timeout": 10.0, "op_deadline_s": 20.0, "max_op_attempts": 2,
        }
        kw.update(client_kwargs or {})
        self._client_kwargs = kw
        self._clients: Dict[str, DataPlaneClient] = {}
        self._lock = threading.Lock()  # serializes admin ops per fleet
        # Gossip half (serve/gossip.py): the controller keeps its own
        # FleetView and pushes every control-plane write (registration,
        # each rollout phase's intent, membership changes) to the
        # replicas, which gossip it onward — so the fleet's state
        # SURVIVES this object. A successor controller rebuilds from
        # any one daemon (from_seeds) and resumes (resume_rollout).
        self._view = gossip_mod.FleetView()
        self._controller_id = f"ctl-{uuid.uuid4().hex[:12]}"
        self._identities: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def from_seeds(
        cls,
        seeds=None,
        token: Optional[str] = None,
        vnodes: Optional[int] = None,
        client_kwargs: Optional[Dict[str, Any]] = None,
    ) -> "ModelFleet":
        """A control plane bootstrapped from ONE seed daemon's gossiped
        FleetView (router.bootstrap_table) — how a SUCCESSOR controller
        (or any operator tool) takes over a running fleet with no
        endpoint roster and no surviving predecessor. Version entries
        adopted this way are payload-less; serving keeps working, and
        :meth:`resume_rollout` can finish or abort an interrupted
        rollout from the gossiped intent."""
        t = bootstrap_table(seeds, token=token, vnodes=vnodes)
        fleet = cls(token=token, client_kwargs=client_kwargs, table=t)
        # The Lamport receive rule for the view the table was built from:
        # without it a controller in a fresh process stamps its first
        # write (a rollout's "registering" intent) below the records the
        # replicas hold, and the fleet keeps theirs.
        fleet._view.merge({"epoch": t.view_epoch})
        return fleet

    # -- lifecycle ---------------------------------------------------------

    @property
    def table(self) -> RoutingTable:
        return self._table

    @property
    def view(self) -> gossip_mod.FleetView:
        """The controller's own gossiped FleetView (tools/top, the
        autoscaler's membership telemetry)."""
        return self._view

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
        self._clients.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def client(self, **kwargs) -> FleetClient:
        """A routing client sharing this fleet's table and health view.
        One per worker thread (FleetClient is single-threaded)."""
        kwargs.setdefault("token", self._token)
        return FleetClient(self._table, **kwargs)

    def _client(self, key: str) -> DataPlaneClient:
        c = self._clients.get(key)
        if c is None:
            r = self._table.replica(key)
            c = DataPlaneClient(
                r.host, r.port, token=self._token, **self._client_kwargs
            )
            self._clients[key] = c
        return c

    # -- gossip sync (serve/gossip.py; docs/protocol.md) --------------------

    def _refresh_replica_records(self) -> None:
        """Write the table's CURRENT members into the controller's view
        as replica records (identity pulled once per replica and
        cached). A replica whose identity cannot be read is skipped —
        the daemons' own start()-time records cover it via gossip."""
        for r in self._table.replicas():
            ident = self._identities.get(r.key)
            if ident is None:
                try:
                    ident = self._client(r.key).server_info()
                except (OSError, protocol.ProtocolError, RuntimeError):
                    continue
                self._identities[r.key] = ident
            sid = str(ident.get("id") or r.key)
            self._view.observe_replica(
                sid, r.key, str(ident.get("boot_id") or ""), liveness="up"
            )

    def _push_view(self) -> int:
        """Push the controller's FleetView to every live replica and
        merge each ack's view back (push-pull), best effort per
        replica. With per-daemon gossip threads running this just
        shortens convergence; with them disabled
        (``gossip_interval_s=0`` — unit tests, single-host fleets) this
        synchronous push IS the gossip. Returns replicas reached."""
        self._refresh_replica_records()
        wire = self._view.to_wire()
        pushed = 0
        for r in self._table.replicas():
            try:
                ack = self._client(r.key).gossip_push(wire)
            except (OSError, protocol.ProtocolError, RuntimeError) as e:
                logger.warning(
                    "gossip push to replica %s failed (its own gossip "
                    "thread will catch it up): %s", r.key, e,
                )
                continue
            remote = ack.get("view")
            if isinstance(remote, dict):
                self._view.merge(remote)
            pushed += 1
        return pushed

    def _publish_model(
        self, model: str, tombstone_versions=(),
    ) -> None:
        """Gossip one model's CURRENT table state — active version,
        fleet epoch, rollout intent (None = no rollout in flight) —
        to the fleet."""
        try:
            v, e, _ = self._table.snapshot(model)
        except KeyError:
            v, e = None, 0
        self._view.set_model(
            model, v, e, self._controller_id,
            intent=self._table.intent(model),
            tombstone_versions=tuple(tombstone_versions),
        )
        self._push_view()

    def _set_intent(
        self, model: str, from_v: Optional[int], to_v: int, phase: str,
    ) -> None:
        """Write + gossip a rollout-intent record BEFORE the phase it
        names runs, then cross the ``fleet.rollout`` fault site — the
        crash-safety contract: a controller that dies inside any phase
        has already told the fleet what it was doing, so a successor
        can complete or abort (docs/protocol.md "Fleet gossip &
        bootstrap")."""
        self._table.set_intent(model, {
            "model": model,
            "from_version": None if from_v is None else int(from_v),
            "to_version": int(to_v),
            "phase": phase,
            "by": self._controller_id,
            "at": float(time.time()),
        })
        self._publish_model(model)
        faults.checkpoint("fleet.rollout")

    # -- registration + rollout --------------------------------------------

    def _register_on_replicas(
        self, model: str, version: int, algo: str,
        arrays: Dict[str, np.ndarray], params: Dict[str, Any],
        warm: bool,
    ) -> Dict[str, List[str]]:
        """Register (and optionally warm) one version on every replica.
        Returns {"ok": [replica keys], "failed": [replica keys]}; failed
        replicas are marked dead so the router skips them."""
        reg_name = self._table.reg_name(model, version)
        # The daemon's own registration-width rule (ONE copy — a drifted
        # mirror here would silently skip the warmup for an algo whose
        # payload key changed); None skips the eager warmup.
        width = _model_width(algo, arrays)
        ok: List[str] = []
        failed: List[str] = []
        for r in self._table.replicas():
            try:
                c = self._client(r.key)
                c.ensure_model(
                    reg_name, algo, arrays, params=params, version=version,
                )
                if warm and width is not None:
                    # The scheduler's bucket ladder, warmed; with
                    # batching off the daemon answers a no-op.
                    c.warmup(reg_name, n_cols=width, dtype="float32")
                self._table.mark_alive(r.key)
                _M_REGISTRATIONS.inc(outcome="ok")
                ok.append(r.key)
            except (OSError, protocol.ProtocolError, RuntimeError) as e:
                _M_REGISTRATIONS.inc(outcome="error")
                self._table.mark_dead(
                    r.key, f"registration of {reg_name} failed: {e}",
                    recheck_s=1.0,
                )
                logger.warning(
                    "replica %s failed %s v%d registration (marked dead, "
                    "routing around it): %s", r.key, model, version, e,
                )
                failed.append(r.key)
        return {"ok": ok, "failed": failed}

    def register(
        self,
        model: str,
        algo: str,
        arrays: Dict[str, np.ndarray],
        params: Optional[Dict[str, Any]] = None,
        version: int = 1,
        warm: bool = True,
    ) -> Dict[str, Any]:
        """Register a model's FIRST served version on every replica and
        activate it. Returns ``{"version", "epoch", "replicas",
        "failed"}``. Raises :class:`FleetRolloutError` when no replica
        accepted it (the table stays without an active version)."""
        with self._lock:
            version = int(version)
            self._table.install(model, version, algo, arrays, params)
            res = self._register_on_replicas(
                model, version, algo, arrays, dict(params or {}), warm
            )
            if not res["ok"]:
                self._table.retire(model, version)
                raise FleetRolloutError(
                    f"no replica accepted {model!r} v{version} "
                    f"({len(res['failed'])} failed)"
                )
            epoch = self._table.activate(model, version)
            _M_REPLICAS.set(len(res["ok"]), model=model)
            _M_EPOCH.set(epoch, model=model)
            # Gossip the new model record so a client can bootstrap
            # (and a restarted replica re-learn) from any daemon.
            self._publish_model(model)
            return {
                "version": version, "epoch": epoch,
                "replicas": len(res["ok"]), "failed": res["failed"],
            }

    def rollout(
        self,
        model: str,
        algo: str,
        arrays: Dict[str, np.ndarray],
        params: Optional[Dict[str, Any]] = None,
        version: Optional[int] = None,
        warm: bool = True,
        drain_timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Zero-downtime version swap (module docstring): register the
        next version everywhere, warm it, atomically flip, drain and
        drop the old one. Returns ``{"version", "previous", "epoch",
        "replicas", "failed", "drained"}``."""
        with self._lock:
            old_v, _, old_reg = self._table.snapshot(model)
            new_v = int(version) if version is not None else old_v + 1
            if new_v == old_v:
                raise ValueError(
                    f"rollout version {new_v} is already the active "
                    f"version of {model!r}"
                )
            # Every phase below gossips its intent BEFORE it runs
            # (_set_intent): a controller that dies mid-phase leaves a
            # record any successor can act on — registering/warming
            # abort cleanly (nothing flipped), flipped/draining
            # complete (resume_rollout).
            self._set_intent(model, old_v, new_v, "registering")
            self._table.install(model, new_v, algo, arrays, params)
            res = self._register_on_replicas(
                model, new_v, algo, arrays, dict(params or {}), warm=False
            )
            if not res["ok"]:
                # Nothing flipped: v_old keeps serving, the failed
                # install is retired so a retry starts clean.
                self._table.retire(model, new_v)
                self._table.set_intent(model, None)
                self._publish_model(model)
                _M_ROLLOUTS.inc(outcome="error")
                # An aborted rollout is an incident: snapshot the
                # context NOW, while the failed registrations are still
                # in the span ring (no-op without a default recorder).
                flight.record("rollout_abort", {
                    "model": model, "phase": "registering",
                    "version": new_v, "failed": list(res["failed"]),
                })
                raise FleetRolloutError(
                    f"no replica accepted {model!r} v{new_v}; "
                    f"v{old_v} keeps serving"
                )
            if warm:
                self._set_intent(model, old_v, new_v, "warming")
                width = _model_width(algo, arrays)
                if width is not None:
                    reg_name = self._table.reg_name(model, new_v)
                    for key in list(res["ok"]):
                        try:
                            self._client(key).warmup(
                                reg_name, n_cols=width, dtype="float32"
                            )
                        except (OSError, protocol.ProtocolError,
                                RuntimeError) as e:
                            # Same policy as a failed registration:
                            # mark it dead and route around it.
                            self._table.mark_dead(
                                key, f"warmup of {reg_name} failed: {e}",
                                recheck_s=1.0,
                            )
                            res["ok"].remove(key)
                            res["failed"].append(key)
                    if not res["ok"]:
                        self._table.retire(model, new_v)
                        self._table.set_intent(model, None)
                        self._publish_model(model)
                        _M_ROLLOUTS.inc(outcome="error")
                        flight.record("rollout_abort", {
                            "model": model, "phase": "warming",
                            "version": new_v,
                            "failed": list(res["failed"]),
                        })
                        raise FleetRolloutError(
                            f"every replica failed warming {model!r} "
                            f"v{new_v}; v{old_v} keeps serving"
                        )
            # THE flip: one atomic table write. Every request from here
            # snapshots v_new; every in-flight request keeps its v_old
            # pin and its v_old daemon registration.
            self._set_intent(model, old_v, new_v, "flipped")
            epoch = self._table.activate(model, new_v)
            _M_REPLICAS.set(len(res["ok"]), model=model)
            _M_EPOCH.set(epoch, model=model)
            _M_ROLLOUTS.inc(outcome="ok" if not res["failed"] else "partial")
            logger.info(
                "flipped %s to v%d (epoch %d) on %d replica(s)",
                model, new_v, epoch, len(res["ok"]),
            )
            # Drain: let pinned v_old requests finish before their
            # arrays are dropped. A timeout leaves v_old registered —
            # stale registrations cost memory, yanked arrays cost
            # correctness.
            self._set_intent(model, old_v, new_v, "draining")
            timeout = float(
                config.get("fleet_drain_timeout_s")
                if drain_timeout_s is None else drain_timeout_s
            )
            drained = self._table.wait_drained(model, old_v, timeout)
            _M_DRAINS.inc(outcome="drained" if drained else "timeout")
            if drained:
                for r in self._table.replicas():
                    try:
                        self._client(r.key).drop_model(old_reg)
                    except (OSError, protocol.ProtocolError, RuntimeError):
                        pass  # dead replica: its registry died with it
                self._table.retire(model, old_v)
            else:
                logger.warning(
                    "drain of %s v%d timed out after %.1fs with %d "
                    "request(s) in flight; its registrations stay up",
                    model, old_v, timeout,
                    self._table.inflight(model, old_v),
                )
            # Rollout finished: clear the gossiped intent, tombstone
            # the drained version so no bootstrap re-adopts it.
            self._table.set_intent(model, None)
            self._publish_model(
                model, tombstone_versions=((old_v,) if drained else ()),
            )
            return {
                "version": new_v, "previous": old_v, "epoch": epoch,
                "replicas": len(res["ok"]), "failed": res["failed"],
                "drained": drained,
            }

    def resume_rollout(
        self,
        model: str,
        drain_timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Finish — or cleanly abort — a rollout whose controller died,
        from the gossiped ``rollout_intent`` record (usually on a fleet
        built with :meth:`from_seeds`). The intent's phase decides:

        * ``registering``/``warming`` — nothing flipped; ABORT: drop
          the half-registered to-version everywhere, clear the intent.
          The old version never stopped serving.
        * ``flipped``/``draining`` — the fleet was told the flip was
          happening; COMPLETE: make the to-version active (the flip is
          idempotent — re-activating the already-active version just
          re-bumps the epoch), drain and drop the from-version, clear
          the intent.

        Returns ``{"action": "aborted"|"completed"|"none", ...}``.
        """
        with self._lock:
            intent = self._table.intent(model)
            if not intent:
                return {"action": "none", "model": model}
            phase = str(intent.get("phase") or "")
            to_v = int(intent["to_version"])
            from_v = intent.get("from_version")
            from_v = None if from_v is None else int(from_v)
            if phase in ("registering", "warming"):
                reg = self._table.reg_name(model, to_v)
                for r in self._table.replicas():
                    try:
                        self._client(r.key).drop_model(reg)
                    except (OSError, protocol.ProtocolError, RuntimeError):
                        pass  # never registered there, or dead replica
                try:
                    self._table.retire(model, to_v)
                except (KeyError, ValueError):
                    pass  # never installed locally (successor table)
                self._table.set_intent(model, None)
                self._publish_model(model, tombstone_versions=(to_v,))
                logger.warning(
                    "aborted interrupted rollout of %s to v%d (died in "
                    "phase %r before the flip); v%s keeps serving",
                    model, to_v, phase, from_v,
                )
                flight.record("rollout_abort", {
                    "model": model, "phase": phase, "version": to_v,
                    "previous": from_v, "via": "resume_rollout",
                })
                return {
                    "action": "aborted", "model": model, "phase": phase,
                    "version": to_v, "previous": from_v,
                }
            if phase not in ("flipped", "draining"):
                raise ValueError(
                    f"unknown rollout-intent phase {phase!r} for "
                    f"{model!r}"
                )
            self._table.ensure_version(model, to_v)
            try:
                cur_v, epoch, _ = self._table.snapshot(model)
            except KeyError:
                cur_v, epoch = None, 0
            if cur_v != to_v:
                epoch = self._table.activate(model, to_v)
            # Publish the (re-)flip BEFORE dropping the from-version's
            # registrations: a client still pinned to it that races the
            # drop resyncs from a view that already names the new
            # active, instead of re-pinning the version being dropped.
            self._publish_model(model)
            timeout = float(
                config.get("fleet_drain_timeout_s")
                if drain_timeout_s is None else drain_timeout_s
            )
            drained = True
            if from_v is not None:
                drained = self._table.wait_drained(model, from_v, timeout)
                _M_DRAINS.inc(outcome="drained" if drained else "timeout")
                if drained:
                    old_reg = self._table.reg_name(model, from_v)
                    for r in self._table.replicas():
                        try:
                            self._client(r.key).drop_model(old_reg)
                        except (OSError, protocol.ProtocolError,
                                RuntimeError):
                            pass
                    try:
                        self._table.retire(model, from_v)
                    except (KeyError, ValueError):
                        pass
            self._table.set_intent(model, None)
            _M_EPOCH.set(epoch, model=model)
            self._publish_model(
                model,
                tombstone_versions=(
                    (from_v,) if drained and from_v is not None else ()
                ),
            )
            logger.warning(
                "completed interrupted rollout of %s to v%d (died in "
                "phase %r after the flip; drained=%s)",
                model, to_v, phase, drained,
            )
            return {
                "action": "completed", "model": model, "phase": phase,
                "version": to_v, "previous": from_v, "epoch": epoch,
                "drained": drained,
            }

    # -- elastic membership (serve/autoscaler.py drives these) --------------

    def scale_out(self, endpoint, warm: bool = True) -> Dict[str, Any]:
        """Admit a new replica daemon into the fleet: register AND warm
        every model's ACTIVE version on it first, then add it to the
        ring — admission is the flip (router.RoutingTable.add_replica),
        so the first request routed to the newcomer finds a warm
        registration. The payloads come from the routing table's
        version entries (the same source the in-band repair uses); a
        newcomer that fails any registration is NOT admitted."""
        if isinstance(endpoint, str):
            host, _, port = endpoint.rpartition(":")
            host, port = host or "127.0.0.1", int(port)
        else:
            host, port = endpoint[0], int(endpoint[1])
        key = f"{host}:{port}"
        with self._lock:
            seeded: List[str] = []
            c = DataPlaneClient(
                host, port, token=self._token, **self._client_kwargs
            )
            try:
                for model in self._table.models():
                    v, _, reg_name = self._table.snapshot(model)
                    info = self._table.version_info(model, v)
                    c.ensure_model(
                        reg_name, info["algo"], info["arrays"],
                        params=info["params"], version=v,
                    )
                    width = _model_width(info["algo"], info["arrays"])
                    if warm and width is not None:
                        c.warmup(reg_name, n_cols=width, dtype="float32")
                    _M_REGISTRATIONS.inc(outcome="ok")
                    seeded.append(model)
            except (OSError, protocol.ProtocolError, RuntimeError) as e:
                _M_REGISTRATIONS.inc(outcome="error")
                c.close()
                raise FleetRolloutError(
                    f"replica {key} failed pre-admission seeding of "
                    f"{model!r} — not admitted: {e}"
                ) from e
            self._table.add_replica((host, port))
            self._clients[key] = c
            n = len(self._table.replicas())
            for model in seeded:
                _M_REPLICAS.set(n, model=model)
            logger.info(
                "scaled OUT: replica %s admitted with %d model(s) "
                "seeded and warm (%d replicas in the ring)",
                key, len(seeded), n,
            )
            # Gossip the grown membership (and seed the newcomer's view
            # with the fleet's model records in the same push).
            self._push_view()
            return {"replica": key, "models": seeded, "replicas": n}

    def scale_in(
        self,
        key: Optional[str] = None,
        drain_timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Retire one replica without dropping a request: remove it
        from the ring (no NEW request routes to it), then roll every
        active model forward one version on the REMAINING replicas —
        the rollout's drain barrier waits out every request pinned to
        the old version, including those in flight on the victim, and
        only then drops the old registrations. Returns ``{"replica",
        "drained", "rollouts"}``; ``drained=False`` means some pinned
        request outlived the timeout — the victim daemon must stay UP
        until a later drain finishes (stopping it would be the dropped
        request the barrier exists to prevent).

        With no ``key`` the least-loaded live replica is chosen."""
        if key is None:
            live = [r for r in self._table.replicas() if r.alive]
            if not live:
                raise ValueError("no live replica to scale in")
            key = min(live, key=lambda r: (r.load(), r.key)).key
        # Capture the victim's gossip identity while it is still a
        # member — its record must flip to a tombstone, not vanish.
        victim = self._identities.get(key)
        if victim is None:
            try:
                victim = self._client(key).server_info()
            except (OSError, protocol.ProtocolError, RuntimeError):
                victim = None
        self._table.remove_replica(key)
        rollouts: Dict[str, Any] = {}
        drained = True
        for model in self._table.models():
            v, _, _ = self._table.snapshot(model)
            info = self._table.version_info(model, v)
            res = self.rollout(
                model, info["algo"], info["arrays"],
                params=info["params"], drain_timeout_s=drain_timeout_s,
            )
            rollouts[model] = res
            drained = drained and bool(res["drained"])
        with self._lock:
            c = self._clients.pop(key, None)
            if c is not None:
                c.close()
            self._identities.pop(key, None)
            if victim is not None and victim.get("id"):
                self._view.tombstone_replica(str(victim["id"]))
            n = len(self._table.replicas())
            # Gossip the shrunk membership so no bootstrapping client
            # ever admits the retiree into its ring again.
            self._push_view()
        logger.info(
            "scaled IN: replica %s retired (%d replicas remain; "
            "drained=%s)", key, n, drained,
        )
        return {
            "replica": key, "drained": drained, "rollouts": rollouts,
            "replicas": n,
        }

    # -- observability ------------------------------------------------------

    def status(self, model: Optional[str] = None) -> Dict[str, Any]:
        """Operator view: per-replica liveness/health plus (with
        ``model``) which replicas hold the active version's
        registration. Polls health live; a dead replica reports its
        last error instead."""
        versions: Dict[str, Any] = {}
        reg_name = None
        if model is not None:
            try:
                v, e, reg_name = self._table.snapshot(model)
                versions = {
                    "active": v, "epoch": e,
                    "installed": self._table.versions(model),
                }
            except KeyError:
                versions = {"active": None, "epoch": 0, "installed": []}
        replicas = {}
        for r in self._table.replicas():
            entry: Dict[str, Any] = {"alive": r.alive}
            try:
                h = self._client(r.key).health()
                self._table.mark_alive(r.key, h)
                entry["alive"] = True
                entry["health"] = {
                    k: h.get(k) for k in
                    ("id", "boot_id", "queue_depth", "served_models", "busy")
                }
                if reg_name is not None:
                    entry["has_active_version"] = bool(
                        self._client(r.key).model_exists(reg_name)
                    )
            except (OSError, protocol.ProtocolError, RuntimeError) as e:
                self._table.mark_dead(r.key, str(e), recheck_s=1.0)
                entry["alive"] = False
                entry["error"] = str(e)
            replicas[r.key] = entry
        out: Dict[str, Any] = {"replicas": replicas}
        if model is not None:
            out["model"] = {"name": model, **versions}
        return out
