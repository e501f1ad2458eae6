"""Mesh membership: which daemons are peers of one device plane.

The port's copy of ``spark_rapids_ml_tpu/parallel/membership.py``. The
on-mesh collective reduce only applies when the daemons involved in a fit
share one device plane (one ``torch.distributed`` world here). This
registry is the membership source of truth for that case: a daemon
registers ``(instance_id, boot_id)`` at ``start()`` and unregisters at
``stop()``, and the driver reads the snapshot to decide collective-vs-hub
per pass (the multi-daemon plane that reads it is a later slice).

Epoch fencing: EVERY membership change — join, leave, or re-registration
of an existing id (a reboot: same durable identity, new ``boot_id``) —
bumps a monotonically increasing ``epoch``. The driver stamps the epoch it
observed on each reduce request and the reduce refuses on any mismatch,
so a daemon that rebooted (losing its pass-local partials) between the
driver's look and the fold can never contribute a stale — or freshly
zeroed — partial silently: the pass replays instead.

Handles are held weakly: a daemon that died without ``stop()`` (test
teardown, GC) reads as absent rather than pinning a dead object alive.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional

__all__ = ["MeshMembership", "registry"]


class MeshMembership:
    """Thread-safe in-process membership table with epoch fencing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._members: Dict[str, Dict[str, Any]] = {}
        self._epoch = 0

    def register(self, member_id: str, boot_id: str, handle: Any) -> int:
        """Join (or re-join after a reboot). Always bumps the epoch —
        a re-registration of a known id IS an incarnation change, and
        every in-flight fit that saw the old epoch must re-resolve."""
        with self._lock:
            self._epoch += 1
            self._members[str(member_id)] = {
                "boot_id": str(boot_id),
                "handle": weakref.ref(handle),
                # The epoch this incarnation joined AT — a member whose
                # joined_epoch postdates a fit's first mesh_info read is
                # a MID-FIT joiner (docs/protocol.md "Mid-fit daemon
                # join"); the snapshot carries it so the driver and
                # tools/top can tell newcomers from founders without a
                # second registry.
                "joined_epoch": self._epoch,
            }
            return self._epoch

    def unregister(self, member_id: str, boot_id: Optional[str] = None) -> int:
        """Leave. With ``boot_id``, only THAT incarnation's entry is
        removed: a superseded daemon object's late ``stop()`` (supervisor
        drain, fixture teardown) must not deregister the live successor
        that re-registered the same durable instance id — the successor
        would read as a non-member forever and every fit would silently
        degrade to the driver hub."""
        with self._lock:
            m = self._members.get(str(member_id))
            if m is None:
                return self._epoch
            if boot_id is not None and m["boot_id"] != str(boot_id):
                return self._epoch
            del self._members[str(member_id)]
            self._epoch += 1
            return self._epoch

    def snapshot(self) -> Dict[str, Any]:
        """``{"epoch", "members": [{"id", "boot_id"}]}`` — live members
        only (dead weakrefs are skipped, NOT pruned: pruning would have
        to bump the epoch from a read path, making two concurrent
        snapshots disagree on it)."""
        with self._lock:
            members: List[Dict[str, Any]] = []
            # sorted(): the members list reaches wire acks (mesh_info) —
            # registration order varies per process and must not leak.
            for mid, m in sorted(self._members.items()):
                if m["handle"]() is not None:
                    members.append({
                        "id": mid,
                        "boot_id": m["boot_id"],
                        "joined_epoch": int(m["joined_epoch"]),
                    })
            return {"epoch": self._epoch, "members": members}

    def get(self, member_id: str, boot_id: Optional[str] = None):
        """The live handle for a member, or None when absent, dead, or
        (with ``boot_id``) running a different incarnation."""
        with self._lock:
            m = self._members.get(str(member_id))
            if m is None:
                return None
            if boot_id is not None and m["boot_id"] != str(boot_id):
                return None
            return m["handle"]()

    # -- epoch plane (serve/gossip.py rides the SAME clock) ------------------

    def tick(self) -> int:
        """Mint a fresh epoch with NO membership change — the gossip
        layer (serve/gossip.py) stamps every FleetView record it writes
        from this clock, so a record written after a join/leave/reboot
        always dominates records written before it: membership changes
        and gossip writes are totally ordered on one counter."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    def observe(self, epoch: int) -> int:
        """Lamport receive rule: advance this plane's epoch to at least
        a REMOTE epoch seen in a merged FleetView, so the next local
        tick() dominates everything the remote view carried. Never
        rewinds. Returns the (possibly advanced) epoch."""
        epoch = int(epoch)
        with self._lock:
            if epoch > self._epoch:
                self._epoch = epoch
            return self._epoch

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch


_REGISTRY = MeshMembership()


def registry() -> MeshMembership:
    """The process-wide membership table (one device plane per process —
    the same invariant ``_DEVICE_LOCK`` encodes in serve/daemon.py)."""
    return _REGISTRY
