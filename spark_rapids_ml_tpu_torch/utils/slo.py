"""SLO burn-rate evaluation over the metrics registry (utils/metrics.py).

The port's copy of ``spark_rapids_ml_tpu/utils/slo.py``: the same spec
grammar, burn-rate arithmetic and ``srml_slo_*`` gauges, reading the
port's config (env ``SRML_TORCH_SLO_*``). For each declared objective the
evaluator computes, from deltas of the cumulative daemon histograms and
counters, the fraction of requests that violated it over a FAST window and
a SLOW window, divides each by the budget (the allowed violating fraction)
to get a burn rate (1.0 = burning exactly the budget), and raises a breach
only when BOTH windows burn at ``slo_burn_threshold`` or above: the fast
window catches a storm in seconds, the slow one keeps a blip from paging.

Objectives (``slo_objectives``) are semicolon-separated specs::

    <op>:<kind>[=<target>][@<budget>]

with ``kind`` one of:

* ``p99_ms``: at most ``budget`` (default 0.01) of requests slower than
  ``target`` milliseconds, judged against ``srml_daemon_request_seconds
  {op}`` (interpolated inside the target's bucket);
* ``error``: at most ``budget`` (default 0.001) of requests with outcome
  ``error``/``transport`` (``srml_daemon_requests_total``);
* ``shed``: at most ``budget`` (default 0.01) of requests shed
  (``srml_daemon_busy_sheds_total`` + ``srml_scheduler_sheds_total``).

Results are the gauges ``srml_slo_burn_rate{objective,op,window}`` and
``srml_slo_breach{objective,op}``, which ride the ``metrics`` and
``telemetry_pull`` scrapes and arm the flight recorder (utils/flight.py).
The daemon's telemetry thread ticks one evaluator; tests tick one directly
with synthetic snapshots and explicit ``now`` timestamps.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

__all__ = [
    "Objective",
    "SloEvaluator",
    "parse_objectives",
    "count_le",
]

#: Default budgets (allowed violating fraction) per objective kind.
_DEFAULT_BUDGETS = {"p99_ms": 0.01, "error": 0.001, "shed": 0.01}

_G_BURN = metrics_mod.gauge(
    "srml_slo_burn_rate",
    "Error-budget burn rate per objective and window (fast|slow): 1.0 "
    "= burning exactly the budget; breaches need both windows over "
    "slo_burn_threshold",
)
_G_BREACH = metrics_mod.gauge(
    "srml_slo_breach",
    "1 while an objective's fast AND slow burn rates both exceed "
    "slo_burn_threshold, else 0",
)


class Objective:
    """One declared per-op objective. ``target`` is milliseconds for
    ``p99_ms`` and unused for ``error``/``shed``; ``budget`` is the
    allowed violating fraction of requests."""

    def __init__(self, op: str, kind: str, target: Optional[float],
                 budget: float):
        if kind not in _DEFAULT_BUDGETS:
            raise ValueError(f"unknown SLO kind {kind!r} (op {op!r})")
        if kind == "p99_ms" and (target is None or target <= 0):
            raise ValueError(f"p99_ms objective for {op!r} needs =<target_ms>")
        if not 0 < budget < 1:
            raise ValueError(f"SLO budget must be in (0, 1), got {budget!r}")
        self.op = op
        self.kind = kind
        self.target = target
        self.budget = float(budget)

    @property
    def name(self) -> str:
        return f"{self.op}:{self.kind}"

    def __repr__(self) -> str:  # tools/top panel + logs
        t = f"={self.target:g}" if self.target is not None else ""
        return f"{self.op}:{self.kind}{t}@{self.budget:g}"


def parse_objectives(spec: str) -> List[Objective]:
    """Parse the ``slo_objectives`` config string. Empty/whitespace →
    no objectives. Malformed entries raise ``ValueError`` — a typoed
    objective silently evaluating nothing is the worst failure mode an
    SLO layer can have."""
    out: List[Objective] = []
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        try:
            op, rest = raw.split(":", 1)
        except ValueError:
            raise ValueError(f"SLO spec {raw!r}: expected <op>:<kind>…")
        budget: Optional[float] = None
        if "@" in rest:
            rest, b = rest.rsplit("@", 1)
            budget = float(b)
        target: Optional[float] = None
        if "=" in rest:
            rest, t = rest.split("=", 1)
            target = float(t)
        kind = rest.strip()
        out.append(Objective(
            op.strip(), kind, target,
            budget if budget is not None else _DEFAULT_BUDGETS.get(kind, 0.01),
        ))
    return out


def count_le(buckets: Dict[str, Any], x: float) -> float:
    """Estimated number of samples ≤ ``x`` from CUMULATIVE le→count
    buckets, linearly interpolated inside x's bucket. Past the largest
    finite bound the whole +Inf tail counts as violations (conservative
    — nothing inside that bucket is knowable)."""
    pairs: List[Tuple[float, float]] = sorted(
        (math.inf if le == "+Inf" else float(le), float(n))
        for le, n in buckets.items()
    )
    prev_b, prev_n = 0.0, 0.0
    for b, n in pairs:
        if math.isinf(b):
            return prev_n
        if x < b:
            if x <= prev_b:
                return prev_n
            return prev_n + (x - prev_b) / (b - prev_b) * (n - prev_n)
        prev_b, prev_n = b, n
    return prev_n


def _op_stats(snap: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-op cumulative stats out of one registry snapshot: total and
    error request counts, shed count, and the latency buckets."""
    stats: Dict[str, Dict[str, Any]] = {}

    def row(op: str) -> Dict[str, Any]:
        return stats.setdefault(
            op, {"total": 0.0, "err": 0.0, "shed": 0.0, "buckets": None}
        )

    for s in snap.get("srml_daemon_requests_total", {}).get("samples", []):
        op = s["labels"].get("op", "")
        row(op)["total"] += float(s["value"])
        if s["labels"].get("outcome") in ("error", "transport"):
            row(op)["err"] += float(s["value"])
    for s in snap.get("srml_daemon_busy_sheds_total", {}).get("samples", []):
        row(s["labels"].get("op", ""))["shed"] += float(s["value"])
    for s in snap.get("srml_scheduler_sheds_total", {}).get("samples", []):
        row(s["labels"].get("op", ""))["shed"] += float(s["value"])
    for s in snap.get("srml_daemon_request_seconds", {}).get("samples", []):
        row(s["labels"].get("op", ""))["buckets"] = s.get("buckets") or {}
    return stats


def _violations(obj: Objective, then: Dict[str, Any], now: Dict[str, Any]
                ) -> Tuple[float, float]:
    """(violating requests, total requests) for one objective over the
    delta between two cumulative per-op stat rows."""
    total = now["total"] - then["total"]
    if total <= 0:
        return 0.0, 0.0
    if obj.kind == "error":
        return max(0.0, now["err"] - then["err"]), total
    if obj.kind == "shed":
        return max(0.0, now["shed"] - then["shed"]), total
    # p99_ms: violations = requests slower than target over the window.
    b_now, b_then = now.get("buckets"), then.get("buckets")
    if not b_now:
        return 0.0, 0.0
    x = float(obj.target) / 1000.0  # histogram is in seconds
    n_now = float(b_now.get("+Inf", 0.0))
    n_then = float(b_then.get("+Inf", 0.0)) if b_then else 0.0
    window_n = n_now - n_then
    if window_n <= 0:
        return 0.0, 0.0
    ok = count_le(b_now, x) - (count_le(b_then, x) if b_then else 0.0)
    return max(0.0, window_n - ok), window_n


class SloEvaluator:
    """Rings cumulative snapshots and turns deltas into burn rates.

    ``tick(snap, now)`` appends one (ts, per-op stats) point, computes
    every objective's fast/slow burn, publishes the ``srml_slo_*``
    gauges, and returns the evaluation list — one dict per objective
    with ``fast_burn`` / ``slow_burn`` / ``breach``. With fewer than
    ``window`` seconds of history a window burns over the span it has
    (a storm at t=5s must not hide behind an unfilled 60 s window).
    """

    def __init__(
        self,
        objectives: Optional[List[Objective]] = None,
        fast_window_s: Optional[float] = None,
        slow_window_s: Optional[float] = None,
        burn_threshold: Optional[float] = None,
    ):
        from spark_rapids_ml_tpu_torch import config

        if objectives is None:
            objectives = parse_objectives(str(config.get("slo_objectives") or ""))
        self.objectives = list(objectives)
        self.fast_window_s = float(
            fast_window_s if fast_window_s is not None
            else config.get("slo_fast_window_s")
        )
        self.slow_window_s = float(
            slow_window_s if slow_window_s is not None
            else config.get("slo_slow_window_s")
        )
        self.burn_threshold = float(
            burn_threshold if burn_threshold is not None
            else config.get("slo_burn_threshold")
        )
        self._lock = threading.Lock()
        self._history: Deque[Tuple[float, Dict[str, Dict[str, Any]]]] = deque()
        self._last: List[Dict[str, Any]] = []

    def _baseline(self, now_ts: float, window: float
                  ) -> Optional[Tuple[float, Dict[str, Dict[str, Any]]]]:
        """Latest history point at least ``window`` old, else the oldest
        point (partial window); None with no history."""
        best = None
        for ts, stats in self._history:
            if ts <= now_ts - window:
                best = (ts, stats)
            else:
                break
        if best is None and self._history:
            best = self._history[0]
        return best

    def tick(
        self,
        snap: Optional[Dict[str, Any]] = None,
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        import time as _time

        if snap is None:
            snap = metrics_mod.snapshot()
        if now is None:
            now = _time.time()
        stats = _op_stats(snap)
        empty = {"total": 0.0, "err": 0.0, "shed": 0.0, "buckets": None}
        out: List[Dict[str, Any]] = []
        with self._lock:
            for obj in self.objectives:
                cur = stats.get(obj.op, empty)
                burns = {}
                for win_name, win in (("fast", self.fast_window_s),
                                      ("slow", self.slow_window_s)):
                    base = self._baseline(now, win)
                    prev = base[1].get(obj.op, empty) if base else empty
                    viol, total = _violations(obj, prev, cur)
                    frac = viol / total if total > 0 else 0.0
                    burns[win_name] = frac / obj.budget
                breach = (
                    burns["fast"] >= self.burn_threshold
                    and burns["slow"] >= self.burn_threshold
                )
                _G_BURN.set(burns["fast"], objective=obj.name, op=obj.op,
                            window="fast")
                _G_BURN.set(burns["slow"], objective=obj.name, op=obj.op,
                            window="slow")
                _G_BREACH.set(1.0 if breach else 0.0, objective=obj.name,
                              op=obj.op)
                out.append({
                    "objective": obj.name,
                    "op": obj.op,
                    "kind": obj.kind,
                    "target": obj.target,
                    "budget": obj.budget,
                    "fast_burn": burns["fast"],
                    "slow_burn": burns["slow"],
                    "breach": breach,
                })
            self._history.append((now, stats))
            horizon = now - self.slow_window_s - 1.0
            while len(self._history) > 1 and self._history[1][0] <= horizon:
                self._history.popleft()
            self._last = out
        return out

    def breaches(self) -> List[Dict[str, Any]]:
        """Objectives breaching as of the last tick."""
        with self._lock:
            return [e for e in self._last if e["breach"]]
