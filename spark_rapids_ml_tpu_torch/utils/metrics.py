"""Process-wide metrics registry: labeled counters, gauges, histograms.

The port's copy of ``spark_rapids_ml_tpu/utils/metrics.py`` (the port
imports nothing of the JAX package, not even its pure-Python modules).
Every layer records into this one registry; the parallel layer's
collective counter (``parallel/mapreduce.py``) is its first user, and the
serving plane's counters follow with that slice. The snapshot and the
Prometheus / OpenMetrics texts are those of the JAX module for the same
sequence of records.

Zero dependencies by design; the Prometheus text exposition (v0.0.4) is
~40 lines, not a client library. Everything is thread-safe: one lock per
metric, held only for the dict update.

Naming convention: ``srml_<area>_<name>[_<unit>]`` — counters end
``_total``, histograms end in their unit (``_seconds``/``_bytes``), gauges
are bare quantities. Labels are lowercase identifiers.

Disabled state: ``config.set("metrics", False)`` (env
``SRML_TORCH_METRICS=0``) turns every record call into an early return —
no label-key allocation, no lock — and ``snapshot()``/
``render_prometheus()`` are only ever executed on demand (a scrape),
never in the background.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "render_prometheus",
    "render_openmetrics",
    "reset",
    "quantile_from_buckets",
]

#: Default latency buckets (seconds): sub-millisecond host ops through
#: the tens-of-seconds first-compile tail the daemon's feed path can hit.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _enabled() -> bool:
    # Lazy import: config pulls utils.logging; importing it at module load
    # from here would make the utils package order-sensitive. config.peek
    # is a lock-free dict read — this gate sits on the daemon's per-frame
    # hot path, and the disabled state must truly be an early return (no
    # process-wide lock), as the module docstring promises.
    from spark_rapids_ml_tpu_torch import config

    return bool(config.peek("metrics"))


def _exemplar_window() -> float:
    """Seconds an exemplar stays "fresh": inside the window only a worse
    sample evicts it; past it, the next exemplared sample takes the slot
    regardless — so each bucket tracks the worst RECENT trace, not the
    worst ever."""
    from spark_rapids_ml_tpu_torch import config

    try:
        return float(config.peek("telemetry_exemplar_window_s") or 60.0)
    except (TypeError, ValueError):
        return 60.0


def quantile_from_buckets(buckets: Dict[str, int], q: float
                          ) -> Optional[float]:
    """Estimate the q-quantile (0 < q < 1) from CUMULATIVE le→count
    buckets (the snapshot/Prometheus shape), linearly interpolating
    inside the target bucket. None when empty; the +Inf bucket clamps
    to the largest finite bound (no upper edge to interpolate against).
    The ONE estimator both consumers of the snapshot shape use —
    tools/top's latency columns and the serve autoscaler's p99
    objective must read the SAME number from the same histogram."""
    import math

    pairs: List[Tuple[float, int]] = sorted(
        (math.inf if le == "+Inf" else float(le), n)
        for le, n in buckets.items()
    )
    if not pairs or pairs[-1][1] <= 0:
        return None
    total = pairs[-1][1]
    target = q * total
    prev_bound, prev_count = 0.0, 0
    for bound, count in pairs:
        if count >= target:
            if math.isinf(bound):
                return prev_bound
            if count == prev_count:
                return bound
            frac = (target - prev_count) / (count - prev_count)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_count = (0.0 if math.isinf(bound) else bound), count
    return prev_bound


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Canonical hashable form: sorted (name, str(value)) pairs, so
    ``inc(op="feed")`` and ``inc(**{"op": "feed"})`` land in one series."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _clear(self) -> None:
        with self._lock:
            self._series.clear()

    def _samples(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._series.items())]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not _enabled():
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        """Current value of one series (0.0 when never incremented)."""
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not _enabled():
            return
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not _enabled():
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram (per-bucket counts + sum + count). Buckets
    are upper bounds with ``le`` (≤) semantics plus an implicit +Inf —
    exactly the Prometheus model, so exposition is a cumulative sum."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        uppers = tuple(float(b) for b in buckets)
        if not uppers or list(uppers) != sorted(set(uppers)):
            raise ValueError(
                f"histogram {name!r} buckets must be distinct and "
                f"ascending, got {buckets!r}"
            )
        self.buckets = uppers
        #: (series key, bucket idx) → (value, ts, trace dict): the worst
        #: sample of the current exemplar window, per bucket.
        self._exemplars: Dict[Tuple[Any, int], Tuple[float, float, Dict[str, str]]] = {}

    def _clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._exemplars.clear()

    def _le(self, idx: int) -> str:
        return _fmt_float(self.buckets[idx]) if idx < len(self.buckets) else "+Inf"

    def exemplars(self, **labels: Any) -> Dict[str, Dict[str, Any]]:
        """Fresh (within-window) exemplars of one series, keyed by the
        bucket's ``le`` bound: ``{le: {"value", "ts", …trace fields}}``."""
        key = _label_key(labels)
        now = time.time()
        window = _exemplar_window()
        with self._lock:
            items = [
                (idx, v, ts, dict(trace))
                for (k, idx), (v, ts, trace) in self._exemplars.items()
                if k == key and now - ts <= window
            ]
        return {
            self._le(idx): {"value": v, "ts": ts, **trace}
            for idx, v, ts, trace in sorted(items)
        }

    def _samples(self):
        # Deep-copy rows under the lock: the base copies the mapping but a
        # row list mutated by a concurrent observe would tear a scrape.
        with self._lock:
            return [
                (dict(k), [list(row[0]), row[1], row[2]])
                for k, row in sorted(self._series.items())
            ]

    def observe(
        self,
        value: float,
        exemplar: Optional[Dict[str, str]] = None,
        **labels: Any,
    ) -> None:
        """Record one sample. ``exemplar`` (optional, additive) is a
        small trace reference — ``{"run": …, "span": …}`` — kept per
        (series, bucket) for the WORST sample of the current exemplar
        window (``telemetry_exemplar_window_s``): a p99 breach on the
        scrape side links straight to the trace that caused it. A label
        literally named ``exemplar`` is therefore reserved."""
        if not _enabled():
            return
        value = float(value)
        idx = bisect_left(self.buckets, value)  # == len(buckets) → +Inf
        key = _label_key(labels)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = self._series[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0,
                ]
            row[0][idx] += 1
            row[1] += value
            row[2] += 1
            if exemplar:
                now = time.time()
                slot = (key, idx)
                prev = self._exemplars.get(slot)
                if (
                    prev is None
                    or now - prev[1] > _exemplar_window()
                    or value >= prev[0]
                ):
                    self._exemplars[slot] = (value, now, dict(exemplar))

    def series(self, **labels: Any):
        """(cumulative buckets {le_str: n}, sum, count) of one series, or
        None when never observed — test/tool convenience."""
        with self._lock:
            row = self._series.get(_label_key(labels))
            if row is None:
                return None
            counts, total, n = list(row[0]), row[1], row[2]
        return self._cumulate(counts), total, n

    def _cumulate(self, counts: List[int]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        running = 0
        for upper, c in zip(self.buckets, counts):
            running += c
            out[_fmt_float(upper)] = running
        out["+Inf"] = running + counts[-1]
        return out


def _fmt_float(v: float) -> str:
    """Minimal decimal form ("0.005", "1", "60") for bucket bounds and
    sample values — deterministic for the exposition golden test."""
    if v == int(v):
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Registry:
    """Named metrics, get-or-create. Module-level instances register at
    import; ``reset()`` clears recorded series but keeps the registered
    metric OBJECTS valid (call sites hold direct references)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {cls.kind}"
                    )
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        """Clear every recorded series (tests; metric objects survive)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every metric with ≥ 1 recorded series — what
        the daemon's ``metrics`` op returns. Histogram buckets are
        CUMULATIVE (Prometheus ``le`` semantics)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in metrics:
            samples = []
            if isinstance(m, Histogram):
                for labels, row in m._samples():
                    sample = {
                        "labels": labels,
                        "buckets": m._cumulate(row[0]),
                        "sum": row[1],
                        "count": row[2],
                    }
                    ex = m.exemplars(**labels)
                    if ex:
                        sample["exemplars"] = ex
                    samples.append(sample)
            else:
                for labels, v in m._samples():
                    samples.append({"labels": labels, "value": v})
            if samples:
                out[name] = {"type": m.kind, "help": m.help, "samples": samples}
        return out

    def _render(self, exemplars: bool) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            samples = m._samples()
            if not samples:
                continue
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for labels, row in samples:
                    cum = m._cumulate(row[0])
                    ex = m.exemplars(**labels) if exemplars else {}
                    for le, n in cum.items():
                        line = (
                            f"{name}_bucket"
                            f"{_render_labels({**labels, 'le': le})} {n}"
                        )
                        e = ex.get(le)
                        if e is not None:
                            # OpenMetrics exemplar syntax: the trace
                            # labelset, then the sample's value and ts.
                            trace = {
                                k: v for k, v in e.items()
                                if k not in ("value", "ts")
                            }
                            line += (
                                f" # {_render_labels(trace) or '{}'} "
                                f"{_fmt_float(e['value'])} "
                                f"{_fmt_float(e['ts'])}"
                            )
                        lines.append(line)
                    lines.append(
                        f"{name}_sum{_render_labels(labels)} "
                        f"{_fmt_float(row[1])}"
                    )
                    lines.append(
                        f"{name}_count{_render_labels(labels)} {row[2]}"
                    )
            else:
                for labels, v in samples:
                    lines.append(
                        f"{name}{_render_labels(labels)} {_fmt_float(v)}"
                    )
        if exemplars:
            lines.append("# EOF")
        return "\n".join(lines) + ("\n" if lines else "")

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4 (the format every
        scraper accepts), metrics and series in sorted order."""
        return self._render(exemplars=False)

    def render_openmetrics(self) -> str:
        """OpenMetrics-style text: the v0.0.4 exposition plus per-bucket
        exemplar suffixes (``… # {run="…",span="…"} value ts``) and the
        terminating ``# EOF`` — what the ``telemetry_pull`` wire op
        ships, so a scraped p99 breach carries the trace that caused
        it."""
        return self._render(exemplars=True)


#: The process-wide registry every layer records into.
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def render_openmetrics() -> str:
    return REGISTRY.render_openmetrics()


def reset() -> None:
    REGISTRY.reset()
