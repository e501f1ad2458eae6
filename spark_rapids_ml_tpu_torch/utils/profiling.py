"""Phase-named tracing spans — the NVTX-range idiom of the reference.

The reference wraps its two fit phases in NVTX ranges (``NvtxRange("compute
cov")`` / ``NvtxRange("cuSolver SVD")``, RapidsRowMatrix.scala:62,70). The
port keeps the JAX package's phase names ("compute cov", "eig finalize",
"pca transform"). A span is a ``torch.profiler.record_function`` range,
which a ``torch.profiler`` trace records with its duration and which costs
next to nothing outside one, and, on a CUDA machine, an NVTX range. Spans
do not synchronise the device: a span around queued kernels covers their
enqueue unless its body waits for a result.

A ``torch.profiler`` trace records only the ranges of the thread that
started it, and the data-plane daemon runs its ops on one thread per
connection. So every span also adds its host-clock seconds to a
process-wide total per name (:func:`span_totals`, two clock reads and a
lock per span), which sums the spans of every thread.

As in the JAX package, a span also feeds the two observability sinks: the
``srml_phase_duration_seconds{phase}`` histogram of the metrics registry
(an early return with ``metrics`` off) and the run journal
(``utils/journal.py``: one ``phase`` line with run, span and parent ids;
an early return when neither a journal file nor the ring is on).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.utils import journal
from spark_rapids_ml_tpu_torch.utils import metrics

#: Every trace_span records here: the per-phase latency breakdown.
PHASE_SECONDS = metrics.histogram(
    "srml_phase_duration_seconds",
    "Wall-clock duration of trace_span phases, by phase name",
)

_totals: Dict[str, list] = {}  # name -> [seconds, count]
_totals_lock = threading.Lock()


class Timer:
    """Wall-clock timer on the monotonic ``perf_counter``; ``stop()``
    returns and keeps the seconds since construction."""

    def __init__(self) -> None:
        self.start = time.perf_counter()
        self.elapsed: Optional[float] = None

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.start
        return self.elapsed


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """``with trace_span("compute cov"): ...`` — a named phase."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name), journal.span(name):
            if torch.cuda.is_available():
                with torch.cuda.nvtx.range(name):
                    yield
            else:
                yield
    finally:
        dt = time.perf_counter() - t0
        with _totals_lock:
            acc = _totals.setdefault(name, [0.0, 0])
            acc[0] += dt
            acc[1] += 1
        PHASE_SECONDS.observe(dt, phase=name)


def span_totals() -> Dict[str, Tuple[float, int]]:
    """{name: (host-clock seconds, count)} of every span ended since the
    last :func:`reset_span_totals`, over all threads."""
    with _totals_lock:
        return {name: (acc[0], acc[1]) for name, acc in _totals.items()}


def reset_span_totals() -> None:
    with _totals_lock:
        _totals.clear()
