"""Kernel ledger: per-(kernel, shape signature) cost attribution.

The port's counterpart of the JAX package's jit ledger
(``spark_rapids_ml_tpu/utils/xprof.py``). There every jitted entry point
registers with the ledger; here the unit is a hand-written kernel: each of
the ten dispatch functions of ``ops/kernels.py`` records every call under
its kernel's name, with the route it took (``wgmma``, ``ffma``, ``fused``,
``sort``, or ``plain`` for a CPU tensor, which runs the plain version).
The snapshot keeps the JAX ledger's schema, so one reader takes both
packages' snapshots. What the fields count in the port:

* **compiles / compile seconds**: the ``nvcc`` build of a kernel's library
  at first use (``ops/_build.py``), booked to the kernel whose call built
  it. A library found already built on disk is the persistent-cache hit.
* **cache misses**: first calls with a new shape signature (the tensor
  arguments' shapes and dtypes, the rows a call folds, the static ints
  such as k, and the route): a new launch plan.
* **flops / bytes accessed**: the kernel's bound counts from the call's
  shapes (``PERF.md`` §6): nd(d+1) for a Gram (plus nd for the column
  sums, 3nd with Xᵀy, 6nd for the Newton pass), C·nd(d+1) + 2Cnd for the
  per-class curvature, 2nkd (+ nd) for the KMeans pair, 2qmd for
  ``dist_topk`` and the probe, 2·nlist·C·maxlen·d for the scan; bytes are
  each input read once and each output written once (an in-place state
  read and written).
* **execution seconds**: only with ``device_timing`` on (env
  ``SRML_TORCH_DEVICE_TIMING``): CUDA events around the launch, and a
  synchronise on the second, so the ledger holds device seconds per call
  (host seconds for a plain call). Off by default: a measurement mode,
  which serialises the host and the card. Off, the ledger adds no event
  and no sync.
* **peak / argument / output bytes** stay None: the port has no
  ahead-of-time memory analysis.
* **CUDA graphs** (``serve/aot.py``): a call made while a graph captures
  is kept (:func:`recording`), not recorded, and :func:`credit` records it
  once for every replay of the graph; with ``device_timing`` a replay is
  timed as a whole and booked under the graph's own name
  (``serve/aot.REPLAY``), never to a kernel: its seconds include the
  graph's casts and padding.

Recording follows the ``metrics`` switch, as in the JAX package: with
``metrics`` off a ledgered call is a passthrough (one config read). The
``srml_xla_*`` metric names and labels (``fn`` = kernel name) are the JAX
package's; their help texts say what they count here.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

__all__ = ["kernel", "annotate", "recording", "credit", "signature", "snapshot", "reset",
           "format_table", "LEDGER"]

_M_CALLS = metrics_mod.counter(
    "srml_xla_calls_total",
    "Calls of the hand-written kernels' dispatch functions (a CPU call of the "
    "plain version included), by fn (the kernel)",
)
_M_COMPILES = metrics_mod.counter(
    "srml_xla_compiles_total",
    "nvcc builds of a kernel library at first use, booked to the kernel whose "
    "call built it, by fn",
)
_M_COMPILE_SECONDS = metrics_mod.counter(
    "srml_xla_compile_seconds_total",
    "Seconds of the nvcc builds booked to a kernel, by fn",
)
_M_CACHE_MISSES = metrics_mod.counter(
    "srml_xla_cache_misses_total",
    "First calls of a kernel with a new shape signature (a new launch plan), by fn",
)
_M_EXEC_SECONDS = metrics_mod.histogram(
    "srml_xla_execute_seconds",
    "Seconds per kernel call between CUDA events, synchronised (host seconds "
    "for a plain call), by fn — recorded only with device_timing on",
)
_M_FLOPS = metrics_mod.counter(
    "srml_xla_executed_flops_total",
    "The kernel's bound operation count from each call's shapes, summed over "
    "calls, by fn",
)
_M_BYTES = metrics_mod.counter(
    "srml_xla_executed_bytes_total",
    "The kernel's bound bytes (each input read once, each output written "
    "once) from each call's shapes, summed over calls, by fn",
)
_M_PCACHE_HITS = metrics_mod.counter(
    "srml_xla_persistent_cache_hits_total",
    "Kernel libraries found already built on disk instead of compiled",
)

# .current: (entry, sig) of the innermost call; .capture: the calls kept by
# the capture in progress on this thread (:func:`recording`).
_tls = threading.local()


def _enabled() -> bool:
    from spark_rapids_ml_tpu_torch import config

    return bool(config.peek("metrics"))


def _device_timing() -> bool:
    from spark_rapids_ml_tpu_torch import config

    return bool(config.peek("device_timing"))


def signature(*args: Any) -> Tuple[Any, ...]:
    """Hashable shape signature of a kernel call's arguments: a tensor by
    (shape, dtype), anything else (None, the static ints) by value."""
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            out.append(("a", tuple(shape), a.dtype))
        else:
            out.append(("s", a))
    return ("t", tuple(out))


def _fresh_record(route: str) -> Dict[str, Any]:
    return {
        "route": route,
        "calls": 0,
        "compiles": 0,
        "compile_s": 0.0,
        "first_call_s": None,
        "flops": None,
        "bytes_accessed": None,
        "peak_bytes": None,
        "argument_bytes": None,
        "output_bytes": None,
        "execute_calls": 0,
        "execute_s": 0.0,
    }


class _Entry:
    """One kernel: its records keyed by shape signature."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()
        self.records: Dict[Any, Dict[str, Any]] = {}

    def record(self, sig: Any, route: str) -> Tuple[Dict[str, Any], bool]:
        with self.lock:
            rec = self.records.get(sig)
            if rec is not None:
                return rec, False
            rec = self.records[sig] = _fresh_record(route)
            return rec, True


class KernelLedger:
    """Process-wide name → entry registry (module singleton ``LEDGER``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}

    def entry(self, name: str) -> _Entry:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(name)
            return e

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._entries))

    def reset(self) -> None:
        """Drop every recorded signature (tests, the boundaries of a timed
        window); the entries survive."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            with e.lock:
                e.records.clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able per-kernel view: per-signature records plus the JAX
        ledger's aggregates, and ``routes`` (calls by route).
        ``flops_per_s`` / ``bytes_per_s`` come from the timed calls, so
        they are present only after calls with ``device_timing`` on."""
        with self._lock:
            entries = sorted(self._entries.items())
        out: Dict[str, Any] = {}
        for name, e in entries:
            with e.lock:
                recs = {sig: dict(r) for sig, r in e.records.items()}
            if not recs:
                continue
            agg: Dict[str, Any] = {
                "calls": sum(r["calls"] for r in recs.values()),
                "compiles": sum(r["compiles"] for r in recs.values()),
                "compile_s": sum(r["compile_s"] for r in recs.values()),
                "cache_misses": len(recs),
                "execute_calls": sum(r["execute_calls"] for r in recs.values()),
                "execute_s": sum(r["execute_s"] for r in recs.values()),
            }
            flops = sum(r["flops"] * r["execute_calls"] for r in recs.values()
                        if r["flops"] is not None)
            nbytes = sum(r["bytes_accessed"] * r["execute_calls"] for r in recs.values()
                         if r["bytes_accessed"] is not None)
            if agg["execute_s"] > 0:
                agg["flops_per_s"] = flops / agg["execute_s"]
                agg["bytes_per_s"] = nbytes / agg["execute_s"]
            else:
                agg["flops_per_s"] = None
                agg["bytes_per_s"] = None
            routes: Dict[str, int] = {}
            for r in recs.values():
                routes[r["route"]] = routes.get(r["route"], 0) + r["calls"]
            agg["routes"] = routes
            agg["signatures"] = [
                {"sig": _render_sig(sig[-1]), **r}
                for sig, r in sorted(recs.items(), key=lambda kv: -kv[1]["calls"])
            ]
            out[name] = agg
        return out


def _render_sig(sig: Any) -> str:
    """Compact human form of a signature: ``bfloat16[65536,2048]``-style."""

    def one(s: Any) -> str:
        if isinstance(s, tuple) and s and s[0] == "a":
            dtype = str(s[2]).replace("torch.", "")
            return f"{dtype}[{','.join(str(d) for d in s[1])}]"
        if isinstance(s, tuple) and s and s[0] == "t":
            return "(" + ",".join(one(v) for v in s[1]) + ")"
        if isinstance(s, tuple) and s and s[0] == "s":
            return repr(s[1])
        return str(s)

    return one(sig)


LEDGER = KernelLedger()


@contextlib.contextmanager
def kernel(name: str, route: str, sig_args: Tuple[Any, ...], flops: float, nbytes: float,
           device: Any = None) -> Iterator[None]:
    """Record one call of kernel ``name`` on ``route`` around its launch (or
    its plain version): the record of the :func:`signature` of
    ``sig_args``, its bound counts, a build that happens inside
    (``note_compile``), and with ``device_timing`` the seconds between CUDA
    events on ``device`` (a ``torch.device``), the second synchronised; host
    seconds for a CPU call. A passthrough with ``metrics`` off."""
    captured = getattr(_tls, "capture", None)
    if captured is not None:
        # Inside a CUDA-graph capture nothing runs: the call is kept for
        # :func:`credit` on every replay, with no event and no sync (both
        # are illegal while a stream captures).
        captured.append((name, route, (route, signature(*sig_args)), float(flops),
                         float(nbytes)))
        yield
        return
    if not _enabled():
        yield
        return
    entry = LEDGER.entry(name)
    sig = (route, signature(*sig_args))
    rec, new = entry.record(sig, route)
    if new:
        _M_CACHE_MISSES.inc(fn=name)
        with entry.lock:
            rec["flops"] = float(flops)
            rec["bytes_accessed"] = float(nbytes)
    timing = _device_timing()
    events = None
    if timing and getattr(device, "type", "cpu") == "cuda":
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record(torch.cuda.current_stream(device))
    compiles_before = rec["compiles"]
    prev = getattr(_tls, "current", None)
    _tls.current = (entry, sig)
    t0 = time.perf_counter()
    try:
        yield
        if events is not None:
            events[1].record(torch.cuda.current_stream(device))
            events[1].synchronize()
    finally:
        _tls.current = prev
    dt = time.perf_counter() - t0
    if events is not None:
        dt_exec = events[0].elapsed_time(events[1]) / 1e3
    else:
        dt_exec = dt
    compiled_now = rec["compiles"] > compiles_before
    with entry.lock:
        rec["calls"] += 1
        if compiled_now and rec["first_call_s"] is None:
            rec["first_call_s"] = dt
        if timing and not compiled_now:
            # A build-bearing call's clock is the build, not the kernel.
            rec["execute_calls"] += 1
            rec["execute_s"] += dt_exec
    _M_CALLS.inc(fn=name)
    if timing and not compiled_now:
        _M_EXEC_SECONDS.observe(dt_exec, fn=name)
    _M_FLOPS.inc(float(flops), fn=name)
    _M_BYTES.inc(float(nbytes), fn=name)


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """Keep, instead of recording, the kernel calls this thread makes inside
    the block: a CUDA-graph capture (``serve/aot.py``), whose launches run
    only when the graph replays. Yields the list of kept calls, ``(name,
    route, signature, flops, bytes)`` each, for :func:`credit`."""
    calls: list = []
    prev = getattr(_tls, "capture", None)
    _tls.capture = calls
    try:
        yield calls
    finally:
        _tls.capture = prev


def credit(calls, seconds: Optional[float] = None) -> None:
    """Record the kept ``calls`` of one replay as :func:`kernel` records a
    call: one call each, its bound counts, a new signature a cache miss.
    ``seconds``: device seconds (``device_timing``) booked to each call;
    ``serve/aot`` passes them only for the graph's own record, since a
    graph's time cannot be split between its kernels. A no-op with
    ``metrics`` off."""
    if not _enabled():
        return
    for name, route, sig, flops, nbytes in calls:
        entry = LEDGER.entry(name)
        rec, new = entry.record(sig, route)
        if new:
            _M_CACHE_MISSES.inc(fn=name)
        timed = seconds is not None
        with entry.lock:
            if new:
                rec["flops"], rec["bytes_accessed"] = flops, nbytes
            rec["calls"] += 1
            if timed:
                rec["execute_calls"] += 1
                rec["execute_s"] += float(seconds)
        _M_CALLS.inc(fn=name)
        if timed:
            _M_EXEC_SECONDS.observe(float(seconds), fn=name)
        _M_FLOPS.inc(flops, fn=name)
        _M_BYTES.inc(nbytes, fn=name)


def note_compile(seconds: float) -> None:
    """A kernel library was built (``ops/_build.py``): book the seconds to
    the kernel call in progress on this thread, if any (a build outside
    every call, as ``build_all``'s, is booked nowhere)."""
    cur = getattr(_tls, "current", None)
    if cur is None or not _enabled():
        return
    entry, sig = cur
    with entry.lock:
        rec = entry.records.get(sig)
        if rec is None:
            return
        rec["compiles"] += 1
        rec["compile_s"] += float(seconds)
    _M_COMPILES.inc(fn=entry.name)
    _M_COMPILE_SECONDS.inc(float(seconds), fn=entry.name)


def note_cache_hit() -> None:
    """A kernel library was found already built on disk."""
    _M_PCACHE_HITS.inc()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Book builds that happen inside the block, outside any kernel call,
    to ledger entry ``name``, and count the block as one call."""
    if not _enabled():
        yield
        return
    entry = LEDGER.entry(name)
    sig = ("ambient", ("s", "ambient"))
    rec, _ = entry.record(sig, "ambient")
    prev = getattr(_tls, "current", None)
    _tls.current = (entry, sig)
    try:
        yield
    finally:
        _tls.current = prev
        with entry.lock:
            rec["calls"] += 1
        _M_CALLS.inc(fn=entry.name)


def snapshot() -> Dict[str, Any]:
    return LEDGER.snapshot()


def reset() -> None:
    LEDGER.reset()


def format_table(
    snap: Optional[Dict[str, Any]] = None,
    peak_flops_per_s: Optional[float] = None,
    peak_bytes_per_s: Optional[float] = None,
) -> str:
    """Achieved-vs-bound text table, one row per kernel: calls, compiles,
    compile seconds, execute seconds, achieved GFLOP/s and GB/s, and the
    shares of the peaks when given (an H100: 989e12 bf16 flop/s, 3.35e12
    HBM bytes/s). The rate columns read ``-`` without timed calls."""
    snap = LEDGER.snapshot() if snap is None else snap
    cols = ["fn", "calls", "compiles", "compile_s", "execute_s", "GFLOP/s", "GB/s"]
    if peak_flops_per_s:
        cols.append("flops%")
    if peak_bytes_per_s:
        cols.append("hbm%")
    rows = [cols]
    for name in sorted(snap):
        a = snap[name]
        row = [
            name,
            str(a["calls"]),
            str(a["compiles"]),
            f"{a['compile_s']:.3f}",
            f"{a['execute_s']:.3f}" if a["execute_calls"] else "-",
            f"{a['flops_per_s'] / 1e9:.1f}" if a["flops_per_s"] else "-",
            f"{a['bytes_per_s'] / 1e9:.1f}" if a["bytes_per_s"] else "-",
        ]
        if peak_flops_per_s:
            row.append(f"{100 * a['flops_per_s'] / peak_flops_per_s:.1f}"
                       if a["flops_per_s"] else "-")
        if peak_bytes_per_s:
            row.append(f"{100 * a['bytes_per_s'] / peak_bytes_per_s:.1f}"
                       if a["bytes_per_s"] else "-")
        rows.append(row)
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows)
