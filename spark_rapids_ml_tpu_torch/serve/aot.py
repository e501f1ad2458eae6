"""AOT at registration: the per-bucket serving programs a served model holds.

The port's counterpart of the JAX package's ``LedgeredJit.aot_prime`` and of
the ``Compiled`` executables its ``_ServedModel.aot_warm`` holds
(``spark_rapids_ml_tpu/utils/xprof.py``, ``serve/daemon.py``;
``docs/protocol.md`` "AOT at registration"). A model publishes, through
``_serve_aot_plan(n_rows, n_cols, dtype, k)``, the :class:`Plan` of the
program one bucket of its serving path dispatches: the row count that path
really runs (the ladder bucket a served transform pads to, the padded query
count of an exact kneighbors), the request's width and wire dtype, the
device body (wire dtype in, outputs on the device), the host finish, and a
check that the model has not changed under the program.

:class:`BucketProgram` holds one plan's program. On a CUDA device it is a
``torch.cuda.CUDAGraph``: one eager run of the body on a side stream first
(cuBLAS takes its handle, workspace and algorithm, and the kernels their
one-time set-up, outside the capture), then the capture on that stream into
a memory pool the served model's buckets share (:class:`CapturePool`). A
request's rows are copied into the static input (the rows after them
zeroed, as the eager path pads), the graph replays, and the static outputs
are copied back: one copy in, one launch of the whole program, one copy out
a static output, one sync. On a CPU
device (the tests) there is no graph: the program keeps the same static
input and runs the body eagerly. :data:`ROUTES` counts the runs, ``aot/graph``
or ``aot/eager``; a CUDA device never takes ``aot/eager``.

A capture launches nothing, so the kernel calls it made (``dist_topk`` in
the exact-kNN program) are kept by ``utils/xprof.recording`` and credited on
every replay (``xprof.credit``, ``ops/kernels.credit_launches``): ``LAUNCHES``,
``ROUTES`` and the kernel ledger count what the graph launches. With
``device_timing`` a replay is timed as a whole (the graph's casts and
padding with its kernels) and booked under the ledger name :data:`REPLAY`,
never to a kernel.

:class:`ProgramSet` is a served instance's compile ledger (``model_status``'s
``aot``): the primed buckets, the programs the warm built, and the hits and
misses since. A hit is a dispatch a held program served; a miss one at a
shape (row count, width, wire dtype, k) nothing primed (a request of another
width included: the eager path then raises its own shape error), or whose
program went stale
(the model's device, dtypes or index changed under it: the program is then
released, and the dispatch runs eagerly).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.utils import xprof
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

__all__ = ["Plan", "BucketProgram", "CapturePool", "ProgramSet", "REPLAY", "ROUTES",
           "check_width", "reset_routes", "transform_plan"]

#: Held-program runs by route: "aot/graph" (a CUDA-graph replay) and
#: "aot/eager" (the body run eagerly, a CPU device only).
ROUTES = {"aot/graph": 0, "aot/eager": 0}

#: The kernel-ledger name a timed replay's device seconds are booked under.
REPLAY = "aot.replay"


def reset_routes() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


def check_width(n_cols: int, width: int) -> None:
    """A plan's width check: raise, never degrade, as the JAX plans do (an
    ack must not bless a width the serving path would reject)."""
    if int(n_cols) != int(width):
        raise ValueError(f"warmup n_cols={int(n_cols)} does not match the model's fitted "
                         f"width {int(width)}")


class Plan(NamedTuple):
    """One bucket's serving program as a model publishes it."""

    rows: int  # the row count the serving path dispatches for this bucket
    width: int  # the request's width
    dtype: np.dtype  # the request's wire dtype
    device: torch.device
    body: Callable[[torch.Tensor], Sequence[torch.Tensor]]  # device: static input → outputs
    finish: Callable[[List[np.ndarray], int], Any]  # host: (outputs, request rows) → answer
    valid: Callable[[], bool]  # the model still serves what the program was built over
    prep: Optional[Callable[[np.ndarray], np.ndarray]] = None  # host rows → static input rows


def transform_plan(model, n_rows: int, n_cols: int, dtype, width: int, fn, finish
                   ) -> List[Plan]:
    """The one-program plan of a transform model's bucket of ``n_rows`` rows.
    ``fn``: the model's device function, cached under ``predictor_key``
    (rows → a tensor or a tuple of tensors, the program's static outputs);
    the program is valid while that key (device and dtypes) is the one it
    was built under. A wrong width raises."""
    from spark_rapids_ml_tpu_torch.parallel.sharding import predictor_key, resolve_device

    check_width(n_cols, width)
    key = predictor_key(model._device)

    def body(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = fn(x)
        return out if isinstance(out, tuple) else (out,)

    return [Plan(int(n_rows), int(n_cols), np.dtype(dtype), resolve_device(model._device),
                 body=body, finish=finish, valid=lambda: predictor_key(model._device) == key)]


class CapturePool:
    """The memory pool and capture stream a served model's graphs share: the
    buckets' temporaries reuse one pool, since their replays never overlap
    (each runs to its sync under the served model's lock and the daemon's
    device lock)."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class BucketProgram:
    """One :class:`Plan` held: a CUDA graph on the card, the eager body over
    the same static input on the CPU. ``capture_s``: the seconds the eager
    warm run and the capture took (0 on the CPU)."""

    def __init__(self, plan: Plan, pool: Optional[CapturePool] = None):
        self.plan = plan
        width, dtype = int(plan.width), np.dtype(plan.dtype)
        if plan.prep is not None:
            probe = plan.prep(np.zeros((1, width), dtype))
            width, dtype = int(probe.shape[1]), probe.dtype
        self.static_in = torch.zeros((int(plan.rows), width), dtype=_torch_dtype(dtype),
                                     device=plan.device)
        self.static_out: Tuple[torch.Tensor, ...] = ()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls: list = []  # the kernel calls the capture kept
        self.capture_s = 0.0
        self.released = False
        if plan.device.type == "cuda":
            if pool is None:
                raise ValueError("a CUDA program needs the served model's CapturePool")
            self._capture(pool)

    def _capture(self, pool: CapturePool) -> None:
        """The eager warm run on the capture stream, then the capture. The
        wrappers' launch counts of the capture are taken back at once: it
        launched nothing."""
        t0 = time.perf_counter()
        dev = self.plan.device
        stream = pool.stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.plan.body(self.static_in)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with xprof.recording() as calls:
            try:
                # thread_local: only this thread's unsafe calls are refused;
                # the daemon's device lock keeps every other device op out.
                with torch.cuda.graph(graph, pool=pool.handle, stream=stream,
                                      capture_error_mode="thread_local"):
                    outs = tuple(self.plan.body(self.static_in))
            finally:
                kernels.credit_launches(calls, -1)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph, self.static_out, self.calls = graph, outs, calls
        self.capture_s = time.perf_counter() - t0

    def usable(self) -> bool:
        return not self.released and bool(self.plan.valid())

    def release(self) -> None:
        """Free the graph and the static buffers (a stale program)."""
        self.released = True
        if self.graph is not None:
            self.graph.reset()
        self.graph, self.static_out, self.calls = None, (), []
        self.static_in = torch.empty(0)

    def _stage(self, x: np.ndarray) -> None:
        """The request rows into the static input (a pageable copy, as the
        eager path uploads), the rows after them zero (as it pads)."""
        n, rows = int(x.shape[0]), int(self.static_in.shape[0])
        if x.ndim != 2 or x.shape[1] != self.static_in.shape[1] or n > rows:
            raise ValueError(f"request of shape {tuple(x.shape)} does not fit the program's "
                             f"{tuple(self.static_in.shape)}")
        self.static_in[:n].copy_(torch.from_numpy(np.ascontiguousarray(x)))
        if n < rows:
            self.static_in[n:].zero_()

    def run(self, x: np.ndarray) -> Any:
        """The plan's answer for request rows ``x`` (at most ``rows``, of the
        plan's width)."""
        plan = self.plan
        n = int(x.shape[0])
        if plan.prep is not None:
            x = plan.prep(x)
        if self.graph is None:
            with trace_span("aot eager"):
                self._stage(x)
                outs = [o.numpy().copy() for o in plan.body(self.static_in)]
            ROUTES["aot/eager"] += 1
            return plan.finish(outs, n)
        from spark_rapids_ml_tpu_torch import config

        stream = torch.cuda.current_stream(plan.device)
        timing = bool(config.peek("device_timing"))
        with trace_span("aot replay"):
            self._stage(x)
            if timing:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            self.graph.replay()
            if timing:
                events[1].record(stream)
            # Each .cpu() syncs the stream: the outputs are read before the
            # next replay, which runs under the same locks.
            outs = [out.cpu().numpy() for out in self.static_out]
        ROUTES["aot/graph"] += 1
        kernels.credit_launches(self.calls)
        xprof.credit(self.calls)
        if timing:
            xprof.credit([(REPLAY, "graph", ("graph", xprof.signature(self.static_in)),
                           sum(c[3] for c in self.calls), sum(c[4] for c in self.calls))],
                         events[0].elapsed_time(events[1]) / 1e3)
        return plan.finish(outs, n)


class ProgramSet:
    """A served instance's held programs and its compile ledger since the
    warm that built it. ``programs``: (dispatched rows, width, wire dtype,
    k) → :class:`BucketProgram`; ``dispatch_rows``: the rows the serving path
    dispatches for a request of n rows. Its counters move under the served
    instance's lock; ``status`` reads them without it."""

    def __init__(self, buckets, compiled: int, programs: Dict[tuple, BucketProgram],
                 dispatch_rows: Callable[[int], int] = int):
        self.buckets = [int(b) for b in buckets]
        self.compiled = int(compiled)
        self.programs = programs
        self.dispatch_rows = dispatch_rows
        # A plan of no program (the scaler's) serves every request eagerly
        # and counts nothing, as the JAX ledger counts on no wrapper.
        self._counting = bool(programs)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(rows: int, width: int, dtype, k: Optional[int]) -> tuple:
        return int(rows), int(width), np.dtype(dtype).str, None if k is None else int(k)

    def run(self, x: np.ndarray, k: Optional[int] = None) -> Optional[Any]:
        """The held program's answer for the request rows ``x``, or None (a
        miss: the caller runs the eager path)."""
        if not self._counting:
            return None
        width = int(x.shape[1]) if x.ndim == 2 else -1
        key = self.key(self.dispatch_rows(int(x.shape[0])), width, x.dtype, k)
        prog = self.programs.get(key)
        if prog is not None and not prog.usable():
            prog.release()
            self.programs = {kk: p for kk, p in self.programs.items() if kk != key}
            prog = None
        if prog is None:
            self.misses += 1
            return None
        self.hits += 1
        return prog.run(x)

    def status(self) -> Dict[str, Any]:
        return {"buckets": list(self.buckets), "compiled": self.compiled, "hits": self.hits,
                "misses": self.misses}
