"""Phase-named tracing spans — the NVTX-range idiom of the reference.

The reference wraps its two fit phases in NVTX ranges (``NvtxRange("compute
cov")`` / ``NvtxRange("cuSolver SVD")``, RapidsRowMatrix.scala:62,70). The
port keeps the JAX package's phase names ("compute cov", "eig finalize",
"pca transform"). A span is a ``torch.profiler.record_function`` range,
which a ``torch.profiler`` trace records with its duration and which costs
next to nothing outside one, and, on a CUDA machine, an NVTX range. Spans
do not synchronise the device: a span around queued kernels covers their
enqueue unless its body waits for a result.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """``with trace_span("compute cov"): ...`` — a named phase."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
