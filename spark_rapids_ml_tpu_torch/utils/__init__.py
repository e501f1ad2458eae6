"""Host utilities of the port: tracing spans and timers, logging, the
metrics registry (the JAX package's re-exports, less ``journal``, which
comes with the serving plane: ROADMAP.md)."""

from spark_rapids_ml_tpu_torch.utils.profiling import trace_span, Timer
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils import metrics

__all__ = ["trace_span", "Timer", "get_logger", "metrics"]
