"""Host utilities of the port: tracing spans and timers, logging, the run
journal and the metrics registry (the JAX package's re-exports)."""

from spark_rapids_ml_tpu_torch.utils.profiling import trace_span, Timer
from spark_rapids_ml_tpu_torch.utils.logging import get_logger
from spark_rapids_ml_tpu_torch.utils import journal, metrics

__all__ = ["trace_span", "Timer", "get_logger", "journal", "metrics"]
