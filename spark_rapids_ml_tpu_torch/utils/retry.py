"""Bounded retries with backoff for the host-side feeding path.

The port's copy of ``spark_rapids_ml_tpu/utils/retry.py``: the fits are
pure functions of their inputs (rerunning a failed fit is always sound),
and the host loop that feeds them (file IO, a daemon's socket) is the part
that sees transient failures, retried here. Backoff is decorrelated-jittered (the AWS
"exponential backoff and jitter" rule): pure exponential backoff
synchronizes the retries of a fleet of executors, so after a daemon
restart every task would hit it again on the same schedule. Jittered
delays spread the herd; ``max_delay_s`` caps one wait, and
``deadline_s`` bounds the total time an op may spend retrying.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from spark_rapids_ml_tpu_torch.utils.logging import get_logger

_logger = get_logger(__name__)

T = TypeVar("T")


def decorrelated_jitter(
    prev_delay_s: float,
    base_delay_s: float,
    max_delay_s: float,
    rng: Optional[random.Random] = None,
) -> float:
    """Next backoff delay: ``min(cap, uniform(base, prev * 3))``. Each
    client's sequence wanders on its own instead of marching in lockstep
    powers of two."""
    draw = (rng or random).uniform(
        base_delay_s, max(prev_delay_s, base_delay_s) * 3.0
    )
    return min(max_delay_s, draw)


def with_retries(
    fn: Callable[[], T],
    max_attempts: int = 3,
    retry_on: Tuple[Type[BaseException], ...] = (OSError, IOError),
    base_delay_s: float = 0.5,
    backoff: float = 2.0,
    max_delay_s: float = 30.0,
    deadline_s: Optional[float] = None,
    rng: Optional[random.Random] = None,
) -> T:
    """Run ``fn`` with bounded retries and decorrelated-jitter backoff.

    Only exceptions in ``retry_on`` are retried; everything else raises at
    once (a deterministic error will not fix itself). ``backoff`` is kept
    for the JAX package's signature: the delays are decorrelated-jittered
    and capped at ``max_delay_s``. ``deadline_s`` bounds the total time
    across all attempts: when the next sleep would cross it, the last error
    raises instead. ``rng``: a seeded ``random.Random`` for deterministic
    tests."""
    attempt = 0
    delay = base_delay_s
    start = time.monotonic()
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt >= max_attempts:
                raise
            delay = decorrelated_jitter(delay, base_delay_s, max_delay_s, rng)
            if deadline_s is not None and time.monotonic() - start + delay > deadline_s:
                _logger.warning("retry deadline %.1fs exhausted after %d attempts: %s",
                                deadline_s, attempt, e)
                raise
            _logger.warning("retryable failure (attempt %d/%d, next in %.2fs): %s",
                            attempt, max_attempts, delay, e)
            time.sleep(delay)
