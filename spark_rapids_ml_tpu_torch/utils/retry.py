"""Backoff for the data-feeding path's reconnect loops.

The port's copy of the part of ``spark_rapids_ml_tpu/utils/retry.py`` that
the port's client uses. Backoff is decorrelated-jittered (the AWS
"exponential backoff and jitter" rule): pure exponential backoff
synchronizes the retries of a fleet of executors, so after a daemon
restart every task would hit it again on the same schedule. Jittered
delays spread the herd; ``max_delay_s`` caps one wait.
"""

from __future__ import annotations

import random
from typing import Optional


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
