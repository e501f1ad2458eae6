"""Mid-fit checkpoint/resume for streaming fits.

The port's copy of ``spark_rapids_ml_tpu/core/checkpoint.py``, single
process: the accumulator state (count, Σx, XᵀX) is O(d²) and fully
determines progress, so persisting it every few batches makes a long fit
preemption-safe. Atomic write (tmp + rename): a crash mid-checkpoint never
corrupts the resume point. The files are numpy ``.npz``, the same format
the JAX package writes, so either package resumes the other's checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np


def save_state(path: str, arrays: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Atomically persist accumulator arrays + JSON-able metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
    """Load a checkpoint; None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode())
    return arrays, meta


def discard_state(path: str) -> None:
    """Remove a checkpoint if present (idempotent)."""
    try:
        os.unlink(path)
    except OSError:
        pass
