"""Mid-fit checkpoint/resume for streaming fits.

The port's copy of ``spark_rapids_ml_tpu/core/checkpoint.py``: the
accumulator state (count, Σx, XᵀX) is O(d²) and fully determines
progress, so persisting it every few batches makes a long fit
preemption-safe. Atomic write (tmp + rename): a crash mid-checkpoint never
corrupts the resume point. The files are numpy ``.npz``, the same format
the JAX package writes, so either package resumes the other's checkpoint.

Across ranks the state is replicated, so rank 0 alone writes (and on
success unlinks) the file (:func:`is_writer`), and every rank must see
the same restored-or-not state (:func:`require_consistent_visibility`):
the path must be on a filesystem all ranks share.
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


def is_writer() -> bool:
    """Whether this process writes and unlinks the checkpoints of a fit:
    rank 0 of a world, or the only process."""
    from spark_rapids_ml_tpu_torch.parallel.mesh import process_index

    return process_index() == 0


def require_consistent_visibility(restored) -> None:
    """Multi-process guard: every rank must see the same restored-or-not
    state, or the lockstep scans desync — a checkpoint visible on some
    ranks but not others means checkpoint_path is not on a shared
    filesystem. No-op in the world of one. Raises identically on all
    ranks."""
    from spark_rapids_ml_tpu_torch.parallel.distributed import process_allgather
    from spark_rapids_ml_tpu_torch.parallel.mesh import process_count

    if process_count() == 1:
        return
    flags = process_allgather(np.asarray([int(restored is not None)]))
    if flags.any() != flags.all():
        raise RuntimeError(
            "checkpoint visible on some hosts but not others; "
            "checkpoint_path must be on a shared filesystem"
        )
