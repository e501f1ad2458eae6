"""Host array -> device tensor placement helpers.

The port of ``spark_rapids_ml_tpu/parallel/sharding.py`` for one device:
placement is a copy to the fit's device (:func:`to_device`). The padding
helpers :func:`pad_rows` and :func:`bucket_rows` keep their contracts for
the multi-device slice, which pads shards; until then only the parity tests
call them. Multi-process assembly and lockstep streams wait for that slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    There is no silent CPU fallback: without a usable CUDA device a
    request for "cuda" raises. Pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def pad_rows(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows with zeros to a multiple; returns (padded, row_mask).

    The mask rides into the stats so padded rows contribute nothing to
    counts, sums or Grams."""
    n = x.shape[0]
    n_pad = (-n) % multiple
    mask = np.ones((n,), dtype=np.float32)
    if n_pad:
        x = np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], dtype=x.dtype)], axis=0)
        mask = np.concatenate([mask, np.zeros((n_pad,), dtype=np.float32)])
    return x, mask


def bucket_rows(n: int, min_bucket: int = 256) -> int:
    """Power-of-two row bucket of an ``n``-row batch (the JAX package's
    compile-bounding ladder; PyTorch runs eagerly, so the port's transform
    does not pad, but serving code may still batch to these sizes)."""
    return max(min_bucket, 1 << (n - 1).bit_length()) if n else min_bucket


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a host array as a CPU tensor sharing its memory
    (copied when read-only, as zero-copy Arrow buffers are)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array or a tensor on ``device`` (and in ``dtype`` when given)."""
    t = as_tensor(x)
    return t.to(device=device, dtype=dtype or t.dtype)

