"""Exact selection primitives of the nearest-neighbour slice.

The port's copy of the selection machinery of
``spark_rapids_ml_tpu/ops/pallas_kernels.py:774-813`` and of the orders that
``lax.top_k`` and ``merge_topk`` give, in torch ops:

* packed keys: an f32 score's order-preserving int32 image with its low
  ``pos_bits`` cleared and the candidate's position OR-ed in. Keys are
  unique, so any exact selection of the smallest keys gives the same bits,
  ties of the score go to the lowest position, and the decoded values are
  the scores floored within a relative 2^(pos_bits − 24);
* :func:`lex_topk`: the k smallest (distance, id) pairs in ascending order,
  ties to the lowest id (the kneighbors contract);
* :func:`stable_topk`: the k smallest values, ties to the lowest position
  (what ``lax.top_k`` of the negated values gives).

``torch.topk`` promises no order among equal values, so the last two sort
stably; the packed keys have no equal values.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Above every packed key of a finite score.
IVF_MASKED_KEY = 0x7FFFFFFF
#: Emitted in the scan's pad rows (blk_k .. bk_pad − 1).
IVF_MASKED_D2 = 3.0e38
#: The scan's and the probe's r2/c2 sentinel on rows that must not win.
IVF_PAD_R2 = 1e30


def ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def pos_bits_for(n: int) -> int:
    """Position bits of n candidates: bit_length(ceil8(n) − 1), at least 1
    (the Pallas kernels count the TPU's 8-row padding, and the floor of the
    decoded values follows from it). Raises above 16."""
    bits = max(1, (ceil_to(n, 8) - 1).bit_length())
    if bits > 16:
        raise ValueError(f"{n} candidates are too many for packed selection (at most 65,536)")
    return bits


def sortable_int(v: torch.Tensor) -> torch.Tensor:
    """The order-preserving f32-bits ↔ int32 bijection (flip the non-sign
    bits of negatives); its own inverse. int32 in, int32 out."""
    return v ^ ((v >> 31) & 0x7FFFFFFF)


def packed_keys(scores: torch.Tensor, pos_bits: int) -> torch.Tensor:
    """Unique int32 keys of f32 scores along the last dim: the sortable
    value in the high bits, the position in the low ``pos_bits``."""
    low = (1 << pos_bits) - 1
    key = sortable_int(scores.to(torch.float32).contiguous().view(torch.int32))
    pos = torch.arange(scores.shape[-1], dtype=torch.int32, device=scores.device)
    return (key & ~low) | pos


def decode_keys(keys: torch.Tensor, pos_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(floored f32 values, int32 positions) of packed keys."""
    pos = keys & ((1 << pos_bits) - 1)
    return sortable_int(keys ^ pos).view(torch.float32), pos


def packed_extract(keys: torch.Tensor, count: int, pos_bits: int):
    """The ``count`` smallest keys along the last dim, ascending, decoded:
    (values (..., count) f32, positions (..., count) int32)."""
    smallest = torch.topk(keys, count, dim=-1, largest=False, sorted=True).values
    return decode_keys(smallest, pos_bits)


def lex_topk(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest (d, id) pairs along the last dim in ascending
    lexicographic order: (d (..., k), ids (..., k))."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    d1, i1 = d.gather(-1, by_id), ids.gather(-1, by_id)
    order = torch.argsort(d1, dim=-1, stable=True)[..., :k]
    return d1.gather(-1, order), i1.gather(-1, order)


def stable_topk(values: torch.Tensor, k: int):
    """The k smallest values along the last dim, ascending, ties to the
    lowest position: (values (..., k), positions (..., k) int64)."""
    order = torch.argsort(values, dim=-1, stable=True)[..., :k]
    return values.gather(-1, order), order
