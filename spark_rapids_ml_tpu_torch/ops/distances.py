"""Pairwise squared-Euclidean distances via the Gram trick.

The port of ``spark_rapids_ml_tpu/ops/distances.py``: ‖x−y‖² = ‖x‖² + ‖y‖²
− 2⟨x,y⟩, one matrix product plus rank-1 updates. The product is a plain
``torch.matmul`` of the operands rounded to the compute dtype and widened
to the accumulator dtype (the JAX package's ``preferred_element_type``;
TF32 is off package-wide), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch


def sq_euclidean(x: torch.Tensor, y: torch.Tensor, accum_dtype=torch.float32) -> torch.Tensor:
    """(m, d) × (k, d) → (m, k) squared distances, clipped at 0; x and y
    already in the compute dtype."""
    xy = x.to(accum_dtype) @ y.to(accum_dtype).T
    x2 = torch.sum(torch.square(x.to(accum_dtype)), dim=1)
    y2 = torch.sum(torch.square(y.to(accum_dtype)), dim=1)
    d = x2[:, None] + y2[None, :] - 2.0 * xy
    return torch.clamp(d, min=0.0)


#: The largest k of the fused distance top-k (``DIST_TOPK_MAX_K``,
#: pallas_kernels.py:618).
DIST_TOPK_MAX_K = 64


def dist_topk_applicable(k: int, m: int, accum_dtype) -> bool:
    """Whether an exact kneighbors scan goes through ``dist_topk``: float32
    accumulators (the kernel emits f32 distances) and 0 < k ≤ min(64, m).
    The shape half of the JAX package's ``fused_topk_fits``; its VMEM term
    does not apply to the card."""
    return accum_dtype == torch.float32 and 0 < k <= min(DIST_TOPK_MAX_K, m)


def first_argmin(scores: torch.Tensor) -> torch.Tensor:
    """Row-wise argmin with ties to the LOWEST index (``jnp.argmin``'s
    rule). ``torch.argmin`` on CUDA does not promise which of equal
    minima it returns, so the rule is written out."""
    best = scores.min(dim=1, keepdim=True).values
    idx = torch.arange(scores.shape[1], device=scores.device)
    return torch.where(scores == best, idx, scores.shape[1]).min(dim=1).values
