"""Fused second-moment statistics: count / column-sum / Gram matrix.

The port of ``spark_rapids_ml_tpu/ops/gram.py`` for one device. Every pass
computes the row count, the column sums and the Gram matrix, so a centred
Gram comes for free as G_c = G − n·μμᵀ (the reference stubs centring to
ETL, RapidsRowMatrix.scala:111-117).

The Gram of bfloat16/float32 operands with float32 accumulators goes
through the hand-written kernels of ``ops/kernels.py`` (on a CPU tensor,
their plain versions). Other dtype pairs — the float64 parity mode — are a
plain product in the accumulator dtype, as the JAX package leaves them to
XLA. The 2-D/ring feature-sharded Gram and multi-device reductions are
not part of this slice.

State tuples are ``(count, colsum, gram)`` as in the JAX package; the
streaming updates fold a batch into the state IN PLACE, the analogue of the
JAX package's donated buffers.

On one device nothing is padded, so the fits pass no mask. The masked
forms (``local_stats`` with a mask, :func:`streaming_update`) keep the JAX
package's contract for the multi-device slice, which pads shards; until
then only the parity tests call them.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.ops import kernels

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (count, colsum, gram)

#: Byte budget for the resident (d, d) Gram accumulator on one device.
#: Override via SRML_TORCH_GRAM_DEVICE_BUDGET_MB (0 = unlimited).
GRAM_DEVICE_BUDGET_BYTES = int(os.environ.get("SRML_TORCH_GRAM_DEVICE_BUDGET_MB", 256)) << 20


class GramCapacityError(ValueError):
    """A (d, d) accumulator does not fit the per-device budget — raised at
    fit entry instead of an opaque device OOM mid-pass."""


def require_gram_capacity(n_cols: int, accum_dtype=None) -> None:
    """Check the (d, d) accumulator against the per-device budget.

    The port runs on one device and has no model-sharded Gram yet, so a
    width over the budget raises :class:`GramCapacityError`."""
    ad = accum_dtype or config.accum_dtype()
    full = n_cols * n_cols * torch.empty((), dtype=ad).element_size()
    if GRAM_DEVICE_BUDGET_BYTES and full > GRAM_DEVICE_BUDGET_BYTES:
        raise GramCapacityError(
            f"the ({n_cols}, {n_cols}) {ad} Gram accumulator is {full >> 20} MiB — "
            f"over the {GRAM_DEVICE_BUDGET_BYTES >> 20} MiB per-device budget; "
            "raise SRML_TORCH_GRAM_DEVICE_BUDGET_MB"
        )


def _dtypes(x: torch.Tensor, compute_dtype, accum_dtype):
    cd = compute_dtype or config.compute_dtype(x.device)
    ad = accum_dtype or config.accum_dtype()
    return cd, ad


def local_stats(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    compute_dtype=None,
    accum_dtype=None,
) -> Stats:
    """Single-block fused stats. x: (m, d); mask: (m,) of {0,1} or None.

    The Gram runs in ``compute_dtype`` and accumulates in ``accum_dtype``;
    bfloat16/float32 into float32 is the masked :func:`kernels.gram`."""
    cd, ad = _dtypes(x, compute_dtype, accum_dtype)
    xc = x.to(cd)
    if mask is not None:
        xm = xc * mask.to(cd)[:, None]
        # Integer sum: a float32 sum of ones saturates at 2^24 rows.
        count = mask.to(torch.int64).sum().to(ad)
    else:
        xm = xc
        count = torch.tensor(x.shape[0], dtype=ad, device=x.device)
    colsum = xm.sum(dim=0, dtype=ad)
    if kernels.kernel_applicable(cd, ad):
        m = None if mask is None else mask.to(torch.float32).contiguous()
        gram = kernels.gram(xc.contiguous(), m)
    else:
        xa = xm.to(ad)
        gram = xa.T @ xa
    return count, colsum, gram


def init_stats(n_cols: int, accum_dtype=None, device=None) -> Stats:
    ad = accum_dtype or config.accum_dtype()
    return (
        torch.zeros((), dtype=ad, device=device),
        torch.zeros((n_cols,), dtype=ad, device=device),
        torch.zeros((n_cols, n_cols), dtype=ad, device=device),
    )


def streaming_update(state: Stats, x: torch.Tensor, mask: torch.Tensor,
                     compute_dtype=None) -> Stats:
    """Fold the masked stats of one batch into ``state`` in place."""
    count, colsum, gram = state
    c, s, g = local_stats(x, mask, compute_dtype=compute_dtype, accum_dtype=gram.dtype)
    count.add_(c)
    colsum.add_(s)
    gram.add_(g)
    return state


def streaming_update_rows(state: Stats, x: torch.Tensor, n_valid: int,
                          compute_dtype=None) -> Stats:
    """Fold the first ``n_valid`` rows of x into ``state`` in place — the
    fast streaming path.

    With bfloat16/float32 compute and a float32 state this is ONE launch
    of the seeded :func:`kernels.gram_colsum` per batch: count, Σx and
    XᵀX of the batch are added to the state inside the kernel. x should
    arrive in the compute dtype already (the ingest casts once); other
    dtypes are cast here."""
    count, colsum, gram = state
    cd = compute_dtype or config.compute_dtype(x.device)
    xc = x.to(cd)
    if kernels.kernel_applicable(cd, gram.dtype):
        kernels.gram_colsum(xc.contiguous(), n_valid, state=(gram, colsum, count))
        return state
    rows = min(x.shape[0], max(int(n_valid), 0))
    xv = xc[:rows].to(gram.dtype)
    gram.add_(xv.T @ xv)
    colsum.add_(xv.sum(dim=0))
    count.add_(rows)
    return state


def finalize_gram(
    count: torch.Tensor,
    colsum: torch.Tensor,
    gram: torch.Tensor,
    mean_center: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count, colsum, gram) -> (G, mean).

    ``mean_center=True``: G = Σxxᵀ − n·μμᵀ, the Gram of centred data.
    ``False``: the raw Gram, the reference's ``cov.reduce(_+_)`` semantics
    (RapidsRowMatrix.scala:139 — no centring, no normalisation)."""
    n = torch.clamp(count, min=1)
    mean = colsum / n
    g = gram - torch.outer(mean, colsum) if mean_center else gram
    return g, mean
