"""Fused second-moment statistics: count / column-sum / Gram matrix.

The port of ``spark_rapids_ml_tpu/ops/gram.py``. Every pass
computes the row count, the column sums and the Gram matrix, so a centred
Gram comes for free as G_c = G − n·μμᵀ (the reference stubs centring to
ETL, RapidsRowMatrix.scala:111-117).

The Gram of bfloat16/float32 operands with float32 accumulators goes
through the hand-written kernels of ``ops/kernels.py`` (on a CPU tensor,
their plain versions). Other dtype pairs — the float64 parity mode — are a
plain product in the accumulator dtype, as the JAX package leaves them to
XLA. Across ranks (``parallel/mesh.py``) each rank computes its own
rows' statistics with the same kernel and the partials meet in
``parallel/mapreduce.reduce_sum`` over the data axis (:func:`sharded_stats`,
and the streaming update given a mesh).

On a mesh with a model axis above 1 the Gram is feature-sharded
(:func:`sharded_stats_ring`): a rank holds a (rows, d/model) column block
and computes its (d/model, d) row slab of the Gram, which stays
model-sharded, so no device ever holds the full (d, d) — the path for
widths whose accumulator is over the per-device budget
(:func:`require_gram_capacity`). The blocks travel around the model ring
one at a time; the JAX package's other form, an all-gather of the full
width onto every rank, is not ported: on the card it was both slower and
larger (``PERF.md``, phase 33). The slab's products are
rectangular, which the JAX package computes with ``dot_general`` outside
its Pallas kernels; here they are library products accumulated in the
accumulator dtype.

State tuples are ``(count, colsum, gram)`` as in the JAX package; the
streaming updates fold a batch into the state IN PLACE, the analogue of the
JAX package's donated buffers.

A rank's rows are its shard and nothing is padded, so the fits pass no
mask. The masked forms (``local_stats`` with a mask,
:func:`streaming_update`) keep the JAX package's contract for padded
shards (``parallel/sharding.shard_rows``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (count, colsum, gram)

#: Byte budget for the resident (d, d) Gram accumulator on one device.
#: Override via SRML_TORCH_GRAM_DEVICE_BUDGET_MB (0 = unlimited).
GRAM_DEVICE_BUDGET_BYTES = int(os.environ.get("SRML_TORCH_GRAM_DEVICE_BUDGET_MB", 256)) << 20


class GramCapacityError(ValueError):
    """A (d, d) accumulator does not fit the per-device budget on this
    mesh — raised at fit entry instead of an opaque device OOM mid-pass."""


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def _dtype_name(dtype) -> str:
    return str(_torch_dtype(dtype)).replace("torch.", "")


def require_gram_capacity(n_cols: int, mesh=None, accum_dtype=None) -> bool:
    """Check the (d, d) accumulator against the per-device budget.

    Returns True when the fit MUST keep the Gram model-sharded end to end
    (the full matrix busts the budget but the (d/n_model, d) slab of a
    rank fits); False when a replicated accumulator is fine. Raises
    :class:`GramCapacityError` when even the slab is too big (grow
    ``mesh_model_axis``). ``mesh`` None: a model axis of 1."""
    ad = _torch_dtype(accum_dtype) if accum_dtype is not None else config.accum_dtype()
    if not GRAM_DEVICE_BUDGET_BYTES:
        return False
    n_model = 1 if mesh is None else mesh.shape[MODEL_AXIS]
    itemsize = torch.empty((), dtype=ad).element_size()
    full = n_cols * n_cols * itemsize
    if full <= GRAM_DEVICE_BUDGET_BYTES:
        return False
    slab = -(-n_cols // n_model) * n_cols * itemsize
    if slab > GRAM_DEVICE_BUDGET_BYTES:
        need = -(-full // GRAM_DEVICE_BUDGET_BYTES)
        raise GramCapacityError(
            f"the ({n_cols}, {n_cols}) {_dtype_name(ad)} Gram accumulator is "
            f"{full >> 20} MiB — over the {GRAM_DEVICE_BUDGET_BYTES >> 20} "
            f"MiB per-device budget even sharded {n_model}-way over the "
            f"'model' axis ({slab >> 20} MiB/device). Use a mesh with "
            f"mesh_model_axis >= {need} (docs/mesh.md 'Model-parallel "
            "Gram/eigh'), or raise SRML_TORCH_GRAM_DEVICE_BUDGET_MB."
        )
    return True


def mm_precision(*dtypes):
    """Context of full-precision products for float32/float64 operands —
    the JAX package's guard against TPU dots that round f32 operands to
    bf16 mantissas. The port pins full-precision float32 products for the
    whole process at import (TF32 off, ``spark_rapids_ml_tpu_torch``
    ``__init__``) and never toggles it per call, so for any dtypes there is
    nothing to switch: a null context."""
    return contextlib.nullcontext()


def _dtypes(x: torch.Tensor, compute_dtype, accum_dtype):
    cd = compute_dtype or config.compute_dtype(x.device)
    ad = accum_dtype or config.accum_dtype()
    return cd, ad


def _block_prep(x: torch.Tensor, mask: Optional[torch.Tensor], compute_dtype, accum_dtype):
    """(block in the compute dtype, that block masked, count, accumulator
    dtype); the two blocks are one tensor when there is no mask."""
    cd, ad = _dtypes(x, compute_dtype, accum_dtype)
    xc = x.to(cd)
    if mask is None:
        return xc, xc, torch.tensor(x.shape[0], dtype=ad, device=x.device), ad
    # Integer sum: a float32 sum of ones saturates at 2^24 rows.
    return xc, xc * mask.to(cd)[:, None], mask.to(torch.int64).sum().to(ad), ad


def local_stats(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    compute_dtype=None,
    accum_dtype=None,
) -> Stats:
    """Single-block fused stats. x: (m, d); mask: (m,) of {0,1} or None.

    The Gram runs in ``compute_dtype`` and accumulates in ``accum_dtype``;
    bfloat16/float32 into float32 is the masked :func:`kernels.gram`."""
    xc, xm, count, ad = _block_prep(x, mask, compute_dtype, accum_dtype)
    colsum = xm.sum(dim=0, dtype=ad)
    if kernels.kernel_applicable(xc.dtype, ad):
        m = None if mask is None else mask.to(torch.float32).contiguous()
        gram = kernels.gram(xc.contiguous(), m)
    else:
        xa = xm.to(ad)
        gram = xa.T @ xa
    return count, colsum, gram


def reduce_stats(stats, mesh) -> tuple:
    """Each statistic of a rank-local partial summed over the mesh's data
    axis, in place (:func:`~spark_rapids_ml_tpu_torch.parallel.mapreduce.reduce_sum`):
    the same replicated values on every rank."""
    return tuple(mr.reduce_sum(t, DATA_AXIS, mesh=mesh) for t in stats)


def sharded_stats(mesh, compute_dtype=None, accum_dtype=None):
    """fn(x, mask=None) → replicated (count, colsum, gram): this rank's
    rows through :func:`local_stats` (the ``gram`` kernel), then the sum
    over the ranks. A rank without rows adds a zero partial (no launch)."""

    def fn(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Stats:
        if x.shape[0] == 0:
            stats = init_stats(x.shape[1], accum_dtype, x.device)
        else:
            stats = local_stats(x, mask, compute_dtype=compute_dtype, accum_dtype=accum_dtype)
        return reduce_stats(stats, mesh)

    return fn


def _mm_accum(a: torch.Tensor, b: torch.Tensor, ad) -> torch.Tensor:
    """a @ b accumulated and returned in ``ad`` — ``dot_general`` with
    ``preferred_element_type``: a bf16 product of two bf16 tensors would
    round its output to bf16. On a CUDA build with ``mm``'s ``out_dtype``
    the f32 product of bf16 operands stays on the tensor cores; otherwise
    the operands are upcast (bf16 values are exact in f32; TF32 is off
    package-wide)."""
    if a.dtype == ad:
        return a @ b.to(ad)
    if (a.is_cuda and ad == torch.float32 and a.dtype in (torch.bfloat16, torch.float16)
            and b.dtype == a.dtype and _mm_out_dtype_on_cuda()):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(ad) @ b.to(ad)


def _mm_out_dtype_on_cuda() -> bool:
    """Whether this build's ``mm`` takes ``out_dtype`` on CUDA tensors."""
    return torch._C._dispatch_has_kernel_for_dispatch_key("aten::mm.dtype", "CUDA")


def _stats_shard_ring(x, mask, mesh, compute_dtype=None, accum_dtype=None) -> Stats:
    """2-D sharded stats of this rank's (rows, d/model) block, by a ring
    (the ring-attention pattern applied to the Gram): instead of
    all-gathering the full width onto every rank (peak (rows, d) of extra
    memory), the feature blocks rotate around the model ring
    (``ring_shift``, positions i → i + 1).
    Step s computes the (d_local, d_local) block of the block held then,
    which came from position (idx − s) mod n, into its columns; n − 1
    steps with a shift, then the last block without one (its shift would
    move the big (rows, d_local) buffer this path exists to avoid
    moving). Peak extra memory: one block. count and colsum come back
    replicated, the (d/model, d) slab model-sharded, summed over ``data``."""
    _, xc, count, ad = _block_prep(x, mask, compute_dtype, accum_dtype)
    n_model = mesh.shape[MODEL_AXIS]
    d_local = xc.shape[1]
    count = mr.reduce_sum(count, DATA_AXIS, mesh=mesh)
    colsum = mr.all_concat(xc.sum(dim=0, dtype=ad), MODEL_AXIS, axis=0, mesh=mesh)
    colsum = mr.reduce_sum(colsum, DATA_AXIS, mesh=mesh)
    idx = mesh.axis_index(MODEL_AXIS)
    perm = [(i, (i + 1) % n_model) for i in range(n_model)]
    slab = torch.zeros((d_local, n_model * d_local), dtype=ad, device=xc.device)
    held = xc
    for s in range(n_model):
        col = ((idx - s) % n_model) * d_local
        slab[:, col:col + d_local] = _mm_accum(xc.T, held, ad)
        if s < n_model - 1:
            held = mr.ring_shift(held, MODEL_AXIS, perm, mesh=mesh)
    del held
    return count, colsum, mr.reduce_sum(slab, DATA_AXIS, mesh=mesh)


def sharded_stats_ring(mesh, compute_dtype=None, accum_dtype=None):
    """fn(block, mask=None) → (count repl, colsum repl, gram model-sharded):
    :func:`_stats_shard_ring`."""

    def fn(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Stats:
        return _stats_shard_ring(x, mask, mesh, compute_dtype, accum_dtype)

    return fn


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
                          compute_dtype=None, mesh=None) -> Stats:
    """Fold the first ``n_valid`` rows of x into ``state`` in place — the
    fast streaming path.

    With bfloat16/float32 compute and a float32 state this is ONE launch
    of the seeded :func:`kernels.gram_colsum` per batch: count, Σx and
    XᵀX of the batch are added to the state inside the kernel. x should
    arrive in the compute dtype already (the ingest casts once); other
    dtypes are cast here.

    With a ``mesh`` of a started world, x is this rank's batch of the
    lockstep and ``state`` the replicated state: the batch folds into a
    fresh zero partial (what the JAX package's unseeded kernel call
    computes), which is summed over the ranks and then added to the state
    (a seeded fold of each rank's replicated state would count the state
    once per rank). A rank
    without rows in this step adds a zero partial (no launch) and still
    joins the sum."""
    count, colsum, gram = state
    cd = compute_dtype or config.compute_dtype(x.device)
    xc = x.to(cd)
    rows = min(x.shape[0], max(int(n_valid), 0))
    if mesh is not None and mesh.collective:
        part = init_stats(gram.shape[0], gram.dtype, gram.device)
        if rows:
            _fold_rows(part, xc, rows, cd)
        for t, p in zip(state, reduce_stats(part, mesh)):
            t.add_(p)
        return state
    _fold_rows(state, xc, rows, cd)
    return state


def _fold_rows(state: Stats, xc: torch.Tensor, rows: int, cd) -> None:
    count, colsum, gram = state
    if kernels.kernel_applicable(cd, gram.dtype):
        kernels.gram_colsum(xc.contiguous(), rows, state=(gram, colsum, count))
        return
    xv = xc[:rows].to(gram.dtype)
    gram.add_(xv.T @ xv)
    colsum.add_(xv.sum(dim=0))
    count.add_(rows)


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
