"""Host array -> device tensor placement, and the lockstep of the ranks.

The port of ``spark_rapids_ml_tpu/parallel/sharding.py``. One rank is one
process with one device (``parallel/mesh.py``), so a rank's rows are its
shard: placement is a copy to the rank's device (:func:`to_device`), and
:func:`shard_rows` pads a rank's rows at the tail to the rows every rank
agrees on, as the JAX package pads each process's slice. The fits need no
padding (each rank's statistics cover its own rows); they take the global
row count from :func:`~spark_rapids_ml_tpu_torch.parallel.distributed.row_counts`.
On a mesh with a model axis above 1 the ranks of one data index hold the
same rows: :func:`shard_rows_2d` keeps this rank's column block, and the
row counts count each data index once.

Streams run in LOCKSTEP across ranks (:func:`lockstep_batches`): every
rank makes the same sequence of collectives, a rank whose stream ended
early yields empty batches, and a bad batch raises on every rank at once,
its flag carried through the control plane's gather (one per step, in a
``trace_span("lockstep gather")``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.parallel import mesh as mesh_mod
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span


def resolve_device(device=None, mesh: Optional[Mesh] = None) -> torch.device:
    """The device an entry point runs on: ``device``, else the mesh's
    rank device (a started world), else the card.

    There is no silent CPU fallback: without a usable CUDA device a
    request for "cuda" raises. Pass ``device="cpu"`` to run on the CPU."""
    if device is None and mesh is not None:
        device = mesh.device
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


def run_bucketed(fn, x, min_bucket: int = 256) -> np.ndarray:
    """Apply a row-wise ``fn`` to ``x`` padded to its power-of-two row
    bucket (:func:`bucket_rows`) and return the first n rows of the result
    as a host array: the JAX package's shared bucketing of batch
    predict/transform, for callers that batch to bounded shapes."""
    x = np.asarray(x)
    n = x.shape[0]
    xp, _ = pad_rows(x, bucket_rows(n, min_bucket))
    out = fn(xp)
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return out[:n]


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


class Placement(NamedTuple):
    """Where a tensor lies on a mesh: ``spec`` names the mesh axis of each
    tensor dim (None: whole on every rank) — the JAX package's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def row_sharding(mesh: Mesh, ndim: int = 2) -> Placement:
    """Rows over the data axis, everything else whole: each rank holds its
    own rows."""
    return Placement(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    """The same values on every rank."""
    return Placement(mesh, ())


def _cast_host(x: np.ndarray, dtype) -> np.ndarray:
    if x.dtype == np.float64 and np.dtype(dtype) == np.float32:
        from spark_rapids_ml_tpu_torch.bridge import native as _native

        cast = _native.cast_f64_to_f32(x)  # threaded native cast
        return cast if cast is not None else x.astype(np.float32)
    return x.astype(dtype)


def _rows_tensor(x, dtype) -> torch.Tensor:
    """A tensor as it is, or a host array as a CPU tensor; cast to the
    numpy ``dtype`` when given (float64 → float32 by the native bridge's
    threaded cast)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(getattr(torch, np.dtype(dtype).name))
    a = np.asarray(x)
    return as_tensor(a if dtype is None or a.dtype == np.dtype(dtype) else _cast_host(a, dtype))


def shard_rows(x, mesh: Mesh, dtype: Optional[Any] = None, with_mask: bool = True,
               device=None):
    """Place this rank's rows on its device: (x, mask, n_true rows).

    ``x`` is a host array (cast to the numpy ``dtype`` when given: float64
    → float32 by the native bridge's threaded cast) or a tensor. In the
    world of one the rows are placed as they are and ``n_true`` is theirs.
    Across ranks ``x`` is THIS rank's rows: the row counts are gathered,
    every rank pads its rows at the tail to the largest count (the valid
    prefix the masked statistics rely on), and ``n_true`` is the GLOBAL
    row count. ``mask`` is the (rows,) float32 {0, 1} row mask, or None
    without ``with_mask``."""
    dev = resolve_device(device, mesh)
    t = _rows_tensor(x, dtype)
    n_local = t.shape[0]
    if mesh_mod.process_count() == 1:
        n_true, rows = n_local, n_local
    else:
        from spark_rapids_ml_tpu_torch.parallel.distributed import row_counts

        counts = row_counts(n_local, mesh)
        n_true, rows = int(counts.sum()), max(1, int(counts.max()))
    t = t.to(dev)
    if rows > n_local:
        t = torch.cat([t, t.new_zeros((rows - n_local,) + tuple(t.shape[1:]))])
    mask = None
    if with_mask:
        mask = torch.zeros((rows,), dtype=torch.float32, device=dev)
        mask[:n_local] = 1.0
    return t, mask, n_true


def shard_rows_2d(x, mesh: Mesh, dtype: Optional[Any] = None, device=None):
    """Place this rank's block of a (data, model) mesh: (block, mask,
    n_true rows) — the JAX package's ``pad_rows`` + ``P(DATA, MODEL)``.

    Every rank of one data index passes the same rows at full width
    (a host array, cast to ``dtype`` when given, or a tensor); the rank
    keeps its ``(rows, d / model)`` column block at its model index. The
    rows pad at the tail to the largest data index's count, the (rows,)
    float32 mask marking the real ones, and ``n_true`` counts each data
    index once. Ranks of one data index that disagree on the row count or
    the width, and a width the model axis does not divide, raise the same
    ValueError on every rank."""
    dev = resolve_device(device, mesh)
    model = mesh.shape[MODEL_AXIS]
    t = _rows_tensor(x, dtype)
    n_local, d = t.shape
    if mesh_mod.process_count() == 1:
        shapes = np.asarray([[n_local, d]], np.int64)
    else:
        from spark_rapids_ml_tpu_torch.parallel.distributed import (
            per_data_index,
            process_allgather,
        )

        shapes = per_data_index(process_allgather(np.asarray([n_local, d], np.int64)), mesh,
                                "(rows, width)")
    if (shapes[:, 1] != d).any():
        raise ValueError(f"the data indices passed widths {shapes[:, 1].tolist()}: every rank "
                         "passes the same width")
    if d % model:
        raise ValueError(f"width {d} is not divisible by the model axis ({model})")
    d_local = d // model
    m = mesh.axis_index(MODEL_AXIS)
    rows = max(1, int(shapes[:, 0].max()))
    block = t[:, m * d_local:(m + 1) * d_local].to(dev).contiguous()
    if rows > n_local:
        block = torch.cat([block, block.new_zeros((rows - n_local, d_local))])
    mask = torch.zeros((rows,), dtype=torch.float32, device=dev)
    mask[:n_local] = 1.0
    return block, mask, int(shapes[:, 0].sum())


def replicated_array(x, mesh: Mesh, device=None) -> torch.Tensor:
    """A host array placed whole on this rank's device. Across ranks every
    rank must pass the SAME values (a query batch given to all ranks)."""
    return to_device(x, resolve_device(device, mesh))


#: The lockstep's dtype codes: the JAX package's three, and bfloat16 (a
#: tensor stream on the card).
_CODES = {"float32": 0, "float64": 1, "float16": 2, "bfloat16": 3}
# An inverse table read by key: its order reaches no fold.
_CODE_NAMES = {v: k for k, v in _CODES.items()}  # srml: disable=unsorted-iter


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _batch(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _empty(code: int, n_cols: int):
    """An empty (0, n_cols) batch in the consensus dtype (a CPU tensor for
    bfloat16, which numpy lacks)."""
    name = _CODE_NAMES[code]
    if name == "bfloat16":
        return torch.zeros((0, n_cols), dtype=torch.bfloat16)
    return np.zeros((0, n_cols), name)


def lockstep_batches(batches, n_cols: int, check=None):
    """Iterate a rank-local batch stream in LOCKSTEP across ranks.

    Every rank must make the same sequence of collectives, but ranks'
    local streams can have different lengths (uneven shards, a straggling
    reader). This yields until EVERY rank's stream is exhausted; a rank
    whose stream ended early yields empty (0, n_cols) batches, which the
    fits fold as zero partials. In the world of one: plain iteration.
    ``check(x)``: an optional validator returning an error string or None,
    carried through the gather as :func:`lockstep_labeled_batches` does.
    Batches are host arrays or tensors (kept where they lie)."""
    _dummy_y = np.zeros((0,), np.float32)
    xcheck = None if check is None else (lambda x, _y: check(x))
    for x, _ in lockstep_labeled_batches(((b, _dummy_y) for b in batches), n_cols, xcheck):
        yield x


def lockstep_labeled_batches(batches, n_cols: int, check=None):
    """``lockstep_batches`` for (x, y) pair streams (linreg/logreg scans).

    ``check(x, y)`` — optional per-batch validator returning an error
    string or None; a failure is carried THROUGH the gather so every rank
    raises the same error together instead of one rank dying locally
    while the rest wait in the next collective. A batch of a dtype other
    than float32/float64/float16/bfloat16 is cast to float32, and one
    that cannot be cast raises on every rank the same way; ranks that
    feed different dtypes raise TypeError together."""
    if mesh_mod.process_count() == 1:
        for x, y in batches:
            x, y = _batch(x), _batch(y).reshape(-1)
            if check is not None:
                err = check(x, y)
                if err:
                    raise ValueError(err)
            yield x, y
        return
    from spark_rapids_ml_tpu_torch.parallel.distributed import process_allgather

    it = iter(batches)
    while True:
        pair = next(it, None)
        code, ok = -1, 1
        cast_err = None
        if pair is not None:
            x, y = _batch(pair[0]), _batch(pair[1]).reshape(-1)
            if _dtype_name(x) not in _CODES:
                # Cast non-float sources (e.g. int features) to f32, so a
                # pipeline that works in the world of one behaves the same
                # across ranks; an uncastable dtype is carried through the
                # gather like a check failure.
                try:
                    x = x.to(torch.float32) if isinstance(x, torch.Tensor) else x.astype(np.float32)
                except (ValueError, TypeError, RuntimeError) as e:
                    cast_err = (
                        f"lockstep: batch dtype {_batch(pair[0]).dtype} "
                        f"is not castable to float32: {e}"
                    )
                    ok = 0
            if cast_err is None:
                code = _CODES[_dtype_name(x)]
                if check is not None and check(x, y):
                    ok = 0
        with trace_span("lockstep gather"):
            flags = process_allgather(np.asarray([0 if pair is None else 1, code, ok]))
        flags = flags.reshape(-1, 3)
        if (flags[:, 2] == 0).any():
            bad = int(np.argmax(flags[:, 2] == 0))
            # Re-derive the local message when this rank is the bad one.
            msg = None
            if pair is not None and ok == 0:
                msg = cast_err or check(x, y)
            raise ValueError(msg or f"batch validation failed on process {bad}")
        live = flags[flags[:, 0] == 1, 1]
        if live.size and live.min() != live.max():
            raise TypeError(
                "lockstep: feeding hosts disagree on batch dtype; make "
                "every host's loader produce the same dtype"
            )
        if not flags[:, 0].any():
            return
        if pair is None:
            yield _empty(int(live.max()), n_cols), np.zeros((0,), np.float32)
        else:
            yield x, y


def require_single_process(feature: str) -> None:
    """Fail fast (identically on every rank) for code whose host-side
    preparation depends on local data — running it across ranks would
    diverge replicated inputs or desync collectives instead of erroring."""
    if mesh_mod.process_count() > 1:
        raise NotImplementedError(
            f"{feature} is single-controller only: its host-side setup "
            f"(init/validation) is data-dependent and would diverge across "
            f"processes. Multi-process paths: fit_pca / fit_linear_regression "
            f"with per-process local rows, or the data-plane daemon on one host."
        )
