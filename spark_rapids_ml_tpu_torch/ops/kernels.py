"""Wrappers of the hand-written Hopper kernels, and their plain versions.

The counterpart of ``spark_rapids_ml_tpu/ops/pallas_kernels.py`` for the
PCA slice:

* :func:`gram` — the masked Gram (X·m)ᵀ(X·m), f32 accumulate; replaces
  ``gram_pallas`` (pallas_kernels.py:78).
* :func:`gram_colsum` — count, Σx and XᵀX of the first ``n_valid`` rows in
  one pass, optionally folded into a ``(gram, colsum, count)`` state in
  place; replaces ``gram_colsum_pallas`` (pallas_kernels.py:173).

Both kernels live in ``csrc/gram.cu`` (design notes there). A wrapper takes
its plain PyTorch version only for a tensor on the CPU; for a CUDA tensor
it launches the kernel or raises — there is no fallback. Each launch adds
one to :data:`LAUNCHES`, so a run can show that it went through the
kernels. The plain versions repeat the kernels' arithmetic (f32 products of
the input values, f32 sums; TF32 is off for the whole package, see
``__init__``) and are what the kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops import _build

#: Kernel launches by wrapper name (the plain versions do not count).
LAUNCHES = {"gram": 0, "gram_colsum": 0}

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

GramState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (gram, colsum, count)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gram")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srml_gram.argtypes = [ptr, i32, ptr, i64, i64, ptr, ptr]
    lib.srml_gram.restype = i32
    lib.srml_gram_colsum.argtypes = [ptr, i32, i64, i64, i64, ptr, ptr, ptr, ptr]
    lib.srml_gram_colsum.restype = i32
    return lib


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be an (n, d) matrix with d >= 1, got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x must lie on the CPU or a CUDA device, got {x.device}")


def _check_f32(t: torch.Tensor, shape, device: torch.device, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_args(x: torch.Tensor):
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")
    return x.data_ptr(), int(x.dtype == torch.bfloat16)


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {rc}")


# ---------------------------------------------------------------------------
# Masked Gram
# ---------------------------------------------------------------------------


def gram_plain(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x·m)ᵀ(x·m) in float32 (both factors masked, so the weight is m²)."""
    xm = x.float() if mask is None else x.float() * mask.float()[:, None]
    return xm.T @ xm


def gram(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked Gram of an (n, d) float32/bfloat16 matrix; (n,) float32 mask,
    or None for all rows.

    Any n and d: the kernel masks the ragged edges itself (the Pallas
    kernel's divisibility demands were tiling artefacts)."""
    _check_x(x)
    n, d = x.shape
    if mask is not None:
        _check_f32(mask, (n,), x.device, "mask")
    if x.device.type == "cpu":
        return gram_plain(x, mask)
    xp, is_bf16 = _launch_args(x)
    out = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().srml_gram(
            xp, is_bf16, None if mask is None else mask.data_ptr(), n, d, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(rc, "gram")
    LAUNCHES["gram"] += 1
    return out


# ---------------------------------------------------------------------------
# Fused count + column sum + Gram of the first n_valid rows
# ---------------------------------------------------------------------------


def _zero_state(d: int, device: torch.device) -> GramState:
    return (
        torch.zeros((d, d), dtype=torch.float32, device=device),
        torch.zeros((d,), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device),
    )


def gram_colsum_plain(
    x: torch.Tensor, n_valid: int, state: Optional[GramState] = None
) -> GramState:
    """Plain version of :func:`gram_colsum`, same in-place contract."""
    n, d = x.shape
    rows = min(n, max(int(n_valid), 0))
    g, cs, c = _zero_state(d, x.device) if state is None else state
    xv = x[:rows].float()
    g.add_(xv.T @ xv)
    cs.add_(xv.sum(dim=0))
    c.add_(float(rows))
    return g, cs, c


def gram_colsum(
    x: torch.Tensor, n_valid: int, state: Optional[GramState] = None
) -> GramState:
    """(gram (d, d), colsum (d,), count ()) float32 over the first
    ``n_valid`` rows of x — the one-pass streaming moment statistic.

    ``state``: a float32 ``(gram, colsum, count)`` to fold the batch into
    IN PLACE (the seeded Pallas kernel's one-dispatch ``state += batch``;
    the JAX package reaches the same through buffer donation). The
    returned tensors are then the state's own. Without it, fresh zeroed
    accumulators are filled and returned."""
    _check_x(x)
    n, d = x.shape
    if state is not None:
        for t, shape, name in zip(state, ((d, d), (d,), ()), ("gram", "colsum", "count")):
            _check_f32(t, shape, x.device, name)
    if x.device.type == "cpu":
        return gram_colsum_plain(x, n_valid, state)
    xp, is_bf16 = _launch_args(x)
    g, cs, c = _zero_state(d, x.device) if state is None else state
    with torch.cuda.device(x.device):
        rc = _lib().srml_gram_colsum(
            xp, is_bf16, n, d, int(n_valid), g.data_ptr(), cs.data_ptr(), c.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(rc, "gram_colsum")
    LAUNCHES["gram_colsum"] += 1
    return g, cs, c
