"""Wrappers of the hand-written Hopper kernels, and their plain versions.

The counterpart of ``spark_rapids_ml_tpu/ops/pallas_kernels.py`` for the
PCA, LinearRegression, KMeans and LogisticRegression slices:

* :func:`gram` — the masked Gram (X·m)ᵀ(X·m), f32 accumulate; replaces
  ``gram_pallas`` (pallas_kernels.py:78).
* :func:`gram_colsum` — count, Σx and XᵀX of the first ``n_valid`` rows in
  one pass, optionally folded into a ``(gram, colsum, count)`` state in
  place; replaces ``gram_colsum_pallas`` (pallas_kernels.py:173).
* :func:`linreg_stats` — XᵀX, Xᵀy, Σx, Σy, Σy² and the row count over
  masked rows in one pass, optionally folded into a state in place;
  replaces ``linreg_stats_pallas`` (pallas_kernels.py:1210).
* :func:`lloyd_step` — one Lloyd step's per-centre sums and counts of the
  first ``n_valid`` rows; replaces ``lloyd_step_pallas``
  (pallas_kernels.py:314).
* :func:`assign_min_dist` — per row, the nearest centre and ‖c‖² − 2x·c;
  replaces ``assign_min_dist_pallas`` (pallas_kernels.py:561).
* :func:`newton_stats` — one binomial Newton-IRLS pass: Xᵀr, Σr,
  Xᵀdiag(wgt)X, Xᵀwgt and Σwgt at (w, b); replaces ``newton_stats_pallas``
  (pallas_kernels.py:451).
* :func:`softmax_curvature` — per class, Xᵀdiag(p_c)X and Xᵀp_c; replaces
  ``softmax_curvature_pallas`` (pallas_kernels.py:1135).
* :func:`dist_topk` — per query the exact k nearest rows by squared
  distance in (distance, id) order; replaces ``dist_topk_pallas``
  (pallas_kernels.py:678).
* :func:`probe_select` — per query the nprobe nearest IVF centroids at
  full f32 on packed keys; replaces ``probe_select_pallas``
  (pallas_kernels.py:984).
* :func:`ivf_scan_select` — per IVF list and query slot the best blk_k
  residual scores on packed keys; replaces ``ivf_scan_select_pallas``
  (pallas_kernels.py:860).

The Gram family, LogisticRegression's weighted Grams included, lives in
``csrc/gram.cu``, the KMeans pair in ``csrc/kmeans.cu``, the
nearest-neighbour kernels in ``csrc/knn.cu`` (design notes there).
``gram.cu`` has two SYRK bodies over the upper-triangle tile pairs: a
CUDA-core FFMA body (f32, and bf16 it cannot route) and, for bfloat16
``gram`` without a mask, ``gram_colsum``, ``linreg_stats``,
``newton_stats`` and ``softmax_curvature`` with d % 8 == 0, a tensor-core
body (wgmma fed by TMA; the weighted pair rounds its Hessian operand to
bf16 as the Pallas kernels do); :func:`gram_route` says which a launch
takes, :func:`gram_plan` and :func:`ffma_gram_plan` lay out the launch.
``kmeans.cu`` has two bodies too: FFMA tiles, and for bfloat16 with
d % 8 == 0 a tensor-core scoring body (wgmma fed by TMA, an argmin
epilogue with ties to the lowest index); :func:`kmeans_route` and
:func:`kmeans_plan` choose the body and the launch (a fused Lloyd pass,
or the assignment then a sums pass). ``knn.cu``'s bfloat16
``ivf_scan_select`` and ``dist_topk`` take the same streamed scoring
layout with a top-k epilogue (:func:`scan_route`, :func:`scan_stages`,
:func:`topk_route`, :func:`topk_stages`); ``probe_select`` runs as one
fused launch whose last block of each query tile merges its blocks' lists, or as keys then a
sort (:func:`probe_route`). A
wrapper takes its plain PyTorch
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises — there is no fallback. Each launch adds one to
:data:`LAUNCHES` (and, for the eight routed kernels, to :data:`ROUTES`),
so a run can show that it went through the kernels, and records
the call in the kernel ledger (``utils/xprof.py``) under its kernel's name
and route, with the call's bound operation and byte counts; a CPU call of
the plain version records under route ``plain`` (and counts no launch). A
launch inside a CUDA-graph capture (``serve/aot.py``) counts once for every
replay of the graph instead (:func:`credit_launches`). The
plain versions repeat the kernels' arithmetic (f32 products of the input
values, f32 sums; TF32 is off for the whole package, see ``__init__``;
ties of the nearest centre to the lowest index; the selections of
``ops/selection.py``) and are what the kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.ops import selection as sel
from spark_rapids_ml_tpu_torch.ops.distances import DIST_TOPK_MAX_K, first_argmin
from spark_rapids_ml_tpu_torch.utils import xprof

#: Kernel launches by wrapper name (the plain versions do not count).
LAUNCHES = {"gram": 0, "gram_colsum": 0, "linreg_stats": 0, "lloyd_step": 0,
            "assign_min_dist": 0, "newton_stats": 0, "softmax_curvature": 0,
            "dist_topk": 0, "probe_select": 0, "ivf_scan_select": 0}

#: Launches of the routed kernels by "<kernel>/<route>": "wgmma" is the
#: tensor-core body of ``gram.cu``, ``kmeans.cu`` or ``knn.cu``, "ffma" its
#: CUDA-core body; ``probe_select`` is "fused" (one launch) or "sort" (keys,
#: then a sort launch).
ROUTES = {f"{k}/{r}": 0 for k in ("gram", "gram_colsum", "linreg_stats", "newton_stats",
                                  "softmax_curvature", "lloyd_step", "assign_min_dist",
                                  "ivf_scan_select", "dist_topk")
          for r in ("wgmma", "ffma")}
ROUTES.update({f"probe_select/{r}": 0 for r in ("fused", "sort")})

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: The tensor-core body's geometry (``csrc/gram.cu``): 128 x 128 tiles of G,
#: 64-row stages, at most 65535 row splits (gridDim.y).
TC_TILE, TC_STAGE_ROWS, TC_MAX_SPLITS = 128, 64, 65535
#: Stages between promotions of the wgmma accumulator into the CUDA-core
#: f32 accumulator (0: once, at the end of the split).
TC_PROMOTE_STAGES = 4
#: A block's fixed cost (prologue, epilogue), in stages, for choosing splits.
TC_BLOCK_OVERHEAD_STAGES = 16
#: The FFMA SYRK body's longest f32 sum per register, in rows: its splits.
FFMA_SPLIT_ROWS = 8192


def kernel_applicable(compute_dtype: torch.dtype, accum_dtype: torch.dtype) -> bool:
    """Whether a data pass goes through the kernels: bfloat16/float32
    operands with float32 accumulators, at any shape. Other pairs (the
    float64 parity mode) are plain products in the accumulator dtype."""
    return compute_dtype in KERNEL_DTYPES and accum_dtype == torch.float32

GramState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (gram, colsum, count)
# (xtx, xty, sx, sy, syy, n), all float32
LinregState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor]
# (gw, gb, hww, hwb, hbb), all float32
NewtonStats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: Rows per step of the plain KMeans versions: bounds their (rows, k)
#: score matrices at the main path's 16.7M rows.
PLAIN_ROW_CHUNK = 1 << 20
#: Entries of one score matrix of the plain nearest-neighbour versions.
PLAIN_SCORE_ELEMS = 1 << 26
#: Rows per step of a row-norm pass (bounds its f32 copy of the rows).
NORM_ROW_CHUNK = 1 << 16


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def credit_launches(calls, times: int = 1) -> None:
    """Add ``times`` to the counts of each kernel launch among ``calls`` (the
    calls a CUDA-graph capture kept, ``utils/xprof.recording``): 1 for every
    replay of the graph, −1 once to take back the counts the wrappers added
    while the capture ran, which launched nothing. Plain calls count no
    launch."""
    for name, route, *_ in calls:
        if route == "plain":
            continue
        LAUNCHES[name] += times
        if f"{name}/{route}" in ROUTES:
            ROUTES[f"{name}/{route}"] += times


def _ledger(name: str, route: str, device: torch.device, flops: float, nbytes: float,
            *sig_args):
    """The kernel ledger's record of one call (``utils/xprof.kernel``)."""
    return xprof.kernel(name, route, sig_args, flops, nbytes, device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gram")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srml_gram.argtypes = [ptr, i32, ptr, i64, i64, ptr, i32, i64, i64, ptr, ptr]
    lib.srml_gram.restype = i32
    lib.srml_gram_tc.argtypes = [ptr, i64, i64, ptr, i32, i64, i64, i32, ptr, ptr]
    lib.srml_gram_tc.restype = i32
    lib.srml_gram_colsum.argtypes = [ptr, i32, i64, i64, i64, ptr, i32, i64, i64, ptr, ptr, ptr,
                                     ptr]
    lib.srml_gram_colsum.restype = i32
    lib.srml_linreg_stats.argtypes = [ptr, i32, ptr, ptr, i64, i64, ptr, i32, i64, i64, ptr, ptr,
                                      ptr, ptr, ptr, ptr, ptr]
    lib.srml_linreg_stats.restype = i32
    lib.srml_gram_colsum_tc.argtypes = [ptr, i64, i64, i64, ptr, i32, i64, i64, i32, ptr, ptr,
                                        ptr, ptr]
    lib.srml_gram_colsum_tc.restype = i32
    lib.srml_linreg_stats_tc.argtypes = [ptr, ptr, ptr, i64, i64, ptr, i32, i64, i64, i32, ptr,
                                         ptr, ptr, ptr, ptr, ptr, ptr]
    lib.srml_linreg_stats_tc.restype = i32
    lib.srml_newton_stats.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i64, i64, ptr, i32, i64, i64,
                                      ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.srml_newton_stats.restype = i32
    lib.srml_newton_stats_tc.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr, i32, i64, i64,
                                         i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.srml_newton_stats_tc.restype = i32
    lib.srml_softmax_curvature.argtypes = [ptr, i32, ptr, i64, i64, i32, ptr, i32, i64, i64,
                                           ptr, ptr, ptr]
    lib.srml_softmax_curvature.restype = i32
    lib.srml_softmax_curvature_tc.argtypes = [ptr, ptr, i64, i64, i32, ptr, i32, i64, i64, i32,
                                              ptr, ptr, ptr]
    lib.srml_softmax_curvature_tc.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _kmeans_lib() -> ctypes.CDLL:
    lib = _build.load("kmeans")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srml_lloyd_step.argtypes = [ptr, ptr, i32, ptr, i64, i64, i64, i64, ptr, ptr, ptr]
    lib.srml_lloyd_step.restype = i32
    lib.srml_assign_min_dist.argtypes = [ptr, ptr, i32, ptr, i64, i64, i64, ptr, ptr, ptr]
    lib.srml_assign_min_dist.restype = i32
    lib.srml_lloyd_sums.argtypes = [ptr, i32, ptr, i64, i64, i64, i32, i32, i64, ptr, ptr, ptr]
    lib.srml_lloyd_sums.restype = i32
    lib.srml_lloyd_step_tc.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, i32, i32, ptr, ptr, ptr]
    lib.srml_lloyd_step_tc.restype = i32
    lib.srml_assign_min_dist_tc.argtypes = [ptr, ptr, ptr, i64, i64, i64, i32, i32, i32, ptr, ptr,
                                            ptr]
    lib.srml_assign_min_dist_tc.restype = i32
    lib.srml_kmeans_tc_smem.argtypes = [i32, i32, i64, i64, i32, i32]
    lib.srml_kmeans_tc_smem.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _knn_lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.srml_dist_topk.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i64, i64, i64, i32, i32, ptr,
                                   ptr, ptr]
    lib.srml_dist_topk.restype = i32
    lib.srml_probe_select.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, i32, ptr,
                                      ptr, ptr, ptr]
    lib.srml_probe_select.restype = i32
    lib.srml_ivf_scan_select.argtypes = [ptr, ptr, i32, ptr, i64, i64, i64, i64, i32, i32, i32,
                                         ptr, ptr, ptr, ptr]
    lib.srml_ivf_scan_select.restype = i32
    lib.srml_scan_needs_scratch.argtypes = [i32]
    lib.srml_scan_needs_scratch.restype = i32
    lib.srml_ivf_scan_select_tc.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, i32, i32, i32, i32,
                                            ptr, ptr, ptr]
    lib.srml_ivf_scan_select_tc.restype = i32
    lib.srml_ivf_scan_tc_smem.argtypes = [i32, i32]
    lib.srml_ivf_scan_tc_smem.restype = i32
    lib.srml_dist_topk_tc.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, i32, ptr,
                                      ptr, ptr, ptr]
    lib.srml_dist_topk_tc.restype = i32
    lib.srml_dist_topk_tc_smem.argtypes = [i32, i32]
    lib.srml_dist_topk_tc_smem.restype = i32
    lib.srml_probe_select_fused.argtypes = [ptr, ptr, i64, i64, i64, i32, i32, ptr, ptr, ptr, ptr,
                                            ptr]
    lib.srml_probe_select_fused.restype = i32
    lib.srml_probe_fused_smem.argtypes = [i32]
    lib.srml_probe_fused_smem.restype = i32
    return lib


def load_libraries() -> None:
    """Build (when needed) and load the three kernel libraries, so every
    later launch finds its library cached. A daemon calls this before it
    listens, with no lock held: an ``nvcc`` build takes seconds."""
    _lib()
    _kmeans_lib()
    _knn_lib()


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
    if rc == 1998:
        raise RuntimeError(f"{kernel} kernel not launched: ptxas did not give the tensor-core "
                           "body the registers its setmaxnreg balance assumes")
    if rc == 1999:
        raise RuntimeError(f"{kernel} kernel not launched: the driver has no "
                           "cuTensorMapEncodeTiled")
    if rc >= 1000:
        raise RuntimeError(f"{kernel} kernel not launched: cuTensorMapEncodeTiled failed with "
                           f"CUresult {rc - 1000}")
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {rc}")


# ---------------------------------------------------------------------------
# The tensor-core Gram body: route and launch plan
# ---------------------------------------------------------------------------


class GramPlan(NamedTuple):
    """A tensor-core launch: ``pairs`` are the (i, j) tiles of G with
    i <= j that blockIdx.x walks, each once per class (blockIdx.x =
    pair · classes + class); blockIdx.y walks ``splits`` row splits of
    ``split_rows`` rows each (a multiple of TC_STAGE_ROWS), which cover the
    rows; the wgmma accumulator is promoted every ``promote`` stages."""

    pairs: Tuple[Tuple[int, int], ...]
    splits: int
    split_rows: int
    promote: int
    classes: int = 1


def tc_tile_pairs(d: int) -> Tuple[Tuple[int, int], ...]:
    """The upper-triangle tile pairs (i <= j) of a (d, d) Gram in 128 x 128
    tiles, row by row: t(t + 1)/2 of them for t = ceil(d / 128)."""
    t = -(-d // TC_TILE)
    return tuple((i, j) for i in range(t) for j in range(i, t))


@functools.lru_cache(maxsize=256)
def tc_row_splits(rows: int, n_pairs: int, sms: int) -> Tuple[int, int]:
    """(splits, split_rows) for ``rows`` rows over ``n_pairs`` tile pairs
    on ``sms`` SMs, one block per SM: the split count whose blocks finish
    soonest, counting whole waves of (per-block stages + a block's fixed
    cost). Zero rows take one empty split."""
    stages = -(-rows // TC_STAGE_ROWS)
    if stages == 0:
        return 1, TC_STAGE_ROWS
    best = None
    for want in range(1, min(stages, TC_MAX_SPLITS) + 1):
        per = -(-stages // want)
        splits = -(-stages // per)  # the splits that hold rows
        waves = -(-n_pairs * splits // sms)
        cost = (waves * (per + TC_BLOCK_OVERHEAD_STAGES), splits)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    return splits, per * TC_STAGE_ROWS


def gram_plan(d: int, rows: int, sms: int, classes: int = 1) -> GramPlan:
    """The tensor-core launch plan for ``rows`` rows of an (n, d) matrix
    and ``classes`` weight columns (``softmax_curvature``; else 1) on a card
    of ``sms`` SMs."""
    pairs = tc_tile_pairs(d)
    splits, split_rows = tc_row_splits(max(int(rows), 0), len(pairs) * classes, sms)
    return GramPlan(pairs, splits, split_rows, TC_PROMOTE_STAGES, classes)


def gram_route(x: torch.Tensor, *outs: torch.Tensor, masked: bool = False) -> str:
    """Which body of ``gram.cu`` a ``gram``/``gram_colsum``/``linreg_stats``/
    ``newton_stats``/``softmax_curvature`` launch on x takes: "wgmma" for
    bfloat16 with d % 8 == 0 (TMA needs a 16-byte row stride), at least
    one row, and x and the outputs 16-byte aligned; "ffma" otherwise
    (float32 stays in full f32 FFMA: TF32 is off). ``masked``: a ``gram``
    with a mask, which stays on the FFMA body (the tensor cores would round
    x·m to bf16 for a mask outside {0, 1}; the Pallas kernel multiplies in
    f32)."""
    n, d = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *outs))
    tc = x.dtype == torch.bfloat16 and d % 8 == 0 and n > 0 and aligned and not masked
    return "wgmma" if tc else "ffma"


def ffma_gram_plan(d: int, rows: int, classes: int = 1) -> GramPlan:
    """The FFMA SYRK body's launch plan: the same upper-triangle tile pairs
    as the tensor-core body, each once per class, over row splits of at
    most FFMA_SPLIT_ROWS rows (a multiple of TC_STAGE_ROWS; at most
    TC_MAX_SPLITS of them), so that no f32 register sums more rows than the
    splits hold; no promotion (its sums are f32 FFMA throughout)."""
    rows = max(int(rows), 0)
    splits = max(1, min(-(-rows // FFMA_SPLIT_ROWS), TC_MAX_SPLITS))
    per = -(-rows // splits)
    split_rows = max(1, -(-per // TC_STAGE_ROWS)) * TC_STAGE_ROWS
    return GramPlan(tc_tile_pairs(d), splits, split_rows, 0, classes)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _pairs_on(d: int, device: torch.device) -> torch.Tensor:
    """The (n_pairs, 2) int32 tile pairs of :func:`tc_tile_pairs` on the
    device, made once per (d, device)."""
    return torch.tensor(tc_tile_pairs(d), dtype=torch.int32, device=device).contiguous()


def _tc_plan_args(x: torch.Tensor, rows: int, classes: int = 1):
    """The plan arguments of a tensor-core launch: pairs pointer, pair
    count, splits, split rows, promotion interval."""
    n, d = x.shape
    plan = gram_plan(d, rows, _sm_count(x.device), classes)
    pairs = _pairs_on(d, x.device)
    return pairs.data_ptr(), len(plan.pairs), plan.splits, plan.split_rows, plan.promote


def _ffma_plan_args(x: torch.Tensor, rows: int, classes: int = 1):
    """The plan arguments of an FFMA launch: pairs pointer, pair count,
    splits, split rows."""
    d = x.shape[1]
    plan = ffma_gram_plan(d, rows, classes)
    return _pairs_on(d, x.device).data_ptr(), len(plan.pairs), plan.splits, plan.split_rows


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
    kernel's divisibility demands were tiling artefacts). The route
    (:func:`gram_route`): bfloat16 with no mask on the tensor-core SYRK,
    everything else on the FFMA SYRK (f32 products of the input values)."""
    _check_x(x)
    n, d = x.shape
    if mask is not None:
        _check_f32(mask, (n,), x.device, "mask")
    # Bound counts: x (and the mask) read, G written; nd(d+1) for the
    # symmetric G.
    work = (n * d * (d + 1), n * d * x.element_size() + (0 if mask is None else 4 * n) + 4 * d * d,
            x, mask)
    if x.device.type == "cpu":
        with _ledger("gram", "plain", x.device, *work):
            return gram_plain(x, mask)
    xp, is_bf16 = _launch_args(x)
    out = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    route = gram_route(x, out, masked=mask is not None)
    with _ledger("gram", route, x.device, *work), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            rc = _lib().srml_gram_tc(xp, n, d, *_tc_plan_args(x, n), out.data_ptr(), stream)
        else:
            rc = _lib().srml_gram(xp, is_bf16, None if mask is None else mask.data_ptr(), n, d,
                                  *_ffma_plan_args(x, n), out.data_ptr(), stream)
        _raise_on(rc, "gram")
    LAUNCHES["gram"] += 1
    ROUTES[f"gram/{route}"] += 1
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
    # Bound counts over the rows folded: x read, the state read and written
    # (written only, when fresh); nd(d+1) for the symmetric G, nd for Σx.
    r = min(n, max(int(n_valid), 0))
    work = (r * d * (d + 1) + r * d,
            r * d * x.element_size() + (1 if state is None else 2) * 4 * (d * d + d + 1),
            x, r, state is not None)
    if x.device.type == "cpu":
        with _ledger("gram_colsum", "plain", x.device, *work):
            return gram_colsum_plain(x, n_valid, state)
    xp, is_bf16 = _launch_args(x)
    g, cs, c = _zero_state(d, x.device) if state is None else state
    route = gram_route(x, g)
    with _ledger("gram_colsum", route, x.device, *work), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            rc = _lib().srml_gram_colsum_tc(
                xp, n, d, int(n_valid), *_tc_plan_args(x, r), g.data_ptr(), cs.data_ptr(),
                c.data_ptr(), stream,
            )
        else:
            rc = _lib().srml_gram_colsum(
                xp, is_bf16, n, d, int(n_valid),
                *_ffma_plan_args(x, r), g.data_ptr(), cs.data_ptr(),
                c.data_ptr(), stream,
            )
        _raise_on(rc, "gram_colsum")
    LAUNCHES["gram_colsum"] += 1
    ROUTES[f"gram_colsum/{route}"] += 1
    return g, cs, c


# ---------------------------------------------------------------------------
# Fused normal-equation statistics
# ---------------------------------------------------------------------------


def _zero_linreg_state(d: int, device: torch.device) -> LinregState:
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return z(d, d), z(d), z(d), z(), z(), z()


def linreg_stats_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    state: Optional[LinregState] = None,
) -> LinregState:
    """Plain version of :func:`linreg_stats`, same in-place contract."""
    xtx, xty, sx, sy, syy, n = _zero_linreg_state(x.shape[1], x.device) if state is None else state
    xm, ym = x.float(), y.float()
    if mask is not None:
        xm = xm * mask[:, None]
        ym = ym * mask
    xtx.add_(xm.T @ xm)
    xty.add_(xm.T @ ym)
    sx.add_(xm.sum(dim=0))
    sy.add_(ym.sum())
    syy.add_((ym * ym).sum())
    n.add_(x.shape[0] if mask is None else (mask != 0).sum())
    return xtx, xty, sx, sy, syy, n


def linreg_stats(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    state: Optional[LinregState] = None,
) -> LinregState:
    """(xtx (d, d), xty (d,), sx (d,), sy, syy, n) float32 over the rows of
    an (n, d) float32/bfloat16 matrix, weighted by an (n,) float32 {0,1}
    mask (None: every row): with xm = x·m and ym = y·m, XᵀX and Xᵀy of
    xm and ym, Σxm, Σym, Σym², and n = the rows with m ≠ 0, counted as
    an integer. y: (n,) float32.

    ``state``: six float32 tensors to fold the batch into IN PLACE (the
    JAX package's donated streaming state); the returned tensors are then
    the state's own. Without it, fresh zeroed accumulators are filled."""
    _check_x(x)
    n, d = x.shape
    _check_f32(y, (n,), x.device, "y")
    if mask is not None:
        _check_f32(mask, (n,), x.device, "mask")
    if state is not None:
        shapes = ((d, d), (d,), (d,), (), (), ())
        for t, shape, name in zip(state, shapes, ("xtx", "xty", "sx", "sy", "syy", "n")):
            _check_f32(t, shape, x.device, name)
    # Bound counts: x, y (and the mask) read, the state read and written
    # (written only, when fresh); nd(d+1) for the symmetric XᵀX, 3nd for
    # Xᵀy and Σx.
    work = (n * d * (d + 1) + 3 * n * d,
            n * d * x.element_size() + 4 * n + (0 if mask is None else 4 * n)
            + (1 if state is None else 2) * (4 * (d * d + 2 * d) + 12),
            x, mask, state is not None)
    if x.device.type == "cpu":
        with _ledger("linreg_stats", "plain", x.device, *work):
            return linreg_stats_plain(x, y, mask, state)
    xp, is_bf16 = _launch_args(x)
    out = _zero_linreg_state(d, x.device) if state is None else state
    xtx, xty, sx, sy, syy, cnt = out
    rows = torch.zeros((), dtype=torch.int64, device=x.device)
    route = gram_route(x, xtx)
    mp = None if mask is None else mask.data_ptr()
    with _ledger("linreg_stats", route, x.device, *work), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            rc = _lib().srml_linreg_stats_tc(
                xp, mp, y.data_ptr(), n, d, *_tc_plan_args(x, n), xtx.data_ptr(),
                xty.data_ptr(), sx.data_ptr(), sy.data_ptr(), syy.data_ptr(), rows.data_ptr(),
                stream,
            )
        else:
            rc = _lib().srml_linreg_stats(
                xp, is_bf16, mp, y.data_ptr(), n, d, *_ffma_plan_args(x, n), xtx.data_ptr(),
                xty.data_ptr(), sx.data_ptr(), sy.data_ptr(), syy.data_ptr(), rows.data_ptr(),
                stream,
            )
        _raise_on(rc, "linreg_stats")
    LAUNCHES["linreg_stats"] += 1
    ROUTES[f"linreg_stats/{route}"] += 1
    cnt.add_(rows)  # one rounding of the exact integer count into the f32 state
    return out


# ---------------------------------------------------------------------------
# KMeans: one Lloyd step, and the nearest centre per row
# ---------------------------------------------------------------------------


class KMeansPlan(NamedTuple):
    """A KMeans launch (``csrc/kmeans.cu``). ``fused``: a Lloyd step in one
    pass (sums beside the scoring); else the scoring pass writes an (n,)
    index scratch and a sums pass follows. Tensor-core route: centre
    chunks of ``width`` (a :data:`KMEANS_WIDTHS` entry), ``resident`` in
    shared memory or streamed beside x, a ring of ``stages``. Sums pass:
    blocks of ``slab`` columns x ``kchunk`` centres x one of ``splits`` row
    splits (0 when there is none)."""

    fused: bool
    width: int
    resident: bool
    stages: int
    slab: int = 0
    kchunk: int = 0
    splits: int = 0


#: Centre chunk widths of the tensor-core scoring body, the wgmma n values
#: ``kmeans.cu`` instantiates: 104, the narrowest multiple of 8 that holds
#: the KMeans path's k = 100 in one chunk with room for its fused pass, for
#: every k <= 104 (a smaller k pads: the same tensor-core issue as k = 100,
#: under the card's balance, and 104·d·2 bytes of resident centres), and
#: 256, the widest wgmma, in chunks for every larger k.
KMEANS_WIDTHS = (104, 256)
#: The shared memory a block may use, and the ring depth the body allows.
KMEANS_SMEM_LIMIT, KMEANS_MAX_STAGES = 232448, 8
#: The FFMA body's scoring buffers (two 32 x 132 f32 panels, 128 rows' best).
KMEANS_FFMA_SCORE_SMEM = (2 * 32 * 132 + 2 * 128) * 4
#: The sums pass: threads a block (one column each, at most this many
#: columns a slab), the shared memory it aims at (two blocks an SM) and
#: the blocks it aims at per SM.
SUMS_THREADS, SUMS_SMEM_TARGET, SUMS_BLOCKS_PER_SM = 512, 100 * 1024, 4


def kmeans_width(k: int) -> int:
    """The centre chunk width for k centres: the smallest width that holds
    them all, or chunks of 256."""
    return next((w for w in KMEANS_WIDTHS if w >= k), KMEANS_WIDTHS[-1])


def kmeans_smem_bytes(fused: bool, width: int, k: int, d: int, resident: bool,
                      stages: int) -> int:
    """Shared memory of a tensor-core launch, a copy of ``tc_layout``'s
    total in kmeans.cu (``srml_kmeans_tc_smem``; chip_smoke.py's phase 2
    holds the two equal): the ring, the resident centres, the fused pass's
    f32 sums, the score constants (resident: every chunk's; streamed: two
    chunk buffers for each consumer warpgroup), the fused pass's per-stage
    assignments and counts, the mbarriers and 1 KB of alignment slack."""
    kboxes, chunks = -(-d // 64), -(-k // width)
    stage = kboxes * 8192 if resident else 2 * 8192 + 128 * width
    off = stages * stage + (chunks * kboxes * 128 * width if resident else 0)
    if fused:
        off += 4 * k * d
    off += 4 * (chunks if resident else 4) * width
    if fused:
        off += 4 * stages * 64 + 4 * k
    off = -(-off // 8) * 8 + 8 * (3 * stages + 1)
    return off + 1024


def _tc_stages(fused: bool, width: int, k: int, d: int, resident: bool) -> int:
    """The deepest ring (at most KMEANS_MAX_STAGES) that fits, or 0."""
    for stages in range(KMEANS_MAX_STAGES, 0, -1):
        if kmeans_smem_bytes(fused, width, k, d, resident, stages) <= KMEANS_SMEM_LIMIT:
            return stages
    return 0


def sums_plan(k: int, d: int, rows: int, sms: int) -> Tuple[int, int, int]:
    """(slab, kchunk, splits) of the two-pass Lloyd step's sums pass: all k
    centres a block when at least 8 columns (or all d) of them fit the
    shared-memory target, else 8-column slabs over centre chunks; then
    row splits for about SUMS_BLOCKS_PER_SM blocks an SM."""
    per = SUMS_SMEM_TARGET // 4  # floats (a count takes one per centre)
    slab = min(d, SUMS_THREADS, per // k - 1) if per // k - 1 >= 1 else 0
    if slab >= min(d, 8):
        slab = slab if slab >= d or slab < 8 else slab // 8 * 8
        kchunk = k
    else:
        slab = min(d, 8)
        kchunk = per // (slab + 1)
    blocks = -(-d // slab) * -(-k // kchunk)
    splits = max(1, min(-(-SUMS_BLOCKS_PER_SM * sms // blocks), -(-max(rows, 1) // 64), 65535))
    return slab, kchunk, splits


def kmeans_plan(k: int, d: int, route: str, rows: int, sms: int,
                lloyd: bool = True) -> KMeansPlan:
    """The launch plan of a ``lloyd_step`` (``lloyd``) or ``assign_min_dist``
    over ``rows`` rows of an (n, d) matrix against k centres on a card of
    ``sms`` SMs. A Lloyd step is fused when its (k, d) f32 sums fit in
    shared memory beside the scoring (tensor cores: the resident centres
    and a two-stage ring; FFMA: the tile buffers); otherwise it is two
    passes, the assignment and then the sums pass of :func:`sums_plan`,
    and no row is scored twice. Centres that do not fit in shared memory
    beside a two-stage ring are streamed, whose shared memory does not
    grow with k or d: every k and d has a tensor-core plan."""
    width = kmeans_width(k)
    if route == "wgmma":
        if lloyd:
            stages = _tc_stages(True, width, k, d, True)
            if stages >= 2:
                return KMeansPlan(True, width, True, stages)
        resident = _tc_stages(False, width, k, d, True) >= 2
        plan = KMeansPlan(False, width, resident, _tc_stages(False, width, k, d, resident))
    else:
        fused = lloyd and KMEANS_FFMA_SCORE_SMEM + 4 * k * (d + 1) <= KMEANS_SMEM_LIMIT
        plan = KMeansPlan(fused, 0, False, 0)
    if lloyd and not plan.fused:
        plan = plan._replace(**dict(zip(("slab", "kchunk", "splits"), sums_plan(k, d, rows, sms))))
    return plan


def kmeans_route(x: torch.Tensor, centers: torch.Tensor, *outs: torch.Tensor) -> str:
    """Which body of ``kmeans.cu`` a ``lloyd_step``/``assign_min_dist``
    launch on x takes: "wgmma" for bfloat16 with d % 8 == 0 (TMA needs a
    16-byte row stride), at least one row, and x, the centres and the
    outputs 16-byte aligned; "ffma" otherwise (float32 stays in full f32
    FFMA: TF32 is off)."""
    n, d = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, centers, *outs))
    return "wgmma" if x.dtype == torch.bfloat16 and d % 8 == 0 and n > 0 and aligned else "ffma"


def center_norms(centers: torch.Tensor, half: bool) -> torch.Tensor:
    """float32 ‖c‖² (or ½‖c‖²) of centres already in the compute dtype —
    the scores' constant terms, as the Pallas wrappers compute them."""
    c = centers.float()
    norms = (c * c).sum(dim=1)
    return 0.5 * norms if half else norms


def _check_centers(x: torch.Tensor, centers: torch.Tensor) -> None:
    if centers.dim() != 2 or centers.shape[0] == 0 or centers.shape[1] != x.shape[1]:
        raise ValueError(
            f"centers must be a (k, {x.shape[1]}) matrix with k >= 1, got {tuple(centers.shape)}"
        )
    if centers.dtype != x.dtype:
        raise TypeError(f"centers must be {x.dtype} like x, got {centers.dtype}")
    if centers.device != x.device:
        raise ValueError(f"centers are on {centers.device}, x on {x.device}")
    if not centers.is_contiguous():
        raise ValueError("centers must be contiguous")


def _nearest(x: torch.Tensor, c: torch.Tensor, cn: torch.Tensor, scale: float):
    """(argmin, min) over centres of cn − scale·(x·c), ties to the lowest
    index, for float32 rows x and centres c."""
    scores = cn[None, :] - scale * (x @ c.T)
    assign = first_argmin(scores)
    return assign, scores.gather(1, assign[:, None])[:, 0]


def lloyd_step_plain(x: torch.Tensor, centers: torch.Tensor, n_valid: int):
    """Plain version of :func:`lloyd_step`."""
    k, d = centers.shape
    rows = min(x.shape[0], max(int(n_valid), 0))
    c = centers.float()
    c2h = center_norms(centers, half=True)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
    for r0 in range(0, rows, PLAIN_ROW_CHUNK):
        xv = x[r0:min(rows, r0 + PLAIN_ROW_CHUNK)].float()
        assign, _ = _nearest(xv, c, c2h, 1.0)
        sums.index_add_(0, assign, xv)
        counts += torch.bincount(assign, minlength=k)
    return sums, counts.float()


def lloyd_sums_plain(x: torch.Tensor, idx: torch.Tensor, k: int):
    """Plain version of the two-pass Lloyd step's sums pass: (sums (k, d),
    counts (k,)) float32 of the first len(idx) rows of x, row r added to
    centre idx[r]."""
    rows = idx.shape[0]
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
    for r0 in range(0, rows, PLAIN_ROW_CHUNK):
        a = idx[r0:r0 + PLAIN_ROW_CHUNK].long()
        sums.index_add_(0, a, x[r0:r0 + a.shape[0]].float())
        counts += torch.bincount(a, minlength=k)
    return sums, counts.float()


def lloyd_step(x: torch.Tensor, centers: torch.Tensor, n_valid: int):
    """One Lloyd step over the first ``n_valid`` rows of an (n, d)
    float32/bfloat16 matrix: each row goes to the centre of least
    ½‖c‖² − x·c (ties to the lowest index); returns (sums (k, d), counts
    (k,)) float32 per centre. centers: (k, d) in x's dtype. Counts are
    summed as integers, so they are exact.

    The route (:func:`kmeans_route`) picks the body and :func:`kmeans_plan`
    the launch: one fused pass, or the assignment into an (n,) index
    scratch and a sums pass (no row is scored twice). Any n, d and k ≥ 1:
    the Pallas kernel's k_pad lanes, pad sentinel and dead lane were tiling
    artefacts the port does not carry over."""
    _check_x(x)
    _check_centers(x, centers)
    n, d = x.shape
    k = centers.shape[0]
    rows = min(n, max(int(n_valid), 0))
    # Bound counts over the rows assigned: x and the centres read, sums and
    # counts written; 2nkd for the distances, nd adds for the sums.
    work = (2 * rows * k * d + rows * d,
            rows * d * x.element_size() + k * d * centers.element_size() + 4 * k * d + 8 * k,
            x, centers, rows)
    if x.device.type == "cpu":
        with _ledger("lloyd_step", "plain", x.device, *work):
            return lloyd_step_plain(x, centers, n_valid)
    xp, is_bf16 = _launch_args(x)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
    route = kmeans_route(x, centers, sums)
    plan = kmeans_plan(k, d, route, rows, _sm_count(x.device))
    with _ledger("lloyd_step", route, x.device, *work), torch.cuda.device(x.device):
        lib = _kmeans_lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.fused:
            c2h = center_norms(centers, half=True)
            if route == "wgmma":
                rc = lib.srml_lloyd_step_tc(
                    xp, centers.data_ptr(), c2h.data_ptr(), n, d, k, int(n_valid), plan.width,
                    plan.stages, sums.data_ptr(), counts.data_ptr(), stream,
                )
            else:
                rc = lib.srml_lloyd_step(
                    xp, centers.data_ptr(), is_bf16, c2h.data_ptr(), n, d, k, int(n_valid),
                    sums.data_ptr(), counts.data_ptr(), stream,
                )
        else:
            # The assignment pass scores ‖c‖² − 2x·c, twice ½‖c‖² − x·c
            # exactly: the same argmin, bit for bit.
            idx = torch.empty((max(rows, 1),), dtype=torch.int32, device=x.device)
            rc = _assign_launch(lib, route, plan, x, centers, rows, idx, None, stream)
            if rc == 0:
                rc = lib.srml_lloyd_sums(
                    xp, is_bf16, idx.data_ptr(), rows, d, k, plan.slab, plan.kchunk, plan.splits,
                    sums.data_ptr(), counts.data_ptr(), stream,
                )
        _raise_on(rc, "lloyd_step")
    LAUNCHES["lloyd_step"] += 1
    ROUTES[f"lloyd_step/{route}"] += 1
    return sums, counts.float()


def _assign_launch(lib, route, plan, x, centers, m, idx, dist, stream) -> int:
    """The assignment launch over the first m rows of x on ``route``."""
    c2 = center_norms(centers, half=False)
    k, d = centers.shape
    dp = None if dist is None else dist.data_ptr()
    if route == "wgmma":
        return lib.srml_assign_min_dist_tc(
            x.data_ptr(), centers.data_ptr(), c2.data_ptr(), m, d, k, plan.width,
            int(plan.resident), plan.stages, idx.data_ptr(), dp, stream,
        )
    return lib.srml_assign_min_dist(
        x.data_ptr(), centers.data_ptr(), int(x.dtype == torch.bfloat16), c2.data_ptr(), m, d, k,
        idx.data_ptr(), dp, stream,
    )


def assign_min_dist_plain(x: torch.Tensor, centers: torch.Tensor):
    """Plain version of :func:`assign_min_dist`."""
    c = centers.float()
    c2 = center_norms(centers, half=False)
    parts = [_nearest(x[r0:r0 + PLAIN_ROW_CHUNK].float(), c, c2, 2.0)
             for r0 in range(0, x.shape[0], PLAIN_ROW_CHUNK)]
    if not parts:
        return (torch.zeros((0,), dtype=torch.int32, device=x.device),
                torch.zeros((0,), dtype=torch.float32, device=x.device))
    return (torch.cat([a for a, _ in parts]).to(torch.int32),
            torch.cat([v for _, v in parts]))


def assign_min_dist(x: torch.Tensor, centers: torch.Tensor):
    """(assignments (m,) int32, partial distances (m,) float32) of an
    (m, d) float32/bfloat16 matrix against (k, d) centres in its dtype:
    per row the argmin of ‖c‖² − 2x·c (ties to the lowest index) and that
    minimum. The distances omit the row constant ‖x‖², as in the JAX
    package (``assign_min_dist_pallas``); callers add it back. The route
    (:func:`kmeans_route`) picks the body."""
    _check_x(x)
    _check_centers(x, centers)
    m, d = x.shape
    k = centers.shape[0]
    # Bound counts: x and the centres read, two (m,) outputs written; 2mkd.
    work = (2 * m * k * d, m * d * x.element_size() + k * d * centers.element_size() + 8 * m,
            x, centers)
    if x.device.type == "cpu":
        with _ledger("assign_min_dist", "plain", x.device, *work):
            return assign_min_dist_plain(x, centers)
    _launch_args(x)
    idx = torch.empty((m,), dtype=torch.int32, device=x.device)
    dist = torch.empty((m,), dtype=torch.float32, device=x.device)
    route = kmeans_route(x, centers, idx, dist)
    plan = kmeans_plan(k, d, route, m, _sm_count(x.device), lloyd=False)
    with _ledger("assign_min_dist", route, x.device, *work), torch.cuda.device(x.device):
        rc = _assign_launch(_kmeans_lib(), route, plan, x, centers, m, idx, dist,
                            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(rc, "assign_min_dist")
    LAUNCHES["assign_min_dist"] += 1
    ROUTES[f"assign_min_dist/{route}"] += 1
    return idx, dist


# ---------------------------------------------------------------------------
# LogisticRegression: one binomial Newton pass, the multinomial curvature
# ---------------------------------------------------------------------------


def newton_stats_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor],
    w: torch.Tensor,
    b: torch.Tensor,
) -> NewtonStats:
    """Plain version of :func:`newton_stats`."""
    xf = x.float()
    p = torch.sigmoid(xf @ w + b)
    r = p - y
    wgt = torch.clamp(p * (1.0 - p), min=1e-10)
    if mask is not None:
        r = r * mask
        wgt = wgt * mask
    return xf.T @ r, r.sum(), (xf * wgt[:, None]).T @ xf, xf.T @ wgt, wgt.sum()


def newton_stats(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor],
    w: torch.Tensor,
    b: torch.Tensor,
) -> NewtonStats:
    """One binomial Newton-IRLS pass over the rows of an (n, d)
    float32/bfloat16 matrix at (w (d,), b ()) float32: with z = x·w + b,
    p = σ(z), r = (p − y)·m and wgt = max(p(1 − p), 1e-10)·m, the fresh
    float32 sums (Xᵀr (d,), Σr (), Xᵀdiag(wgt)X (d, d), Xᵀwgt (d,),
    Σwgt ()). y: (n,) float32; mask: (n,) float32 or None for every row.

    w, b, z, p, r and wgt stay float32 and x converts exactly: the Pallas
    kernel's bf16 roundings of w and r are not carried over. The Hessian
    alone differs by route (:func:`gram_route`): on the tensor-core route
    (bfloat16, d % 8 == 0) its operand is bf16(x·bf16(wgt)), rounded as
    the Pallas kernel rounds it (pallas_kernels.py:437), within 2⁻⁸ of the
    f32-weighted sum's Σ|terms|; on the FFMA route wgt stays float32. The
    gradient and borders are float32 on both. Any n and d (no block_n
    divisibility)."""
    _check_x(x)
    n, d = x.shape
    _check_f32(y, (n,), x.device, "y")
    if mask is not None:
        _check_f32(mask, (n,), x.device, "mask")
    _check_f32(w, (d,), x.device, "w")
    _check_f32(b, (), x.device, "b")
    if x.device.type == "cpu":
        with _ledger("newton_stats", "plain", x.device, *_newton_work(x, mask)):
            return newton_stats_plain(x, y, mask, w, b)
    return newton_stats_launch(x, y, mask, w, b)[:5]


def _newton_work(x, mask):
    """Bound counts of a Newton pass: x, y, w, b (and the mask) read, the
    five sums written; nd(d+1) for the symmetric Hessian, 6nd for x·w, Xᵀr
    and Xᵀwgt."""
    n, d = x.shape
    return (n * d * (d + 1) + 6 * n * d,
            n * d * x.element_size() + 4 * n + (0 if mask is None else 4 * n) + 4 * d + 4
            + 4 * (d * d + 2 * d + 2), x, mask)


def newton_stats_launch(x, y, mask, w, b):
    """The launch of :func:`newton_stats` on checked CUDA tensors: its five
    sums, then the row pass's (n,) float32 residual and weight, the
    weights the Gram pass read."""
    n, d = x.shape
    xp, is_bf16 = _launch_args(x)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=x.device)  # noqa: E731
    gw, gb, hww, hwb, hbb = z(d), z(), z(d, d), z(d), z()
    resid = torch.empty((n,), dtype=torch.float32, device=x.device)
    wgt = torch.empty((n,), dtype=torch.float32, device=x.device)
    route = gram_route(x, hww)
    mp = None if mask is None else mask.data_ptr()
    outs = (resid.data_ptr(), wgt.data_ptr(), gw.data_ptr(), gb.data_ptr(), hww.data_ptr(),
            hwb.data_ptr(), hbb.data_ptr())
    with _ledger("newton_stats", route, x.device, *_newton_work(x, mask)), \
            torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            rc = _lib().srml_newton_stats_tc(
                xp, y.data_ptr(), mp, w.data_ptr(), b.data_ptr(), n, d, *_tc_plan_args(x, n),
                *outs, stream,
            )
        else:
            rc = _lib().srml_newton_stats(
                xp, is_bf16, y.data_ptr(), mp, w.data_ptr(), b.data_ptr(), n, d,
                *_ffma_plan_args(x, n), *outs, stream,
            )
        _raise_on(rc, "newton_stats")
    LAUNCHES["newton_stats"] += 1
    ROUTES[f"newton_stats/{route}"] += 1
    return gw, gb, hww, hwb, hbb, resid, wgt


def softmax_curvature_plain(x: torch.Tensor, p: torch.Tensor):
    """Plain version of :func:`softmax_curvature`: one product per class."""
    xf = x.float()
    hw = torch.stack([(xf * p[:, c:c + 1]).T @ xf for c in range(p.shape[1])])
    return hw, p.T @ xf


def softmax_curvature(x: torch.Tensor, p: torch.Tensor):
    """Per class c of the (n, C) float32 weights p (softmax probabilities,
    already masked), the curvature block Xᵀdiag(p_c)X and the border
    Xᵀp_c of an (n, d) float32/bfloat16 matrix: (hw (C, d, d), hwb (C, d))
    float32, fresh sums.

    The border's p_c stays float32. The curvature differs by route
    (:func:`gram_route`): on the tensor-core route (bfloat16, d % 8 == 0)
    its operand is bf16(x·bf16(p_c)), rounded as the Pallas kernel rounds
    it (pallas_kernels.py:1117), within 2⁻⁸ of the f32-weighted sum's
    Σ|terms|; on the FFMA route p_c stays float32. Any n, d and
    1 <= C <= 65535 (no block_n or block_c demands)."""
    _check_x(x)
    n, d = x.shape
    if p.dim() != 2 or p.shape[0] != n or not 1 <= p.shape[1] <= 65535:
        raise ValueError(f"p must be an ({n}, C) matrix with 1 <= C <= 65535, got {tuple(p.shape)}")
    _check_f32(p, tuple(p.shape), x.device, "p")
    n_classes = p.shape[1]
    # Bound counts: x and p read, the (C, d, d) and (C, d) sums written;
    # C·nd(d+1) for the symmetric blocks, 2Cnd for Xᵀp_c.
    work = (n_classes * n * d * (d + 1) + 2 * n_classes * n * d,
            n * d * x.element_size() + 4 * n * n_classes + 4 * n_classes * (d * d + d), x, p)
    if x.device.type == "cpu":
        with _ledger("softmax_curvature", "plain", x.device, *work):
            return softmax_curvature_plain(x, p)
    xp, is_bf16 = _launch_args(x)
    hw = torch.zeros((n_classes, d, d), dtype=torch.float32, device=x.device)
    hwb = torch.zeros((n_classes, d), dtype=torch.float32, device=x.device)
    route = gram_route(x, hw)
    with _ledger("softmax_curvature", route, x.device, *work), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            pt = p.T.contiguous()  # (C, n): a stage's weights of one class are contiguous
            rc = _lib().srml_softmax_curvature_tc(
                xp, pt.data_ptr(), n, d, n_classes, *_tc_plan_args(x, n, n_classes),
                hw.data_ptr(), hwb.data_ptr(), stream,
            )
        else:
            rc = _lib().srml_softmax_curvature(
                xp, is_bf16, p.data_ptr(), n, d, n_classes, *_ffma_plan_args(x, n, n_classes),
                hw.data_ptr(), hwb.data_ptr(), stream,
            )
        _raise_on(rc, "softmax_curvature")
    LAUNCHES["softmax_curvature"] += 1
    ROUTES[f"softmax_curvature/{route}"] += 1
    return hw, hwb


# ---------------------------------------------------------------------------
# Nearest neighbours: exact distance top-k, IVF probe, IVF list scan
# ---------------------------------------------------------------------------


def row_sq_norms(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """‖x‖² per row of x as it is (the values a product reads), summed in
    ``dtype``, in row chunks: a widened copy of all of x would be 2–4× x."""
    out = torch.empty((x.shape[0],), dtype=dtype, device=x.device)
    for r0 in range(0, x.shape[0], NORM_ROW_CHUNK):
        out[r0:r0 + NORM_ROW_CHUNK] = torch.sum(
            torch.square(x[r0:r0 + NORM_ROW_CHUNK].to(dtype)), dim=1)
    return out


def _chunk_rows(rows: int, cols: int) -> int:
    """Rows per step that keep a (rows, cols) score matrix within
    PLAIN_SCORE_ELEMS entries."""
    return max(1, min(rows, PLAIN_SCORE_ELEMS // max(cols, 1)))


def dist_topk_norms(db: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """r2 of :func:`dist_topk`: the f32 squared norms of the rows as the
    product reads them (compute dtype), +inf on rows with mask 0. An index
    computes it once and passes it to every call."""
    r2 = row_sq_norms(db)
    return torch.where(mask > 0, r2, torch.full_like(r2, float("inf")))


def dist_topk_plain(queries: torch.Tensor, db: torch.Tensor, row_ids: torch.Tensor,
                    mask: torch.Tensor, k: int, r2: Optional[torch.Tensor] = None):
    """Plain version of :func:`dist_topk`: f32 products of the input values
    over db chunks, each merged into the running best in (distance, id)
    order."""
    q2 = row_sq_norms(queries)
    r2 = dist_topk_norms(db, mask) if r2 is None else r2
    nq, m = queries.shape[0], db.shape[0]
    qf = queries.float()
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=db.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=db.device)
    step = _chunk_rows(m, nq)
    for r0 in range(0, m, step):
        qr = qf @ db[r0:r0 + step].float().T
        d2 = torch.clamp((q2[:, None] + r2[None, r0:r0 + step]) - 2.0 * qr, min=0.0)
        ids = row_ids[r0:r0 + step].expand(nq, -1)
        best_d, best_i = sel.lex_topk(torch.cat([best_d, d2], 1), torch.cat([best_i, ids], 1), k)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def dist_topk_splits(nq: int, m: int, sms: int) -> int:
    """db splits of an FFMA :func:`dist_topk` launch: enough (query tile,
    split) blocks for about four waves of two blocks per SM, at most one
    split per 128-row tile."""
    q_tiles = -(-nq // 128)
    m_tiles = -(-m // 128)
    return max(1, min(m_tiles, -(-8 * sms // q_tiles), 65535))


#: The tensor-core top-k (``knn.cu``'s ``dist_topk_tc_kernel``): db rows per
#: chunk (the wgmma's N), queries per task, the deepest ring, the sorted
#: lists (one per consumer thread, two per query) and the candidates a list
#: takes in one round of inserts.
TOPK_CHUNK, TOPK_TILE, TOPK_MAX_STAGES, TOPK_LISTS, TOPK_ROUND = 256, 128, 4, 256, 8
#: The shared memory a block may use.
TOPK_SMEM_LIMIT = 232448


def topk_smem_bytes(k: int, stages: int) -> int:
    """Shared memory of a tensor-core dist_topk launch whose lists hold k
    keys, a copy of ``topk_layout``'s total in knn.cu
    (``srml_dist_topk_tc_smem``; chip_smoke.py's phase 2 holds the two
    equal): the ring (two 64-query slabs and one 256-row db slab a stage),
    two chunk buffers of r2 and of ids for each consumer warpgroup, a round's
    u64 candidates, the lists of k u64 keys and their int32 rows, the
    mbarriers and 1 KB of alignment slack."""
    off = (stages * (2 * 8192 + 128 * TOPK_CHUNK) + 2 * (4 * 4 * TOPK_CHUNK)
           + 8 * TOPK_LISTS * TOPK_ROUND + 12 * TOPK_LISTS * k)
    return -(-off // 8) * 8 + 8 * 2 * stages + 1024


def topk_stages(k: int) -> int:
    """The deepest ring (at most TOPK_MAX_STAGES) that fits beside lists of
    k keys, or 0."""
    for stages in range(TOPK_MAX_STAGES, 0, -1):
        if topk_smem_bytes(k, stages) <= TOPK_SMEM_LIMIT:
            return stages
    return 0


#: The largest k the tensor-core top-k takes: its lists of k keys leave room
#: for a two-stage ring. Larger k (up to DIST_TOPK_MAX_K) keep the FFMA tiles.
TOPK_TC_MAX_K = max(k for k in range(1, DIST_TOPK_MAX_K + 1) if topk_stages(k) >= 2)


def topk_splits(nq: int, m: int, sms: int) -> int:
    """db splits of a tensor-core :func:`dist_topk` launch, in 256-row
    chunks: about eight (split, query tile) tasks per SM for its persistent
    blocks, at most one split per chunk."""
    q_tiles = -(-nq // TOPK_TILE)
    chunks = -(-m // TOPK_CHUNK)
    return max(1, min(chunks, -(-8 * sms // q_tiles)))


def topk_route(queries: torch.Tensor, db: torch.Tensor, k: int) -> str:
    """Which body of ``knn.cu`` a ``dist_topk`` launch takes: "wgmma" for
    bfloat16 with d % 8 == 0 (TMA needs a 16-byte row stride), queries and
    db 16-byte aligned, at least one query and row, and k <= TOPK_TC_MAX_K;
    "ffma" otherwise (float32, the IVF build's spill candidates included,
    stays in full f32 FFMA, never TF32)."""
    d = db.shape[1]
    aligned = queries.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0
    tc = (db.dtype == torch.bfloat16 and d % 8 == 0 and aligned and k <= TOPK_TC_MAX_K
          and queries.shape[0] * db.shape[0] > 0)
    return "wgmma" if tc else "ffma"


def dist_topk(queries: torch.Tensor, db: torch.Tensor, row_ids: torch.Tensor,
              mask: torch.Tensor, k: int, r2: Optional[torch.Tensor] = None):
    """Exact kneighbors core: per query of ``queries`` (q, d) the ``k`` ≤ 64
    smallest max(q2 + r2 − 2q·r, 0) over the rows of ``db`` (m, d), both
    float32 or both bfloat16 (the compute dtype), in ascending (distance,
    id) order, ties to the lowest id: (dists (q, k) f32, ids (q, k) int32).

    ``row_ids``: (m,) int32 ids of the rows; ``mask``: (m,) f32, rows with
    mask 0 score +inf; slots without a finite candidate are (+inf, −1).
    q2 and r2 are the f32 squared norms of the values the product reads;
    ``r2`` may be passed precomputed (:func:`dist_topk_norms` of the same db
    and mask: an index keeps it beside its rows). Any q, m ≥ k and d (no
    tiling demands). The route (:func:`topk_route`): bfloat16 with d % 8 ==
    0 and k ≤ TOPK_TC_MAX_K on the tensor-core scoring body, its distances
    recomputed in f32 FFMA; else the FFMA tiles."""
    _check_x(db)
    m, d = db.shape
    if queries.dim() != 2 or queries.shape[1] != d or queries.dtype != db.dtype:
        raise ValueError(f"queries must be a (q, {d}) {db.dtype} matrix, got "
                         f"{tuple(queries.shape)} {queries.dtype}")
    if queries.device != db.device:
        raise ValueError(f"queries are on {queries.device}, db on {db.device}")
    if not 0 < k <= min(DIST_TOPK_MAX_K, m):
        raise ValueError(f"k={k} must be in [1, min({DIST_TOPK_MAX_K}, m={m})]")
    if row_ids.dtype != torch.int32 or tuple(row_ids.shape) != (m,) or row_ids.device != db.device:
        raise ValueError(f"row_ids must be ({m},) int32 on {db.device}")
    _check_f32(mask, (m,), db.device, "mask")
    if r2 is not None:
        _check_f32(r2, (m,), db.device, "r2")
    nq = queries.shape[0]
    # Bound counts: the queries, the rows, their ids and mask read, the
    # (q, k) distances and ids written; 2qmd.
    work = (2 * nq * m * d, (nq + m) * d * db.element_size() + 8 * m + 8 * nq * k, queries, db, k)
    if db.device.type == "cpu":
        with _ledger("dist_topk", "plain", db.device, *work):
            return dist_topk_plain(queries, db, row_ids, mask, k, r2)
    q2 = row_sq_norms(queries)
    r2 = dist_topk_norms(db, mask) if r2 is None else r2
    sms = _sm_count(db.device)
    qc = queries.contiguous()  # held until the launch is queued
    qp, is_bf16 = _launch_args(qc)
    dbp, _ = _launch_args(db)
    ids = row_ids.contiguous()
    route = topk_route(qc, db, k)
    out = torch.empty((nq, k, 2), dtype=torch.float32, device=db.device)
    with _ledger("dist_topk", route, db.device, *work), torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        if route == "wgmma":
            splits = topk_splits(nq, m, sms)
            part_key = torch.empty((splits, nq, k), dtype=torch.int64, device=db.device)
            part_pos = torch.empty((splits, nq, k), dtype=torch.int32, device=db.device)
            rc = _knn_lib().srml_dist_topk_tc(
                qp, dbp, q2.data_ptr(), r2.data_ptr(), ids.data_ptr(), nq, m, d, k, splits,
                topk_stages(k), part_key.data_ptr(), part_pos.data_ptr(), out.data_ptr(), stream,
            )
        else:
            splits = dist_topk_splits(nq, m, sms)
            part = (torch.empty((splits, nq, k, 2), dtype=torch.float32, device=db.device)
                    if splits > 1 else None)
            rc = _knn_lib().srml_dist_topk(
                qp, dbp, is_bf16, q2.data_ptr(), r2.data_ptr(), ids.data_ptr(), nq, m, d, k,
                splits, None if part is None else part.data_ptr(), out.data_ptr(), stream,
            )
        _raise_on(rc, "dist_topk")
    LAUNCHES["dist_topk"] += 1
    ROUTES[f"dist_topk/{route}"] += 1
    return out[..., 0].contiguous(), out[..., 1].view(torch.int32).contiguous()


def _check_probe(centroids: torch.Tensor, queries: torch.Tensor, nprobe: int) -> None:
    if centroids.dim() != 2 or centroids.shape[0] == 0:
        raise ValueError(f"centroids must be an (nlist, d) matrix, got {tuple(centroids.shape)}")
    nlist, d = centroids.shape
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be a (q, {d}) matrix, got {tuple(queries.shape)}")
    if centroids.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("probe_select runs at full f32: centroids and queries must be float32")
    if queries.device != centroids.device:
        raise ValueError(f"queries are on {queries.device}, centroids on {centroids.device}")
    if not 0 < nprobe <= nlist:
        raise ValueError(f"nprobe={nprobe} must be in [1, nlist={nlist}]")


def probe_select_plain(centroids: torch.Tensor, queries: torch.Tensor, nprobe: int):
    """Plain version of :func:`probe_select`."""
    nlist = centroids.shape[0]
    pos_bits = sel.pos_bits_for(nlist)
    c2 = row_sq_norms(centroids)
    q2 = row_sq_norms(queries)
    probe = torch.empty((queries.shape[0], nprobe), dtype=torch.int32, device=queries.device)
    probe_d = torch.empty((queries.shape[0], nprobe), dtype=torch.float32, device=queries.device)
    step = _chunk_rows(queries.shape[0], nlist)
    for r0 in range(0, queries.shape[0], step):
        cq = queries[r0:r0 + step] @ centroids.T
        scores = (c2[None, :] - 2.0 * cq) + q2[r0:r0 + step, None]
        probe_d[r0:r0 + step], probe[r0:r0 + step] = sel.packed_extract(
            sel.packed_keys(scores, pos_bits), nprobe, pos_bits)
    return probe, probe_d


#: The fused probe (``knn.cu``'s ``probe_fused_kernel``): queries and
#: centroids per tile (its warp sort takes one tile's 128 keys, so nprobe
#: <= 128), blocks per query tile (of two 256-thread halves each: half h of
#: block r takes every 2·PROBE_SPLIT-th centroid tile from 2r + h), and the
#: FFMA work tile (128 x 129 f32) of a half.
PROBE_TILE, PROBE_SPLIT, PROBE_WORK_BYTES = 128, 4, 128 * 129 * 4


def probe_smem_bytes(nprobe: int) -> int:
    """Shared memory of a fused probe launch, a copy of knn.cu's
    ``probe_fused_smem`` (``srml_probe_fused_smem``; chip_smoke.py's phase 2
    holds the two equal): a work tile, the tile's q2 and c2 and 128 lists of
    nprobe int32 keys for each half."""
    return 2 * (PROBE_WORK_BYTES + 4 * 2 * PROBE_TILE + 4 * PROBE_TILE * nprobe)


#: The largest nprobe the fused probe takes: both halves' lists fit (96).
PROBE_FUSED_MAX = max(n for n in range(1, PROBE_TILE + 1)
                      if probe_smem_bytes(n) <= TOPK_SMEM_LIMIT)


def probe_route(nlist: int, nprobe: int) -> str:
    """Which body of ``knn.cu`` a ``probe_select`` launch takes: "fused"
    (one launch, the lists in shared memory, merged by the last block of
    each query tile) when nprobe fits one tile's sorted keys and both halves' lists fit
    shared memory (nprobe <= 96); "sort" (every key into a (q, P) scratch,
    then a sort launch) otherwise, such as a query of every list at nlist
    > 96. Both take any nlist ≤ 65,536 and give the same bits (the keys
    are unique)."""
    return "fused" if nprobe <= min(nlist, PROBE_FUSED_MAX) else "sort"


def probe_select(centroids: torch.Tensor, queries: torch.Tensor, nprobe: int):
    """Exact IVF probe at full f32: per query of ``queries`` (q, d) the
    scores (c2 − 2c·q) + q2 against every row of ``centroids`` (nlist, d)
    (true ‖q − c‖², no clamp), packed with pos_bits = bit_length(ceil8(nlist)
    − 1), and the ``nprobe`` smallest keys: (probe ids (q, nprobe) int32
    ascending, floored values (q, nprobe) f32). nlist ≤ 65,536. The route:
    :func:`probe_route`."""
    _check_probe(centroids, queries, nprobe)
    nlist, d = centroids.shape
    nq = queries.shape[0]
    # Bound counts: the centroids and queries read, the (q, nprobe) ids and
    # values written; 2·q·nlist·d.
    work = (2 * nq * nlist * d,
            (nlist * centroids.element_size() + nq * queries.element_size()) * d
            + 8 * nq * nprobe,
            centroids, queries, nprobe)
    if queries.device.type == "cpu":
        with _ledger("probe_select", "plain", queries.device, *work):
            return probe_select_plain(centroids, queries, nprobe)
    pos_bits = sel.pos_bits_for(nlist)
    cent, qs = centroids.contiguous(), queries.contiguous()
    route = probe_route(nlist, nprobe)
    out_p = torch.empty((nq, nprobe), dtype=torch.int32, device=qs.device)
    out_d = torch.empty((nq, nprobe), dtype=torch.float32, device=qs.device)
    with _ledger("probe_select", route, qs.device, *work), torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        if route == "fused":
            q_tiles = -(-nq // PROBE_TILE)
            part = torch.empty((q_tiles, 2 * PROBE_SPLIT, PROBE_TILE, nprobe), dtype=torch.int32,
                               device=qs.device)
            done = torch.empty((q_tiles,), dtype=torch.int32, device=qs.device)
            rc = _knn_lib().srml_probe_select_fused(
                cent.data_ptr(), qs.data_ptr(), nq, nlist, d, nprobe, pos_bits, part.data_ptr(),
                done.data_ptr(), out_p.data_ptr(), out_d.data_ptr(), stream,
            )
        else:
            c2, q2 = row_sq_norms(cent), row_sq_norms(qs)
            p = 1 << max(0, (nlist - 1).bit_length())
            keys = torch.empty((nq, p), dtype=torch.int32, device=qs.device)
            rc = _knn_lib().srml_probe_select(
                cent.data_ptr(), c2.data_ptr(), qs.data_ptr(), q2.data_ptr(), nq, nlist, d,
                nprobe, pos_bits, p, keys.data_ptr(), out_p.data_ptr(), out_d.data_ptr(), stream,
            )
        _raise_on(rc, "probe_select")
    LAUNCHES["probe_select"] += 1
    ROUTES[f"probe_select/{route}"] += 1
    return out_p, out_d


def _check_scan(qv: torch.Tensor, rows: torch.Tensor, r2: torch.Tensor, blk_k: int) -> None:
    if qv.dim() != 3 or rows.dim() != 3 or qv.shape[0] != rows.shape[0] or \
            qv.shape[2] != rows.shape[2]:
        raise ValueError(f"qv (nlist, C, d) and rows (nlist, maxlen, d) disagree: "
                         f"{tuple(qv.shape)}, {tuple(rows.shape)}")
    if qv.dtype != rows.dtype or rows.dtype not in KERNEL_DTYPES:
        raise TypeError(f"qv and rows must both be float32 or bfloat16, got {qv.dtype}, "
                        f"{rows.dtype}")
    if qv.device != rows.device:
        raise ValueError(f"qv is on {qv.device}, rows on {rows.device}")
    _check_f32(r2, rows.shape[:2], rows.device, "r2")
    if not 0 < blk_k <= rows.shape[1]:
        raise ValueError(f"blk_k={blk_k} must be in [1, maxlen={rows.shape[1]}]")


#: The tensor-core scan (``knn.cu``'s ``ivf_scan_tc_kernel``): list rows per
#: chunk (the wgmma's N), query slots per task, the deepest ring, the sorted
#: key lists (one per consumer thread, two per slot) and the candidates a
#: list takes in one round of inserts.
SCAN_CHUNK, SCAN_TILE, SCAN_MAX_STAGES, SCAN_LISTS, SCAN_ROUND = 256, 128, 4, 256, 8
#: The shared memory a block may use.
SCAN_SMEM_LIMIT = 232448


def scan_smem_bytes(blk_k: int, stages: int) -> int:
    """Shared memory of a tensor-core scan launch, a copy of ``scan_layout``'s
    total in knn.cu (``srml_ivf_scan_tc_smem``; chip_smoke.py's phase 2
    holds the two equal): the ring (two 64-slot query slabs and one
    256-row list slab a stage), two chunk buffers of r2 for each consumer
    warpgroup, a round's candidates and the lists of blk_k int32 keys, the
    mbarriers and 1 KB of alignment slack."""
    off = (stages * (2 * 8192 + 128 * SCAN_CHUNK) + 4 * 4 * SCAN_CHUNK
           + 4 * SCAN_LISTS * (SCAN_ROUND + blk_k))
    return -(-off // 8) * 8 + 8 * 2 * stages + 1024


def scan_stages(blk_k: int) -> int:
    """The deepest ring (at most SCAN_MAX_STAGES) that fits beside the lists
    of blk_k keys, or 0."""
    for stages in range(SCAN_MAX_STAGES, 0, -1):
        if scan_smem_bytes(blk_k, stages) <= SCAN_SMEM_LIMIT:
            return stages
    return 0


#: The largest blk_k the tensor-core scan takes: its lists leave room for a
#: two-stage ring (117: every width ApproximateNearestNeighbors extracts at
#: k <= 64 under its default ann_extract, ceil(1.2·k) <= 77).
SCAN_TC_MAX_BLK_K = max(b for b in range(1, 4096) if scan_stages(b) >= 2)


def scan_route(qv: torch.Tensor, rows: torch.Tensor, blk_k: int) -> str:
    """Which body of ``knn.cu`` an ``ivf_scan_select`` launch takes: "wgmma"
    for bfloat16 with d % 8 == 0 (TMA needs a 16-byte row stride), qv and
    rows 16-byte aligned, at least one list, slot and row, and blk_k <=
    SCAN_TC_MAX_BLK_K; "ffma" otherwise (float32 stays in full f32 FFMA)."""
    nlist, n_slots, d = qv.shape
    aligned = qv.data_ptr() % 16 == 0 and rows.data_ptr() % 16 == 0
    tc = (qv.dtype == torch.bfloat16 and d % 8 == 0 and aligned and blk_k <= SCAN_TC_MAX_BLK_K
          and nlist * n_slots * rows.shape[1] > 0)
    return "wgmma" if tc else "ffma"


def ivf_scan_select_plain(qv: torch.Tensor, rows: torch.Tensor, r2: torch.Tensor, blk_k: int):
    """Plain version of :func:`ivf_scan_select`."""
    nlist, n_slots, _ = qv.shape
    maxlen = rows.shape[1]
    pos_bits = sel.pos_bits_for(maxlen)
    bk_pad = sel.ceil_to(blk_k, 8)
    out_d = torch.full((nlist, bk_pad, n_slots), sel.IVF_MASKED_D2, dtype=torch.float32,
                       device=qv.device)
    out_p = torch.zeros((nlist, bk_pad, n_slots), dtype=torch.int32, device=qv.device)
    step = _chunk_rows(nlist, n_slots * maxlen)
    for l0 in range(0, nlist, step):
        qr = torch.bmm(qv[l0:l0 + step].float(), rows[l0:l0 + step].float().transpose(1, 2))
        scores = r2[l0:l0 + step, None, :] - 2.0 * qr  # (L, C, maxlen)
        vals, pos = sel.packed_extract(sel.packed_keys(scores, pos_bits), blk_k, pos_bits)
        out_d[l0:l0 + step, :blk_k] = vals.transpose(1, 2)
        out_p[l0:l0 + step, :blk_k] = pos.transpose(1, 2)
    return out_d, out_p


def ivf_scan_select(qv: torch.Tensor, rows: torch.Tensor, r2: torch.Tensor, blk_k: int):
    """Fused IVF list scan: per list l and query slot c, the scores
    r2[l] − 2·(rows[l]·qv[l, c]) over the list's maxlen rows, packed with
    pos_bits = bit_length(ceil8(maxlen) − 1), and the ``blk_k`` smallest
    keys decoded: (best_d (nlist, bk_pad, C) f32 ascending, best_p (nlist,
    bk_pad, C) int32 row positions), bk_pad = ceil8(blk_k), the pad rows
    (3e38, 0) as in JAX. Ties go to the lowest position.

    qv: (nlist, C, d), the query residuals per slot; rows: (nlist, maxlen,
    d), the residual list rows, both float32 or both bfloat16; r2: (nlist,
    maxlen) f32 with ≥ 1e30 on rows that must not win. blk_k ≤ maxlen ≤
    65,536. The route (:func:`scan_route`): bfloat16 with d % 8 == 0 on
    the tensor-core scoring body with a packed-key top-k epilogue, else
    the FFMA tiles; both give the same bits (the keys are unique)."""
    _check_scan(qv, rows, r2, blk_k)
    nlist, n_slots, d = qv.shape
    maxlen = rows.shape[1]
    bk_pad = sel.ceil_to(blk_k, 8)
    # Bound counts: the query residuals, the list rows and their norms read,
    # the (nlist, bk_pad, C) values and positions written;
    # 2·nlist·C·maxlen·d.
    work = (2 * nlist * n_slots * maxlen * d,
            (qv.numel() + rows.numel()) * qv.element_size() + 4 * r2.numel()
            + 8 * nlist * bk_pad * n_slots,
            qv, rows, blk_k)
    if qv.device.type == "cpu":
        with _ledger("ivf_scan_select", "plain", qv.device, *work):
            return ivf_scan_select_plain(qv, rows, r2, blk_k)
    pos_bits = sel.pos_bits_for(maxlen)
    qvc = qv.contiguous()  # held until the launch is queued
    qvp, is_bf16 = _launch_args(qvc)
    rp, _ = _launch_args(rows)
    r2c = r2.contiguous()
    route = scan_route(qvc, rows, blk_k)
    out_d = torch.empty((nlist, bk_pad, n_slots), dtype=torch.float32, device=qv.device)
    out_p = torch.empty((nlist, bk_pad, n_slots), dtype=torch.int32, device=qv.device)
    with _ledger("ivf_scan_select", route, qv.device, *work), torch.cuda.device(qv.device):
        lib = _knn_lib()
        stream = torch.cuda.current_stream(qv.device).cuda_stream
        if route == "wgmma":
            rc = lib.srml_ivf_scan_select_tc(
                qvp, rp, r2c.data_ptr(), nlist, n_slots, maxlen, d, blk_k, bk_pad, pos_bits,
                scan_stages(blk_k), out_d.data_ptr(), out_p.data_ptr(), stream,
            )
        else:
            scratch = (torch.empty((nlist, n_slots, blk_k), dtype=torch.int32, device=qv.device)
                       if lib.srml_scan_needs_scratch(blk_k) else None)
            rc = lib.srml_ivf_scan_select(
                qvp, rp, is_bf16, r2c.data_ptr(), nlist, n_slots, maxlen, d, blk_k, bk_pad,
                pos_bits, None if scratch is None else scratch.data_ptr(), out_d.data_ptr(),
                out_p.data_ptr(), stream,
            )
        _raise_on(rc, "ivf_scan_select")
    LAUNCHES["ivf_scan_select"] += 1
    ROUTES[f"ivf_scan_select/{route}"] += 1
    return out_d, out_p
