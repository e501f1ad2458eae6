"""LogisticRegression — full-batch Newton (IRLS) and multinomial MM-Newton,
in PyTorch on a CUDA device.

The port of ``spark_rapids_ml_tpu/models/logistic_regression.py``
(BASELINE.json config #4, the normal-equations family on Criteo-1TB).

Objective (Spark ML LogisticRegression, ``standardization=False``):

    min_w 1/n Σ log(1 + exp(−ŷᵢ·(xᵢw + b))) + λ/2·‖w‖₂²   (binary, L2)

Binary labels are {0, 1}; multinomial labels are 0..C−1. The intercept is
unpenalized, as in Spark.

* Binary, in memory (:func:`fit_logistic_regression`): a host loop of
  Newton steps. With bfloat16/float32 compute and float32 accumulators x
  is cast once to the compute dtype on the device and each iteration is
  ONE launch of the hand-written ``newton_stats`` kernel (gradient,
  Hessian and both borders; ``ops/kernels.py``, its plain version on a
  CPU tensor), then the direct solve of the bordered (d + 1) system
  (:func:`~spark_rapids_ml_tpu_torch.ops.linalg.solve_newton_system`, on
  both devices: the JAX package's Jacobi-CG stood in for a direct solve
  that cost too much on a TPU). On bfloat16 x with tol > 0 the loop stops
  once a step is below max(tol, 2⁻⁸·‖w‖), the noise floor of the rounded
  rows, as in the JAX package. The objective reads x in the accumulator
  dtype. Other dtypes (the float64 parity mode) are plain products in the
  accumulator dtype.
* Multinomial (in memory and streamed): MM-Newton. Each pass takes the
  exact softmax gradient and per-class upper-bound curvature blocks
  Xᵀdiag(p_c)X (diag(p) − ppᵀ ⪯ diag(p), so each class block solved
  against the exact gradient is a majorize-minimize step: monotone descent
  with O(C·d²) state). The logits, gradient and loss read x in the
  accumulator dtype; the curvature reads it in bfloat16 when the compute
  dtype is bfloat16 and the accumulators float32 (else in the accumulator
  dtype), and with float32 accumulators it is ONE ``softmax_curvature``
  launch per pass for all classes.
* The binary stream (:func:`fit_logistic_stream`) uses no kernel, as the
  JAX package's streaming update uses none: plain products in the
  accumulator dtype per batch. Batches are placed as float32, as there.
* Both streams run across ranks (``mesh=``, a started
  ``torch.distributed`` world): each rank scans its own stream in lockstep
  (``parallel/sharding.lockstep_labeled_batches``: the label and shape
  checks raise on every rank together), the pass statistics are summed
  over the ranks once a pass, and every rank takes the same step from the
  same replicated sums. The in-memory fit stays single-process, as in the
  JAX package (it infers the classes from local labels).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core import checkpoint as ckpt
from spark_rapids_ml_tpu_torch.core.dataset import as_column, as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasFeaturesCol,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasRegParam,
    HasTol,
    Model,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops.linalg import solve_newton_system
from spark_rapids_ml_tpu_torch.ops.gram import reduce_stats
from spark_rapids_ml_tpu_torch.parallel.distributed import row_counts
from spark_rapids_ml_tpu_torch.parallel.mesh import default_mesh
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    as_tensor,
    lockstep_labeled_batches,
    require_single_process,
    resolve_device,
    to_device,
)
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

#: (gw, gb, hww, hwb, hbb, loss, n) raw sums of one pass, in the accumulator dtype.
PassState = Tuple[torch.Tensor, ...]

#: Largest multinomial (C, d, d) curvature state an in-memory fit takes.
STATE_BYTES_LIMIT = 2**31


class LogisticTrainingSummary(NamedTuple):
    """Final objective + iterations, Spark's training-summary shape; the
    objective of every pass where a pass computes it (the multinomial fit
    and both streams)."""

    loss: Optional[float]
    numIter: int
    n_rows: int
    objectiveHistory: Tuple[float, ...] = ()


class LogisticSolution(NamedTuple):
    coefficients: np.ndarray  # (d,) binary or (c, d) multinomial
    intercept: np.ndarray  # scalar (binary) or (c,)
    n_iter: int
    n_rows: int
    loss: Optional[float] = None  # final training objective (binary and streams)
    objective_history: Tuple[float, ...] = ()  # per pass, at the iterate it read


def _host(y) -> np.ndarray:
    """Labels as a host numpy array (a tensor is copied off its device)."""
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _row_chunks(n: int):
    step = kernels.PLAIN_ROW_CHUNK
    return ((r0, min(n, r0 + step)) for r0 in range(0, n, step))


def _data_loss(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ log(1 + e^z) − y·z, the binary cross-entropy in the margin."""
    return (torch.logaddexp(z, torch.zeros_like(z)) - y * z).sum()


def stream_objective(lsum, n, reg: float, w) -> float:
    """Training objective at the iterate a pass evaluated: mean data loss
    plus the L2 term (w, or W of a multinomial pass)."""
    return float(lsum / torch.clamp(n, min=1.0)) + 0.5 * float(reg) * float(torch.sum(w * w))


#: The multinomial name of :func:`stream_objective` (the JAX package has both).
stream_softmax_objective = stream_objective


def _newton_step(gw, gb, hww, hwb, hbb, n, w, b, reg: float, fit_intercept: bool):
    """One Newton step from a pass's raw sums: (new w, new b, ‖(dw, db)‖).

    Binary: w (d,), b (). Multinomial: w is Wᵀ (C, d) and b (C,), one
    bordered per-class system each (the JAX package's vmapped solve_c)."""
    n = torch.clamp(n, min=1.0)
    eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
    dw, db = solve_newton_system(
        hww / n + reg * eye, hwb / n, hbb / n, gw / n + reg * w, gb / n,
        reg, fit_intercept,
    )
    delta = torch.sqrt(torch.sum(dw * dw) + torch.sum(db * db))
    return w - dw, (b - db) if fit_intercept else b, delta


# ---------------------------------------------------------------------------
# Binary Newton-IRLS
# ---------------------------------------------------------------------------


def _irls_sums(xc, yc, w, b):
    """Plain accumulator-dtype sums at (w, b): (Xᵀr, Σr, Xᵀdiag(wgt)X,
    Xᵀwgt, Σwgt) and the margins z."""
    z = xc @ w + b
    p = torch.sigmoid(z)
    r = p - yc
    wgt = torch.clamp(p * (1.0 - p), min=1e-10)
    xw = xc * wgt[:, None]
    return (xc.T @ r, r.sum(), xw.T @ xc, xw.sum(dim=0), wgt.sum()), z


def _binary_objective(x, y, w, b, reg: float) -> float:
    """Mean binary cross-entropy + λ/2‖w‖² with x read in the accumulator
    dtype (w's), in row chunks on w's device."""
    ad, dev = w.dtype, w.device
    xt, yt = as_tensor(x), as_tensor(y).reshape(-1)
    total = torch.zeros((), dtype=ad, device=dev)
    for r0, r1 in _row_chunks(xt.shape[0]):
        z = to_device(xt[r0:r1], dev, ad) @ w + b
        total += _data_loss(z, to_device(yt[r0:r1], dev, ad))
    return float(total / max(xt.shape[0], 1)) + 0.5 * float(reg) * float(w @ w)


def _fit_binomial(x, y, dev, reg: float, fit_intercept: bool, max_iter: int,
                  tol: float) -> LogisticSolution:
    cd, ad = config.compute_dtype(dev), config.accum_dtype()
    kernel = kernels.kernel_applicable(cd, ad)
    n_rows, d = x.shape
    xk = to_device(x, dev, cd if kernel else ad).contiguous()
    yk = to_device(y, dev, torch.float32 if kernel else ad).contiguous()
    n = torch.tensor(float(n_rows), dtype=ad, device=dev)
    # On bfloat16 x the rounding of the rows puts a relative noise floor
    # under the gradient: steps plateau near 2.5e-3·‖w‖ instead of
    # contracting, so stop below 2⁻⁸·‖w‖ (tol = 0 keeps its "exactly
    # max_iter steps" contract).
    floor = kernel and cd == torch.bfloat16 and tol > 0.0
    w = torch.zeros((d,), dtype=ad, device=dev)
    b = torch.zeros((), dtype=ad, device=dev)
    n_iter, delta, tol_eff = 0, float("inf"), float(tol)
    while n_iter < max_iter and delta > tol_eff:
        if kernel:
            stats = kernels.newton_stats(xk, yk, None, w, b)
        else:
            stats, _ = _irls_sums(xk, yk, w, b)
        w, b, step = _newton_step(*stats, n, w, b, reg, fit_intercept)
        delta = float(step)
        n_iter += 1
        if floor:
            tol_eff = max(float(tol), 2.0**-8 * float(torch.linalg.norm(w)))
    del xk, yk
    return LogisticSolution(
        coefficients=w.cpu().numpy().astype(np.float64),
        intercept=np.asarray(float(b), dtype=np.float64),
        n_iter=n_iter,
        n_rows=n_rows,
        loss=_binary_objective(x, y, w, b, reg),
    )


# ---------------------------------------------------------------------------
# Multinomial MM-Newton
# ---------------------------------------------------------------------------


def curvature_dtype(compute_dtype: torch.dtype, accum_dtype: torch.dtype) -> torch.dtype:
    """Operand dtype of the curvature blocks: bfloat16 when the compute
    dtype is bfloat16 and the accumulators float32, else the accumulator
    dtype. The blocks set only the MM step's direction (the exact gradient
    pins the fixed point), so they may read the rounded rows."""
    if accum_dtype == torch.float32 and compute_dtype == torch.bfloat16:
        return torch.bfloat16
    return accum_dtype


def stream_softmax_zero_state(n_cols: int, n_classes: int, accum_dtype,
                              device=None) -> PassState:
    """Zero (gw (d, C), gb (C), hw (C, d, d), hwb (C, d), hbb (C), loss, n)
    accumulator for one multinomial pass."""
    z = lambda *shape: torch.zeros(shape, dtype=accum_dtype, device=device)  # noqa: E731
    d, c = n_cols, n_classes
    return z(d, c), z(c), z(c, d, d), z(c, d), z(c), z(), z()


def softmax_stats_update(state: PassState, W, b, x, y, xh=None) -> PassState:
    """Fold one batch's multinomial statistics at fixed (W (d, C), b (C))
    into ``state`` IN PLACE (the JAX package's donated update).

    x: (m, d) rows, read in the accumulator dtype for the logits, the
    gradient and the loss; y: (m,) integer labels. ``xh``: x already in
    the curvature dtype (:func:`curvature_dtype`); made from x when None.
    With float32 accumulators the curvature is one ``softmax_curvature``
    launch."""
    gw, gb, hw, hwb, hbb, loss, n = state
    ad = gw.dtype
    hd = curvature_dtype(config.compute_dtype(gw.device), ad)
    xc = x.to(ad)
    if xh is None:
        xh = xc.to(hd)
    yi = y.to(torch.int64).reshape(-1)
    logits = xc @ W + b
    p = torch.softmax(logits, dim=1)
    if kernels.kernel_applicable(hd, ad):
        bhw, bhwb = kernels.softmax_curvature(xh.contiguous(), p)
        hw.add_(bhw)
        hwb.add_(bhwb)
    else:
        for c in range(W.shape[1]):
            xw = xh * p[:, c:c + 1]
            hw[c].add_(xw.T @ xh)
            hwb[c].add_(xw.sum(dim=0))
    hbb.add_(p.sum(dim=0))
    r = p - torch.nn.functional.one_hot(yi, W.shape[1]).to(ad)
    gw.add_(xc.T @ r)
    gb.add_(r.sum(dim=0))
    loss.add_((torch.logsumexp(logits, dim=1) - logits.gather(1, yi[:, None])[:, 0]).sum())
    n.add_(x.shape[0])
    return state


def _softmax_step(state: PassState, W, b, reg: float, fit_intercept: bool):
    gw, gb, hw, hwb, hbb, _, n = state
    wt, b, delta = _newton_step(gw.T, gb, hw, hwb, hbb, n, W.T, b, reg, fit_intercept)
    return wt.T, b, delta


def _fit_multinomial(x, y, dev, n_classes: int, reg: float, fit_intercept: bool,
                     max_iter: int, tol: float) -> LogisticSolution:
    ad = config.accum_dtype()
    hd = curvature_dtype(config.compute_dtype(dev), ad)
    n_rows, d = x.shape
    state_bytes = n_classes * d ** 2 * torch.finfo(ad).bits // 8
    if state_bytes > STATE_BYTES_LIMIT:
        # The (C, d, d) curvature state is the price of second-order
        # steps; past ~2 GB it would crowd out the data.
        raise ValueError(
            f"multinomial MM-Newton state is C·d² = {state_bytes / 2**30:.1f}"
            f" GiB (C={n_classes}, d={d}, {str(ad)[6:]}) — too "
            "large for a replicated accumulator. Reduce d (feature "
            "hashing/PCA) or C, or use a float32 accum_dtype."
        )
    # One copy of x in the accumulator dtype (logits, gradient, loss) and,
    # when it differs, one in the curvature dtype.
    xa = to_device(x, dev, ad).contiguous()
    xh = xa if hd == ad else xa.to(hd)
    yk = to_device(y, dev, torch.float32)
    W = torch.zeros((d, n_classes), dtype=ad, device=dev)
    b = torch.zeros((n_classes,), dtype=ad, device=dev)
    n_iter, history = 0, []
    for it in range(max_iter):
        state = stream_softmax_zero_state(d, n_classes, ad, dev)
        softmax_stats_update(state, W, b, xa, yk, xh=xh)
        history.append(stream_objective(state[5], state[6], reg, W))
        W, b, delta = _softmax_step(state, W, b, reg, fit_intercept)
        n_iter = it + 1
        if float(delta) <= tol:
            break
    return LogisticSolution(
        coefficients=W.T.cpu().numpy().astype(np.float64),  # (c, d) Spark layout
        intercept=b.cpu().numpy().astype(np.float64),
        n_iter=n_iter,
        n_rows=n_rows,
        objective_history=tuple(history),
    )


def fit_logistic_regression(
    x,
    y,
    reg: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    device=None,
) -> LogisticSolution:
    """Fit on an in-memory (n, d) matrix and (n,) labels 0..C−1 (numpy
    arrays or tensors, possibly already on the card). Two classes: binary
    Newton-IRLS; more: multinomial MM-Newton. ``device``: None → the card."""
    require_single_process("fit_logistic_regression (n_classes inferred from local labels)")
    dev = resolve_device(device)
    y = as_tensor(y).reshape(-1)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"X rows {x.shape[0]} != y rows {y.shape[0]}")
    classes = _host(torch.unique(y)).astype(np.float64)
    n_classes = len(classes)
    if n_classes < 2:
        raise ValueError("need at least 2 classes in the label column")
    if not np.array_equal(classes, np.arange(n_classes)):
        raise ValueError(
            f"labels must be 0..{n_classes - 1} (Spark ML convention); got {classes[:8]}"
        )
    with trace_span("logreg fit"):
        if n_classes == 2:
            return _fit_binomial(x, y, dev, float(reg), bool(fit_intercept), int(max_iter),
                                 float(tol))
        return _fit_multinomial(x, y, dev, n_classes, float(reg), bool(fit_intercept),
                                int(max_iter), float(tol))


# ---------------------------------------------------------------------------
# Streaming fits: one scan of the source per iteration
# ---------------------------------------------------------------------------


def stream_zero_state(n_cols: int, accum_dtype, device=None) -> PassState:
    """Zero (gw, gb, hww, hwb, hbb, loss, n) accumulator for one Newton pass."""
    z = lambda *shape: torch.zeros(shape, dtype=accum_dtype, device=device)  # noqa: E731
    return z(n_cols), z(), z(n_cols, n_cols), z(n_cols), z(), z(), z()


def stream_grad_hess_update(state: PassState, w, b, x, y) -> PassState:
    """Fold one batch's binary Newton statistics at fixed (w, b) into
    ``state`` IN PLACE: plain products in the accumulator dtype (the JAX
    package's ``_stream_grad_hess_fn`` uses no kernel either)."""
    ad = state[0].dtype
    yc = y.to(ad).reshape(-1)
    sums, z = _irls_sums(x.to(ad), yc, w, b)
    for t, v in zip(state, sums + (_data_loss(z, yc), x.shape[0])):
        t.add_(v)
    return state




def validate_binary_labels(y) -> None:
    """Raise unless labels are {0, 1} (Spark ML binary convention)."""
    bad = set(np.unique(_host(y))) - {0, 1, 0.0, 1.0}
    if bad:
        raise ValueError(
            f"labels must be binary 0/1 for the streaming path; got {sorted(bad)[:8]}"
        )


def validate_multiclass_labels(y, n_classes: int) -> None:
    """Raise unless labels are integers in [0, n_classes) (Spark ML)."""
    ya = _host(y)
    if ya.size == 0:
        return
    if not np.all(np.equal(np.mod(ya, 1), 0)):
        raise ValueError("labels must be integers 0..n_classes-1")
    lo, hi = ya.min(), ya.max()
    if lo < 0 or hi >= n_classes:
        raise ValueError(f"labels must be in [0, {n_classes}); got range [{lo}, {hi}]")


def _scan(batch_source, n_cols: int, dev, fold, check) -> int:
    """One pass over the source in lockstep across ranks
    (:func:`~spark_rapids_ml_tpu_torch.parallel.sharding.lockstep_labeled_batches`):
    each batch's shapes, and ``check(y)`` of its labels as given (unless it
    is None), are validated on every rank together; then the (x, y) batch
    is placed on ``dev`` as float32 (the JAX package's placement) and
    folded by ``fold(x, y)`` unless it is empty. Returns this rank's row
    count."""

    def validate(x, y) -> Optional[str]:
        if x.ndim != 2 or x.shape[1] != n_cols or x.shape[0] != y.shape[0]:
            return (f"batch has x {tuple(x.shape)} and y {tuple(y.shape)}, "
                    f"expected (m, {n_cols}) and (m,)")
        if check is not None:
            try:
                check(y)
            except ValueError as e:
                return str(e)
        return None

    n_rows = 0
    for xb, yb in lockstep_labeled_batches(batch_source(), n_cols, validate):
        xt = to_device(xb, dev, torch.float32)
        yt = to_device(yb, dev, torch.float32).reshape(-1)
        n_rows += xt.shape[0]
        if xt.shape[0]:
            fold(xt, yt)
    return n_rows


def _restore(checkpoint_path, expect: dict):
    """(arrays, iteration) of a checkpoint whose metadata match ``expect``,
    or None when there is none; every rank must see the same."""
    restored = ckpt.load_state(checkpoint_path) if checkpoint_path else None
    if checkpoint_path:
        ckpt.require_consistent_visibility(restored)
    if restored is None:
        return None
    arrays, meta = restored
    # A metadata check and its message: the order reaches no fold.
    if any(meta.get(k) != v for k, v in expect.items()):  # srml: disable=unsorted-iter
        have = ", ".join(f"{k}={meta.get(k)}" for k in expect)
        # The message lists the values in the order of ``have``.
        want = ", ".join(str(v) for v in expect.values())  # srml: disable=unsorted-iter
        raise ValueError(f"checkpoint at {checkpoint_path} is for {have}, not ({want})")
    return arrays, int(meta["it"])


def _run_stream(batch_source, n_cols: int, dev, zero_state, fold, check, step, w, b,
                reg: float, start_iter: int, max_iter: int, tol: float, save, mesh):
    """The Newton loop both streams share: one scan per iteration into
    ``zero_state()`` through ``fold(state, w, b, x, y)``, labels checked by
    ``check(y)`` on the first scan only (the data are fixed across scans),
    the pass sums summed over the ranks of a started world, then
    ``step(state, w, b) → (w, b, delta)`` and ``save(w, b, it)`` (None: no
    checkpoint; rank 0 alone writes). Returns (w, b, n_iter, n_rows, loss,
    history), the loss at the last iterate a scan evaluated."""

    def scan(w, b, check):
        state = zero_state()
        n = _scan(batch_source, n_cols, dev, lambda xt, yt: fold(state, w, b, xt, yt), check)
        if mesh.collective:
            return reduce_stats(state, mesh), int(row_counts(n, mesh).sum())
        return state, n

    n_rows, n_iter, loss, history = 0, start_iter, float("nan"), []
    for it in range(start_iter, max_iter):
        state, n_rows = scan(w, b, check if it == start_iter else None)
        loss = stream_objective(state[5], state[6], reg, w)
        history.append(loss)
        w, b, delta = step(state, w, b)
        n_iter = it + 1
        if save is not None and ckpt.is_writer():
            save(w, b, n_iter)
        if float(delta) <= tol:
            break
    if n_iter == start_iter:
        # Resumed at or past max_iter: the loop never ran, so evaluate the
        # restored iterate once for a faithful (n_rows, loss).
        state, n_rows = scan(w, b, check)
        loss = stream_objective(state[5], state[6], reg, w)
    return w, b, n_iter, n_rows, loss, tuple(history)


def fit_logistic_stream(
    batch_source,
    n_cols: int,
    reg: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    checkpoint_path: Optional[str] = None,
    device=None,
    mesh=None,
) -> LogisticSolution:
    """Binary Newton-IRLS over a re-scannable stream of (x, y) batches —
    the capacity path for labelled data larger than the device.

    ``batch_source`` is a CALLABLE returning a fresh iterator of ``(x (m,
    d), y (m,))`` pairs (arrays or tensors); each Newton iteration consumes
    one full scan into an O(d²) state on the device. Labels must be
    {0, 1}. The returned ``loss`` is the objective at the last iterate a
    scan evaluated (one iteration stale). With ``checkpoint_path``, (w, b)
    persist after every iteration in the JAX package's layout, so either
    package resumes the other's checkpoint; the file is removed on
    success.

    **Across ranks** (``mesh`` of a started world): ``batch_source``
    yields THIS rank's (x, y) stream; scans run in lockstep (uneven
    lengths are fine; a bad label raises on every rank), each pass's sums
    are summed over the ranks, and rank 0 alone writes the checkpoints,
    which every rank must see."""
    mesh = mesh or default_mesh()
    dev = resolve_device(device, mesh)
    ad = config.accum_dtype()
    reg, fit_intercept = float(reg), bool(fit_intercept)
    w = torch.zeros((n_cols,), dtype=ad, device=dev)
    b = torch.zeros((), dtype=ad, device=dev)
    start_iter = 0
    restored = _restore(checkpoint_path, {"n_cols": n_cols})
    if restored is not None:
        arrays, start_iter = restored
        w = torch.as_tensor(arrays["w"]).to(dev, ad)
        b = torch.as_tensor(arrays["b"]).to(dev, ad).reshape(())

    def step(state, w, b):
        return _newton_step(*state[:5], state[6], w, b, reg, fit_intercept)

    def save(w, b, it):
        ckpt.save_state(checkpoint_path, {"w": w.cpu().numpy(), "b": b.cpu().numpy()},
                        {"it": it, "n_cols": n_cols})

    with trace_span("logreg-stream"):
        w, b, n_iter, n_rows, loss, history = _run_stream(
            batch_source, n_cols, dev, lambda: stream_zero_state(n_cols, ad, dev),
            stream_grad_hess_update, validate_binary_labels, step, w, b, reg, start_iter,
            int(max_iter), float(tol), save if checkpoint_path else None, mesh)
    if checkpoint_path and ckpt.is_writer():
        ckpt.discard_state(checkpoint_path)
    return LogisticSolution(
        coefficients=w.cpu().numpy().astype(np.float64),
        intercept=np.asarray(float(b), dtype=np.float64),
        n_iter=n_iter,
        n_rows=n_rows,
        loss=loss,
        objective_history=history,
    )


def fit_multinomial_stream(
    batch_source,
    n_cols: int,
    n_classes: int,
    reg: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    checkpoint_path: Optional[str] = None,
    device=None,
    mesh=None,
) -> LogisticSolution:
    """Multinomial softmax over a re-scannable stream of (x, y) batches —
    the multiclass peer of :func:`fit_logistic_stream`, one scan per
    MM-Newton iteration (:func:`softmax_stats_update`: one
    ``softmax_curvature`` launch per batch with float32 accumulators).
    Labels are integers in [0, n_classes). Checkpoints hold (W (d, C), b)
    in the JAX package's layout. Across ranks it runs as
    :func:`fit_logistic_stream` does."""
    if n_classes < 2:
        raise ValueError("n_classes must be >= 2")
    mesh = mesh or default_mesh()
    dev = resolve_device(device, mesh)
    ad = config.accum_dtype()
    reg, fit_intercept = float(reg), bool(fit_intercept)
    W = torch.zeros((n_cols, n_classes), dtype=ad, device=dev)
    b = torch.zeros((n_classes,), dtype=ad, device=dev)
    start_iter = 0
    restored = _restore(checkpoint_path, {"n_cols": n_cols, "n_classes": n_classes})
    if restored is not None:
        arrays, start_iter = restored
        W = torch.as_tensor(arrays["W"]).to(dev, ad)
        b = torch.as_tensor(arrays["b"]).to(dev, ad)

    def save(W, b, it):
        ckpt.save_state(checkpoint_path, {"W": W.cpu().numpy(), "b": b.cpu().numpy()},
                        {"it": it, "n_cols": n_cols, "n_classes": n_classes})

    with trace_span("multinomial-stream"):
        W, b, n_iter, n_rows, loss, history = _run_stream(
            batch_source, n_cols, dev,
            lambda: stream_softmax_zero_state(n_cols, n_classes, ad, dev),
            softmax_stats_update, lambda yt: validate_multiclass_labels(yt, n_classes),
            lambda state, W, b: _softmax_step(state, W, b, reg, fit_intercept), W, b, reg,
            start_iter, int(max_iter), float(tol), save if checkpoint_path else None, mesh)
    if checkpoint_path and ckpt.is_writer():
        ckpt.discard_state(checkpoint_path)
    return LogisticSolution(
        coefficients=W.T.cpu().numpy().astype(np.float64),  # (C, d)
        intercept=b.cpu().numpy().astype(np.float64),
        n_iter=n_iter,
        n_rows=n_rows,
        loss=loss,
        objective_history=history,
    )


# ---------------------------------------------------------------------------
# Estimator / Model
# ---------------------------------------------------------------------------


class _LogisticRegressionParams(
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasRegParam,
    HasFitIntercept,
    HasMaxIter,
    HasTol,
):
    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            probabilityCol="probability",
            rawPredictionCol="rawPrediction",
            regParam=0.0,
            fitIntercept=True,
            maxIter=100,
            tol=1e-6,
        )


class LogisticRegression(Estimator, _LogisticRegressionParams, MLWritable, MLReadable):
    """Spark-ML-shaped logistic regression (binary and multinomial).

    ``device``: where the fit runs; None → the card."""

    _uid_prefix = "LogisticRegression"
    _persist_class = "spark_rapids_ml_tpu.models.logistic_regression.LogisticRegression"

    def __init__(self, uid=None, device=None):
        super().__init__(uid=uid)
        self._device = device

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)

    def _fit(self, dataset) -> "LogisticRegressionModel":
        x = as_matrix(dataset, self.getFeaturesCol())
        y = as_column(dataset, self.getLabelCol())
        sol = fit_logistic_regression(
            x,
            y,
            reg=self.getRegParam(),
            fit_intercept=self.getFitIntercept(),
            max_iter=self.getMaxIter(),
            tol=self.getTol(),
            device=self._device,
        )
        model = LogisticRegressionModel(
            coefficients=sol.coefficients, intercept=sol.intercept, device=self._device
        )
        model.uid = self.uid
        model._summary = LogisticTrainingSummary(
            loss=sol.loss, numIter=sol.n_iter, n_rows=sol.n_rows,
            objectiveHistory=sol.objective_history,
        )
        self._copy_params_to(model)
        return model


def _proba(raw: torch.Tensor, binary: bool) -> torch.Tensor:
    """Spark's raw2probability: binary → sigmoid of the margin raw[:, 1]
    (raw = [−z, z], so a softmax would give sigmoid(2z)), overflow-safe;
    multiclass → softmax of the logits."""
    if binary:
        z = raw[:, 1]
        e = torch.exp(-torch.abs(z))
        p1 = torch.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
        return torch.stack([1.0 - p1, p1], dim=1)
    e = torch.exp(raw - raw.max(dim=1, keepdim=True).values)
    return e / e.sum(dim=1, keepdim=True)


class LogisticRegressionModel(Model, _LogisticRegressionParams, MLWritable, MLReadable):
    """Fitted coefficients ((d,) binary, (C, d) multinomial) and intercept.
    ``predict_raw``/``predict_proba``/``predict`` are host float64 numpy;
    ``transform_matrix`` scores on ``device`` (None → the card)."""

    _uid_prefix = "LogisticRegressionModel"
    # The layout's class name, shared with the JAX package (persistence.py).
    _persist_class = "spark_rapids_ml_tpu.models.logistic_regression.LogisticRegressionModel"

    def __init__(self, coefficients=None, intercept=None, uid=None, device=None):
        super().__init__(uid=uid)
        self.coefficients = None if coefficients is None else np.asarray(coefficients)
        self.intercept = None if intercept is None else np.asarray(intercept)
        self._summary: Optional[LogisticTrainingSummary] = None
        self._device = device
        self._raw_cache: dict = {}

    @property
    def summary(self) -> Optional[LogisticTrainingSummary]:
        return self._summary

    @property
    def numClasses(self) -> int:
        if self.coefficients is None:
            return 0
        return 2 if self.coefficients.ndim == 1 else self.coefficients.shape[0]

    def _model_data(self):
        return {
            "coefficients": self.coefficients,
            "intercept": np.atleast_1d(self.intercept),
        }

    @classmethod
    def _from_model_data(cls, uid, data):
        coef = np.asarray(data["coefficients"])
        inter = data["intercept"]
        if coef.ndim == 1 or coef.shape[0] == 1:
            coef = coef.reshape(-1)
            inter = np.asarray(inter).reshape(-1)[0]
        return cls(coefficients=coef, intercept=inter, uid=uid)

    def _copy_extra_state(self, source):
        self.coefficients = source.coefficients
        self.intercept = source.intercept
        self._summary = getattr(source, "_summary", None)
        self._device = getattr(source, "_device", None)
        self._raw_cache = {}

    def _binary(self) -> bool:
        return self.coefficients.ndim == 1

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Per-class margins (logits) — Spark's rawPrediction vector.
        Binary: ``[-z, z]`` with z the log-odds."""
        x = np.asarray(x, dtype=np.float64)
        if self._binary():
            z = x @ self.coefficients + float(np.asarray(self.intercept).reshape(-1)[0])
            return np.stack([-z, z], axis=1)
        return x @ self.coefficients.T + np.asarray(self.intercept)[None, :]

    def _raw_to_proba(self, raw: np.ndarray) -> np.ndarray:
        return _proba(torch.from_numpy(np.asarray(raw, dtype=np.float64)), self._binary()).numpy()

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return self._raw_to_proba(self.predict_raw(x))

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=1)

    # Daemon serving contract (serve/daemon.py): wire algo and output roles.
    _serve_algo = "logreg"
    _serve_outputs = (
        ("rawPrediction", "rawPredictionCol", "vec"),
        ("probability", "probabilityCol", "vec"),
        ("prediction", "predictionCol", "double"),
    )

    def _raw_scorer(self):
        """Per-class margins with W and b resident on the device: x and W
        rounded to the compute dtype, multiplied in the accumulator dtype
        (the JAX scorer's ``preferred_element_type``), plus b. Binary:
        ``[-z, z]``. Cached by device and dtypes."""
        dev = resolve_device(self._device)
        cd, ad = config.compute_dtype(dev), config.accum_dtype()
        key = (str(dev), cd, ad)
        if key not in self._raw_cache:
            w_dev = as_tensor(np.atleast_2d(self.coefficients)).to(dev).to(cd).to(ad)  # (C|1, d)
            b_dev = as_tensor(np.atleast_1d(self.intercept)).to(dev, ad)
            binary = self._binary()

            def raw(x: torch.Tensor) -> torch.Tensor:
                z = x.to(dev).to(cd).to(ad) @ w_dev.T + b_dev[None, :]
                return torch.cat([-z, z], dim=1) if binary else z

            self._raw_cache[key] = raw
        return self._raw_cache[key]

    def transform_matrix(self, x) -> dict:
        """Role-keyed transform of a bare matrix: margins on the device,
        then probability and prediction in float64. A tensor in gives
        tensors on the model's device out; a host array in gives float64
        numpy out."""
        if self.coefficients is None:
            raise RuntimeError("model has no coefficients (unfitted?)")
        with trace_span("logreg transform"):
            raw = self._raw_scorer()(as_tensor(x)).double()
            proba = _proba(raw, self._binary())
            out = {
                "rawPrediction": raw,
                "probability": proba,
                "prediction": torch.argmax(proba, dim=1).double(),
            }
            if isinstance(x, torch.Tensor):
                return out
            return {k: v.cpu().numpy() for k, v in out.items()}

    def _transform(self, dataset):
        if self.coefficients is None:
            raise RuntimeError("model has no coefficients (unfitted?)")
        x = as_matrix(dataset, self.getFeaturesCol())
        raw = self.predict_raw(x.double().cpu().numpy() if isinstance(x, torch.Tensor) else x)
        proba = self._raw_to_proba(raw)
        # rawPrediction, probability, then prediction, as Spark's
        # ProbabilisticClassificationModel.
        out = with_column(dataset, self.getRawPredictionCol(), raw)
        out = with_column(out, self.getProbabilityCol(), proba)
        return with_column(out, self.getPredictionCol(), np.argmax(proba, axis=1))
