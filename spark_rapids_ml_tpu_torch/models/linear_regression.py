"""LinearRegression via the normal equations, in PyTorch on a CUDA device,
or on one per rank.

The port of ``spark_rapids_ml_tpu/models/linear_regression.py``
(BASELINE.json config #4). One pass over the rows computes the fused
statistics (XᵀX, Xᵀy, Σx, Σy, Σy², n); the d×d solve then runs on the
fit's device. With bfloat16/float32 compute and float32 accumulators the
pass is ONE launch of the hand-written ``linreg_stats`` kernel
(``ops/kernels.py``; its plain version on a CPU tensor); other dtypes —
the float64 parity mode — are plain products in the accumulator dtype, as
the JAX package leaves them to XLA.

Solver semantics (objective matches Spark ML's LinearRegression with
``standardization=False``):

    min_w  1/(2n) ‖Xw + b − y‖² + λ·(α‖w‖₁ + (1−α)/2·‖w‖₂²)

* α = 0 (ridge / OLS): closed form, (XᵀX/n + λI) w = Xᵀy/n via Cholesky.
* α > 0 (lasso / elastic net): FISTA on the normal-equation statistics,
  step size 1/L from 50 power-iteration steps, soft-threshold prox.
* fitIntercept: solved on centred statistics; intercept = ȳ − x̄·w.

Across ranks (``mesh=``, a started ``torch.distributed`` world) each rank
computes its own rows' statistics with the same kernel and the six meet
in an ``all_reduce`` before the solve, which every rank then runs on the
same replicated statistics.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core.dataset import as_column, as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasElasticNetParam,
    HasFeaturesCol,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasRegParam,
    HasTol,
    Model,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops.linalg import solve_spd
from spark_rapids_ml_tpu_torch.ops.gram import reduce_stats
from spark_rapids_ml_tpu_torch.parallel.distributed import row_counts
from spark_rapids_ml_tpu_torch.parallel.mesh import default_mesh
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    as_tensor,
    predictor_key,
    resolve_device,
    to_device,
)
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

#: (XᵀX, Xᵀy, Σx, Σy, Σy², n) in the accumulator dtype.
NormalEqStats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]


class LinearRegressionTrainingSummary(NamedTuple):
    """Training metrics computed FROM THE FIT STATISTICS — zero extra data
    passes (RSS/R²/RMSE are closed forms over the normal-equation moments)."""

    rmse: float
    r2: float
    rss: float
    tss: float
    n_rows: int


class LinearSolution(NamedTuple):
    coefficients: np.ndarray  # (d,)
    intercept: float
    n_rows: int
    summary: Optional[LinearRegressionTrainingSummary] = None


def _plain_stats(x, y, mask, cd, ad, state: NormalEqStats) -> NormalEqStats:
    """The statistics as plain products in the accumulator dtype (the JAX
    package's XLA path), added into ``state`` in place."""
    xc = x.to(cd)
    yc = y.to(ad)
    if mask is not None:
        xc = xc * mask.to(cd)[:, None]
        yc = yc * mask.to(ad)
    xa = xc.to(ad)
    xtx, xty, sx, sy, syy, n = state
    xtx.add_(xa.T @ xa)
    xty.add_(xa.T @ yc.to(cd).to(ad))  # y rounded to the compute dtype, as in JAX
    sx.add_(xa.sum(dim=0))
    sy.add_(yc.sum())
    syy.add_((yc * yc).sum())
    # Integer count: a float32 sum of ones saturates at 2^24 rows.
    n.add_(x.shape[0] if mask is None else mask.to(torch.int64).sum())
    return state


def init_normal_eq_stats(n_cols: int, accum_dtype=None, device=None) -> NormalEqStats:
    """Zero (XᵀX, Xᵀy, Σx, Σy, Σy², n) accumulator for streaming fits."""
    ad = accum_dtype or config.accum_dtype()
    z = lambda *shape: torch.zeros(shape, dtype=ad, device=device)  # noqa: E731
    return z(n_cols, n_cols), z(n_cols), z(n_cols), z(), z(), z()


def streaming_normal_eq_update(state: NormalEqStats, x, y, mask=None,
                               mesh=None) -> NormalEqStats:
    """Fold one batch (x (m, d), y (m,), mask (m,) of {0,1} or None) into
    ``state`` IN PLACE — the analogue of the JAX package's donated update.

    With bfloat16/float32 compute and a float32 state this is ONE launch
    of the seeded ``linreg_stats`` kernel per batch. Host arrays are
    placed on the state's device; x should arrive in the compute dtype
    already (the ingest casts once).

    With a ``mesh`` of a started world, x is this rank's batch of the
    lockstep and ``state`` the replicated state: the batch folds into a
    zero partial, which is summed over the ranks and then added (a rank
    without rows in this step adds a zero partial, with no launch)."""
    if mesh is not None and mesh.collective:
        part = init_normal_eq_stats(state[0].shape[0], state[0].dtype, state[0].device)
        if x.shape[0]:
            streaming_normal_eq_update(part, x, y, mask)
        for t, p in zip(state, reduce_stats(part, mesh)):
            t.add_(p)
        return state
    dev = state[0].device
    cd = config.compute_dtype(dev)
    xc = to_device(x, dev, cd)
    if kernels.kernel_applicable(cd, state[0].dtype):
        yf = to_device(y, dev, torch.float32).reshape(-1)
        m = None if mask is None else to_device(mask, dev, torch.float32).contiguous()
        kernels.linreg_stats(xc.contiguous(), yf.contiguous(), m, state=state)
        return state
    m = None if mask is None else to_device(mask, dev)
    return _plain_stats(xc, to_device(y, dev).reshape(-1), m, cd, state[0].dtype, state)


def normal_eq_stats(x: torch.Tensor, y: torch.Tensor) -> NormalEqStats:
    """One pass over all rows of x (on its device): fresh statistics.

    The port of ``_normal_eq_stats_fn`` for one device, which pads nothing,
    so no mask: one ``linreg_stats`` launch with bfloat16/float32 compute
    and float32 accumulators."""
    state = init_normal_eq_stats(x.shape[1], device=x.device)
    return streaming_normal_eq_update(state, x, y)


def _fista(a: torch.Tensor, b: torch.Tensor, l1: float, iters: int, tol: float) -> torch.Tensor:
    """min_w ½wᵀAw − bᵀw + l1‖w‖₁ via FISTA; A is PSD d×d.

    Stops when the iterate movement ‖w_{t+1} − w_t‖ drops to ``tol`` or
    below, else after ``iters`` steps (the JAX ``while_loop``'s rule)."""
    d = a.shape[0]
    # Lipschitz constant: largest eigenvalue of A by 50 power steps.
    v = torch.ones((d,), dtype=a.dtype, device=a.device) / torch.sqrt(
        torch.tensor(float(d), dtype=a.dtype))
    for _ in range(50):
        v = a @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    lip = torch.clamp(v @ (a @ v), min=1e-12)
    step = 1.0 / lip

    def soft(z, t):
        return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)

    w = torch.zeros((d,), dtype=a.dtype, device=a.device)
    z = w
    t = 1.0
    for _ in range(iters):
        g = a @ z - b
        w_next = soft(z - step * g, step * l1)
        t_next = 0.5 * (1.0 + float(np.sqrt(1.0 + 4.0 * t * t)))
        z = w_next + ((t - 1.0) / t_next) * (w_next - w)
        delta = float(torch.linalg.norm(w_next - w))
        w, t = w_next, t_next
        if not delta > tol:
            break
    return w


def _solve(stats: NormalEqStats, fit_intercept: bool, reg: float, alpha: float,
           max_iter: int, tol: float):
    """stats → (coefficients, intercept) in the stats' dtype and device."""
    xtx, xty, sx, sy, _syy, n = stats
    n = torch.clamp(n, min=1.0)
    if fit_intercept:
        mx = sx / n
        my = sy / n
        a = xtx - torch.outer(mx, sx)  # centred XᵀX
        b = xty - sx * my  # centred Xᵀy
    else:
        a, b = xtx, xty
    a = a / n
    b = b / n
    l2 = reg * (1.0 - alpha)
    l1 = reg * alpha
    if l1 > 0:
        eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        w = _fista(a + l2 * eye, b, l1, max_iter, tol)
    else:
        w = solve_spd(a, b, reg=l2)
    intercept = my - mx @ w if fit_intercept else torch.zeros((), dtype=a.dtype)
    return w, intercept


def fit_linear_regression(
    x,
    y,
    reg: float = 0.0,
    elastic_net: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 500,
    tol: float = 1e-6,
    device=None,
    mesh=None,
) -> LinearSolution:
    """Fit on an in-memory (n, d) matrix and (n,) labels (numpy arrays or
    tensors): one statistics pass (one ``linreg_stats`` launch), then the
    solve. ``device``: None → the mesh's rank device, else the card.
    ``mesh``: None → ``default_mesh()``; across ranks (x, y) are THIS
    rank's rows, the statistics are summed over the ranks and ``n_rows``
    is the global count."""
    mesh = mesh or default_mesh()
    dev = resolve_device(device, mesh)
    if x.shape[0] != y.reshape(-1).shape[0]:
        raise ValueError(f"X rows {x.shape[0]} != y rows {y.reshape(-1).shape[0]}")
    with trace_span("normal equations"):
        xs = to_device(x, dev, config.compute_dtype(dev))
        if mesh.collective:
            stats = init_normal_eq_stats(xs.shape[1], device=dev)
            streaming_normal_eq_update(stats, xs, as_tensor(y).reshape(-1), mesh=mesh)
            n_rows = int(row_counts(xs.shape[0], mesh).sum())
        else:
            stats = normal_eq_stats(xs, as_tensor(y).reshape(-1))
            n_rows = int(x.shape[0])
    return finalize_normal_eq_stats(stats, reg, elastic_net, fit_intercept, max_iter, tol, n_rows)


def finalize_normal_eq_stats(
    stats,
    reg: float,
    elastic_net: float,
    fit_intercept: bool,
    max_iter: int,
    tol: float,
    n_true: int,
) -> LinearSolution:
    """(XᵀX, Xᵀy, Σx, Σy, Σy², n) accumulator (tensors or arrays) →
    LinearSolution. The shared tail of batch and streaming fits; the solve
    runs where the stats lie, in their dtype, the summary on the host in
    float64."""
    stats = tuple(as_tensor(s) for s in stats)
    with trace_span("solve"):
        w, b = _solve(stats, bool(fit_intercept), float(reg), float(elastic_net),
                      int(max_iter), float(tol))
    w = w.cpu().numpy().astype(np.float64)
    b = float(b)
    xtx, xty, sx, sy, syy, n = (s.cpu().numpy().astype(np.float64) for s in stats)
    n = float(n)
    # Closed-form training metrics from the moments (no second data pass):
    # RSS = Σy² − 2(wᵀXᵀy + bΣy) + wᵀXᵀXw + 2b·wᵀΣx + b²n.
    rss = max(
        float(
            syy - 2.0 * (w @ xty + b * sy) + w @ xtx @ w + 2.0 * b * (w @ sx) + b * b * n
        ),
        0.0,  # clamp: low-precision compute can round a perfect fit negative
    )
    tss = float(syy - sy * sy / max(n, 1.0))
    summary = LinearRegressionTrainingSummary(
        rmse=float(np.sqrt(rss / max(n, 1.0))),
        r2=float(1.0 - rss / tss) if tss > 0 else 0.0,
        rss=rss,
        tss=tss,
        n_rows=n_true,
    )
    return LinearSolution(coefficients=w, intercept=b, n_rows=n_true, summary=summary)


# ---------------------------------------------------------------------------
# Estimator / Model
# ---------------------------------------------------------------------------


class _LinearRegressionParams(
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasRegParam,
    HasElasticNetParam,
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
            regParam=0.0,
            elasticNetParam=0.0,
            fitIntercept=True,
            maxIter=500,
            tol=1e-6,
        )


class LinearRegression(Estimator, _LinearRegressionParams, MLWritable, MLReadable):
    """Spark-ML-shaped linear regression on the normal-equations path.

    ``device``: where the fit runs; None → the card. ``mesh``: the ranks the
    fit spans (None → ``default_mesh()``; see :func:`fit_linear_regression`)."""

    _uid_prefix = "LinearRegression"
    _persist_class = "spark_rapids_ml_tpu.models.linear_regression.LinearRegression"

    def __init__(self, uid=None, device=None, mesh=None):
        super().__init__(uid=uid)
        self._device = device
        self._mesh = mesh

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)
        self._mesh = getattr(source, "_mesh", None)

    def _fit(self, dataset) -> "LinearRegressionModel":
        x = as_matrix(dataset, self.getFeaturesCol())
        y = as_column(dataset, self.getLabelCol())
        sol = fit_linear_regression(
            x,
            y,
            reg=self.getRegParam(),
            elastic_net=self.getElasticNetParam(),
            fit_intercept=self.getFitIntercept(),
            max_iter=self.getMaxIter(),
            tol=self.getTol(),
            device=self._device,
            mesh=self._mesh,
        )
        model = LinearRegressionModel(
            coefficients=sol.coefficients, intercept=sol.intercept, device=self._device
        )
        model.uid = self.uid
        model._summary = sol.summary
        self._copy_params_to(model)
        return model


class LinearRegressionModel(Model, _LinearRegressionParams, MLWritable, MLReadable):
    """Fitted coefficients and intercept. ``predict`` is the host numpy
    product; ``transform_matrix`` runs on ``device`` (None → the card)."""

    _uid_prefix = "LinearRegressionModel"
    # The layout's class name, shared with the JAX package (persistence.py).
    _persist_class = "spark_rapids_ml_tpu.models.linear_regression.LinearRegressionModel"

    def __init__(self, coefficients=None, intercept: float = 0.0, uid=None, device=None):
        super().__init__(uid=uid)
        self.coefficients = None if coefficients is None else np.asarray(coefficients)
        self.intercept = float(intercept)
        self._summary: Optional[LinearRegressionTrainingSummary] = None
        self._device = device
        self._predict_cache: dict = {}

    @property
    def summary(self) -> Optional[LinearRegressionTrainingSummary]:
        """Training metrics (rmse, r2, ...), Spark's model.summary shape.
        None after persistence reload (metrics are training-time only)."""
        return self._summary

    def _model_data(self):
        return {
            "coefficients": self.coefficients,
            "intercept": np.asarray([self.intercept]),
        }

    @classmethod
    def _from_model_data(cls, uid, data):
        return cls(
            coefficients=data["coefficients"],
            intercept=float(np.asarray(data["intercept"]).reshape(-1)[0]),
            uid=uid,
        )

    def _copy_extra_state(self, source):
        self.coefficients = source.coefficients
        self.intercept = source.intercept
        self._summary = getattr(source, "_summary", None)
        self._device = getattr(source, "_device", None)
        self._predict_cache = {}

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        return x @ self.coefficients + self.intercept

    # Daemon serving contract (serve/daemon.py): wire algo and output roles.
    _serve_algo = "linreg"
    _serve_outputs = (("prediction", "predictionCol", "double"),)

    def _predictor(self):
        """y = x @ w + b with the coefficients resident on the device, both
        operands rounded to the compute dtype and multiplied in the
        accumulator dtype (the JAX predictor's ``preferred_element_type``).
        Cached by device and dtypes."""
        key = predictor_key(self._device)
        if key not in self._predict_cache:
            dev, cd, ad = resolve_device(self._device), key[1], key[2]
            w_dev = as_tensor(self.coefficients).to(dev).to(cd).to(ad)
            b = float(self.intercept)

            def predict(x: torch.Tensor) -> torch.Tensor:
                return x.to(dev).to(cd).to(ad) @ w_dev + b

            self._predict_cache[key] = predict
        return self._predict_cache[key]

    def _serve_aot_plan(self, n_rows, n_cols, dtype="float32", k=None):
        """AOT-at-registration plan (``serve/aot.py``): the predictor over
        one served bucket of ``n_rows`` wire-dtype rows, float64 out as
        :meth:`transform_matrix` answers. A wrong width raises."""
        if self.coefficients is None:
            return None
        from spark_rapids_ml_tpu_torch.serve import aot

        return aot.transform_plan(self, n_rows, n_cols, dtype,
                                  np.asarray(self.coefficients).reshape(-1).shape[0],
                                  self._predictor(),
                                  lambda outs, n: {"prediction": outs[0].astype(np.float64)})

    def transform_matrix(self, x) -> dict:
        """Role-keyed device transform. A tensor in gives a tensor on the
        model's device out; a host array in gives float64 numpy out."""
        if self.coefficients is None:
            raise RuntimeError("model has no coefficients (unfitted?)")
        with trace_span("linreg transform"):
            if isinstance(x, torch.Tensor):
                return {"prediction": self._predictor()(x)}
            y = self._predictor()(as_tensor(x))
            return {"prediction": y.cpu().numpy().astype(np.float64)}

    def _transform(self, dataset):
        if self.coefficients is None:
            raise RuntimeError("model has no coefficients (unfitted?)")
        x = as_matrix(dataset, self.getFeaturesCol())
        return with_column(
            dataset, self.getPredictionCol(), self.transform_matrix(x)["prediction"]
        )
