"""KMeans — Lloyd's algorithm in PyTorch on a CUDA device.

The port of ``spark_rapids_ml_tpu/models/kmeans.py`` (BASELINE.json
config #3, "KMeans k=100 on 50M×256").

* The in-memory :func:`fit_kmeans` keeps one copy of x in the compute
  dtype on the device. Each Lloyd iteration is ONE launch of the
  hand-written ``lloyd_step`` kernel (per-centre sums and integer counts
  in one pass over x), and the training cost at the final centres is ONE
  launch of ``assign_min_dist`` (``ops/kernels.py``; their plain versions
  on a CPU tensor). Other dtypes — the float64 parity mode — run the
  assignment as :func:`~spark_rapids_ml_tpu_torch.ops.distances.sq_euclidean`
  plus a first-index argmin in the accumulator dtype, as the JAX package
  leaves them to XLA.
* The loop reads the largest centre movement once per iteration and
  stops at ``max_iter`` or when it is ≤ tol² (Spark's convergence shape).
  Empty clusters keep their previous centre (Spark behaviour).
* :func:`fit_kmeans_stream` re-scans a batch source once per iteration
  for datasets larger than the device. As in the JAX package it uses no
  kernel: per batch, ``sq_euclidean``, argmin and ``index_add_`` sums,
  which also give the running cost. Across ranks (``mesh=``, a started
  ``torch.distributed`` world) each rank scans its own stream in lockstep,
  the pass statistics are summed over the ranks once a pass, and the init
  sample is gathered from every rank's stream head, so every rank
  computes the same centres. The in-memory fit stays single-process, as
  in the JAX package (its init samples local data).

Init is host numpy: "k-means++" (D² seeding on a ≤ 65,536-row sample) or
"random", copied from the JAX package so that the same seed gives the same
initial centres. When x lies on the device, the sample's row indices are
drawn on the host with the same numpy generator and those rows gathered.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core import checkpoint as ckpt
from spark_rapids_ml_tpu_torch.core.dataset import as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
    Model,
    ParamDecl,
    ParamValidators,
    TypeConverters,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops.distances import first_argmin, sq_euclidean
from spark_rapids_ml_tpu_torch.ops.gram import reduce_stats
from spark_rapids_ml_tpu_torch.parallel.distributed import (
    per_data_index,
    process_allgather,
    row_counts,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import default_mesh
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    as_tensor,
    lockstep_batches,
    predictor_key,
    require_single_process,
    resolve_device,
    to_device,
)
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

INIT_SAMPLE_ROWS = 65536  # kmeans.py:86


class KMeansSolution(NamedTuple):
    centers: np.ndarray  # (k, d)
    cost: float  # sum of squared distances to nearest center (training cost)
    n_iter: int
    n_rows: int


class KMeansSummary(NamedTuple):
    """Spark's KMeansSummary shape: trainingCost + iteration count."""

    trainingCost: float
    numIter: int
    k: int
    n_rows: int


# ---------------------------------------------------------------------------
# Init (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _host_rows(x, idx=None) -> np.ndarray:
    """Rows ``idx`` (all rows when None) of a numpy array or a tensor, as a
    host array (a tensor's bfloat16/float16 widened to float32, exactly)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x) if idx is None else np.asarray(x)[idx]
    rows = x if idx is None else x[torch.as_tensor(idx, device=x.device)]
    if rows.dtype in (torch.bfloat16, torch.float16):
        rows = rows.float()
    return rows.cpu().numpy()


def _kmeans_plus_plus(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Classic k-means++ D² seeding on a host subsample."""
    n = x.shape[0]
    sample = x if n <= 65536 else x[rng.choice(n, 65536, replace=False)]
    m = sample.shape[0]
    centers = np.empty((k, x.shape[1]), dtype=np.float64)
    centers[0] = sample[rng.integers(m)]
    d2 = np.sum((sample - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0:
            centers[i:] = sample[rng.integers(m, size=k - i)]
            break
        probs = d2 / total
        centers[i] = sample[rng.choice(m, p=probs)]
        d2 = np.minimum(d2, np.sum((sample - centers[i]) ** 2, axis=1))
    return centers


def _random_init(x, k: int, rng: np.random.Generator) -> np.ndarray:
    idx = rng.choice(x.shape[0], size=k, replace=False)
    return np.asarray(_host_rows(x, idx), dtype=np.float64)


def _init_centers(x, k: int, rng: np.random.Generator, init: str) -> np.ndarray:
    """(k, d) float64 initial centres of x (numpy array or tensor).

    For k-means++ the ≤ 65,536-row sample is drawn here with the same
    generator call as :func:`_kmeans_plus_plus` makes, and gathered to the
    host, so the draws — and the centres — match the JAX package's."""
    if init == "k-means++":
        n = x.shape[0]
        idx = None if n <= INIT_SAMPLE_ROWS else rng.choice(n, INIT_SAMPLE_ROWS, replace=False)
        return _kmeans_plus_plus(_host_rows(x, idx), k, rng)
    if init == "random":
        return _random_init(x, k, rng)
    raise ValueError(f"unknown init mode {init!r} (k-means++|random)")


# ---------------------------------------------------------------------------
# Lloyd
# ---------------------------------------------------------------------------


def _assign_min(xc: torch.Tensor, centers: torch.Tensor, cd, ad, kernel: bool):
    """(assignment, min squared distance) per row at ``centers``."""
    cc = centers.to(cd)
    if kernel:
        assign, part_d = kernels.assign_min_dist(xc, cc.contiguous())
        return assign, torch.clamp(part_d + kernels.row_sq_norms(xc, ad), min=0.0)
    d2 = sq_euclidean(xc, cc, accum_dtype=ad)
    assign = first_argmin(d2)
    return assign, d2.gather(1, assign[:, None])[:, 0]


def _lloyd_stats(xc: torch.Tensor, centers: torch.Tensor, cd, ad, kernel: bool):
    """Per-centre (sums (k, d), counts (k,)) in the accumulator dtype."""
    if kernel:
        sums, counts = kernels.lloyd_step(xc, centers.to(cd).contiguous(), xc.shape[0])
        return sums.to(ad), counts.to(ad)
    state = stream_zero_state(centers.shape[0], xc.shape[1], ad, xc.device)
    _stream_update(state, centers, xc, cd, ad)
    return state[0], state[1]


def apply_lloyd_update(sums, counts, centers):
    """One Lloyd centre update from a full pass's statistics.

    Empty clusters keep their previous centroid (Spark behavior). Returns
    (new_centers, moved² max over centers) — the update rule of both the
    in-memory and the streaming fit."""
    new_centers = torch.where(
        (counts > 0)[:, None], sums / torch.clamp(counts, min=1)[:, None], centers
    )
    moved2 = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
    return new_centers, moved2


def fit_kmeans(
    x,
    k: int,
    max_iter: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    init: str = "k-means++",
    device=None,
) -> KMeansSolution:
    """Lloyd's algorithm on an in-memory (n, d) matrix (numpy array or a
    tensor, possibly already on the card). ``device``: None → the card.

    x is cast once to the compute dtype on the device; with bfloat16/
    float32 compute and float32 accumulators every iteration is one
    ``lloyd_step`` launch and the final cost one ``assign_min_dist``
    launch."""
    require_single_process("fit_kmeans (k-means++/random init samples local data)")
    dev = resolve_device(device)
    n, d = x.shape
    if not 0 < k <= n:
        raise ValueError(f"k = {k} out of range (0, numRows = {n}]")
    rng = np.random.default_rng(seed)
    with trace_span("kmeans init"):
        centers0 = _init_centers(x, k, rng, init)
    cd, ad = config.compute_dtype(dev), config.accum_dtype()
    kernel = kernels.kernel_applicable(cd, ad)
    with trace_span("lloyd"):
        xc = to_device(x, dev, cd).contiguous()
        centers = torch.as_tensor(centers0, device=dev).to(ad)
        n_iter, moved2 = 0, float("inf")
        while n_iter < max_iter and moved2 > tol * tol:
            sums, counts = _lloyd_stats(xc, centers, cd, ad, kernel)
            centers, moved = apply_lloyd_update(sums, counts, centers)
            moved2 = float(moved)
            n_iter += 1
        # Final training cost at the converged centres (one assignment pass).
        _, min_d2 = _assign_min(xc, centers, cd, ad, kernel)
        cost = float(torch.sum(min_d2))
    return KMeansSolution(
        centers=centers.cpu().numpy().astype(np.float64),
        cost=cost,
        n_iter=n_iter,
        n_rows=int(n),
    )


# ---------------------------------------------------------------------------
# Streaming (out-of-device-memory) Lloyd: one scan of the source per iteration
# ---------------------------------------------------------------------------


def stream_zero_state(k: int, n_cols: int, accum_dtype, device=None) -> tuple:
    """Zero (sums, counts, cost) accumulator for one Lloyd pass."""
    return (
        torch.zeros((k, n_cols), dtype=accum_dtype, device=device),
        torch.zeros((k,), dtype=accum_dtype, device=device),
        torch.zeros((), dtype=accum_dtype, device=device),
    )


def _stream_update(state: tuple, centers: torch.Tensor, xc: torch.Tensor, cd, ad) -> None:
    """Fold one batch's Lloyd statistics at fixed centres into ``state`` in
    place (the JAX package's donated ``_stream_step_fn``): sq_euclidean,
    first-index argmin, ``index_add_`` sums (their order is not fixed on
    CUDA, so f32 sums may differ in the last bits between runs). Also the
    float64 path of the in-memory fit, on a zero state."""
    sums, counts, cost = state
    assign, min_d2 = _assign_min(xc, centers, cd, ad, kernel=False)
    sums.index_add_(0, assign, xc.to(ad))
    counts.add_(torch.bincount(assign, minlength=counts.shape[0]).to(ad))
    cost.add_(torch.sum(min_d2))


def _gather_sample(local: torch.Tensor, per: int, n_cols: int, mesh) -> torch.Tensor:
    """Every data index's init-sample rows (at most ``per``), concatenated
    in data-index order over the control plane: the row counts, then each
    rank's rows padded to ``per`` (the ranks of one data index hold the
    same rows: one copy each). A host float32 tensor."""
    counts = row_counts(local.shape[0], mesh)
    buf = np.zeros((per, n_cols), np.float32)
    buf[: local.shape[0]] = local.cpu().numpy()
    gathered = per_data_index(process_allgather(buf), mesh, "init samples")
    return torch.from_numpy(np.concatenate([gathered[p, :c] for p, c in enumerate(counts)]))


def fit_kmeans_stream(
    batch_source,
    k: int,
    n_cols: int,
    max_iter: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    init: str = "k-means++",
    checkpoint_path: Optional[str] = None,
    init_sample_rows: int = INIT_SAMPLE_ROWS,
    device=None,
    mesh=None,
) -> KMeansSolution:
    """Lloyd's algorithm over a re-scannable stream of row batches — the
    capacity path for datasets larger than the device.

    ``batch_source`` is a CALLABLE returning a fresh iterator of (rows, d)
    arrays or tensors; each Lloyd iteration consumes one full scan. Each
    batch is placed on the device as float32, then cast to the compute
    dtype (the JAX package's placement), and folded into the (sums,
    counts, cost) state in place. One extra scan at the end computes the
    exact training cost at the final centres.

    The initial centres come from a sample of the stream's first
    ``init_sample_rows`` rows. With ``checkpoint_path``, the centres are
    persisted after every iteration and an interrupted fit resumes at the
    saved iteration; the file is removed on success.

    **Across ranks** (``mesh`` of a started world): ``batch_source``
    yields THIS rank's stream; scans run in lockstep (uneven stream
    lengths are fine), each pass's statistics are summed over the ranks,
    and the init sample is ``ceil(init_sample_rows / ranks)`` rows of
    every rank's stream head, gathered in rank order, so every rank
    computes the same centres. Rank 0 alone writes the checkpoints, which
    every rank must see (a shared filesystem)."""
    if k <= 0:
        raise ValueError(f"k = {k} must be > 0")
    if init not in ("k-means++", "random"):
        raise ValueError(f"unknown init mode {init!r} (k-means++|random)")
    mesh = mesh or default_mesh()
    dev = resolve_device(device, mesh)
    cd, ad = config.compute_dtype(dev), config.accum_dtype()

    start_iter = 0
    centers = None
    restored = ckpt.load_state(checkpoint_path) if checkpoint_path else None
    if checkpoint_path:
        ckpt.require_consistent_visibility(restored)
    if restored is not None:
        arrays, meta = restored
        if meta.get("n_cols") != n_cols or meta.get("k") != k:
            raise ValueError(
                f"checkpoint at {checkpoint_path} is for k="
                f"{meta.get('k')}, n_cols={meta.get('n_cols')}, not ({k}, {n_cols})"
            )
        centers = np.asarray(arrays["centers"])
        start_iter = int(meta["it"])
    if centers is None:
        rng = np.random.default_rng(seed)
        per = -(-init_sample_rows // mesh.size) if mesh.collective else init_sample_rows
        head = []
        got = 0
        for batch in batch_source():
            head.append(to_device(batch, dev, torch.float32))
            got += head[-1].shape[0]
            if got >= per:
                break
        sample = (torch.cat(head)[:per] if head
                  else torch.zeros((0, n_cols), dtype=torch.float32, device=dev))
        del head
        if mesh.collective:
            sample = _gather_sample(sample, per, n_cols, mesh).to(dev)
        if sample.shape[0] == 0:
            raise ValueError("batch_source yielded no batches")
        if k > sample.shape[0]:
            raise ValueError(
                f"k = {k} exceeds the {sample.shape[0]}-row init sample; "
                f"raise init_sample_rows"
            )
        with trace_span("kmeans init"):
            centers = _init_centers(sample, k, rng, init)
        del sample

    def check(x) -> Optional[str]:
        if x.ndim != 2 or x.shape[1] != n_cols:
            return f"batch has shape {tuple(x.shape)}, expected (m, {n_cols})"
        return None

    def scan(centers_dev):
        state = stream_zero_state(k, n_cols, ad, dev)
        n_rows = 0
        for batch in lockstep_batches(batch_source(), n_cols, check):
            xb = to_device(batch, dev, torch.float32)
            n_rows += xb.shape[0]
            if xb.shape[0]:
                _stream_update(state, centers_dev, xb.to(cd), cd, ad)
        if mesh.collective:
            return reduce_stats(state, mesh), int(row_counts(n_rows, mesh).sum())
        return state, n_rows

    n_true = 0
    n_iter = start_iter
    centers_dev = torch.as_tensor(centers, device=dev).to(ad)
    with trace_span("lloyd-stream"):
        for it in range(start_iter, max_iter):
            (sums, counts, _), n_true = scan(centers_dev)
            centers_dev, moved2 = apply_lloyd_update(sums, counts, centers_dev)
            moved2 = float(moved2)
            n_iter = it + 1
            if checkpoint_path and ckpt.is_writer():
                ckpt.save_state(
                    checkpoint_path,
                    {"centers": centers_dev.cpu().numpy()},
                    {"it": n_iter, "k": k, "n_cols": n_cols},
                )
            if moved2 <= float(tol) ** 2:
                break
        # Exact cost at the final centres (one cost-only scan).
        (_, _, cost), n_true = scan(centers_dev)
    if checkpoint_path and ckpt.is_writer() and os.path.exists(checkpoint_path):
        ckpt.discard_state(checkpoint_path)
    return KMeansSolution(
        centers=centers_dev.cpu().numpy().astype(np.float64),
        cost=float(cost),
        n_iter=n_iter,
        n_rows=n_true,
    )


# ---------------------------------------------------------------------------
# Estimator / Model
# ---------------------------------------------------------------------------


class _KMeansParams(HasFeaturesCol, HasPredictionCol, HasMaxIter, HasTol, HasSeed):
    k = ParamDecl(
        "k",
        "number of clusters (> 0)",
        TypeConverters.toInt,
        validator=ParamValidators.gt(0),
    )
    initMode = ParamDecl(
        "initMode",
        "initialization: k-means++ | random",
        TypeConverters.toString,
        validator=ParamValidators.inList(["k-means++", "random"]),
    )

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(
            k=2,
            maxIter=20,
            tol=1e-4,
            seed=0,
            initMode="k-means++",
            featuresCol="features",
            predictionCol="prediction",
        )

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getInitMode(self) -> str:
        return self.getOrDefault(self.initMode)


class KMeans(Estimator, _KMeansParams, MLWritable, MLReadable):
    """``KMeans().setK(100).fit(df)`` — Spark ML clustering API shape.

    ``device``: where the fit runs; None → the card."""

    _uid_prefix = "KMeans"
    _persist_class = "spark_rapids_ml_tpu.models.kmeans.KMeans"

    def __init__(self, uid=None, device=None):
        super().__init__(uid=uid)
        self._device = device

    def setK(self, value: int) -> "KMeans":
        return self._set(k=value)

    def setInitMode(self, value: str) -> "KMeans":
        return self._set(initMode=value)

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)

    def _fit(self, dataset) -> "KMeansModel":
        x = as_matrix(dataset, self.getFeaturesCol())
        sol = fit_kmeans(
            x,
            k=self.getK(),
            max_iter=self.getMaxIter(),
            tol=self.getTol(),
            seed=self.getSeed(),
            init=self.getInitMode(),
            device=self._device,
        )
        model = KMeansModel(centers=sol.centers, device=self._device)
        model.uid = self.uid
        model._training_cost = sol.cost
        model._n_iter = sol.n_iter
        model._summary = KMeansSummary(
            trainingCost=sol.cost, numIter=sol.n_iter, k=self.getK(), n_rows=sol.n_rows
        )
        self._copy_params_to(model)
        return model


class KMeansModel(Model, _KMeansParams, MLWritable, MLReadable):
    """Fitted centres + predict(); ``summary.trainingCost`` equivalent.

    ``device``: where predict runs; None → the card."""

    _uid_prefix = "KMeansModel"
    # The layout's class name, shared with the JAX package (persistence.py).
    _persist_class = "spark_rapids_ml_tpu.models.kmeans.KMeansModel"

    def __init__(self, centers: Optional[np.ndarray] = None, uid=None, device=None):
        super().__init__(uid=uid)
        self.centers = None if centers is None else np.asarray(centers)
        self._training_cost: Optional[float] = None
        self._n_iter: Optional[int] = None
        self._summary: Optional[KMeansSummary] = None
        self._device = device
        self._predict_cache: dict = {}

    @property
    def summary(self) -> Optional[KMeansSummary]:
        return self._summary

    @property
    def hasSummary(self) -> bool:
        return self._summary is not None

    def clusterCenters(self) -> np.ndarray:
        return self.centers

    @property
    def trainingCost(self) -> Optional[float]:
        return self._training_cost

    def _model_data(self):
        return {"clusterCenters": self.centers}

    @classmethod
    def _from_model_data(cls, uid, data):
        return cls(centers=data["clusterCenters"], uid=uid)

    def _copy_extra_state(self, source):
        self.centers = source.centers
        self._training_cost = source._training_cost
        self._n_iter = source._n_iter
        self._summary = getattr(source, "_summary", None)
        self._device = getattr(source, "_device", None)
        self._predict_cache = {}

    def _predictor(self):
        """Nearest centre per row (int32): ``sq_euclidean`` in the compute
        and accumulator dtypes with the centres resident on the device, and
        a first-index argmin. Cached by device and dtypes."""
        key = predictor_key(self._device)
        if key not in self._predict_cache:
            dev, cd, ad = resolve_device(self._device), key[1], key[2]
            centers_dev = as_tensor(self.centers).to(dev).to(cd)

            def predict(x: torch.Tensor) -> torch.Tensor:
                d2 = sq_euclidean(x.to(dev).to(cd), centers_dev, accum_dtype=ad)
                return first_argmin(d2).to(torch.int32)

            self._predict_cache[key] = predict
        return self._predict_cache[key]

    def _serve_aot_plan(self, n_rows, n_cols, dtype="float32", k=None):
        """AOT-at-registration plan (``serve/aot.py``): the nearest-centre
        predictor over one served bucket of ``n_rows`` wire-dtype rows. A
        wrong width raises."""
        if self.centers is None:
            return None
        from spark_rapids_ml_tpu_torch.serve import aot

        return aot.transform_plan(self, n_rows, n_cols, dtype, np.asarray(self.centers).shape[1],
                                  self._predictor(), lambda outs, n: {"prediction": outs[0]})

    def predict(self, x):
        """Nearest centre per row: numpy int32 for a host array, a tensor
        on the model's device for a tensor."""
        if self.centers is None:
            raise RuntimeError("KMeansModel has no centers (unfitted?)")
        if isinstance(x, torch.Tensor):
            return self._predictor()(x)
        return self._predictor()(as_tensor(x)).cpu().numpy()

    # Daemon serving contract (serve/daemon.py): wire algo and output roles.
    _serve_algo = "kmeans"
    _serve_outputs = (("prediction", "predictionCol", "int"),)

    def transform_matrix(self, x) -> dict:
        """Role-keyed device transform (the serving surface)."""
        with trace_span("kmeans transform"):
            return {"prediction": self.predict(x)}

    def _transform(self, dataset):
        x = as_matrix(dataset, self.getFeaturesCol())
        return with_column(dataset, self.getPredictionCol(), self.predict(x))
