"""RandomForest — histogram trees grown level-synchronously on the device.

The port of ``spark_rapids_ml_tpu/models/random_forest.py`` (its
in-process half: the fit, the predictor, the estimators and persistence).

* Features quantize once to bin ids against quantile-sketch edges (part of
  the model: fit and predict bin alike, in the accumulation dtype).
* All trees grow level-synchronously: one pass over the rows per depth
  routes every row to its frontier node in every tree and accumulates ONE
  ``(tree, node, feature, bin, stat)`` histogram (``ops/histogram.py``).
  The rows are binned once and stay resident on the device, as bin ids,
  across the passes.
* Split selection scores every (node, feature, threshold) candidate at
  once on the device (Gini or variance gain); the small node tables are
  written on the host.
* The fitted forest is a dense ``(tree, node)`` heap table (the children
  of i at 2i+1 and 2i+2); predict bins a batch and descends every tree by
  gathers, then averages the trees' class distributions (argmax) or leaf
  means.

Bootstrap bags are counter-based Poisson(1) weights keyed on each row's
(partition, offset) identity: an in-memory fit is partition 0.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core.dataset import as_column, as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasSeed,
    Model,
    ParamDecl,
    ParamValidators,
    TypeConverters,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.ops import histogram as hist_ops
from spark_rapids_ml_tpu_torch.ops.histogram import LEAF, OPEN
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    as_tensor,
    predictor_key,
    require_single_process,
    resolve_device,
    to_device,
)
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

#: Dense-heap bound: max_nodes = 2^(maxDepth+1) − 1 per tree.
MAX_MAX_DEPTH = 16


class ForestCapacityError(ValueError):
    """A frontier histogram over the budget (config
    ``forest_hist_budget_mb``), refused at the pass that would allocate it,
    never as a mid-pass out-of-memory. A ``ValueError``: a replay cannot
    fix a too-large shape."""


class ForestSpec(NamedTuple):
    """Resolved creation params of one forest (the one parse of the
    ``params`` dict, shared by the fit and the split scorer)."""

    num_trees: int
    max_depth: int
    max_bins: int
    n_classes: int  # 0 = regression
    subset_m: int
    seed: int
    bootstrap: bool
    min_instances: int

    @property
    def n_stats(self) -> int:
        return self.n_classes if self.n_classes > 0 else 3

    @property
    def max_nodes(self) -> int:
        return (1 << (self.max_depth + 1)) - 1

    def role(self) -> str:
        return "classifier" if self.n_classes > 0 else "regressor"


def subset_size(strategy: str, n_cols: int, classifier: bool) -> int:
    """featureSubsetStrategy → per-node candidate-feature count (Spark ML
    semantics: auto = sqrt for classification, onethird for regression;
    also all|sqrt|onethird|log2, an integer count, or a (0, 1] fraction)."""
    s = str(strategy).strip().lower()
    if s == "auto":
        s = "sqrt" if classifier else "onethird"
    if s == "all":
        return n_cols
    if s == "sqrt":
        return max(1, int(math.ceil(math.sqrt(n_cols))))
    if s == "onethird":
        return max(1, n_cols // 3)
    if s == "log2":
        return max(1, int(math.floor(math.log2(max(n_cols, 2)))))
    try:
        v = float(s)
    except ValueError:
        raise ValueError(
            f"unknown featureSubsetStrategy {strategy!r} "
            "(auto|all|sqrt|onethird|log2|<int>|<fraction>)"
        ) from None
    if 0.0 < v <= 1.0 and "." in s:
        return max(1, int(math.ceil(v * n_cols)))
    if v >= 1.0 and v == int(v):
        return min(n_cols, int(v))
    raise ValueError(
        f"featureSubsetStrategy {strategy!r} must be a strategy name, an "
        "integer >= 1, or a fraction in (0, 1]"
    )


def forest_spec_from_params(params: Dict, n_cols: int) -> ForestSpec:
    """Validate and resolve one ``params`` dict; a ``ValueError`` for an
    out-of-range creation param (the reference's messages)."""
    params = params or {}

    def _p(key, default, cast=int):
        # None-aware (never `or`): an explicit 0 must reach the range checks.
        v = params.get(key)
        return default if v is None else cast(v)

    num_trees = _p("num_trees", 20)
    max_depth = _p("max_depth", 5)
    max_bins = _p("max_bins", 32)
    n_classes = _p("n_classes", 0)
    seed = _p("seed", 0)
    bootstrap = _p("bootstrap", True, bool)
    min_instances = _p("min_instances", 1)
    strategy = _p("subset", "auto", str)
    if num_trees < 1:
        raise ValueError(f"num_trees = {num_trees} must be >= 1")
    if not 1 <= max_depth <= MAX_MAX_DEPTH:
        raise ValueError(
            f"max_depth = {max_depth} out of range [1, {MAX_MAX_DEPTH}] "
            "(dense (tree, node) heap tables)"
        )
    if not 2 <= max_bins <= 256:
        raise ValueError(f"max_bins = {max_bins} out of range [2, 256] (uint8 bin ids)")
    if n_classes == 1 or n_classes < 0:
        raise ValueError(f"n_classes = {n_classes} must be 0 (regression) or >= 2")
    if min_instances < 1:
        raise ValueError(f"min_instances = {min_instances} must be >= 1")
    return ForestSpec(
        num_trees=num_trees,
        max_depth=max_depth,
        max_bins=max_bins,
        n_classes=n_classes,
        subset_m=subset_size(strategy, n_cols, n_classes > 0),
        seed=seed,
        bootstrap=bootstrap,
        min_instances=min_instances,
    )


def require_hist_capacity(spec: ForestSpec, depth: int, n_cols: int) -> None:
    """Refuse a frontier histogram over ``forest_hist_budget_mb`` at the
    pass that would allocate it."""
    budget = int(config.get("forest_hist_budget_mb")) << 20
    itemsize = torch.empty((), dtype=config.accum_dtype()).element_size()
    need = spec.num_trees * (1 << depth) * n_cols * spec.max_bins * spec.n_stats * itemsize
    if budget and need > budget:
        raise ForestCapacityError(
            f"the depth-{depth} frontier histogram "
            f"({spec.num_trees} trees x {1 << depth} nodes x {n_cols} "
            f"features x {spec.max_bins} bins x {spec.n_stats} stats = "
            f"{need >> 20} MiB) exceeds forest_hist_budget_mb "
            f"({budget >> 20} MiB); lower maxDepth/maxBins/numTrees or "
            "raise SRML_FOREST_HIST_BUDGET_MB"
        )


def init_forest_arrays(spec: ForestSpec, bin_edges: np.ndarray) -> Dict[str, np.ndarray]:
    """The depth-0 iterate: quantile edges and empty node tables with every
    root OPEN (the reference's layout)."""
    edges = np.asarray(bin_edges, np.float64)
    if edges.ndim != 2 or edges.shape[1] != spec.max_bins - 1:
        raise ValueError(f"bin_edges shape {edges.shape} != (n_cols, {spec.max_bins - 1})")
    T, N, S = spec.num_trees, spec.max_nodes, spec.n_stats
    feature = np.full((T, N), LEAF, np.int32)
    feature[:, 0] = OPEN
    return {
        "bin_edges": edges,
        "feature": feature,
        "threshold": np.zeros((T, N), np.int32),
        "value": np.zeros((T, N, S), np.float64),
        "depth": np.zeros((1,), np.int64),
    }


def validate_forest_arrays(arrays: Dict[str, np.ndarray], spec: ForestSpec,
                           n_cols: int) -> Dict[str, np.ndarray]:
    """Full shape validation of an iterate (the reference's contract)."""
    T, N, S = spec.num_trees, spec.max_nodes, spec.n_stats
    want = {
        "bin_edges": (n_cols, spec.max_bins - 1),
        "feature": (T, N),
        "threshold": (T, N),
        "value": (T, N, S),
        "depth": (1,),
    }
    out = {}
    for name, shape in want.items():
        a = arrays.get(name)
        if a is None:
            raise ValueError(f"forest iterate missing array {name!r}")
        a = np.asarray(a)
        if tuple(a.shape) != shape:
            raise ValueError(f"forest iterate array {name!r} shape {tuple(a.shape)} != {shape}")
        out[name] = a
    depth = int(out["depth"][0])
    if not 0 <= depth <= spec.max_depth + 1:
        raise ValueError(f"forest iterate depth {depth} out of range [0, {spec.max_depth + 1}]")
    out["bin_edges"] = np.asarray(out["bin_edges"], np.float64)
    out["feature"] = np.asarray(out["feature"], np.int32)
    out["threshold"] = np.asarray(out["threshold"], np.int32)
    out["value"] = np.asarray(out["value"], np.float64)
    out["depth"] = np.asarray(out["depth"], np.int64)
    return out


def open_frontier_nodes(feature: np.ndarray, depth: int) -> int:
    """How many nodes await a split at ``depth`` (0 ends the fit)."""
    W = 1 << depth
    base = W - 1
    if base >= feature.shape[1]:
        return 0
    return int(np.sum(feature[:, base: base + W] == OPEN))


def row_identity_keys(partition: Optional[int], offset: int, n: int) -> np.ndarray:
    """uint32 bootstrap-bag identity keys of ``n`` rows from the
    partition-relative ``offset``: a pure function of (partition, offset),
    never of batch boundaries."""
    pid = 0 if partition is None else int(partition)
    base = np.uint32((pid * 2654435761 + int(offset)) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        return (base + np.arange(n, dtype=np.uint32)).astype(np.uint32)


def accumulate_histogram(hist: torch.Tensor, tables: Dict[str, np.ndarray], bins: torch.Tensor,
                         y: torch.Tensor, mask, row_key: torch.Tensor,
                         spec: ForestSpec) -> torch.Tensor:
    """Fold one batch of binned rows (``bin_matrix`` of the rows in the
    accumulation dtype against the tables' edges) into the frontier
    histogram, on ``hist``'s device; the host node tables upload per call
    (tiny beside the rows)."""
    depth = int(tables["depth"][0])
    dev = hist.device
    with trace_span("forest histogram"):
        return hist_ops.hist_update(
            hist, bins,
            torch.as_tensor(tables["feature"], device=dev),
            torch.as_tensor(tables["threshold"], device=dev),
            y, mask, row_key, depth, spec.n_classes, spec.bootstrap, spec.seed,
        )


def grow_level(tables: Dict[str, np.ndarray], hist: torch.Tensor,
               spec: ForestSpec) -> Dict[str, int]:
    """Apply one level's split decisions from the pass histogram: score
    every candidate on the device, then write the host node tables (split
    features and thresholds on the frontier, child stats and OPEN/LEAF
    marks one level down). Mutates ``tables`` and advances ``depth``;
    returns ``{"open_nodes", "splits", "depth"}``."""
    depth = int(tables["depth"][0])
    W = 1 << depth
    base = W - 1
    with trace_span("forest split"):
        out = hist_ops.best_splits(hist, depth, spec.n_classes, spec.subset_m, spec.seed,
                                   spec.min_instances)
        score, bf, bb, left, right, tot = (a.cpu().numpy() for a in out)
    score = np.where(np.isfinite(score), score, -np.inf)
    feat, thr, val = tables["feature"], tables["threshold"], tables["value"]
    fl = feat[:, base: base + W]  # basic slices: views, writes stick
    tl = thr[:, base: base + W]
    vl = val[:, base: base + W]
    open_mask = fl == OPEN
    clf = spec.n_classes > 0
    n_l = left.sum(-1) if clf else left[..., 0]
    n_r = right.sum(-1) if clf else right[..., 0]
    vl[open_mask] = tot[open_mask]
    can = (
        open_mask
        & (depth < spec.max_depth)
        & (score > 1e-12)
        & (n_l >= spec.min_instances)
        & (n_r >= spec.min_instances)
    )
    fl[open_mask & ~can] = LEAF
    fl[can] = bf[can]
    tl[can] = bb[can]
    opened = 0
    if depth < spec.max_depth and can.any():
        base2 = 2 * W - 1
        for side, stats, n_side in ((0, left, n_l), (1, right, n_r)):
            cf = feat[:, base2 + side: base2 + 2 * W: 2]
            cv = val[:, base2 + side: base2 + 2 * W: 2]
            cv[can] = stats[can]
            if clf:
                pure = (n_side - stats.max(-1)) <= 1e-9
            else:
                resid = stats[..., 2] - (stats[..., 1] ** 2 / np.maximum(n_side, 1))
                pure = resid <= 1e-12 * np.maximum(1.0, stats[..., 2])
            grow = (
                can
                & (depth + 1 < spec.max_depth)
                & (n_side >= 2 * spec.min_instances)
                & ~pure
            )
            cf[can] = np.where(grow, OPEN, LEAF)[can]
            opened += int(grow.sum())
    tables["depth"] = np.asarray([depth + 1], np.int64)
    return {"open_nodes": opened, "splits": int(can.sum()), "depth": depth + 1}


# ---------------------------------------------------------------------------
# In-memory fit
# ---------------------------------------------------------------------------


class ForestSolution(NamedTuple):
    arrays: Dict[str, np.ndarray]
    n_classes: int
    n_rows: int
    n_passes: int


def _host_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float64).numpy()
    return np.asarray(a, np.float64)


def _fit_forest(x, y, n_classes: int, num_trees: int, max_depth: int, max_bins: int,
                feature_subset: str, seed: int, bootstrap: bool, min_instances: int,
                device=None) -> ForestSolution:
    require_single_process("fit_random_forest (quantile binning samples local data)")
    dev = resolve_device(device)
    y = _host_f64(y).reshape(-1)
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(f"features must be (n, d) with n > 0, got {tuple(x.shape)}")
    if y.shape[0] != x.shape[0]:
        raise ValueError(f"labels length {y.shape[0]} != rows {x.shape[0]}")
    n, d = x.shape
    spec = forest_spec_from_params(
        {
            "num_trees": num_trees, "max_depth": max_depth, "max_bins": max_bins,
            "n_classes": n_classes, "seed": seed, "bootstrap": bootstrap,
            "min_instances": min_instances, "subset": feature_subset,
        },
        n_cols=d,
    )
    if spec.n_classes > 0 and (
        np.any(y < 0) or np.any(y >= spec.n_classes) or np.any(y != np.floor(y))
    ):
        raise ValueError(f"classifier labels must be integers in [0, {spec.n_classes})")
    accum = config.accum_dtype()
    with trace_span("forest binning"):
        cap = int(config.get("forest_seed_sample_rows"))
        edges = hist_ops.quantile_bin_edges(_host_f64(x[:cap]), spec.max_bins)
        # The rows upload once and bin in the accumulation dtype, as the
        # reference bins each pass; the bin ids stay resident (uint8).
        edges_dev = torch.as_tensor(edges).to(device=dev, dtype=accum)
        bins = hist_ops.bin_matrix(to_device(x, dev).to(accum), edges_dev).to(torch.uint8)
    tables = init_forest_arrays(spec, edges)
    # Bag identity: the whole matrix is partition 0, offset = row index.
    keys = torch.from_numpy(row_identity_keys(None, 0, n).astype(np.int64)).to(dev)
    yd = torch.from_numpy(y).to(dev)
    n_passes = 0
    with trace_span("forest grow"):
        for depth in range(spec.max_depth + 1):
            if open_frontier_nodes(tables["feature"], depth) == 0:
                break
            require_hist_capacity(spec, depth, d)
            hist = hist_ops.zero_hist(spec.num_trees, depth, d, spec.max_bins, spec.n_stats,
                                      accum, dev)
            hist = accumulate_histogram(hist, tables, bins, yd, None, keys, spec)
            grow_level(tables, hist, spec)
            n_passes += 1
    arrays = dict(tables)
    arrays.pop("depth")
    arrays["n_classes"] = np.asarray([spec.n_classes], np.int64)
    return ForestSolution(arrays=arrays, n_classes=spec.n_classes, n_rows=n, n_passes=n_passes)


def fit_random_forest_classifier(x, y, n_classes: Optional[int] = None, num_trees: int = 20,
                                 max_depth: int = 5, max_bins: int = 32,
                                 feature_subset: str = "auto", seed: int = 0,
                                 bootstrap: bool = True, min_instances: int = 1,
                                 device=None) -> ForestSolution:
    """Gini-split random forest on binned features (Spark ML
    RandomForestClassifier semantics). ``n_classes=None`` infers
    ``max(y) + 1`` (>= 2). ``device``: None → the card."""
    with trace_span("forest fit"):
        y = _host_f64(y).reshape(-1)
        if n_classes is None:
            n_classes = max(int(np.max(y)) + 1 if y.size else 2, 2)
        return _fit_forest(x, y, int(n_classes), num_trees, max_depth, max_bins,
                           feature_subset, seed, bootstrap, min_instances, device)


def fit_random_forest_regressor(x, y, num_trees: int = 20, max_depth: int = 5,
                                max_bins: int = 32, feature_subset: str = "auto", seed: int = 0,
                                bootstrap: bool = True, min_instances: int = 1,
                                device=None) -> ForestSolution:
    """Variance-split random forest on binned features (Spark ML
    RandomForestRegressor semantics). ``device``: None → the card."""
    with trace_span("forest fit"):
        return _fit_forest(x, y, 0, num_trees, max_depth, max_bins, feature_subset, seed,
                           bootstrap, min_instances, device)


# ---------------------------------------------------------------------------
# Prediction: bin, descend every tree by gathers, aggregate
# ---------------------------------------------------------------------------


def _forest_predictor(arrays: Dict[str, np.ndarray], n_classes: int, device):
    """Row scorer with the tables resident on ``device``, in the
    accumulation dtype (fit-time binning precision): returns ``(pred (n,),
    proba (n, C) or pred (n, 1))``."""
    accum = config.accum_dtype()
    edges = torch.as_tensor(np.asarray(arrays["bin_edges"], np.float64)).to(device, accum)
    feature = torch.as_tensor(np.asarray(arrays["feature"], np.int32)).to(device)
    threshold = torch.as_tensor(np.asarray(arrays["threshold"], np.int32)).to(device)
    value = torch.as_tensor(np.asarray(arrays["value"], np.float64)).to(device, accum)
    n_nodes = int(feature.shape[1])
    depth = max(int(math.ceil(math.log2(n_nodes + 1))) - 1, 1)
    S = value.shape[2]

    def predict(x: torch.Tensor):
        bins = hist_ops.bin_matrix(x.to(device, accum), edges)
        idx, _ = hist_ops.descend_to_frontier(bins, feature, threshold, depth)
        leaves = value.gather(1, idx[:, :, None].expand(-1, -1, S))  # (T, n, S)
        if n_classes > 0:
            counts = leaves.sum(-1, keepdim=True)
            proba = (leaves / counts.clamp_min(1.0)).mean(0)
            return proba.argmax(1).to(accum), proba
        means = leaves[..., 1] / leaves[..., 0].clamp_min(1.0)
        pred = means.mean(0)
        return pred, pred[:, None]

    return predict


class _ForestModelBase(Model, MLWritable, MLReadable):
    """The fitted-forest surface shared by both roles: dense tables and a
    device-resident descent. ``device``: where predict runs; None → the
    card."""

    def __init__(self, arrays: Optional[Dict[str, np.ndarray]] = None, uid=None, device=None):
        super().__init__(uid=uid)
        self.arrays = None if arrays is None else {k: np.asarray(v) for k, v in arrays.items()}
        self._device = device
        self._predict_cache: dict = {}

    @property
    def numClasses(self) -> int:
        if self.arrays is None:
            return 0
        return int(np.asarray(self.arrays.get("n_classes", [0]))[0])

    @property
    def totalNumNodes(self) -> int:
        """Materialized nodes over all trees (internal and leaves): the
        roots plus both children of every node that split, by a level-order
        sweep of the dense heap."""
        f = np.asarray(self.arrays["feature"])
        T, N = f.shape
        alive = np.zeros((T, N), bool)
        alive[:, 0] = True
        base, width = 0, 1
        while 2 * base + 2 < N:
            level = slice(base, base + width)
            split = alive[:, level] & (f[:, level] >= 0)
            base2 = 2 * base + 1
            alive[:, base2: base2 + 2 * width: 2] = split
            alive[:, base2 + 1: base2 + 2 * width: 2] = split
            base, width = base2, 2 * width
        return int(alive.sum())

    def getNumTrees(self) -> int:
        return int(np.asarray(self.arrays["feature"]).shape[0])

    def _model_data(self):
        return dict(self.arrays)

    @classmethod
    def _from_model_data(cls, uid, data):
        return cls(arrays=dict(data), uid=uid)

    def _copy_extra_state(self, source):
        self.arrays = source.arrays
        self._device = getattr(source, "_device", None)
        self._predict_cache = {}

    def _predictor(self):
        if self.arrays is None:
            raise RuntimeError("forest model has no trees (unfitted?)")
        key = predictor_key(self._device)
        if key not in self._predict_cache:
            self._predict_cache[key] = _forest_predictor(self.arrays, self.numClasses,
                                                         resolve_device(self._device))
        return self._predict_cache[key]

    def _serve_aot_plan(self, n_rows, n_cols, dtype="float32", k=None):
        """AOT-at-registration plan (``serve/aot.py``): the binning and the
        descent of every tree over one served bucket of ``n_rows``
        wire-dtype rows, float64 predictions out as :meth:`transform_matrix`
        answers; the node tables stay resident on the device for the
        program's life (the predictor holds them). A wrong width raises."""
        if self.arrays is None:
            return None
        from spark_rapids_ml_tpu_torch.serve import aot

        predict = self._predictor()
        return aot.transform_plan(self, n_rows, n_cols, dtype,
                                  np.asarray(self.arrays["bin_edges"]).shape[0],
                                  lambda x: predict(x)[0],
                                  lambda outs, n: {"prediction": np.asarray(outs[0], np.float64)})

    def _run(self, x, which: int):
        """Output ``which`` of the predictor: a tensor in gives a tensor on
        the model's device out; a host array in gives a numpy array out."""
        out = self._predictor()(as_tensor(x))[which]
        return out if isinstance(x, torch.Tensor) else out.cpu().numpy()

    def predict(self, x):
        return self._run(x, 0)

    def transform_matrix(self, x) -> dict:
        """Role-keyed transform (the serving surface): float64 predictions."""
        with trace_span("forest transform"):
            pred = self.predict(x)
            if isinstance(pred, torch.Tensor):
                return {"prediction": pred.to(torch.float64)}
            return {"prediction": np.asarray(pred, np.float64)}

    def _transform(self, dataset):
        x = as_matrix(dataset, self.getFeaturesCol())
        return with_column(dataset, self.getPredictionCol(), self.predict(x))


class _RandomForestParams(HasFeaturesCol, HasLabelCol, HasPredictionCol, HasSeed):
    numTrees = ParamDecl(
        "numTrees", "number of trees (>= 1)", TypeConverters.toInt,
        validator=ParamValidators.gt(0),
    )
    maxDepth = ParamDecl(
        "maxDepth", f"maximum tree depth (1..{MAX_MAX_DEPTH})",
        TypeConverters.toInt, validator=ParamValidators.gt(0),
    )
    maxBins = ParamDecl(
        "maxBins", "feature-quantization bins (2..256; uint8 ids)",
        TypeConverters.toInt, validator=ParamValidators.gt(1),
    )
    featureSubsetStrategy = ParamDecl(
        "featureSubsetStrategy",
        "per-node candidate features: auto|all|sqrt|onethird|log2|<n>",
        TypeConverters.toString,
    )
    bootstrap = ParamDecl(
        "bootstrap", "Poisson(1) bootstrap bags per tree", TypeConverters.toBoolean,
    )
    minInstancesPerNode = ParamDecl(
        "minInstancesPerNode", "minimum rows each split side must keep",
        TypeConverters.toInt, validator=ParamValidators.gt(0),
    )

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(
            numTrees=20, maxDepth=5, maxBins=32, featureSubsetStrategy="auto",
            bootstrap=True, minInstancesPerNode=1, seed=0, featuresCol="features",
            labelCol="label", predictionCol="prediction",
        )

    def getNumTrees(self) -> int:
        return self.getOrDefault(self.numTrees)

    def getMaxDepth(self) -> int:
        return self.getOrDefault(self.maxDepth)

    def getMaxBins(self) -> int:
        return self.getOrDefault(self.maxBins)

    def getFeatureSubsetStrategy(self) -> str:
        return self.getOrDefault(self.featureSubsetStrategy)

    def getBootstrap(self) -> bool:
        return self.getOrDefault(self.bootstrap)

    def getMinInstancesPerNode(self) -> int:
        return self.getOrDefault(self.minInstancesPerNode)

    def setNumTrees(self, value: int):
        return self._set(numTrees=value)

    def setMaxDepth(self, value: int):
        return self._set(maxDepth=value)

    def setMaxBins(self, value: int):
        return self._set(maxBins=value)

    def setFeatureSubsetStrategy(self, value: str):
        return self._set(featureSubsetStrategy=value)

    def setBootstrap(self, value: bool):
        return self._set(bootstrap=value)

    def setMinInstancesPerNode(self, value: int):
        return self._set(minInstancesPerNode=value)



class _ForestEstimatorBase(Estimator, _RandomForestParams, MLWritable, MLReadable):
    """``device``: where the fit runs; None → the card."""

    def __init__(self, uid=None, device=None):
        super().__init__(uid=uid)
        self._device = device

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)

    def _fit(self, dataset):
        x = as_matrix(dataset, self.getFeaturesCol())
        y = as_column(dataset, self.getLabelCol())
        sol = self._fit_fn(
            x, y, num_trees=self.getNumTrees(), max_depth=self.getMaxDepth(),
            max_bins=self.getMaxBins(), feature_subset=self.getFeatureSubsetStrategy(),
            seed=self.getSeed(), bootstrap=self.getBootstrap(),
            min_instances=self.getMinInstancesPerNode(), device=self._device,
        )
        model = self._model_cls(arrays=sol.arrays, device=self._device)
        model.uid = self.uid
        self._copy_params_to(model)
        return model


class RandomForestClassificationModel(_ForestModelBase, _RandomForestParams):
    _uid_prefix = "RandomForestClassificationModel"
    _persist_class = "spark_rapids_ml_tpu.models.random_forest.RandomForestClassificationModel"
    # The daemon serving contract (serve/daemon.py's rf_classifier).
    _serve_algo = "rf_classifier"
    _serve_outputs = (("prediction", "predictionCol", "double"),)

    def predict_proba(self, x):
        """(n, numClasses) mean of the trees' leaf class distributions."""
        return self._run(x, 1)


class RandomForestRegressionModel(_ForestModelBase, _RandomForestParams):
    _uid_prefix = "RandomForestRegressionModel"
    _persist_class = "spark_rapids_ml_tpu.models.random_forest.RandomForestRegressionModel"
    _serve_algo = "rf_regressor"
    _serve_outputs = (("prediction", "predictionCol", "double"),)


class RandomForestClassifier(_ForestEstimatorBase):
    """``RandomForestClassifier().setNumTrees(50).fit(df)``: Spark ML's
    classification API over the histogram-tree core."""

    _uid_prefix = "RandomForestClassifier"
    _persist_class = "spark_rapids_ml_tpu.models.random_forest.RandomForestClassifier"
    _model_cls = RandomForestClassificationModel
    _fit_fn = staticmethod(fit_random_forest_classifier)


class RandomForestRegressor(_ForestEstimatorBase):
    """``RandomForestRegressor().setNumTrees(50).fit(df)``: Spark ML's
    regression API over the histogram-tree core."""

    _uid_prefix = "RandomForestRegressor"
    _persist_class = "spark_rapids_ml_tpu.models.random_forest.RandomForestRegressor"
    _model_cls = RandomForestRegressionModel
    _fit_fn = staticmethod(fit_random_forest_regressor)
