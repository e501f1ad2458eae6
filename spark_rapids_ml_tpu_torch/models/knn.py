"""Nearest neighbours in PyTorch on a CUDA device: exact brute force and
IVF-Flat (approximate).

The port of ``spark_rapids_ml_tpu/models/knn.py`` (BASELINE.json config #5,
"Approx-KNN IVF-Flat on 10M×768 SBERT embeddings"), for one device:

* **Exact** (``NearestNeighbors``): the index is the database in the
  compute dtype on the device. A kneighbors call is ONE launch of the
  hand-written ``dist_topk`` kernel (``ops/kernels.py``) for the l2 metrics
  with float32 accumulators and k ≤ 64; otherwise (inner product, larger k,
  the float64 parity mode) a product per db chunk and a stable top-k merge,
  as the JAX package's XLA two-step computes it.
* **IVF-Flat** (``ApproximateNearestNeighbors``): :func:`build_ivf_flat`
  trains the coarse quantizer with the port's ``fit_kmeans`` (random init,
  10 iterations), assigns every row with ``assign_min_dist``, bounds the
  list sizes with the capacity balancer fed by ``dist_topk`` candidates,
  and buckets the rows into padded host lists; :func:`build_ivf_flat_device`
  does the same with the rows and the index resident on the device (the
  daemon's build under its device cap). A query probes with
  ``probe_select`` and scans with ``ivf_scan_select`` — the JAX package's
  fused flow — then gathers each query's candidates back, selects exactly
  and reranks from the stored f32 rows. With float64 accumulators the JAX
  package's XLA flow runs instead, in plain PyTorch with exact selections:
  the port's float64 parity mode, which runs no kernel.

Cross-list selections are exact here on both devices (the JAX package's
``approx_min_k`` on a TPU is approximate; on the CPU it is exact, which is
what the tests hold the port to). Ties go to the lowest position.

Output convention follows spark-rapids-ml's NearestNeighbors:
``kneighbors(queries) -> (distances, indices)`` as numpy arrays.

Exact kneighbors runs across ranks (``mesh=``, a started
``torch.distributed`` world): each data index indexes its own rows, whose
global ids start after the lower data indices' rows; every rank passes the
same queries, runs its ``dist_topk`` and the pools meet in
``parallel/mapreduce.reduce_topk``.

The IVF index shards its inverted lists over the data axis
(``ApproximateNearestNeighborsModel.shard_index``, the capacity path of
config #5): each rank keeps a contiguous range of lists, probes the
replicated centroids with ``probe_select``, scans its own lists with
``ivf_scan_select``, and the per-rank top-k meet in ``reduce_topk``
(:func:`ivf_query_sharded`).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise rather than run on the CPU. Not in the
port: the serving plans (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core.dataset import as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasFeaturesCol,
    HasSeed,
    Model,
    ParamDecl,
    ParamValidators,
    TypeConverters,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.models.kmeans import _host_rows, fit_kmeans
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops import selection as sel
from spark_rapids_ml_tpu_torch.ops.distances import dist_topk_applicable, sq_euclidean
from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
from spark_rapids_ml_tpu_torch.parallel.distributed import row_counts
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, default_mesh
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    as_tensor,
    bucket_rows,
    resolve_device,
    to_device,
)
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

# APPEND-ONLY: ANN model payloads persist the fit metric as an ordinal into
# this tuple (_model_data "fit_metric"), an on-disk contract shared with the
# JAX package.
KNN_METRICS = ("euclidean", "sqeuclidean", "cosine", "inner_product")


def merge_topk(dists, ids, k: int, descending: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side top-k merge of per-shard kneighbors results (shards served
    by different processes). Exact as long as each shard returns its local
    top-min(k, shard rows). ``dists``/``ids``: sequences of (q, k_i)
    arrays; ``descending`` for similarity metrics (inner_product). Invalid
    entries (id −1, distance ±inf) sort last; ties break toward the smaller
    row id. Distances come back in the shards' common dtype."""
    out_dtype = np.result_type(*[np.asarray(d).dtype for d in dists])
    D = np.concatenate([np.asarray(d, np.float64) for d in dists], axis=1)
    I = np.concatenate([np.asarray(i, np.int64) for i in ids], axis=1)  # noqa: E741
    if D.shape[1] < k:
        raise ValueError(
            f"merged candidate pool {D.shape[1]} < k = {k}; every shard "
            "must return min(k, its rows) candidates"
        )
    key = -D if descending else D
    order = np.lexsort((I, key), axis=-1)[:, :k]
    return (
        np.take_along_axis(D, order, axis=1).astype(out_dtype, copy=False),
        np.take_along_axis(I, order, axis=1),
    )


def _normalized_rows(x, zero_slot: int = 0, eps: float = 1e-12):
    """Cosine-metric preprocessing: unit rows + TWO augmentation columns.

    A zero row becomes a unit vector in augmentation column ``zero_slot``
    (0 for database/index rows, 1 for queries): orthogonal to every real
    vector and to the other side's zero vectors, so its cosine distance is
    exactly 1 (sklearn's normalize-then-dot semantics). A numpy array in
    gives a numpy array out, a tensor a tensor on its device."""
    t = as_tensor(x)
    t = t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)
    nrm = torch.linalg.vector_norm(t, dim=1, keepdim=True)
    out = torch.cat(
        [t / torch.clamp(nrm, min=eps), torch.zeros((t.shape[0], 2), dtype=t.dtype, device=t.device)],
        dim=1,
    )
    out[nrm[:, 0] <= eps, t.shape[1] + zero_slot] = 1.0
    return out if isinstance(x, torch.Tensor) else out.numpy()


def _pad_queries(queries: torch.Tensor) -> torch.Tensor:
    """Zero rows up to ``bucket_rows(q, 64)``, as kneighbors pads in the
    JAX package: in the bucketed IVF executor the padded count sets the
    capacity C and the eviction rotation."""
    q = queries.shape[0]
    pad = bucket_rows(q, 64) - q
    if pad == 0:
        return queries
    return torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])


def _finish(metric: str, d2: np.ndarray, ids: np.ndarray):
    """The metric post-processing of the JAX kneighbors."""
    if metric == "inner_product":
        # d2 holds NEGATED products; the +inf of never-found slots decodes
        # to −inf similarity.
        return -d2, ids
    if metric == "sqeuclidean":
        return np.maximum(d2, 0), ids
    if metric == "cosine":
        # Unit rows: ‖q − x‖² = 2 − 2cos, so 1 − cos is half of it.
        return np.clip(d2 / 2.0, 0, None), ids
    return np.sqrt(np.maximum(d2, 0)), ids


# ---------------------------------------------------------------------------
# Exact brute force
# ---------------------------------------------------------------------------


def exact_knn(db: torch.Tensor, row_ids: torch.Tensor, mask: torch.Tensor,
              queries: torch.Tensor, k: int, metric: str, ad, r2=None):
    """The one-device body of the JAX ``_exact_knn_fn``: (d2 (q, k) in
    ``ad`` ascending, ids (q, k) int32). ``db`` and ``queries`` are in the
    compute dtype on one device. metric "l2" (squared distances) or "ip"
    (negated inner products). ``r2``: the index's masked row norms
    (``kernels.dist_topk_norms``), or None to compute them here."""
    m = db.shape[0]
    kl = min(k, m)
    if metric == "l2" and dist_topk_applicable(kl, m, ad):
        d2, ids = kernels.dist_topk(queries, db, row_ids, mask, kl, r2)
        return d2.to(ad), ids
    q = queries.shape[0]
    best_d = torch.full((q, 0), float("inf"), dtype=ad, device=db.device)
    best_i = torch.full((q, 0), -1, dtype=torch.int32, device=db.device)
    step = max(kl, kernels.PLAIN_SCORE_ELEMS // max(q, 1))
    for r0 in range(0, m, step):
        chunk = db[r0:r0 + step]
        if metric == "ip":
            d2 = -(queries.to(ad) @ chunk.to(ad).T)  # negated: the min machinery applies
        else:
            d2 = sq_euclidean(queries, chunk, accum_dtype=ad)
        d2 = torch.where(mask[None, r0:r0 + step] > 0, d2, torch.full_like(d2, float("inf")))
        cat_i = torch.cat([best_i, row_ids[None, r0:r0 + step].expand(q, -1)], 1)
        # Earlier rows sit first, so a stable selection ties to the lowest row.
        best_d, pos = sel.stable_topk(torch.cat([best_d, d2], 1), kl)
        best_i = cat_i.gather(1, pos)
    return best_d, best_i


class _NNParams(HasFeaturesCol, HasSeed):
    k = ParamDecl(
        "k",
        "number of neighbors to return (> 0)",
        TypeConverters.toInt,
        validator=ParamValidators.gt(0),
    )
    metric = ParamDecl(
        "metric",
        "distance metric: euclidean (default), sqeuclidean, cosine, or "
        "inner_product (exact KNN only; returns similarities descending)",
        TypeConverters.toString,
        validator=ParamValidators.inList(KNN_METRICS),
    )

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(k=5, featuresCol="features", seed=0, metric="euclidean")

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getMetric(self) -> str:
        return self.getOrDefault(self.metric)


class NearestNeighbors(Estimator, _NNParams, MLWritable, MLReadable):
    """Exact brute-force KNN; ``fit`` indexes the database.

    ``device``: where queries run; None → the card. ``mesh``: the ranks
    the index spans (None → ``default_mesh()``; see
    :meth:`NearestNeighborsModel.kneighbors`)."""

    _uid_prefix = "NearestNeighbors"
    _persist_class = "spark_rapids_ml_tpu.models.knn.NearestNeighbors"

    def __init__(self, uid=None, device=None, mesh=None):
        super().__init__(uid=uid)
        self._device = device
        self._mesh = mesh

    def setK(self, value: int) -> "NearestNeighbors":
        return self._set(k=value)

    def setMetric(self, value: str) -> "NearestNeighbors":
        return self._set(metric=value)

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)
        self._mesh = getattr(source, "_mesh", None)

    def _fit(self, dataset) -> "NearestNeighborsModel":
        x = as_matrix(dataset, self.getFeaturesCol())
        model = NearestNeighborsModel(database=x, device=self._device, mesh=self._mesh)
        model.uid = self.uid
        self._copy_params_to(model)
        return model


class NearestNeighborsModel(Model, _NNParams, MLWritable, MLReadable):
    """The indexed database: a host array, or a tensor (kept where it lies).
    Across ranks, THIS rank's rows.

    ``device``: where queries run; None → the mesh's rank device, else the
    card."""

    _uid_prefix = "NearestNeighborsModel"
    _persist_class = "spark_rapids_ml_tpu.models.knn.NearestNeighborsModel"

    def __init__(self, database=None, uid=None, device=None, mesh=None):
        super().__init__(uid=uid)
        if database is not None and not isinstance(database, torch.Tensor):
            database = np.asarray(database)
        self.database = database
        self._device = device
        self._mesh = mesh
        self._index_cache: dict = {}
        # Bumped whenever the resident index is dropped or replaced: a held
        # serving program (serve/aot.py) captured over an older index is
        # stale and is never run again.
        self._index_epoch = 0
        self._n_global: Optional[int] = None

    def _model_data(self):
        return {"database": _host_rows(self.database)}

    @classmethod
    def _from_model_data(cls, uid, data):
        return cls(database=data["database"], uid=uid)

    def _copy_extra_state(self, source):
        self.database = source.database
        self._device = getattr(source, "_device", None)
        self._mesh = getattr(source, "_mesh", None)
        self._index_cache = {}
        self._index_epoch = 0

    def _ensure_index(self, dev, cd, mesh=None):
        """(db, row ids, mask, r2) on ``dev``, the db in the compute dtype
        and r2 its masked f32 row norms (``kernels.dist_topk_norms``), so an
        exact query does not recompute them; ``_n_global`` is then the
        index's global row count. Across ranks (a ``mesh`` of a started
        world) the ids of this rank's rows start after the lower ranks'
        rows, their counts gathered once. Only the cosine metric changes
        the indexed data (the normalized, augmented copy), so the other
        three share one copy; the cache is keyed by that representation,
        the device, the dtype, the world and the mesh's shape."""
        key = self._index_key(dev, cd, mesh)
        if key not in self._index_cache:
            self._index_cache.clear()  # one resident copy at a time
            self._index_epoch += 1
            db = self.database
            if key[0] == "cosine":
                db = _normalized_rows(db, zero_slot=0)
            n = db.shape[0]
            lo, n_global = 0, n
            if mesh is not None and mesh.collective:
                counts = row_counts(n, mesh)
                lo, n_global = int(counts[: mesh.coords[0]].sum()), int(counts.sum())
            rows = to_device(db, dev, cd).contiguous()
            mask = torch.ones((n,), dtype=torch.float32, device=dev)
            ids = torch.arange(lo, lo + n, dtype=torch.int32, device=dev)
            self._index_cache[key] = (rows, ids, mask, kernels.dist_topk_norms(rows, mask))
            self._n_global = n_global
        return self._index_cache[key]

    def _index_key(self, dev, cd, mesh=None):
        """The resident index's cache key: its representation, device,
        dtype, world and mesh shape."""
        rep = "cosine" if self.getMetric() == "cosine" else "raw"
        world = None if mesh is None else (mesh.world, tuple(mesh.shape.values()))
        return rep, str(dev), cd, world

    def _query_setup(self, k: Optional[int]):
        """(k, mesh, device, metric, compute dtype, accumulator dtype, index
        entry) of a query, the index made resident; raises on a k out of
        range."""
        if self.database is None:
            raise RuntimeError("model has no database (unfitted?)")
        k = self.getK() if k is None else int(k)
        mesh = self._mesh or default_mesh()
        dev = resolve_device(self._device, mesh)
        cd, ad = config.compute_dtype(dev), config.accum_dtype()
        entry = self._ensure_index(dev, cd, mesh)
        n = self._n_global
        if not 0 < k <= n:
            raise ValueError(f"k = {k} out of range (0, numRows = {n}]")
        return k, mesh, dev, self.getMetric(), cd, ad, entry

    @staticmethod
    def _query_body(entry, qp: torch.Tensor, k: int, metric: str, ad):
        """The device body of a query: (d2, ids) of the padded queries ``qp``
        (compute dtype, on the index's device) against this rank's rows, an
        empty pool for a rank without rows."""
        db, row_ids, mask, r2 = entry
        if db.shape[0]:
            return exact_knn(db, row_ids, mask, qp, k,
                             "ip" if metric == "inner_product" else "l2", ad, r2)
        return (torch.empty((qp.shape[0], 0), dtype=ad, device=db.device),
                torch.empty((qp.shape[0], 0), dtype=torch.int32, device=db.device))

    @staticmethod
    def _serve_dispatch_rows(n: int) -> int:
        """The query rows a kneighbors of ``n`` rows dispatches
        (``_pad_queries``)."""
        return bucket_rows(n, 64)

    def _serve_aot_plan(self, n_rows, n_cols, dtype="float32", k=None):
        """AOT-at-registration plan (``serve/aot.py``): the exact query of one
        served bucket over the resident index, ``dist_topk`` on the card.
        The program's rows are what kneighbors pads the bucket to
        (:meth:`_serve_dispatch_rows`, the JAX plan's ``bucket_rows(n, 64)``),
        not the raw bucket; ``k`` defaults to the fitted k. Making the index
        resident here front-loads its upload into the registration, as the
        JAX plan does. The program holds no reference to the index it was
        captured over: a dropped or replaced index (another representation,
        dtype or device) bumps ``_index_epoch``, which makes it stale. A
        query across ranks merges over a collective, which a graph cannot
        hold: no plan then. A wrong width raises."""
        if self.database is None:
            return None
        from spark_rapids_ml_tpu_torch.serve import aot

        aot.check_width(n_cols, self.database.shape[1])
        k, mesh, dev, metric, cd, ad, _ = self._query_setup(k)
        if mesh.collective:
            return None
        key, epoch = self._index_key(dev, cd, mesh), self._index_epoch

        def valid() -> bool:
            d = resolve_device(self._device, mesh)
            now = config.compute_dtype(d)
            return (self._index_epoch == epoch and config.accum_dtype() == ad
                    and self._index_key(d, now, mesh) == key and key in self._index_cache)

        def body(x: torch.Tensor):
            return self._query_body(self._index_cache[key], _pad_queries(x.to(cd)).contiguous(),
                                    k, metric, ad)

        def finish(outs, q: int):
            return _finish(metric, outs[0][:q], outs[1][:q].astype(np.int64))

        prep = (lambda x: _normalized_rows(x, zero_slot=1)) if metric == "cosine" else None
        return [aot.Plan(self._serve_dispatch_rows(int(n_rows)), int(n_cols), np.dtype(dtype),
                         dev, body=body, finish=finish, valid=valid, prep=prep)]

    def kneighbors(self, queries, k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(distances (q, k), indices (q, k) int64) under ``metric``:
        euclidean (default) / sqeuclidean / cosine ascending, or
        inner_product DESCENDING (the "distances" are the similarities).

        Across ranks every rank passes the SAME queries and gets the same
        answer; the indices are global row positions (the ranks' rows in
        rank order), and k may reach the global row count."""
        k, mesh, dev, metric, cd, ad, entry = self._query_setup(k)
        if metric == "cosine":
            queries = _normalized_rows(queries, zero_slot=1)
        qt = to_device(queries, dev, cd)
        q = qt.shape[0]
        with trace_span("knn query"):
            d2, idx = self._query_body(entry, _pad_queries(qt).contiguous(), k, metric, ad)
            if mesh.collective:
                d2, idx = mr.reduce_topk(d2, idx, k, DATA_AXIS, mesh=mesh)
            d2, idx = d2[:q].cpu().numpy(), idx[:q].cpu().numpy().astype(np.int64)
        return _finish(metric, d2, idx)

    def _transform(self, dataset):
        x = as_matrix(dataset, self.getFeaturesCol())
        dists, idx = self.kneighbors(x)
        out = with_column(dataset, "knn_distances", dists)
        return with_column(out, "knn_indices", idx)


# ---------------------------------------------------------------------------
# IVF-Flat: the build
# ---------------------------------------------------------------------------


class IVFFlatIndex(NamedTuple):
    """The fields are host numpy (:func:`build_ivf_flat`, a loaded model)
    or tensors on one device (:func:`build_ivf_flat_device`); every reader
    takes both."""

    centroids: np.ndarray  # (nlist, d)
    lists: np.ndarray  # (nlist, maxlen, d) padded points
    list_ids: np.ndarray  # (nlist, maxlen) original row ids, -1 = pad
    list_mask: np.ndarray  # (nlist, maxlen) 1.0 valid


def _host_array(a) -> np.ndarray:
    """An index field as a host array (a tensor on any device copied)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# Padded-list capacity bound, as a multiple of the mean list size n/nlist:
# rows past a list's cap spill to their next-nearest centroid, so the
# rectangular (nlist, maxlen, d) layout does not pay for the hottest list.
IVF_MAX_LOAD_FACTOR = 2.0
_IVF_SPILL_CANDIDATES = 4
#: Rows per assignment chunk of the build.
IVF_BUILD_STEP = 1 << 18


def _balance_assignments(cand: np.ndarray, nlist: int, cap: int) -> np.ndarray:
    """Greedy capacity-bounded assignment from preference-ordered
    candidates ``cand`` (n, T): round t gives every still-unassigned row
    its t-th nearest list while capacity remains; leftovers after T rounds
    fill the least-loaded lists (guaranteed to fit: cap·nlist ≥ n)."""
    n, T = cand.shape
    assign = np.full(n, -1, np.int64)
    load = np.zeros(nlist, np.int64)
    pending = np.arange(n)
    for t in range(T):
        want = cand[pending, t].astype(np.int64)
        order = np.argsort(want, kind="stable")
        sw = want[order]
        run_start = np.searchsorted(sw, np.arange(nlist))
        pos_in_run = np.arange(len(sw)) - run_start[sw]
        ok = pos_in_run < np.maximum(cap - load[sw], 0)
        assign[pending[order[ok]]] = sw[ok]
        load += np.bincount(sw[ok], minlength=nlist)
        pending = pending[order[~ok]]
        if pending.size == 0:
            break
    if pending.size:
        spare = np.maximum(cap - load, 0)
        order = np.argsort(-spare, kind="stable")  # least-loaded lists first
        slots = np.repeat(order, spare[order])
        assign[pending] = slots[: pending.size]
    return assign


def _ivf_cap(n: int, nlist: int) -> int:
    """Per-list row capacity: load-factor × mean, floored so cap·nlist ≥ n."""
    return max(int(np.ceil(IVF_MAX_LOAD_FACTOR * n / nlist)), -(-n // nlist))


def _balanced_refine(get_cand, recenter, nlist: int, cap: int, rounds: int = 3):
    """Balanced-Lloyd refinement: alternate capacity-greedy assignment with
    centroid recomputation from the balanced assignment, so spill targets
    become genuinely near rows. ``get_cand()`` → (n, T) preference-ordered
    candidates for the current centroids; ``recenter(assign)`` updates
    them. Returns the final balanced (n,) assignment."""
    for _ in range(rounds):
        assign = _balance_assignments(np.asarray(get_cand()), nlist, cap)
        recenter(assign)
    return _balance_assignments(np.asarray(get_cand()), nlist, cap)


def _ivf_quantizer(x, nlist: int, seed: int, train_rows: int, centroids, train_data,
                   dev) -> Tuple[np.ndarray, bool]:
    """(centroids (nlist, d), frozen) of an IVF build: ``centroids`` as a
    frozen float32 quantizer when given, else the port's ``fit_kmeans``
    (random init, 10 iterations, float64 centres) on at most ``train_rows``
    rows of ``train_data`` or of x, drawn with ``default_rng(seed)`` and
    gathered where the pool lives (a tensor on its device)."""
    d = x.shape[1]
    if centroids is not None:
        centroids = _host_array(centroids).astype(np.float32)
        if centroids.shape != (nlist, d):
            raise ValueError(f"pretrained centroids shape {centroids.shape} != ({nlist}, {d})")
        return centroids, True
    if train_rows < nlist:
        raise ValueError(
            f"train_rows = {train_rows} must be >= nlist = {nlist} "
            f"(the quantizer needs at least one training row per list)"
        )
    pool = x if train_data is None else np.asarray(train_data)
    if train_data is not None:
        if pool.ndim != 2 or pool.shape[1] != d:
            raise ValueError(
                f"train_data shape {pool.shape} does not match the database width {d}"
            )
        if pool.shape[0] < nlist:
            raise ValueError(
                f"train_data has {pool.shape[0]} rows < nlist = {nlist} "
                "(one training row per list minimum)"
            )
    if pool.shape[0] > train_rows:
        pick = np.random.default_rng(seed).choice(
            pool.shape[0], train_rows, replace=False, shuffle=False
        )
        sample = pool[pick] if not isinstance(pool, torch.Tensor) else \
            pool[torch.as_tensor(pick, device=pool.device)]
    else:
        sample = pool
    sol = fit_kmeans(sample, k=nlist, max_iter=10, seed=seed, init="random", device=dev)
    return sol.centers, False


def _ivf_assign(chunks, n: int, nlist: int, cdev: torch.Tensor, frozen: bool):
    """The build's list of every row against the f32 centres ``cdev``:
    (assign (n,) int64, counts (nlist,) int64, cdev), tensors on cdev's
    device. ``chunks()`` yields (start, f32 rows) in ``IVF_BUILD_STEP``
    slices, once a pass: one ``assign_min_dist`` launch per chunk, and,
    when a list outgrows its cap, ``dist_topk`` launches for the (n, T)
    spill candidates, which go to the host balancer (frozen: capacity
    spill only; trained: ``_balanced_refine``, whose recenter returns the
    moved centres)."""
    dev = cdev.device
    T = min(_IVF_SPILL_CANDIDATES, nlist)
    all_lists = torch.arange(nlist, dtype=torch.int32, device=dev)
    all_valid = torch.ones((nlist,), dtype=torch.float32, device=dev)

    def candidates() -> np.ndarray:
        out = np.empty((n, T), dtype=np.int32)
        for i, c in chunks():
            _, ids = kernels.dist_topk(c, cdev, all_lists, all_valid, T)
            out[i:i + c.shape[0]] = ids.cpu().numpy()
        return out

    def recenter(assign_np: np.ndarray) -> None:
        # Sums of the bf16-rounded rows in f32, as the JAX package's one-hot
        # bf16 product accumulates them.
        nonlocal cdev
        sums = torch.zeros((nlist, cdev.shape[1]), dtype=torch.float32, device=dev)
        cnt = torch.zeros((nlist,), dtype=torch.float32, device=dev)
        for i, c in chunks():
            a = torch.as_tensor(assign_np[i:i + c.shape[0]], device=dev)
            sums.index_add_(0, a, c.to(torch.bfloat16).float())
            cnt += torch.bincount(a, minlength=nlist).float()
        cdev = torch.where((cnt > 0)[:, None], sums / torch.clamp(cnt, min=1.0)[:, None], cdev)

    assign = torch.cat([kernels.assign_min_dist(c, cdev)[0] for _, c in chunks()]).long()
    counts = torch.bincount(assign, minlength=nlist)
    cap = _ivf_cap(n, nlist)
    if int(counts.max()) > cap:
        if frozen:  # shared quantizer: capacity-spill only, no recenter
            balanced = _balance_assignments(candidates(), nlist, cap)
        else:
            balanced = _balanced_refine(candidates, recenter, nlist, cap)
        assign = torch.as_tensor(balanced, device=dev)
        counts = torch.bincount(assign, minlength=nlist)
    return assign, counts, cdev


def _bucket_order(assign: torch.Tensor, counts: torch.Tensor, seed: int):
    """(order, list, slot) of the rows sorted by list, tensors on assign's
    device: a stable sort by list of the seeded shuffle
    ``default_rng(seed ^ 0x5EED).permutation(n)`` (uploaded), so each
    list's internal order is the draw's; a row's slot is its rank minus its
    list's start."""
    n = assign.shape[0]
    shuffle = torch.as_tensor(np.random.default_rng(seed ^ 0x5EED).permutation(n),
                              device=assign.device)
    order = shuffle[torch.argsort(assign[shuffle], stable=True)]
    sorted_assign = assign[order]
    starts = torch.cumsum(counts, 0) - counts
    return order, sorted_assign, torch.arange(n, device=assign.device) - starts[sorted_assign]


def build_ivf_flat(
    x,
    nlist: int,
    seed: int = 0,
    train_rows: int = 2_000_000,
    centroids: Optional[np.ndarray] = None,
    train_data: Optional[np.ndarray] = None,
    device=None,
) -> IVFFlatIndex:
    """Train the coarse quantizer and bucket the database into padded lists.

    x: (n, d) host array or tensor. The quantizer is the port's
    ``fit_kmeans`` on at most ``train_rows`` sampled rows (random init, 10
    iterations), unless ``centroids`` gives a pretrained (nlist, d)
    quantizer, which stays FROZEN (capacity balancing may spill rows but
    never recenters). ``train_data`` replaces the local sample as the
    training set. The assignment runs on ``device`` (None → the card) in
    f32 chunks of 262,144 rows, each uploaded again on every pass: one
    ``assign_min_dist`` launch per chunk, and, when a list outgrows its
    cap, ``dist_topk`` launches for the spill candidates. The rows'
    order by list (the JAX package's seeded shuffle, sorted stably) comes
    from the device, and the rows are scattered into host numpy lists; the
    index's fields are host numpy (:func:`build_ivf_flat_device` keeps the
    rows and the index on the device)."""
    dev = resolve_device(device)
    n, d = x.shape
    centroids, frozen = _ivf_quantizer(x, nlist, seed, train_rows, centroids, train_data, dev)
    cdev = torch.as_tensor(centroids, device=dev).float().contiguous()

    def chunks():
        for i in range(0, n, IVF_BUILD_STEP):
            yield i, to_device(x[i:i + IVF_BUILD_STEP], dev, torch.float32).contiguous()

    assign, counts, cdev_out = _ivf_assign(chunks, n, nlist, cdev, frozen)
    if cdev_out is not cdev:  # recentred by the balanced refine
        centroids = cdev_out.cpu().numpy().astype(centroids.dtype)
    maxlen = max(int(counts.max()), 1)
    xh = _host_rows(x)
    lists = np.zeros((nlist, maxlen, d), dtype=xh.dtype)
    list_ids = np.full((nlist, maxlen), -1, dtype=np.int64)
    order, sorted_assign, slots = (t.cpu().numpy() for t in _bucket_order(assign, counts, seed))
    lists[sorted_assign, slots] = xh[order]
    list_ids[sorted_assign, slots] = order
    list_mask = (list_ids >= 0).astype(np.float32)
    return IVFFlatIndex(np.asarray(centroids), lists, list_ids, list_mask)


def build_ivf_flat_device(
    x,
    nlist: int,
    seed: int = 0,
    train_rows: int = 2_000_000,
    centroids=None,
    train_data: Optional[np.ndarray] = None,
    device=None,
) -> IVFFlatIndex:
    """:func:`build_ivf_flat` with the rows and the index resident on
    ``device`` (None → the card): the JAX package's
    ``build_ivf_flat_device``.

    x: an (n, d) tensor, used where it lies when that is ``device``, or
    host rows, uploaded once in their dtype (the daemon's are float32).
    The quantizer trains on a sample gathered on the device (the same
    ``default_rng(seed)`` pick and ``fit_kmeans`` as the host build: 10
    ``lloyd_step`` launches and an ``assign_min_dist`` cost pass); the
    assignment, the spill candidates and the balanced refine's recentres
    run over f32 chunks sliced from the resident rows, with no upload a
    pass; only the (n, T) candidates go to the host balancer and its
    assignment comes back. The bucketing is the host build's seeded
    shuffle and stable sort on the device, one scatter into the lists;
    ``counts.max()`` is the one value read back, to fix ``maxlen``.

    The fields are tensors on the device, in the host build's dtypes (lists
    in the rows' dtype, bfloat16/float16 widened to float32; int64 ids, −1
    for pads; float32 mask; float32 frozen or float64 trained centroids).
    Under one quantizer (``centroids``) the two builds are bitwise equal in
    every field: the same kernels on the same chunks, the same balancer and
    the same permutation."""
    dev = resolve_device(device)
    n, d = x.shape
    xd = to_device(x, dev)
    centroids, frozen = _ivf_quantizer(xd, nlist, seed, train_rows, centroids, train_data, dev)
    cdev = torch.as_tensor(centroids, device=dev).float().contiguous()

    def chunks():
        for i in range(0, n, IVF_BUILD_STEP):
            yield i, xd[i:i + IVF_BUILD_STEP].to(torch.float32).contiguous()

    assign, counts, cdev_out = _ivf_assign(chunks, n, nlist, cdev, frozen)
    # A refine's moved centres come back float64, as the host build's.
    cent_t = torch.as_tensor(centroids, device=dev) if cdev_out is cdev else cdev_out.double()
    maxlen = max(int(counts.max()), 1)
    wide = xd.dtype in (torch.bfloat16, torch.float16)
    lists = torch.zeros((nlist, maxlen, d), dtype=torch.float32 if wide else xd.dtype, device=dev)
    list_ids = torch.full((nlist, maxlen), -1, dtype=torch.int64, device=dev)
    order, sorted_assign, slots = _bucket_order(assign, counts, seed)
    for i in range(0, n, IVF_BUILD_STEP):  # the row gather a chunk at a time
        at = (sorted_assign[i:i + IVF_BUILD_STEP], slots[i:i + IVF_BUILD_STEP])
        lists[at] = xd[order[i:i + IVF_BUILD_STEP]].to(lists.dtype)
        list_ids[at] = order[i:i + IVF_BUILD_STEP]
    list_mask = (list_ids >= 0).float()
    return IVFFlatIndex(cent_t, lists, list_ids, list_mask)


# ---------------------------------------------------------------------------
# IVF-Flat: the query
# ---------------------------------------------------------------------------

#: Lists per step of the dense executor (the JAX package's LIST_BLOCK).
DENSE_LIST_BLOCK = 32
#: Entries of one f32 intermediate of the bucketed executor's list chunks.
IVF_CHUNK_ELEMS = 1 << 28


def _bucketed_capacity(q: int, nprobe: int, nlist: int, slack: float) -> int:
    """Per-list query capacity C: ceil(q·nprobe/nlist·slack), raised to
    ceil(q/nprobe) while that costs ≤ 4× (so nprobe·C ≥ q), at least 8,
    8-rounded and at most q (where nothing can be dropped)."""
    base = int(np.ceil(q * nprobe / nlist * slack))
    floor = int(np.ceil(q / nprobe))
    cap = max(base, floor) if floor <= 4 * base else base
    return min(q, max(8, ((cap + 7) // 8) * 8))


def bucket_pairs(probe: torch.Tensor, n_valid: int, nlist: int, C: int):
    """Capacity bucketing of the (query, probe rank) pairs by list:
    (bucket_q (nlist, C) int64 — the query of each list slot, −1 empty;
    pair_slot (q, nprobe) int64 — each pair's slot in its list, −1 dropped).

    The pairs are taken in a fixed order: rank-major, and within a rank the
    queries rotated by r·C, so correlated batches spread over their lists.
    A pair's slot is the number of earlier pairs of the same list in that
    order; slots ≥ C are dropped. Padding queries (≥ n_valid) and pairs
    with probe < 0 go to the sentinel list ``nlist`` and hold no capacity.
    The JAX package counts the earlier pairs without a sort (a chunked
    prefix count, for the TPU); a stable sort gives the same numbers."""
    q, nprobe = probe.shape
    dev = probe.device
    seq = torch.arange(q * nprobe, device=dev)
    r_seq = seq // q
    q_seq = (seq % q - r_seq * C) % q  # the rank-keyed rotation, inverted
    l_seq = probe.reshape(-1).long()[q_seq * nprobe + r_seq]
    l_seq = torch.where((l_seq >= 0) & (q_seq < n_valid), l_seq, nlist)
    order = torch.argsort(l_seq, stable=True)
    counts = torch.bincount(l_seq, minlength=nlist + 1)
    starts = torch.cumsum(counts, 0) - counts
    slot_seq = torch.empty_like(seq)
    slot_seq[order] = seq - starts[l_seq[order]]
    keep = (slot_seq < C) & (l_seq < nlist)
    bucket_q = torch.full((nlist, C), -1, dtype=torch.int64, device=dev)
    bucket_q[l_seq[keep], slot_seq[keep]] = q_seq[keep]
    qq = torch.arange(q, device=dev)[:, None]
    rr = torch.arange(nprobe, device=dev)[None, :]
    i_pair = rr * q + (qq + rr * C) % q
    pair_slot = torch.where(keep, slot_seq, -1)[i_pair]
    return bucket_q, pair_slot


def _extract_width(k: int, maxlen: int, shortlist_mult: int, rerank: bool, extract,
                   fused: bool) -> int:
    """Rows each (list, slot) keeps (the JAX package's blk_k rules)."""
    ext = str(extract).lower()
    ext_rows = int(ext) if ext.isascii() and ext.isdigit() else None
    if ext_rows is None and ext not in ("auto", "wide", "narrow"):
        raise ValueError(
            f"ann_extract={extract!r}: expected 'auto', 'wide', 'narrow' or an integer row width"
        )
    if not fused:
        return min(shortlist_mult * k, maxlen)
    if not rerank or ext == "narrow":
        return min(k, maxlen)  # exact selection answers directly
    if ext_rows is not None:
        return min(max(ext_rows, k), maxlen)
    if ext == "wide":
        return min(shortlist_mult * k, maxlen)
    return min(-(-12 * k // 10), maxlen)  # auto: ceil(1.2·k)


def residual_index_data(lists: torch.Tensor, centroids: torch.Tensor, cd):
    """(resid_norms (nlist, maxlen) f32, lists_lo (nlist, maxlen, d) in
    ``cd``): the residual rows δ = row − c_list formed in f32 and their
    ‖δ‖², built over list chunks so the f32 residual never holds the
    whole index at once."""
    nlist, maxlen, d = lists.shape
    norms = torch.empty((nlist, maxlen), dtype=torch.float32, device=lists.device)
    lo = torch.empty((nlist, maxlen, d), dtype=cd, device=lists.device)
    step = max(1, IVF_CHUNK_ELEMS // max(maxlen * d, 1) // 4)
    cent = centroids.float()
    for l0 in range(0, nlist, step):
        r = lists[l0:l0 + step].float() - cent[l0:l0 + step, None, :]
        norms[l0:l0 + step] = torch.sum(torch.square(r), dim=2)
        lo[l0:l0 + step] = r.to(cd)
    return norms, lo


def _query_residuals(queries: torch.Tensor, bucket_q: torch.Tensor, centroids: torch.Tensor,
                     l0: int, l1: int, cd) -> torch.Tensor:
    """(q − c_list) for the slots of lists l0..l1, formed in f32 and then
    cast: casting q and c first would lose the small margins."""
    return (queries.float()[bucket_q[l0:l1].clamp(min=0)]
            - centroids[l0:l1].float()[:, None, :]).to(cd)


def _probe(centroids: torch.Tensor, queries: torch.Tensor, nprobe: int, ad):
    """(probe (q, nprobe) int64, probe_d2 (q, nprobe) f32): the
    ``probe_select`` kernel, at full f32, under f32 accumulators; the JAX
    package's XLA probe (f32 distances, exact selection here) otherwise,
    and where nlist exceeds the packed keys' 16 position bits."""
    nlist = centroids.shape[0]
    if ad == torch.float32 and nlist <= 1 << 16:
        probe, probe_d2 = kernels.probe_select(centroids.float().contiguous(),
                                               queries.float().contiguous(), nprobe)
        return probe.long(), probe_d2
    cd2 = sq_euclidean(queries.float(), centroids.float(), accum_dtype=torch.float32)
    probe_d2, probe = sel.stable_topk(cd2, nprobe)
    return probe, probe_d2


def _scan_lists(queries, bucket_q, centroids, lists_lo, r2_all, blk_k, cd, ad, fused):
    """Per (list, slot) the blk_k best residual scores and row positions:
    (res_d (nlist, C, ≥ blk_k) in ``ad``, res_p (nlist, C, ≥ blk_k))."""
    nlist, C = bucket_q.shape
    maxlen, d = lists_lo.shape[1:]
    if fused:
        qv = torch.empty((nlist, C, d), dtype=cd, device=queries.device)
        step = max(1, IVF_CHUNK_ELEMS // max(C * d, 1) // 4)
        for l0 in range(0, nlist, step):
            qv[l0:l0 + step] = _query_residuals(queries, bucket_q, centroids, l0, l0 + step, cd)
        fd, fp = kernels.ivf_scan_select(qv, lists_lo, r2_all.float().contiguous(), blk_k)
        return fd.transpose(1, 2).to(ad), fp.transpose(1, 2)
    # The float64 flow: the JAX package's XLA scan with exact selection.
    res_d = torch.empty((nlist, C, blk_k), dtype=ad, device=queries.device)
    res_p = torch.empty((nlist, C, blk_k), dtype=torch.int64, device=queries.device)
    step = max(1, IVF_CHUNK_ELEMS // max(C * maxlen, 1) // 8)
    for l0 in range(0, nlist, step):
        qv = _query_residuals(queries, bucket_q, centroids, l0, l0 + step, cd)
        qr = torch.bmm(qv.to(ad), lists_lo[l0:l0 + step].to(ad).transpose(1, 2))
        d2 = r2_all[l0:l0 + step, None, :] - 2.0 * qr  # (L, C, maxlen)
        res_d[l0:l0 + step], res_p[l0:l0 + step] = sel.stable_topk(d2, blk_k)
    return res_d, res_p


def bucketed_core(queries, probe, probe_d2, lists, list_ids, list_mask, resid_norms,
                  lists_lo, centroids, n_valid: int, k: int, C: int, cd, ad,
                  shortlist_mult: int = 2, rerank: bool = True, rerank_width: int = 0,
                  extract="auto"):
    """The capacity-bucketed scorer (the JAX ``_bucketed_core`` on one
    device): bucket the (query, list) pairs, scan each list's residual rows
    against its slots' query residuals, gather each query's candidates
    back with the probe's ‖q − c‖² term (so scores compare across lists),
    then select exactly — from those scores (rerank off) or from an exact
    f32 rescore of the R best from the stored rows. Returns (d2 (q, k)
    ascending in ``ad``, ids (q, k)); (+inf, −1) where fewer than k
    candidates exist."""
    q, nprobe = probe.shape
    nlist, maxlen, d = lists.shape
    bucket_q, pair_slot = bucket_pairs(probe, n_valid, nlist, C)
    pair_list = torch.where(probe >= 0, probe, 0)
    # Residual norms with a huge value on padded rows, so they never win.
    r2_all = torch.where(list_mask > 0, resid_norms.to(ad),
                         torch.full_like(resid_norms, sel.IVF_PAD_R2, dtype=ad))
    fused = ad == torch.float32  # the kernel computes and emits f32 scores
    blk_k = _extract_width(k, maxlen, shortlist_mult, rerank, extract, fused)
    if nprobe * blk_k < k:
        raise ValueError(
            f"k={k} exceeds the bucketed candidate pool nprobe*maxlen="
            f"{nprobe * maxlen}; raise nprobe or use mode='dense'"
        )
    res_d, res_p = _scan_lists(queries, bucket_q, centroids, lists_lo, r2_all, blk_k, cd, ad,
                               fused)
    ps = pair_slot.clamp(min=0)
    cand_d = res_d[pair_list, ps][..., :blk_k] + probe_d2.to(ad)[:, :, None]
    cand_pos = res_p[pair_list, ps][..., :blk_k].long()
    dropped = (pair_slot < 0)[:, :, None]
    cand_d = torch.where(dropped, float("inf"), cand_d).reshape(q, nprobe * blk_k)
    cand_pos = torch.where(dropped, 0, cand_pos).reshape(q, nprobe * blk_k)
    cand_list = pair_list[:, :, None].expand(q, nprobe, blk_k).reshape(q, nprobe * blk_k)
    flat_ids = list_ids.reshape(-1)
    if not rerank:
        bd, pos = sel.stable_topk(cand_d, k)
        ids_k = flat_ids[cand_list.gather(1, pos) * maxlen + cand_pos.gather(1, pos)]
        # Padded rows carry the finite 1e30 sentinel, not inf.
        missing = torch.isinf(bd) | (ids_k < 0)
        return (torch.where(missing, float("inf"), torch.clamp(bd, min=0.0)),
                torch.where(missing, -1, ids_k))
    auto_w = shortlist_mult if fused else 2 * shortlist_mult
    R = min((rerank_width or auto_w) * k, nprobe * blk_k)
    approx_d, pos_r = sel.stable_topk(cand_d, R)
    flat = cand_list.gather(1, pos_r) * maxlen + cand_pos.gather(1, pos_r)
    ids_r = flat_ids[flat]  # (q, R); −1 = padded row
    rows_r = lists.reshape(-1, d)[flat].to(ad)  # (q, R, d)
    exact_d = torch.sum(torch.square(rows_r - queries.to(ad)[:, None, :]), dim=2)
    exact_d = torch.where((ids_r < 0) | torch.isinf(approx_d), float("inf"), exact_d)
    bd, pos = sel.stable_topk(exact_d, k)
    win = torch.where(torch.isinf(bd), -1, ids_r.gather(1, pos))
    return torch.clamp(bd, min=0.0), win


def _query_dense(centroids, lists, list_ids, list_mask, queries, k: int, nprobe: int, cd, ad):
    """Every block of lists against every query, non-probed pairs masked to
    +inf: exact within the probed lists (the JAX dense executor, plain
    PyTorch; no kernel serves it in the JAX package either)."""
    q = queries.shape[0]
    nlist, maxlen, d = lists.shape
    qc = queries.to(cd)
    cd2 = sq_euclidean(qc, centroids.to(cd), accum_dtype=ad)
    _, probe = sel.stable_topk(cd2, nprobe)
    probe_mask = torch.zeros((q, nlist), dtype=torch.bool, device=queries.device)
    probe_mask.scatter_(1, probe, True)
    best_d = torch.full((q, k), float("inf"), dtype=ad, device=queries.device)
    best_i = torch.full((q, k), -1, dtype=list_ids.dtype, device=queries.device)
    for b0 in range(0, nlist, DENSE_LIST_BLOCK):
        nb = min(DENSE_LIST_BLOCK, nlist - b0)
        rows = lists[b0:b0 + nb].reshape(nb * maxlen, d)
        ids = list_ids[b0:b0 + nb].reshape(-1)
        d2 = sq_euclidean(qc, rows.to(cd), accum_dtype=ad)
        keep = probe_mask[:, b0:b0 + nb, None] & (list_mask[b0:b0 + nb] > 0)[None]
        d2 = torch.where(keep.reshape(q, -1), d2, float("inf"))
        blk_d, blk_pos = sel.stable_topk(d2, min(k, nb * maxlen))
        cat_i = torch.cat([best_i, ids[blk_pos]], 1)
        best_d, pos = sel.stable_topk(torch.cat([best_d, blk_d], 1), k)
        best_i = cat_i.gather(1, pos)
    return best_d, best_i


def ivf_query(index_dev, queries: torch.Tensor, k: int, nprobe: int, cd, ad, *,
              n_valid: Optional[int] = None, mode: str = "auto", slack: float = 1.5,
              shortlist_mult: int = 2, rerank: bool = True, rerank_width: int = 0,
              extract="auto", resid=None):
    """The IVF query executor (the JAX ``_ivf_query_fn``): (d2 (q, k) in
    ``ad``, ids (q, k)). ``index_dev``: (centroids, lists, list_ids,
    list_mask) on the queries' device; ``resid``: (resid_norms, lists_lo)
    in ``cd``, built here when absent.

    ``mode``: "dense", "bucketed", or "auto" — dense when nprobe·4 ≥ nlist
    at float32 compute, else bucketed (at bfloat16 the dense executor's
    raw-magnitude scores lose the margins that residual scoring keeps)."""
    cent, lists, list_ids, list_mask = index_dev
    nlist = lists.shape[0]
    if mode not in ("auto", "dense", "bucketed"):
        raise ValueError(f"mode={mode!r}: expected 'auto', 'dense' or 'bucketed'")
    if mode == "dense" or (mode == "auto" and nprobe * 4 >= nlist and cd == torch.float32):
        return _query_dense(cent, lists, list_ids, list_mask, queries, k, nprobe, cd, ad)
    q = queries.shape[0]
    n_valid = q if n_valid is None else n_valid
    resid_norms, lists_lo = residual_index_data(lists, cent, cd) if resid is None else resid
    probe, probe_d2 = _probe(cent, queries, nprobe, ad)
    C = _bucketed_capacity(q, nprobe, nlist, slack)
    return bucketed_core(
        queries, probe, probe_d2, lists, list_ids, list_mask, resid_norms, lists_lo, cent,
        n_valid, k, C, cd, ad, shortlist_mult=shortlist_mult, rerank=rerank,
        rerank_width=rerank_width, extract=extract,
    )


def ivf_query_sharded(shard_dev, queries: torch.Tensor, k: int, nprobe: int, cd, ad, mesh, *,
                      n_valid: Optional[int] = None, slack: float = 1.5,
                      shortlist_mult: int = 2, rerank: bool = True, rerank_width: int = 0,
                      extract="auto", resid=None):
    """The sharded IVF query (the JAX ``_ivf_query_fn_sharded``): (d2 (q, k)
    ascending in ``ad``, ids (q, k)), the same on every rank of the data
    axis. ``shard_dev``: (centroids (nlist, d) unpadded and replicated,
    this rank's (nlist_local, d) centroids, lists, list_ids, list_mask),
    the rank's lists being the contiguous range at its data index of the
    padded global lists; ``resid``: the local lists' (resid_norms,
    lists_lo), built here when absent.

    Every rank probes the same replicated centroids (``probe_select``: the
    same global probe set everywhere), localizes the probe ids to its
    range (pairs it does not own become −1 and are answered by their
    owner), runs the capacity-bucketed scorer (``ivf_scan_select``) over
    its lists with the capacity of the padded global nlist, and the
    per-rank (q, k) candidates merge in one ``reduce_topk`` over the data
    axis: O(q·k·ranks), independent of the index size. Always the bucketed
    executor; list ids stay global."""
    cent, cent_local, lists, list_ids, list_mask = shard_dev
    q = queries.shape[0]
    n_valid = q if n_valid is None else n_valid
    nl_local = lists.shape[0]
    resid_norms, lists_lo = residual_index_data(lists, cent_local, cd) if resid is None else resid
    probe, probe_d2 = _probe(cent, queries, nprobe, ad)
    lo = mesh.axis_index(DATA_AXIS) * nl_local
    owned = (probe >= lo) & (probe < lo + nl_local)
    probe_local = torch.where(owned, probe - lo, -1)
    C = _bucketed_capacity(q, nprobe, nl_local * mesh.shape[DATA_AXIS], slack)
    d2, ids = bucketed_core(
        queries, probe_local, probe_d2, lists, list_ids, list_mask, resid_norms, lists_lo,
        cent_local, n_valid, k, C, cd, ad, shortlist_mult=shortlist_mult, rerank=rerank,
        rerank_width=rerank_width, extract=extract,
    )
    return mr.reduce_topk(d2, ids, k, DATA_AXIS, mesh=mesh)


# ---------------------------------------------------------------------------
# IVF-Flat: estimator and model
# ---------------------------------------------------------------------------


class _ANNParams(_NNParams):
    nlist = ParamDecl(
        "nlist",
        "number of IVF inverted lists (> 0)",
        TypeConverters.toInt,
        validator=ParamValidators.gt(0),
    )
    nprobe = ParamDecl(
        "nprobe",
        "number of lists probed per query (> 0)",
        TypeConverters.toInt,
        validator=ParamValidators.gt(0),
    )

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        self.setDefault(nlist=32, nprobe=4)

    def getNlist(self) -> int:
        return self.getOrDefault(self.nlist)

    def getNprobe(self) -> int:
        return self.getOrDefault(self.nprobe)


class ApproximateNearestNeighbors(Estimator, _ANNParams, MLWritable, MLReadable):
    """IVF-Flat approximate KNN (spark-rapids-ml ApproximateNearestNeighbors
    shape, algorithm="ivfflat"). ``device``: where the build's assignment
    and the queries run; None → the card."""

    _uid_prefix = "ApproximateNearestNeighbors"
    _persist_class = "spark_rapids_ml_tpu.models.knn.ApproximateNearestNeighbors"

    def __init__(self, uid=None, device=None):
        super().__init__(uid=uid)
        self._device = device

    def setK(self, value: int) -> "ApproximateNearestNeighbors":
        return self._set(k=value)

    def setNlist(self, value: int) -> "ApproximateNearestNeighbors":
        return self._set(nlist=value)

    def setNprobe(self, value: int) -> "ApproximateNearestNeighbors":
        return self._set(nprobe=value)

    def setMetric(self, value: str) -> "ApproximateNearestNeighbors":
        return self._set(metric=value)

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)

    def _fit(self, dataset) -> "ApproximateNearestNeighborsModel":
        metric = self.getMetric()
        if metric == "inner_product":
            raise ValueError(
                "metric='inner_product' is supported by the exact "
                "NearestNeighbors only (IVF-Flat partitions by L2 "
                "proximity; MIPS needs a different quantizer)"
            )
        x = as_matrix(dataset, self.getFeaturesCol())
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if metric == "cosine":
            # The index stores the unit-normalized (augmented) rows: L2 on
            # them is a monotone transform of the cosine distance.
            x = _normalized_rows(x, zero_slot=0)
        with trace_span("ivf build"):
            index = build_ivf_flat(x, nlist=self.getNlist(), seed=self.getSeed(),
                                   device=self._device)
        model = ApproximateNearestNeighborsModel(index=index, device=self._device)
        model.uid = self.uid
        self._copy_params_to(model)
        model._index_metric = metric
        return model


class ApproximateNearestNeighborsModel(Model, _ANNParams, MLWritable, MLReadable):
    """The IVF-Flat index (host numpy, or tensors on the device of a
    device build) and its device copies.

    ``_index_metric`` travels with the index (pickle and save/load): the
    metric's normalization is baked into the stored lists, so a query under
    another metric raises rather than mis-scores."""

    _uid_prefix = "ApproximateNearestNeighborsModel"
    _persist_class = "spark_rapids_ml_tpu.models.knn.ApproximateNearestNeighborsModel"
    _transient_attrs = ("_mesh", "_dev_index", "_resid_data", "_shard_mesh", "_shard")

    def __init__(self, index: Optional[IVFFlatIndex] = None, uid=None, device=None):
        super().__init__(uid=uid)
        self.index = index
        self._device = device
        self._dev_index = None  # (device, (centroids, lists, list_ids, list_mask))
        self._resid_data = None  # (device, compute dtype, resid_norms, lists_lo)
        self._shard_mesh = None  # set by shard_index()
        self._shard = None  # (device, ivf_query_sharded's shard_dev)

    def _model_data(self):
        idx = self.index
        data = {
            "centroids": _host_array(idx.centroids),
            "lists": _host_array(idx.lists),
            "list_ids": _host_array(idx.list_ids).astype(np.float64),
            "list_mask": _host_array(idx.list_mask),
        }
        fit_metric = getattr(self, "_index_metric", None)
        if fit_metric is not None:
            data["fit_metric"] = np.array([KNN_METRICS.index(fit_metric)], dtype=np.float64)
        return data

    @classmethod
    def _from_model_data(cls, uid, data):
        index = IVFFlatIndex(
            centroids=data["centroids"],
            lists=data["lists"],
            list_ids=np.asarray(data["list_ids"]).astype(np.int64),
            list_mask=data["list_mask"],
        )
        model = cls(index=index, uid=uid)
        code = data.get("fit_metric")
        if code is not None:
            model._index_metric = KNN_METRICS[int(np.asarray(code).reshape(-1)[0])]
        return model

    def _copy_extra_state(self, source):
        self.index = source.index
        self._device = getattr(source, "_device", None)
        self._dev_index = None
        self._resid_data = None
        self._index_metric = getattr(source, "_index_metric", None)
        # Re-run the sharded placement (it pads nlist to a multiple of the
        # data axis: an invariant a lazy upload would not restore).
        src_mesh = getattr(source, "_shard_mesh", None)
        self._shard_mesh = self._shard = None
        if src_mesh is not None and self.index is not None:
            self.shard_index(src_mesh)

    def shard_index(self, mesh=None) -> "ApproximateNearestNeighborsModel":
        """Shard the inverted lists over the mesh's ``data`` axis — the
        capacity path for an index larger than one card (BASELINE.json
        config #5, 10M × 768). nlist pads to a multiple of the data axis
        with never-probed pad lists (no rows; the probed centroid set stays
        unpadded), and this rank uploads only its contiguous range of the
        padded lists, read from the host index (of a memory-mapped one it
        reads just that range of the lists, and the centroids, which every
        rank probes, whole). Every rank of the data axis must call it; later
        queries run :func:`ivf_query_sharded` and must be made on every
        rank with the same queries. Returns self."""
        mesh = mesh or default_mesh()
        idx = self.index
        nlist = idx.centroids.shape[0]
        nl_local = -(-nlist // mesh.shape[DATA_AXIS])
        lo = min(mesh.axis_index(DATA_AXIS) * nl_local, nlist)
        hi = min(lo + nl_local, nlist)
        dev = resolve_device(self._device, mesh)

        def local(a, fill, dtype=None):
            # Slice first: a memmap reads the range, a device index copies it.
            part = _host_array(a[lo:hi])
            part = np.array(part, dtype=dtype or part.dtype)
            pad = nl_local - part.shape[0]
            if pad:
                part = np.concatenate([part, np.full((pad,) + part.shape[1:], fill, part.dtype)])
            return torch.from_numpy(part).to(dev)

        self._shard = (str(dev), (
            torch.as_tensor(np.array(_host_array(idx.centroids))).to(dev),
            local(idx.centroids, 0),
            local(idx.lists, 0),
            local(idx.list_ids, -1, np.int64),
            local(idx.list_mask, 0),
        ))
        self._dev_index = self._resid_data = None
        self._shard_mesh = mesh
        return self

    def _ensure_dev_index(self, dev):
        """The index on ``dev``, uploaded once and reused by every query; a
        device-built index already on ``dev`` is used without a copy."""
        if self._dev_index is None or self._dev_index[0] != str(dev):
            idx = self.index
            self._dev_index = (str(dev), tuple(
                (a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))).to(dev)
                for a in (idx.centroids, idx.lists, idx.list_ids, idx.list_mask)
            ))
            self._resid_data = None
        return self._dev_index[1]

    def _ensure_resid_data(self, dev, cd):
        """The bucketed executor's residual copy and norms, built lazily and
        keyed by the compute dtype: a config change between queries
        rebuilds it rather than scanning at the stale precision."""
        if self._resid_data is None or self._resid_data[:2] != (str(dev), cd):
            if self._shard is not None:
                _, cent, lists = self._shard[1][:3]  # this rank's lists
            else:
                cent, lists = self._ensure_dev_index(dev)[:2]
            self._resid_data = (str(dev), cd, *residual_index_data(lists, cent, cd))
        return self._resid_data[2:]

    def kneighbors(self, queries, k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate (distances, indices int64) under ``metric`` —
        euclidean (default) / sqeuclidean / cosine — ascending. Only the
        ``nprobe`` nearest lists are searched; where they hold fewer than k
        rows the tail is (+inf, −1). With ``ann_rerank`` off the distances
        carry the scan's packed-key mantissa floor; the ids do not."""
        if self.index is None:
            raise RuntimeError("model has no index (unfitted?)")
        k = self.getK() if k is None else k
        n_db = int(self.index.list_mask.sum())
        if not 0 < k <= n_db:
            raise ValueError(f"k = {k} out of range (0, numRows = {n_db}]")
        nlist, maxlen = self.index.list_ids.shape
        nprobe = min(self.getNprobe(), nlist)
        if nprobe * maxlen < k:
            raise ValueError(
                f"candidate pool nprobe*maxlen = {nprobe * maxlen} < k = {k}; "
                f"increase nprobe (or nlist granularity)"
            )
        metric = self.getMetric()
        fit_metric = getattr(self, "_index_metric", None)
        if fit_metric is None:
            # A model saved without it: the persisted metric param was
            # copied from the estimator at fit.
            fit_metric = metric
            self._index_metric = fit_metric
        if metric != fit_metric:
            raise ValueError(
                f"index was built under metric={fit_metric!r}; the "
                f"normalization is baked into the stored lists, so refit "
                f"to query with metric={metric!r}"
            )
        mesh = self._shard_mesh
        dev = resolve_device(self._device, mesh)
        if metric == "cosine":
            queries = _normalized_rows(queries, zero_slot=1)
        qt = to_device(queries, dev)
        if not qt.is_floating_point() or qt.dtype in (torch.bfloat16, torch.float16):
            qt = qt.float()
        q = qt.shape[0]
        cd, ad = config.compute_dtype(dev), config.accum_dtype()
        opts = dict(shortlist_mult=int(config.get("ann_shortlist_mult")),
                    rerank=bool(config.get("ann_rerank")),
                    rerank_width=int(config.get("ann_rerank_width")),
                    extract=str(config.get("ann_extract")))
        with trace_span("ivf query"):
            if mesh is not None:
                d2, ids = ivf_query_sharded(self._shard[1], _pad_queries(qt), k, nprobe, cd, ad,
                                            mesh, n_valid=q,
                                            resid=self._ensure_resid_data(dev, cd), **opts)
            else:
                index_dev = self._ensure_dev_index(dev)
                dense = nprobe * 4 >= nlist and cd == torch.float32
                resid = None if dense else self._ensure_resid_data(dev, cd)
                d2, ids = ivf_query(index_dev, _pad_queries(qt), k, nprobe, cd, ad, n_valid=q,
                                    resid=resid, **opts)
            d2, ids = d2[:q].cpu().numpy(), ids[:q].cpu().numpy().astype(np.int64)
        return _finish(metric, d2, ids)

    def _transform(self, dataset):
        x = as_matrix(dataset, self.getFeaturesCol())
        dists, idx = self.kneighbors(x)
        out = with_column(dataset, "knn_distances", dists)
        return with_column(out, "knn_indices", idx)
