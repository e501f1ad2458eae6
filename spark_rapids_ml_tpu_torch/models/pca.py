"""Principal Component Analysis — the reference's one shipped algorithm,
in PyTorch on a CUDA device, or on one per rank.

The port of ``spark_rapids_ml_tpu/models/pca.py``. Reference call stack
(SURVEY.md §3.1): ``PCA.fit`` (PCA.scala:27-37) → ``RapidsPCA.fit``
(RapidsPCA.scala:72-80) → ``computePrincipalComponentsAndExplainedVariance``
(RapidsRowMatrix.scala:59-102): per-partition Gram → reduce → single-GPU
eig → top-k slice.

Fit: the fused (count, Σx, XᵀX) stats come from the hand-written Gram
kernels (``ops/kernels.py``): the in-memory :func:`fit_pca` through the
masked ``gram`` kernel, the streaming :func:`fit_pca_stream` through one
seeded ``gram_colsum`` launch per batch. The eigensolve then runs in
float64: ``torch.linalg.eigh`` on the fit's device (config ``finalize``
"auto", which resolves to "device") or numpy on the host ("host").

Across ranks (``mesh=``, a started ``torch.distributed`` world: one
process, one device a rank) each rank passes its own rows or stream: each
rank's statistics come from the same kernel and meet in an ``all_reduce``
(``ops/gram.py``), the stream runs in lockstep
(``parallel/sharding.lockstep_batches``), every rank finalizes the same
replicated state, and rank 0 alone writes the checkpoints.

On a mesh with a model axis above 1 that divides d, :func:`fit_pca` takes
the 2-D route: the ranks of one data index pass the same rows at full
width, each keeps its column block, and the Gram is computed and kept
model-sharded (``ops/gram.sharded_stats_ring``). A width whose (d, d)
accumulator is over the per-device budget
(``ops/gram.require_gram_capacity``) fits only there:
the randomized solver stays model-sharded on the device
(``ops/eigh.pca_from_gram_model_sharded``), the exact one assembles the
slabs on the host in float64. The stream keeps its replicated
accumulator, so it refuses such widths.

Transform matches ``RapidsPCAModel.transform`` (RapidsPCA.scala:122-166):
y = x @ pc with NO re-centring; the principal components stay resident on
the device across batches.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

import os
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.core import checkpoint as ckpt
from spark_rapids_ml_tpu_torch.core.dataset import as_matrix, with_column
from spark_rapids_ml_tpu_torch.core.params import (
    Estimator,
    HasInputCol,
    HasOutputCol,
    Model,
    ParamDecl,
    ParamValidators,
    TypeConverters,
)
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable, MLWritable
from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
from spark_rapids_ml_tpu_torch.ops.eigh import (
    pca_from_gram,
    pca_from_gram_host,
    pca_from_gram_model_sharded,
    pca_from_gram_randomized,
)
from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
from spark_rapids_ml_tpu_torch.parallel.distributed import row_counts
from spark_rapids_ml_tpu_torch.parallel.mesh import MODEL_AXIS, default_mesh
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    as_tensor,
    lockstep_batches,
    predictor_key,
    resolve_device,
    shard_rows_2d,
    to_device,
)
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span


class PCASolution(NamedTuple):
    """Fit result (host-side numpy)."""

    pc: np.ndarray  # (d, k) principal components, columns descending
    explained_variance: np.ndarray  # (k,) σᵢ/Σσ — reference semantics
    sigma: np.ndarray  # (d,) singular values √λ of the (centred) Gram
    mean: np.ndarray  # (d,) column means observed during fit
    n_rows: int


_SOLVERS = ("full", "randomized")
_FINALIZE_MODES = ("device", "host")


def _resolve_solver(solver: Optional[str]) -> str:
    """None/"auto" → config ``solver``; otherwise validate explicitly —
    a typo must not silently select the slow exact path."""
    if solver is None or solver == "auto":
        solver = config.get("solver")
    if solver == "auto":
        solver = "full"
    if solver not in _SOLVERS:
        raise ValueError(f"solver must be one of {_SOLVERS} or 'auto', got {solver!r}")
    return solver


def _check_k(k: int, n_cols: int) -> None:
    if not 0 < k <= n_cols:
        # require(k > 0 && k <= n) — RapidsRowMatrix.scala:60
        raise ValueError(f"k = {k} out of range (0, n = {n_cols}]")


def _finalize_on_host(count, colsum, gram, mean_center: bool, k: int):
    """Centring + calSVD-equivalent in host float64."""
    count = float(np.asarray(count))
    colsum = np.asarray(colsum, dtype=np.float64)
    g = np.asarray(gram, dtype=np.float64)
    mean = colsum / max(count, 1.0)
    if mean_center:
        g = g - np.outer(mean, colsum)
    pc, ev, s = pca_from_gram_host(g, k)
    return pc, ev, s, mean


def _finalize(count, colsum, gram, mean_center: bool, k: int, solver: str):
    """(count, colsum, gram) → (pc, ev, σ, mean) as float64 numpy."""
    mode = config.get("finalize")
    if mode == "auto":  # cuSOLVER's float64 eigh needs no host round trip
        mode = "device"
    if mode not in _FINALIZE_MODES:
        raise ValueError(f"finalize must be one of {_FINALIZE_MODES} or 'auto', got {mode!r}")
    if mode == "host" and solver != "randomized":
        as_np = lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
        return _finalize_on_host(as_np(count), as_np(colsum), as_np(gram), mean_center, k)
    f64 = [as_tensor(t).to(torch.float64) for t in (count, colsum, gram)]
    g, mean = gram_ops.finalize_gram(*f64, mean_center)
    fn = pca_from_gram_randomized if solver == "randomized" else pca_from_gram
    pc, ev, s = fn(g, k)
    return tuple(t.cpu().numpy() for t in (pc, ev, s, mean))


def _finalize_2d(count, colsum, slab, mean_center: bool, k: int, solver: str, mesh,
                 must_shard: bool):
    """The 2-D route's finalize from a model-sharded (d/n_model, d) slab.

    Randomized: model-sharded on the device in float64 (the centring
    applied to this rank's rows of the Gram). Exact: the slabs gathered
    into the full (d, d) — on the host in float64 when the Gram is over
    the per-device budget, else on the device — then the 1-D finalize."""
    if solver == "randomized":
        count, colsum, slab = (as_tensor(t).to(torch.float64) for t in (count, colsum, slab))
        mean = colsum / torch.clamp(count, min=1)
        if mean_center:
            r0 = mesh.axis_index(MODEL_AXIS) * slab.shape[0]
            slab = slab - torch.outer(mean[r0:r0 + slab.shape[0]], colsum)
        pc, ev, s = pca_from_gram_model_sharded(slab, k, mesh)
        return tuple(t.cpu().numpy() for t in (pc, ev, s, mean))
    if must_shard:
        g = mr.host_concat(slab.to(torch.float64), MODEL_AXIS, mesh=mesh).numpy()
        return _finalize_on_host(count.cpu().numpy(), colsum.cpu().numpy(), g, mean_center, k)
    g = mr.all_concat(slab, MODEL_AXIS, axis=0, mesh=mesh)
    return _finalize(count, colsum, g, mean_center, k, solver)


def _solution(out, n_rows: int) -> PCASolution:
    pc, ev, s, mean = (np.asarray(a, dtype=np.float64) for a in out)
    return PCASolution(pc=pc, explained_variance=ev, sigma=s, mean=mean, n_rows=n_rows)


def fit_pca(
    x,
    k: int,
    mean_center: bool = True,
    solver: Optional[str] = None,
    device=None,
    mesh=None,
) -> PCASolution:
    """Fit PCA on an in-memory (n, d) matrix (numpy array or tensor).

    The Gram is the masked ``gram`` kernel on CUDA (bfloat16 or float32
    compute). ``solver``: None → config ``solver``; "full" = exact eigh,
    "randomized" = subspace iteration (:func:`pca_from_gram_randomized`).
    ``device``: None → the mesh's rank device, else the card. ``mesh``:
    None → ``default_mesh()``; across ranks ``x`` is THIS rank's rows
    (``parallel.distributed.process_local_rows``), the statistics are
    summed over the data axis and ``n_rows`` is the global count. On a
    mesh whose model axis (above 1) divides d, every rank of one data
    index passes the same rows at full width and the Gram stays
    model-sharded (the module's 2-D route); a d whose (d, d) accumulator
    is over the per-device budget fits only there, and otherwise raises
    :class:`~spark_rapids_ml_tpu_torch.ops.gram.GramCapacityError`."""
    mesh = mesh or default_mesh()
    dev = resolve_device(device, mesh)
    solver = _resolve_solver(solver)
    d = x.shape[1]
    _check_k(k, d)
    n_model = mesh.shape[MODEL_AXIS]
    two_d = n_model > 1 and d % n_model == 0
    # Capacity gate: a (d, d) accumulator over the per-device budget must
    # stay model-sharded end to end; without a model axis dividing d this
    # raises here instead of running out of memory mid-fit.
    must_shard = gram_ops.require_gram_capacity(d, mesh)
    if must_shard and not two_d:
        raise gram_ops.GramCapacityError(
            f"d={d} needs the model-sharded Gram but is not divisible by "
            f"the model axis ({n_model}); pick a divisor "
            "mesh_model_axis (docs/mesh.md 'Model-parallel Gram/eigh')"
        )
    with trace_span("compute cov"):  # phase names kept from the reference
        if two_d:
            xs, mask, n_rows = shard_rows_2d(x, mesh, device=dev)
            count, colsum, g = gram_ops.sharded_stats_ring(mesh)(xs, mask)
        else:
            xs = to_device(x, dev)
            if mesh.collective:
                count, colsum, g = gram_ops.sharded_stats(mesh)(xs)
                n_rows = int(row_counts(xs.shape[0], mesh).sum())
            else:
                count, colsum, g = gram_ops.local_stats(xs)
                n_rows = int(xs.shape[0])
    with trace_span("eig finalize"):
        if two_d:
            out = _finalize_2d(count, colsum, g, mean_center, k, solver, mesh, must_shard)
        else:
            out = _finalize(count, colsum, g, mean_center, k, solver)
    return _solution(out, n_rows)


def fit_pca_stream(
    batches: Iterable,
    k: int,
    n_cols: int,
    mean_center: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 16,
    solver: Optional[str] = None,
    device=None,
    mesh=None,
) -> PCASolution:
    """Fit PCA over a stream of row batches (dataset ≫ device memory).

    Each batch (numpy array or tensor, (m, n_cols)) is cast once to the
    compute dtype on the device and folded into the device-resident
    (count, colsum, gram) state in place by ONE seeded ``gram_colsum``
    launch (bfloat16/float32 compute, float32 state).

    With ``checkpoint_path``, the O(d²) accumulator is atomically persisted
    every ``checkpoint_every`` batches and the fit RESUMES from it if the
    file exists: callers re-supply the same batch iterator and already-
    consumed batches are skipped. The checkpoint is removed on success.

    **Across ranks** (``mesh`` of a started world): ``batches`` is THIS
    rank's stream, iterated in lockstep (uneven stream lengths are fine:
    an exhausted rank adds zero partials), each batch's partial summed
    over the ranks before it joins the replicated state. Rank 0 alone
    writes and removes the checkpoint, which every rank must see (a
    shared filesystem); one file restores all.
    """
    _check_k(k, n_cols)
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    solver = _resolve_solver(solver)  # fail fast, before consuming batches
    mesh = mesh or default_mesh()
    dev = resolve_device(device, mesh)
    if gram_ops.require_gram_capacity(n_cols, mesh):
        # The streaming accumulator is REPLICATED on every rank, so a model
        # axis does not shelter it; the model-sharded accumulate is the
        # in-memory fit's 2-D route.
        raise gram_ops.GramCapacityError(
            f"the ({n_cols}, {n_cols}) streaming accumulator is over the "
            "per-device budget and the streaming path keeps it replicated; "
            "use fit_pca with mesh_model_axis > 1 (docs/mesh.md) or raise "
            "SRML_TORCH_GRAM_DEVICE_BUDGET_MB"
        )
    cd = config.compute_dtype(dev)
    state = gram_ops.init_stats(n_cols, device=dev)
    n_prev = 0  # rows of the restored checkpoint (global)
    n_local = 0  # this rank's rows since
    skip_batches = 0
    if checkpoint_path:
        restored = ckpt.load_state(checkpoint_path)
        ckpt.require_consistent_visibility(restored)
        if restored is not None:
            arrays, meta = restored
            if meta.get("n_cols") != n_cols:
                raise ValueError(
                    f"checkpoint at {checkpoint_path} is for n_cols="
                    f"{meta.get('n_cols')}, not {n_cols}"
                )
            state = tuple(
                as_tensor(arrays[name]).to(device=dev, dtype=config.accum_dtype())
                for name in ("count", "colsum", "gram")
            )
            n_prev = int(meta["n_rows"])
            skip_batches = int(meta["n_batches"])

    def rows_so_far() -> int:
        if mesh.collective:
            return n_prev + int(row_counts(n_local, mesh).sum())
        return n_prev + n_local

    def check(x) -> Optional[str]:
        if x.ndim != 2 or x.shape[1] != n_cols:
            return f"batch has shape {tuple(x.shape)}, expected (m, {n_cols})"
        return None

    with trace_span("compute cov"):
        for i, batch in enumerate(lockstep_batches(batches, n_cols, check)):
            if i < skip_batches:
                continue
            xb = to_device(batch, dev, cd)
            n_local += xb.shape[0]
            gram_ops.streaming_update_rows(state, xb, xb.shape[0], compute_dtype=cd, mesh=mesh)
            if checkpoint_path and (i + 1) % checkpoint_every == 0:
                n_rows = rows_so_far()
                if ckpt.is_writer():
                    count, colsum, g = (t.cpu().numpy() for t in state)
                    ckpt.save_state(
                        checkpoint_path,
                        {"count": count, "colsum": colsum, "gram": g},
                        {"n_rows": n_rows, "n_batches": i + 1, "n_cols": n_cols},
                    )
    n_true = rows_so_far()
    if checkpoint_path and ckpt.is_writer() and os.path.exists(checkpoint_path):
        # A finished fit must not seed a FUTURE fit against the same path.
        ckpt.discard_state(checkpoint_path)
    return finalize_pca_stats(state, k, mean_center, n_true, solver=solver)


def finalize_pca_stats(
    state,
    k: int,
    mean_center: bool,
    n_true: int,
    solver: Optional[str] = None,
) -> PCASolution:
    """(count, colsum, gram) accumulator (tensors or arrays) → PCASolution.

    The shared tail of the streaming fit, and the finalize entry point for
    a state gathered elsewhere (``convert.stats_from_jax``)."""
    solver = _resolve_solver(solver)
    count, colsum, g = state
    _check_k(k, int(colsum.shape[0]))
    with trace_span("eig finalize"):
        out = _finalize(count, colsum, g, mean_center, k, solver)
    return _solution(out, n_true)


# ---------------------------------------------------------------------------
# Estimator / Model (Spark ML contract — reference RapidsPCA.scala)
# ---------------------------------------------------------------------------


class _PCAParams(HasInputCol, HasOutputCol):
    """Params shared by PCA and PCAModel (RapidsPCAParams, RapidsPCA.scala:34-46)."""

    k = ParamDecl(
        "k",
        "number of principal components (> 0)",
        TypeConverters.toInt,
        validator=ParamValidators.gt(0),
    )
    meanCentering = ParamDecl(
        "meanCentering",
        "whether to center data before computing the covariance "
        "(fused on-device here; the reference stubs this to ETL)",
        TypeConverters.toBoolean,
    )
    solver = ParamDecl(
        "solver",
        'eigensolver for the finalize: "auto" (config), "full" (exact '
        'eigh), or "randomized" (subspace iteration)',
        TypeConverters.toString,
    )

    def __init__(self, uid=None):
        super().__init__(uid=uid)
        # default true — RapidsPCA.scala:45-46
        self.setDefault(
            meanCentering=True,
            inputCol="features",
            outputCol="pca_features",
            solver="auto",
        )

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getMeanCentering(self) -> bool:
        return self.getOrDefault(self.meanCentering)

    def getSolver(self) -> str:
        return self.getOrDefault(self.solver)


class PCA(Estimator, _PCAParams, MLWritable, MLReadable):
    """PCA estimator: ``PCA().setInputCol("features").setK(3).fit(df)``.

    ``device``: where the fit runs; None → the card. ``mesh``: the ranks the
    fit spans (None → ``default_mesh()``; see :func:`fit_pca`)."""

    _uid_prefix = "PCA"
    _persist_class = "spark_rapids_ml_tpu.models.pca.PCA"

    def __init__(self, uid=None, device=None, mesh=None):
        super().__init__(uid=uid)
        self._device = device
        self._mesh = mesh

    def setK(self, value: int) -> "PCA":
        return self._set(k=value)

    def setMeanCentering(self, value: bool) -> "PCA":
        return self._set(meanCentering=value)

    def setSolver(self, value: str) -> "PCA":
        return self._set(solver=value)

    def _copy_extra_state(self, source):
        self._device = getattr(source, "_device", None)
        self._mesh = getattr(source, "_mesh", None)

    def _fit(self, dataset) -> "PCAModel":
        x = as_matrix(dataset, self.getInputCol())
        sol = fit_pca(
            x,
            k=self.getK(),
            mean_center=self.getMeanCentering(),
            solver=self.getSolver(),
            device=self._device,
            mesh=self._mesh,
        )
        model = PCAModel(
            pc=sol.pc,
            explained_variance=sol.explained_variance,
            mean=sol.mean,
            device=self._device,
        )
        model.uid = self.uid
        # Parent params flow to the model — Model.copy semantics in Spark.
        self._copy_params_to(model)
        return model


class PCAModel(Model, _PCAParams, MLWritable, MLReadable):
    """Fitted PCA model: pc (d, k), explainedVariance (k,).

    (RapidsPCAModel, RapidsPCA.scala:102-166.) ``device``: where transform
    runs; None → the card."""

    _uid_prefix = "PCAModel"
    # The on-disk class name, shared with the JAX package so that either
    # package loads the other's saved models (core/persistence.py).
    _persist_class = "spark_rapids_ml_tpu.models.pca.PCAModel"
    # The daemon's serving contract (spark/estimator.py): the wire algo and
    # role → (param naming the output column, the column's kind).
    _serve_algo = "pca"
    _serve_outputs = (("output", "outputCol", "vec"),)

    def __init__(
        self,
        pc: Optional[np.ndarray] = None,
        explained_variance: Optional[np.ndarray] = None,
        mean: Optional[np.ndarray] = None,
        uid=None,
        device=None,
    ):
        super().__init__(uid=uid)
        self.pc = None if pc is None else np.asarray(pc)
        self.explainedVariance = (
            None if explained_variance is None else np.asarray(explained_variance)
        )
        self.mean = None if mean is None else np.asarray(mean)
        self._device = device
        self._project_cache: dict = {}

    # -- persistence (PCAModelWriter/Reader, RapidsPCA.scala:193-228) ------
    def _model_data(self):
        data = {"pc": self.pc}
        if self.explainedVariance is not None:
            data["explainedVariance"] = self.explainedVariance
        if self.mean is not None:
            data["mean"] = self.mean
        return data

    @classmethod
    def _from_model_data(cls, uid, data):
        return cls(
            pc=data["pc"],
            # Tolerate saves without explainedVariance, as the reference's
            # reader does (RapidsPCA.scala:209-213); transform needs only pc.
            explained_variance=data.get("explainedVariance"),
            mean=data.get("mean"),
            uid=uid,
        )

    def _copy_extra_state(self, source):
        self.pc = source.pc
        self.explainedVariance = source.explainedVariance
        self.mean = source.mean
        self._device = getattr(source, "_device", None)
        self._project_cache = {}

    # -- transform ---------------------------------------------------------
    def _projector(self):
        """y = x @ pc with the PC matrix resident on the device.

        Operands are rounded to the compute dtype and multiplied with
        accumulation in the accumulator dtype, TF32 off (package-wide) —
        the JAX package's ``preferred_element_type=accum``. (A bf16 × bf16
        ``torch.matmul`` would round its OUTPUT to bf16.) Cached by device
        and dtypes, so a config change rebuilds it."""
        key = predictor_key(self._device)
        if key not in self._project_cache:
            dev, cd, ad = resolve_device(self._device), key[1], key[2]
            pc_dev = as_tensor(self.pc).to(dev).to(cd).to(ad)

            def project(x: torch.Tensor) -> torch.Tensor:
                return x.to(dev).to(cd).to(ad) @ pc_dev

            self._project_cache[key] = project
        return self._project_cache[key]

    def _serve_aot_plan(self, n_rows, n_cols, dtype="float32", k=None):
        """AOT-at-registration plan (``serve/aot.py``): the projection of one
        served bucket, ``n_rows`` rows of the wire dtype. The served
        transform pads a request to its ladder bucket and the port's
        projector adds no floor, so each bucket is one program (the JAX
        plan's 256-row floor folds buckets 64 and 256 into one). A wrong
        width raises, as in the JAX plan."""
        if self.pc is None:
            return None
        from spark_rapids_ml_tpu_torch.serve import aot

        return aot.transform_plan(self, n_rows, n_cols, dtype, self.pc.shape[0],
                                  self._projector(), lambda outs, n: {"output": outs[0]})

    def transform_matrix(self, x) -> dict:
        """Role-keyed transform of a bare (n, d) matrix — the serving
        surface. A tensor in gives a tensor on the model's device out; a
        host array in gives a numpy array out."""
        if self.pc is None:
            raise RuntimeError("PCAModel has no principal components (unfitted?)")
        with trace_span("pca transform"):
            if isinstance(x, torch.Tensor):
                return {"output": self._projector()(x)}
            y = self._projector()(as_tensor(x))
            return {"output": y.cpu().numpy()}

    def _transform(self, dataset):
        x = as_matrix(dataset, self.getInputCol())
        y = self.transform_matrix(x)["output"]
        return with_column(dataset, self.getOutputCol(), y)

    def setOutputCol(self, value: str) -> "PCAModel":
        return self._set(outputCol=value)
