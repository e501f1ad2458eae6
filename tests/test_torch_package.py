"""Package rules of the PyTorch port (spark_rapids_ml_tpu_torch).

* It imports neither JAX nor anything of the JAX package, and neither does
  ``chip_smoke.py``, the script that drives the port on the card.
* Its entry points run on the card unless asked for the CPU, and raise
  without one instead of carrying on there.
* Its config reads its own ``SRML_TORCH_*`` environment, not the JAX
  package's ``SRML_TPU_*``.
* On a CUDA card (``cuda`` marker; skipped elsewhere) its kernels launch
  and agree with their plain versions.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import (
    PCA,
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    KMeans,
    KMeansModel,
    LinearRegression,
    LinearRegressionModel,
    LogisticRegression,
    LogisticRegressionModel,
    NearestNeighbors,
    NearestNeighborsModel,
    PCAModel,
    config,
)
from spark_rapids_ml_tpu_torch.core.dataset import as_column, as_matrix, num_rows, with_column
from spark_rapids_ml_tpu_torch.models import kmeans as port_km
from spark_rapids_ml_tpu_torch.models import knn as port_knn
from spark_rapids_ml_tpu_torch.models import linear_regression as port_lr
from spark_rapids_ml_tpu_torch.models import logistic_regression as port_lg
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "spark_rapids_ml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_ml_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_and_chip_smoke_import_no_jax():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) >= 15
    offenders = [
        f"{p.relative_to(ROOT)}:{line} imports {root}"
        for p in sources
        for root, line in _imported_roots(p)
        if root in FORBIDDEN
    ]
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, spark_rapids_ml_tpu_torch, spark_rapids_ml_tpu_torch.convert, "
        "spark_rapids_ml_tpu_torch.ops.kernels, spark_rapids_ml_tpu_torch.ops.selection, "
        "spark_rapids_ml_tpu_torch.models.knn; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'spark_rapids_ml_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_data_plane_loads_neither_jax_nor_pyarrow():
    code = (
        "import sys, spark_rapids_ml_tpu_torch.serve; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'spark_rapids_ml_tpu', 'pyarrow', 'pandas')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_parallel_layer_and_its_utilities_load_no_jax():
    code = (
        "import sys, spark_rapids_ml_tpu_torch.parallel, "
        "spark_rapids_ml_tpu_torch.parallel.distributed, spark_rapids_ml_tpu_torch.core, "
        "spark_rapids_ml_tpu_torch.bridge, spark_rapids_ml_tpu_torch.ops, "
        "spark_rapids_ml_tpu_torch.utils, spark_rapids_ml_tpu_torch.utils.retry, "
        "spark_rapids_ml_tpu_torch.core.checkpoint; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'spark_rapids_ml_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # The two-rank test's worker process imports only the port, too.
    worker = ROOT / "tests" / "torch_multiproc_worker.py"
    assert [r for r, _ in _imported_roots(worker) if r in FORBIDDEN] == []


def test_the_serving_scheduler_is_scanned_and_loads_neither_jax_nor_pyarrow():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    assert "spark_rapids_ml_tpu_torch/serve/scheduler.py" in scanned
    assert [r for r, _ in _imported_roots(PORT / "serve" / "scheduler.py")
            if r in FORBIDDEN] == []
    code = (
        "import sys, spark_rapids_ml_tpu_torch.serve.scheduler; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'spark_rapids_ml_tpu', 'pyarrow', 'pandas')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_fleet_modules_are_scanned_and_load_neither_jax_nor_pyarrow():
    """``serve/router.py`` and ``serve/gossip.py`` are in the scan above,
    import nothing of JAX, and load neither JAX nor pyarrow."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    for name in ("router", "gossip"):
        assert f"spark_rapids_ml_tpu_torch/serve/{name}.py" in scanned
        assert [r for r, _ in _imported_roots(PORT / "serve" / f"{name}.py")
                if r in FORBIDDEN] == []
    code = (
        "import sys, spark_rapids_ml_tpu_torch.serve.router, "
        "spark_rapids_ml_tpu_torch.serve.gossip; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'spark_rapids_ml_tpu', 'pyarrow', 'pandas')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_fleet_control_plane_and_tools_are_scanned_and_load_no_jax():
    """``serve/fleet.py``, ``serve/autoscaler.py`` and ``tools/*.py`` are in
    the scan above, import nothing of JAX, and load neither JAX nor pyarrow;
    ``serve.__all__`` names what the JAX package's names."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    paths = [PORT / "serve" / "fleet.py", PORT / "serve" / "autoscaler.py"] + [
        PORT / "tools" / f"{m}.py" for m in ("__init__", "top", "trace")]
    for path in paths:
        assert path.relative_to(ROOT).as_posix() in scanned
        assert [r for r, _ in _imported_roots(path) if r in FORBIDDEN] == []
    code = (
        "import sys, spark_rapids_ml_tpu_torch.serve as s, "
        "spark_rapids_ml_tpu_torch.serve.fleet, spark_rapids_ml_tpu_torch.serve.autoscaler, "
        "spark_rapids_ml_tpu_torch.tools.top, spark_rapids_ml_tpu_torch.tools.trace; "
        "assert 'ModelFleet' in s.__all__ and 'FleetRolloutError' in s.__all__; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'spark_rapids_ml_tpu', 'pyarrow', 'pandas')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from spark_rapids_ml_tpu import serve as jax_serve
    from spark_rapids_ml_tpu_torch import serve as port_serve

    assert port_serve.__all__ == jax_serve.__all__


def test_the_analyzer_and_perfcheck_are_scanned_and_load_only_the_stdlib():
    """``tools/analyze.py`` and ``tools/perfcheck.py`` are in the scan above
    and import neither JAX, the JAX package, torch nor pyarrow; importing
    both loads none of them either."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    for mod in ("analyze", "perfcheck"):
        path = PORT / "tools" / f"{mod}.py"
        assert path.relative_to(ROOT).as_posix() in scanned
        roots = [r for r, _ in _imported_roots(path)]
        assert [r for r in roots if r in FORBIDDEN + ("torch", "pyarrow")] == []
    code = (
        "import sys, spark_rapids_ml_tpu_torch.tools.analyze, "
        "spark_rapids_ml_tpu_torch.tools.perfcheck; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'spark_rapids_ml_tpu', 'pyarrow')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_observability_plane_is_scanned_and_loads_no_jax():
    """The journal, the kernel ledger, the SLO evaluator and the flight
    recorder are the port's own copies: scanned, importing neither JAX nor
    the JAX package, and the ``utils`` re-exports name ``journal``."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    mods = ("journal", "xprof", "slo", "flight")
    for mod in mods:
        path = PORT / "utils" / f"{mod}.py"
        assert path.relative_to(ROOT).as_posix() in scanned
        assert [r for r, _ in _imported_roots(path) if r in FORBIDDEN] == []
    code = (
        "import sys, spark_rapids_ml_tpu_torch.utils as u; "
        + "".join(f"import spark_rapids_ml_tpu_torch.utils.{m}; " for m in mods)
        + "assert 'journal' in u.__all__ and u.journal.__name__.endswith('utils.journal'); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'spark_rapids_ml_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_cuda):
    x = np.random.default_rng(0).normal(size=(20, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCA().setK(2).fit({"features": x})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pca.fit_pca(x, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pca.fit_pca_stream([x], 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCAModel(pc=np.eye(4)[:, :2]).transform_matrix(x)
    daemon = DataPlaneDaemon(serve_batching=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daemon.start()
    assert daemon._scheduler is None  # refused before any serving thread starts
    # Asked for explicitly, the CPU works.
    model = PCA(device="cpu").setK(2).fit({"features": x})
    assert model.transform_matrix(x)["output"].shape == (20, 2)


@pytest.mark.parametrize("call", [
    lambda x, y: KMeans().setK(2).fit({"features": x}),
    lambda x, y: port_km.fit_kmeans(x, 2),
    lambda x, y: port_km.fit_kmeans_stream(lambda: iter([x]), 2, 4),
    lambda x, y: KMeansModel(centers=x[:2]).predict(x),
    lambda x, y: LinearRegression().fit({"features": x, "label": y}),
    lambda x, y: port_lr.fit_linear_regression(x, y),
    lambda x, y: LinearRegressionModel(coefficients=np.ones(4)).transform_matrix(x),
])
def test_kmeans_and_linreg_entry_points_raise_without_a_card(no_cuda, call):
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(20, 4)), rng.normal(size=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x, y)


def test_kmeans_and_linreg_run_on_the_cpu_when_asked(no_cuda):
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(20, 4)), rng.normal(size=20)
    ds = {"features": x, "label": y}
    km = KMeans(device="cpu").setK(2).fit(ds)
    assert km.transform(ds)["prediction"].shape == (20,)
    lr = LinearRegression(device="cpu").fit(ds)
    assert lr.transform(ds)["prediction"].shape == (20,)
    np.testing.assert_array_equal(as_column(ds, "label"), y)
    with pytest.raises(TypeError, match="bare array"):
        as_column(x, "label")


def test_logreg_exports_and_launch_counters():
    import spark_rapids_ml_tpu_torch as port

    assert {"LogisticRegression", "LogisticRegressionModel"} <= set(port.__all__)
    assert port.LogisticRegressionModel._persist_class == (
        "spark_rapids_ml_tpu.models.logistic_regression.LogisticRegressionModel")
    assert set(kernels.LAUNCHES) == {"gram", "gram_colsum", "linreg_stats", "lloyd_step",
                                     "assign_min_dist", "newton_stats", "softmax_curvature",
                                     "dist_topk", "probe_select", "ivf_scan_select"}
    kernels.LAUNCHES["newton_stats"] += 3
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("call", [
    lambda x, y: LogisticRegression().fit({"features": x, "label": y}),
    lambda x, y: port_lg.fit_logistic_regression(x, y),
    lambda x, y: port_lg.fit_logistic_stream(lambda: iter([(x, y)]), 4),
    lambda x, y: port_lg.fit_multinomial_stream(lambda: iter([(x, y)]), 4, 2),
    lambda x, y: LogisticRegressionModel(coefficients=np.ones(4), intercept=0.0)
    .transform_matrix(x),
])
def test_logreg_entry_points_raise_without_a_card(no_cuda, call):
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(20, 4)), (rng.random(20) < 0.5).astype(np.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x, y)


def test_knn_exports_and_persisted_class_names():
    import spark_rapids_ml_tpu_torch as port

    assert {"NearestNeighbors", "NearestNeighborsModel", "ApproximateNearestNeighbors",
            "ApproximateNearestNeighborsModel"} <= set(port.__all__)
    assert NearestNeighborsModel._persist_class == (
        "spark_rapids_ml_tpu.models.knn.NearestNeighborsModel")
    assert ApproximateNearestNeighborsModel._persist_class == (
        "spark_rapids_ml_tpu.models.knn.ApproximateNearestNeighborsModel")
    assert {k: config.get(k) for k in ("ann_shortlist_mult", "ann_rerank", "ann_rerank_width",
                                       "ann_extract")} == {
        "ann_shortlist_mult": 2, "ann_rerank": True, "ann_rerank_width": 0, "ann_extract": "auto"}
    with pytest.raises(KeyError):
        config.get("ann_fused_scan")  # the tensor's device decides, no switch


def _knn_db():
    return np.random.default_rng(3).normal(size=(64, 4)).astype(np.float32)


@pytest.mark.parametrize("call", [
    lambda x: NearestNeighbors().setK(2).fit({"features": x}).kneighbors(x[:3]),
    lambda x: NearestNeighborsModel(database=x).kneighbors(x[:3], k=2),
    lambda x: ApproximateNearestNeighbors().setNlist(4).fit({"features": x}),
    lambda x: port_knn.build_ivf_flat(x, 4),
    lambda x: ApproximateNearestNeighborsModel(
        index=port_knn.build_ivf_flat(x, 4, device="cpu"))._set(k=2).kneighbors(x[:3]),
])
def test_knn_entry_points_raise_without_a_card(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(_knn_db())


def test_knn_runs_on_the_cpu_when_asked(no_cuda):
    x = _knn_db()
    d, i = NearestNeighbors(device="cpu").setK(3).fit({"features": x}).kneighbors(x[:5])
    assert i[:, 0].tolist() == [0, 1, 2, 3, 4] and np.allclose(d[:, 0], 0, atol=1e-3)
    ann = ApproximateNearestNeighbors(device="cpu").setNlist(4).setNprobe(4).setK(3)
    d, i = ann.fit({"features": x}).kneighbors(x[:5])
    assert i[:, 0].tolist() == [0, 1, 2, 3, 4] and d.shape == (5, 3)


def test_config_reads_its_own_env_prefix():
    # The JAX conftest sets SRML_TPU_COMPUTE_DTYPE=float64; the port must
    # not see it.
    assert os.environ.get("SRML_TPU_COMPUTE_DTYPE") == "float64"
    code = (
        "from spark_rapids_ml_tpu_torch import config; "
        "print(config.get('compute_dtype'), config.get('accum_dtype'), config.get('solver'))"
    )
    env = dict(os.environ, SRML_TORCH_SOLVER="randomized")
    env.pop("SRML_TORCH_COMPUTE_DTYPE", None)
    env.pop("SRML_TORCH_ACCUM_DTYPE", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["auto", "float32", "randomized"], out.stderr


def test_compute_dtype_auto_resolves_per_device():
    with config.option("compute_dtype", "auto"):
        assert config.compute_dtype("cuda") == torch.bfloat16
        assert config.compute_dtype("cpu") == torch.float32
    with config.option("compute_dtype", "float64"):
        assert config.compute_dtype("cuda") == torch.float64
    with pytest.raises(KeyError):
        config.get("use_pallas")  # the tensor's device decides, no switch
    with pytest.raises(KeyError):
        config.get("tracing")  # spans are always named


def test_tracing_names_the_reference_phases():
    """A fit's phases are named ranges in a ``torch.profiler`` trace (the
    reference's NVTX phase names)."""
    x = np.random.default_rng(2).normal(size=(30, 4))
    with torch.profiler.profile() as prof:
        PCA(device="cpu").setK(2).fit({"features": x}).transform_matrix(x)
    names = {e.name for e in prof.events()}
    assert {"compute cov", "eig finalize", "pca transform"} <= names


def test_float32_products_are_pinned_to_full_precision():
    """Importing the port turns TF32 off once for the process (the JAX
    package's ``Precision.HIGHEST``); nothing toggles it per call."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("kind", ["dict", "tensor", "arrow", "pandas"])
def test_estimator_over_containers(kind):
    x = np.random.default_rng(1).normal(size=(40, 5))
    if kind == "dict":
        ds = {"features": x}
    elif kind == "tensor":
        ds = torch.from_numpy(x)
    elif kind == "arrow":
        pa = pytest.importorskip("pyarrow")
        ds = pa.table({"features": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 5)})
    else:
        pd = pytest.importorskip("pandas")
        ds = pd.DataFrame({"features": list(x)})
    assert num_rows(ds) == 40
    np.testing.assert_allclose(np.asarray(as_matrix(ds, "features")), x)
    model = PCA(device="cpu").setK(2).fit(ds)
    out = model.transform(ds)
    y = as_matrix(out, "pca_features") if kind != "tensor" else out
    assert tuple(np.asarray(y).shape) == (40, 2)


def test_estimator_params_copy_and_persistence(tmp_path):
    est = PCA(device="cpu").setK(3).setMeanCentering(False).setSolver("full")
    est.save(str(tmp_path / "est"))
    back = PCA.load(str(tmp_path / "est"))
    assert (back.getK(), back.getMeanCentering(), back.getSolver()) == (3, False, "full")
    assert back.uid == est.uid
    copied = est.copy({"k": 2})
    assert copied.getK() == 2 and copied._device == "cpu"
    assert with_column({"a": 1}, "b", np.zeros(2))["b"].shape == (2,)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """On a CUDA card: both kernels launch and agree with their plain
    versions at ragged shapes (f32 sums in another order: 1e-5 of the
    largest Σx²). Run on the card (no JAX there, so without the JAX conftest) with
    ``python -m pytest tests/test_torch_package.py -m cuda --noconftest``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1001, 300), generator=gen, device="cuda").to(dtype)
        scale = float((x.float() ** 2).sum(0).max())
        before = kernels.LAUNCHES["gram_colsum"]
        g, cs, c = kernels.gram_colsum(x, 777)
        assert kernels.LAUNCHES["gram_colsum"] == before + 1
        gp, csp, cp = kernels.gram_colsum_plain(x, 777)
        assert float((g - gp).abs().max()) <= 1e-5 * scale
        assert float(c) == float(cp) == 777.0
        mask = (torch.rand(1001, generator=gen, device="cuda") < 0.5).float()
        assert float((kernels.gram(x, mask) - kernels.gram_plain(x, mask)).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_kmeans_and_linreg_kernels_match_plain_versions_on_card():
    """On a CUDA card: linreg_stats, lloyd_step and assign_min_dist launch
    and agree with their plain versions at ragged shapes (f32 sums in
    another order: 1e-5 of the largest absolute sum; counts exact; rows
    near well-separated centres, so the assignments agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1001, 300), generator=gen, device="cuda").to(dtype)
        y = torch.randn((1001,), generator=gen, device="cuda")
        mask = (torch.rand(1001, generator=gen, device="cuda") < 0.5).float()
        before = kernels.LAUNCHES["linreg_stats"]
        out = kernels.linreg_stats(x, y, mask)
        assert kernels.LAUNCHES["linreg_stats"] == before + 1
        ref = kernels.linreg_stats_plain(x, y, mask)
        scale = float((x.float() ** 2).sum(0).max())
        assert float((out[0] - ref[0]).abs().max()) <= 1e-5 * scale
        assert float(out[5]) == float(ref[5]) == float((mask != 0).sum())
        centers = torch.randn((37, 300), generator=gen, device="cuda")
        lab = torch.randint(0, 37, (1001,), generator=gen, device="cuda")
        xk = (centers[lab] + 0.05 * torch.randn((1001, 300), generator=gen, device="cuda"))
        xk, ck = xk.to(dtype), centers.to(dtype)
        sums, counts = kernels.lloyd_step(xk, ck, 900)
        sums_p, counts_p = kernels.lloyd_step_plain(xk, ck, 900)
        assert bool((counts == counts_p).all()) and float(counts.sum()) == 900
        assert float((sums - sums_p).abs().max()) <= 1e-5 * float(xk.float().abs().sum(0).max())
        idx, part = kernels.assign_min_dist(xk, ck)
        idx_p, part_p = kernels.assign_min_dist_plain(xk, ck)
        assert bool((idx == idx_p).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d, k", [(8, 1024), (256, 100), (256, 129), (768, 7), (1000, 1024),
                                  (256, 50_000)])
def test_tensor_core_kmeans_matches_plain_versions_on_card(d, k):
    """On a CUDA card: bf16 lloyd_step and assign_min_dist with d % 8 == 0
    take the tensor-core route and agree BITWISE with their plain versions
    on small-integer rows and centres (every score and sum an exact
    integer in f32) at ragged n and n_valid, a duplicated centre (exact
    ties, to the lowest index) included; the fused pass (d = 8, and d = 256
    with k = 100) and the two-pass step (the rest; k = 50,000 streams its
    score constants) both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(d + k)

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=gen, device="cuda").float()

    n = 9001
    x = ints(n, d).to(torch.bfloat16)
    c = ints(k, d)
    c[k - 1] = c[0]
    c = c.to(torch.bfloat16)
    before = dict(kernels.ROUTES)
    idx, dist = kernels.assign_min_dist(x, c)
    want_i, want_d = kernels.assign_min_dist_plain(x, c)
    assert torch.equal(idx, want_i) and torch.equal(dist, want_d)
    assert k == 1 or not bool((idx == k - 1).any())
    for n_valid in (0, 1234, n + 5):
        got = kernels.lloyd_step(x, c, n_valid)
        want = kernels.lloyd_step_plain(x, c, n_valid)
        assert all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    assert kernels.ROUTES["assign_min_dist/wgmma"] == before["assign_min_dist/wgmma"] + 1
    assert kernels.ROUTES["lloyd_step/wgmma"] == before["lloyd_step/wgmma"] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("d, n", [(8, 20001), (1000, 20001), (2048, 9001), (1000, 37)])
def test_tensor_core_gram_matches_plain_versions_on_card(d, n):
    """On a CUDA card: bf16 gram_colsum and linreg_stats with d % 8 == 0
    take the tensor-core route and agree BITWISE with their plain versions
    on small-integer inputs (every product and partial sum an integer
    below 2^24), seeded non-symmetric integer states and a {0, 1} mask
    included; d = 300 stays on the FFMA route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(d)

    def ints(*shape, lo=-3, hi=4):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda").float()

    x = ints(n, d).to(torch.bfloat16)
    for n_valid in (0, min(1234, n), n + 5):
        g0, cs0 = ints(d, d, lo=-50, hi=51), ints(d, lo=-50, hi=51)
        before = kernels.ROUTES["gram_colsum/wgmma"]
        got = kernels.gram_colsum(x, n_valid, (g0.clone(), cs0.clone(), torch.tensor(3.0, device="cuda")))
        assert kernels.ROUTES["gram_colsum/wgmma"] == before + 1
        want = kernels.gram_colsum_plain(x, n_valid, (g0, cs0, torch.tensor(3.0, device="cuda")))
        assert all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    y = ints(n)
    mask = (torch.rand((n,), generator=gen, device="cuda") < 0.7).float()
    before = kernels.ROUTES["linreg_stats/wgmma"]
    got = kernels.linreg_stats(x, y, mask)
    assert kernels.ROUTES["linreg_stats/wgmma"] == before + 1
    want = kernels.linreg_stats_plain(x, y, mask)
    assert all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    before = kernels.ROUTES["gram_colsum/ffma"]
    kernels.gram_colsum(ints(n, 300).to(torch.bfloat16), n)
    assert kernels.ROUTES["gram_colsum/ffma"] == before + 1


@pytest.mark.cuda
def test_logreg_kernels_match_plain_versions_on_card():
    """On a CUDA card: newton_stats and softmax_curvature launch and agree
    with their plain versions at ragged shapes (f32 sums in another order:
    1e-5 of the largest absolute sum of terms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1001, 300), generator=gen, device="cuda").to(dtype)
        y = (torch.rand((1001,), generator=gen, device="cuda") < 0.5).float()
        mask = (torch.rand((1001,), generator=gen, device="cuda") < 0.7).float()
        w = torch.randn((300,), generator=gen, device="cuda") / 300 ** 0.5
        b = torch.tensor(0.3, device="cuda")
        before = kernels.LAUNCHES["newton_stats"]
        out = kernels.newton_stats(x, y, mask, w, b)
        assert kernels.LAUNCHES["newton_stats"] == before + 1
        ref = kernels.newton_stats_plain(x, y, mask, w, b)
        xf = x.float()
        scale = float((xf * xf).sum(0).max())
        assert float((out[2] - ref[2]).abs().max()) <= 1e-5 * scale
        assert float((out[0] - ref[0]).abs().max()) <= 1e-5 * float(xf.abs().sum(0).max())
        p = torch.softmax(torch.randn((1001, 3), generator=gen, device="cuda"), dim=1)
        before = kernels.LAUNCHES["softmax_curvature"]
        hw, hwb = kernels.softmax_curvature(x, p)
        assert kernels.LAUNCHES["softmax_curvature"] == before + 1
        hp, bp = kernels.softmax_curvature_plain(x, p)
        assert float((hw - hp).abs().max()) <= 1e-5 * scale
        assert float((hwb - bp).abs().max()) <= 1e-5 * float(xf.abs().sum(0).max())


@pytest.mark.cuda
def test_knn_kernels_match_plain_versions_on_card():
    """On a CUDA card: dist_topk, probe_select and ivf_scan_select launch
    and agree bitwise with their plain versions on small-integer inputs
    (every product and sum exact in f32), at ragged shapes, ties included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen, device="cuda").float()

    for dtype in (torch.float32, torch.bfloat16):
        q, db = ints(300, 70).to(dtype), ints(5001, 70).to(dtype)
        ids = torch.randperm(5001, generator=gen, device="cuda").int()
        mask = (torch.rand(5001, generator=gen, device="cuda") < 0.9).float()
        before = kernels.LAUNCHES["dist_topk"]
        out = kernels.dist_topk(q, db, ids, mask, 10)
        assert kernels.LAUNCHES["dist_topk"] == before + 1
        ref = kernels.dist_topk_plain(q, db, ids, mask, 10)
        assert all(bool((a == b).all()) for a, b in zip(out, ref))
        qv, rows = ints(7, 130, 33).to(dtype), ints(7, 301, 33).to(dtype)
        r2 = (rows.float() ** 2).sum(2)
        r2[2, 4:] = 1e30
        out = kernels.ivf_scan_select(qv, rows, r2, 12)
        ref = kernels.ivf_scan_select_plain(qv, rows, r2, 12)
        assert all(bool((a == b).all()) for a, b in zip(out, ref))
    cent, qs = ints(1000, 40), ints(513, 40)
    out = kernels.probe_select(cent, qs, 20)
    ref = kernels.probe_select_plain(cent, qs, 20)
    assert all(bool((a == b).all()) for a, b in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("d, n", [(8, 20001), (1000, 20001), (1024, 9001), (1024, 37)])
def test_weighted_tensor_core_matches_plain_versions_on_card(d, n):
    """On a CUDA card: bf16 newton_stats and softmax_curvature with
    d % 8 == 0 take the tensor-core route. softmax_curvature agrees
    BITWISE with its plain version on small-integer rows with dyadic
    weights p in {0, 1/4, 1/2, 1} (bf16(x·bf16(p)) exact, every sum an
    exact multiple of 1/4), for C in {1, 3, 32}; newton_stats' Hessian,
    whose operand is bf16(x·bf16(wgt)), within 2⁻⁸ of the plain version's
    largest Σ|terms|, its gradient and borders within 1e-5 (f32 on both);
    float32 rows stay on the FFMA route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(d + n)
    x = torch.randint(-3, 4, (n, d), generator=gen, device="cuda").to(torch.bfloat16)
    quarters = torch.tensor([0.0, 0.25, 0.5, 1.0], device="cuda")
    for c in (1, 3, 32):
        p = quarters[torch.randint(0, 4, (n, c), generator=gen, device="cuda")]
        before = kernels.ROUTES["softmax_curvature/wgmma"]
        got = kernels.softmax_curvature(x, p)
        assert kernels.ROUTES["softmax_curvature/wgmma"] == before + 1
        want = kernels.softmax_curvature_plain(x, p)
        assert all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    xg = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    y = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
    mask = (torch.rand((n,), generator=gen, device="cuda") < 0.7).float()
    w = torch.randn((d,), generator=gen, device="cuda") / d ** 0.5
    b = torch.tensor(0.3, device="cuda")
    before = kernels.ROUTES["newton_stats/wgmma"]
    out = kernels.newton_stats(xg, y, mask, w, b)
    assert kernels.ROUTES["newton_stats/wgmma"] == before + 1
    ref = kernels.newton_stats_plain(xg, y, mask, w, b)
    xf = xg.float()
    p1 = torch.sigmoid(xf @ w + b)
    wgt = torch.clamp(p1 * (1 - p1), min=1e-10) * mask
    assert float((out[2] - ref[2]).abs().max()) <= 2.0 ** -8 * float((xf * xf * wgt[:, None]).sum(0).max())
    scale = float((xf.abs() * mask[:, None]).sum(0).max())
    assert float((out[0] - ref[0]).abs().max()) <= 1e-5 * scale
    assert float((out[3] - ref[3]).abs().max()) <= 1e-5 * scale
    before = kernels.ROUTES["newton_stats/ffma"]
    kernels.newton_stats(xg.float(), y, mask, w, b)
    assert kernels.ROUTES["newton_stats/ffma"] == before + 1


@pytest.mark.cuda
def test_daemon_fits_on_the_card():
    """A short fit through the port's daemon on the card (bf16 compute, the
    tensor-core gram_colsum), against float64 on the same bf16-rounded
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    rng = np.random.default_rng(3)
    d = 64
    x = (rng.normal(size=(4096, d)) * np.linspace(3, 0.1, d)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # exact in bf16
    with config.option("compute_dtype", "auto"), config.option("accum_dtype", "float32"):
        kernels.reset_launches()
        with DataPlaneDaemon() as d_, DataPlaneClient(*d_.address) as c:
            for pid, part in enumerate(np.array_split(x, 4)):
                c.feed_raw("card", part, partition=pid)
                c.commit("card", partition=pid)
            out = c.finalize_pca("card", k=4)
    assert kernels.LAUNCHES["gram_colsum"] == 4
    x64 = x.astype(np.float64)
    ref = port_pca._finalize_on_host(x.shape[0], x64.sum(0), x64.T @ x64, True, 4)
    np.testing.assert_allclose(np.abs(out["pc"]), np.abs(ref[0]), atol=1e-3)


_CARD_RANK = """
import sys, numpy as np, torch
from spark_rapids_ml_tpu_torch.models.pca import fit_pca_stream
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.parallel import distributed
rank, port = int(sys.argv[1]), sys.argv[2]
distributed.initialize_cluster(f"127.0.0.1:{port}", 2, rank, backend="gloo")
x = (np.random.default_rng(7).integers(-3, 4, size=(4096, 64)) * np.arange(64, 0, -1)
     ).astype(np.float32)  # exact in bf16, a spread spectrum
lo, hi = distributed.process_local_rows(4096)
parts = np.array_split(x[lo:hi], 3 if rank == 0 else 2)
sol = fit_pca_stream([torch.from_numpy(p).cuda() for p in parts], k=4, n_cols=64,
                     mesh=distributed.global_mesh())
print(kernels.LAUNCHES["gram_colsum"], sol.n_rows, repr(sol.pc.tobytes().hex()))
distributed.shutdown_cluster()
"""


@pytest.mark.cuda
def test_two_gloo_ranks_fit_on_the_card():
    """Two ranks on the one card (gloo: NCCL refuses two ranks on one
    device) stream integer rows through the tensor-core gram_colsum: one
    launch per non-empty batch on each rank, the same components on both,
    and those of float64 PCA of all rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _CARD_RANK, str(r), str(port)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    got = [o[0].split() for o in outs]
    assert [g[0] for g in got] == ["3", "2"] and {g[1] for g in got} == {"4096"}
    assert got[0][2] == got[1][2]
    pc = np.frombuffer(bytes.fromhex(got[0][2].strip("'")), dtype=np.float64).reshape(64, 4)
    x = (np.random.default_rng(7).integers(-3, 4, size=(4096, 64)) * np.arange(64, 0, -1)
         ).astype(np.float64)
    ref = port_pca._finalize_on_host(4096, x.sum(0), x.T @ x, True, 4)
    np.testing.assert_allclose(np.abs(pc), np.abs(ref[0]), atol=1e-3)
