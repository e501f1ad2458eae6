"""The port's model axis: a (data, model) mesh of ranks, the feature-sharded
Gram, the 2-D ``fit_pca`` route, the capacity path and the sharded IVF index.

``tests/torch_model_axis_worker.py`` runs in four OS processes joined by the
port's ``initialize_cluster`` (gloo, CPU tensors), spawned ONCE for the
module; each builds the 2 x 2, 1 x 4 and 4 x 1 meshes of that one world,
runs every path on each in float64 (the IVF in float32) and pickles what it
got. The tests hold the ranks against the JAX package on its conftest meshes
(``mesh8``, ``mesh4x2``, ``mesh1``; x64, ledger off) with the JAX tests' own
tolerances:

* the ranks' coordinates against JAX's ``mesh.devices`` layout, and every
  collective on each axis against numpy;
* ``sharded_stats_ring`` against both of JAX's forms (``sharded_stats_2d``
  and ``_ring``) and against ``x.T @ x`` (atol 1e-10, ``tests/test_pca.py``);
* ``fit_pca`` (exact and randomized) and ``fit_pca_stream`` against JAX's
  fits on ``mesh8`` and ``mesh4x2`` (|pc| atol 1e-8, explained variance
  1e-10); the model-sharded eigensolve against the port's randomized one
  of the gathered Gram, same seed; linreg, KMeans and exact kNN on each
  mesh against JAX's fits on ``mesh8`` and ``mesh4x2``;
* the capacity gate's returns and messages, a shrunk-budget fit refused on
  model 1 and fitted on model 2 with both solvers, and the d = 8,192
  float64 shape on 1 x 4 (top PC |dot| > 0.99 against the SVD of the
  centred rows);
* the sharded IVF index against the unsharded port and JAX's sharded query
  on ``mesh8`` (24 lists padded; a copy of a 30-list index keeping its
  padding);
* errors raised on every rank, never a hang (each rank runs under a time
  limit and is killed past it).

The daemon's and the stream's refusals run in this process (a world of one).
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import knn as jk
from spark_rapids_ml_tpu.models import pca as jax_pca
from spark_rapids_ml_tpu.ops import gram as jax_gram
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.models import knn as pk
from spark_rapids_ml_tpu_torch.models import pca as port_pca
from spark_rapids_ml_tpu_torch.ops import gram as port_gram
from spark_rapids_ml_tpu_torch.parallel import mesh as port_mesh
from torch_port_helpers import jax_ledger_off

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_model_axis_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 150
SHAPES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
ENV = ("SRML_GRAM_DEVICE_BUDGET_MB", "SRML_TORCH_GRAM_DEVICE_BUDGET_MB")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ivf_arrays():
    """Two port IVF indexes built in this process (a world of one): the 24
    lists of tests/test_knn.py's sharded test, and its 30-list copy test."""
    rng = np.random.default_rng(42)
    centers = rng.normal(size=(24, 16)) * 8
    db = np.concatenate([c + rng.normal(size=(160, 16)) for c in centers]).astype(np.float32)
    qs = np.concatenate([c + rng.normal(size=(3, 16)) for c in centers]).astype(np.float32)
    db30 = rng.normal(size=(900, 8)).astype(np.float32)
    qs30 = rng.normal(size=(10, 8)).astype(np.float32)
    out = {}
    with config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"):
        for tag, rows, queries, nlist in (("ivf24", db, qs, 24), ("ivf30", db30, qs30, 30)):
            model = pk.ApproximateNearestNeighbors(device="cpu").setNlist(nlist).fit(
                {"features": rows})
            for name, arr in model.index._asdict().items():
                out[f"{tag}_{name}"] = np.asarray(arr)
            out[f"{tag}_queries"] = queries
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("torch_model_axis"))
    np.savez(os.path.join(outdir, "ivf.npz"), **_ivf_arrays())
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_model_axis_worker.py"),
             str(r), str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
        )
        for r in range(4)
    ]
    outs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank hung past {RANK_TIMEOUT_S} s")
        outs.append((p.returncode, err))
    for rc, err in outs:
        assert rc == 0, f"rank failed rc={rc}\nstderr={err.decode()[-3000:]}"
    res = []
    for r in range(4):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(autouse=True)
def _ledger_off():
    with jax_ledger_off():
        yield


def _axis_ranks(r, shape, axis):
    data, model = shape
    if axis == "data":
        return [d * model + r % model for d in range(data)]
    return [(r // model) * model + m for m in range(model)]


def _t(r):
    return np.arange(6, dtype=np.float64).reshape(2, 3) * (r + 1)


# ------------------------------ the mesh -------------------------------------


@pytest.mark.parametrize("name", list(SHAPES))
def test_rank_coordinates_follow_the_jax_layout(ranks, devices, name):
    from spark_rapids_ml_tpu.parallel.mesh import make_mesh as jax_make_mesh

    data, model = SHAPES[name]
    jmesh = jax_make_mesh(data=data, model=model, devices=devices[:4])
    for r, res in enumerate(ranks):
        want = tuple(int(v) for v in np.argwhere(jmesh.devices == devices[r])[0])
        got = res["meshes"][name]
        assert got["coords"] == want
        assert got["ranks"] == {a: _axis_ranks(r, SHAPES[name], a) for a in ("data", "model")}


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("axis", ["data", "model"])
def test_collectives_on_each_axis_equal_numpy(ranks, name, axis):
    for r, res in enumerate(ranks):
        got = res["meshes"][name][axis]
        peers = _axis_ranks(r, SHAPES[name], axis)
        n, pos = len(peers), peers.index(r)
        np.testing.assert_array_equal(got["reduce_sum"], sum(_t(p) for p in peers))
        np.testing.assert_array_equal(got["all_concat"], np.concatenate([_t(p) for p in peers], 1))
        np.testing.assert_array_equal(got["stacked"], np.stack([_t(p) for p in peers]))
        np.testing.assert_array_equal(got["host_concat"], np.concatenate([_t(p) for p in peers]))
        np.testing.assert_array_equal(got["ring"], _t(peers[(pos - 1) % n]))
        one_way = _t(peers[0]) if pos == n - 1 else np.zeros((2, 3))
        np.testing.assert_array_equal(got["one_way"], one_way)
        # Each pool padded to k = 4 with (+inf, the largest id), then merged.
        pad = np.iinfo(np.int64).max
        pool_d = np.tile(np.array([[0.5, 1.0, 2.0, np.inf], [0.1, 0.1, 3.0, np.inf]]), n)
        shift = [[10 * (3 - p)] * 3 + [0] for p in peers]  # the pad id is not shifted
        base = np.array([[0, 1, 2, pad], [3, 4, 5, pad]])
        pool_i = np.concatenate([base + sh for sh in shift], 1)
        order = np.lexsort((pool_i, pool_d), axis=-1)[:, :4]
        np.testing.assert_array_equal(got["reduce_topk"][0], np.take_along_axis(pool_d, order, 1))
        np.testing.assert_array_equal(got["reduce_topk"][1], np.take_along_axis(pool_i, order, 1))


def test_make_mesh_needs_a_divisible_world(ranks):
    # Every rank reached every mesh: the groups were built in one order.
    assert [res["rank"] for res in ranks] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="not divisible by model=3"):
        port_mesh.make_mesh(model=3)


# ------------------------------ the sharded Gram ------------------------------


def _stats_rows():
    return np.random.default_rng(3).normal(size=(worker.STATS_ROWS, worker.D))


@pytest.mark.parametrize("name", list(SHAPES))
def test_sharded_stats_equal_the_whole_gram(ranks, name):
    x = _stats_rows()
    data, model = SHAPES[name]
    d_local = worker.D // model
    rows = -(-worker.STATS_ROWS // data)
    for r, res in enumerate(ranks):
        m = r % model
        assert res["meshes"][name]["block"] == (
            (rows, d_local), len(np.array_split(x, data)[r // model]), worker.STATS_ROWS)
        count, colsum, slab = res["meshes"][name]["stats"]
        assert float(count) == worker.STATS_ROWS
        np.testing.assert_allclose(colsum, x.sum(0), atol=1e-10)
        np.testing.assert_allclose(slab, (x.T @ x)[m * d_local:(m + 1) * d_local], atol=1e-10)


@pytest.mark.parametrize("algo", ["2d", "ring"])
def test_sharded_stats_match_jax_on_mesh4x2(ranks, mesh4x2, algo):
    """The port's ring against JAX's all-gather (``2d``) and its ring."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spark_rapids_ml_tpu.parallel.sharding import pad_rows

    x = _stats_rows()
    xp, mask = pad_rows(x, 4)
    xs = jax.device_put(xp, NamedSharding(mesh4x2, P("data", "model")))
    ms = jax.device_put(mask, NamedSharding(mesh4x2, P("data")))
    fn = {"2d": jax_gram.sharded_stats_2d, "ring": jax_gram.sharded_stats_ring}[algo]
    jc, js, jg = (np.asarray(a) for a in fn(mesh4x2)(xs, ms))
    slabs = [ranks[r]["meshes"]["2x2"]["stats"] for r in (0, 1)]
    assert float(slabs[0][0]) == float(jc)
    np.testing.assert_allclose(slabs[0][1], js, atol=1e-10)
    np.testing.assert_allclose(np.concatenate([s[2] for s in slabs]), jg, atol=1e-10)


@pytest.mark.parametrize("name", list(SHAPES))
def test_model_sharded_eigensolve_equals_the_gathered_one(ranks, name):
    for res in ranks:
        got, want = res["meshes"][name]["eig_sharded"], res["meshes"][name]["eig_whole"]
        np.testing.assert_allclose(got[0], want[0], atol=1e-8)
        np.testing.assert_allclose(got[1], want[1], atol=1e-10)
        np.testing.assert_allclose(got[2], want[2], atol=1e-8)


# ------------------------------ fit_pca's 2-D route ----------------------------


@pytest.fixture(scope="module")
def jax_fits(mesh8, mesh4x2):
    x = worker.pca_rows()
    with jax_ledger_off():
        return {
            "mesh8": jax_pca.fit_pca(x, k=worker.K, mesh=mesh8),
            "mesh4x2": jax_pca.fit_pca(x, k=worker.K, mesh=mesh4x2),
            "stream": jax_pca.fit_pca_stream(iter(np.array_split(x, 6)), k=worker.K,
                                             n_cols=worker.D, mesh=mesh4x2),
        }


@pytest.mark.parametrize("name", ["2x2", "1x4"])
@pytest.mark.parametrize("ref", ["mesh8", "mesh4x2"])
def test_fit_pca_2d_matches_jax(ranks, jax_fits, name, ref):
    want = jax_fits[ref]
    for res in ranks:
        pc, ev, mean, n_rows = res["meshes"][name]["pca"]
        np.testing.assert_allclose(np.abs(pc), np.abs(want.pc), atol=1e-8)
        np.testing.assert_allclose(ev, want.explained_variance, atol=1e-10)
        np.testing.assert_allclose(mean, want.mean, atol=1e-12)
        assert n_rows == worker.N == want.n_rows


@pytest.mark.parametrize("name", list(SHAPES))
def test_fit_pca_randomized_and_stream_match_jax(ranks, jax_fits, name):
    # k + oversample covers d = 16: the subspace is all of it, so the
    # randomized solver is exact here.
    want = jax_fits["mesh8"]
    for res in ranks:
        pc, ev, n_rows = res["meshes"][name]["pca_randomized"]
        np.testing.assert_allclose(np.abs(pc), np.abs(want.pc), atol=1e-8)
        np.testing.assert_allclose(ev, want.explained_variance, atol=1e-10)
        pc, ev, n_rows = res["meshes"][name]["pca_stream"]
        np.testing.assert_allclose(np.abs(pc), np.abs(jax_fits["stream"].pc), atol=1e-8)
        np.testing.assert_allclose(ev, jax_fits["stream"].explained_variance, atol=1e-10)
        assert n_rows == worker.N


@pytest.mark.parametrize("ref", ["mesh8", "mesh4x2"])
def test_other_fits_count_each_data_index_once(ranks, request, ref):
    """linreg, the KMeans stream and exact kNN on every port mesh against
    JAX's fits of all the rows on ``mesh8`` and ``mesh4x2`` (its in-memory
    KMeans: the stream's batches must divide over its devices)."""
    from spark_rapids_ml_tpu.models import kmeans as jkm
    from spark_rapids_ml_tpu.models import linear_regression as jlr

    mesh = request.getfixturevalue(ref)
    x = worker.pca_rows()
    y = x @ np.linspace(-2, 2, worker.D) + 1.0
    lsol = jlr.fit_linear_regression(x, y, mesh=mesh)
    ksol = jkm.fit_kmeans(x.astype(np.float32), 3, max_iter=4, seed=0, mesh=mesh)
    nn_d, nn_i = jk.NearestNeighbors(mesh=mesh).setK(5).fit({"features": x}).kneighbors(x[:7])
    assert lsol.n_rows == ksol.n_rows == worker.N
    for res in ranks:
        for name in SHAPES:
            got = res["meshes"][name]
            np.testing.assert_allclose(got["linreg"][0], lsol.coefficients, rtol=1e-9)
            np.testing.assert_allclose(got["linreg"][1], lsol.intercept, rtol=1e-9)
            np.testing.assert_allclose(got["kmeans"][0], ksol.centers, rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(got["kmeans"][1], ksol.cost, rtol=1e-8)
            np.testing.assert_array_equal(got["knn"][1], nn_i)
            np.testing.assert_allclose(got["knn"][0], nn_d, rtol=1e-5, atol=1e-6)
            assert got["linreg"][2] == got["kmeans"][2] == worker.N


@pytest.mark.parametrize("key, match", [
    ("uneven_rows", "the ranks of data index 0 passed different \\(rows, width\\)"),
    ("uneven_width", "the ranks of data index 1 passed different \\(rows, width\\)"),
    ("uneven_stream", "the ranks of data index 0 passed different row counts"),
])
def test_model_group_disagreements_raise_on_every_rank(ranks, key, match):
    import re

    errs = {res[key] for res in ranks}
    assert len(errs) == 1, errs  # the same error on every rank
    kind, msg = errs.pop()
    assert kind == "ValueError" and re.search(match, msg), msg


# ------------------------------ the capacity path -------------------------------


def test_require_gram_capacity_returns_and_messages_as_jax(monkeypatch, mesh4x2, mesh1):
    budget = 64 * 128 * 8
    monkeypatch.setattr(jax_gram, "GRAM_DEVICE_BUDGET_BYTES", budget)
    monkeypatch.setattr(port_gram, "GRAM_DEVICE_BUDGET_BYTES", budget)
    p4x2 = port_mesh.Mesh(4, 2, port_mesh.SOLO)
    p1 = port_mesh.Mesh(1, 1, port_mesh.SOLO)
    for n_cols, pm, jm in ((128, p1, mesh1), (1024, p4x2, mesh4x2)):
        with pytest.raises(jax_gram.GramCapacityError) as jerr:
            jax_gram.require_gram_capacity(n_cols, jm, accum_dtype="float64")
        with pytest.raises(port_gram.GramCapacityError) as perr:
            port_gram.require_gram_capacity(n_cols, pm, accum_dtype="float64")
        assert str(perr.value) == str(jerr.value).replace(*ENV)
    for n_cols, pm, jm in ((128, p4x2, mesh4x2), (32, p1, mesh1)):
        want = jax_gram.require_gram_capacity(n_cols, jm, accum_dtype="float64")
        assert port_gram.require_gram_capacity(n_cols, pm, accum_dtype=torch.float64) is want
    monkeypatch.setattr(port_gram, "GRAM_DEVICE_BUDGET_BYTES", 0)
    assert port_gram.require_gram_capacity(1 << 20, p1) is False  # 0: unlimited


def test_ranks_refuse_on_model_1_and_fit_on_model_2(ranks, mesh1):
    with jax_ledger_off():
        ref = jax_pca.fit_pca(worker.budget_rows(), k=3, mesh=mesh1)
    for res in ranks:
        assert res["capacity"]["2x2"] is True and res["capacity"]["1x4"] is True
        kind, msg = res["capacity"]["4x1"]
        assert kind == "GramCapacityError" and "mesh_model_axis >= 2" in msg
        assert res["budget_4x1"][0] == "GramCapacityError"
        assert res["budget_stream"][0] == "GramCapacityError"
        assert "streaming accumulator" in res["budget_stream"][1]
        pc, ev = res["budget_2x2_full"]
        np.testing.assert_allclose(np.abs(pc), np.abs(ref.pc), atol=1e-8)
        np.testing.assert_allclose(ev, ref.explained_variance, atol=1e-10)
        pc, _ = res["budget_2x2_randomized"]
        dots = np.abs(np.sum(pc * ref.pc, axis=0))
        assert np.all(dots > 1 - 1e-6), dots


def test_d8192_fits_on_1x4_where_4x1_refuses(ranks):
    x = worker.big_rows()
    xc = x - x.mean(axis=0)
    top = np.linalg.svd(xc, full_matrices=False)[2][0]
    for res in ranks:
        assert res["big_must_shard"] is True
        assert res["big_4x1"][0] == "GramCapacityError"
        pc0, finite, shape, n_rows = res["big"]
        assert finite and shape == (worker.BIG_D, worker.BIG_K) and n_rows == worker.BIG_N
        assert abs(float(pc0 @ top)) > 0.99


def test_stream_over_budget_refuses_as_jax(monkeypatch, mesh8):
    monkeypatch.setattr(jax_gram, "GRAM_DEVICE_BUDGET_BYTES", 64 * 64 * 8)
    monkeypatch.setattr(port_gram, "GRAM_DEVICE_BUDGET_BYTES", 64 * 64 * 8)
    with pytest.raises(jax_gram.GramCapacityError, match="budget") as jerr:
        jax_pca.fit_pca_stream(iter([np.zeros((8, 128))]), k=2, n_cols=128, mesh=mesh8)
    with pytest.raises(port_gram.GramCapacityError, match="budget") as perr, \
            config.option("accum_dtype", jax_config.get("accum_dtype")):
        port_pca.fit_pca_stream(iter([np.zeros((8, 128))]), k=2, n_cols=128, device="cpu")
    assert str(perr.value) == str(jerr.value).replace(*ENV)


def test_daemon_job_over_budget_refuses_at_its_first_feed_as_jax(monkeypatch, mesh8):
    from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon

    monkeypatch.setattr(jax_gram, "GRAM_DEVICE_BUDGET_BYTES", 64 * 64 * 8)
    monkeypatch.setattr(port_gram, "GRAM_DEVICE_BUDGET_BYTES", 64 * 64 * 8)
    x = np.random.default_rng(0).standard_normal((16, 128)).astype(np.float32)
    msgs = []
    for server in (JaxDaemon(mesh=mesh8), DataPlaneDaemon(device="cpu")):
        with server, DataPlaneClient(*server.address) as c, \
                config.option("accum_dtype", jax_config.get("accum_dtype")):
            for algo in ("pca", "linreg"):
                y = np.zeros(16, np.float32) if algo == "linreg" else None
                with pytest.raises(RuntimeError, match="budget") as err:
                    c.feed_raw(f"big-{algo}", x, y, algo=algo, partition=0)
                msgs.append(str(err.value))
            # under-budget widths are untouched
            c.feed_raw("ok", x[:, :32], partition=0)
            c.commit("ok", partition=0, attempt=0)
    assert msgs[2:] == [m.replace(*ENV) for m in msgs[:2]]


# ------------------------------ the sharded IVF index ----------------------------


def _jax_ivf(arrays, tag, mesh, k, nprobe):
    index = jk.IVFFlatIndex(centroids=arrays[f"{tag}_centroids"], lists=arrays[f"{tag}_lists"],
                            list_ids=arrays[f"{tag}_list_ids"],
                            list_mask=arrays[f"{tag}_list_mask"])
    model = jk.ApproximateNearestNeighborsModel(index=index)
    model._set(k=k, nprobe=nprobe)
    with jax_config.option("compute_dtype", "float32"), \
            jax_config.option("accum_dtype", "float32"):
        model.shard_index(mesh)
        return model.kneighbors(arrays[f"{tag}_queries"])


@pytest.fixture(scope="module")
def ivf_arrays():
    return _ivf_arrays()


@pytest.mark.parametrize("name, local", [("4x1", 6), ("2x2", 12)])
def test_sharded_ivf_equals_unsharded_and_jax(ranks, ivf_arrays, mesh8, name, local):
    with jax_ledger_off():
        jd, ji = _jax_ivf(ivf_arrays, "ivf24", mesh8, 10, 4)
    for res in ranks:
        got = res[f"ivf24_{name}"]
        assert got["local_lists"] == local
        (pd, pi), (sd, si) = got["plain"], got["sharded"]
        np.testing.assert_array_equal(np.sort(si, 1), np.sort(pi, 1))
        np.testing.assert_allclose(np.sort(sd, 1), np.sort(pd, 1), rtol=1e-5)
        np.testing.assert_array_equal(np.sort(si, 1), np.sort(ji, 1))
        np.testing.assert_allclose(np.sort(sd, 1), np.sort(jd, 1), rtol=1e-5)
        np.testing.assert_array_equal(got["copy"][1], si)


@pytest.mark.parametrize("name, local", [("4x1", 8), ("2x2", 15)])
def test_sharded_ivf_copy_keeps_its_padding(ranks, ivf_arrays, mesh8, name, local):
    with jax_ledger_off():
        _, ji = _jax_ivf(ivf_arrays, "ivf30", mesh8, 5, 5)
    for res in ranks:
        got = res[f"ivf30_{name}"]
        assert got["local_lists"] == got["copy_local_lists"] == local
        np.testing.assert_array_equal(got["copy"][1], got["sharded"][1])
        np.testing.assert_array_equal(np.sort(got["sharded"][1], 1), np.sort(ji, 1))
        np.testing.assert_array_equal(np.sort(got["sharded"][1], 1), np.sort(got["plain"][1], 1))
