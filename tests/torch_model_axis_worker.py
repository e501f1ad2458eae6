"""One rank of the four-rank gloo world of tests/test_torch_model_axis.py.

Run as ``python tests/torch_model_axis_worker.py RANK PORT OUTDIR``: the rank
joins the world through the port's ``initialize_cluster`` on the CPU, builds
the 2 x 2, 1 x 4 and 4 x 1 meshes (every rank in the same order), runs the
collectives, the feature-sharded Gram, the 2-D ``fit_pca`` route, the stream,
the capacity path and the sharded IVF index on each, and pickles what it got
to ``OUTDIR/rank{RANK}.pkl``. The IVF indexes come from ``OUTDIR/ivf.npz``
(built by the test in a world of one). The expected failures are caught and
recorded as (type, message). It imports only the port, never the JAX package.
"""

import os
import pickle
import sys

#: The rows every mesh fits: the same seeds as the test's references.
N, D, K = 203, 16, 4
STATS_ROWS = 101
BIG_D, BIG_N, BIG_K = 8192, 256, 4


def _err(fn):
    try:
        fn()
    except Exception as e:  # recorded for the test's assertions
        return type(e).__name__, str(e)
    return None


def pca_rows():
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.normal(size=(N, D)) * np.logspace(0, -1.0, D) + 0.5


def big_rows():
    import numpy as np

    rng = np.random.default_rng(8)
    scale = np.exp(-np.arange(BIG_D) / 64.0) + 1e-3
    return rng.standard_normal((BIG_N, BIG_D)) * scale


def budget_rows():
    import numpy as np

    d = 128
    scale = np.exp(-np.arange(d) / 8.0)
    return np.random.default_rng(42).standard_normal((1024, d)) * scale


def data_split(x, mesh):
    """The rows of this rank's data index: split i of ``data`` (every rank
    of a data index passes the same rows at full width)."""
    import numpy as np

    return np.array_split(x, mesh.shape["data"])[mesh.coords[0]]


def main() -> None:
    rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from spark_rapids_ml_tpu_torch import config
    from spark_rapids_ml_tpu_torch.models import kmeans as km
    from spark_rapids_ml_tpu_torch.models import knn
    from spark_rapids_ml_tpu_torch.models import linear_regression as lr
    from spark_rapids_ml_tpu_torch.models import pca
    from spark_rapids_ml_tpu_torch.ops import eigh
    from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
    from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
    from spark_rapids_ml_tpu_torch.parallel.distributed import (
        global_mesh,
        initialize_cluster,
        shutdown_cluster,
    )
    from spark_rapids_ml_tpu_torch.parallel.sharding import shard_rows_2d

    initialize_cluster(f"127.0.0.1:{port}", 4, rank, device="cpu")
    # Every rank builds the meshes' groups in this order.
    meshes = {"2x2": global_mesh(model=2), "1x4": global_mesh(model=4), "4x1": global_mesh()}
    out = {"rank": rank, "meshes": {}}
    config.set("compute_dtype", "float64")
    config.set("accum_dtype", "float64")
    cpu = dict(device="cpu")
    x = pca_rows()

    for name, mesh in meshes.items():
        res = out["meshes"][name] = {
            "coords": mesh.coords,
            "ranks": {a: mesh.axis_ranks(a) for a in ("data", "model")},
        }
        # -- the collectives on each axis ------------------------------------
        t = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1)
        for axis in ("data", "model"):
            n = mesh.shape[axis]
            ring = [(i, (i + 1) % n) for i in range(n)]
            pool_d = torch.tensor([[0.5, 1.0, 2.0], [0.1, 0.1, 3.0]], dtype=torch.float64)
            pool_i = torch.tensor([[0, 1, 2], [3, 4, 5]]) + 10 * (3 - rank)
            res[axis] = {
                "reduce_sum": mr.reduce_sum(t.clone(), axis, mesh=mesh).numpy(),
                "all_concat": mr.all_concat(t, axis, axis=1, mesh=mesh).numpy(),
                "stacked": mr.all_concat(t, axis, tiled=False, mesh=mesh).numpy(),
                "ring": mr.ring_shift(t, axis, ring, mesh=mesh).numpy(),
                "one_way": mr.ring_shift(t, axis, [(0, n - 1)], mesh=mesh).numpy(),
                "reduce_topk": tuple(a.numpy() for a in
                                     mr.reduce_topk(pool_d, pool_i, 4, axis, mesh=mesh)),
                "host_concat": mr.host_concat(t, axis, mesh=mesh).numpy(),
            }

        # -- the feature-sharded Gram ---------------------------------------------
        rows = np.random.default_rng(3).normal(size=(STATS_ROWS, D))
        block, mask, n_true = shard_rows_2d(data_split(rows, mesh), mesh, **cpu)
        res["block"] = (tuple(block.shape), int(mask.sum()), n_true)
        count, colsum, slab = gram_ops.sharded_stats_ring(mesh)(block, mask)
        res["stats"] = (count.numpy(), colsum.numpy(), slab.numpy())
        # The model-sharded eigensolve against the randomized one of the
        # gathered Gram, same seed.
        full = mr.all_concat(slab, "model", axis=0, mesh=mesh)
        sharded = eigh.pca_from_gram_model_sharded(slab, K, mesh, seed=3)
        whole = eigh.pca_from_gram_randomized(full, K, seed=3)
        res["eig_sharded"] = tuple(a.numpy() for a in sharded)
        res["eig_whole"] = tuple(a.numpy() for a in whole)

        # -- fit_pca: every data index passes its rows at full width -----------
        local = data_split(x, mesh)
        sol = pca.fit_pca(local, k=K, mesh=mesh, **cpu)
        res["pca"] = (sol.pc, sol.explained_variance, sol.mean, sol.n_rows)
        sol = pca.fit_pca(local, k=K, mesh=mesh, solver="randomized", **cpu)
        res["pca_randomized"] = (sol.pc, sol.explained_variance, sol.n_rows)
        batches = np.array_split(local, 3)
        sol = pca.fit_pca_stream(iter(batches), k=K, n_cols=D, mesh=mesh, **cpu)
        res["pca_stream"] = (sol.pc, sol.explained_variance, sol.n_rows)

        # -- the other fits count each data index's rows once ----------------------
        y = x @ np.linspace(-2, 2, D) + 1.0
        lsol = lr.fit_linear_regression(local, data_split(y, mesh), mesh=mesh, **cpu)
        res["linreg"] = (lsol.coefficients, lsol.intercept, lsol.n_rows)
        ksol = km.fit_kmeans_stream(lambda: iter(np.array_split(local.astype(np.float32), 2)),
                                    k=3, n_cols=D, max_iter=4, seed=0, mesh=mesh, **cpu)
        res["kmeans"] = (ksol.centers, ksol.cost, ksol.n_rows)
        model = knn.NearestNeighbors(device="cpu", mesh=mesh).setK(5).fit({"features": local})
        res["knn"] = model.kneighbors(x[:7])

    # -- errors raised on every rank ----------------------------------------------
    m22 = meshes["2x2"]
    local = data_split(x, m22)
    short = local[:-1] if rank == 1 else local
    out["uneven_rows"] = _err(lambda: pca.fit_pca(short, k=K, mesh=m22, **cpu))
    narrow = local[:, :-2] if rank == 2 else local
    out["uneven_width"] = _err(lambda: pca.fit_pca(narrow, k=K, mesh=m22, **cpu))
    out["uneven_stream"] = _err(lambda: pca.fit_pca_stream(
        iter(np.array_split(short, 2)), k=K, n_cols=D, mesh=m22, **cpu))

    # -- the capacity path under a shrunk budget -----------------------------------
    real_budget = gram_ops.GRAM_DEVICE_BUDGET_BYTES
    gram_ops.GRAM_DEVICE_BUDGET_BYTES = 64 * 128 * 8
    try:
        xb = budget_rows()
        out["capacity"] = {
            name: (gram_ops.require_gram_capacity(128, mesh, accum_dtype="float64")
                   if name != "4x1" else _err(lambda mesh=mesh: gram_ops.require_gram_capacity(
                       128, mesh, accum_dtype="float64")))
            for name, mesh in meshes.items()
        }
        out["budget_4x1"] = _err(lambda: pca.fit_pca(data_split(xb, meshes["4x1"]), k=3,
                                                     mesh=meshes["4x1"], **cpu))
        for solver in ("full", "randomized"):
            sol = pca.fit_pca(data_split(xb, m22), k=3, mesh=m22, solver=solver, **cpu)
            out[f"budget_2x2_{solver}"] = (sol.pc, sol.explained_variance)
        out["budget_stream"] = _err(lambda: pca.fit_pca_stream(
            iter([data_split(xb, m22)]), k=3, n_cols=128, mesh=m22, **cpu))
    finally:
        gram_ops.GRAM_DEVICE_BUDGET_BYTES = real_budget

    # -- the d = 8192 float64 acceptance shape on 1 x 4 ----------------------------
    big = big_rows()
    m14 = meshes["1x4"]
    out["big_must_shard"] = gram_ops.require_gram_capacity(BIG_D, m14)
    out["big_4x1"] = _err(lambda: gram_ops.require_gram_capacity(BIG_D, meshes["4x1"]))
    sol = pca.fit_pca(big, k=BIG_K, mesh=m14, solver="randomized", **cpu)
    out["big"] = (sol.pc[:, 0], bool(np.isfinite(sol.pc).all()), sol.pc.shape, sol.n_rows)
    del big, sol

    # -- the sharded IVF index ----------------------------------------------------------
    config.set("compute_dtype", "float32")
    config.set("accum_dtype", "float32")
    arrays = np.load(os.path.join(outdir, "ivf.npz"))
    for tag in ("ivf24", "ivf30"):
        index = knn.IVFFlatIndex(centroids=arrays[f"{tag}_centroids"],
                                 lists=arrays[f"{tag}_lists"],
                                 list_ids=arrays[f"{tag}_list_ids"],
                                 list_mask=arrays[f"{tag}_list_mask"])
        queries = arrays[f"{tag}_queries"]
        k, nprobe = (10, 4) if tag == "ivf24" else (5, 5)
        for name in ("4x1", "2x2"):
            model = knn.ApproximateNearestNeighborsModel(index=index, device="cpu")
            model._set(k=k, nprobe=nprobe)
            plain = model.kneighbors(queries)
            model.shard_index(meshes[name])
            sharded = model.kneighbors(queries)
            copy = model.copy()
            out[f"{tag}_{name}"] = {
                "plain": plain, "sharded": sharded,
                "local_lists": int(model._shard[1][2].shape[0]),
                "copy": copy.kneighbors(queries),
                "copy_local_lists": int(copy._shard[1][2].shape[0]),
            }

    shutdown_cluster()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
