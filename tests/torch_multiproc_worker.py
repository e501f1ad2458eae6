"""One rank of the two-rank gloo world of tests/test_torch_multiprocess.py.

Run as ``python tests/torch_multiproc_worker.py RANK PORT OUTDIR``: the rank
joins the world through the port's ``initialize_cluster`` on the CPU,
feeds only its own rows (``process_local_rows``, uneven stream batch counts
3 / 2), runs every multi-process fit and collective of the port, and
pickles what it got to ``OUTDIR/rank{RANK}.pkl``. The expected failures
(lockstep errors, checkpoint visibility, the single-process refusals) are
caught and recorded as (type, message): the test asserts that both ranks
raised them. It imports only the port, never the JAX package.
"""

import os
import pickle
import sys


def _err(fn):
    try:
        fn()
    except Exception as e:  # recorded for the test's assertions
        return type(e).__name__, str(e)
    return None


def main() -> None:
    rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from spark_rapids_ml_tpu_torch import config
    from spark_rapids_ml_tpu_torch.core import checkpoint as ckpt
    from spark_rapids_ml_tpu_torch.models import kmeans as km
    from spark_rapids_ml_tpu_torch.models import knn
    from spark_rapids_ml_tpu_torch.models import linear_regression as lr
    from spark_rapids_ml_tpu_torch.models import logistic_regression as lg
    from spark_rapids_ml_tpu_torch.models import pca
    from spark_rapids_ml_tpu_torch.models.random_forest import fit_random_forest_classifier
    from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
    from spark_rapids_ml_tpu_torch.ops import kernels
    from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
    from spark_rapids_ml_tpu_torch.parallel.distributed import (
        global_mesh,
        initialize_cluster,
        process_local_rows,
        shutdown_cluster,
    )
    from spark_rapids_ml_tpu_torch.parallel.sharding import lockstep_batches, shard_rows

    got = initialize_cluster(f"127.0.0.1:{port}", 2, rank, device="cpu")
    mesh = global_mesh()
    out = {"rank": got, "backend": mesh.backend, "size": mesh.size}
    config.set("compute_dtype", "float64")
    config.set("accum_dtype", "float64")

    rng = np.random.default_rng(0)
    n, d, k = 603, 16, 3
    x = rng.normal(size=(n, d)) * np.logspace(0, -1.0, d)
    lo, hi = process_local_rows(n)
    local = x[lo:hi]
    n_batches = 3 if rank == 0 else 2
    cpu = dict(device="cpu")

    # -- the fits ------------------------------------------------------------
    sol = pca.fit_pca(local, k=k, mean_center=True, mesh=mesh, **cpu)
    out["pca"] = (sol.pc, sol.explained_variance, sol.n_rows)
    ssol = pca.fit_pca_stream(iter(np.array_split(local, n_batches)), k=k, n_cols=d,
                              mesh=mesh, **cpu)
    out["pca_stream"] = (ssol.pc, ssol.explained_variance, ssol.n_rows)

    w_lin = np.linspace(-2, 2, d)
    y_lin = x @ w_lin + 1.0 + 0.1 * np.random.default_rng(1).normal(size=n)
    lsol = lr.fit_linear_regression(local, y_lin[lo:hi], mesh=mesh, **cpu)
    out["linreg"] = (lsol.coefficients, lsol.intercept, lsol.n_rows)

    ksol = km.fit_kmeans_stream(
        lambda: iter(np.array_split(local.astype(np.float32), n_batches)),
        k=3, n_cols=d, max_iter=5, seed=0, mesh=mesh, **cpu)
    out["kmeans"] = (ksol.centers, ksol.cost, ksol.n_iter, ksol.n_rows)

    y_bin = (x @ np.linspace(-1, 1, d) > 0).astype(np.float64)
    y_mn = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5]).astype(np.float64)

    def labeled(y):
        return lambda: iter(zip(np.array_split(local.astype(np.float32), n_batches),
                                np.array_split(y[lo:hi], n_batches)))

    bsol = lg.fit_logistic_stream(labeled(y_bin), n_cols=d, reg=1e-3, max_iter=8,
                                  mesh=mesh, **cpu)
    out["logistic"] = (bsol.coefficients, bsol.intercept, bsol.n_rows)
    msol = lg.fit_multinomial_stream(labeled(y_mn), n_cols=d, n_classes=3, reg=1e-3,
                                     max_iter=6, mesh=mesh, **cpu)
    out["multinomial"] = (msol.coefficients, msol.intercept, msol.n_rows)

    model = knn.NearestNeighbors(device="cpu", mesh=mesh).setK(5).fit({"features": local})
    out["knn"] = model.kneighbors(x[:7])
    # Duplicated rows across ranks: rank 1 holds a copy of rank 0's first
    # 40 rows, so every query below ties across the ranks.
    dup = np.concatenate([x[:40], x[40:60]]) if rank == 0 else np.concatenate([x[:40], x[60:80]])
    model = knn.NearestNeighbors(device="cpu", mesh=mesh).setK(4).fit({"features": dup})
    out["knn_dup"] = model.kneighbors(x[:9])

    # -- integer rows: the reduced state, float32, through the kernel path --
    with config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"):
        irows = np.random.default_rng(5).integers(-3, 4, size=(640, 24)).astype(np.float32)
        ilo, ihi = process_local_rows(640)
        state = gram_ops.init_stats(24, device="cpu")
        kernels.reset_launches()
        for b in lockstep_batches(iter(np.array_split(irows[ilo:ihi], n_batches)), 24):
            gram_ops.streaming_update_rows(state, torch.from_numpy(b), b.shape[0], mesh=mesh)
        out["int_state"] = tuple(t.numpy().copy() for t in state)

    # -- the primitives ----------------------------------------------------------
    t = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1)
    out["reduce_sum"] = mr.reduce_sum(t.clone(), mesh=mesh).numpy()
    out["reduce_sum_bf16"] = _err(lambda: mr.reduce_sum(t.to(torch.bfloat16), mesh=mesh))
    out["all_concat"] = mr.all_concat(t, axis=1, mesh=mesh).numpy()
    out["all_concat_stacked"] = mr.all_concat(t, tiled=False, mesh=mesh).numpy()
    out["ring_swap"] = mr.ring_shift(t, "data", [(0, 1), (1, 0)], mesh=mesh).numpy()
    out["ring_one_way"] = mr.ring_shift(t, "data", [(0, 1)], mesh=mesh).numpy()
    # Per-rank (q, k) pools whose distances tie across the ranks.
    pool_d = torch.tensor([[0.5, 1.0, 2.0], [0.1, 0.1, 3.0]], dtype=torch.float64)
    pool_i = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int64) + 10 * (1 - rank)
    out["pools"] = (pool_d.numpy(), pool_i.numpy())
    out["reduce_topk"] = tuple(a.numpy() for a in mr.reduce_topk(pool_d, pool_i, 4, mesh=mesh))
    xs, ms, n_true = shard_rows(local, mesh, dtype=np.float32, device="cpu")
    out["shard_rows"] = (tuple(xs.shape), str(xs.dtype), int(ms.sum()), n_true)

    # -- rank-0 checkpoints and resume ---------------------------------------
    shared = os.path.join(outdir, "shared")
    os.makedirs(shared, exist_ok=True)
    path = os.path.join(shared, "pca.ckpt.npz")
    writes = []
    real_save = ckpt.save_state
    ckpt.save_state = lambda *a, **kw: (writes.append(a[0]), real_save(*a, **kw))

    def preempted():
        for i, b in enumerate(np.array_split(local, n_batches)):
            if i == 1:
                raise RuntimeError("preempted")
            yield b

    out["preempted"] = _err(lambda: pca.fit_pca_stream(
        preempted(), k=k, n_cols=d, mesh=mesh, checkpoint_path=path, checkpoint_every=1, **cpu))
    mr_barrier = mr.reduce_sum(torch.zeros(1), mesh=mesh)  # both ranks past the write
    del mr_barrier
    out["ckpt_after_preempt"] = os.path.exists(path)
    resumed = pca.fit_pca_stream(iter(np.array_split(local, n_batches)), k=k, n_cols=d,
                                 mesh=mesh, checkpoint_path=path, checkpoint_every=1, **cpu)
    mr.reduce_sum(torch.zeros(1), mesh=mesh)
    out["resumed"] = (resumed.pc, resumed.n_rows)
    out["ckpt_writes"] = len(writes)
    out["ckpt_after_success"] = os.path.exists(path)
    ckpt.save_state = real_save

    # A checkpoint that rank 0 sees and rank 1 does not: both ranks raise.
    own = os.path.join(outdir, f"rank{rank}.ckpt.npz")
    if rank == 0:
        state0 = gram_ops.init_stats(d, device="cpu")
        ckpt.save_state(own, {"count": state0[0].numpy(), "colsum": state0[1].numpy(),
                              "gram": state0[2].numpy()},
                        {"n_rows": 0, "n_batches": 0, "n_cols": d})
    out["visibility"] = _err(lambda: pca.fit_pca_stream(
        iter(np.array_split(local, n_batches)), k=k, n_cols=d, mesh=mesh,
        checkpoint_path=own, **cpu))

    # -- lockstep errors raise on every rank ----------------------------------
    def mixed_dtypes():
        yield local.astype(np.float32 if rank == 0 else np.float64)

    out["dtype_mismatch"] = _err(lambda: pca.fit_pca_stream(mixed_dtypes(), k=k, n_cols=d,
                                                             mesh=mesh, **cpu))
    bad = y_bin.copy()
    bad[hi - 1] = 2.0 if rank == 1 else bad[hi - 1]
    out["bad_label"] = _err(lambda: lg.fit_logistic_stream(labeled(bad), n_cols=d, max_iter=2,
                                                            mesh=mesh, **cpu))

    def uncastable():
        yield np.array([["a"] * d], dtype=object) if rank == 1 else local[:1]

    out["uncastable"] = _err(lambda: list(lockstep_batches(uncastable(), d)))
    out["bad_width"] = _err(lambda: pca.fit_pca_stream(
        iter([local[:, : d - 1] if rank == 0 else local]), k=k, n_cols=d, mesh=mesh, **cpu))

    # -- the single-process refusals --------------------------------------------
    out["refuse_kmeans"] = _err(lambda: km.fit_kmeans(local, 3, **cpu))
    out["refuse_logreg"] = _err(lambda: lg.fit_logistic_regression(local, y_bin[lo:hi], **cpu))
    out["refuse_forest"] = _err(lambda: fit_random_forest_classifier(local, y_bin[lo:hi], **cpu))

    mr.reduce_sum(torch.zeros(1), mesh=mesh)  # nobody leaves while the other still gathers
    shutdown_cluster()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
