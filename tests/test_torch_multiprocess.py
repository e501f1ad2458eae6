"""The port's fits across processes: one two-rank gloo world on the CPU.

``tests/torch_multiproc_worker.py`` runs in two OS processes joined by the
port's ``initialize_cluster`` (gloo, CPU tensors), spawned ONCE for the
module. Each rank feeds only its own rows of the 603 x 16 dataset of
``tests/multiproc_worker.py`` (``process_local_rows``; uneven stream batch
counts 3 / 2) in float64 and pickles what it got. The tests hold:

* ``fit_pca`` and ``fit_pca_stream`` to the JAX ``fit_pca`` of all rows on
  ``mesh8`` (|pc| atol 1e-8, explained variance atol 1e-10, the
  tolerances of tests/test_multiprocess.py);
* ``fit_linear_regression`` to the JAX fit of all rows (rtol 1e-9);
* ``fit_kmeans_stream`` (seed 0) and the two logistic streams to the JAX
  single-process streams of all rows (1e-8): the two-rank k-means init
  sample is the whole data in rank order, so the init is the same;
* exact kNN to the JAX single-process model (ids equal, SQUARED distances
  atol 1e-12: a query's distance to its own row is the square root of a
  float64 cancellation of ~1e-16 in both packages, which the square root
  turns into ~3e-8 in one and 0 in the other), also with rows duplicated
  across the ranks (ties to the lowest id);
* integer rows: the reduced Gram state bitwise equal to the one-process
  port's fold;
* the collectives against numpy, rank-0-only checkpoints and resume, and
  the error cases raising on BOTH ranks (each rank runs under a time limit
  and is killed past it, so a hang fails the module instead of stalling it).
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_ledger_off

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, K = 603, 16, 3
RANK_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("torch_world"))
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_multiproc_worker.py"),
             str(r), str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank hung past {RANK_TIMEOUT_S} s")
        outs.append((p.returncode, err))
    for rc, err in outs:
        assert rc == 0, f"rank failed rc={rc}\nstderr={err.decode()[-3000:]}"
    res = []
    for r in range(2):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(N, D)) * np.logspace(0, -1.0, D)


def _labels(x):
    y_bin = (x @ np.linspace(-1, 1, D) > 0).astype(np.float64)
    y_mn = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5]).astype(np.float64)
    return y_bin, y_mn


def _same_on_both(ranks, key):
    a, b = ranks[0][key], ranks[1][key]
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    return a


def test_world_is_two_gloo_ranks(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" and r["size"] == 2 for r in ranks)


@pytest.mark.parametrize("key", ["pca", "pca_stream"])
def test_pca_across_ranks_matches_jax_fit_of_all_rows(ranks, mesh8, key):
    from spark_rapids_ml_tpu.models.pca import fit_pca

    with jax_ledger_off():
        ref = fit_pca(_data(), k=K, mean_center=True, mesh=mesh8)
    pc, ev, n_rows = _same_on_both(ranks, key)
    assert n_rows == N
    np.testing.assert_allclose(np.abs(pc), np.abs(ref.pc), atol=1e-8)
    np.testing.assert_allclose(ev, ref.explained_variance, atol=1e-10)


def test_linear_regression_across_ranks_matches_jax(ranks, mesh8):
    from spark_rapids_ml_tpu.models.linear_regression import fit_linear_regression

    x = _data()
    y = x @ np.linspace(-2, 2, D) + 1.0 + 0.1 * np.random.default_rng(1).normal(size=N)
    with jax_ledger_off():
        ref = fit_linear_regression(x, y, mesh=mesh8)
    coef, intercept, n_rows = _same_on_both(ranks, "linreg")
    assert n_rows == N
    np.testing.assert_allclose(coef, ref.coefficients, rtol=1e-9)
    np.testing.assert_allclose(intercept, ref.intercept, rtol=1e-9)


def test_kmeans_stream_across_ranks_matches_jax_single_process(ranks):
    from spark_rapids_ml_tpu.models.kmeans import fit_kmeans_stream

    x = _data().astype(np.float32)
    with jax_ledger_off():
        ref = fit_kmeans_stream(lambda: iter(np.array_split(x, 5)), k=3, n_cols=D,
                                max_iter=5, seed=0)
    centers, cost, n_iter, n_rows = _same_on_both(ranks, "kmeans")
    assert n_rows == N and n_iter == ref.n_iter
    np.testing.assert_allclose(centers, ref.centers, atol=1e-8)
    np.testing.assert_allclose(cost, ref.cost, rtol=1e-8)


@pytest.mark.parametrize("key", ["logistic", "multinomial"])
def test_logistic_streams_across_ranks_match_jax_single_process(ranks, key):
    from spark_rapids_ml_tpu.models import logistic_regression as jlg

    x = _data()
    y_bin, y_mn = _labels(x)

    def labeled(y):
        return lambda: iter(zip(np.array_split(x.astype(np.float32), 4), np.array_split(y, 4)))

    with jax_ledger_off():
        if key == "logistic":
            ref = jlg.fit_logistic_stream(labeled(y_bin), n_cols=D, reg=1e-3, max_iter=8)
        else:
            ref = jlg.fit_multinomial_stream(labeled(y_mn), n_cols=D, n_classes=3, reg=1e-3,
                                             max_iter=6)
    coef, intercept, n_rows = _same_on_both(ranks, key)
    assert n_rows == N
    np.testing.assert_allclose(coef, ref.coefficients, atol=1e-8)
    np.testing.assert_allclose(intercept, ref.intercept, atol=1e-8)


@pytest.mark.parametrize("key", ["knn", "knn_dup"])
def test_exact_knn_across_ranks_matches_jax(ranks, key):
    import jax

    from spark_rapids_ml_tpu.models.knn import NearestNeighbors
    from spark_rapids_ml_tpu.parallel.mesh import make_mesh

    x = _data()
    if key == "knn":
        db, queries, k = x, x[:7], 5
    else:  # rank 1 repeats rank 0's first 40 rows: every query ties across ranks
        db, queries, k = np.concatenate([x[:40], x[40:60], x[:40], x[60:80]]), x[:9], 4
    # A mesh of its own (devices 6-7): the JAX query program is cached per
    # (mesh, k, ...), and one that another test primed ahead of time calls
    # jax.core.trace_state_clean, which jax 0.9 no longer has.
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[6:8])
    with jax_ledger_off():
        ref_d, ref_i = (NearestNeighbors(mesh=mesh).setK(k).fit({"features": db})
                        .kneighbors(queries))
    dists, idx = _same_on_both(ranks, key)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(dists ** 2, ref_d ** 2, atol=1e-12)
    if key == "knn_dup":
        assert (idx[:, 0] == np.arange(9)).all() and (idx[:, 1] == 60 + np.arange(9)).all()


def test_integer_rows_reduce_bitwise_to_the_one_process_fold(ranks):
    from spark_rapids_ml_tpu_torch import config
    from spark_rapids_ml_tpu_torch.ops import gram as gram_ops

    irows = np.random.default_rng(5).integers(-3, 4, size=(640, 24)).astype(np.float32)
    with config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"):
        state = gram_ops.init_stats(24, device="cpu")
        for b in np.array_split(irows, 5):
            gram_ops.streaming_update_rows(state, torch.from_numpy(b), b.shape[0])
    got = _same_on_both(ranks, "int_state")
    for g, want in zip(got, state):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, want.numpy())


def test_collectives_against_numpy(ranks):
    t = [np.arange(6, dtype=np.float64).reshape(2, 3) * (r + 1) for r in range(2)]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["reduce_sum"], t[0] + t[1])
        np.testing.assert_array_equal(res["all_concat"], np.concatenate(t, axis=1))
        np.testing.assert_array_equal(res["all_concat_stacked"], np.stack(t))
        np.testing.assert_array_equal(res["ring_swap"], t[1 - r])
        np.testing.assert_array_equal(res["ring_one_way"], t[0] if r == 1 else 0 * t[0])
        assert res["reduce_sum_bf16"][0] == "TypeError"
    pools = [r["pools"] for r in ranks]
    d = np.concatenate([p[0] for p in pools], axis=1)
    i = np.concatenate([p[1] for p in pools], axis=1)
    order = np.lexsort((i, d), axis=-1)[:, :4]  # (distance, id), ties to the lowest id
    want = (np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1))
    for res in ranks:
        np.testing.assert_array_equal(res["reduce_topk"][0], want[0])
        np.testing.assert_array_equal(res["reduce_topk"][1], want[1])
    # Rows padded at each rank's tail to the larger count, the global count.
    assert ranks[0]["shard_rows"] == ((302, D), "torch.float32", 302, N)
    assert ranks[1]["shard_rows"] == ((302, D), "torch.float32", 301, N)


def test_rank_zero_checkpoints_and_resume(ranks, mesh8):
    from spark_rapids_ml_tpu.models.pca import fit_pca

    with jax_ledger_off():
        ref = fit_pca(_data(), k=K, mean_center=True, mesh=mesh8)
    for res in ranks:
        assert res["preempted"] == ("RuntimeError", "preempted")
        assert res["ckpt_after_preempt"] and not res["ckpt_after_success"]
        pc, n_rows = res["resumed"]
        assert n_rows == N
        np.testing.assert_allclose(np.abs(pc), np.abs(ref.pc), atol=1e-8)
    # Rank 0 wrote after its one step before the preemption and after each
    # of the two steps it resumed with (checkpoint_every=1); rank 1 never.
    assert [r["ckpt_writes"] for r in ranks] == [3, 0]


def test_checkpoint_visible_on_one_rank_raises_on_both(ranks):
    for res in ranks:
        assert res["visibility"] == (
            "RuntimeError",
            "checkpoint visible on some hosts but not others; "
            "checkpoint_path must be on a shared filesystem",
        )


def test_lockstep_errors_raise_on_both_ranks(ranks):
    for res in ranks:
        assert res["dtype_mismatch"][0] == "TypeError"
        assert "disagree on batch dtype" in res["dtype_mismatch"][1]
    # The bad rank raises its own message, the other the carried flag.
    assert ranks[1]["bad_label"][0] == "ValueError"
    assert ranks[1]["bad_label"][1].startswith("labels must be binary 0/1 for the streaming path")
    assert ranks[0]["bad_label"] == ("ValueError", "batch validation failed on process 1")
    assert ranks[1]["uncastable"][0] == "ValueError"
    assert "is not castable to float32" in ranks[1]["uncastable"][1]
    assert ranks[0]["uncastable"] == ("ValueError", "batch validation failed on process 1")
    assert ranks[0]["bad_width"] == ("ValueError", f"batch has shape (302, {D - 1}), "
                                                   f"expected (m, {D})")
    assert ranks[1]["bad_width"] == ("ValueError", "batch validation failed on process 0")


@pytest.mark.parametrize("key,feature", [
    ("refuse_kmeans", "fit_kmeans"),
    ("refuse_logreg", "fit_logistic_regression"),
    ("refuse_forest", "fit_random_forest"),
])
def test_single_process_fits_refuse_on_both_ranks(ranks, key, feature):
    for res in ranks:
        kind, msg = res[key]
        assert kind == "NotImplementedError"
        assert msg.startswith(f"{feature} (") and "single-controller only" in msg
