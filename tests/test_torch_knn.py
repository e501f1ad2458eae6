"""The PyTorch port's nearest-neighbour slice against the JAX package, on
the CPU.

Both packages get the same numpy inputs. The JAX reference runs with its
jit ledger off and, for the IVF query, with ``ann_fused_scan="on"`` (its
Pallas probe and scan in interpret mode): the flow the port always takes
under float32 accumulators. The port runs with ``device="cpu"``, where the
kernels' wrappers take their plain versions. Ids must be identical on data
without near-ties (random normal rows); distances agree within 1e-5
relative (f32 sums in another order), 5e-4 where the scan's packed-key
floor reaches them (rerank off).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import knn as jk
from spark_rapids_ml_tpu_torch import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
    config,
)
from spark_rapids_ml_tpu_torch.convert import ann_model_from_jax, knn_model_from_jax
from spark_rapids_ml_tpu_torch.models import knn as pk
from spark_rapids_ml_tpu_torch.ops import kernels
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _f32_both():
    """float32 compute and accumulators in both packages (the JAX conftest
    defaults the JAX package to float64)."""
    with jax_ledger_off(), jax_config.option("compute_dtype", "float32"), \
            jax_config.option("accum_dtype", "float32"), \
            config.option("compute_dtype", "float32"), config.option("accum_dtype", "float32"):
        yield


@pytest.fixture
def data():
    rng = np.random.default_rng(31)
    return (rng.normal(size=(1024, 16)).astype(np.float32),
            rng.normal(size=(40, 16)).astype(np.float32))


@pytest.fixture
def ann_pair(data, mesh8):
    """A JAX IVF model (nlist 32) and the port's copy of its index."""
    db, _ = data
    jm = jk.ApproximateNearestNeighbors(mesh=mesh8).setK(10).setNlist(32).setNprobe(5).fit(
        {"features": db})
    pm = ann_model_from_jax(jm._model_data(), device="cpu")
    pm._set(k=10, nprobe=5)
    return jm, pm


def _fused(**opts):
    """Both packages' IVF options, the JAX scan forced onto its kernels."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax_config.option("ann_fused_scan", "on"))
    for key, value in opts.items():
        stack.enter_context(jax_config.option(key, value))
        stack.enter_context(config.option(key, value))
    return stack


# ---------------------------------------------------------------------------
# Exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine", "inner_product"])
def test_exact_kneighbors_matches_jax(data, mesh8, metric):
    db, qs = data
    ref = jk.NearestNeighbors(mesh=mesh8).setK(7).setMetric(metric).fit({"features": db})
    out = NearestNeighbors(device="cpu").setK(7).setMetric(metric).fit({"features": db})
    before = dict(kernels.LAUNCHES)
    d, i = out.kneighbors(qs)
    assert kernels.LAUNCHES == before  # plain versions on the CPU launch nothing
    rd, ri = ref.kneighbors(qs)
    assert i.dtype == np.int64 and i.shape == (40, 7)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, **TOL)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_exact_float64_two_step_matches_jax(data, mesh8, metric):
    db, qs = data
    with jax_config.option("compute_dtype", "float64"), jax_config.option("accum_dtype", "float64"), \
            config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        ref = jk.NearestNeighbors(mesh=mesh8).setK(5).setMetric(metric).fit({"features": db})
        out = NearestNeighbors(device="cpu").setK(5).setMetric(metric).fit({"features": db})
        d, i = out.kneighbors(qs)
        rd, ri = ref.kneighbors(qs)
    assert d.dtype == np.float64
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-12, atol=1e-12)


def test_exact_k_past_the_kernel_limit_takes_the_two_step(data, mesh8):
    db, qs = data
    ref = jk.NearestNeighbors(mesh=mesh8).setK(70).fit({"features": db})
    out = NearestNeighbors(device="cpu").setK(70).fit({"features": db})
    d, i = out.kneighbors(qs)
    rd, ri = ref.kneighbors(qs)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, **TOL)


def test_exact_ties_go_to_the_lowest_row(mesh8):
    db = np.repeat(np.eye(4, dtype=np.float32), 3, axis=0)  # each row three times
    qs = np.eye(4, dtype=np.float32)[[2, 0]]
    d, i = NearestNeighbors(device="cpu").setK(4).fit({"features": db}).kneighbors(qs)
    rd, ri = jk.NearestNeighbors(mesh=mesh8).setK(4).fit({"features": db}).kneighbors(qs)
    np.testing.assert_array_equal(i, ri)
    assert i[0].tolist()[:3] == [6, 7, 8]


def test_exact_cosine_zero_rows_match_jax(mesh8):
    rng = np.random.default_rng(32)
    db = rng.normal(size=(64, 5)).astype(np.float32)
    db[[3, 17]] = 0.0
    qs = rng.normal(size=(6, 5)).astype(np.float32)
    qs[2] = 0.0
    ref = jk.NearestNeighbors(mesh=mesh8).setK(6).setMetric("cosine").fit({"features": db})
    out = NearestNeighbors(device="cpu").setK(6).setMetric("cosine").fit({"features": db})
    d, i = out.kneighbors(qs)
    rd, ri = ref.kneighbors(qs)
    # A zero query is 1 from every row: its order is rounding, not data.
    real = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(i[real], ri[real])
    np.testing.assert_allclose(d, rd, **TOL)
    np.testing.assert_allclose(d[2], 1.0, atol=1e-6)
    assert {3, 17} & set(i[real].ravel()) == set()  # zero rows are 1 from real queries


def test_exact_metric_switch_rebuilds_the_index(data):
    db, qs = data
    model = NearestNeighbors(device="cpu").setK(3).fit({"features": db})
    _, i1 = model.kneighbors(qs)
    model._set(metric="cosine")
    _, i2 = model.kneighbors(qs)
    key = next(iter(model._index_cache))
    assert key[0] == "cosine" and len(model._index_cache) == 1
    ref = NearestNeighbors(device="cpu").setK(3).setMetric("cosine").fit({"features": db})
    np.testing.assert_array_equal(i2, ref.kneighbors(qs)[1])
    assert not np.array_equal(i1, i2)


def test_exact_k_validation_and_unfitted(data):
    db, qs = data
    model = NearestNeighbors(device="cpu").setK(3).fit({"features": db[:5]})
    with pytest.raises(ValueError, match="out of range"):
        model.kneighbors(qs, k=6)
    with pytest.raises(RuntimeError, match="unfitted"):
        NearestNeighborsModel(device="cpu").kneighbors(qs)


def test_exact_tensor_database_and_queries(data):
    db, qs = data
    a = NearestNeighbors(device="cpu").setK(4).fit({"features": db}).kneighbors(qs)
    b = NearestNeighbors(device="cpu").setK(4).fit(torch.from_numpy(db)).kneighbors(
        torch.from_numpy(qs))
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_exact_transform_adds_the_columns(data):
    db, qs = data
    model = NearestNeighbors(device="cpu").setK(2).fit({"features": db})
    out = model.transform({"features": qs})
    assert out["knn_distances"].shape == (40, 2) and out["knn_indices"].shape == (40, 2)


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(33)
    ds = [np.sort(rng.integers(0, 5, size=(6, k)).astype(np.float32), axis=1) for k in (3, 4)]
    ids = [rng.integers(0, 50, size=(6, k)) for k in (3, 4)]
    ds[1][:, -1] = np.inf
    ids[1][:, -1] = -1
    for desc in (False, True):
        out = pk.merge_topk(ds, ids, 5, descending=desc)
        ref = jk.merge_topk(ds, ids, 5, descending=desc)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_normalized_rows_match_jax():
    rng = np.random.default_rng(34)
    x = rng.normal(size=(9, 4)).astype(np.float32)
    x[4] = 0.0
    for slot in (0, 1):
        ref = jk._normalized_rows(x, zero_slot=slot)
        np.testing.assert_allclose(pk._normalized_rows(x, zero_slot=slot), ref, rtol=1e-6,
                                   atol=1e-7)
        t = pk._normalized_rows(torch.from_numpy(x), zero_slot=slot)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# IVF build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spill", [False, True])
def test_build_with_frozen_centroids_is_identical(data, spill):
    """The same quantizer gives the same lists and ids. With ``spill`` the
    centroids crowd one list past its cap, so the balancer runs on the
    dist_topk candidates."""
    db, _ = data
    rng = np.random.default_rng(35)
    cent = db[rng.choice(len(db), 16, replace=False)].copy()
    if spill:
        cent[:8] = db[:8] * 0.01  # eight centroids near the origin
    ref = jk.build_ivf_flat(db, 16, seed=3, centroids=cent)
    out = pk.build_ivf_flat(db, 16, seed=3, centroids=cent, device="cpu")
    np.testing.assert_array_equal(out.lists, ref.lists)
    np.testing.assert_array_equal(out.list_ids, ref.list_ids)
    np.testing.assert_array_equal(out.list_mask, ref.list_mask)
    if spill:
        assert out.lists.shape[1] <= pk._ivf_cap(len(db), 16)


def test_build_trains_the_same_quantizer(data, mesh8):
    """fit_kmeans in float64 in both packages: the same random init and
    Lloyd steps, so the same lists."""
    db, _ = data
    with jax_config.option("compute_dtype", "float64"), jax_config.option("accum_dtype", "float64"), \
            config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        ref = jk.build_ivf_flat(db, 24, seed=5, mesh=mesh8)
        out = pk.build_ivf_flat(db, 24, seed=5, device="cpu")
    np.testing.assert_allclose(out.centroids, ref.centroids, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out.list_ids, ref.list_ids)
    np.testing.assert_array_equal(out.lists, ref.lists)


def test_build_validates_its_inputs(data):
    db, _ = data
    with pytest.raises(ValueError, match="pretrained centroids"):
        pk.build_ivf_flat(db, 8, centroids=np.zeros((7, 16)), device="cpu")
    with pytest.raises(ValueError, match="train_rows"):
        pk.build_ivf_flat(db, 8, train_rows=4, device="cpu")
    with pytest.raises(ValueError, match="train_data"):
        pk.build_ivf_flat(db, 8, train_data=np.zeros((100, 3)), device="cpu")


def test_balance_assignments_matches_jax():
    rng = np.random.default_rng(36)
    cand = rng.integers(0, 6, size=(500, 3)).astype(np.int32)
    cand[:300, 0] = 2  # one hot list
    out = pk._balance_assignments(cand, 6, pk._ivf_cap(500, 6))
    np.testing.assert_array_equal(out, jk._balance_assignments(cand, 6, jk._ivf_cap(500, 6)))
    assert np.bincount(out, minlength=6).max() <= pk._ivf_cap(500, 6)


def test_residual_index_data_matches_jax(ann_pair):
    jm, pm = ann_pair
    idx = jm.index
    rn, lo = jk._residual_index_data(jnp.asarray(idx.lists), jnp.asarray(idx.centroids),
                                     jnp.float32)
    prn, plo = pk.residual_index_data(torch.from_numpy(np.asarray(idx.lists)),
                                      torch.from_numpy(np.asarray(idx.centroids)), torch.float32)
    np.testing.assert_allclose(prn.numpy(), np.asarray(rn), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(plo.numpy(), np.asarray(lo))


# ---------------------------------------------------------------------------
# IVF query
# ---------------------------------------------------------------------------


def _jax_bucket(probe, n_valid, nlist, C):
    """The JAX package's sort-free bucketing (models/knn.py:1027-1067),
    transcribed: bucket_q and pair_slot."""
    probe = jnp.asarray(probe, jnp.int32)
    q, nprobe = probe.shape
    n_pairs = q * nprobe
    S = 512
    n_seq = -(-n_pairs // S) * S
    seq_i = jnp.arange(n_seq, dtype=jnp.int32)
    r_seq = seq_i // q
    q_seq = (seq_i % q - r_seq * C) % q
    valid_seq = r_seq < nprobe
    l_seq = jnp.where(valid_seq, probe.reshape(-1)[jnp.where(valid_seq, q_seq * nprobe + r_seq, 0)],
                      -1)
    l_seq = jnp.where((l_seq >= 0) & (q_seq < n_valid), l_seq, nlist)
    ch = n_seq // S
    lc = l_seq.reshape(ch, S)
    tri = jnp.arange(S)[None, :] < jnp.arange(S)[:, None]
    within = jnp.sum((lc[:, :, None] == lc[:, None, :]) & tri[None], axis=2,
                     dtype=jnp.int32).reshape(-1)
    hist = jnp.zeros((ch, nlist + 1), jnp.int32).at[seq_i // S, l_seq].add(1)
    base = jnp.cumsum(hist, axis=0) - hist
    slot_seq = base[seq_i // S, l_seq] + within
    keep = (slot_seq < C) & (l_seq < nlist)
    bucket_q = (jnp.full((nlist, C), -1, jnp.int32)
                .at[jnp.where(keep, l_seq, nlist), jnp.where(keep, slot_seq, 0)]
                .set(q_seq, mode="drop"))
    qq = jnp.arange(q, dtype=jnp.int32)[:, None]
    rr = jnp.arange(nprobe, dtype=jnp.int32)[None, :]
    i_pair = rr * q + (qq + rr * C) % q
    return np.asarray(bucket_q), np.asarray(jnp.where(keep, slot_seq, -1)[i_pair])


@pytest.mark.parametrize("q, nprobe, nlist, slack, n_valid, hot", [
    (64, 4, 16, 1.5, 64, False),
    (128, 5, 32, 1.0, 100, True),   # correlated probes: drops, padding queries
    (256, 3, 8, 1e9, 200, False),   # C == q: nothing dropped
])
def test_bucket_pairs_match_jax(q, nprobe, nlist, slack, n_valid, hot):
    rng = np.random.default_rng(37)
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(q)]).astype(np.int32)
    if hot:
        probe[: q // 2, 0] = 3
        probe[5, 2] = -1  # a pair owned elsewhere
    C = pk._bucketed_capacity(q, nprobe, nlist, slack)
    assert C == jk._bucketed_capacity(q, nprobe, nlist, slack)
    bq, ps = pk.bucket_pairs(torch.from_numpy(probe), n_valid, nlist, C)
    ref_bq, ref_ps = _jax_bucket(probe, n_valid, nlist, C)
    np.testing.assert_array_equal(bq.numpy(), ref_bq)
    np.testing.assert_array_equal(ps.numpy(), ref_ps)
    if hot:
        assert (ps.numpy() < 0).sum() > 0


@pytest.mark.parametrize("rerank", [True, False])
def test_ann_kneighbors_matches_jax_fused(data, ann_pair, rerank):
    _, qs = data
    jm, pm = ann_pair
    with _fused(ann_rerank=rerank):
        rd, ri = jm.kneighbors(qs)
        before = dict(kernels.LAUNCHES)
        d, i = pm.kneighbors(qs)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5 if rerank else 5e-4, atol=1e-5)


@pytest.mark.parametrize("extract", ["narrow", "wide", "15"])
def test_ann_extract_widths_match_jax(data, ann_pair, extract):
    _, qs = data
    jm, pm = ann_pair
    with _fused(ann_extract=extract):
        rd, ri = jm.kneighbors(qs)
        d, i = pm.kneighbors(qs)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, **TOL)


def test_ann_correlated_queries_with_drops_match_jax(data, ann_pair):
    """Clustered queries overflow their lists' capacity: the evictions
    (rank-major, rotated within a rank) must be the JAX package's."""
    db, _ = data
    rng = np.random.default_rng(38)
    qs = (db[:3][rng.integers(0, 3, size=50)] + 0.01 * rng.normal(size=(50, 16))).astype(
        np.float32)
    jm, pm = ann_pair
    with _fused():
        rd, ri = jm.kneighbors(qs)
        d, i = pm.kneighbors(qs)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, **TOL)


def test_bucketed_matches_dense_without_drops(ann_pair):
    """With C == q no pair is dropped, so the bucketed executor finds the
    dense executor's neighbours (JAX test_ivf_bucketed_matches_dense_no_drops)."""
    _, pm = ann_pair
    idx = pm._ensure_dev_index(torch.device("cpu"))
    qs = torch.from_numpy(np.random.default_rng(39).normal(size=(64, 16)).astype(np.float32))
    dd, di = pk.ivf_query(idx, qs, 10, 8, torch.float32, torch.float32, mode="dense")
    bd, bi = pk.ivf_query(idx, qs, 10, 8, torch.float32, torch.float32, mode="bucketed",
                          slack=1e9)
    np.testing.assert_array_equal(np.sort(di.numpy(), 1), np.sort(bi.numpy(), 1))
    np.testing.assert_allclose(np.sort(dd.numpy(), 1), np.sort(bd.numpy(), 1), **TOL)


def test_dense_executor_matches_jax(ann_pair):
    jm, pm = ann_pair
    idx = jm.index
    qs = np.random.default_rng(40).normal(size=(64, 16)).astype(np.float32)
    fn = jk._ivf_query_fn(10, 8, "float32", "float32", mode="dense")
    rd, ri = fn(jnp.asarray(idx.centroids, jnp.float32), jnp.asarray(idx.lists),
                jnp.asarray(idx.list_ids), jnp.asarray(idx.list_mask), jnp.asarray(qs))
    d, i = pk.ivf_query(pm._ensure_dev_index(torch.device("cpu")), torch.from_numpy(qs), 10, 8,
                        torch.float32, torch.float32, mode="dense")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **TOL)


@pytest.mark.parametrize("rerank", [True, False])
def test_float64_flow_matches_jax_xla_scan(data, ann_pair, rerank):
    """float64 accumulators: the XLA flow (mult·k per slot, rerank width
    2·mult·k) in plain PyTorch, against the JAX package's fused="off"."""
    _, qs = data
    jm, pm = ann_pair
    idx = jm.index
    qp = np.concatenate([qs, np.zeros((24, 16), np.float32)])
    fn = jk._ivf_query_fn(10, 5, "float64", "float64", mode="bucketed", rerank=rerank,
                          fused="off")
    rd, ri = fn(jnp.asarray(idx.centroids, jnp.float32), jnp.asarray(idx.lists),
                jnp.asarray(idx.list_ids), jnp.asarray(idx.list_mask), jnp.asarray(qp),
                n_valid=40)
    before = dict(kernels.LAUNCHES)
    d, i = pk.ivf_query(pm._ensure_dev_index(torch.device("cpu")), torch.from_numpy(qp), 10, 5,
                        torch.float64, torch.float64, n_valid=40, rerank=rerank)
    assert kernels.LAUNCHES == before and d.dtype == torch.float64
    np.testing.assert_array_equal(i.numpy()[:40], np.asarray(ri)[:40])
    # Without rerank the answer carries the probe's f32 ‖q − c‖² term (both
    # packages' XLA probe is f32), whose sums run in another order.
    tol = 1e-9 if rerank else 2e-6
    np.testing.assert_allclose(d.numpy()[:40], np.asarray(rd)[:40], rtol=tol, atol=tol)


def test_ann_estimator_cosine_matches_jax(data, mesh8):
    db, qs = data
    with jax_config.option("compute_dtype", "float64"), jax_config.option("accum_dtype", "float64"), \
            config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        ref = jk.ApproximateNearestNeighbors(mesh=mesh8).setK(5).setNlist(16).setNprobe(3) \
            .setMetric("cosine").fit({"features": db})
        out = ApproximateNearestNeighbors(device="cpu").setK(5).setNlist(16).setNprobe(3) \
            .setMetric("cosine").fit({"features": db})
    np.testing.assert_array_equal(out.index.list_ids, ref.index.list_ids)
    with _fused():
        d, i = out.kneighbors(qs)
        rd, ri = ref.kneighbors(qs)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, **TOL)


def test_ann_inner_product_rejected(data):
    with pytest.raises(ValueError, match="inner_product"):
        ApproximateNearestNeighbors(device="cpu").setMetric("inner_product").fit(
            {"features": data[0]})


def test_ann_query_validation(ann_pair, data):
    _, pm = ann_pair
    with pytest.raises(ValueError, match="out of range"):
        pm.kneighbors(data[1], k=2000)
    with pytest.raises(RuntimeError, match="unfitted"):
        ApproximateNearestNeighborsModel(device="cpu").kneighbors(data[1])
    with pytest.raises(ValueError, match="ann_extract"):
        with config.option("ann_extract", "bogus"):
            pm.kneighbors(data[1])


def test_ann_resid_cache_is_keyed_by_compute_dtype(ann_pair, data):
    _, pm = ann_pair
    pm.kneighbors(data[1])
    assert pm._resid_data[1] == torch.float32
    with config.option("compute_dtype", "bfloat16"):
        pm.kneighbors(data[1])
    assert pm._resid_data[1] == torch.bfloat16 and pm._resid_data[3].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Persistence and conversion
# ---------------------------------------------------------------------------


def test_exact_save_load_across_packages(data, mesh8, tmp_path):
    db, qs = data
    port = NearestNeighbors(device="cpu").setK(4).setMetric("sqeuclidean").fit({"features": db})
    port.save(str(tmp_path / "port"))
    back_jax = jk.NearestNeighborsModel.load(str(tmp_path / "port"))
    assert back_jax.getK() == 4 and back_jax.getMetric() == "sqeuclidean"
    np.testing.assert_array_equal(back_jax.database.astype(np.float32), db)
    back_jax.save(str(tmp_path / "jax"))
    back = NearestNeighborsModel.load(str(tmp_path / "jax"))
    back._device = "cpu"
    assert back.uid == port.uid and back.getK() == 4
    np.testing.assert_array_equal(back.kneighbors(qs)[1], port.kneighbors(qs)[1])


def test_ann_save_load_across_packages(data, ann_pair, tmp_path):
    _, qs = data
    jm, pm = ann_pair
    pm.save(str(tmp_path / "port"))
    back_jax = jk.ApproximateNearestNeighborsModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back_jax.index.list_ids, pm.index.list_ids)
    assert back_jax.getNprobe() == 5
    back_jax.save(str(tmp_path / "jax"))
    back = ApproximateNearestNeighborsModel.load(str(tmp_path / "jax"))
    back._device = "cpu"
    assert back._index_metric == "euclidean"
    np.testing.assert_array_equal(back.kneighbors(qs)[1], pm.kneighbors(qs)[1])


def test_convert_functions_carry_the_arrays(data, mesh8, ann_pair):
    db, qs = data
    ref = jk.NearestNeighbors(mesh=mesh8).setK(3).fit({"features": db})
    model = knn_model_from_jax(ref._model_data(), device="cpu")
    model._set(k=3)
    np.testing.assert_array_equal(model.kneighbors(qs)[1], ref.kneighbors(qs)[1])
    jm, pm = ann_pair
    for a, b in zip(pm.index, jm.index):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pm._index_metric == "euclidean" and pm._device == "cpu"


def test_metric_guard_after_load(data, tmp_path):
    db, qs = data
    model = ApproximateNearestNeighbors(device="cpu").setK(3).setNlist(8).setNprobe(2) \
        .setMetric("cosine").fit({"features": db})
    model.save(str(tmp_path / "m"))
    back = ApproximateNearestNeighborsModel.load(str(tmp_path / "m"))
    back._device = "cpu"
    assert back._index_metric == "cosine"
    back._set(metric="euclidean")
    with pytest.raises(ValueError, match="built under metric='cosine'"):
        back.kneighbors(qs)
    back._set(metric="cosine")
    np.testing.assert_array_equal(back.kneighbors(qs)[1], model.kneighbors(qs)[1])
