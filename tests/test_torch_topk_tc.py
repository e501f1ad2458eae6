"""The tensor-core exact top-k and the fused IVF probe of the PyTorch port
on the CPU.

``dist_topk_tc_kernel`` and ``probe_fused_kernel``
(``spark_rapids_ml_tpu_torch/ops/csrc/knn.cu``) run on a card only;
``chip_smoke.py`` phase 2 holds them against the plain versions there,
bitwise. Here, without a card, numpy emulations of their decompositions
against the Pallas kernels in interpret mode and the plain versions, on
the same small-integer inputs (every product and score exact):

* dist_topk: 64-bit keys (the ordered f32 bits of the distance over
  ``id ^ 0x80000000``); per (db split, 128-query tile) task, chunks of 256
  rows, each query's two per-lane lists (four columns of every 8-column
  group each) filled in rounds (16 columns scored, those below the
  threshold set aside, then keyed and inserted), merged at the end of the
  task; the splits' lists merged, each finite distance recomputed in f32
  and the k smallest re-sorted by (distance, id);
* probe_select: each half of a query tile's four blocks keys its
  centroid tiles, sorts each query's 128 keys with the warp's bitonic
  network and merges them into its list for the query; the eight lists
  merged by the tile's last block;
* the routes, the shared-memory plans, and the exact index's cached norms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_kernels import dist_topk_pallas, probe_select_pallas
from spark_rapids_ml_tpu_torch.models import knn
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops import selection as sel
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

EMPTY = (1 << 64) - 1
INF_HI = 0xFF800000


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


def _ints(rng, *shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The 64-bit key
# ---------------------------------------------------------------------------


def _ordered_bits(d):
    """knn.cu's ordered_bits: the f32 bits as an unsigned word in the
    values' order (the sign bit of non-negatives flipped, every bit of
    negatives)."""
    b = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b >> 31, b ^ 0xFFFFFFFF, b ^ 0x80000000)


def _key64(d, ids):
    lo = (np.asarray(ids, np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (_ordered_bits(d) << np.uint64(32)) | lo.astype(np.uint64)


@pytest.mark.parametrize("case", ["ties_and_negative_ids", "inf_and_zero", "random"])
def test_key_order_is_the_distance_id_order(case):
    """Ascending keys are ascending (distance, id), negative ids, +inf and
    ties included: what sel.lex_topk gives."""
    rng = np.random.default_rng(5)
    if case == "ties_and_negative_ids":
        d = rng.integers(0, 4, 200).astype(np.float32)
        ids = rng.permutation(200).astype(np.int32) - 100
    elif case == "inf_and_zero":
        d = np.array([np.inf, 0.0, 3.5, np.inf, 0.0, 1e-30, 3.0e38, 2.0], np.float32)
        ids = np.array([-1, 7, -(2 ** 31), 5, -3, 2 ** 31 - 1, 0, 2], np.int32)
    else:
        d = rng.random(300).astype(np.float32) * 1e3
        ids = rng.integers(-2 ** 31, 2 ** 31 - 1, 300).astype(np.int32)
    order = np.argsort(_key64(d, ids), kind="stable")
    ld, li = sel.lex_topk(torch.from_numpy(d)[None], torch.from_numpy(ids)[None], len(d))
    np.testing.assert_array_equal(d[order], ld.numpy()[0])
    np.testing.assert_array_equal(ids[order], li.numpy()[0])


# ---------------------------------------------------------------------------
# dist_topk's decomposition, emulated
# ---------------------------------------------------------------------------


def _insert(keys, rows, key, row):
    """list_insert64: shift the larger keys up past any equal one, drop the
    last."""
    j = len(keys) - 1
    while j > 0 and not keys[j - 1] <= key:
        keys[j], rows[j] = keys[j - 1], rows[j - 1]
        j -= 1
    keys[j], rows[j] = key, row


def _emulated_topk(q, db, ids, mask, k, splits):
    """(d (nq, k), ids (nq, k)) as srml_dist_topk_tc computes them, with the
    tensor-core scores exact (small integers)."""
    nq, m = q.shape[0], db.shape[0]
    chunks = -(-m // kernels.TOPK_CHUNK)
    split_chunks = -(-chunks // splits)
    used = -(-chunks // split_chunks)
    q2 = (q.astype(np.float64) ** 2).sum(1).astype(np.float32)
    r2 = np.where(mask > 0, (db.astype(np.float64) ** 2).sum(1), np.inf).astype(np.float32)
    dots = (q.astype(np.float64) @ db.astype(np.float64).T).astype(np.float32)
    dist = np.maximum((q2[:, None] + r2[None, :]) - np.float32(2.0) * dots, np.float32(0.0))
    hi = _ordered_bits(dist)
    batch = kernels.TOPK_ROUND // 4  # 8-column groups a round
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for qi in range(nq):
        part = []
        for s in range(used):
            lists = [([EMPTY] * k, [0] * k) for _ in (0, 1)]
            for c in range(s * split_chunks, min((s + 1) * split_chunks, chunks)):
                for g0 in range(0, kernels.TOPK_CHUNK // 8, batch):
                    for p in (0, 1):
                        keys, rows = lists[p]
                        th_hi = keys[-1] >> 32
                        cand = []  # set aside in column order, against the round's threshold
                        for g in range(g0, g0 + batch):
                            for e in range(4):
                                row = c * kernels.TOPK_CHUNK + 8 * g + 4 * p + e
                                if row < m and hi[qi, row] < INF_HI and hi[qi, row] <= th_hi:
                                    cand.append(row)
                        for row in cand:
                            key = int(hi[qi, row]) << 32 | ((int(ids[row]) & 0xFFFFFFFF) ^ 0x80000000)
                            if key < keys[-1]:
                                _insert(keys, rows, key, row)
            (ka, ra), (kb, rb) = lists
            a = b = 0
            for _ in range(k):  # the task's two-pointer merge
                if ka[a] <= kb[b]:
                    part.append((ka[a], ra[a]))
                    a += 1
                else:
                    part.append((kb[b], rb[b]))
                    b += 1
        best = sorted(part, key=lambda kr: kr[0])[:k]  # the finishing merge's k smallest
        res = []
        for j, (key, row) in enumerate(best):
            if key >> 32 < INF_HI:  # recomputed: exact on small integers
                res.append((float(dist[qi, row]), int(ids[row]), j))
            else:
                res.append((np.inf, -1, j))
        res.sort()
        out_d[qi] = [r[0] for r in res]
        out_i[qi] = [r[1] for r in res]
    return out_d, out_i


def _topk_case(case, k, rng):
    nq, m, d = 9, 700, 24
    q, db = _ints(rng, nq, d), _ints(rng, m, d)
    ids = (rng.permutation(m) - m // 2).astype(np.int32)  # negative ids too
    mask = np.ones(m, np.float32)
    if case == "masked":
        mask = (rng.random(m) < 0.6).astype(np.float32)
    elif case == "k_past_valid":
        mask[:] = 0
        mask[[3, 350, 699]] = 1  # 3 valid rows: a (+inf, −1) tail
    elif case == "duplicates":
        db[5] = db[600]
        db[30] = db[31]
        db[300] = db[31]
        q[:4] = db[[5, 30, 600, 300]]
    return q, db, ids, mask


@pytest.mark.parametrize("k", [1, 6, 64])
@pytest.mark.parametrize("case", ["basic", "masked", "k_past_valid", "duplicates"])
def test_emulated_topk_matches_pallas_and_plain(case, k):
    rng = np.random.default_rng(31 + k)
    q, db, ids, mask = _topk_case(case, k, rng)
    ed, ei = _emulated_topk(q, db, ids, mask, k, splits=2)
    ref_d, ref_i = dist_topk_pallas(jnp.asarray(q, jnp.bfloat16), jnp.asarray(db, jnp.bfloat16),
                                    jnp.asarray(ids), jnp.asarray(mask), k, interpret=True)
    np.testing.assert_array_equal(ei, np.asarray(ref_i))
    np.testing.assert_array_equal(ed, np.asarray(ref_d))
    pd, pi = kernels.dist_topk_plain(torch.from_numpy(q).to(torch.bfloat16),
                                     torch.from_numpy(db).to(torch.bfloat16),
                                     torch.from_numpy(ids), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(ei, pi.numpy())
    np.testing.assert_array_equal(ed, pd.numpy())
    if case == "duplicates":
        # Row 30 and row 31 tie for query 1; the lower id wins.
        tied = sorted([int(ids[30]), int(ids[31]), int(ids[300])])
        assert list(ei[1, :min(k, 3)]) == tied[:min(k, 3)]
    if case == "k_past_valid" and k > 3:
        assert (ei[:, 3:] == -1).all() and np.isinf(ed[:, 3:]).all()


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_emulated_topk_is_the_same_for_any_split(splits):
    """Three 256-row chunks: one split, a ragged last split, one chunk a
    split."""
    rng = np.random.default_rng(40 + splits)
    q, db, ids, mask = _topk_case("masked", 10, rng)
    ed, ei = _emulated_topk(q, db, ids, mask, 10, splits=splits)
    pd, pi = kernels.dist_topk_plain(torch.from_numpy(q), torch.from_numpy(db),
                                     torch.from_numpy(ids), torch.from_numpy(mask), 10)
    np.testing.assert_array_equal(ei, pi.numpy())
    np.testing.assert_array_equal(ed, pd.numpy())


# ---------------------------------------------------------------------------
# The finishing merge's recompute
# ---------------------------------------------------------------------------


def _truncated_dot(a, b, step=16):
    """A tensor-core-like dot product: exact products, each 16-term partial
    sum truncated toward zero into an f32 accumulator."""
    acc = np.float32(0.0)
    for c0 in range(0, len(a), step):
        exact = float(acc) + float(np.dot(a[c0:c0 + step].astype(np.float64),
                                          b[c0:c0 + step].astype(np.float64)))
        r = np.float32(exact)
        if abs(float(r)) > abs(exact):
            r = np.nextafter(r, np.float32(0.0))
        acc = r
    return acc


def _ffma_dot(a, b):
    """The finishing merge's recompute: lane-strided f32 FMA sums of 32
    lanes, then the butterfly."""
    part = np.zeros(32, np.float32)
    for c in range(len(a)):
        part[c % 32] = np.float32(np.float64(a[c]) * np.float64(b[c]) + np.float64(part[c % 32]))
    for o in (16, 8, 4, 2, 1):
        part = (part + part[np.arange(32) ^ o]).astype(np.float32)
    return part[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_recompute_replaces_the_truncated_scores(seed):
    """Rows near a query (squared norms ~ 700 against distances ~ 40): the
    truncated tensor-core sum biases every score, the recompute in f32 puts
    the returned distances within the plain version's rounding (4e-6 of
    q2 + r2) and re-sorts them in (distance, id) order."""
    rng = np.random.default_rng(seed)
    d, m, k = 768, 300, 10
    q = rng.normal(size=d).astype(np.float32)
    db = (q + 0.15 * rng.normal(size=(m, d))).astype(np.float32)
    q, db = (torch.from_numpy(v).to(torch.bfloat16).float().numpy() for v in (q, db))
    ids = rng.permutation(m).astype(np.int32)
    q2 = np.float32((q.astype(np.float64) ** 2).sum())
    r2 = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    tc = np.array([max((q2 + r2[j]) - np.float32(2.0) * _truncated_dot(q, db[j]), 0.0)
                   for j in range(m)], np.float32)
    chosen = np.argsort(tc, kind="stable")[:k]
    rec = sorted((float(max((q2 + r2[j]) - np.float32(2.0) * _ffma_dot(q, db[j]), 0.0)),
                 int(ids[j])) for j in chosen)
    pd, pi = kernels.dist_topk_plain(torch.from_numpy(q)[None], torch.from_numpy(db),
                                     torch.from_numpy(ids), torch.ones(m), k)
    tol = 4e-6 * (float(q2) + float(r2.max()))
    got_d = np.array([r[0] for r in rec])
    assert np.abs(got_d - pd.numpy()[0]).max() <= tol
    assert np.abs(tc[chosen] - np.sort(got_d)).max() > np.abs(got_d - pd.numpy()[0]).max()
    assert [r[1] for r in rec] == list(pi.numpy()[0])


# ---------------------------------------------------------------------------
# dist_topk's route and plan
# ---------------------------------------------------------------------------


def _topk_args(dtype, d, nq=5, m=300):
    return torch.zeros((nq, d), dtype=dtype), torch.zeros((m, d), dtype=dtype)


@pytest.mark.parametrize("dtype, d, k, route", [
    (torch.bfloat16, 768, 10, "wgmma"),   # the exact kneighbors path
    (torch.bfloat16, 8, 1, "wgmma"),
    (torch.bfloat16, 1000, kernels.TOPK_TC_MAX_K, "wgmma"),
    (torch.bfloat16, 768, kernels.TOPK_TC_MAX_K + 1, "ffma"),  # lists past shared memory
    (torch.bfloat16, 12, 10, "ffma"),     # a 24-byte row: TMA needs 16-byte strides
    (torch.float32, 768, 4, "ffma"),      # f32 (the build's spill candidates) stays in FFMA
])
def test_topk_route_by_dtype_width_and_k(dtype, d, k, route):
    assert kernels.topk_route(*_topk_args(dtype, d), k) == route


def test_topk_route_needs_16_byte_alignment_and_rows():
    flat = torch.zeros(5 * 16 + 4, dtype=torch.bfloat16)
    db = torch.zeros((300, 16), dtype=torch.bfloat16)
    assert kernels.topk_route(flat[:80].view(5, 16), db, 10) == "wgmma"
    assert kernels.topk_route(flat[4:].view(5, 16), db, 10) == "ffma"  # 8-byte offset
    assert kernels.topk_route(torch.zeros((0, 16), dtype=torch.bfloat16), db, 10) == "ffma"


def test_every_k_up_to_64_has_a_route():
    routes = [kernels.topk_route(*_topk_args(torch.bfloat16, 768), k)
              for k in range(1, kernels.DIST_TOPK_MAX_K + 1)]
    limit = kernels.TOPK_TC_MAX_K
    assert routes == ["wgmma"] * limit + ["ffma"] * (kernels.DIST_TOPK_MAX_K - limit)
    assert 10 <= limit < kernels.DIST_TOPK_MAX_K


def test_topk_plan_at_the_paths_shape():
    """k = 10: a three-stage ring of 48 KB stages, 8 KB of r2 and id
    buffers, 16 KB of u64 candidates, 30 KB of lists (u64 keys, int32
    rows)."""
    assert kernels.topk_stages(10) == 3
    want = 3 * (2 * 8192 + 128 * 256) + 2 * 4 * 4 * 256 + 8 * 256 * 8 + 12 * 256 * 10 + 16 * 3 + 1024
    assert kernels.topk_smem_bytes(10, 3) == want == 203824
    assert kernels.topk_smem_bytes(10, 4) > kernels.TOPK_SMEM_LIMIT


def test_topk_plan_at_the_routes_limit():
    limit = kernels.TOPK_TC_MAX_K
    assert kernels.topk_stages(limit) == 2
    assert kernels.topk_smem_bytes(limit + 1, 2) > kernels.TOPK_SMEM_LIMIT
    stages = [kernels.topk_stages(k) for k in range(1, limit + 1)]
    assert stages == sorted(stages, reverse=True) and min(stages) == 2


def test_topk_splits_give_each_sm_eight_tasks():
    assert kernels.topk_splits(4096, 1 << 20, 132) == 33  # 33 x 32 tiles = 8 x 132 tasks
    assert kernels.topk_splits(1, 300, 132) == 2          # at most one split per chunk
    assert kernels.topk_splits(1 << 20, 1 << 20, 132) == 1


# ---------------------------------------------------------------------------
# probe_select's fused body, emulated
# ---------------------------------------------------------------------------


def _network(v, size_j):
    """One compare-exchange step of the warp's bitonic network over its 128
    keys (element e = r · 32 + lane): e and e ^ j, the lower keeping the
    smaller when (e & size) == 0 (cx_lanes for j < 32, cx_regs for 32, 64)."""
    size, j = size_j
    e = np.arange(128)
    p = e ^ j
    keep_min = ((e & j) == 0) == ((e & size) == 0)
    return np.where(keep_min, np.minimum(v, v[p]), np.maximum(v, v[p]))


def _warp_sort128(v):
    for size in (2, 4, 8, 16, 32, 64, 128):
        j = size // 2
        while j:
            v = _network(v, (size, j))
            j //= 2
    return v


def _warp_merge128(v, w):
    v = np.minimum(v, w[::-1])  # lane 31 − lane, register 3 − r: element 127 − e
    for j in (64, 32, 16, 8, 4, 2, 1):
        v = _network(v, (128, j))
    return v


def _padded(lst):
    return np.concatenate([lst, np.full(128 - len(lst), sel.IVF_MASKED_KEY, np.int64)])


def _emulated_probe(cent, qs, nprobe):
    """(probe ids, floored values) as probe_fused_kernel computes them."""
    nlist = cent.shape[0]
    pos_bits = sel.pos_bits_for(nlist)
    low = (1 << pos_bits) - 1
    c2 = (cent.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q2 = (qs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    scores = (c2[None, :] - np.float32(2.0) * (qs @ cent.T).astype(np.float32)) + q2[:, None]
    bits = scores.astype(np.float32).view(np.int32).astype(np.int64)
    keys = ((bits ^ ((bits >> 31) & 0x7FFFFFFF)) & ~low) | np.arange(nlist)
    tiles = -(-nlist // kernels.PROBE_TILE)
    groups = 2 * kernels.PROBE_SPLIT  # two halves a block, each with its own lists
    out_p = np.empty((qs.shape[0], nprobe), np.int32)
    out_d = np.empty((qs.shape[0], nprobe), np.float32)
    for qi in range(qs.shape[0]):
        lists = []
        for g in range(groups):
            lst = np.full(nprobe, sel.IVF_MASKED_KEY, np.int64)
            for ct in range(g, tiles, groups):
                tile = keys[qi, ct * 128:(ct + 1) * 128]
                v = _warp_sort128(_padded(tile))
                lst = _warp_merge128(v, _padded(lst))[:nprobe]
            lists.append(lst)
        v = _padded(lists[0])
        for lst in lists[1:]:  # the last block's merge
            v = _warp_merge128(v, _padded(lst))
        best = v[:nprobe]
        out_p[qi] = best & low
        val = best ^ (best & low)
        out_d[qi] = (val ^ ((val >> 31) & 0x7FFFFFFF)).astype(np.int32).view(np.float32)
    return out_p, out_d


def test_warp_network_sorts_and_merges():
    rng = np.random.default_rng(3)
    for _ in range(20):
        v = rng.permutation(1000)[:128]
        w = np.sort(rng.permutation(1000)[:128] + 1000 * rng.integers(0, 2))
        np.testing.assert_array_equal(_warp_sort128(v), np.sort(v))
        np.testing.assert_array_equal(_warp_merge128(np.sort(v), w),
                                      np.sort(np.concatenate([v, w]))[:128])


@pytest.mark.parametrize("nlist, nprobe", [(1, 1), (37, 20), (37, 37), (300, 1), (300, 96),
                                           (1100, 20)])
def test_emulated_probe_matches_pallas(nlist, nprobe):
    rng = np.random.default_rng(nlist + nprobe)
    cent, qs = _ints(rng, nlist, 20), _ints(rng, 64, 20)
    cent[7 % nlist] = cent[0]  # duplicate centroids: ties to the lower index
    ep, ed = _emulated_probe(cent, qs, nprobe)
    ref_p, ref_d = probe_select_pallas(jnp.asarray(cent), jnp.asarray(qs), nprobe,
                                       interpret=True)
    np.testing.assert_array_equal(ep, np.asarray(ref_p))
    np.testing.assert_array_equal(ed, np.asarray(ref_d))
    pp, pd = kernels.probe_select_plain(torch.from_numpy(cent), torch.from_numpy(qs), nprobe)
    np.testing.assert_array_equal(ep, pp.numpy())
    np.testing.assert_array_equal(ed, pd.numpy())


@pytest.mark.parametrize("nlist, nprobe, route", [
    (1024, 20, "fused"),    # the IVF query
    (1024, 96, "fused"),    # both halves' lists still fit
    (1024, 97, "sort"),
    (1024, 1024, "sort"),   # every list probed
    (37, 37, "fused"),
])
def test_probe_route_by_nprobe(nlist, nprobe, route):
    assert kernels.probe_route(nlist, nprobe) == route


def test_probe_plan_at_the_path():
    """nprobe 20: per half a 66 KB work tile, 1 KB of norms, 10 KB of lists."""
    assert kernels.probe_smem_bytes(20) == 2 * (128 * 129 * 4 + 4 * 256 + 4 * 128 * 20) == 154624
    assert kernels.PROBE_FUSED_MAX == 96
    assert kernels.probe_smem_bytes(96) <= kernels.TOPK_SMEM_LIMIT < kernels.probe_smem_bytes(97)


# ---------------------------------------------------------------------------
# CPU calls, and the exact index's cached norms
# ---------------------------------------------------------------------------


def test_cpu_calls_take_no_route():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_ints(rng, 5, 16)).to(torch.bfloat16)
    db = torch.from_numpy(_ints(rng, 40, 16)).to(torch.bfloat16)
    kernels.reset_launches()
    kernels.dist_topk(q, db, torch.arange(40, dtype=torch.int32), torch.ones(40), 10)
    kernels.probe_select(db.float(), q.float(), 20)
    assert not any(kernels.ROUTES.values()) and not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("r2", [torch.ones(39), torch.ones(40, dtype=torch.float64),
                                torch.ones((40, 1))])
def test_dist_topk_rejects_norms_that_do_not_fit_the_db(r2):
    with pytest.raises((ValueError, TypeError)):
        kernels.dist_topk(torch.ones((4, 16)), torch.ones((40, 16)),
                          torch.arange(40, dtype=torch.int32), torch.ones(40), 3, r2)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_kneighbors_gives_the_same_bits_with_and_without_cached_norms(metric):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(500, 24)).astype(np.float32)
    qs = rng.normal(size=(37, 24)).astype(np.float32)
    model = knn.NearestNeighbors(device="cpu").setK(7).setMetric(metric).fit({"features": x})
    got_d, got_i = model.kneighbors(qs)
    cache = dict(model._index_cache)
    ((key, (db, row_ids, mask, r2)),) = cache.items()
    np.testing.assert_array_equal(r2.numpy(), kernels.dist_topk_norms(db, mask).numpy())
    calls = []
    orig = kernels.dist_topk

    def without_cache(*args):
        calls.append(args[5] is not None)
        return orig(*args[:5])  # r2 recomputed from the db and mask

    kernels.dist_topk = without_cache
    try:
        ref_d, ref_i = model.kneighbors(qs)
    finally:
        kernels.dist_topk = orig
    assert calls == [True]
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_d, ref_d)
