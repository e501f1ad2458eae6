"""The tensor-core IVF list scan of the PyTorch port on the CPU.

``ivf_scan_tc_kernel`` (``spark_rapids_ml_tpu_torch/ops/csrc/knn.cu``) runs
bfloat16 ``ivf_scan_select`` launches with d % 8 == 0 on a card only;
``chip_smoke.py`` phase 2 holds it against the plain version there,
bitwise. Here, without a card:

* a numpy emulation of its decomposition — per (list, 128-slot tile) task,
  chunks of 256 list rows, the accumulator fragment's columns swapped
  between the lanes of a pair so that each lane keeps one slot and four
  columns of every 8-column group, one sorted list of blk_k packed keys a
  lane with its threshold, filled in rounds (16 columns keyed, those below
  the threshold set aside, then inserted), columns past maxlen keyed as
  masked, then the two lists of a slot merged — against ``ivf_scan_select_pallas`` in
  interpret mode on the same small-integer inputs (every product and
  score exact), bitwise;
* the route a launch takes;
* the shared-memory plan: the ring beside the lists, and the blk_k limit
  it sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_kernels import ivf_scan_select_pallas
from spark_rapids_ml_tpu_torch.models import knn
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.ops import selection as sel
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

MASKED = sel.IVF_MASKED_KEY


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


def _ints(rng, *shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The accumulator fragment after the pair swap
# ---------------------------------------------------------------------------


def _kept_cells(lane):
    """(row, column) cells of a 64 x 256 wgmma accumulator that lane `lane`
    of warp 0 keeps after swapping halves with lane ^ 1: acc[4q + 2h + e]
    sits at row lane/4 + 8h, column 8q + 2(lane % 4) + e; the lane keeps
    row h = q4 & 1 of its own pair and takes the partner's values there."""
    q4 = lane & 3
    hb = q4 & 1
    cells = set()
    for src in (lane, lane ^ 1):
        for q in range(32):
            for e in range(2):
                cells.add((lane // 4 + 8 * hb, 8 * q + 2 * (src & 3) + e))
    return cells


def test_pair_swap_gives_each_lane_one_row_and_half_its_columns():
    """Each lane keeps 128 cells of one row, columns 8q + 4p .. 8q + 4p + 3
    for p = (lane % 4) >> 1, and the two lanes of a row cover its 256
    columns once: two lists a slot."""
    for lane in range(32):
        cells = _kept_cells(lane)
        p = (lane & 3) >> 1
        rows = {r for r, _ in cells}
        assert len(cells) == 128 and rows == {lane // 4 + 8 * (lane & 1)}
        assert {c for _, c in cells} == {8 * q + 4 * p + e for q in range(32) for e in range(4)}
        other = _kept_cells(lane ^ 2)
        assert {r for r, _ in other} == rows and not cells & other
        assert len(cells | other) == 256


# ---------------------------------------------------------------------------
# The epilogue, emulated, against the Pallas kernel
# ---------------------------------------------------------------------------


def _keys(scores, pos_bits):
    """Packed int32 keys of f32 scores at positions 0.. (numpy)."""
    low = (1 << pos_bits) - 1
    bits = scores.astype(np.float32).view(np.int32)
    sortable = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (sortable & ~low) | np.arange(scores.shape[-1], dtype=np.int32)


def _insert(lst, key):
    """The kernel's list_insert: shift the larger entries up, drop the last."""
    j = len(lst) - 1
    while j > 0 and not lst[j - 1] < key:
        lst[j] = lst[j - 1]
        j -= 1
    lst[j] = key


def _emulated_scan(qv, rows, r2, blk_k):
    """(best_d, best_p) (nlist, bk_pad, C) as the tensor-core scan computes
    them: per slot two lists (lane halves p = 0, 1 of each 8-column group)
    fed chunk by chunk in rounds of four groups — the round's 16 columns
    keyed, those below the list's threshold set aside, then inserted in
    turn — and merged two-pointer."""
    nlist, n_slots, _ = qv.shape
    maxlen = rows.shape[1]
    chunks = -(-maxlen // kernels.SCAN_CHUNK)
    pos_bits = sel.pos_bits_for(maxlen)
    low = (1 << pos_bits) - 1
    bk_pad = sel.ceil_to(blk_k, 8)
    out_d = np.full((nlist, bk_pad, n_slots), sel.IVF_MASKED_D2, np.float32)
    out_p = np.zeros((nlist, bk_pad, n_slots), np.int32)
    for li in range(nlist):
        scores = r2[li][None, :] - np.float32(2.0) * (qv[li] @ rows[li].T)  # exact: integers
        keys = _keys(scores.astype(np.float32), pos_bits)
        for s in range(n_slots):
            lists = [[MASKED] * blk_k, [MASKED] * blk_k]
            rounds = kernels.SCAN_ROUND // 4  # 8-column groups a round: 4 columns of each
            for c in range(chunks):
                for q0 in range(0, kernels.SCAN_CHUNK // 8, rounds):
                    for p in (0, 1):
                        th = lists[p][-1]  # the threshold the round's candidates pass
                        cand = []
                        for q in range(q0, q0 + rounds):
                            for e in range(4):
                                col = c * kernels.SCAN_CHUNK + 8 * q + 4 * p + e
                                key = int(keys[s, col]) if col < maxlen else MASKED
                                if key < th:
                                    cand.append(key)
                        for key in cand:  # inserted in turn, each against the current threshold
                            if key < lists[p][-1]:
                                _insert(lists[p], key)
            a = b = 0
            for j in range(blk_k):
                ka, kb = lists[0][a], lists[1][b]
                key = min(ka, kb)
                a, b = (a + 1, b) if ka < kb else (a, b + 1)
                v = key ^ (key & low)
                out_d[li, j, s] = np.int32(v ^ ((v >> 31) & 0x7FFFFFFF)).view(np.float32)
                out_p[li, j, s] = key & low
    return out_d, out_p


@pytest.mark.parametrize("maxlen, n_slots, blk_k", [
    (1, 5, 1),      # one row: one candidate a slot
    (7, 24, 7),     # blk_k = maxlen, a ragged 8-row tail
    (37, 70, 12),   # list 1 holds 3 valid rows: its sentinel rows are emitted
    (256, 24, 12),  # exactly one chunk
    (300, 3, 40),   # a ragged second chunk, a wide list
    (513, 70, 9),   # three chunks, the last holding one row
])
def test_emulated_scan_matches_pallas(maxlen, n_slots, blk_k):
    rng = np.random.default_rng(maxlen + n_slots)
    nlist, d = 3, 16
    qv, rows = _ints(rng, nlist, n_slots, d), _ints(rng, nlist, maxlen, d)
    if maxlen > 5:
        rows[0, 5] = rows[0, 2]  # duplicate rows: equal scores, ties to the lower position
        qv[0, 0] = rows[0, 2]
    r2 = (np.sum(rows * rows, axis=2) * 0.5).astype(np.float32)
    if maxlen > 3:
        r2[1, 3:] = 1e30
    ed, ep = _emulated_scan(qv, rows, r2, blk_k)
    ref_d, ref_p = ivf_scan_select_pallas(jnp.asarray(qv, jnp.bfloat16),
                                          jnp.asarray(rows, jnp.bfloat16), jnp.asarray(r2), blk_k,
                                          keep_pad=True, interpret=True)
    np.testing.assert_array_equal(ep, np.asarray(ref_p))
    np.testing.assert_array_equal(ed, np.asarray(ref_d))
    pd, pp = kernels.ivf_scan_select_plain(torch.from_numpy(qv).to(torch.bfloat16),
                                           torch.from_numpy(rows).to(torch.bfloat16),
                                           torch.from_numpy(r2), blk_k)
    np.testing.assert_array_equal(ep, pp.numpy())
    np.testing.assert_array_equal(ed, pd.numpy())
    if maxlen > 5:
        assert ep[0, 0, 0] == 2  # the duplicate at position 5 ties and loses


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


def _scan_args(dtype, d, blk_k=12, nlist=2, c=5, maxlen=300):
    return (torch.zeros((nlist, c, d), dtype=dtype), torch.zeros((nlist, maxlen, d), dtype=dtype),
            blk_k)


@pytest.mark.parametrize("dtype, d, blk_k, route", [
    (torch.bfloat16, 768, 12, "wgmma"),   # the IVF path
    (torch.bfloat16, 8, 1, "wgmma"),
    (torch.bfloat16, 1000, kernels.SCAN_TC_MAX_BLK_K, "wgmma"),
    (torch.bfloat16, 768, kernels.SCAN_TC_MAX_BLK_K + 1, "ffma"),  # lists past shared memory
    (torch.bfloat16, 12, 12, "ffma"),     # a 24-byte row: TMA needs 16-byte strides
    (torch.float32, 768, 12, "ffma"),     # f32 stays in f32 FFMA
])
def test_scan_route_by_dtype_width_and_blk_k(dtype, d, blk_k, route):
    assert kernels.scan_route(*_scan_args(dtype, d, blk_k)) == route


def test_scan_route_needs_16_byte_alignment_and_candidates():
    flat = torch.zeros(2 * 5 * 16 + 4, dtype=torch.bfloat16)
    rows = torch.zeros((2, 300, 16), dtype=torch.bfloat16)
    assert kernels.scan_route(flat[:160].view(2, 5, 16), rows, 12) == "wgmma"
    assert kernels.scan_route(flat[4:].view(2, 5, 16), rows, 12) == "ffma"  # 8-byte offset
    assert kernels.scan_route(torch.zeros((2, 0, 16), dtype=torch.bfloat16), rows, 12) == "ffma"


def test_cpu_scan_takes_no_route():
    rng = np.random.default_rng(3)
    qv = torch.from_numpy(_ints(rng, 2, 5, 16)).to(torch.bfloat16)
    rows = torch.from_numpy(_ints(rng, 2, 40, 16)).to(torch.bfloat16)
    r2 = torch.zeros((2, 40))
    kernels.reset_launches()
    kernels.ivf_scan_select(qv, rows, r2, 12)
    assert not any(kernels.ROUTES.values()) and not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The shared-memory plan
# ---------------------------------------------------------------------------


def test_scan_plan_at_the_paths_shape():
    """blk_k 12 (ceil(1.2 · 10), the IVF query's k = 10): a four-stage ring
    of 48 KB stages, 4 KB of r2 buffers, 8 KB of candidates, 12 KB of
    lists."""
    assert kernels.scan_stages(12) == kernels.SCAN_MAX_STAGES == 4
    want = 4 * (2 * 8192 + 128 * 256) + 4 * 4 * 256 + 4 * 256 * (8 + 12) + 8 * 2 * 4 + 1024
    assert kernels.scan_smem_bytes(12, 4) == want == 222272
    assert kernels.scan_smem_bytes(12, 4) <= kernels.SCAN_SMEM_LIMIT


def test_scan_plan_at_the_routes_limit():
    limit = kernels.SCAN_TC_MAX_BLK_K
    assert kernels.scan_stages(limit) == 2
    assert kernels.scan_smem_bytes(limit, 2) <= kernels.SCAN_SMEM_LIMIT
    assert kernels.scan_smem_bytes(limit + 1, 2) > kernels.SCAN_SMEM_LIMIT
    assert kernels.scan_stages(limit + 1) < 2
    # The stages shrink as the lists grow, never below two within the limit.
    stages = [kernels.scan_stages(b) for b in range(1, limit + 1)]
    assert stages == sorted(stages, reverse=True) and min(stages) == 2


@pytest.mark.parametrize("k", [1, 10, 32, 64])
@pytest.mark.parametrize("extract, rerank", [("auto", True), ("narrow", True), ("auto", False)])
def test_scan_limit_covers_the_default_extraction(k, extract, rerank):
    """Every blk_k ApproximateNearestNeighbors extracts for k <= 64 under
    its default ann_extract (and with the rerank off) takes the route."""
    blk_k = knn._extract_width(k, 2048, 2, rerank, extract, True)
    assert blk_k <= kernels.SCAN_TC_MAX_BLK_K
    assert kernels.scan_route(*_scan_args(torch.bfloat16, 768, blk_k)) == "wgmma"
