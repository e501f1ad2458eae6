"""The tensor-core KMeans body of the PyTorch port on the CPU.

``kmeans_tc_kernel`` (``spark_rapids_ml_tpu_torch/ops/csrc/kmeans.cu``)
runs bfloat16 ``lloyd_step`` and ``assign_min_dist`` launches with
d % 8 == 0 on a card only; ``chip_smoke.py`` phase 2 and the
``cuda``-marked test of tests/test_torch_package.py hold it against the
plain versions there. Here, without a card:

* the route a launch takes and the routes the counters know;
* the launch plan: fused Lloyd pass or two passes, the centre chunk width,
  resident or streamed centres, the ring depth, and the sums pass's
  column slabs, centre chunks and row splits;
* a numpy emulation of the kernel's argmin — per chunk of centres, each
  thread's columns in ascending order, the quad butterfly, the merge
  across chunks, ties to the lowest index at every step — and of the
  two-pass decomposition (assignments, then block sums from them),
  against ``assign_min_dist_pallas`` and ``lloyd_step_pallas`` in
  interpret mode on the same small-integer inputs, where every score and
  sum is exact;
* the build cache: a change to a shared header names another library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_kernels import assign_min_dist_pallas, lloyd_step_pallas
from spark_rapids_ml_tpu_torch.ops import _build, kernels
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

SMS = 132  # an H100's SMs


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, n, d, route", [
    (torch.bfloat16, 70, 8, "wgmma"),
    (torch.bfloat16, 70, 256, "wgmma"),    # the KMeans path's width
    (torch.bfloat16, 70, 768, "wgmma"),    # the IVF quantizer's width
    (torch.bfloat16, 70, 300, "ffma"),     # a 600-byte row stride: TMA needs 16 bytes
    (torch.bfloat16, 70, 13, "ffma"),
    (torch.bfloat16, 0, 256, "ffma"),      # no rows: nothing for TMA to load
    (torch.float32, 70, 256, "ffma"),      # f32 stays in f32 FFMA (TF32 is off)
    (torch.float32, 70, 768, "ffma"),      # the IVF build's f32 assignment chunks
])
def test_kmeans_route_by_dtype_width_and_rows(dtype, n, d, route):
    x = torch.zeros((n, d), dtype=dtype)
    c = torch.zeros((5, d), dtype=dtype)
    assert kernels.kmeans_route(x, c, torch.zeros((5, d))) == route


@pytest.mark.parametrize("which", ["x", "centers", "output"])
def test_kmeans_route_needs_16_byte_alignment(which):
    flat = torch.zeros(70 * 16 + 4, dtype=torch.bfloat16)
    x_ok, x_off = flat[:70 * 16].view(70, 16), flat[4:].view(70, 16)
    cflat = torch.zeros(5 * 16 + 4, dtype=torch.bfloat16)
    c_ok, c_off = cflat[:80].view(5, 16), cflat[4:].view(5, 16)
    out = torch.zeros(5 * 16 + 1)
    o_ok, o_off = out[:-1].view(5, 16), out[1:].view(5, 16)
    assert kernels.kmeans_route(x_ok, c_ok, o_ok) == "wgmma"
    args = {"x": (x_off, c_ok, o_ok), "centers": (x_ok, c_off, o_ok),
            "output": (x_ok, c_ok, o_off)}[which]
    assert kernels.kmeans_route(*args) == "ffma"


def test_cpu_tensors_take_no_kmeans_route():
    x = torch.zeros((70, 16), dtype=torch.bfloat16)
    c = torch.ones((3, 16), dtype=torch.bfloat16)
    kernels.reset_launches()
    kernels.lloyd_step(x, c, 70)
    kernels.assign_min_dist(x, c)
    assert not any(kernels.ROUTES.values()) and not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k, width", [
    (1, 104), (7, 104), (8, 104), (9, 104), (100, 104), (104, 104), (105, 256), (129, 256),
    (256, 256), (1024, 256), (50_000, 256),
])
def test_kmeans_width(k, width):
    """104 for every k the KMeans path's one chunk holds, else chunks of
    256, the widest wgmma."""
    assert kernels.kmeans_width(k) == width
    assert width % 8 == 0 and width <= 256 and width in kernels.KMEANS_WIDTHS


def test_plan_at_the_kmeans_path():
    """k = 100, d = 256: one resident chunk of 104 and the fused pass, whose
    (100, 256) f32 sums (100 KB) leave room for a two-stage ring only."""
    plan = kernels.kmeans_plan(100, 256, "wgmma", 16_764_871, SMS)
    assert plan == kernels.KMeansPlan(True, 104, True, 2)
    assert kernels.kmeans_smem_bytes(True, 104, 100, 256, True, 2) <= kernels.KMEANS_SMEM_LIMIT
    assert kernels.kmeans_smem_bytes(True, 104, 100, 256, True, 3) > kernels.KMEANS_SMEM_LIMIT
    # assign_min_dist at the same shape: resident centres, a deeper ring.
    assign = kernels.kmeans_plan(100, 256, "wgmma", 16_764_871, SMS, lloyd=False)
    assert (assign.fused, assign.width, assign.resident, assign.stages) == (False, 104, True, 5)


def test_plan_at_the_ivf_quantizer():
    """k = 1,024, d = 768: the sums (3 MB) and the centres (1.5 MB) do not
    fit, so the step is two passes with the centres streamed in chunks of
    256; the sums pass covers every column and centre once."""
    plan = kernels.kmeans_plan(1024, 768, "wgmma", 1 << 20, SMS)
    assert (plan.fused, plan.width, plan.resident) == (False, 256, False)
    assert plan.stages == 4
    assert (plan.slab, plan.kchunk) == (24, 1024)
    assert -(-768 // plan.slab) * plan.slab == 768
    blocks = -(-768 // plan.slab) * plan.splits
    assert blocks >= kernels.SUMS_BLOCKS_PER_SM * SMS


@pytest.mark.parametrize("k, d, fused, resident", [
    (1, 8, True, True),
    (1024, 8, True, True),      # four resident chunks of 256 beside the sums
    (7, 768, False, False),     # 104 padded centres x 768 leave no room for a ring
    (129, 256, False, True),
    (100, 768, False, False),
    (7, 1000, False, False),
    (1024, 1000, False, False),
])
def test_plan_at_ragged_shapes(k, d, fused, resident):
    plan = kernels.kmeans_plan(k, d, "wgmma", 20001, SMS)
    assign = kernels.kmeans_plan(k, d, "wgmma", 20001, SMS, lloyd=False)
    assert plan.fused == fused and assign.resident == resident
    for p in (plan, assign):
        assert 2 <= p.stages <= kernels.KMEANS_MAX_STAGES
        assert kernels.kmeans_smem_bytes(p.fused, p.width, k, d, p.resident,
                                         p.stages) <= kernels.KMEANS_SMEM_LIMIT
        if p.stages < kernels.KMEANS_MAX_STAGES:  # the deepest ring that fits
            assert kernels.kmeans_smem_bytes(p.fused, p.width, k, d, p.resident,
                                             p.stages + 1) > kernels.KMEANS_SMEM_LIMIT
    if not fused:
        slabs, kchunks = -(-d // plan.slab), -(-k // plan.kchunk)
        assert (slabs - 1) * plan.slab < d <= slabs * plan.slab
        assert (kchunks - 1) * plan.kchunk < k <= kchunks * plan.kchunk
        assert plan.slab <= kernels.SUMS_THREADS
        assert 4 * plan.kchunk * (plan.slab + 1) <= kernels.KMEANS_SMEM_LIMIT
        assert 1 <= plan.splits <= 65535


@pytest.mark.parametrize("k, d, fused", [(100, 256, True), (1000, 300, False),
                                         (1024, 768, False), (100, 13, True)])
def test_ffma_plan(k, d, fused):
    """The FFMA body fuses when its (k, d) sums fit beside the tile buffers."""
    plan = kernels.kmeans_plan(k, d, "ffma", 20001, SMS)
    assert plan.fused == fused and plan.width == 0
    assert (plan.slab > 0) == (not fused)


@pytest.mark.parametrize("k, d", [(50_000, 256), (50_000, 768), (100_000, 8), (1024, 4096)])
def test_any_k_and_d_has_a_tensor_core_plan(k, d):
    """A bf16 launch with d % 8 == 0 takes the wgmma route at any k: centres
    that do not fit are streamed, and a streamed launch reads its score
    constants from global memory, so its shared memory is the same at
    every k and d (no plan raises, no route depends on k)."""
    x = torch.zeros((70, d), dtype=torch.bfloat16)
    c = torch.zeros((k, d), dtype=torch.bfloat16)
    assert kernels.kmeans_route(x, c, torch.zeros(8)) == "wgmma"
    for lloyd in (False, True):
        plan = kernels.kmeans_plan(k, d, "wgmma", 1 << 20, SMS, lloyd=lloyd)
        assert not plan.fused and not plan.resident and plan.width == 256
        assert plan.stages == 4  # 48 KB stages: (64 rows x 2 + 256 centres) x 64 columns
    assert kernels.kmeans_smem_bytes(False, 256, k, d, False, 4) == \
        kernels.kmeans_smem_bytes(False, 256, 1, 8, False, 4)
    slabs, kchunks = -(-d // plan.slab), -(-k // plan.kchunk)
    assert slabs * plan.slab >= d and kchunks * plan.kchunk >= k
    assert 4 * plan.kchunk * (plan.slab + 1) <= kernels.SUMS_SMEM_TARGET


def test_sums_plan_chunks_centres_past_the_target():
    slab, kchunk, splits = kernels.sums_plan(50_000, 256, 1 << 20, SMS)
    assert slab == 8 and kchunk * (slab + 1) * 4 <= kernels.SUMS_SMEM_TARGET
    assert -(-50_000 // kchunk) > 1 and splits >= 1


# ---------------------------------------------------------------------------
# The argmin and the two-pass decomposition, emulated, against Pallas
# ---------------------------------------------------------------------------


def _ints(rng, *shape):
    return rng.integers(-8, 9, size=shape).astype(np.float32)


def _emulated_argmin(scores: np.ndarray, width: int):
    """The kernel's reduction of an (m, k) f32 score matrix: per chunk of
    `width` centres (+inf past k), each of the 4 threads of a row's quad
    scans its columns 8q + 2t, 8q + 2t + 1 in ascending order (strict <),
    the quad merges by shfl_xor 1 then 2 (ties to the lower index), and
    chunks merge in order (strict <)."""
    m, k = scores.shape
    chunks = -(-k // width)
    pad = np.full((m, chunks * width), np.inf, np.float32)
    pad[:, :k] = scores
    best_d = np.full(m, np.inf, np.float32)
    best_i = np.zeros(m, np.int64)
    for c in range(chunks):
        bd = np.full((m, 4), np.inf, np.float32)
        bi = np.zeros((m, 4), np.int64)
        for q in range(width // 8):
            for t in range(4):
                for e in range(2):
                    col = c * width + 8 * q + 2 * t + e
                    better = pad[:, col] < bd[:, t]
                    bd[better, t] = pad[better, col]
                    bi[better, t] = col
        for off in (1, 2):
            od, oi = bd[:, [t ^ off for t in range(4)]], bi[:, [t ^ off for t in range(4)]]
            take = (od < bd) | ((od == bd) & (oi < bi))
            bd, bi = np.where(take, od, bd), np.where(take, oi, bi)
        assert (bd == bd[:, :1]).all() and (bi == bi[:, :1]).all()  # the quad agrees
        better = bd[:, 0] < best_d
        best_d[better], best_i[better] = bd[better, 0], bi[better, 0]
    return best_i, best_d


def _tie_heavy(seed, m, d, k):
    """Small-integer rows and centres (every score exact) with duplicated
    centres and rows sitting on them: many exact ties."""
    rng = np.random.default_rng(seed)
    x, c = _ints(rng, m, d), _ints(rng, k, d)
    if k > 2:
        c[k - 1] = c[1]
        c[k // 2] = c[1]
        x[:m // 4] = c[1]
    return x, c


@pytest.mark.parametrize("k, d", [(7, 8), (100, 32), (129, 16), (300, 24)])
def test_emulated_argmin_matches_pallas(k, d):
    """Ties go to the lowest index at every step of the kernel's reduction,
    as jnp.argmin sends them (across the Pallas kernel's centre blocks)."""
    m = 256
    x, c = _tie_heavy(k, m, d, k)
    c2 = (c * c).sum(1)
    scores = (c2[None, :] - 2.0 * (x @ c.T)).astype(np.float32)
    idx, dist = _emulated_argmin(scores, kernels.kmeans_width(k))
    k_pad = -(-k // 8) * 8
    cp = np.zeros((k_pad, d), np.float32)
    cp[:k] = c
    cp[k:] = 100.0  # padded centres far away: they never win
    idx_j, part_j = assign_min_dist_pallas(jnp.asarray(x), jnp.asarray(cp), block_m=128,
                                           block_k=8, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_array_equal(dist, np.asarray(part_j))
    ip, dp = kernels.assign_min_dist_plain(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(idx, ip.numpy())
    assert not np.isin(idx, [k - 1, k // 2]).any() or k <= 2


def _emulated_two_pass(x, c, n_valid, sms=SMS):
    """Pass 1: the assignments of the first rows (‖c‖² − 2x·c through the
    kernel's argmin); pass 2: per (slab, centre chunk, split) block f32
    partial sums and counts of those rows, added into the outputs."""
    k, d = c.shape
    rows = min(x.shape[0], max(n_valid, 0))
    c2 = (c * c).sum(1)
    idx, _ = _emulated_argmin((c2[None, :] - 2.0 * (x[:rows] @ c.T)).astype(np.float32),
                              kernels.kmeans_width(k))
    slab, kchunk, splits = kernels.sums_plan(k, d, rows, sms)
    split_rows = -(-max(rows, 1) // splits)
    sums = np.zeros((k, d), np.float32)
    counts = np.zeros(k, np.int64)
    for s0 in range(0, d, slab):
        for k0 in range(0, k, kchunk):
            for r0 in range(0, rows, split_rows):
                a = idx[r0:r0 + split_rows]
                keep = (a >= k0) & (a < k0 + kchunk)
                part = np.zeros((k, d), np.float32)
                np.add.at(part, a[keep], x[:rows][r0:r0 + split_rows][keep])
                sums[k0:k0 + kchunk, s0:s0 + slab] += part[k0:k0 + kchunk, s0:s0 + slab]
                if s0 == 0:
                    counts += np.bincount(a[keep], minlength=k)
    return sums, counts


@pytest.mark.parametrize("k, d, n_valid", [(60, 128, 1024), (60, 128, 700), (7, 16, 1),
                                           (129, 24, 0), (300, 8, 1030)])
def test_two_pass_decomposition_matches_pallas(k, d, n_valid):
    """Assign, then sum from the assignments: the same sums and counts as
    lloyd_step_pallas (interpret mode) and the port's one-pass plain
    version, exactly on small-integer inputs."""
    m = 1024
    x, c = _tie_heavy(k + d, m, d, k)
    sums, counts = _emulated_two_pass(x, c, n_valid)
    k_pad = -(-k // 128) * 128 + (128 if k % 128 == 0 else 0)
    cp = np.zeros((k_pad, d), np.float32)
    cp[:k] = c
    sums_j, counts_j = lloyd_step_pallas(jnp.asarray(x), jnp.asarray(cp), max(n_valid, 0), k=k,
                                         block_n=256, interpret=True)
    np.testing.assert_array_equal(sums, np.asarray(sums_j)[:k])
    np.testing.assert_array_equal(counts, np.asarray(counts_j)[:k])
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    sp, cnt = kernels.lloyd_step_plain(xt, ct, n_valid)
    np.testing.assert_array_equal(sums, sp.numpy())
    np.testing.assert_array_equal(counts, cnt.numpy())
    # The plain two-pass composition: assign, then lloyd_sums_plain.
    rows = min(m, max(n_valid, 0))
    idx, _ = kernels.assign_min_dist_plain(xt[:rows], ct)
    s2, c2 = kernels.lloyd_sums_plain(xt, idx, k)
    np.testing.assert_array_equal(s2.numpy(), sums)
    np.testing.assert_array_equal(c2.numpy(), counts)


def test_lloyd_scores_and_assign_scores_share_their_argmin():
    """½‖c‖² − x·c and ‖c‖² − 2x·c differ by the exact factor 2, so the
    two-pass step may assign with the latter: same indices, bit for bit,
    also on gaussian bf16 inputs where the scores round."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2048, 64)).astype(np.float32)).to(torch.bfloat16)
    c = torch.from_numpy(rng.normal(size=(100, 64)).astype(np.float32)).to(torch.bfloat16)
    xf, cf = x.float(), c.float()
    half, _ = kernels._nearest(xf, cf, kernels.center_norms(c, half=True), 1.0)
    full, _ = kernels._nearest(xf, cf, kernels.center_norms(c, half=False), 2.0)
    assert torch.equal(half, full)


# ---------------------------------------------------------------------------
# The build cache
# ---------------------------------------------------------------------------


def test_library_path_follows_shared_headers(monkeypatch, tmp_path):
    """kmeans.cu and gram.cu include csrc/hopper.cuh: editing the header
    must name another library, or a stale build would load."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kmeans.cu").write_text('#include "hopper.cuh"\n')
    (src / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setenv("SRML_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = _build.library_path("kmeans")
    assert before == _build.library_path("kmeans")  # stable
    (src / "hopper.cuh").write_text("// v2\n")
    after = _build.library_path("kmeans")
    assert after != before and after.parent == before.parent
    (src / "extra.cuh").write_text("// new header\n")
    assert _build.library_path("kmeans") != after


def test_csrc_headers_are_included_by_both_tensor_core_sources():
    for name in ("gram", "kmeans"):
        assert '#include "hopper.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
