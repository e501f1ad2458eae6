"""The tensor-core Gram body of the PyTorch port on the CPU.

``gram_tc_kernel`` (``spark_rapids_ml_tpu_torch/ops/csrc/gram.cu``) runs
bfloat16 ``gram_colsum``, ``linreg_stats``, ``newton_stats`` and
``softmax_curvature`` launches with d % 8 == 0 on a card only;
``chip_smoke.py`` phase 2 and the ``cuda``-marked tests of
tests/test_torch_package.py hold it against the plain versions there.
Here, without a card:

* the launch plan the wrapper hands the kernel: the upper-triangle tile
  pairs, the classes of a weighted launch and the row splits;
* the route a launch takes;
* a numpy emulation of the kernel's decomposition — per (pair, split)
  float32 partials with the wgmma accumulator promoted every few stages,
  each off-diagonal tile added to both halves of a seeded, non-symmetric
  G, Σx and Xᵀy from the diagonal pairs, Σy, Σy² and the row count from
  the tile-(0, 0) blocks, masked rows zeroed — against
  ``gram_colsum_pallas`` and ``linreg_stats_pallas`` in interpret mode on
  the same seeded inputs;
* the same for the weighted mode, per (pair, split, class): the A panel
  rounded to bf16(x·bf16(wt)), borders summed in f32 from the raw
  diagonal panels — against ``newton_stats_pallas`` and
  ``softmax_curvature_pallas`` (which round the Hessian operand the same
  way) and, within the rounding bound, the port's plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import pallas_kernels as pk
from spark_rapids_ml_tpu.ops.pallas_kernels import (
    gram_colsum_pallas,
    gram_pallas,
    linreg_stats_pallas,
    newton_stats_pallas,
    softmax_curvature_pallas,
)
from spark_rapids_ml_tpu_torch.ops import kernels
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)

N, D = 1024, 256
# The emulation and the Pallas kernel multiply the same bf16-rounded values
# exactly in f32 and sum them in f32 in other orders: over at most 1024
# rows of products of N(0, 1) values the sums differ by well under 1e-3
# (outputs reach about 1e3 on the diagonal).
TOL = dict(rtol=1e-5, atol=2e-3)


@pytest.fixture(autouse=True)
def _jax_ledger_off():
    with jax_ledger_off():
        yield


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [8, 64, 128, 136, 1000, 1024, 2048])
def test_tile_pairs_cover_the_upper_triangle_once(d):
    pairs = kernels.tc_tile_pairs(d)
    t = -(-d // 128)
    assert len(pairs) == len(set(pairs)) == t * (t + 1) // 2
    assert all(0 <= i <= j < t for i, j in pairs)
    assert list(pairs) == sorted(pairs)  # row by row, as blockIdx.x walks them
    # Each element of G is reached exactly once: by its own tile, or as the
    # transpose of an upper tile.
    hits = np.zeros((d, d), np.int32)
    for i, j in pairs:
        hits[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] += 1
        if i != j:
            hits[j * 128:(j + 1) * 128, i * 128:(i + 1) * 128] += 1
    assert (hits == 1).all()


ROWS = 20001


@pytest.mark.parametrize("d", [1000, 2048])
@pytest.mark.parametrize("n_valid", [0, 1, 63, 8192, ROWS, ROWS + 5])
def test_row_splits_cover_the_rows_without_gaps(d, n_valid):
    rows = min(ROWS, max(n_valid, 0))
    plan = kernels.gram_plan(d, rows, sms=132)
    assert plan.split_rows % kernels.TC_STAGE_ROWS == 0  # no stage straddles two splits
    assert 1 <= plan.splits <= kernels.TC_MAX_SPLITS
    spans = [(s * plan.split_rows, min(rows, (s + 1) * plan.split_rows))
             for s in range(plan.splits)]
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    if rows:
        assert all(r1 > r0 for r0, r1 in spans)  # every split holds rows
    else:
        assert plan.splits == 1
    assert plan.promote == kernels.TC_PROMOTE_STAGES


@pytest.mark.parametrize("d, rows", [(2048, 262144), (1024, 262144), (8, 20001), (2048, 1)])
def test_plan_fills_the_card(d, rows):
    """The plan's modelled time — whole waves of one block per SM, each
    block its stages plus a fixed cost — is within 15 % of what any plan
    could reach: the work spread evenly over the SMs plus one block's
    fixed cost, or one full wave per pair-sized wave when rows are few."""
    sms, fixed = 132, kernels.TC_BLOCK_OVERHEAD_STAGES
    plan = kernels.gram_plan(d, rows, sms)
    p, stages = len(plan.pairs), -(-rows // 64)
    per = plan.split_rows // 64
    modelled = -(-p * plan.splits // sms) * (per + fixed)
    floor = max(p * stages / sms + fixed, -(-p // sms) * (1 + fixed))
    assert modelled <= 1.15 * floor


@pytest.mark.parametrize("classes", [1, 3, 32])
@pytest.mark.parametrize("d, rows", [(1024, 129838), (1024, 511943), (1000, 20001),
                                     (8, 20001), (1024, 1), (8, 63)])
def test_class_plan_covers_rows_and_classes(classes, d, rows):
    """A weighted launch's plan: the splits cover the rows without gaps,
    chosen for its pairs × classes blocks a split (tc_row_splits with
    pairs × classes)."""
    plan = kernels.gram_plan(d, rows, sms=132, classes=classes)
    assert plan.classes == classes and plan.pairs == kernels.tc_tile_pairs(d)
    assert (plan.splits, plan.split_rows) == kernels.tc_row_splits(
        rows, len(plan.pairs) * classes, 132)
    assert plan.split_rows % kernels.TC_STAGE_ROWS == 0
    spans = [(s * plan.split_rows, min(rows, (s + 1) * plan.split_rows))
             for s in range(plan.splits)]
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    assert all(r1 > r0 for r0, r1 in spans)


def test_class_plan_at_the_paths_shapes():
    """Phase 12's launch (C = 32, 129,838 rows) is 4 splits of 1,152
    (pair, class) blocks, 35 waves on 132 SMs; phase 11's Gram pass
    (511,943 rows) 11 splits of 36 pairs, three full waves."""
    soft = kernels.gram_plan(1024, 129838, sms=132, classes=32)
    assert (len(soft.pairs), soft.classes, soft.splits) == (36, 32, 4)  # 4,608 blocks
    newton = kernels.gram_plan(1024, 511943, sms=132)
    assert (len(newton.pairs), newton.classes, newton.splits) == (36, 1, 11)  # 396 blocks


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, d, route", [
    (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 2048, "wgmma"),
    (torch.bfloat16, 1000, "wgmma"),
    (torch.bfloat16, 300, "ffma"),   # a 600-byte row stride: TMA needs 16 bytes
    (torch.float32, 2048, "ffma"),   # f32 stays in f32 FFMA (TF32 is off)
])
def test_route_by_dtype_and_width(dtype, d, route):
    assert kernels.gram_route(torch.zeros((70, d), dtype=dtype)) == route


@pytest.mark.parametrize("dtype, n, d, classes, route", [
    (torch.bfloat16, 70, 1024, 1, "wgmma"),   # newton_stats at the path's width
    (torch.bfloat16, 70, 1024, 32, "wgmma"),  # softmax_curvature at the path's C
    (torch.bfloat16, 70, 1000, 3, "wgmma"),
    (torch.bfloat16, 1, 8, 1, "wgmma"),
    (torch.bfloat16, 70, 300, 3, "ffma"),
    (torch.bfloat16, 70, 13, 1, "ffma"),
    (torch.bfloat16, 0, 1024, 1, "ffma"),     # no rows: nothing for TMA to load
    (torch.float32, 70, 1024, 32, "ffma"),
])
def test_weighted_route(dtype, n, d, classes, route):
    """newton_stats and softmax_curvature route as the other two: their
    (C, d, d) outputs are fresh, aligned allocations."""
    hw = torch.zeros((classes, d, d))
    assert kernels.gram_route(torch.zeros((n, d), dtype=dtype), hw) == route


def test_weighted_route_needs_16_byte_alignment():
    flat = torch.zeros(70 * 16 + 4, dtype=torch.bfloat16)
    hw = torch.zeros(3 * 16 * 16 + 1)
    assert kernels.gram_route(flat[:70 * 16].view(70, 16), hw[:-1].view(3, 16, 16)) == "wgmma"
    assert kernels.gram_route(flat[:70 * 16].view(70, 16), hw[1:].view(3, 16, 16)) == "ffma"
    assert kernels.gram_route(flat[4:].view(70, 16), hw[:-1].view(3, 16, 16)) == "ffma"


def test_routes_count_the_four_routed_kernels():
    """The four Gram-family kernels; since the KMeans pair gained its
    tensor-core body, lloyd_step and assign_min_dist; since the masked Gram
    and the IVF list scan gained theirs, gram and ivf_scan_select; since
    the exact top-k gained its own, dist_topk; and the probe's fused and
    sort bodies: ten routed kernels."""
    assert set(kernels.ROUTES) == {f"{k}/{r}" for k in (
        "gram", "gram_colsum", "linreg_stats", "newton_stats", "softmax_curvature", "lloyd_step",
        "assign_min_dist", "ivf_scan_select", "dist_topk") for r in ("wgmma", "ffma")} | {
        "probe_select/fused", "probe_select/sort"}


def test_route_needs_rows_and_16_byte_alignment():
    flat = torch.zeros(70 * 16 + 4, dtype=torch.bfloat16)
    assert kernels.gram_route(flat[:70 * 16].view(70, 16)) == "wgmma"
    assert kernels.gram_route(flat[4:].view(70, 16)) == "ffma"  # 8-byte offset
    g = torch.zeros(16 * 16 + 1)
    assert kernels.gram_route(flat[:70 * 16].view(70, 16), g[1:].view(16, 16)) == "ffma"
    assert kernels.gram_route(torch.zeros((0, 16), dtype=torch.bfloat16)) == "ffma"


@pytest.mark.parametrize("dtype, d, masked, route", [
    (torch.bfloat16, 2048, False, "wgmma"),  # the default in-memory PCA fit on the card
    (torch.bfloat16, 8, False, "wgmma"),
    (torch.bfloat16, 136, False, "wgmma"),
    (torch.bfloat16, 2048, True, "ffma"),    # x·m would round to bf16 for m outside {0, 1}
    (torch.float32, 2048, False, "ffma"),    # f32 stays in full f32 FFMA (TF32 is off)
    (torch.float32, 1000, True, "ffma"),
    (torch.bfloat16, 300, False, "ffma"),    # a 600-byte row: TMA needs 16-byte strides
    (torch.bfloat16, 13, True, "ffma"),
])
def test_gram_route(dtype, d, masked, route):
    g = torch.zeros((d, d))
    assert kernels.gram_route(torch.zeros((70, d), dtype=dtype), g, masked=masked) == route


def test_cpu_tensors_take_no_route():
    x = torch.zeros((70, 16), dtype=torch.bfloat16)
    kernels.reset_launches()
    kernels.gram(x)
    kernels.gram(x, torch.ones(70))
    kernels.gram_colsum(x, 70)
    kernels.linreg_stats(x, torch.zeros(70))
    kernels.newton_stats(x, torch.zeros(70), None, torch.zeros(16), torch.tensor(0.0))
    kernels.softmax_curvature(x, torch.full((70, 3), 1 / 3))
    assert not any(kernels.ROUTES.values()) and not any(kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The decomposition, emulated in numpy, against the Pallas kernels
# ---------------------------------------------------------------------------


def _bf16_inputs(seed):
    x = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # the values bf16 holds
    return x, jnp.asarray(x, jnp.bfloat16)


def _plan(kind, rows):
    if kind == "planned":  # the wrapper's own plan on an H100's 132 SMs
        return kernels.gram_plan(D, rows, sms=132)
    # Three splits of six stages and a promotion every two stages: more
    # splits and promotions than the planned launch has at this size.
    return kernels.GramPlan(kernels.tc_tile_pairs(D), 3, 384, 2)


def _split_partial(a, b, promote):
    """One (pair, split) block: f32 wgmma sums over `promote` stages, each
    added into the f32 CUDA-core accumulator."""
    step = promote * 64 if promote else max(len(a), 1)
    tot = np.zeros((a.shape[1], b.shape[1]), np.float32)
    for k0 in range(0, len(a), step):
        tot += (a[k0:k0 + step].T @ b[k0:k0 + step]).astype(np.float32)
    return tot


def _emulate(x, rows, plan, g, cs, xty=None, ym=None):
    """Adds every (pair, split) block's tile into G (and its transpose into
    the lower half), and the diagonal pairs' Σx and Xᵀym, in f32."""
    for i, j in plan.pairs:
        ci, cj = slice(128 * i, 128 * (i + 1)), slice(128 * j, 128 * (j + 1))
        for s in range(plan.splits):
            r = slice(s * plan.split_rows, min(rows, (s + 1) * plan.split_rows))
            part = _split_partial(x[r, ci], x[r, cj], plan.promote)
            g[ci, cj] += part
            if i != j:
                g[cj, ci] += part.T
            else:
                cs[ci] += x[r, ci].sum(0, dtype=np.float32)
                if xty is not None:
                    xty[ci] += (x[r, ci].T @ ym[r]).astype(np.float32)


@pytest.mark.parametrize("kind", ["planned", "split"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("n_valid", [N, 700, 0])
def test_emulated_gram_colsum_matches_pallas(kind, seeded, n_valid):
    x, xj = _bf16_inputs(41)
    rng = np.random.default_rng(42)
    g0 = rng.normal(size=(D, D)).astype(np.float32)  # not symmetric
    cs0 = rng.normal(size=(D,)).astype(np.float32)
    state = (jnp.asarray(g0), jnp.asarray(cs0), jnp.asarray(37.0, jnp.float32))
    g, cs, c = gram_colsum_pallas(xj, n_valid, block_n=256, state=state if seeded else None,
                                  interpret=True)
    rows = min(N, max(n_valid, 0))
    eg = g0.copy() if seeded else np.zeros((D, D), np.float32)
    ecs = cs0.copy() if seeded else np.zeros((D,), np.float32)
    _emulate(x, rows, _plan(kind, rows), eg, ecs)
    ec = (37.0 if seeded else 0.0) + rows  # block (0, 0) adds the count once
    np.testing.assert_allclose(eg, np.asarray(g), **TOL)
    np.testing.assert_allclose(ecs, np.asarray(cs), **TOL)
    assert float(c) == ec


@pytest.mark.parametrize("kind", ["planned", "split"])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_emulated_linreg_stats_matches_pallas(kind, seeded, masked):
    x, xj = _bf16_inputs(43)
    rng = np.random.default_rng(44)
    y = rng.normal(size=(N,)).astype(np.float32)
    m = (rng.random(N) < 0.7).astype(np.float32) if masked else np.ones((N,), np.float32)
    ref = linreg_stats_pallas(xj, y, m, block_n=256, interpret=True)
    seed = [rng.normal(size=s).astype(np.float32) for s in ((D, D), (D,), (D,), (), ())]
    out = [a.copy() if seeded else np.zeros_like(a) for a in seed]
    xtx, xty, sx, sy, syy = out
    # A helper warp zeroes the staged rows where m = 0; the y statistics
    # read y·m.
    xm = x * m[:, None]
    ym = (y * m).astype(np.float32)
    plan = _plan(kind, N)
    _emulate(xm, N, plan, xtx, sx, xty, ym)
    n_rows = 0
    for s in range(plan.splits):  # the tile-(0, 0) block of each split
        r = slice(s * plan.split_rows, min(N, (s + 1) * plan.split_rows))
        sy += ym[r].sum(dtype=np.float32)
        syy += (ym[r] * ym[r]).sum(dtype=np.float32)
        n_rows += int((m[r] != 0).sum())
    for got, want, s0 in zip(out, ref[:5], seed):
        np.testing.assert_allclose(got, np.asarray(want) + (s0 if seeded else 0), **TOL)
    assert n_rows == float(ref[5]) == (N if not masked else int(m.sum()))


# ---------------------------------------------------------------------------
# The masked Gram on both SYRK bodies, emulated, against gram_pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [0, 1, 8192, 8193, 20001, 1 << 20, (1 << 20) + 63])
def test_ffma_plan_bounds_each_register_sum(rows):
    """The FFMA body's splits cover the rows without gaps, in stage
    multiples, and no split sums more than FFMA_SPLIT_ROWS rows."""
    plan = kernels.ffma_gram_plan(2048, rows)
    assert plan.pairs == kernels.tc_tile_pairs(2048) and plan.promote == 0
    assert plan.split_rows % kernels.TC_STAGE_ROWS == 0
    assert plan.split_rows <= max(kernels.FFMA_SPLIT_ROWS, kernels.TC_STAGE_ROWS)
    assert 1 <= plan.splits <= kernels.TC_MAX_SPLITS
    assert plan.splits * plan.split_rows >= rows
    assert (plan.splits - 1) * plan.split_rows < max(rows, 1)  # every split holds rows


GN = 512  # rows of the masked-Gram cases: two Pallas row blocks, three splits below


def _gram_inputs(seed, d, dtype):
    x = np.random.default_rng(seed).normal(size=(GN, d)).astype(np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # the values dtype holds
    return x, jnp.asarray(x, "bfloat16" if dtype == torch.bfloat16 else "float32")


GRAM_CASES = [(route, d, masked) for d in (8, 136, 1000)
              for route, masked in (("ffma-f32", False), ("ffma-f32", True), ("ffma-bf16", True),
                                    ("wgmma-bf16", False))]


@pytest.mark.parametrize("route, d, masked", GRAM_CASES)
@pytest.mark.parametrize("seeded", [False, True])
def test_emulated_gram_syrk_matches_pallas(route, d, masked, seeded):
    """gram's SYRK on either body: per (pair, split) f32 partials of the
    (x·m) tiles over the upper tile pairs (promoted every few stages on
    the tensor cores), each tile S into G[i, j] and, off the diagonal, Sᵀ
    into G[j, i] — folded into a non-symmetric seed, which must stay
    exact — against gram_pallas in interpret mode (its whole square)."""
    dtype = torch.float32 if route == "ffma-f32" else torch.bfloat16
    x, xj = _gram_inputs(49 + d, d, dtype)
    rng = np.random.default_rng(50 + d)
    m = rng.random(GN).astype(np.float32) if masked else np.ones((GN,), np.float32)
    if masked and route == "ffma-bf16":
        m = (m < 0.7).astype(np.float32)  # the bf16 masked gram of a padded shard
    ref = np.asarray(gram_pallas(xj, jnp.asarray(m, xj.dtype), block_n=256, block_d=d,
                                 interpret=True))
    g0 = rng.normal(size=(d, d)).astype(np.float32) if seeded else np.zeros((d, d), np.float32)
    g = g0.copy()
    if route.startswith("wgmma"):
        plan = kernels.gram_plan(d, GN, sms=132)
    else:
        plan = kernels.ffma_gram_plan(d, GN)
    # The planned launch, then three splits of three stages (a promotion
    # every two on the tensor cores).
    for p in (plan, kernels.GramPlan(plan.pairs, 3, 192, plan.promote and 2)):
        g = g0.copy()
        _emulate((x * m[:, None]).astype(np.float32), GN, p, g, np.zeros((d,), np.float32))
        np.testing.assert_allclose(g - g0, ref, **TOL)
        if seeded:  # the seed is only added to: the result is no longer symmetric
            assert not np.allclose(g, g.T)
    plain = kernels.gram_plain(torch.from_numpy(x).to(dtype),
                               torch.from_numpy(m) if masked else None).numpy()
    np.testing.assert_allclose(g - g0, plain, **TOL)


# ---------------------------------------------------------------------------
# The weighted mode (newton_stats, softmax_curvature), emulated
# ---------------------------------------------------------------------------

C = 3
# The rounding bound against the f32-weighted plain versions, over the
# largest Σ|terms|: two bf16 roundings a term, independent over the rows.
ROUNDING_BOUND = 2.0 ** -8


def _bf16(a):
    """The bf16 value (round to nearest even) of each float32 entry."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _emulate_weighted(x, wt, plan, r=None):
    """(G (C, d, d), colsum (C, d), xty (d,)) of the weighted mode: x (n, d)
    float32 holding bf16 values, wt (C, n) float32 weights, r (n,) a
    residual or None. Per (pair, split, class) block the A panel is
    bf16(x·bf16(wt_c)) (the product of two bf16 is exact in f32, then
    rounded once), B the raw panel; the diagonal pairs sum Xᵀwt_c and
    Xᵀr from the raw panel in f32."""
    n, d = x.shape
    g = np.zeros((wt.shape[0], d, d), np.float32)
    cs = np.zeros((wt.shape[0], d), np.float32)
    xty = np.zeros((d,), np.float32)
    for c in range(wt.shape[0]):
        a = _bf16(x * _bf16(wt[c])[:, None])
        for i, j in plan.pairs:
            ci, cj = slice(128 * i, 128 * (i + 1)), slice(128 * j, 128 * (j + 1))
            for s in range(plan.splits):
                rs = slice(s * plan.split_rows, min(n, (s + 1) * plan.split_rows))
                part = _split_partial(a[rs, ci], x[rs, cj], plan.promote)
                g[c, ci, cj] += part
                if i != j:
                    g[c, cj, ci] += part.T
                else:
                    cs[c, ci] += (x[rs, ci] * wt[c, rs, None]).sum(0, dtype=np.float32)
                    if r is not None:
                        xty[ci] += (x[rs, ci].T @ r[rs]).astype(np.float32)
    return g, cs, xty


def _upper(d):
    """Entries of the diagonal and upper 128-tile blocks: those the kernel
    computes as the full product does (the lower blocks are the upper
    ones mirrored, so there x_j·wt is rounded where the product rounds
    x_i·wt)."""
    t = np.arange(d) // 128
    return t[:, None] <= t[None, :]


def _weighted_plan(kind, classes):
    if kind == "planned":  # the wrapper's own plan on an H100's 132 SMs
        return kernels.gram_plan(D, N, sms=132, classes=classes)
    # Three splits of six stages and a promotion every two stages.
    return kernels.GramPlan(kernels.tc_tile_pairs(D), 3, 384, 2, classes)


def _operand_gram(xj, wt):
    """float64 product of the Pallas kernels' Hessian operand,
    (x·wt.astype(bf16)) in jax as pallas_kernels.py:437 and :1117 round
    it, with x: what the interpret-mode kernels compute, whose own bf16
    dot on the CPU sums inexactly (about 5e-4 of Σ|terms|)."""
    a = xj * jnp.asarray(wt, jnp.float32).astype(xj.dtype)[:, None]
    a = np.asarray(a.astype(jnp.float32), np.float64)
    return a.T @ np.asarray(xj.astype(jnp.float32), np.float64)


def _newton_rows(xj, y, m, w, b, block_n=256):
    """z, then r and wgt, by the same jax operations on the same (block_n,
    d) blocks as the interpret-mode Pallas kernel, so that both round the
    same weights to bf16."""
    n, d = xj.shape
    wpad = jnp.zeros((128, d), xj.dtype).at[0].set(jnp.asarray(w, xj.dtype))
    z = jnp.concatenate([jax.lax.dot_general(
        xj[r0:r0 + block_n], wpad, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=pk._dot_prec(xj.dtype))[:, :1]
        for r0 in range(0, n, block_n)])[:, 0] + jnp.float32(b)
    p = jax.nn.sigmoid(z)
    r = (p - y) * m
    wgt = jnp.maximum(p * (1.0 - p), 1e-10) * m
    return np.asarray(r, np.float32), np.asarray(wgt, np.float32)


@pytest.mark.parametrize("kind", ["planned", "split"])
@pytest.mark.parametrize("masked", [False, True])
def test_emulated_newton_stats_matches_pallas(kind, masked):
    """The weighted mode with C = 1, the row pass's residual and weight:
    the Hessian's diagonal and upper tiles against the product of
    ``newton_stats_pallas``'s own rounded operand (f32 sums in another
    order), the whole Hessian within the rounding bound of the Pallas
    kernel's and of the f32-weighted plain version's, the borders and
    gradient against the plain version (both f32). w is rounded to bf16
    first, as the Pallas wrapper rounds it, so both packages compute the
    same z (Σwgt, f32 in both, checks it)."""
    x, xj = _bf16_inputs(45)
    rng = np.random.default_rng(46)
    y = (rng.random(N) > 0.5).astype(np.float32)
    m = np.ones((N,), np.float32)
    if masked:
        m[-100:] = 0.0
    w = _bf16((rng.normal(size=(D,)) / np.sqrt(D)).astype(np.float32))
    b = np.float32(0.3)
    ref = newton_stats_pallas(xj, y, m, w, b, block_n=256, interpret=True)
    r, wgt = _newton_rows(xj, y, m, w, b)
    g, cs, xty = _emulate_weighted(x, wgt[None, :], _weighted_plan(kind, 1), r)
    np.testing.assert_allclose(wgt.sum(dtype=np.float32), float(ref[4]), rtol=1e-5)
    h_ref = np.asarray(ref[2])
    up = _upper(D)
    np.testing.assert_allclose(g[0][up], _operand_gram(xj, wgt)[up], rtol=1e-5, atol=2e-3)
    scale = float((x * x * wgt[:, None]).sum(0).max())  # the largest Σ|terms|
    assert np.abs(g[0] - h_ref).max() <= ROUNDING_BOUND * scale
    plain = kernels.newton_stats_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y),
                                       torch.from_numpy(m), torch.from_numpy(w), torch.tensor(b))
    assert np.abs(g[0] - plain[2].numpy()).max() <= ROUNDING_BOUND * scale
    assert np.abs(g[0] - plain[2].numpy()).max() > 0  # the operand is rounded
    np.testing.assert_allclose(xty, plain[0].numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(cs[0], plain[3].numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", ["planned", "split"])
@pytest.mark.parametrize("masked", [False, True])
def test_emulated_softmax_curvature_matches_pallas(kind, masked):
    """The weighted mode over C = 3 classes (two Pallas class groups):
    each curvature block's diagonal and upper tiles against the product of
    ``softmax_curvature_pallas``'s own rounded operand, the whole block
    within the rounding bound of the Pallas kernel's and of the plain
    version's; the border Xᵀp_c, f32 in the port and summed from the
    rounded operand in the Pallas kernel, equal to the plain version's and
    within the rounding bound of Pallas'."""
    x, xj = _bf16_inputs(47)
    rng = np.random.default_rng(48)
    logits = rng.normal(size=(N, C))
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if masked:
        p[-200:] = 0.0
    p = p.astype(np.float32)
    hw_j, hwb_j = softmax_curvature_pallas(xj, p, block_n=256, block_c=2, interpret=True)
    g, cs, _ = _emulate_weighted(x, np.ascontiguousarray(p.T), _weighted_plan(kind, C))
    hw_p, hwb_p = kernels.softmax_curvature_plain(torch.from_numpy(x).to(torch.bfloat16),
                                                  torch.from_numpy(p))
    up = _upper(D)
    for c in range(C):
        scale = float((x * x * p[:, c:c + 1]).sum(0).max())
        np.testing.assert_allclose(g[c][up], _operand_gram(xj, p[:, c])[up], rtol=1e-5, atol=2e-3)
        assert np.abs(g[c] - np.asarray(hw_j[c])).max() <= ROUNDING_BOUND * scale
        assert np.abs(g[c] - hw_p[c].numpy()).max() <= ROUNDING_BOUND * scale
        bscale = float((np.abs(x) * p[:, c:c + 1]).sum(0).max())
        assert np.abs(cs[c] - np.asarray(hwb_j[c])).max() <= ROUNDING_BOUND * bscale
    np.testing.assert_allclose(cs, hwb_p.numpy(), rtol=1e-5, atol=1e-3)
