"""The tensor-core Gram body of the PyTorch port on the CPU.

``gram_tc_kernel`` (``spark_rapids_ml_tpu_torch/ops/csrc/gram.cu``) runs
bfloat16 ``gram_colsum`` and ``linreg_stats`` launches with d % 8 == 0 on a
card only; ``chip_smoke.py`` phase 2 and the ``cuda``-marked tests of
tests/test_torch_package.py hold it against the plain versions there.
Here, without a card:

* the launch plan the wrapper hands the kernel: the upper-triangle tile
  pairs and the row splits;
* the route a launch takes;
* a numpy emulation of the kernel's decomposition — per (pair, split)
  float32 partials with the wgmma accumulator promoted every few stages,
  each off-diagonal tile added to both halves of a seeded, non-symmetric
  G, Σx and Xᵀy from the diagonal pairs, Σy, Σy² and the row count from
  the tile-(0, 0) blocks, masked rows zeroed — against
  ``gram_colsum_pallas`` and ``linreg_stats_pallas`` in interpret mode on
  the same seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_kernels import gram_colsum_pallas, linreg_stats_pallas
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


def test_route_needs_rows_and_16_byte_alignment():
    flat = torch.zeros(70 * 16 + 4, dtype=torch.bfloat16)
    assert kernels.gram_route(flat[:70 * 16].view(70, 16)) == "wgmma"
    assert kernels.gram_route(flat[4:].view(70, 16)) == "ffma"  # 8-byte offset
    g = torch.zeros(16 * 16 + 1)
    assert kernels.gram_route(flat[:70 * 16].view(70, 16), g[1:].view(16, 16)) == "ffma"
    assert kernels.gram_route(torch.zeros((0, 16), dtype=torch.bfloat16)) == "ffma"


def test_cpu_tensors_take_no_route():
    x = torch.zeros((70, 16), dtype=torch.bfloat16)
    kernels.reset_launches()
    kernels.gram_colsum(x, 70)
    kernels.linreg_stats(x, torch.zeros(70))
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
