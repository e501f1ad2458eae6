"""The port's kernel ledger (``spark_rapids_ml_tpu_torch/utils/xprof.py``),
the counterpart of the JAX jit ledger.

* Each of the ten dispatch functions of ``ops/kernels.py``, called on the
  CPU, records a call under its kernel's name on route ``plain``, one cache
  miss a new shape signature, and per call the bound operation and byte
  counts of ``PERF.md`` §6 for those shapes (the formulas written out here
  again); the ``srml_xla_*`` counters follow.
* The snapshot keeps the JAX ledger's aggregate and record keys (plus the
  route); ``reset`` drops the records and keeps the entries;
  ``format_table`` renders them; with ``metrics`` off a call is a
  passthrough; ``device_timing`` records execution seconds (host seconds for
  a plain call); an ``nvcc`` build inside a call is booked to that kernel as
  a compile, and a library found built counts a persistent-cache hit.
"""

import os
import stat
import sys

import pytest
import torch

from spark_rapids_ml_tpu.utils import xprof as jax_xprof
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.ops import _build, kernels
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils import xprof

torch.set_num_threads(2)

N, DD, K, C = 40, 8, 3, 3


@pytest.fixture(autouse=True)
def _fresh_ledger():
    xprof.reset()
    yield
    xprof.reset()


def _gen():
    return torch.Generator().manual_seed(20)


def _x(dtype=torch.float32, n=N, d=DD):
    return torch.randn((n, d), generator=_gen()).to(dtype)


def _ceil8(v):
    return -(-v // 8) * 8


def _calls():
    """(kernel, call, flops a call, bytes a call): PERF.md §6's bound counts
    for the shapes of the call; es is the operand's element size."""
    x, xb = _x(), _x(torch.bfloat16)
    y = torch.rand(N, generator=_gen())
    mask = (torch.rand(N, generator=_gen()) > 0.3).float()
    cen = x[:K].clone()
    state = kernels._zero_state(DD, x.device)
    lstate = kernels._zero_linreg_state(DD, x.device)
    w, b = torch.zeros(DD), torch.zeros(())
    p = torch.softmax(torch.randn((N, C), generator=_gen()), dim=1)
    q, m, kk = 5, N, 4
    ids, ones = torch.arange(m, dtype=torch.int32), torch.ones(m)
    nlist, nq, nprobe = 6, 5, 2
    qv, rows, r2 = torch.randn((4, 2, DD)), torch.randn((4, 16, DD)), torch.zeros((4, 16))
    nd, d2 = N * DD, DD * DD
    r = 33  # the rows the n_valid kernels fold
    return [
        ("gram", lambda: kernels.gram(x), nd * (DD + 1), nd * 4 + 4 * d2),
        ("gram", lambda: kernels.gram(xb, mask), nd * (DD + 1), nd * 2 + 4 * N + 4 * d2),
        ("gram_colsum", lambda: kernels.gram_colsum(x, r), r * DD * (DD + 1) + r * DD,
         r * DD * 4 + 4 * (d2 + DD + 1)),
        ("gram_colsum", lambda: kernels.gram_colsum(xb, r, state), r * DD * (DD + 1) + r * DD,
         r * DD * 2 + 2 * 4 * (d2 + DD + 1)),
        ("linreg_stats", lambda: kernels.linreg_stats(x, y, mask, lstate),
         nd * (DD + 1) + 3 * nd, nd * 4 + 4 * N + 4 * N + 2 * (4 * (d2 + 2 * DD) + 12)),
        ("lloyd_step", lambda: kernels.lloyd_step(x, cen, r), 2 * r * K * DD + r * DD,
         r * DD * 4 + K * DD * 4 + 4 * K * DD + 8 * K),
        ("assign_min_dist", lambda: kernels.assign_min_dist(x, cen), 2 * N * K * DD,
         nd * 4 + K * DD * 4 + 8 * N),
        ("newton_stats", lambda: kernels.newton_stats(x, y.round(), mask, w, b),
         nd * (DD + 1) + 6 * nd, nd * 4 + 4 * N + 4 * N + 4 * DD + 4 + 4 * (d2 + 2 * DD + 2)),
        ("softmax_curvature", lambda: kernels.softmax_curvature(x, p),
         C * nd * (DD + 1) + 2 * C * nd, nd * 4 + 4 * N * C + 4 * C * (d2 + DD)),
        ("dist_topk", lambda: kernels.dist_topk(x[:q].clone(), x, ids, ones, kk),
         2 * q * m * DD, (q + m) * DD * 4 + 8 * m + 8 * q * kk),
        ("probe_select", lambda: kernels.probe_select(x[:nlist].clone(), x[-nq:].clone(), nprobe),
         2 * nq * nlist * DD, nlist * DD * 4 + nq * DD * 4 + 8 * nq * nprobe),
        ("ivf_scan_select", lambda: kernels.ivf_scan_select(qv, rows, r2, 3),
         2 * 4 * 2 * 16 * DD, (qv.numel() + rows.numel()) * 4 + 4 * r2.numel()
         + 8 * 4 * _ceil8(3) * 2),
    ]


CASES = [(i, c[0]) for i, c in enumerate(_calls())]


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{i}" for i, n in CASES])
def test_each_dispatch_function_records_its_plain_call(case):
    i, name = case
    _, call, flops, nbytes = _calls()[i]
    launches = dict(kernels.LAUNCHES)
    snap0 = metrics_mod.snapshot()
    call()
    call()
    assert kernels.LAUNCHES == launches  # a plain call launches nothing
    led = xprof.snapshot()[name]
    assert (led["calls"], led["cache_misses"], led["routes"]) == (2, 1, {"plain": 2})
    (rec,) = led["signatures"]
    assert rec["flops"] == flops and rec["bytes_accessed"] == nbytes
    assert rec["route"] == "plain" and rec["compiles"] == 0 and rec["execute_calls"] == 0
    assert rec["peak_bytes"] is None and rec["argument_bytes"] is None
    snap1 = metrics_mod.snapshot()

    def delta(metric):
        def val(snap):
            return sum(s["value"] for s in snap.get(metric, {}).get("samples", [])
                       if s["labels"].get("fn") == name)
        return val(snap1) - val(snap0)

    assert delta("srml_xla_calls_total") == 2
    assert delta("srml_xla_cache_misses_total") == 1
    assert delta("srml_xla_executed_flops_total") == 2 * flops
    assert delta("srml_xla_executed_bytes_total") == 2 * nbytes


def test_a_new_shape_is_a_new_signature_and_reset_keeps_entries():
    x = _x()
    kernels.gram(x)
    kernels.gram(x)
    kernels.gram(_x(n=17))
    led = xprof.snapshot()["gram"]
    assert led["calls"] == 3 and led["cache_misses"] == 2
    assert [s["sig"] for s in led["signatures"]] == ["(float32[40,8],None)",
                                                     "(float32[17,8],None)"]
    xprof.reset()
    assert xprof.snapshot() == {} and "gram" in xprof.LEDGER.names()
    kernels.gram(x)
    assert xprof.snapshot()["gram"]["cache_misses"] == 1


def test_the_snapshot_keeps_the_jax_ledgers_schema():
    """The aggregate and per-signature keys of the JAX jit ledger (built
    without calling jit), plus ``routes`` and ``route``."""
    name = "torch-port-schema-probe"
    entry = jax_xprof.LEDGER.entry(name)
    try:
        entry.record(("t", ()))
        ref = jax_xprof.LEDGER.snapshot()[name]
    finally:
        jax_xprof.LEDGER._entries.pop(name, None)
    kernels.gram(_x())
    got = xprof.snapshot()["gram"]
    assert set(got) == set(ref) | {"routes"}
    assert set(got["signatures"][0]) == set(ref["signatures"][0]) | {"route"}


def test_metrics_off_is_a_passthrough():
    with config.option("metrics", False):
        out = kernels.gram(_x())
    assert xprof.snapshot() == {}
    assert torch.equal(out, kernels.gram_plain(_x()))


def test_device_timing_records_execution_seconds_and_rates():
    kernels.gram_colsum(_x(), N)
    assert xprof.snapshot()["gram_colsum"]["execute_calls"] == 0
    with config.option("device_timing", True):
        for _ in range(3):
            kernels.gram_colsum(_x(), N)
    led = xprof.snapshot()["gram_colsum"]
    assert led["calls"] == 4 and led["execute_calls"] == 3 and led["execute_s"] > 0
    flops = N * DD * (DD + 1) + N * DD
    assert led["flops_per_s"] == pytest.approx(3 * flops / led["execute_s"])
    table = xprof.format_table(peak_flops_per_s=989e12, peak_bytes_per_s=3.35e12)
    header, row = table.splitlines()
    assert header.split() == ["fn", "calls", "compiles", "compile_s", "execute_s", "GFLOP/s",
                              "GB/s", "flops%", "hbm%"]
    assert row.split()[:3] == ["gram_colsum", "4", "0"] and "-" not in row.split()[4:]


def test_format_table_without_timed_calls_reads_dashes():
    kernels.gram(_x())
    (_, row) = xprof.format_table().splitlines()
    assert row.split() == ["gram", "1", "0", "0.000", "-", "-", "-"]


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A compiler stand-in that writes its -o file, and a build directory of
    the test's own."""
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\nimport sys, time\n"
                      "time.sleep(0.05)\n"
                      "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(script))
    monkeypatch.setenv("SRML_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    return script


def test_a_build_inside_a_call_is_the_kernels_compile(fake_nvcc):
    hits = metrics_mod.REGISTRY.counter("srml_xla_persistent_cache_hits_total")
    hits0 = hits.value()
    x = _x()
    with kernels._ledger("gram", "wgmma", x.device, 1.0, 1.0, x):
        path = _build.build("gram")
    assert path.exists() and os.path.dirname(path) == os.environ["SRML_TORCH_BUILD_DIR"]
    led = xprof.snapshot()["gram"]
    (rec,) = led["signatures"]
    assert led["compiles"] == 1 and led["compile_s"] >= 0.05
    assert rec["first_call_s"] is not None and rec["first_call_s"] >= rec["compile_s"]
    # Built already: a persistent-cache hit, no compile.
    with kernels._ledger("gram", "wgmma", x.device, 1.0, 1.0, x):
        _build.build("gram")
    assert xprof.snapshot()["gram"]["compiles"] == 1
    assert hits.value() == hits0 + 1
    # A build outside every call (build_all's) is booked nowhere.
    _build.build("knn")
    assert set(xprof.snapshot()) == {"gram"}


def test_annotate_books_ambient_builds_and_counts_the_block(fake_nvcc):
    with xprof.annotate("scheduler.kneighbors"):
        _build.build("kmeans")
    led = xprof.snapshot()["scheduler.kneighbors"]
    assert led["calls"] == 1 and led["compiles"] == 1 and led["routes"] == {"ambient": 1}
    with config.option("metrics", False):
        with xprof.annotate("scheduler.kneighbors"):
            pass
    assert xprof.snapshot()["scheduler.kneighbors"]["calls"] == 1
