"""The port's perfcheck (``spark_rapids_ml_tpu_torch/tools/perfcheck.py``)
held to the JAX package's on every record family.

Each case is a synthetic fresh record and the history beside it, written
under ``tmp_path`` (no ``BENCH_*``/``MULTICHIP_*``/``BENCHMARK.json`` of the
repo is read), fed to JAX ``perfcheck.main`` and to the port's. Both must
give the same exit code, the same report lines and the same stderr. The
record shapes are those of ``tests/test_{elastic,gossip,mesh_collectives,
forest}.py`` and the perfcheck docstrings.
"""

import io
import json
import sys

import pytest

from spark_rapids_ml_tpu.tools import perfcheck as jax_perfcheck
from spark_rapids_ml_tpu_torch.tools import perfcheck

XLA_OK = {"warmup": {"gram.fold": {"compiles": 1, "compile_s": 0.5}},
          "steady": {"gram.fold": {"compiles": 0, "compile_s": 0.0}}}


def _bench(value=1000.0, **over):
    rec = {"metric": "pca_fit_rows_per_s_d2048_k32", "value": value, "unit": "rows/s",
           "xla": XLA_OK}
    rec.update(over)
    return rec


def _serve(value=500.0, **over):
    rec = {"metric": "serve_transform_qps_d2048_k32", "value": value, "unit": "req/s",
           "telemetry_overhead": 0.01, "telemetry_on": {"scrapes": 12}}
    rec.update(over)
    return rec


def _mc(eff=0.9, **over):
    rec = {"metric": "multichip_fit_rows_per_sec_d512_k16", "value": 100000.0,
           "unit": "rows/s", "n_devices": 8, "simulated": True, "dryrun": False,
           "scaling_efficiency": eff,
           "xla": {"warmup": {}, "steady": {"f": {"compiles": 0}}}}
    rec.update(over)
    return rec


def _fleet(eff=0.9, **over):
    rec = {"metric": "serve_fleet_qps_d256_k8", "value": 3000.0, "unit": "req/s",
           "n_replicas": 3, "scaling_efficiency": eff, "dryrun": False,
           "wire_limited": False}
    rec.update(over)
    return rec


def _elastic(**over):
    rec = {"metric": "chaos_elastic_replay_rows_per_s_d64_k8", "mode": "chaos_elastic",
           "value": 1000.0, "replayed_rows": 100, "recovery_overhead": 2.0,
           "bitwise_equal_oracle": True, "n_survivors": 2, "time_to_recover_s": 0.5}
    rec.update(over)
    return rec


def _grow(**over):
    rec = {"metric": "chaos_grow_admit_rows_per_s_d64_k8", "mode": "chaos_grow",
           "value": 1000.0, "rebalanced_rows": 100, "grow_overhead": 1.1,
           "bitwise_equal_oracle": True, "n_daemons": 2, "time_to_admit_s": 0.01}
    rec.update(over)
    return rec


def _partition(**over):
    rec = {"metric": "chaos_partition_converge_d4", "mode": "chaos_partition",
           "value": 0.09, "time_to_converge_s": 0.09, "converged": True,
           "routed_during_partition": 13, "failed_during_partition": 0,
           "mismatched_during_partition": 0, "tombstones_clean": True, "n_daemons": 4,
           "gossip_interval_s": 0.05, "gossip_fanout": 2}
    rec.update(over)
    return rec


def _forest(**over):
    rec = {"metric": "forest_fit_rows_per_s_n1000_d8_t4_depth3_b16", "unit": "rows/s",
           "mode": "forest", "backend": "gpu", "value": 50000.0, "passes": 3,
           "transform_rows_per_s": 200000.0, "accuracy": 0.99, "accuracy_ok": True,
           "baseline": {"impl": "sklearn", "accuracy": 0.99}}
    rec.update(over)
    return rec


def _kernels(**over):
    rec = {"metric": "kernel_gram_colsum_rows_per_s_d2048", "mode": "kernels",
           "kernel": "gram_colsum", "backend": "gpu", "interpret": False, "value": 2.0e8,
           "unfused_rows_per_s": 1.5e8, "unit": "rows/s", "speedup": 1.33}
    rec.update(over)
    return rec


#: name → (fresh record, history records, extra CLI flags). PASS,
#: REGRESSION and SKIP for each family.
CASES = {
    "bench-pass": (_bench(), [_bench(990.0), _bench(1010.0)], []),
    "bench-regression": (_bench(700.0), [_bench(990.0), _bench(1010.0)], []),
    "bench-skip-no-matching-history": (_bench(), [_bench(metric="other_metric")], []),
    "bench-compile-storm": (
        _bench(xla={"warmup": {}, "steady": {"gram.fold": {"compiles": 2, "compile_s": 1.5}}}),
        [_bench()], []),
    "bench-compile-storm-allowed": (
        _bench(xla={"warmup": {}, "steady": {"gram.fold": {"compiles": 2, "compile_s": 1.5}}}),
        [_bench()], ["--allow-compile", "gram.fold"]),
    "bench-no-xla-skip-fails": (_bench(xla=None), [_bench()], []),
    "bench-empty-steady-skip": (_bench(xla={"warmup": {}, "steady": {}}), [_bench()], []),
    "bench-wider-gate-pass": (_bench(700.0), [_bench(1000.0)], ["--max-regression", "0.4"]),
    "serve-pass": (_serve(), [_serve(505.0)], []),
    "serve-telemetry-regression": (_serve(telemetry_overhead=0.05), [_serve()], []),
    "serve-telemetry-skip": (_serve(telemetry_overhead=None), [], []),
    "multichip-pass": (_mc(1.2), [_mc(1.2), _mc(1.3), _mc(1.25)], []),
    "multichip-regression": (_mc(0.85), [_mc(1.2), _mc(1.3), _mc(1.25)], []),
    "multichip-dryrun-skip": ({"n_devices": 8, "rc": 0, "ok": True, "tail": "dryrun OK"},
                              [], []),
    "multichip-dryrun-history": (_mc(0.9), [{"tail": "dryrun", "n_devices": 8}], []),
    "fleet-pass": (_fleet(0.9), [_fleet(0.92)], []),
    "fleet-regression": (_fleet(0.6), [], []),
    "fleet-dryrun-skip": (_fleet(dryrun=True), [], []),
    "fleet-wire-limited": (_fleet(0.5, wire_limited=True, fabric_relative_efficiency=0.85,
                                  wire={"reqs_per_s_n": 4000.0}), [], []),
    "chaos-elastic-pass": (_elastic(), [_elastic()], []),
    "chaos-elastic-regression": (_elastic(value=500.0), [_elastic()], []),
    "chaos-elastic-skip": (_elastic(), [], []),
    "chaos-elastic-bitwise-fail": (_elastic(bitwise_equal_oracle=False), [], []),
    "chaos-grow-pass": (_grow(), [_grow()], []),
    "chaos-grow-regression": (_grow(grow_overhead=5.0), [_grow()], []),
    "chaos-grow-skip": (_grow(), [_elastic(value=10.0)], []),
    "chaos-partition-pass": (_partition(), [_partition()], []),
    "chaos-partition-regression": (_partition(value=0.5), [_partition()], []),
    "chaos-partition-skip": (_partition(), [], []),
    "chaos-partition-failed-traffic": (_partition(failed_during_partition=3), [_partition()],
                                       []),
    "forest-pass": (_forest(value=95000.0), [_forest(value=100000.0)], []),
    "forest-regression": (_forest(value=50000.0), [_forest(value=100000.0)], []),
    "forest-skip-other-backend": (_forest(), [_forest(value=1e7, backend="tpu")], []),
    "forest-accuracy-fail": (_forest(accuracy=0.5, accuracy_ok=False), [_forest()], []),
    "kernels-pass": (_kernels(), [_kernels(value=1.9e8)], []),
    "kernels-regression": (_kernels(speedup=0.9), [_kernels()], []),
    "kernels-interpret-skip": (_kernels(interpret=True, backend="cpu"), [], []),
}


def _run(main, argv, capsys, stdin_text=None, monkeypatch=None):
    if stdin_text is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err.splitlines()


def _both(argv, capsys, stdin_text=None, monkeypatch=None):
    jax_res = _run(jax_perfcheck.main, argv, capsys, stdin_text, monkeypatch)
    port_res = _run(perfcheck.main, argv, capsys, stdin_text, monkeypatch)
    return jax_res, port_res


def _write_history(tmp_path, history):
    for i, rec in enumerate(history):
        (tmp_path / f"HIST_r{i + 1:02d}.json").write_text(json.dumps(rec))
    return str(tmp_path / "HIST_r*.json")


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_record_family_gates_as_the_jax_perfcheck(case, tmp_path, capsys):
    fresh, history, flags = CASES[case]
    glob = _write_history(tmp_path, history)
    path = tmp_path / "fresh.json"
    path.write_text(json.dumps(fresh))
    jax_res, port_res = _both([str(path), "--history", glob, *flags], capsys)
    assert port_res == jax_res
    rc, lines, _ = port_res
    assert lines[-1] == ("perfcheck: PASS" if rc == 0 else "perfcheck: FAIL")
    verdicts = " ".join(lines)
    if case.endswith("-pass"):
        assert rc == 0 and "[OK]" in verdicts
    if "regression" in case:
        assert rc == 1 and "REGRESSION" in verdicts
    if "skip" in case:
        assert "SKIP" in verdicts


def test_a_record_on_stdin_gates_as_the_jax_perfcheck(tmp_path, capsys, monkeypatch):
    """``-`` reads the record from stdin; log noise around the one JSON line
    is skipped."""
    glob = _write_history(tmp_path, [_bench(1000.0)])
    text = "warming up\n" + json.dumps(_bench(600.0)) + "\ndone\n"
    jax_res, port_res = _both(["-", "--history", glob], capsys, text, monkeypatch)
    assert port_res == jax_res
    assert port_res[0] == 1 and "REGRESSION" in " ".join(port_res[1])


def test_a_wrapped_record_gates_as_the_jax_perfcheck(tmp_path, capsys):
    """A harness's wrapper nests the record under ``parsed`` and may keep
    the ledger outside it, pretty-printed over many lines."""
    inner = _bench(1005.0)
    xla = inner.pop("xla")
    glob = _write_history(tmp_path, [{"parsed": _bench(1000.0)}])
    path = tmp_path / "wrapped.json"
    path.write_text(json.dumps({"parsed": inner, "xla": xla, "rc": 0}, indent=2))
    jax_res, port_res = _both([str(path), "--history", glob], capsys)
    assert port_res == jax_res
    assert port_res[0] == 0 and "compile storm [OK]" in " ".join(port_res[1])


@pytest.mark.parametrize("text", ["no record here\n", "[1, 2, 3]\n", "{not json\n"])
def test_a_file_with_no_record_exits_2_as_the_jax_perfcheck(text, tmp_path, capsys):
    path = tmp_path / "empty.txt"
    path.write_text(text)
    jax_res, port_res = _both([str(path), "--history", str(tmp_path / "none*.json")], capsys)
    assert port_res == jax_res
    assert port_res[0] == 2
    assert port_res[2] == ["perfcheck: no JSON record found in input"]


def test_the_gates_and_constants_are_the_jax_perfchecks():
    """The module's public surface: the same gate functions and constants."""
    for name in ("DEFAULT_MAX_REGRESSION", "MULTICHIP_MIN_EFFICIENCY", "FLEET_MIN_EFFICIENCY",
                 "TELEMETRY_MAX_OVERHEAD", "KERNELS_MIN_SPEEDUP"):
        assert getattr(perfcheck, name) == getattr(jax_perfcheck, name)
    gates = sorted(n for n in dir(jax_perfcheck) if n.startswith("check"))
    assert gates == sorted(n for n in dir(perfcheck) if n.startswith("check"))
    assert len(gates) == 9
