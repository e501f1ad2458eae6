"""The port's data plane under deterministic fault injection.

The port of ``tests/test_chaos.py:112-256``: faults injected by the port's
``FaultPlan`` (``spark_rapids_ml_tpu_torch/utils/faults.py``) at the real
sites of its client, wire framing, daemon and Arrow bridge. Every test holds
the healed result to the fault-free one exactly, and checks that the plan
fired and the healing ran (a chaos test whose faults never fired proves
nothing).

* KMeans under client drops, partial frames, daemon and bridge latency and
  refused connects: the healed centres equal the fault-free run bitwise;
  the client reconnected, and ``srml_client_fault_trips_total`` went up.
* Partitioned PCA under partial frames and drops: the client replayed ops
  that had reached the wire, the daemon folded each row once, and the
  model is within 1e-8 of the JAX package's ``fit_pca`` of the same rows
  (both in float64).
* The op deadline bounds a blocked receive.
* Across packages: the JAX client under a JAX ``FaultPlan`` of partial
  frames feeds a port daemon; its commits stay exactly-once and it gets
  the PCA of a clean feed bitwise.
"""

import contextlib
import socket
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models.pca import fit_pca
from spark_rapids_ml_tpu.serve import DataPlaneClient as JaxClient
from spark_rapids_ml_tpu.utils import faults as jax_faults
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import client as client_mod
from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
from spark_rapids_ml_tpu_torch.utils import faults
from spark_rapids_ml_tpu_torch.utils.faults import FaultPlan
from torch_port_helpers import jax_ledger_off

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    faults.deactivate()
    jax_faults.deactivate()
    assert faults.active_plan() is None and jax_faults.active_plan() is None


def _client(addr, cls=DataPlaneClient, **kw):
    kw.setdefault("timeout", 15.0)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_max_s", 0.2)
    kw.setdefault("max_op_attempts", 10)
    return cls(*addr, **kw)


def _f64():
    stack = contextlib.ExitStack()
    stack.enter_context(config.option("compute_dtype", "float64"))
    stack.enter_context(config.option("accum_dtype", "float64"))
    return stack


def _drive_kmeans(addr, parts, k, seed, iters, job, attempt=0):
    """One seeded partitioned kmeans fit, driven as the Spark wrapper drives
    it (seed, then per pass feed + commit and step, then finalize). The
    client's healing absorbs connection faults; what escapes is the
    fit-level retry's."""
    seed_batch = np.concatenate(parts)[: 10 * k]
    with _client(addr) as c:
        c.seed_kmeans(job, seed_batch, k=k, params={"seed": seed})
        for it in range(iters):
            for pid, part in enumerate(parts):
                c.feed(job, part, algo="kmeans", partition=pid, attempt=attempt, pass_id=it,
                       params={"k": k, "seed": seed})
                c.commit(job, partition=pid, attempt=attempt, pass_id=it)
            c.step(job)
        out, _ = c.finalize(job, {}, drop=False)  # a replay re-reads the model
        c.drop(job)
        return out, dict(c.stats)


def _fit_with_job_retry(addr, parts, k, seed, iters, max_fit_attempts=8):
    """The fit-level retry (Spark's job retry above task retry): a fresh job
    name an attempt; the fit is a pure function of (data, seed)."""
    last = None
    for attempt in range(max_fit_attempts):
        try:
            return _drive_kmeans(addr, parts, k, seed, iters, job=f"chaos-{attempt}",
                                 attempt=attempt)
        except (RuntimeError, OSError) as e:
            last = e
    raise AssertionError(f"fit did not complete in {max_fit_attempts} attempts: {last}")


def _trips():
    return sum(v for _, v in client_mod._M_FAULT_TRIPS._samples())


def test_chaos_kmeans_heals_to_the_fault_free_centres_bitwise():
    rng = np.random.default_rng(112)
    x = rng.normal(size=(240, 6)) + 3.0 * rng.integers(0, 3, size=(240, 1))
    parts = [np.ascontiguousarray(p) for p in np.array_split(x, 4)]
    with DataPlaneDaemon(device="cpu") as d:
        baseline, clean = _drive_kmeans(d.address, parts, k=3, seed=7, iters=3,
                                        job="fault-free")
        assert clean["reconnects"] == 0
        plan = (FaultPlan(seed=1234)
                .rule("client.op", "drop", p=0.10)
                .rule("wire.send_frame", "partial", p=0.04)
                .rule("daemon.op", "latency", p=0.25, delay_s=0.002)
                .rule("bridge.to_matrix", "latency", p=0.25, delay_s=0.002)
                .rule("client.connect", "refuse", p=0.05))
        trips0 = _trips()
        with faults.active(plan):
            healed, stats = _fit_with_job_retry(d.address, parts, k=3, seed=7, iters=3)
        assert {"client.op", "wire.send_frame", "daemon.op", "bridge.to_matrix"} <= \
            set(plan.fired), plan.fired
        assert stats["reconnects"] > 0  # the healing ran
        assert _trips() > trips0
        assert d._jobs == {}
    np.testing.assert_array_equal(healed["centers"], baseline["centers"])
    np.testing.assert_array_equal(healed["n_iter"], baseline["n_iter"])


def test_chaos_partitioned_pca_is_exactly_once_and_matches_jax(mesh8):
    rng = np.random.default_rng(99)
    data = rng.normal(size=(480, 16)) * np.logspace(0, -1.5, 16)
    parts = np.array_split(data, 4)
    plan = (FaultPlan(seed=99)
            .rule("client.op", "drop", p=0.12)
            .rule("wire.send_frame", "partial", p=0.06))
    with _f64(), DataPlaneDaemon(device="cpu") as d:
        with faults.active(plan), _client(d.address) as c:
            for pid, part in enumerate(parts):
                for sub in np.array_split(part, 2):
                    c.feed("pj", sub, algo="pca", partition=pid)
                c.commit("pj", partition=pid)
            assert c.status("pj")["rows"] == data.shape[0]  # each row folded once
            out, _ = c.finalize("pj", {"k": 3, "mean_center": True, "solver": None},
                                drop=False)
            c.drop("pj")
            stats = dict(c.stats)
    assert plan.fired and stats["reconnects"] > 0
    # Partial frames fired mid-request: some retries replayed an op that had
    # reached the wire.
    assert stats["replays"] > 0
    with jax_ledger_off():
        ref = fit_pca(data, k=3, mesh=mesh8)
    np.testing.assert_allclose(np.abs(out["pc"]), np.abs(ref.pc), atol=1e-8)
    np.testing.assert_allclose(out["mean"], ref.mean, atol=1e-8)


def test_the_op_deadline_bounds_a_blocked_recv():
    """A daemon that accepts and never answers costs about the deadline, not
    the 30 s socket timeout an attempt."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        c = DataPlaneClient("127.0.0.1", srv.getsockname()[1], timeout=30.0,
                            op_deadline_s=0.6, max_op_attempts=10, backoff_base_s=0.01,
                            backoff_max_s=0.05)
        expiries0 = sum(v for _, v in client_mod._M_DEADLINE_EXPIRIES._samples())
        start = time.monotonic()
        with pytest.raises(OSError):
            c.ping()
        assert time.monotonic() - start < 5.0
        assert sum(v for _, v in client_mod._M_DEADLINE_EXPIRIES._samples()) > expiries0
        c.close()
    finally:
        srv.close()


def test_the_jax_client_under_jax_partial_frames_feeds_a_port_daemon_exactly_once():
    """The wire is one protocol: a JAX client whose own plan truncates its
    frames and drops its ops heals against a port daemon, whose commits
    stay exactly-once, and the PCA equals a clean JAX feed's bitwise."""
    rng = np.random.default_rng(256)
    data = rng.normal(size=(400, 12)) * np.logspace(0, -1, 12)
    parts = np.array_split(data, 4)
    params = {"k": 3, "mean_center": True, "solver": None}

    def feed(c, job):
        for pid, part in enumerate(parts):
            for sub in np.array_split(part, 2):
                c.feed(job, sub, algo="pca", partition=pid)
            c.commit(job, partition=pid)
            c.commit(job, partition=pid)  # a duplicate commit: acknowledged, not added
        rows = c.status(job)["rows"]
        out, _ = c.finalize(job, params, drop=False)
        c.drop(job)
        return rows, out

    plan = (jax_faults.FaultPlan(seed=7)
            .rule("wire.send_frame", "partial", p=0.08)
            .rule("client.op", "drop", p=0.05))
    with _f64(), jax_config.option("metrics", False), DataPlaneDaemon(device="cpu") as d:
        with _client(d.address, cls=JaxClient) as c:
            clean_rows, clean = feed(c, "clean")
        with jax_faults.active(plan), _client(d.address, cls=JaxClient) as c:
            rows, healed = feed(c, "healed")
            stats = dict(c.stats)
        assert d._jobs == {}
    assert plan.fired.get("wire.send_frame", 0) > 0 and stats["replays"] > 0
    assert rows == clean_rows == data.shape[0]
    for key in ("pc", "explained_variance", "mean"):
        np.testing.assert_array_equal(healed[key], clean[key])
