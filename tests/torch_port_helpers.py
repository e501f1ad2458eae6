"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

from spark_rapids_ml_tpu import config as jax_config


def jax_ledger_off():
    """Run the JAX reference with its jit ledger (utils/xprof.py) off.

    The ledger is the ``metrics`` feature; with it on, a direct call of a
    ledgered function asks ``jax.core.trace_state_clean``, which jax
    releases from 0.9 no longer have. Off, the same jitted function runs
    unrecorded, computing exactly what it computes with the ledger on."""
    return jax_config.option("metrics", False)


def daemon_addr(daemon) -> str:
    """A daemon's ``host:port``, as the Spark conf and the executor env
    spell it."""
    return "%s:%d" % daemon.address


def split_routing(primary, peer, n_partitions=4, conf=None):
    """(session, env_plan) of a fit across two daemons: the driver resolves
    ``primary`` and the executors of the upper half of the partitions feed
    ``peer`` (their host's daemon, named in the executor env)."""
    from sparksim import SimSparkSession

    session = SimSparkSession({"spark.srml.daemon.address": daemon_addr(primary),
                               **(conf or {})})
    env_plan = {pid: {"SRML_DAEMON_ADDRESS": daemon_addr(peer)}
                for pid in range(n_partitions // 2, n_partitions)}
    return session, env_plan


def direct_fit(drive, primary, x, n_parts, algo, routes=None, spark=None, **fit_kw):
    """A port Spark fit's driver (``drive(fit, run_pass)``, one of the
    estimator's ``_drive_*`` loops) over ``primary`` with the partition
    tasks run in this process: partition ``p`` of ``np.array_split(x,
    n_parts)`` goes through the Spark task body (``_feed_partition``) with
    ``feed_raw`` frames to ``routes[p]`` (a daemon; the primary by default).
    The same driver as the sparksim fits', without a process a task: the
    oracle fits of the elastic tests."""
    import uuid

    import numpy as np

    from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
    from spark_rapids_ml_tpu_torch.spark import estimator as port_est

    job = f"direct-{uuid.uuid4().hex[:8]}"
    fit = port_est._DaemonFit(*primary.address, job, spark=spark, **fit_kw)
    parts = np.array_split(np.asarray(x), n_parts)

    def run_pass(pass_id):
        acks = []
        for p, rows in enumerate(parts):
            addr = (routes or {}).get(p, primary).address
            with DataPlaneClient(*addr) as c:
                def send(batch, c=c, p=p):
                    c.feed_raw(job, batch, algo=algo, n_cols=batch.shape[1], params=fit.params,
                               partition=p, pass_id=pass_id)

                acks.append(port_est._feed_partition(c, [rows], send, job, p, 0, pass_id, addr))
        return acks

    try:
        return drive(fit, run_pass)
    finally:
        fit.close()
        port_est._evict_daemon_id_cache(job)
