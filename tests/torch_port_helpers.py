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
