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
