"""Operator CLIs (``python -m spark_rapids_ml_tpu_torch.tools.<name>``).

The port's ``top`` and ``trace``: thin shells over the wire ops any client
can speak (``health``, ``metrics``, ``gossip_pull``, ``trace_pull``,
``telemetry_pull``; docs/protocol.md) and over the run journal and the
flight recorder's bundles, rendering the numbers a scrape pipeline would
collect for a human terminal.
"""
