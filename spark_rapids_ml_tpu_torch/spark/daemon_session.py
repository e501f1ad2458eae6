"""Which data-plane daemon a Spark fit or transform talks to.

The port of ``spark_rapids_ml_tpu/spark/daemon_session.py``:

* **Cluster**: each GPU host runs one ``DataPlaneDaemon`` next to its card.
  The driver reads the address from ``$SRML_DAEMON_ADDRESS`` or
  ``spark.srml.daemon.address`` and ships it to the tasks; an executor
  whose own env names a daemon feeds that one instead (the executor →
  local host routing rule, :func:`executor_daemon_address`). Executors on
  other hosts feed their own daemons; the driver folds those peers into
  the daemon it resolved, and :func:`resolve_all` names every daemon a fit
  must seed before its first scan.
* **Local / tests**: nothing configured — the driver starts one daemon in
  its own process per device (:func:`_local_daemon`; the card unless the
  estimator was built with ``device="cpu"``), shared across fits and
  stopped at exit.

An optional shared-secret token (``$SRML_DAEMON_TOKEN`` /
``spark.srml.daemon.token``) is checked by the daemon on every op. Every
reader takes the env before the Spark conf, and the fit policies fall
back to the port's config.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Dict, Optional, Tuple

from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.utils.logging import get_logger

logger = get_logger("spark.daemon_session")

_lock = threading.Lock()
_owned: Dict[str, object] = {}  # device name -> in-process daemon
_atexit_registered = False


def _spark_conf_get(spark, key: str) -> Optional[str]:
    try:
        return spark.conf.get(key)
    except Exception:
        return None


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"daemon address {addr!r} must be 'host:port' (e.g. 'gpu-host-0:9747')"
        )
    return host or "127.0.0.1", int(port)


def resolve(spark=None, device=None) -> Tuple[str, int, Optional[str]]:
    """(host, port, token) of the daemon this driver uses; with nothing
    configured, the in-process daemon of ``device`` (started on first use)."""
    addr = os.environ.get("SRML_DAEMON_ADDRESS")
    if not addr and spark is not None:
        addr = _spark_conf_get(spark, "spark.srml.daemon.address")
    token = os.environ.get("SRML_DAEMON_TOKEN")
    if token is None and spark is not None:
        token = _spark_conf_get(spark, "spark.srml.daemon.token")
    if addr:
        return (*_parse_addr(addr), token)
    return (*_local_daemon(device).address, token)


def resolve_all(spark=None) -> list:
    """[(host, port)] of every configured daemon, for a fit that must know
    its peers before the first scan (kmeans seeds its centres and a forest
    installs its iterate on each): ``$SRML_DAEMON_ADDRESSES`` /
    ``spark.srml.daemon.addresses``, comma-separated ``host:port``. Empty
    when neither is set: a single-pass fit finds its peers in the tasks'
    acks instead."""
    addrs = os.environ.get("SRML_DAEMON_ADDRESSES")
    if not addrs and spark is not None:
        addrs = _spark_conf_get(spark, "spark.srml.daemon.addresses")
    if not addrs:
        return []
    return [_parse_addr(a.strip()) for a in addrs.split(",") if a.strip()]


def client_kwargs(spark=None) -> dict:
    """Resilience tuning of every client a Spark fit or transform opens,
    env first, then Spark conf: ``$SRML_DAEMON_TIMEOUT_S`` /
    ``spark.srml.daemon.timeout_s`` (socket timeout),
    ``$SRML_DAEMON_OP_DEADLINE_S`` / ``spark.srml.daemon.op_deadline_s``
    (one op's whole healing budget) and ``$SRML_DAEMON_OP_ATTEMPTS`` /
    ``spark.srml.daemon.op_attempts`` (reconnects per op). Unset keys are
    left out, so the client's defaults hold. Executors pass ``spark=None``
    and read their own env."""

    def _get(env_name: str, conf_key: str) -> Optional[str]:
        v = os.environ.get(env_name)
        if v is None and spark is not None:
            v = _spark_conf_get(spark, conf_key)
        return v

    out: dict = {}
    t = _get("SRML_DAEMON_TIMEOUT_S", "spark.srml.daemon.timeout_s")
    if t:
        out["timeout"] = float(t)
    d = _get("SRML_DAEMON_OP_DEADLINE_S", "spark.srml.daemon.op_deadline_s")
    if d:
        out["op_deadline_s"] = float(d)
    a = _get("SRML_DAEMON_OP_ATTEMPTS", "spark.srml.daemon.op_attempts")
    if a:
        out["max_op_attempts"] = int(a)
    return out


def _env_conf_config(spark, env_name: str, conf_key: str, config_key: str, cast, floor=None):
    """The fit policies' ladder: env, then Spark conf, then the port's
    config. An invalid value warns and falls through: a typo must never
    silently turn off a policy the operator set."""
    sources = [(f"${env_name}", os.environ.get(env_name))]
    if spark is not None:
        sources.append((conf_key, _spark_conf_get(spark, conf_key)))
    for src, v in sources:
        if v is None:
            continue
        try:
            v = cast(v)
            return v if floor is None else max(v, floor)
        except (TypeError, ValueError):
            logger.warning("ignoring invalid %s value %r from %s", config_key, v, src)
    try:
        v = cast(config.get(config_key))
        return v if floor is None else max(v, floor)
    except (TypeError, ValueError):
        return floor if floor is not None else cast(0)


def recovery_attempts(spark=None) -> int:
    """How many times a fit replays its pass after a daemon incarnation
    change before the failure surfaces; 0 (the default) = off.
    ``$SRML_FIT_RECOVERY_ATTEMPTS`` / ``spark.srml.fit.recovery_attempts``
    / config ``fit_recovery_attempts``."""
    return _env_conf_config(
        spark, "SRML_FIT_RECOVERY_ATTEMPTS", "spark.srml.fit.recovery_attempts",
        "fit_recovery_attempts", int, floor=0,
    )


def daemon_loss_tolerance(spark=None) -> int:
    """How many peer daemons one fit may declare dead; 0 (the default) =
    off. ``$SRML_FIT_DAEMON_LOSS_TOLERANCE`` /
    ``spark.srml.fit.daemon_loss_tolerance`` / config
    ``fit_daemon_loss_tolerance``."""
    return _env_conf_config(
        spark, "SRML_FIT_DAEMON_LOSS_TOLERANCE", "spark.srml.fit.daemon_loss_tolerance",
        "fit_daemon_loss_tolerance", int, floor=0,
    )


def daemon_death_timeout_s(spark=None) -> float:
    """The death deadline: the whole reconnect budget of the liveness probe
    of a peer implicated in a failed pass, before it is declared dead
    (floor 0.1 s). ``$SRML_FIT_DAEMON_DEATH_TIMEOUT_S`` /
    ``spark.srml.fit.daemon_death_timeout_s`` / config
    ``fit_daemon_death_timeout_s``."""
    return _env_conf_config(
        spark, "SRML_FIT_DAEMON_DEATH_TIMEOUT_S", "spark.srml.fit.daemon_death_timeout_s",
        "fit_daemon_death_timeout_s", float, floor=0.1,
    )


def daemon_join_policy(spark=None) -> str:
    """Whether a daemon that appears mid-fit may join it: ``off`` (the
    default) or ``boundary``; an unknown value warns and reads ``off``.
    ``$SRML_FIT_DAEMON_JOIN_POLICY`` / ``spark.srml.fit.daemon_join_policy``
    / config ``fit_daemon_join_policy``."""

    def _policy(v) -> str:
        v = str(v).strip().lower()
        if v not in ("off", "boundary"):
            raise ValueError(v)
        return v

    try:
        return _env_conf_config(
            spark, "SRML_FIT_DAEMON_JOIN_POLICY", "spark.srml.fit.daemon_join_policy",
            "fit_daemon_join_policy", _policy,
        )
    except (TypeError, ValueError):
        return "off"  # every source invalid: admission stays closed


def daemon_join_limit(spark=None) -> int:
    """How many daemons one fit may admit mid-fit before a further one
    fails it loudly (floor 0). ``$SRML_FIT_DAEMON_JOIN_LIMIT`` /
    ``spark.srml.fit.daemon_join_limit`` / config
    ``fit_daemon_join_limit``."""
    return _env_conf_config(
        spark, "SRML_FIT_DAEMON_JOIN_LIMIT", "spark.srml.fit.daemon_join_limit",
        "fit_daemon_join_limit", int, floor=0,
    )


def _local_daemon(device=None):
    """The driver's in-process daemon on ``device`` (None: the card, and
    ``start()`` raises without one), started on first use."""
    global _atexit_registered
    key = "cuda" if device is None else str(device)
    with _lock:
        d = _owned.get(key)
        if d is None:
            from spark_rapids_ml_tpu_torch.serve.daemon import DataPlaneDaemon

            d = DataPlaneDaemon(device=device, ttl=3600.0).start()
            _owned[key] = d
            if not _atexit_registered:
                atexit.register(shutdown)
                _atexit_registered = True
        return d


def shutdown() -> None:
    """Stop every in-process daemon (idempotent)."""
    with _lock:
        daemons = list(_owned.values())
        _owned.clear()
    for d in daemons:
        d.stop()


def task_context() -> Tuple[int, int]:
    """(partition id, attempt) of the current task, executor-side: from
    pyspark's TaskContext inside a real executor, else from
    ``$SRML_PARTITION_ID`` / ``$SRML_ATTEMPT`` (set by non-Spark task
    runners such as the test harness)."""
    try:
        from pyspark import TaskContext

        ctx = TaskContext.get()
        if ctx is not None:
            return int(ctx.partitionId()), int(ctx.attemptNumber())
    except ImportError:
        pass
    return (
        int(os.environ.get("SRML_PARTITION_ID", "0")),
        int(os.environ.get("SRML_ATTEMPT", "0")),
    )


def executor_daemon_address(default_host: str, default_port: int) -> Tuple[str, int]:
    """Executor-side routing: a task feeds its host's daemon when the
    executor env names one, else the driver-resolved address."""
    addr = os.environ.get("SRML_DAEMON_ADDRESS")
    if addr:
        return _parse_addr(addr)
    return default_host, default_port
