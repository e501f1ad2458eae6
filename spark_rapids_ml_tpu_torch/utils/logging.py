"""Logging setup — the Spark ``Logging`` trait equivalent.

The port's copy of ``spark_rapids_ml_tpu/utils/logging.py``. Configuration
attaches ONE handler to the ``spark_rapids_ml_tpu_torch`` package logger,
never ``logging.basicConfig``, which would take over the host
application's root logger. Every logger of the package lives under its
namespace and the package logger does not propagate, so its records reach
its handler exactly once. ``SRML_TORCH_LOG_LEVEL`` sets the package level
(default WARNING). Setup is idempotent and thread-safe.
"""

from __future__ import annotations

import logging
import os
import threading

_PKG = "spark_rapids_ml_tpu_torch"
_lock = threading.Lock()
_configured = False


def _ensure_package_handler() -> None:
    global _configured
    if _configured:
        return
    with _lock:
        if _configured:
            return
        pkg = logging.getLogger(_PKG)
        level = os.environ.get("SRML_TORCH_LOG_LEVEL", "WARNING").upper()
        pkg.setLevel(getattr(logging, level, logging.WARNING))
        if not any(getattr(h, "_srml_handler", False) for h in pkg.handlers):
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
            handler._srml_handler = True  # idempotency marker
            pkg.addHandler(handler)
        pkg.propagate = False
        _configured = True


def get_logger(name: str) -> logging.Logger:
    """A logger under the package namespace (short names such as
    ``"serve.daemon"`` are prefixed), the package handler attached once
    per process."""
    _ensure_package_handler()
    if name != _PKG and not name.startswith(_PKG + "."):
        name = f"{_PKG}.{name}"
    return logging.getLogger(name)
