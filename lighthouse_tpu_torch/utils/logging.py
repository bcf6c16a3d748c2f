"""Structured key-value logging: the port's copy of
``lighthouse_tpu/utils/logging.py`` (Lighthouse common/logging: slog drains
bridged to tracing layers).

``get_logger("beacon_chain")`` yields a component logger whose records
carry key=value fields slog-style; a metrics layer counts log events per
component/level as Prometheus counters, mirroring
``tracing_metrics_layer.rs``'s accounting of dependency logs.
"""

from __future__ import annotations

import logging
import sys
import threading
import time

from .metrics import REGISTRY

LOG_EVENTS = REGISTRY.counter(
    "log_events_total",
    "Log events by component and level (tracing_metrics_layer.rs)",
    label_names=("component", "level"),
)

_configured = False
_lock = threading.Lock()


class _KVFormatter(logging.Formatter):
    def format(self, record):
        ts = time.strftime("%b %d %H:%M:%S", time.localtime(record.created))
        fields = getattr(record, "kv", {})
        kv = "".join(f", {k}: {v}" for k, v in fields.items())
        return (
            f"{ts} {record.levelname:5s} {record.getMessage()}{kv}, "
            f"module: {record.name}"
        )


class StructuredLogger:
    """slog-style: ``log.info("Block imported", slot=5, root="0xab..")``."""

    def __init__(self, component: str):
        self.component = component
        self._log = logging.getLogger(f"lighthouse_tpu_torch.{component}")

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        LOG_EVENTS.inc(
            component=self.component, level=logging.getLevelName(level).lower()
        )
        self._log.log(level, msg, extra={"kv": kv})

    def debug(self, msg: str, **kv) -> None:
        self._emit(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._emit(logging.INFO, msg, kv)

    def warn(self, msg: str, **kv) -> None:
        self._emit(logging.WARNING, msg, kv)

    # stdlib-logging name; same level (callers use either spelling)
    warning = warn

    def error(self, msg: str, **kv) -> None:
        self._emit(logging.ERROR, msg, kv)

    def child(self, sub: str) -> "StructuredLogger":
        return StructuredLogger(f"{self.component}.{sub}")


def init_logging(level: str = "info", stream=None) -> None:
    """Install the root handler once (EnvironmentBuilder's logger init)."""
    global _configured
    with _lock:
        root = logging.getLogger("lighthouse_tpu_torch")
        if _configured:
            root.setLevel(level.upper())
            return
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(_KVFormatter())
        root.addHandler(handler)
        root.setLevel(level.upper())
        root.propagate = False
        _configured = True


def get_logger(component: str) -> StructuredLogger:
    return StructuredLogger(component)
