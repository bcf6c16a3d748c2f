"""The engine-API seam the beacon chain talks to an execution client
through: the port's copy of ``lighthouse_tpu/execution_layer/engine.py``.
The reference's HTTP transport and in-process mock are not ported."""

from .engine import (  # noqa: F401
    ExecutionEngine,
    PayloadAttributes,
    PayloadStatus,
    PayloadStatusV1,
)
