"""The execution layer: the engine-API seam the beacon chain talks to an
execution client through, its HTTP JSON-RPC transport with JWT auth, the
in-process mock and the mock served over HTTP. The port's copy of
``lighthouse_tpu/execution_layer/``."""

from .auth import JwtKey  # noqa: F401
from .engine import (  # noqa: F401
    ExecutionEngine,
    PayloadAttributes,
    PayloadStatus,
    PayloadStatusV1,
)
from .http import EngineApiError, HttpExecutionEngine  # noqa: F401
from .json_server import ExecutionJsonRpcServer  # noqa: F401
from .mock import ExecutionBlockGenerator, MockExecutionLayer  # noqa: F401
