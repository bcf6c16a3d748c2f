"""Overload protection: deadline propagation, admission control, adaptive
client pacing. The port's copy of ``lighthouse_tpu/loadshed`` (host Python,
no device work).

Four layers, each usable alone:

* :mod:`.deadline` — ingest-timestamp + per-work-type deadlines; queues drop
  expired work before any BLS/device dispatch.
* :mod:`.monitor` — ``LoadMonitor`` folds queue depth / drop rate /
  resilience-ladder state / worker lag into HEALTHY -> BUSY -> SATURATED;
  fails CLOSED (SATURATED) when sampling itself fails. Injection stage:
  ``loadshed.monitor_sample``.
* :mod:`.priorities` — P0/P1 HTTP route split and Req/Resp method priority
  classes; shedding is strictly lowest-priority-first.
* :mod:`.adaptive` — per-peer EWMA RTT timeouts (RFC 6298 shape), jittered
  exponential backoff with per-peer cooldown, and client-side self-limiting
  against a peer's rate quotas.
"""

from __future__ import annotations

from .adaptive import (  # noqa: F401
    BackoffPolicy,
    RttEstimator,
    SelfLimiter,
)
from .deadline import (  # noqa: F401
    DEFAULT_SLOT_SECONDS,
    budget_for,
    deadline_for,
    expired,
)
from .monitor import (  # noqa: F401
    AdmissionLevel,
    LoadMonitor,
    LoadThresholds,
)
from .priorities import (  # noqa: F401
    METHOD_PRIORITY,
    P0_ROUTES,
    is_p0_route,
    method_priority,
    shed_floor,
    should_shed_method,
)
