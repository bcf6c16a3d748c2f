"""Fault-domain layer between the port's serving engines and its device
backend: the port's copy of ``lighthouse_tpu/resilience`` (the BLS domain
and the generic API).

* ``faults``     — the fault taxonomy (transient / oom / hang / corruption),
  the classifier (CUDA's sticky errors are corruption) and the
  process-global classified-fault ring.
* ``supervisor`` — per-domain backend supervisors: watchdog deadlines for
  hang detection, bounded jittered-backoff retry for transients, and a
  HEALTHY → DEGRADED → QUARANTINED circuit breaker driving a degradation
  ladder (full device shape → reduced batch shape → oracle CPU fallback)
  so a device fault degrades throughput instead of dropping work.
* ``inject``     — the seeded, env-gated deterministic fault injector
  (``LIGHTHOUSE_FAULT_INJECT``) that makes any supervised stage raise,
  hang, or corrupt on the Nth call.

Import-light: no torch anywhere in this package — supervisors wrap device
calls, they never reach into them.

Canonical fault domain: ``bls_supervisor()`` guards batched BLS device
verification (and through it the firehose).
"""

from __future__ import annotations

from .faults import (  # noqa: F401
    FaultKind,
    FaultRecord,
    SupervisedFault,
    WatchdogTimeout,
    classify,
    classify_text,
    clear_fault_log,
    recent_faults,
    record_fault,
)
from .inject import (  # noqa: F401
    ENV_VAR as INJECT_ENV_VAR,
    FaultInjector,
    InjectedFault,
    injector,
    maybe_fault,
)
from .supervisor import (  # noqa: F401
    BackendSupervisor,
    HealthState,
    SupervisorConfig,
    all_supervisors,
    get_supervisor,
    reset_all,
    run_with_deadline,
    snapshot_all,
)

BLS_DOMAIN = "bls_device"


def bls_supervisor() -> BackendSupervisor:
    """The fault domain guarding batched BLS device verification."""
    return get_supervisor(BLS_DOMAIN)


def health_snapshot() -> dict:
    """Fault-domain health for /health + monitoring: per-domain supervisor
    snapshots plus the most recent classified faults."""
    return {
        "supervisors": snapshot_all(),
        "recent_faults": recent_faults(16),
        "injection_active": injector.active(),
    }
