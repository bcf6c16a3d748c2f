"""Fault taxonomy + classifier for the device fault domain: the port's copy
of ``lighthouse_tpu/resilience/faults.py``, with CUDA's errors classified.

Every failure on a device path (BLS batch verify, firehose pipeline stage)
is classified into one of four kinds before any
policy decision is made — replacing the bare ``except Exception`` blocks
that used to drop a batch silently:

* ``TRANSIENT``  — host/tunnel hiccup (connection reset, UNAVAILABLE,
  ABORTED): safe to retry in place with jittered backoff.
* ``OOM``        — device allocation failure (RESOURCE_EXHAUSTED,
  ``MemoryError``): retrying the same shape is futile; the degradation
  ladder drops to a reduced batch shape.
* ``HANG``       — a call that blew past its watchdog deadline (a wedged
  device call). The device may still be executing;
  the worker thread cannot be killed, so the supervisor counts the stranded
  thread and demotes.
* ``CORRUPTION`` — a tripped limb-bound assert, NaN, or parity mismatch:
  the device's *numerics* are suspect, so no device rung can be trusted —
  the ladder jumps straight to the oracle CPU fallback.

Classification is type-first (``WatchdogTimeout``, ``MemoryError``,
``TimeoutError``, injected faults carry their kind), then marker-based on
the rendered message. Unknown faults default to TRANSIENT: one bounded
retry is cheap, and the ladder below it keeps the verdict honest either way.

CUDA's errors, which the reference's XLA markers do not know:

* ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory") is OOM, by the
  existing "out of memory" marker.
* Sticky errors ("an illegal memory access was encountered", "unspecified
  launch failure", "device-side assert triggered", a misaligned address,
  an illegal instruction) leave the process's CUDA context dead: every
  later call on it fails. They are CORRUPTION, checked before every other
  marker, so the supervisor never retries on a dead context; without a
  CPU rung the ladder exhausts and the batch fails closed.
* The kernels' ctypes wrappers raise "plan kernel launch failed: CUDA
  error N" / "chain kernel launch failed: CUDA error N" with the runtime's
  ``cudaError_t`` code. A sticky code (700 illegal address, 710 assert,
  715 illegal instruction, 716 misaligned address, 719 launch failure) is
  CORRUPTION; any other code (an invalid launch configuration, a resource
  limit) leaves the context usable and falls to the marker rules, so the
  ladder retries it and then tries its reduced shape.

Classified faults are appended to a process-global ring (``recent_faults``)
and counted into ``utils.metrics`` so degradation is observable from the
``/metrics`` and ``/health`` surfaces.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

from ..utils.metrics import RESILIENCE_FAULTS


class FaultKind(str, Enum):
    TRANSIENT = "transient"
    OOM = "oom"
    HANG = "hang"
    CORRUPTION = "corruption"


class WatchdogTimeout(TimeoutError):
    """A supervised call exceeded its watchdog deadline (classified HANG)."""

    def __init__(self, stage: str, deadline_s: float):
        super().__init__(
            f"{stage}: no result within the {deadline_s:.3g}s watchdog deadline"
        )
        self.stage = stage
        self.deadline_s = deadline_s


class SupervisedFault(RuntimeError):
    """Every rung of a supervised ladder failed. Carries the last underlying
    fault; callers treat it as "this work has no trustworthy verdict" (fail
    closed — never a false verify)."""

    def __init__(self, stage: str, last: BaseException | None):
        super().__init__(f"{stage}: all rungs exhausted ({last!r})")
        self.stage = stage
        self.last = last


# CUDA errors after which the context is dead (checked first, see above):
# torch's rendered texts, and the cudaError_t codes the launch wrappers give
_CUDA_STICKY_MARKERS = ("illegal memory access", "unspecified launch failure",
                        "device-side assert", "misaligned address",
                        "illegal instruction")
_CUDA_STICKY_CODES = frozenset({700, 710, 715, 716, 719})
_CUDA_CODE = re.compile(r"cuda error (\d+)")

# marker tables, matched against the lowercased "TypeName: message" render.
# Order matters: oom > hang > corruption > transient — a RESOURCE_EXHAUSTED
# message saying "limit exceeded" is an OOM-shaped status, not a hang, and
# a misread sends the hunter to a BIGGER rung that will OOM again.
_HANG_MARKERS = ("watchdog deadline", "deadline_exceeded", "timed out",
                 "timeout", "hung", "wedged", "exceeded")
_OOM_MARKERS = ("resource_exhausted", "out of memory", "memoryerror",
                "failed to allocate", "allocation failure", "oom")
_CORRUPTION_MARKERS = ("limb bound", "bound assert", "out_bound", "nan",
                       "corrupt", "parity mismatch", "checkify")
_TRANSIENT_MARKERS = ("unavailable", "aborted", "connection", "broken pipe",
                      "internal", "cancelled", "socket", "reset by peer",
                      "transient")


def classify_text(text: str) -> FaultKind:
    """Classify a rendered error message / subprocess note (the hunter's
    probe notes come through here — a subprocess killed by its timeout is
    the out-of-process watchdog firing)."""
    low = text.lower()
    if any(int(n) in _CUDA_STICKY_CODES for n in _CUDA_CODE.findall(low)):
        return FaultKind.CORRUPTION
    for markers, kind in (
        (_CUDA_STICKY_MARKERS, FaultKind.CORRUPTION),
        (_OOM_MARKERS, FaultKind.OOM),
        (_HANG_MARKERS, FaultKind.HANG),
        (_CORRUPTION_MARKERS, FaultKind.CORRUPTION),
        (_TRANSIENT_MARKERS, FaultKind.TRANSIENT),
    ):
        if any(m in low for m in markers):
            return kind
    return FaultKind.TRANSIENT


def classify(exc: BaseException) -> FaultKind:
    """Fault kind for an exception raised on a supervised device path."""
    injected = getattr(exc, "fault_kind", None)  # inject.InjectedFault
    if injected is not None:
        return FaultKind(injected)
    if isinstance(exc, WatchdogTimeout):
        return FaultKind.HANG
    if isinstance(exc, MemoryError):
        return FaultKind.OOM
    if isinstance(exc, (FloatingPointError, AssertionError)):
        return FaultKind.CORRUPTION
    if isinstance(exc, TimeoutError):
        return FaultKind.HANG
    return classify_text(f"{type(exc).__name__}: {exc}")


@dataclass
class FaultRecord:
    """One classified fault event (the structured record that replaces a
    silent drop)."""

    stage: str
    kind: FaultKind
    error: str
    domain: str = ""
    rung: str = ""
    attempt: int = 1
    ts: float = field(default_factory=time.time)
    # OOM faults only: the static-memory model's view of the faulting domain
    # (analysis.memory.fault_memory_context)
    memory: dict | None = None

    def as_dict(self) -> dict:
        d = {
            "stage": self.stage,
            "kind": self.kind.value,
            "error": self.error,
            "domain": self.domain,
            "rung": self.rung,
            "attempt": self.attempt,
            "ts": self.ts,
        }
        if self.memory is not None:
            d["memory"] = self.memory
        return d


_LOG_DEPTH = 512
_log: deque = deque(maxlen=_LOG_DEPTH)
_log_lock = threading.Lock()


def record_fault(
    stage: str,
    exc: BaseException | str,
    kind: FaultKind | None = None,
    domain: str = "",
    rung: str = "",
    attempt: int = 1,
) -> FaultRecord:
    """Classify + append one fault to the process ring and the metrics
    registry. Returns the record (callers log/propagate it as they like)."""
    if kind is None:
        kind = classify(exc) if isinstance(exc, BaseException) else classify_text(exc)
    err = (
        f"{type(exc).__name__}: {exc}" if isinstance(exc, BaseException) else str(exc)
    )
    mem = None
    if kind is FaultKind.OOM:
        from ..analysis.memory import fault_memory_context  # never raises

        mem = fault_memory_context(domain or stage)
    rec = FaultRecord(
        stage=stage, kind=kind, error=err[:500], domain=domain, rung=rung,
        attempt=attempt, memory=mem,
    )
    with _log_lock:
        _log.append(rec)
    RESILIENCE_FAULTS.inc(domain=domain or stage, stage=stage, kind=kind.value)
    return rec


def recent_faults(n: int = 32) -> list[dict]:
    """Most recent classified faults, newest last (the /health payload)."""
    with _log_lock:
        return [r.as_dict() for r in list(_log)[-n:]]


def clear_fault_log() -> None:
    """Test hook: empty the ring so scenarios assert on their own faults."""
    with _log_lock:
        _log.clear()
