"""Crash-point injection: deterministic process-kill simulation at
persistence barriers. The port's copy of
``lighthouse_tpu/resilience/crashpoints.py``.

The fault injector (``inject.py``) makes a supervised *device* stage raise a
fault the resilience ladder absorbs. Crash points are the opposite contract:
they simulate the process DYING at a persistence barrier — nothing may
absorb them, because nothing absorbs a ``kill -9``. Hence
``InjectedCrash`` derives from ``BaseException``: every ``except Exception``
handler on the stack (observer shields, chaos-mode proposal tolerance,
supervisor rungs) lets it through, exactly like a real kill, and only the
test harness — playing the role of the operating system — catches it and
marks the node dead.

Two modes ride the existing ``LIGHTHOUSE_FAULT_INJECT`` grammar:

* ``mode=kill`` — die BEFORE the barrier's bytes are written (the op never
  happened);
* ``mode=tear`` — persist a deterministic prefix of the write, then die
  (the torn-tail case WAL replay must truncate). Only barriers that own a
  byte stream honor tear (``store.commit``, ``store.compact``); elsewhere
  it degrades to kill.

Enumerable barrier stages (the crash-point sweep kills at the Nth firing of
each): ``store.commit`` (every WAL frame: block import, state writes, the
finalization migration's freeze/prune batches, slasher checkpoints...),
``store.compact`` / ``store.compact.replace``, ``persist.fork_choice``,
``persist.op_pool``, ``persist.slasher``, ``persist.slashing_protection``,
``migrate.finalization``. Counting a sweep's total barriers needs no extra
machinery: install a never-firing plan (``at=10**9``) and read its
``calls`` counter back from ``injector.plans()``.
"""

from __future__ import annotations

from .inject import injector

CRASH_MODES = ("kill", "tear")


class InjectedCrash(BaseException):
    """The process "died" at a persistence barrier. BaseException on
    purpose — see the module docstring; only the chaos harness catches it."""

    def __init__(self, stage: str, owner: str | None = None, torn: bool = False):
        what = "torn write" if torn else "killed"
        suffix = f" [{owner}]" if owner else ""
        super().__init__(f"injected crash: {what} at {stage}{suffix}")
        self.stage = stage
        self.owner = owner
        self.torn = torn


def raise_crash(stage: str, owner: str | None = None, torn: bool = False):
    raise InjectedCrash(stage, owner=owner, torn=torn)


def maybe_crash(
    stage: str, owner: str | None = None, tear_capable: bool = False
) -> str | None:
    """The barrier hook. Returns ``None`` (no plan fired) or ``"tear"``
    (only when the caller declared ``tear_capable`` — it owns the byte
    stream: persist a prefix, then call ``raise_crash(..., torn=True)``).
    ``kill`` raises here; a ``tear`` plan at a barrier that cannot tear
    degrades to kill. Inert — one attribute read — unless
    ``LIGHTHOUSE_FAULT_INJECT`` armed plans."""
    if not injector.active():
        return None
    action = injector.crash_action(stage)
    if action == "kill" or (action == "tear" and not tear_capable):
        raise_crash(stage, owner=owner)
    return action
