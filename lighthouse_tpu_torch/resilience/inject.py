"""Deterministic, env-gated fault injector for supervised stages: the port's
copy of ``lighthouse_tpu/resilience/inject.py`` (same grammar, same
``LIGHTHOUSE_FAULT_INJECT`` variable).

The chaos harness needs faults that are *reproducible*: the Nth device call
fails, every run, regardless of wall clock or thread timing. Each supervised
stage keeps a per-plan call counter, and a plan fires purely as a function
of that counter — no randomness on the firing decision (the ``seed`` field
exists so stochastic modes stay reproducible if ever added, and is embedded
in the plan's repr for provenance).

Activation is env-gated: ``LIGHTHOUSE_FAULT_INJECT`` is parsed once on
first use (tests use ``install()``/``clear()``/``reload_env()`` directly).
An empty/unset variable means the injector is completely inert — the hot
path pays one attribute read.

Spec grammar (clauses joined with ``|``, fields with ``;``)::

    LIGHTHOUSE_FAULT_INJECT="stage=bls.batch_verify;mode=raise;kind=transient;every=5"
    LIGHTHOUSE_FAULT_INJECT="stage=epoch.sweep;mode=hang;hang_s=0.5;at=3|stage=firehose.device_verify;mode=corrupt;at=2;times=1"

Fields:

* ``stage``  (required) — supervised stage name. Bare names match the
  *primary* (full-device) rung only; ``stage/rung`` targets a specific
  ladder rung; a trailing ``*`` prefix-matches.
* ``mode``   — ``raise`` (default), ``hang`` (sleep past the watchdog
  deadline), ``corrupt`` (raise a limb-bound-assert-shaped error, the
  *detected*-corruption fault: the certifier's bound asserts are exactly
  what turns silent bad numerics into a classified fault), or the crash
  modes ``kill`` / ``tear`` (simulate the process dying at a persistence
  barrier — consumed ONLY through ``crash_action`` by the crash-point
  hooks in ``crashpoints.py``, never by ``before_call``, so a supervised
  device stage can never accidentally absorb a "process death").
* ``kind``   — for ``raise``: ``transient`` (default) or ``oom``.
* ``every=K`` / ``at=N`` — fire on every Kth call / only on the Nth call.
* ``times=T`` — stop after T firings (default unlimited).
* ``hang_s`` — sleep length for ``hang`` (default 0.25 s).
* ``seed``   — recorded for provenance; reserved for stochastic modes.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from .faults import FaultKind

ENV_VAR = "LIGHTHOUSE_FAULT_INJECT"


class InjectedFault(RuntimeError):
    """A fault raised by the injector; carries its taxonomy kind so
    ``faults.classify`` never has to guess."""

    def __init__(self, kind: FaultKind, stage: str, call_no: int):
        msg = {
            FaultKind.TRANSIENT: "injected transient host error",
            FaultKind.OOM: "injected RESOURCE_EXHAUSTED: out of memory "
                           "allocating device buffer",
            FaultKind.CORRUPTION: "injected limb bound assert tripped: "
                                  "corrupted device output",
            FaultKind.HANG: "injected hang",
        }[kind]
        super().__init__(f"{msg} (stage={stage}, call #{call_no})")
        self.fault_kind = kind.value
        self.stage = stage
        self.call_no = call_no


@dataclass
class _Plan:
    stage: str
    mode: str = "raise"                 # raise | hang | corrupt
    kind: FaultKind = FaultKind.TRANSIENT
    every: int | None = None
    at: int | None = None
    times: int | None = None
    hang_s: float = 0.25
    seed: int = 0
    calls: int = 0
    fired: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def matches(self, stage: str) -> bool:
        if self.stage.endswith("*"):
            return stage.startswith(self.stage[:-1])
        return stage == self.stage

    def should_fire(self) -> bool:
        """Count this call; decide deterministically. Thread-safe: the
        counter is the only shared decision input."""
        with self._lock:
            self.calls += 1
            if self.times is not None and self.fired >= self.times:
                return False
            hit = False
            if self.at is not None:
                hit = self.calls == self.at
            elif self.every is not None:
                hit = self.calls % self.every == 0
            if hit:
                self.fired += 1
            return hit

    def as_dict(self) -> dict:
        return {
            "stage": self.stage, "mode": self.mode, "kind": self.kind.value,
            "every": self.every, "at": self.at, "times": self.times,
            "hang_s": self.hang_s, "seed": self.seed,
            "calls": self.calls, "fired": self.fired,
        }


def _parse_clause(clause: str) -> _Plan:
    kw: dict = {}
    for pair in clause.split(";"):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"bad injection field {pair!r} (want key=value)")
        k, v = (s.strip() for s in pair.split("=", 1))
        if k == "stage":
            kw["stage"] = v
        elif k == "mode":
            if v not in ("raise", "hang", "corrupt", "kill", "tear"):
                raise ValueError(f"unknown injection mode {v!r}")
            kw["mode"] = v
        elif k == "kind":
            kw["kind"] = FaultKind(v)
        elif k in ("every", "at", "times", "seed"):
            kw[k] = int(v)
        elif k == "hang_s":
            kw["hang_s"] = float(v)
        else:
            raise ValueError(f"unknown injection field {k!r}")
    if "stage" not in kw:
        raise ValueError(f"injection clause missing stage=: {clause!r}")
    if kw.get("mode") == "corrupt":
        kw["kind"] = FaultKind.CORRUPTION
    if "every" not in kw and "at" not in kw:
        kw["at"] = 1
    return _Plan(**kw)


class FaultInjector:
    """Process-global registry of injection plans (see module docstring)."""

    def __init__(self):
        self._plans: list[_Plan] = []
        self._lock = threading.Lock()
        self._env_loaded = False

    # -- configuration -----------------------------------------------------

    def install(self, spec: str) -> list[_Plan]:
        """Parse + add plans from a spec string. Returns the new plans."""
        plans = [_parse_clause(c) for c in spec.split("|") if c.strip()]
        with self._lock:
            self._env_loaded = True  # explicit install overrides env gating
            self._plans.extend(plans)
        return plans

    def clear(self) -> None:
        with self._lock:
            self._plans = []
            self._env_loaded = True

    def reload_env(self) -> None:
        """Drop all plans and re-read LIGHTHOUSE_FAULT_INJECT."""
        with self._lock:
            self._plans = []
            self._env_loaded = False
        self._ensure_env()

    def _ensure_env(self) -> None:
        if self._env_loaded:
            return
        with self._lock:
            if self._env_loaded:
                return
            self._env_loaded = True
            spec = os.environ.get(ENV_VAR, "").strip()
            if spec:
                self._plans.extend(
                    _parse_clause(c) for c in spec.split("|") if c.strip()
                )

    def active(self) -> bool:
        self._ensure_env()
        return bool(self._plans)

    def plans(self) -> list[dict]:
        self._ensure_env()
        with self._lock:
            return [p.as_dict() for p in self._plans]

    # -- the supervised-stage hook ----------------------------------------

    def before_call(self, stage: str) -> None:
        """Called by the supervisor at every rung invocation with the
        injection-qualified stage name. May sleep (hang) or raise."""
        self._ensure_env()
        if not self._plans:
            return
        with self._lock:
            plans = list(self._plans)
        for p in plans:
            if p.mode in ("kill", "tear"):
                continue  # crash plans fire only via crash_action
            if not p.matches(stage) or not p.should_fire():
                continue
            if p.mode == "hang":
                time.sleep(p.hang_s)  # a *slow* call: the watchdog decides
                continue
            raise InjectedFault(p.kind, stage, p.calls)

    def crash_action(self, stage: str) -> str | None:
        """Called by crash-point hooks (``crashpoints.maybe_crash``) at
        every persistence barrier. Counts the call on each matching
        kill/tear plan and returns the mode of the first plan that fires
        (``"kill"`` | ``"tear"``), else None. Counters are crash-plan
        private: ``before_call`` never ticks them, so "the Nth persistence
        op" is exact regardless of interleaved device-fault plans."""
        self._ensure_env()
        if not self._plans:
            return None
        with self._lock:
            plans = list(self._plans)
        action = None
        for p in plans:
            if p.mode not in ("kill", "tear") or not p.matches(stage):
                continue
            if p.should_fire() and action is None:
                action = p.mode
        return action


injector = FaultInjector()
maybe_fault = injector.before_call
