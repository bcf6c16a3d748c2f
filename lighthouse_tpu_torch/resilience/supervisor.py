"""Backend supervisor: watchdog, bounded retry, and the degradation ladder.

The port's copy of ``lighthouse_tpu/resilience/supervisor.py``: the same
health machine, counters and metrics. One ``BackendSupervisor`` guards one
fault domain (the BLS device backend, a firehose run). Every supervised call runs through
``run_ladder(stage, rungs)`` where ``rungs`` is the degradation ladder for
that call — typically::

    (full device shape, reduced batch shape, native/oracle CPU fallback)

Policy per classified fault kind (``faults.classify``):

* TRANSIENT  — retried in place up to ``max_retries`` with seeded jittered
  backoff; only then does the ladder descend.
* OOM        — no same-shape retry (futile); descend immediately: the next
  rung is the reduced shape.
* HANG       — watchdog fired; the worker thread may be stranded inside the
  device client forever (it cannot be killed). Descend immediately; the
  stranded-thread count is capped (``max_hung_threads``) — past the cap the
  domain is hard-quarantined so a wedged tunnel cannot accumulate threads.
* CORRUPTION — device numerics suspect; jump straight to the LAST rung
  (CPU fallback) and quarantine.

Health state machine (circuit breaker)::

    HEALTHY --fault--> DEGRADED --fault--> QUARANTINED
       ^                  |                     |
       +--(promote_after  |                     | probation_s cool-off,
       |   consecutive    |                     | then ONE probe call at
       |   full-rung OKs) |                     | the full rung
       +------------------+---- probe OK -------+

* HEALTHY     — calls start at rung 0 (full device shape).
* DEGRADED    — calls start at rung 1 (reduced shape); every
  ``probe_every``-th call starts at rung 0 as a promotion probe.
* QUARANTINED — calls start at the last rung (CPU fallback; device never
  touched); after ``probation_s`` the next call probes rung 0. A probe
  success re-promotes one level; ``promote_after`` consecutive full-rung
  successes then restore HEALTHY. Never total loss of service: whatever
  the state, some rung answers — a call fails only when every rung faults
  (``SupervisedFault``, counted as ``exhausted``; callers fail CLOSED).

Everything is observable: per-domain health gauge, fault/demotion/promotion/
retry/fallback counters in ``utils.metrics``, and ``snapshot()`` for
/health, bench records, and the chaos assertions.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from enum import IntEnum

from ..utils.metrics import (
    RESILIENCE_DEMOTIONS,
    RESILIENCE_FALLBACK_CALLS,
    RESILIENCE_HEALTH,
    RESILIENCE_PROMOTIONS,
    RESILIENCE_RETRIES,
    RESILIENCE_WATCHDOG_TIMEOUTS,
)
from . import faults
from .faults import FaultKind, SupervisedFault, WatchdogTimeout
from .inject import maybe_fault


class HealthState(IntEnum):
    HEALTHY = 0
    DEGRADED = 1
    QUARANTINED = 2


def _default_deadline() -> float:
    # generous by default: a COLD first call builds the kernels (nvcc) and
    # derives every plan schedule at the new row counts — the watchdog must
    # catch wedged-forever, not a slow first call. Benches tighten it via
    # the env var once warm.
    return float(os.environ.get("LIGHTHOUSE_WATCHDOG_S", "600"))


@dataclass
class SupervisorConfig:
    deadline_s: float | None = None     # None -> LIGHTHOUSE_WATCHDOG_S (600)
    max_retries: int = 2                # transient retries per rung
    backoff_base_s: float = 0.05
    backoff_max_s: float = 1.0
    seed: int = 0                       # jitter determinism (chaos runs)
    promote_after: int = 3              # full-rung OKs to climb one level
    probe_every: int = 4                # DEGRADED: probe rung 0 every Nth call
    probation_s: float = 5.0            # QUARANTINED cool-off before a probe
    max_hung_threads: int = 4           # stranded watchdog workers cap

    def resolved_deadline(self) -> float | None:
        d = self.deadline_s if self.deadline_s is not None else _default_deadline()
        return d if d and d > 0 else None


class BackendSupervisor:
    def __init__(self, name: str, config: SupervisorConfig | None = None):
        self.name = name
        self.config = config or SupervisorConfig()
        seed = int(os.environ.get("LIGHTHOUSE_RESILIENCE_SEED",
                                  str(self.config.seed)))
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self.state = HealthState.HEALTHY
        self._streak = 0                # consecutive full-rung successes
        self._calls_since_demotion = 0
        self._quarantined_at: float | None = None
        self._hung_threads = 0
        self._hard_quarantined = False
        # counters (all monotonic; exposed via snapshot() + metrics)
        self.calls = 0
        self.retries = 0
        self.demotions = 0
        self.promotions = 0
        self.fallback_calls = 0         # answered below rung 0
        self.watchdog_timeouts = 0
        self.exhausted = 0              # every rung failed (fail-closed)
        self.faults_seen = 0
        RESILIENCE_HEALTH.set(0, domain=name)

    # -- health machine ----------------------------------------------------

    def _set_state(self, new: HealthState) -> None:
        """Caller holds the lock."""
        if new == self.state:
            return
        if new > self.state:
            self.demotions += 1
            RESILIENCE_DEMOTIONS.inc(domain=self.name)
            self._calls_since_demotion = 0
        else:
            self.promotions += 1
            RESILIENCE_PROMOTIONS.inc(domain=self.name)
        self.state = new
        self._streak = 0
        self._quarantined_at = (
            time.monotonic() if new == HealthState.QUARANTINED else None
        )
        RESILIENCE_HEALTH.set(int(new), domain=self.name)

    def _probation_due(self) -> bool:
        return (
            self._quarantined_at is not None
            and time.monotonic() - self._quarantined_at >= self.config.probation_s
        )

    def device_allowed(self) -> bool:
        """May the full device rung be attempted right now? (A caller's cheap
        pre-check: in quarantine the device path is skipped entirely until
        probation.)"""
        with self._lock:
            if self._hard_quarantined:
                return False
            if self.state != HealthState.QUARANTINED:
                return True
            return self._probation_due()

    def note_fallback(self, rung: str = "external") -> None:
        """Record that the caller served this request from its own fallback
        path (one that lives outside the ladder)."""
        with self._lock:
            self.fallback_calls += 1
        RESILIENCE_FALLBACK_CALLS.inc(domain=self.name, rung=rung)

    def _start_rung(self, n_rungs: int, cpu_idx: int | None) -> int | None:
        """First ladder rung for this call, or None when quarantine demands
        a device-free rung and the ladder has none (caller fails closed)."""
        with self._lock:
            self._calls_since_demotion += 1
            if self.state == HealthState.HEALTHY:
                return 0
            if self.state == HealthState.DEGRADED:
                if self._calls_since_demotion % self.config.probe_every == 0:
                    return 0            # promotion probe
                return min(1, n_rungs - 1)
            if self._probation_due():
                return 0                # quarantine probation probe
            # QUARANTINED: the device is not trusted — only a cpu* rung may
            # serve; a ladder without one fails closed
            return cpu_idx

    def _on_full_rung_success(self) -> None:
        with self._lock:
            if self.state == HealthState.QUARANTINED:
                self._set_state(HealthState.DEGRADED)
                self._streak = 1
            elif self.state == HealthState.DEGRADED:
                self._streak += 1
                if self._streak >= self.config.promote_after:
                    self._set_state(HealthState.HEALTHY)
            else:
                self._streak += 1

    def _on_rung_fault(self, kind: FaultKind) -> None:
        with self._lock:
            self._streak = 0
            if kind == FaultKind.CORRUPTION:
                target = HealthState.QUARANTINED
            elif self.state == HealthState.HEALTHY:
                target = HealthState.DEGRADED
            else:
                target = HealthState.QUARANTINED
            if (
                target == HealthState.QUARANTINED
                and self.state == HealthState.QUARANTINED
            ):
                # a failed probation probe restarts the cool-off clock
                self._quarantined_at = time.monotonic()
            self._set_state(target)

    # -- watchdog ----------------------------------------------------------

    def _with_watchdog(self, stage: str, fn):
        # one daemon thread per supervised call (~50-100us): noise next to
        # the ms-scale device dispatch it guards. If a profile ever shows
        # it on the serving path, the upgrade is a persistent worker with a
        # request queue — same hang semantics, amortized thread cost.
        deadline = self.config.resolved_deadline()
        if deadline is None:
            return fn()
        box: dict = {}
        done = threading.Event()
        timed_out = threading.Event()

        def worker():
            try:
                box["v"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box["e"] = e
            finally:
                done.set()
                # the timeout-vs-completion decision is made under the
                # supervisor lock below; taking the same lock here makes the
                # hung-thread accounting race-free in both interleavings
                with self._lock:
                    if timed_out.is_set():
                        # the stranded call eventually returned: un-count it,
                        # and lift the hard quarantine once the backlog
                        # drains — the domain then recovers through the
                        # NORMAL probation path instead of staying pinned
                        # to the last rung until process restart
                        self._hung_threads -= 1
                        if self._hung_threads < self.config.max_hung_threads:
                            self._hard_quarantined = False

        # watchdog workers are deliberately never joined: a wedged device
        # call cannot be killed, so the hang model ABANDONS the thread and
        # counts it against max_hung_threads instead (bounded by the hard
        # quarantine); done.wait(deadline) is the bounded reclaim
        th = threading.Thread(  # lint: allow(unjoined-thread)
            target=worker, daemon=True, name=f"watchdog-{self.name}-{stage}"
        )
        th.start()
        if not done.wait(deadline):
            with self._lock:
                if not done.is_set():   # decide under the lock: truly hung
                    timed_out.set()
                    self._hung_threads += 1
                    self.watchdog_timeouts += 1
                    if self._hung_threads >= self.config.max_hung_threads:
                        # a wedged tunnel must not accumulate threads
                        self._hard_quarantined = True
                        self._set_state(HealthState.QUARANTINED)
                    fire = True
                else:
                    fire = False        # result arrived at the deadline: use it
            if fire:
                RESILIENCE_WATCHDOG_TIMEOUTS.inc(domain=self.name, stage=stage)
                raise WatchdogTimeout(stage, deadline)
        if "e" in box:
            raise box["e"]
        return box["v"]

    # -- the supervised call -----------------------------------------------

    def _backoff(self, attempt: int) -> float:
        base = min(
            self.config.backoff_max_s,
            self.config.backoff_base_s * (2 ** (attempt - 1)),
        )
        with self._lock:
            jitter = self._rng.uniform(0.5, 1.0)
        return base * jitter

    def _attempt_rung(self, stage: str, rung_name: str, fn, rung_idx: int):
        """One ladder rung with bounded transient retries. Raises the last
        exception when the rung is out of retries (ladder descends)."""
        attempt = 0
        while True:
            attempt += 1
            with self._lock:
                self.calls += 1
            # bare stage names target the primary rung; lower rungs are
            # addressable as "stage/rung" (see inject.py)
            inj_name = stage if rung_idx == 0 else f"{stage}/{rung_name}"

            def guarded():
                # injection runs INSIDE the watchdog so a hang-mode plan is
                # detected the way a real wedged call would be
                maybe_fault(inj_name)
                return fn()

            try:
                return self._with_watchdog(stage, guarded)
            except Exception as e:  # noqa: BLE001 — classified below
                kind = faults.classify(e)
                with self._lock:
                    self.faults_seen += 1
                faults.record_fault(
                    stage, e, kind=kind, domain=self.name, rung=rung_name,
                    attempt=attempt,
                )
                retryable = (
                    kind == FaultKind.TRANSIENT
                    and attempt <= self.config.max_retries
                )
                if not retryable:
                    raise
                with self._lock:
                    self.retries += 1
                RESILIENCE_RETRIES.inc(domain=self.name, stage=stage)
                time.sleep(self._backoff(attempt))

    def run_ladder(self, stage: str, rungs) -> object:
        """Run one supervised call down the degradation ladder.

        ``rungs``: sequence of ``(rung_name, thunk)``, full shape first,
        CPU fallback last. Returns the first rung result; raises
        ``SupervisedFault`` only when every reachable rung faulted.
        A ``False`` verdict from a verifier is a RESULT, never a fault —
        the supervisor only ever reacts to exceptions.

        Rung names starting with ``cpu`` mark device-free rungs: under a
        HARD quarantine (hung-thread cap hit — the backend is wedged with
        stranded threads) only those are eligible; a ladder with no cpu
        rung fails closed immediately rather than feeding more threads
        into the wedge.
        """
        rungs = list(rungs)
        n = len(rungs)
        cpu = next(
            (i for i, (nm, _) in enumerate(rungs) if nm.startswith("cpu")),
            None,
        )
        with self._lock:
            hard = self._hard_quarantined
        last: BaseException | None = None
        r = cpu if hard else self._start_rung(n, cpu)
        if r is None:  # quarantined ladder with no device-free rung
            with self._lock:
                self.exhausted += 1
            raise SupervisedFault(stage, None)
        while r < n:
            name, fn = rungs[r]
            try:
                result = self._attempt_rung(stage, name, fn, r)
            except Exception as e:  # noqa: BLE001 — rung exhausted
                last = e
                kind = faults.classify(e)
                self._on_rung_fault(kind)
                if kind == FaultKind.CORRUPTION:
                    # device numerics suspect: NOTHING device-shaped can be
                    # trusted — only a cpu* rung may finish this call
                    if cpu is None or cpu <= r:
                        break
                    r = cpu
                else:
                    r += 1
                continue
            if r == 0:
                self._on_full_rung_success()
            else:
                with self._lock:
                    self.fallback_calls += 1
                RESILIENCE_FALLBACK_CALLS.inc(domain=self.name, rung=name)
            return result
        with self._lock:
            self.exhausted += 1
        raise SupervisedFault(stage, last)

    def run(self, stage: str, fn):
        """Single-rung supervised call (watchdog + retries + health), for
        domains whose fallback lives outside the ladder."""
        return self.run_ladder(stage, ((stage.rsplit(".", 1)[-1], fn),))

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state.name,
                "calls": self.calls,
                "faults": self.faults_seen,
                "retries": self.retries,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "fallback_calls": self.fallback_calls,
                "watchdog_timeouts": self.watchdog_timeouts,
                "hung_threads": self._hung_threads,
                "hard_quarantined": self._hard_quarantined,
                "exhausted": self.exhausted,
            }

    def reset(self) -> None:
        """Test hook: back to a fresh HEALTHY supervisor (counters zeroed)."""
        with self._lock:
            self.state = HealthState.HEALTHY
            self._streak = 0
            self._calls_since_demotion = 0
            self._quarantined_at = None
            self._hung_threads = 0
            self._hard_quarantined = False
            self.calls = self.retries = self.demotions = 0
            self.promotions = self.fallback_calls = self.watchdog_timeouts = 0
            self.exhausted = self.faults_seen = 0
            self._rng = random.Random(self.config.seed)
        RESILIENCE_HEALTH.set(0, domain=self.name)


# -- process-global registry ----------------------------------------------------

_REGISTRY: dict[str, BackendSupervisor] = {}
_REGISTRY_LOCK = threading.Lock()


def get_supervisor(
    name: str, config: SupervisorConfig | None = None
) -> BackendSupervisor:
    """Named supervisor, one per fault domain, created on first use.
    ``config`` only applies on creation — a domain's policy is process-wide."""
    with _REGISTRY_LOCK:
        sup = _REGISTRY.get(name)
        if sup is None:
            sup = _REGISTRY[name] = BackendSupervisor(name, config)
        return sup


def all_supervisors() -> dict[str, BackendSupervisor]:
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)


def snapshot_all() -> dict:
    """{domain: snapshot} for every supervisor that has been created —
    the /health payload and the bench-record integrity stamp."""
    return {name: sup.snapshot() for name, sup in all_supervisors().items()}


def reset_all() -> None:
    """Test hook: reset every registered supervisor to HEALTHY."""
    for sup in all_supervisors().values():
        sup.reset()


def run_with_deadline(stage: str, fn, deadline_s: float):
    """Standalone watchdog call (no health machine): bounds a helper call —
    raises ``WatchdogTimeout`` on a hang."""
    box: dict = {}
    done = threading.Event()

    def worker():
        try:
            box["v"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box["e"] = e
        finally:
            done.set()

    # same abandonment contract as _with_watchdog: the probe thread may be
    # wedged inside the device client and cannot be joined
    th = threading.Thread(target=worker, daemon=True, name=f"watchdog-{stage}")  # lint: allow(unjoined-thread)
    th.start()
    if not done.wait(deadline_s):
        raise WatchdogTimeout(stage, deadline_s)
    if "e" in box:
        raise box["e"]
    return box["v"]
