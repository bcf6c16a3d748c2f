"""Admission-level monitor: HEALTHY -> BUSY -> SATURATED.

A ``LoadMonitor`` folds queue depths, drop rates, resilience-ladder health
and worker lag from any number of attached sources into one admission level
that every shedding surface (HTTP API gate, Req/Resp method shedding) reads.

Sampling is PASSIVE: ``level()`` recomputes from the sources at most once
per ``min_sample_interval`` — no monitor thread exists, so there is nothing
to join and nothing that can wedge. A source that raises (or an injected
fault on the ``loadshed.monitor_sample`` stage) drives the monitor to
SATURATED: when we cannot see the load, we fail CLOSED toward shedding
deferrable work, never toward unbounded admission.

Source protocol: a zero-arg callable returning a dict with any subset of
  fill        float 0..1   worst queue-fill fraction this source sees
  submitted   int          cumulative accepted work (for drop-rate windows)
  dropped     int          cumulative dropped work
  lag_s       float        age of the oldest queued item (worker lag)
  degraded    bool         a resilience ladder is off its primary rung
  quarantined bool         a resilience ladder is quarantined / exhausted
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass

from ..resilience import maybe_fault
from ..utils.metrics import ADMISSION_LEVEL, ADMISSION_TRANSITIONS


class AdmissionLevel(enum.IntEnum):
    HEALTHY = 0
    BUSY = 1
    SATURATED = 2


@dataclass
class LoadThresholds:
    """Trip points. Defaults: queues half full or any recent drops or a
    degraded ladder = BUSY; queues near capacity, sustained drop rate, long
    worker lag or a quarantined ladder = SATURATED."""

    busy_fill: float = 0.50
    saturated_fill: float = 0.90
    busy_lag_s: float = 1.0
    saturated_lag_s: float = 4.0
    saturated_drop_rate: float = 0.05   # drops / submissions over the window
    min_sample_interval: float = 0.05


class LoadMonitor:
    def __init__(self, thresholds: LoadThresholds | None = None,
                 clock=time.monotonic):
        self.thresholds = thresholds or LoadThresholds()
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: list[tuple[str, object]] = []
        self._level = AdmissionLevel.HEALTHY
        self._forced: AdmissionLevel | None = None
        self._last_sample_t = float("-inf")
        # per-source cumulative (submitted, dropped) at the previous sample,
        # for windowed drop-rate computation
        self._prev: dict[str, tuple[int, int]] = {}
        self._transitions: list[tuple[float, str, str]] = []
        self._sample_failures = 0

    # -- sources -----------------------------------------------------------

    def add_source(self, name: str, fn) -> None:
        with self._lock:
            self._sources.append((name, fn))

    def attach_processor(self, proc) -> None:
        """Sample a BeaconProcessor's queues + drop counters. Reads are
        GIL-atomic snapshots (len / int loads); sampling never takes the
        processor's lock, so the monitor can't add scheduler contention."""

        def sample():
            lengths = proc.config.queue_lengths
            fill = 0.0
            for t, q in proc.queues.items():
                limit = lengths.limit(t)
                if limit > 0:
                    fill = max(fill, len(q) / limit)
            return {
                "fill": fill,
                "submitted": sum(proc.processed.values()),
                "dropped": sum(proc.dropped.values()),
            }

        self.add_source("beacon_processor", sample)

    def attach_batcher(self, batcher) -> None:
        """Sample a firehose AdaptiveBatcher's intake depth + shed counts."""

        def sample():
            cap = max(1, batcher.config.intake_capacity)
            depth = batcher.depth()
            out = {
                "fill": depth / cap,
                "submitted": batcher.submitted,
                "dropped": batcher.dropped_total,
            }
            oldest = batcher.oldest_age()
            if oldest is not None:
                out["lag_s"] = oldest
            return out

        self.add_source("firehose_batcher", sample)

    def attach_supervisors(self, snapshot_fn=None) -> None:
        """Fold resilience-ladder state in: any DEGRADED domain is at least
        BUSY, any QUARANTINED/exhausted domain is SATURATED."""
        if snapshot_fn is None:
            from ..resilience import snapshot_all as snapshot_fn  # noqa: N813

        def sample():
            snaps = snapshot_fn()
            states = [s.get("state", "HEALTHY") for s in snaps.values()]
            return {
                "degraded": any(s == "DEGRADED" for s in states),
                "quarantined": any(
                    s == "QUARANTINED" or snap.get("exhausted")
                    for s, snap in zip(states, snaps.values())
                ),
            }

        self.add_source("resilience", sample)

    # -- level -------------------------------------------------------------

    def force_level(self, level: AdmissionLevel | None) -> None:
        """Pin the level (bench/test hook); None releases the pin."""
        with self._lock:
            self._forced = level
            if level is not None:
                self._note_transition_locked(level)
            else:
                # releasing the pin invalidates the sample cache, so the
                # next level() reads the true load, not the pinned residue
                self._last_sample_t = float("-inf")

    def level(self) -> AdmissionLevel:
        """Current admission level, resampling if the last sample is stale."""
        now = self._clock()
        with self._lock:
            if self._forced is not None:
                return self._forced
            if now - self._last_sample_t < self.thresholds.min_sample_interval:
                return self._level
        return self.sample()

    def sample(self) -> AdmissionLevel:
        """Resample every source now and fold into a level."""
        now = self._clock()
        with self._lock:
            sources = list(self._sources)
        try:
            maybe_fault("loadshed.monitor_sample")
            readings = [(name, fn()) for name, fn in sources]
            level = self._fold(readings)
        except Exception:  # noqa: BLE001 — incl. InjectedFault: fail closed
            with self._lock:
                self._sample_failures += 1
            level = AdmissionLevel.SATURATED
        with self._lock:
            self._last_sample_t = now
            if self._forced is not None:
                return self._forced
            self._note_transition_locked(level)
            return self._level

    def _fold(self, readings) -> AdmissionLevel:
        th = self.thresholds
        fill = 0.0
        lag = 0.0
        degraded = False
        quarantined = False
        d_submitted = 0
        d_dropped = 0
        with self._lock:
            prev = dict(self._prev)
        cur: dict[str, tuple[int, int]] = {}
        for name, r in readings:
            fill = max(fill, float(r.get("fill", 0.0)))
            lag = max(lag, float(r.get("lag_s", 0.0)))
            degraded = degraded or bool(r.get("degraded"))
            quarantined = quarantined or bool(r.get("quarantined"))
            sub = int(r.get("submitted", 0))
            drp = int(r.get("dropped", 0))
            psub, pdrp = prev.get(name, (sub, drp))
            d_submitted += max(0, sub - psub)
            d_dropped += max(0, drp - pdrp)
            cur[name] = (sub, drp)
        with self._lock:
            self._prev.update(cur)
        drop_rate = d_dropped / max(1, d_submitted + d_dropped)
        if (
            quarantined
            or fill >= th.saturated_fill
            or lag >= th.saturated_lag_s
            or (d_dropped > 0 and drop_rate >= th.saturated_drop_rate)
        ):
            return AdmissionLevel.SATURATED
        if (
            degraded
            or fill >= th.busy_fill
            or lag >= th.busy_lag_s
            or d_dropped > 0
        ):
            return AdmissionLevel.BUSY
        return AdmissionLevel.HEALTHY

    def _note_transition_locked(self, level: AdmissionLevel) -> None:
        if level != self._level:
            self._transitions.append(
                (self._clock(), self._level.name, level.name)
            )
            ADMISSION_TRANSITIONS.inc(
                from_level=self._level.name, to_level=level.name
            )
            self._level = level
        ADMISSION_LEVEL.set(int(level))

    # -- introspection -----------------------------------------------------

    def transitions(self) -> list[tuple[float, str, str]]:
        with self._lock:
            return list(self._transitions)

    def retry_after_s(self) -> int:
        """Suggested Retry-After for shed HTTP requests."""
        return 1

    def summary(self) -> dict:
        with self._lock:
            return {
                "level": self._level.name,
                "forced": self._forced.name if self._forced else None,
                "transitions": len(self._transitions),
                "sample_failures": self._sample_failures,
                "sources": [name for name, _ in self._sources],
            }
