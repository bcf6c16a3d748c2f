"""Slot clocks (Lighthouse common/slot_clock): system-time and manual test
clocks. The port's copy of ``lighthouse_tpu/utils/slot_clock.py``."""

from __future__ import annotations

import time


class SlotClock:
    def now(self) -> int | None:
        raise NotImplementedError

    def seconds_into_slot(self) -> float:
        raise NotImplementedError


class SystemTimeSlotClock(SlotClock):
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> int | None:
        t = time.time()
        if t < self.genesis_time:
            return None
        return int(t - self.genesis_time) // self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        t = time.time()
        return (t - self.genesis_time) % self.seconds_per_slot

    def start_of(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot


class ManualSlotClock(SlotClock):
    """Test clock advanced by hand (TestingSlotClock, slot_clock/src/manual_slot_clock.rs)."""

    def __init__(self, slot: int = 0):
        self._slot = slot

    def now(self) -> int | None:
        return self._slot

    def set_slot(self, slot: int) -> None:
        self._slot = slot

    def advance_slot(self) -> None:
        self._slot += 1

    def seconds_into_slot(self) -> float:
        return 0.0
