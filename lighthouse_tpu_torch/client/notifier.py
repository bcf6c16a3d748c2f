"""Periodic human-readable sync status (Lighthouse's client/src/notifier.rs):
the port's copy of ``lighthouse_tpu/client/notifier.py``."""

from __future__ import annotations

import threading

from ..utils.logging import get_logger

log = get_logger("notifier")


class Notifier:
    def __init__(self, chain, interval: float | None = None):
        self.chain = chain
        self.interval = interval or chain.spec.preset.SECONDS_PER_SLOT
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def status_line(self) -> dict:
        head = self.chain.head
        current = self.chain.current_slot()
        distance = max(0, current - head.slot)
        return {
            "slot": current,
            "head_slot": head.slot,
            "head": head.root.hex()[:10],
            "finalized_epoch": int(
                head.state.finalized_checkpoint.epoch
            ),
            "sync": "synced" if distance <= 1 else f"behind ({distance})",
        }

    def tick(self) -> None:
        status = self.status_line()
        log.info("Synced" if status["sync"] == "synced" else "Syncing",
                 **status)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.tick()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            # the loop wakes from its interval wait as soon as the event
            # sets, so a short bounded join reclaims the thread
            self._thread.join(timeout=5.0)
