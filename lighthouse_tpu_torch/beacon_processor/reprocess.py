"""Re-scheduling of early/orphan work (work_reprocessing_queue.rs, 1,183 LoC).

Attestations for unknown blocks wait until the block arrives (or expire);
early-arriving blocks wait until their slot starts; backfill batches wait for
idle. Here the queue is slot-driven (the chain pokes ``on_slot`` /
``on_block_imported``) rather than tokio-timer-driven.

The port's copy of ``lighthouse_tpu/beacon_processor/reprocess.py``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class QueuedUnknownBlockWork:
    block_root: bytes
    work: object
    queued_at_slot: int


EXPIRY_SLOTS = 2  # attestations are valid for ~1 epoch; requeue window


class ReprocessQueue:
    def __init__(self, resubmit):
        """``resubmit(work)`` re-enqueues into the BeaconProcessor."""
        self.resubmit = resubmit
        self._awaiting_block: dict[bytes, list] = defaultdict(list)
        self._early_blocks: list = []  # (slot, work)
        self._backfill: list = []
        self.expired = 0

    def queue_unknown_block_work(self, block_root: bytes, work, slot: int) -> None:
        self._awaiting_block[bytes(block_root)].append(
            QueuedUnknownBlockWork(bytes(block_root), work, slot)
        )

    def queue_early_block(self, slot: int, work) -> None:
        self._early_blocks.append((slot, work))

    def queue_backfill(self, work) -> None:
        self._backfill.append(work)

    def on_block_imported(self, block_root: bytes) -> int:
        """Release attestations that were waiting on this block."""
        released = self._awaiting_block.pop(bytes(block_root), [])
        for q in released:
            self.resubmit(q.work)
        return len(released)

    def on_slot(self, current_slot: int) -> None:
        # release due blocks
        due = [w for s, w in self._early_blocks if s <= current_slot]
        self._early_blocks = [
            (s, w) for s, w in self._early_blocks if s > current_slot
        ]
        for w in due:
            self.resubmit(w)
        # expire stale unknown-block waiters
        for root in list(self._awaiting_block):
            fresh = [
                q
                for q in self._awaiting_block[root]
                if q.queued_at_slot + EXPIRY_SLOTS >= current_slot
            ]
            self.expired += len(self._awaiting_block[root]) - len(fresh)
            if fresh:
                self._awaiting_block[root] = fresh
            else:
                del self._awaiting_block[root]

    def on_idle(self) -> None:
        if self._backfill:
            self.resubmit(self._backfill.pop(0))
