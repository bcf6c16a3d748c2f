"""Bounded priority-queue scheduler with batch forming.

Parity: ``beacon_node/beacon_processor/src/lib.rs`` — a
manager owns one bounded queue per ``WorkType`` (:555-680), pops strictly by
priority, spawns up to n workers, drops on overflow (:1-39,77-99), and folds
queued gossip attestations/aggregates into batches of up to 64
(:219-254,1074-1090). The port's copy of
``lighthouse_tpu/beacon_processor/processor.py``, whole: batch sizes are
shape-bucketed and the cap is configurable upward — the device backend wants
larger, shape-stable batches; bisection keeps the 64-limit's error-fidelity
rationale intact at any size.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..utils.metrics import (
    PROCESSOR_EXPIRED_DROPS,
    PROCESSOR_OVERFLOW_DROPS,
    PROCESSOR_QUEUE_LENGTH,
    PROCESSOR_WORK_EVENTS,
)


class WorkType(enum.Enum):
    # priority order: lower value = higher priority (lib.rs manager match order)
    ChainSegmentBackfill = 0
    GossipBlock = 1
    GossipBlobSidecar = 2
    RpcBlock = 3
    ChainSegment = 4
    GossipAggregate = 5
    GossipAttestation = 6
    UnknownBlockAggregate = 7
    UnknownBlockAttestation = 8
    GossipVoluntaryExit = 9
    GossipProposerSlashing = 10
    GossipAttesterSlashing = 11
    GossipSyncSignature = 12
    GossipSyncContribution = 13
    ApiRequestP0 = 14
    ApiRequestP1 = 15
    Status = 16
    BlocksByRangeRequest = 17
    BlocksByRootsRequest = 18
    LightClientUpdate = 19


# which queues are LIFO (freshest-first: attestations age out fast; lib.rs)
_LIFO = {
    WorkType.GossipAttestation,
    WorkType.GossipAggregate,
    WorkType.GossipSyncSignature,
}

# batchable work: (batch cap mirrors max_gossip_attestation_batch_size = 64,
# lib.rs:219-231; configurable upward for the device backend). Sync-committee
# messages batch too, unlike the reference's: a device verify call costs the
# same ~1,000 kernel launches for one set as for 64, and
# ``verify_sync_committee_messages`` judges a batch message by message
_BATCHABLE = {WorkType.GossipAttestation, WorkType.GossipAggregate,
              WorkType.GossipSyncSignature}


@dataclass
class Work:
    """One unit of work. ``process_individual(item)`` handles a single item;
    ``process_batch(items)`` an entire batch (lib.rs:555-571).

    ``ingest_at``/``deadline`` carry the wire-ingest monotonic timestamp and
    the work's absolute expiry (loadshed.deadline): expired work is dropped
    BEFORE it reaches any handler or device dispatch. ``deadline=None``
    means the work never expires (the legacy behaviour)."""

    work_type: WorkType
    item: object
    process_individual: object = None
    process_batch: object = None
    ingest_at: float = field(default_factory=time.monotonic)
    deadline: float | None = None


@dataclass
class QueueLengths:
    """Per-type bounds scaled by active-validator count
    (BeaconProcessorQueueLengths::from_state, lib.rs:102-144)."""

    default: int = 16384
    overrides: dict = field(default_factory=dict)

    @classmethod
    def from_active_validators(cls, n_active: int) -> "QueueLengths":
        # 110% of one attestation per validator per epoch, min 128
        att = max(128, n_active * 11 // 10)
        return cls(
            overrides={
                WorkType.GossipAttestation: att,
                WorkType.GossipAggregate: max(128, att // 16),
                WorkType.UnknownBlockAttestation: max(128, att // 8),
            }
        )

    def limit(self, t: WorkType) -> int:
        return self.overrides.get(t, self.default)


@dataclass
class BeaconProcessorConfig:
    max_workers: int = 4
    max_batch_size: int = 64          # per-type batch cap (lib.rs:230)
    queue_lengths: QueueLengths = field(default_factory=QueueLengths)


class BeaconProcessor:
    """Manager + worker pool. ``synchronous=True`` runs work inline on
    ``submit``/``run_until_idle`` (the test mode); otherwise worker threads
    drain the queues continuously."""

    def __init__(self, config: BeaconProcessorConfig | None = None,
                 synchronous: bool = False, firehose=None):
        self.config = config or BeaconProcessorConfig()
        # optional streaming verification engine (firehose/engine.py):
        # batchable gossip work WITHOUT explicit handlers routes straight
        # into its intake instead of the generic queues
        self.firehose = firehose
        self.queues: dict[WorkType, deque] = {t: deque() for t in WorkType}
        self.dropped: dict[WorkType, int] = {t: 0 for t in WorkType}
        self.expired: dict[WorkType, int] = {t: 0 for t in WorkType}
        self.processed: dict[WorkType, int] = {t: 0 for t in WorkType}
        self.batches_formed = 0
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._shutdown = False
        self.synchronous = synchronous
        self._workers: list[threading.Thread] = []
        self._idle_workers = 0
        if not synchronous:
            for i in range(self.config.max_workers):
                w = threading.Thread(target=self._worker_loop, daemon=True,
                                     name=f"beacon-worker-{i}")
                w.start()
                self._workers.append(w)

    # -- submission (back-pressure at enqueue, drop on overflow) -----------------

    def submit(self, work: Work) -> bool:
        if work.deadline is not None and time.monotonic() > work.deadline:
            # already expired at ingest: never spend queue space or BLS
            # cycles on work whose client/inclusion window has passed
            with self._lock:
                self.expired[work.work_type] += 1
            PROCESSOR_EXPIRED_DROPS.inc(work_type=work.work_type.name)
            return False
        if (
            self.firehose is not None
            and work.work_type in _BATCHABLE
            and work.process_individual is None
            and work.process_batch is None
        ):
            # firehose-eligible gossip work: the engine owns batching,
            # back-pressure and verdict application end to end
            ok = self.firehose.submit(
                work.item, work_type=work.work_type,
                ingest_at=work.ingest_at, deadline=work.deadline,
            )
            with self._lock:
                if ok:
                    PROCESSOR_WORK_EVENTS.inc(work_type=work.work_type.name)
                else:
                    self.dropped[work.work_type] += 1
            return ok
        with self._lock:
            q = self.queues[work.work_type]
            if len(q) >= self.config.queue_lengths.limit(work.work_type):
                self.dropped[work.work_type] += 1
                PROCESSOR_OVERFLOW_DROPS.inc(work_type=work.work_type.name)
                if work.work_type not in _LIFO:
                    return False
                # freshest-first queues evict the OLDEST item (the tail)
                # and admit the fresh one: under overload the stale end of
                # an attestation queue is the least likely to still matter
                q.pop()
            if work.work_type in _LIFO:
                q.appendleft(work)
            else:
                q.append(work)
            PROCESSOR_WORK_EVENTS.inc(work_type=work.work_type.name)
            PROCESSOR_QUEUE_LENGTH.set(len(q), work_type=work.work_type.name)
            self._work_ready.notify()
        if self.synchronous:
            self.run_until_idle()
        return True

    # -- scheduling --------------------------------------------------------------

    def _expired_locked(self, w: Work, now: float) -> bool:
        """Deadline check at dispatch time; counts the drop. Caller holds
        the lock."""
        if w.deadline is None or now <= w.deadline:
            return False
        self.expired[w.work_type] += 1
        PROCESSOR_EXPIRED_DROPS.inc(work_type=w.work_type.name)
        return True

    def _pop_next(self):
        """Highest-priority nonempty queue -> one Work or a formed batch.
        Expired work is shed here — the last gate before any handler or
        BLS/device dispatch. Caller holds the lock."""
        for t in WorkType:
            q = self.queues[t]
            if not q:
                continue
            now = time.monotonic()
            if t in _BATCHABLE and len(q) > 1:
                n = min(len(q), self.config.max_batch_size)
                items = []
                while q and len(items) < n:
                    w = q.popleft()
                    if not self._expired_locked(w, now):
                        items.append(w)
                PROCESSOR_QUEUE_LENGTH.set(len(q), work_type=t.name)
                if not items:
                    continue
                if len(items) == 1:
                    return ("one", t, items[0])
                self.batches_formed += 1
                return ("batch", t, items)
            popped = q.popleft()
            while popped is not None and self._expired_locked(popped, now):
                popped = q.popleft() if q else None
            PROCESSOR_QUEUE_LENGTH.set(len(q), work_type=t.name)
            if popped is None:
                continue
            return ("one", t, popped)
        return None

    def _execute(self, popped) -> None:
        kind, t, payload = popped
        if kind == "batch":
            lead = payload[0]
            if lead.process_batch is not None:
                lead.process_batch([w.item for w in payload])
            else:
                for w in payload:
                    if w.process_individual:
                        w.process_individual(w.item)
            with self._lock:
                self.processed[t] += len(payload)
        else:
            if payload.process_individual:
                payload.process_individual(payload.item)
            elif payload.process_batch:
                payload.process_batch([payload.item])
            with self._lock:
                self.processed[t] += 1

    def run_until_idle(self) -> int:
        """Drain all queues inline; returns number of dispatches."""
        n = 0
        while True:
            with self._lock:
                popped = self._pop_next()
            if popped is None:
                return n
            self._execute(popped)
            n += 1

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while not self._shutdown:
                    popped = self._pop_next()
                    if popped is not None:
                        break
                    self._work_ready.wait(timeout=0.1)
                if self._shutdown:
                    return
            self._execute(popped)

    def queue_len(self, t: WorkType) -> int:
        with self._lock:
            return len(self.queues[t])

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._work_ready.notify_all()
        for w in self._workers:
            w.join(timeout=1.0)
