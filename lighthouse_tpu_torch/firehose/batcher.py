"""Adaptive intake + fixed-shape batch forming for the gossip firehose: the
port's copy of ``lighthouse_tpu/firehose/batcher.py``.

Holds one bounded queue per ``WorkType`` (the scheduler's priority table,
``beacon_processor/processor.py``) and forms homogeneous batches for the
device backend:

  * a batch closes as soon as ``max_batch`` items of one type are buffered
    (a burst amortizes one device dispatch), or when the OLDEST buffered
    item of that type has waited ``deadline_s`` (a trickle never stalls);
  * batch sizes are padded downstream to the device backend's power-of-two
    plan shapes (``bls.backend.bucket``), so closing at ``max_batch``
    keeps every dispatch inside the precompiled bucket family;
  * the intake is bounded by ``intake_capacity`` across all types plus
    per-type caps. Overflow sheds the LOWEST-priority buffered work first
    (largest ``WorkType`` value — the inverse of the scheduler's pop order),
    so an attestation flood cannot starve aggregates, and ``submit`` never
    blocks the caller (the gossip/network thread).

Attestation-family queues are LIFO (freshest first — stale attestations age
out of fork-choice relevance fast), matching the scheduler's ``_LIFO`` set.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..beacon_processor.processor import WorkType, _LIFO
from ..utils.metrics import (
    FIREHOSE_DROPPED,
    FIREHOSE_EXPIRED,
    FIREHOSE_INTAKE_DEPTH,
)


@dataclass
class FirehoseItem:
    """One unit of streaming work plus its intake timestamp (queue-latency
    measurement runs enqueue -> verdict).

    ``ingest_at`` is the earlier WIRE-ingest stamp when the item rode the
    gossip pipeline before reaching the intake (end-to-end gossip->verdict
    latency runs from it); ``deadline`` is the absolute monotonic expiry —
    expired items are shed at batch-form time, before any device dispatch."""

    work_type: WorkType
    payload: object
    callback: object = None          # callback(payload, ok: bool) after verify
    enqueued_at: float = field(default_factory=time.monotonic)
    ingest_at: float | None = None
    deadline: float | None = None


@dataclass
class FirehoseConfig:
    max_batch: int = 64              # close a batch at this many items
    deadline_s: float = 0.010        # max wait on the oldest buffered item
    intake_capacity: int = 8192      # total buffered items across work types
    per_type_capacity: dict = field(default_factory=dict)  # WorkType -> cap
    prep_depth: int = 1              # prepared batches buffered ahead of device

    def type_limit(self, t: WorkType) -> int:
        return self.per_type_capacity.get(t, self.intake_capacity)


class AdaptiveBatcher:
    """Bounded multi-priority intake with deadline-driven batch forming."""

    def __init__(self, config: FirehoseConfig | None = None):
        self.config = config or FirehoseConfig()
        self._queues: dict[WorkType, deque] = {}
        self._depth = 0
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._closed = False
        self.dropped: dict[WorkType, int] = {}
        self.expired: dict[WorkType, int] = {}
        self.submitted = 0   # ACCEPTED items (gate rejections not included)
        self.evicted = 0     # accepted items later shed by back-pressure
        self.high_water = 0  # max total intake depth ever observed
        self._expired_out: list[FirehoseItem] = []  # await callbacks

    # -- intake (non-blocking; called from network/gossip threads) ---------------

    def submit(self, item: FirehoseItem) -> bool:
        """Buffer one item. Returns False when the item was shed. Never
        blocks: overflow evicts the lowest-priority buffered work (or
        rejects ``item`` itself when nothing buffered is lower priority)."""
        t = item.work_type
        with self._lock:
            if self._closed:
                return False
            q = self._queues.get(t)
            if q is None:
                q = self._queues[t] = deque()
            if len(q) >= self.config.type_limit(t):
                self._drop(t, 1)
                return False
            if self._depth >= self.config.intake_capacity:
                if not self._shed_lower_priority_than(t):
                    self._drop(t, 1)
                    return False
            if t in _LIFO:
                q.appendleft(item)
            else:
                q.append(item)
            self._depth += 1
            self.submitted += 1
            if self._depth > self.high_water:
                self.high_water = self._depth
            FIREHOSE_INTAKE_DEPTH.set(len(q), work_type=t.name)
            self._ready.notify()
        return True

    def _drop(self, t: WorkType, n: int) -> None:
        self.dropped[t] = self.dropped.get(t, 0) + n
        FIREHOSE_DROPPED.inc(n, work_type=t.name)

    def _shed_lower_priority_than(self, t: WorkType) -> bool:
        """Evict one buffered item of strictly lower priority than ``t``
        (higher WorkType value), preferring the lowest. Caller holds the
        lock. Returns False when ``t`` is itself the lowest priority."""
        for cand in sorted(self._queues, key=lambda w: w.value, reverse=True):
            if cand.value <= t.value:
                break
            q = self._queues[cand]
            if q:
                # shed the STALEST item of the victim type (queue tail for
                # LIFO types, head for FIFO) — freshest work survives
                q.pop() if cand in _LIFO else q.popleft()
                self._depth -= 1
                self.evicted += 1
                self._drop(cand, 1)
                FIREHOSE_INTAKE_DEPTH.set(len(q), work_type=cand.name)
                return True
        return False

    # -- batch forming (the pipeline's host thread) -------------------------------

    def depth(self, t: WorkType | None = None) -> int:
        with self._lock:
            if t is None:
                return self._depth
            return len(self._queues.get(t, ()))

    @property
    def dropped_total(self) -> int:
        with self._lock:
            return sum(self.dropped.values()) + sum(self.expired.values())

    def oldest_age(self) -> float | None:
        """Age (s) of the oldest buffered item — the LoadMonitor's worker-lag
        signal. None when the intake is empty."""
        now = time.monotonic()
        with self._lock:
            best = None
            for t, q in self._queues.items():
                if not q:
                    continue
                oldest = q[-1] if t in _LIFO else q[0]
                if best is None or oldest.enqueued_at < best:
                    best = oldest.enqueued_at
            return None if best is None else now - best

    def _oldest_deadline(self) -> float | None:
        """Earliest flush time over nonempty queues. Caller holds the lock."""
        best = None
        for t, q in self._queues.items():
            if not q:
                continue
            # oldest item: tail for LIFO queues, head for FIFO
            oldest = q[-1] if t in _LIFO else q[0]
            flush_at = oldest.enqueued_at + self.config.deadline_s
            if best is None or flush_at < best:
                best = flush_at
        return best

    def _form_locked(self, force: bool) -> list[FirehoseItem] | None:
        """Highest-priority queue that is full-batch ready (or past its
        deadline, or ``force``) -> homogeneous batch. Caller holds lock."""
        now = time.monotonic()
        for t in sorted(self._queues, key=lambda w: w.value):
            q = self._queues[t]
            if not q:
                continue
            oldest = q[-1] if t in _LIFO else q[0]
            if (
                len(q) >= self.config.max_batch
                or force
                or now - oldest.enqueued_at >= self.config.deadline_s
            ):
                n = min(len(q), self.config.max_batch)
                batch = []
                expired = []
                while q and len(batch) < n:
                    it = q.popleft()
                    self._depth -= 1
                    # per-item deadline: expired work is shed HERE, the
                    # last host-side gate before device dispatch
                    if it.deadline is not None and now > it.deadline:
                        expired.append(it)
                        self.expired[t] = self.expired.get(t, 0) + 1
                        FIREHOSE_EXPIRED.inc(work_type=t.name)
                    else:
                        batch.append(it)
                FIREHOSE_INTAKE_DEPTH.set(len(q), work_type=t.name)
                # callbacks fire outside the lock (see _fire_expired)
                self._expired_out.extend(expired)
                if not batch:
                    continue
                return batch
        return None

    @property
    def expired_total(self) -> int:
        with self._lock:
            return sum(self.expired.values())

    def _fire_expired(self) -> None:
        """Deliver verdict=False callbacks for deadline-shed items, outside
        the intake lock (a callback may log, score a peer, or resubmit)."""
        with self._lock:
            out, self._expired_out = self._expired_out, []
        for it in out:
            if it.callback is not None:
                try:
                    # engine-style callbacks take (payload, ok, meta)
                    it.callback(it.payload, False, None)
                except TypeError:
                    it.callback(it.payload, False)

    def next_batch(self, timeout: float | None = None) -> list[FirehoseItem] | None:
        """Block until a batch is ready (full, or the oldest item's deadline
        expires), the batcher closes, or ``timeout`` elapses. Returns None
        on timeout/close with nothing buffered."""
        try:
            return self._next_batch_inner(timeout)
        finally:
            self._fire_expired()

    def _next_batch_inner(self, timeout):
        give_up = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                batch = self._form_locked(force=self._closed)
                if batch is not None:
                    return batch
                if self._closed:
                    return None
                wait_until = self._oldest_deadline()
                if give_up is not None and (
                    wait_until is None or give_up < wait_until
                ):
                    wait_until = give_up
                if wait_until is None:
                    self._ready.wait(timeout=0.05)
                else:
                    remaining = wait_until - time.monotonic()
                    if remaining <= 0:
                        if give_up is not None and time.monotonic() >= give_up:
                            return self._form_locked(force=False)
                        # deadline passed: form whatever is buffered
                        batch = self._form_locked(force=True)
                        if batch is not None:
                            return batch
                        continue
                    self._ready.wait(timeout=remaining)

    def form_now(self) -> list[FirehoseItem] | None:
        """Form a batch immediately regardless of deadlines (synchronous
        drain mode)."""
        try:
            with self._lock:
                return self._form_locked(force=True)
        finally:
            self._fire_expired()

    def close(self) -> None:
        """Stop accepting new work; ``next_batch`` drains what remains then
        returns None."""
        with self._lock:
            self._closed = True
            self._ready.notify_all()
