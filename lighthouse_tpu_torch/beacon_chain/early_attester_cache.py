"""Early-attester cache: head-block attestation data without a state read.

Parity target: ``beacon_chain/src/early_attester_cache.rs`` — when a block
becomes head, everything an attester needs for the rest of its epoch
(``beacon_block_root``, source and target checkpoints) is fixed, so the
``attestation_data`` serving path caches it once per head update and answers
the validator-client stampede at the attestation deadline without touching
(let alone slot-advancing) a ``BeaconState``.

One entry — the current head. A request hits when it attests to the cached
head (same chain), in the cached epoch, at or after the head's slot; any
head change or epoch rollover re-primes or evicts. The target root needs
one subtlety: for slots strictly after the epoch-start slot the target is
the epoch-start block root (read from the head state's ``block_roots`` ONCE
at prime time); for the epoch-start slot itself the head block (at or
before that slot) is its own target.

Hit/miss/evict counts land in ``utils.metrics`` (``early_attester_cache_total``)
so the cache's effectiveness is observable next to the shuffling cache tier.

The port's copy of ``lighthouse_tpu/beacon_chain/early_attester_cache.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..utils.metrics import EARLY_ATTESTER_CACHE


@dataclass(frozen=True)
class EarlyAttesterEntry:
    epoch: int
    head_root: bytes
    head_slot: int
    source_epoch: int
    source_root: bytes
    target_root: bytes


class EarlyAttesterCache:
    """Single-entry head-attestation cache (module docstring). Thread-safe:
    primed under the chain lock on head updates, read lock-free-ish (one
    small mutex) from HTTP handler threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entry: EarlyAttesterEntry | None = None
        self.hits = 0
        self.misses = 0

    # -- priming (head-update path, chain lock held by the caller) ----------

    def prime(self, spec, head_root: bytes, state) -> None:
        """Cache the attestation view of the new head. ``state`` is the
        head's post-state (state.slot == head slot); the one
        ``block_roots`` read here is the state access every later request
        skips."""
        head_slot = int(state.slot)
        epoch = spec.compute_epoch_at_slot(head_slot)
        start = spec.start_slot(epoch)
        if head_slot <= start:
            target_root = bytes(head_root)
        else:
            from ..state_transition import get_block_root_at_slot

            target_root = bytes(get_block_root_at_slot(spec, state, start))
        src = state.current_justified_checkpoint
        entry = EarlyAttesterEntry(
            epoch=int(epoch),
            head_root=bytes(head_root),
            head_slot=head_slot,
            source_epoch=int(src.epoch),
            source_root=bytes(src.root),
            target_root=target_root,
        )
        with self._lock:
            self._entry = entry

    def evict(self) -> None:
        with self._lock:
            if self._entry is not None:
                self._entry = None
                EARLY_ATTESTER_CACHE.inc(result="evict")

    # -- the serving path ---------------------------------------------------

    def try_attestation_data(
        self, spec, slot: int, committee_index: int, head_root: bytes
    ):
        """AttestationData for (slot, index) served purely from the cache,
        or None on a miss (caller falls back to the state path). Serves
        only when the caller's current head is the cached head, the request
        epoch is the cached epoch, and the slot is at/after the head's slot
        (attesting to the head as an ancestor)."""
        slot = int(slot)
        with self._lock:
            e = self._entry
        epoch = spec.compute_epoch_at_slot(slot)
        if (
            e is None
            or e.head_root != bytes(head_root)
            or epoch != e.epoch
            or slot < e.head_slot
        ):
            with self._lock:
                self.misses += 1
            EARLY_ATTESTER_CACHE.inc(result="miss")
            return None
        from ..types.containers import AttestationData, Checkpoint

        with self._lock:
            self.hits += 1
        EARLY_ATTESTER_CACHE.inc(result="hit")
        return AttestationData(
            slot=slot,
            index=int(committee_index),
            beacon_block_root=e.head_root,
            source=Checkpoint(epoch=e.source_epoch, root=e.source_root),
            target=Checkpoint(epoch=e.epoch, root=e.target_root),
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "primed": self._entry is not None,
            }
