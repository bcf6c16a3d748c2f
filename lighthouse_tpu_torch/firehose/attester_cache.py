"""Attester/shuffling cache tier: committee resolution off the full-state path.

Parity targets: ``beacon_chain/src/shuffling_cache.rs`` (CommitteeCache by
shuffling decision root) and ``attester_cache.rs`` (everything gossip
attestation verification needs, cached per (epoch, decision root) so the hot
path never clones or slot-advances a BeaconState).

The attester shuffling for epoch E is fixed by the RANDAO mix at the end of
epoch E-2 (seed lookahead 1), so its cache key is the **decision root**: the
block root at the last slot of epoch E-2 on the attestation's own chain.
Two states that agree on that root produce byte-identical committees — the
property ``tests/test_firehose.py`` pins across an epoch boundary. The
decision root itself is resolved through fork choice's proto-array ancestor
walk (no state access).

The signing domain needs only the fork schedule and the genesis validators
root, both known without a state, so a cache hit builds the complete
``(indices, signing_root, signature)`` triple for the device backend from
cached data alone.

The port's copy of ``lighthouse_tpu/firehose/attester_cache.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..state_transition.beacon_state_util import (
    CommitteeCache,
    get_block_root_at_slot,
)
from ..types.helpers import compute_domain, compute_signing_root
from ..utils.metrics import FIREHOSE_SHUFFLING_CACHE


def attester_shuffling_decision_slot(spec, target_epoch: int) -> int:
    """Last slot of epoch E-2 — where the attester shuffling for epoch E is
    decided (``attestation_shuffling_decision_slot``). Saturates to 0 for
    the first two epochs."""
    if target_epoch < 2:
        return 0
    return spec.start_slot(target_epoch - 1) - 1


def attester_shuffling_decision_root(
    spec, state, target_epoch: int, block_root: bytes
) -> bytes:
    """Decision root from a state that holds the attestation's chain.
    Falls back to ``block_root`` when the state predates the decision slot
    (early-chain genesis case — the reference uses the state's own root
    there too)."""
    slot = attester_shuffling_decision_slot(spec, target_epoch)
    if state.slot <= slot:
        return block_root
    try:
        return bytes(get_block_root_at_slot(spec, state, slot))
    except Exception:  # noqa: BLE001 — out of historical range: no cache key
        return block_root


class ShufflingCache:
    """LRU of ``CommitteeCache`` keyed by (epoch, decision_root)
    (``shuffling_cache.rs``; the reference holds 16 entries)."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._entries: OrderedDict[tuple, CommitteeCache] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> CommitteeCache | None:
        with self._lock:
            cc = self._entries.get(key)
            if cc is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                FIREHOSE_SHUFFLING_CACHE.inc(result="hit")
            else:
                self.misses += 1
                FIREHOSE_SHUFFLING_CACHE.inc(result="miss")
            return cc

    def insert(self, key: tuple, cc: CommitteeCache) -> None:
        with self._lock:
            self._entries[key] = cc
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class AttesterCacheTier:
    """The gossip hot path's committee/pubkey resolution tier.

    ``committee_for`` answers from the shuffling cache when the decision
    root is resolvable through fork choice; ``state_fallback`` (wired by the
    chain to its full-state path) fills misses and doubles as the reference
    implementation the cache is pinned against.
    """

    def __init__(
        self,
        spec,
        genesis_validators_root: bytes,
        ancestor_at_slot=None,
        state_fallback=None,
        capacity: int = 16,
    ):
        self.spec = spec
        self.genesis_validators_root = bytes(genesis_validators_root)
        self.shuffling = ShufflingCache(capacity=capacity)
        # ancestor_at_slot(block_root, slot) -> root, via fork choice
        self.ancestor_at_slot = ancestor_at_slot
        # state_fallback(block_root, slot) -> state advanced to `slot`
        self.state_fallback = state_fallback

    # -- key resolution (no state access) ----------------------------------------

    def decision_key(self, target_epoch: int, beacon_block_root: bytes):
        """(epoch, decision_root) via the proto-array ancestor walk, or None
        when fork choice cannot resolve the chain (unknown block)."""
        if self.ancestor_at_slot is None:
            return None
        slot = attester_shuffling_decision_slot(self.spec, target_epoch)
        root = self.ancestor_at_slot(bytes(beacon_block_root), slot)
        if root is None:
            return None
        return (int(target_epoch), bytes(root))

    # -- committee resolution ------------------------------------------------------

    def committee_for(self, data) -> "object | None":
        """Committee (validator indices, numpy array) for an AttestationData,
        from cache when possible, else through the full-state fallback
        (which also populates the cache). None when the chain is unknown."""
        epoch = self.spec.compute_epoch_at_slot(int(data.slot))
        key = self.decision_key(epoch, bytes(data.beacon_block_root))
        cc = self.shuffling.get(key) if key is not None else None
        if cc is None:
            cc = self._fill(key, int(data.slot), bytes(data.beacon_block_root))
            if cc is None:
                return None
        return cc.committee(int(data.slot), int(data.index))

    def _fill(self, key, slot: int, block_root: bytes) -> CommitteeCache | None:
        if self.state_fallback is None:
            return None
        state = self.state_fallback(block_root, slot)
        if state is None:
            return None
        epoch = self.spec.compute_epoch_at_slot(slot)
        cc = CommitteeCache(self.spec, state, epoch)
        if key is None:
            # fork choice couldn't resolve the decision root; derive it from
            # the state we were handed so the NEXT lookup hits
            key = (
                epoch,
                attester_shuffling_decision_root(
                    self.spec, state, epoch, block_root
                ),
            )
        self.shuffling.insert(key, cc)
        return cc

    # -- signing-root construction (state-free) ------------------------------------

    def attester_domain(self, target_epoch: int) -> bytes:
        """DOMAIN_BEACON_ATTESTER at the target epoch from the fork schedule
        alone (equals ``get_domain(state, ...)`` for any state on schedule)."""
        return compute_domain(
            self.spec.DOMAIN_BEACON_ATTESTER,
            self.spec.fork_version_at_epoch(int(target_epoch)),
            self.genesis_validators_root,
        )

    def signing_root(self, data) -> bytes:
        return compute_signing_root(
            data, self.attester_domain(int(data.target.epoch))
        )
