"""BeaconState accessors: epochs, seeds, committees, proposers.

Parity targets: the accessor impl block of
``consensus/types/src/beacon_state.rs`` and the committee
cache (``beacon_state/committee_cache.rs``). The committee cache here shuffles
the whole active set once per (epoch, seed) with the vectorized swap-or-not
kernel and slices committees out of the flat permutation — the same layout the
reference caches.

Per-epoch caches. Beside the committee caches, each state memoises per epoch
the values block processing would otherwise recompute from the registry on
every attestation: the active validator indices (and with them the committee
count per slot) and the total active balance — Lighthouse keeps the same
values on ``BeaconState`` (its committee caches and ``total_active_balance``).
They live in the state's ``_committee_caches`` dict, are dropped with the
committee caches by ``invalidate_caches`` (at every epoch change and fork
upgrade) and are carried by ``state.copy()``. Within an epoch no block can
change them: exits and activations land at epochs >= current + 1 +
MAX_SEED_LOOKAHEAD, deposits add validators that are not active yet, and
effective balances move only in epoch processing, after its last read of the
total.
"""

from __future__ import annotations

import numpy as np

from ..ops.shuffle import shuffle_list
from ..ssz.sha256 import sha256
from ..types.helpers import is_active_validator
from ..types.spec import ChainSpec

DOMAIN_BEACON_ATTESTER = b"\x01\x00\x00\x00"


class StateTransitionError(Exception):
    pass


def get_current_epoch(spec: ChainSpec, state) -> int:
    return state.slot // spec.preset.SLOTS_PER_EPOCH


def get_previous_epoch(spec: ChainSpec, state) -> int:
    cur = get_current_epoch(spec, state)
    return cur - 1 if cur > 0 else 0


def _caches(state) -> dict:
    cache = getattr(state, "_committee_caches", None)
    if cache is None:
        cache = {}
        object.__setattr__(state, "_committee_caches", cache)
    return cache


def get_active_validator_indices(state, epoch: int) -> np.ndarray:
    """Memoised per (state, epoch); the array is read-only."""
    cache = _caches(state)
    key = ("active", epoch)
    out = cache.get(key)
    if out is None:
        out = np.array(
            [i for i, v in enumerate(state.validators) if is_active_validator(v, epoch)],
            dtype=np.uint64,
        )
        out.setflags(write=False)
        cache[key] = out
    return out


def get_randao_mix(spec: ChainSpec, state, epoch: int) -> bytes:
    return state.randao_mixes[epoch % spec.preset.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(spec: ChainSpec, state, epoch: int, domain_type: bytes) -> bytes:
    mix = get_randao_mix(
        spec,
        state,
        epoch
        + spec.preset.EPOCHS_PER_HISTORICAL_VECTOR
        - spec.min_seed_lookahead
        - 1,
    )
    return sha256(domain_type + epoch.to_bytes(8, "little") + mix)


def get_block_root_at_slot(spec: ChainSpec, state, slot: int) -> bytes:
    if not (slot < state.slot <= slot + spec.preset.SLOTS_PER_HISTORICAL_ROOT):
        raise StateTransitionError(f"block root slot {slot} out of range")
    return state.block_roots[slot % spec.preset.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(spec: ChainSpec, state, epoch: int) -> bytes:
    return get_block_root_at_slot(spec, state, spec.start_slot(epoch))


def get_committee_count_per_slot(spec: ChainSpec, state, epoch: int) -> int:
    n_active = len(get_active_validator_indices(state, epoch))
    return committee_count_from_active(spec, n_active)


def committee_count_from_active(spec: ChainSpec, n_active: int) -> int:
    p = spec.preset
    return max(
        1,
        min(
            p.MAX_COMMITTEES_PER_SLOT,
            n_active // p.SLOTS_PER_EPOCH // p.TARGET_COMMITTEE_SIZE,
        ),
    )


class CommitteeCache:
    """All committees of one epoch: the active-set permutation plus slicing.

    ``shuffled`` holds active validator indices in shuffled order (the
    reference stores exactly this, committee_cache.rs); committee (slot, idx)
    is a contiguous slice.
    """

    def __init__(self, spec: ChainSpec, state, epoch: int):
        cur = get_current_epoch(spec, state)
        if epoch > cur + 1:
            raise StateTransitionError("committee epoch beyond lookahead")
        self.epoch = epoch
        self.spec = spec
        active = get_active_validator_indices(state, epoch)
        if active.size == 0:
            raise StateTransitionError("no active validators")
        seed = get_seed(spec, state, epoch, DOMAIN_BEACON_ATTESTER)
        # Spec committees use compute_shuffled_index forward on positions;
        # shuffling the *list* backwards yields the same assignment in O(n)
        # (the reference's shuffle_list(forwards=false) trick).
        self.shuffled = active[
            shuffle_list(
                np.arange(active.size, dtype=np.uint64),
                seed,
                spec.preset.SHUFFLE_ROUND_COUNT,
                forwards=False,
            ).astype(np.int64)
        ]
        self.committees_per_slot = committee_count_from_active(spec, active.size)
        self.slots_per_epoch = spec.preset.SLOTS_PER_EPOCH
        self.n_active = active.size

    def committee(self, slot: int, index: int) -> np.ndarray:
        p = self.spec.preset
        if slot // p.SLOTS_PER_EPOCH != self.epoch:
            raise StateTransitionError("slot not in cached epoch")
        if index >= self.committees_per_slot:
            raise StateTransitionError("committee index out of range")
        total = self.committees_per_slot * self.slots_per_epoch
        ci = (slot % p.SLOTS_PER_EPOCH) * self.committees_per_slot + index
        start = self.n_active * ci // total
        end = self.n_active * (ci + 1) // total
        return self.shuffled[start:end]

    def committees_at_slot(self, slot: int) -> list:
        return [
            self.committee(slot, i) for i in range(self.committees_per_slot)
        ]


def get_beacon_committee(spec: ChainSpec, state, slot: int, index: int) -> np.ndarray:
    epoch = slot // spec.preset.SLOTS_PER_EPOCH
    return _committee_cache(spec, state, epoch).committee(slot, index)


def _committee_cache(spec: ChainSpec, state, epoch: int) -> CommitteeCache:
    """Per-state memo of up to 3 epochs (reference keeps prev/cur/next)."""
    cache = _caches(state)
    key = epoch
    if key not in cache:
        cache[key] = CommitteeCache(spec, state, epoch)
    return cache[key]


def invalidate_caches(state) -> None:
    if hasattr(state, "_committee_caches"):
        state._committee_caches.clear()


def compute_proposer_index(
    spec: ChainSpec, state, indices: np.ndarray, seed: bytes
) -> int:
    """Effective-balance-weighted rejection sampling (spec literal)."""
    if indices.size == 0:
        raise StateTransitionError("no candidates")
    MAX_RANDOM_BYTE = 2**8 - 1
    max_eb = spec.max_effective_balance
    i = 0
    total = indices.size
    while True:
        candidate = int(indices[compute_shuffled_position(spec, i % total, total, seed)])
        random_byte = sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= max_eb * random_byte:
            return candidate
        i += 1


def compute_shuffled_position(spec: ChainSpec, index: int, n: int, seed: bytes) -> int:
    from ..ops.shuffle import compute_shuffled_index

    return compute_shuffled_index(index, n, seed, spec.preset.SHUFFLE_ROUND_COUNT)


def get_beacon_proposer_index(spec: ChainSpec, state, slot: int | None = None) -> int:
    slot = state.slot if slot is None else slot
    epoch = slot // spec.preset.SLOTS_PER_EPOCH
    seed = sha256(
        get_seed(spec, state, epoch, spec.DOMAIN_BEACON_PROPOSER)
        + int(slot).to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(spec, state, indices, seed)


def get_total_balance(spec: ChainSpec, state, indices) -> int:
    total = sum(int(state.validators[int(i)].effective_balance) for i in indices)
    return max(spec.effective_balance_increment, total)


def get_total_active_balance(spec: ChainSpec, state) -> int:
    """Memoised per (state, epoch)."""
    epoch = get_current_epoch(spec, state)
    cache = _caches(state)
    key = ("total_active_balance", epoch)
    total = cache.get(key)
    if total is None:
        total = cache[key] = get_total_balance(
            spec, state, get_active_validator_indices(state, epoch)
        )
    return total


def get_attesting_indices(spec: ChainSpec, state, data, aggregation_bits) -> np.ndarray:
    committee = get_beacon_committee(spec, state, data.slot, data.index)
    bits = np.asarray(aggregation_bits, dtype=bool)
    if bits.size != committee.size:
        raise StateTransitionError("aggregation bits length != committee size")
    return committee[bits]


def get_indexed_attestation(spec: ChainSpec, state, attestation):
    from ..types.containers import for_preset

    ns = for_preset(spec.preset.name)
    if hasattr(attestation, "committee_bits"):
        from .electra import get_attesting_indices_electra

        return ns.IndexedAttestationElectra(
            attesting_indices=sorted(
                get_attesting_indices_electra(spec, state, attestation)
            ),
            data=attestation.data,
            signature=attestation.signature,
        )
    indices = get_attesting_indices(
        spec, state, attestation.data, attestation.aggregation_bits
    )
    return ns.IndexedAttestation(
        attesting_indices=sorted(int(i) for i in indices),
        data=attestation.data,
        signature=attestation.signature,
    )
