"""State advance helpers (state_advance.rs:28,61).

``complete_state_advance`` hashes every intermediate state (valid roots);
``partial_state_advance`` skips hashing for speed by writing a placeholder
root, valid only when the final state will never be hashed across the skipped
range (the attestation-shuffling use case).
"""

from __future__ import annotations

from ..types.spec import ChainSpec
from .per_slot import per_slot_processing


def _crosses_epoch_boundary(spec: ChainSpec, state, target_slot: int) -> bool:
    per_epoch = spec.preset.SLOTS_PER_EPOCH
    return target_slot // per_epoch > state.slot // per_epoch


def _warm_epoch_engine(spec: ChainSpec, state, target_slot: int) -> None:
    """Bind the device epoch engine's registry mirror before a multi-epoch
    advance: the boundary transitions inside the loop then run as journal
    deltas against a resident mirror instead of first-bind full gathers."""
    if not _crosses_epoch_boundary(spec, state, target_slot):
        return
    from ..epoch_engine import prepare_state

    prepare_state(state)  # no-op unless the device backend is active


def complete_state_advance(spec: ChainSpec, state, target_slot: int) -> None:
    if state.slot > target_slot:
        raise ValueError("state ahead of target")
    _warm_epoch_engine(spec, state, target_slot)
    while state.slot < target_slot:
        per_slot_processing(spec, state)


def partial_state_advance(spec: ChainSpec, state, target_slot: int) -> None:
    if state.slot > target_slot:
        raise ValueError("state ahead of target")
    _warm_epoch_engine(spec, state, target_slot)
    first = True
    while state.slot < target_slot:
        # Only the first slot's root must be real (it may already be wanted by
        # the caller); subsequent roots are placeholders.
        root = None if first else b"\x00" * 32
        per_slot_processing(spec, state, state_root=root)
        first = False
