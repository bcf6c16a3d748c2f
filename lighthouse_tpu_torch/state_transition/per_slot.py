"""Slot processing + epoch trigger (per_slot_processing.rs:28)."""

from __future__ import annotations

from ..types.spec import ChainSpec
from .beacon_state_util import get_current_epoch, invalidate_caches


def process_slot(spec: ChainSpec, state, state_root: bytes | None = None) -> None:
    p = spec.preset
    prev_root = state_root or state.tree_root()
    state.state_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = prev_root
    if bytes(state.latest_block_header.state_root) == b"\x00" * 32:
        state.latest_block_header.state_root = prev_root
    state.block_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = (
        state.latest_block_header.tree_root()
    )


def per_slot_processing(
    spec: ChainSpec, state, state_root: bytes | None = None
) -> None:
    """Advance one slot in place (epoch processing at boundaries). The
    ``state_root`` argument lets callers skip re-hashing when they already
    know the root (state_advance.rs does the same)."""
    from .per_epoch import process_epoch

    from .upgrades import apply_fork_upgrades

    process_slot(spec, state, state_root)
    epoch_boundary = (state.slot + 1) % spec.preset.SLOTS_PER_EPOCH == 0
    if epoch_boundary:
        process_epoch(spec, state)
    state.slot += 1
    if epoch_boundary:
        # committee caches are per-epoch; they stay valid within an epoch
        # (the reference keeps prev/cur/next caches across slots)
        invalidate_caches(state)
        # fork upgrades fire exactly when the boundary enters the fork epoch
        apply_fork_upgrades(spec, state)


def process_slots(spec: ChainSpec, state, target_slot: int) -> None:
    if state.slot > target_slot:
        raise ValueError(f"state slot {state.slot} ahead of {target_slot}")
    while state.slot < target_slot:
        per_slot_processing(spec, state)
