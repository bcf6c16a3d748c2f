"""Epoch processing as vectorized columnar sweeps.

Parity: ``consensus/state_processing/src/per_epoch_processing.rs``
and the fused O(n) sweep (``per_epoch_processing/single_pass.rs``). The
reference fuses rewards/registry/effective-balance updates into one loop over
validators; here the same fusion is numpy column arithmetic: validator fields
are gathered into uint64 arrays once, every per-validator rule is an array
expression, and results scatter back. That is the device-native shape — the
validator set is the array axis.
"""

from __future__ import annotations

import math

import numpy as np

from ..types.spec import ChainSpec, FAR_FUTURE_EPOCH
from .beacon_state_util import (
    get_active_validator_indices,
    get_attesting_indices,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    get_total_balance,
)
from .common import balances_array, compute_activation_exit_epoch
from .per_block import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    get_base_reward_per_increment,
)

BASE_REWARDS_PER_EPOCH = 4  # phase0


class _Cols:
    """Columnar gather of the validator registry (struct-of-arrays)."""

    def __init__(self, state):
        vs = state.validators
        n = len(vs)
        self.n = n
        self.effective = np.array([v.effective_balance for v in vs], dtype=np.uint64)
        self.slashed = np.array([v.slashed for v in vs], dtype=bool)
        self.activation = np.array([v.activation_epoch for v in vs], dtype=np.uint64)
        self.exit = np.array([v.exit_epoch for v in vs], dtype=np.uint64)
        self.withdrawable = np.array(
            [v.withdrawable_epoch for v in vs], dtype=np.uint64
        )
        self.activation_eligibility = np.array(
            [v.activation_eligibility_epoch for v in vs], dtype=np.uint64
        )

    def active(self, epoch: int) -> np.ndarray:
        e = np.uint64(epoch)
        return (self.activation <= e) & (e < self.exit)


def process_epoch(spec: ChainSpec, state) -> None:
    # Backend seam (mirrors the BLS backend registry): the device epoch
    # engine owns the whole transition when selected; otherwise the columnar
    # numpy path below runs. See ``epoch_engine/``.
    from ..epoch_engine import maybe_process_epoch_on_device

    if maybe_process_epoch_on_device(spec, state):
        return
    fork = getattr(state, "fork_name", "phase0")
    if fork == "phase0":
        _process_epoch_phase0(spec, state)
    else:
        _process_epoch_altair(spec, state)


# ==================================================================================
# phase0
# ==================================================================================


def _matching_attestations(spec, state, epoch: int):
    if epoch == get_current_epoch(spec, state):
        return list(state.current_epoch_attestations)
    if epoch == get_previous_epoch(spec, state):
        return list(state.previous_epoch_attestations)
    raise ValueError("epoch out of range")


def _matching_target_attestations(spec, state, epoch: int):
    root = get_block_root(spec, state, epoch)
    return [
        a
        for a in _matching_attestations(spec, state, epoch)
        if bytes(a.data.target.root) == bytes(root)
    ]


def _matching_head_attestations(spec, state, epoch: int):
    return [
        a
        for a in _matching_target_attestations(spec, state, epoch)
        if bytes(a.data.beacon_block_root)
        == bytes(get_block_root_at_slot(spec, state, a.data.slot))
    ]


def _attesting_mask(spec, state, attestations, cols: _Cols) -> np.ndarray:
    mask = np.zeros(cols.n, dtype=bool)
    for a in attestations:
        idx = get_attesting_indices(spec, state, a.data, a.aggregation_bits)
        mask[idx.astype(np.int64)] = True
    return mask & ~cols.slashed


def _unslashed_attesting_balance(spec, cols: _Cols, mask: np.ndarray) -> int:
    return max(
        spec.effective_balance_increment, int(cols.effective[mask].sum())
    )


def _process_epoch_phase0(spec: ChainSpec, state) -> None:
    # the field loops below mutate validators without journaling; a bound
    # device mirror must re-gather on its next sync
    from ..epoch_engine import invalidate_registry_journal

    invalidate_registry_journal(state)
    cols = _Cols(state)
    process_justification_and_finalization_phase0(spec, state, cols)
    process_rewards_and_penalties_phase0(spec, state, cols)
    process_registry_updates(spec, state, cols)
    process_slashings(spec, state, cols)
    process_eth1_data_reset(spec, state)
    process_effective_balance_updates(spec, state)
    process_slashings_reset(spec, state)
    process_randao_mixes_reset(spec, state)
    process_historical_roots_update(spec, state)
    # participation record rotation
    state.previous_epoch_attestations = list(state.current_epoch_attestations)
    state.current_epoch_attestations = []


def process_justification_and_finalization_phase0(spec, state, cols: _Cols):
    if get_current_epoch(spec, state) <= 1:
        return
    prev_ep, cur_ep = get_previous_epoch(spec, state), get_current_epoch(spec, state)
    total = get_total_active_balance(spec, state)
    prev_target = _unslashed_attesting_balance(
        spec, cols,
        _attesting_mask(
            spec, state, _matching_target_attestations(spec, state, prev_ep), cols
        ),
    )
    cur_target = _unslashed_attesting_balance(
        spec, cols,
        _attesting_mask(
            spec, state, _matching_target_attestations(spec, state, cur_ep), cols
        ),
    )
    _weigh_justification_and_finalization(
        spec, state, total, prev_target, cur_target
    )


def _weigh_justification_and_finalization(
    spec, state, total_balance, prev_target_balance, cur_target_balance
):
    from ..types.containers import Checkpoint

    prev_ep, cur_ep = get_previous_epoch(spec, state), get_current_epoch(spec, state)
    old_prev = state.previous_justified_checkpoint
    old_cur = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = np.asarray(state.justification_bits, dtype=bool).copy()
    bits[1:] = bits[:-1]
    bits[0] = False
    if prev_target_balance * 3 >= total_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=prev_ep, root=get_block_root(spec, state, prev_ep)
        )
        bits[1] = True
    if cur_target_balance * 3 >= total_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=cur_ep, root=get_block_root(spec, state, cur_ep)
        )
        bits[0] = True
    state.justification_bits = bits

    # finalization rules
    if bits[1:4].all() and old_prev.epoch + 3 == cur_ep:
        state.finalized_checkpoint = old_prev
    if bits[1:3].all() and old_prev.epoch + 2 == cur_ep:
        state.finalized_checkpoint = old_prev
    if bits[0:3].all() and old_cur.epoch + 2 == cur_ep:
        state.finalized_checkpoint = old_cur
    if bits[0:2].all() and old_cur.epoch + 1 == cur_ep:
        state.finalized_checkpoint = old_cur


def _base_reward_phase0(spec, cols: _Cols, total_balance: int) -> np.ndarray:
    sqrt_total = math.isqrt(total_balance)
    return (
        cols.effective
        * np.uint64(spec.base_reward_factor)
        // np.uint64(sqrt_total)
        // np.uint64(BASE_REWARDS_PER_EPOCH)
    )


def process_rewards_and_penalties_phase0(spec, state, cols: _Cols):
    if get_current_epoch(spec, state) == 0:
        return
    prev_ep = get_previous_epoch(spec, state)
    total = get_total_active_balance(spec, state)
    base = _base_reward_phase0(spec, cols, total)

    src_atts = _matching_attestations(spec, state, prev_ep)
    tgt_atts = _matching_target_attestations(spec, state, prev_ep)
    head_atts = _matching_head_attestations(spec, state, prev_ep)
    src_mask = _attesting_mask(spec, state, src_atts, cols)
    tgt_mask = _attesting_mask(spec, state, tgt_atts, cols)
    head_mask = _attesting_mask(spec, state, head_atts, cols)

    eligible = cols.active(prev_ep) | (
        cols.slashed & (np.uint64(prev_ep + 1) < cols.withdrawable)
    )

    rewards = np.zeros(cols.n, dtype=np.uint64)
    penalties = np.zeros(cols.n, dtype=np.uint64)

    finality_delay = prev_ep - state.finalized_checkpoint.epoch
    in_inactivity_leak = finality_delay > spec.min_epochs_to_inactivity_penalty

    for mask, att_balance in (
        (src_mask, _unslashed_attesting_balance(spec, cols, src_mask)),
        (tgt_mask, _unslashed_attesting_balance(spec, cols, tgt_mask)),
        (head_mask, _unslashed_attesting_balance(spec, cols, head_mask)),
    ):
        attesters = eligible & mask
        non_attesters = eligible & ~mask
        if in_inactivity_leak:
            rewards[attesters] += base[attesters]
        else:
            increments = att_balance // spec.effective_balance_increment
            total_increments = total // spec.effective_balance_increment
            rewards[attesters] += (
                base[attesters] * np.uint64(increments) // np.uint64(total_increments)
            )
        penalties[non_attesters] += base[non_attesters]

    # proposer & inclusion-delay micro-rewards (earliest inclusion per attester)
    earliest: dict[int, tuple[int, int]] = {}
    for a in src_atts:
        idx = get_attesting_indices(spec, state, a.data, a.aggregation_bits)
        for i in idx:
            i = int(i)
            cand = (int(a.inclusion_delay), int(a.proposer_index))
            if i not in earliest or cand[0] < earliest[i][0]:
                earliest[i] = cand
    for i, (delay, proposer) in earliest.items():
        if cols.slashed[i]:
            continue
        proposer_reward = int(base[i]) // spec.proposer_reward_quotient
        rewards[proposer] += np.uint64(proposer_reward)
        max_attester_reward = int(base[i]) - proposer_reward
        rewards[i] += np.uint64(max_attester_reward // delay)

    if in_inactivity_leak:
        # spec get_inactivity_penalty_deltas: every eligible validator pays
        # BASE_REWARDS_PER_EPOCH * base - proposer_reward; non-target
        # attesters additionally pay the quadratic leak penalty.
        penalties[eligible] += (
            np.uint64(BASE_REWARDS_PER_EPOCH) * base[eligible]
            - base[eligible] // np.uint64(spec.proposer_reward_quotient)
        )
        not_tgt = eligible & ~tgt_mask
        penalties[not_tgt] += (
            cols.effective[not_tgt]
            * np.uint64(finality_delay)
            // np.uint64(spec.inactivity_penalty_quotient)
        )

    bal = balances_array(state)
    bal += rewards
    dec = np.minimum(penalties, bal)
    bal -= dec


def process_registry_updates(spec, state, cols: _Cols):
    from ..types.spec import fork_at_least

    electra = fork_at_least(getattr(state, "fork_name", "phase0"), "electra")
    cur = get_current_epoch(spec, state)
    # eligibility: electra keys on MIN_ACTIVATION_BALANCE (EIP-7251)
    for i, v in enumerate(state.validators):
        eligible = (
            v.effective_balance >= spec.min_activation_balance
            if electra
            else v.effective_balance == spec.max_effective_balance
        )
        if v.activation_eligibility_epoch == FAR_FUTURE_EPOCH and eligible:
            v.activation_eligibility_epoch = cur + 1
        if (
            (cols.activation[i] <= np.uint64(cur) < cols.exit[i])
            and v.effective_balance <= spec.ejection_balance
        ):
            from .common import initiate_validator_exit

            initiate_validator_exit(spec, state, i)
    # activation queue, FIFO by (eligibility epoch, index), churn-limited
    queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    from .common import get_validator_activation_churn_limit

    # electra: activations are throttled by the pending-deposit balance
    # churn instead of a head-count limit here (EIP-7251)
    limit = None if electra else get_validator_activation_churn_limit(spec, state)
    for i in queue[:limit]:
        state.validators[i].activation_epoch = compute_activation_exit_epoch(
            spec, cur
        )


def process_slashings(spec, state, cols: _Cols):
    from ..types.spec import proportional_slashing_multiplier_for

    cur = get_current_epoch(spec, state)
    total = get_total_active_balance(spec, state)
    fork = getattr(state, "fork_name", "phase0")
    mult = proportional_slashing_multiplier_for(spec, fork)
    slash_sum = int(np.asarray(state.slashings, dtype=np.uint64).sum())
    adjusted = min(slash_sum * mult, total)
    target_wd = np.uint64(cur + spec.preset.EPOCHS_PER_SLASHINGS_VECTOR // 2)
    hit = cols.slashed & (cols.withdrawable == target_wd)
    if not hit.any():
        return
    increment = spec.effective_balance_increment
    from ..types.spec import fork_at_least

    if fork_at_least(fork, "electra"):
        # EIP-7251 overflow-safe form: per-increment penalty first
        per_increment = np.uint64(adjusted // (total // increment))
        penalty = cols.effective[hit] // np.uint64(increment) * per_increment
    else:
        penalty_numer = (
            cols.effective[hit] // np.uint64(increment) * np.uint64(adjusted)
        )
        penalty = penalty_numer // np.uint64(total) * np.uint64(increment)
    bal = balances_array(state)
    idx = np.nonzero(hit)[0]
    dec = np.minimum(penalty, bal[idx])
    bal[idx] -= dec


def process_eth1_data_reset(spec, state):
    next_ep = get_current_epoch(spec, state) + 1
    if next_ep % spec.preset.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(spec, state):
    HYSTERESIS_QUOTIENT = 4
    HYSTERESIS_DOWNWARD_MULTIPLIER = 1
    HYSTERESIS_UPWARD_MULTIPLIER = 5
    increment = spec.effective_balance_increment
    hysteresis = increment // HYSTERESIS_QUOTIENT
    down = hysteresis * HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis * HYSTERESIS_UPWARD_MULTIPLIER
    from ..types.spec import fork_at_least

    electra = fork_at_least(getattr(state, "fork_name", "phase0"), "electra")
    if electra:
        from .electra import get_max_effective_balance

    bal = balances_array(state)
    for i, v in enumerate(state.validators):
        b = int(bal[i])
        if b + down < v.effective_balance or v.effective_balance + up < b:
            limit = (
                get_max_effective_balance(spec, v)
                if electra
                else spec.max_effective_balance
            )
            v.effective_balance = min(b - b % increment, limit)


def process_slashings_reset(spec, state):
    next_ep = get_current_epoch(spec, state) + 1
    state.slashings[next_ep % spec.preset.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(spec, state):
    cur = get_current_epoch(spec, state)
    next_ep = cur + 1
    p = spec.preset
    state.randao_mixes[next_ep % p.EPOCHS_PER_HISTORICAL_VECTOR] = get_randao_mix(
        spec, state, cur
    )


def process_historical_roots_update(spec, state):
    next_ep = get_current_epoch(spec, state) + 1
    p = spec.preset
    if next_ep % (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH) == 0:
        from ..types.containers import for_preset

        ns = for_preset(spec.preset.name)
        from ..types.spec import fork_at_least

        if fork_at_least(getattr(state, "fork_name", "phase0"), "capella"):
            # capella: accumulate summaries instead of batch roots
            from ..types.containers import HistoricalSummary
            from ..ssz import Vector
            from ..types.containers import Root

            br = Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)
            state.historical_summaries = list(state.historical_summaries) + [
                HistoricalSummary(
                    block_summary_root=br.hash_tree_root(list(state.block_roots)),
                    state_summary_root=br.hash_tree_root(list(state.state_roots)),
                )
            ]
            return
        batch = ns.HistoricalBatch(
            block_roots=list(state.block_roots),
            state_roots=list(state.state_roots),
        )
        state.historical_roots = list(state.historical_roots) + [batch.tree_root()]


# ==================================================================================
# altair
# ==================================================================================


def _participation_cols(state):
    prev = np.asarray(state.previous_epoch_participation, dtype=np.uint8)
    cur = np.asarray(state.current_epoch_participation, dtype=np.uint8)
    return prev, cur


def _process_epoch_altair(spec: ChainSpec, state) -> None:
    from ..epoch_engine import invalidate_registry_journal

    invalidate_registry_journal(state)
    cols = _Cols(state)
    process_justification_and_finalization_altair(spec, state, cols)
    process_inactivity_updates(spec, state, cols)
    process_rewards_and_penalties_altair(spec, state, cols)
    process_registry_updates(spec, state, cols)
    process_slashings(spec, state, cols)
    process_eth1_data_reset(spec, state)
    from ..types.spec import fork_at_least

    if fork_at_least(getattr(state, "fork_name", "altair"), "electra"):
        from .electra import (
            process_pending_consolidations,
            process_pending_deposits,
        )

        process_pending_deposits(spec, state)
        process_pending_consolidations(spec, state)
    process_effective_balance_updates(spec, state)
    process_slashings_reset(spec, state)
    process_randao_mixes_reset(spec, state)
    process_historical_roots_update(spec, state)
    process_participation_flag_updates(spec, state)
    process_sync_committee_updates(spec, state)


def _unslashed_participating_mask(spec, state, cols, flag_index: int, epoch: int):
    prev, cur = _participation_cols(state)
    part = cur if epoch == get_current_epoch(spec, state) else prev
    has_flag = (part & np.uint8(1 << flag_index)) != 0
    return cols.active(epoch) & has_flag & ~cols.slashed


def process_justification_and_finalization_altair(spec, state, cols):
    if get_current_epoch(spec, state) <= 1:
        return
    prev_ep, cur_ep = get_previous_epoch(spec, state), get_current_epoch(spec, state)
    total = get_total_active_balance(spec, state)
    prev_mask = _unslashed_participating_mask(
        spec, state, cols, TIMELY_TARGET_FLAG_INDEX, prev_ep
    )
    cur_mask = _unslashed_participating_mask(
        spec, state, cols, TIMELY_TARGET_FLAG_INDEX, cur_ep
    )
    prev_bal = max(
        spec.effective_balance_increment, int(cols.effective[prev_mask].sum())
    )
    cur_bal = max(
        spec.effective_balance_increment, int(cols.effective[cur_mask].sum())
    )
    _weigh_justification_and_finalization(spec, state, total, prev_bal, cur_bal)


def process_inactivity_updates(spec, state, cols):
    if get_current_epoch(spec, state) == 0:
        return
    prev_ep = get_previous_epoch(spec, state)
    scores = np.asarray(state.inactivity_scores, dtype=np.uint64).copy()
    eligible = cols.active(prev_ep) | (
        cols.slashed & (np.uint64(prev_ep + 1) < cols.withdrawable)
    )
    target_mask = _unslashed_participating_mask(
        spec, state, cols, TIMELY_TARGET_FLAG_INDEX, prev_ep
    )
    finality_delay = prev_ep - state.finalized_checkpoint.epoch
    is_leak = finality_delay > spec.min_epochs_to_inactivity_penalty

    inc = eligible & target_mask
    scores[inc] -= np.minimum(np.uint64(1), scores[inc])
    notinc = eligible & ~target_mask
    scores[notinc] += np.uint64(spec.inactivity_score_bias)
    if not is_leak:
        dec = np.minimum(np.uint64(spec.inactivity_score_recovery_rate), scores)
        scores[eligible] -= dec[eligible]
    state.inactivity_scores = scores


def process_rewards_and_penalties_altair(spec, state, cols):
    if get_current_epoch(spec, state) == 0:
        return
    prev_ep = get_previous_epoch(spec, state)
    total = get_total_active_balance(spec, state)
    total_increments = total // spec.effective_balance_increment
    per_inc = get_base_reward_per_increment(spec, state)
    base = (
        cols.effective // np.uint64(spec.effective_balance_increment)
    ) * np.uint64(per_inc)

    eligible = cols.active(prev_ep) | (
        cols.slashed & (np.uint64(prev_ep + 1) < cols.withdrawable)
    )
    finality_delay = prev_ep - state.finalized_checkpoint.epoch
    is_leak = finality_delay > spec.min_epochs_to_inactivity_penalty

    rewards = np.zeros(cols.n, dtype=np.uint64)
    penalties = np.zeros(cols.n, dtype=np.uint64)

    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        mask = _unslashed_participating_mask(spec, state, cols, flag_index, prev_ep)
        flag_balance = max(
            spec.effective_balance_increment, int(cols.effective[mask].sum())
        )
        flag_increments = flag_balance // spec.effective_balance_increment
        attesters = eligible & mask
        if not is_leak:
            numer = base[attesters] * np.uint64(weight * flag_increments)
            rewards[attesters] += numer // np.uint64(
                total_increments * WEIGHT_DENOMINATOR
            )
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            non = eligible & ~mask
            penalties[non] += (
                base[non] * np.uint64(weight) // np.uint64(WEIGHT_DENOMINATOR)
            )

    # inactivity penalties (altair formula)
    target_mask = _unslashed_participating_mask(
        spec, state, cols, TIMELY_TARGET_FLAG_INDEX, prev_ep
    )
    scores = np.asarray(state.inactivity_scores, dtype=np.uint64)
    non_target = eligible & ~target_mask
    numer = cols.effective[non_target] * scores[non_target]
    denom = np.uint64(
        spec.inactivity_score_bias * spec.inactivity_penalty_quotient_altair
    )
    penalties[non_target] += numer // denom

    bal = balances_array(state)
    bal += rewards
    dec = np.minimum(penalties, bal)
    bal -= dec


def process_participation_flag_updates(spec, state):
    state.previous_epoch_participation = np.asarray(
        state.current_epoch_participation, dtype=np.uint8
    ).copy()
    state.current_epoch_participation = np.zeros(
        len(state.validators), dtype=np.uint8
    )


def process_sync_committee_updates(spec, state):
    next_ep = get_current_epoch(spec, state) + 1
    if next_ep % spec.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(spec, state)


def get_next_sync_committee(spec, state):
    """Effective-balance-weighted sync committee sampling + aggregate pubkey
    (altair spec get_next_sync_committee)."""
    from ..ssz.sha256 import sha256
    from ..types.containers import for_preset
    from ..oracle import ciphersuite as cs
    from ..oracle import curves as oc
    from .beacon_state_util import get_seed

    ns = for_preset(spec.preset.name)
    epoch = get_current_epoch(spec, state) + 1
    active = get_active_validator_indices(state, epoch)
    seed = get_seed(spec, state, epoch, spec.DOMAIN_SYNC_COMMITTEE)
    from ..ops.shuffle import compute_shuffled_index

    indices = []
    i = 0
    MAX_RANDOM_BYTE = 255
    while len(indices) < spec.preset.SYNC_COMMITTEE_SIZE:
        shuffled = compute_shuffled_index(
            i % active.size, active.size, seed, spec.preset.SHUFFLE_ROUND_COUNT
        )
        candidate = int(active[shuffled])
        random_byte = sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= spec.max_effective_balance * random_byte:
            indices.append(candidate)
        i += 1
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    agg = None
    for pk in pubkeys:
        agg = oc.g1_add(agg, oc.g1_decompress(pk))
    return ns.SyncCommittee(
        pubkeys=pubkeys, aggregate_pubkey=oc.g1_compress(agg)
    )
