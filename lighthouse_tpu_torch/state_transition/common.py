"""Shared mutators: balances, exits, slashing (state_processing/src/common)."""

from __future__ import annotations

import numpy as np

from ..types.spec import ChainSpec, FAR_FUTURE_EPOCH
from .beacon_state_util import (
    get_active_validator_indices,
    get_beacon_proposer_index,
    get_current_epoch,
)


def balances_array(state) -> np.ndarray:
    """View/convert state.balances as a numpy uint64 column."""
    if not isinstance(state.balances, np.ndarray):
        state.balances = np.asarray(state.balances, dtype=np.uint64)
    return state.balances


def increase_balance(state, index: int, delta: int) -> None:
    b = balances_array(state)
    b[index] += np.uint64(delta)


def decrease_balance(state, index: int, delta: int) -> None:
    b = balances_array(state)
    b[index] -= np.uint64(min(int(delta), int(b[index])))


def get_validator_churn_limit(spec: ChainSpec, state) -> int:
    n_active = len(
        get_active_validator_indices(state, get_current_epoch(spec, state))
    )
    return max(
        spec.min_per_epoch_churn_limit, n_active // spec.churn_limit_quotient
    )


def get_validator_activation_churn_limit(spec: ChainSpec, state) -> int:
    """Deneb caps the activation churn (spec get_validator_activation_churn_limit)."""
    from ..types.spec import fork_at_least

    limit = get_validator_churn_limit(spec, state)
    if fork_at_least(getattr(state, "fork_name", "phase0"), "deneb"):
        limit = min(spec.max_per_epoch_activation_churn_limit, limit)
    return limit


def compute_activation_exit_epoch(spec: ChainSpec, epoch: int) -> int:
    return epoch + 1 + spec.max_seed_lookahead


def initiate_validator_exit(spec: ChainSpec, state, index: int) -> None:
    from ..types.spec import fork_at_least

    if fork_at_least(getattr(state, "fork_name", "phase0"), "electra"):
        from .electra import initiate_validator_exit_electra

        return initiate_validator_exit_electra(spec, state, index)
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [
        w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_queue_epoch = max(
        exit_epochs + [compute_activation_exit_epoch(spec, get_current_epoch(spec, state))]
    )
    exit_queue_churn = sum(
        1 for w in state.validators if w.exit_epoch == exit_queue_epoch
    )
    if exit_queue_churn >= get_validator_churn_limit(spec, state):
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = exit_queue_epoch + spec.min_validator_withdrawability_delay
    from ..epoch_engine import mark_registry_delta

    mark_registry_delta(state, index)


def slash_validator(
    spec: ChainSpec, state, slashed_index: int, whistleblower_index: int | None = None
) -> None:
    epoch = get_current_epoch(spec, state)
    initiate_validator_exit(spec, state, slashed_index)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch, epoch + spec.preset.EPOCHS_PER_SLASHINGS_VECTOR
    )
    from ..epoch_engine import mark_registry_delta

    mark_registry_delta(state, slashed_index)
    state.slashings[epoch % spec.preset.EPOCHS_PER_SLASHINGS_VECTOR] += (
        v.effective_balance
    )
    from ..types.spec import fork_at_least

    fork = getattr(state, "fork_name", "phase0")
    if fork == "phase0":
        slash_quotient = spec.min_slashing_penalty_quotient
    elif fork == "altair":
        slash_quotient = spec.min_slashing_penalty_quotient_altair
    elif fork_at_least(fork, "electra"):
        slash_quotient = spec.min_slashing_penalty_quotient_electra
    else:
        slash_quotient = spec.min_slashing_penalty_quotient_bellatrix
    decrease_balance(state, slashed_index, v.effective_balance // slash_quotient)

    proposer_index = get_beacon_proposer_index(spec, state)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    wb_quotient = (
        spec.whistleblower_reward_quotient_electra
        if fork_at_least(fork, "electra")
        else spec.whistleblower_reward_quotient
    )
    whistleblower_reward = v.effective_balance // wb_quotient
    proposer_reward = whistleblower_reward // spec.proposer_reward_quotient
    if fork != "phase0":
        # altair+: proposer gets PROPOSER_WEIGHT/WEIGHT_DENOMINATOR of the reward
        proposer_reward = whistleblower_reward * 8 // 64
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(
        state, whistleblower_index, whistleblower_reward - proposer_reward
    )
