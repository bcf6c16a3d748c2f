"""Electra state-transition pieces (EIP-6110/7002/7251/7549).

Twin of the reference's electra modules in ``consensus/state_processing``
(process_operations.rs request handlers, single_pass.rs pending-deposit /
consolidation sweeps, upgrade/electra.rs). Balance-denominated churn
replaces validator-count churn; deposits flow through an in-state pending
queue; withdrawals and consolidations arrive as execution-layer requests.
"""

from __future__ import annotations

import numpy as np

from ..types.spec import ChainSpec, FAR_FUTURE_EPOCH
from .beacon_state_util import get_current_epoch, get_total_active_balance
from .common import (
    compute_activation_exit_epoch,
    decrease_balance,
    increase_balance,
)

UNSET_DEPOSIT_REQUESTS_START_INDEX = 2**64 - 1
FULL_EXIT_REQUEST_AMOUNT = 0
G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95
COMPOUNDING_WITHDRAWAL_PREFIX = b"\x02"
ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"


# -- credential / balance helpers -------------------------------------------------


def has_compounding_withdrawal_credential(validator) -> bool:
    return bytes(validator.withdrawal_credentials)[:1] == COMPOUNDING_WITHDRAWAL_PREFIX


def has_eth1_withdrawal_credential(validator) -> bool:
    from .per_block import has_eth1_withdrawal_credential as _impl

    return _impl(validator)


def has_execution_withdrawal_credential(validator) -> bool:
    return has_compounding_withdrawal_credential(validator) or (
        has_eth1_withdrawal_credential(validator)
    )


def get_max_effective_balance(spec: ChainSpec, validator) -> int:
    if has_compounding_withdrawal_credential(validator):
        return spec.max_effective_balance_electra
    return spec.min_activation_balance


def get_pending_balance_to_withdraw(state, validator_index: int) -> int:
    return sum(
        int(w.amount)
        for w in state.pending_partial_withdrawals
        if int(w.validator_index) == validator_index
    )


# -- balance-denominated churn (EIP-7251) -----------------------------------------


def get_balance_churn_limit(spec: ChainSpec, state) -> int:
    churn = max(
        spec.min_per_epoch_churn_limit_electra,
        get_total_active_balance(spec, state) // spec.churn_limit_quotient,
    )
    return churn - churn % spec.effective_balance_increment


def get_activation_exit_churn_limit(spec: ChainSpec, state) -> int:
    return min(
        spec.max_per_epoch_activation_exit_churn_limit,
        get_balance_churn_limit(spec, state),
    )


def get_consolidation_churn_limit(spec: ChainSpec, state) -> int:
    return get_balance_churn_limit(spec, state) - get_activation_exit_churn_limit(
        spec, state
    )


def compute_exit_epoch_and_update_churn(spec, state, exit_balance: int) -> int:
    earliest = max(
        int(state.earliest_exit_epoch),
        compute_activation_exit_epoch(spec, get_current_epoch(spec, state)),
    )
    per_epoch_churn = get_activation_exit_churn_limit(spec, state)
    exit_balance_to_consume = (
        per_epoch_churn
        if int(state.earliest_exit_epoch) < earliest
        else int(state.exit_balance_to_consume)
    )
    if exit_balance > exit_balance_to_consume:
        balance_to_process = exit_balance - exit_balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest += additional_epochs
        exit_balance_to_consume += additional_epochs * per_epoch_churn
    state.exit_balance_to_consume = exit_balance_to_consume - exit_balance
    state.earliest_exit_epoch = earliest
    return earliest


def compute_consolidation_epoch_and_update_churn(
    spec, state, consolidation_balance: int
) -> int:
    earliest = max(
        int(state.earliest_consolidation_epoch),
        compute_activation_exit_epoch(spec, get_current_epoch(spec, state)),
    )
    per_epoch_churn = get_consolidation_churn_limit(spec, state)
    balance_to_consume = (
        per_epoch_churn
        if int(state.earliest_consolidation_epoch) < earliest
        else int(state.consolidation_balance_to_consume)
    )
    if consolidation_balance > balance_to_consume:
        balance_to_process = consolidation_balance - balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest += additional_epochs
        balance_to_consume += additional_epochs * per_epoch_churn
    state.consolidation_balance_to_consume = (
        balance_to_consume - consolidation_balance
    )
    state.earliest_consolidation_epoch = earliest
    return earliest


def initiate_validator_exit_electra(spec, state, index: int) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_queue_epoch = compute_exit_epoch_and_update_churn(
        spec, state, int(v.effective_balance)
    )
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = (
        exit_queue_epoch + spec.min_validator_withdrawability_delay
    )
    from ..epoch_engine import mark_registry_delta

    mark_registry_delta(state, index)


def queue_excess_active_balance(spec, state, index: int) -> None:
    from ..types.containers import for_preset

    ns = for_preset(spec.preset.name)
    balance = int(state.balances[index])
    if balance > spec.min_activation_balance:
        excess = balance - spec.min_activation_balance
        state.balances[index] = spec.min_activation_balance
        v = state.validators[index]
        state.pending_deposits = list(state.pending_deposits) + [
            ns.PendingDeposit(
                pubkey=bytes(v.pubkey),
                withdrawal_credentials=bytes(v.withdrawal_credentials),
                amount=excess,
                signature=G2_POINT_AT_INFINITY,
                slot=0,  # GENESIS_SLOT: exempt from finality delay
            )
        ]


def switch_to_compounding_validator(spec, state, index: int) -> None:
    v = state.validators[index]
    v.withdrawal_credentials = (
        COMPOUNDING_WITHDRAWAL_PREFIX + bytes(v.withdrawal_credentials)[1:]
    )
    # the credential prefix feeds the mirror's derived "compounding" column
    from ..epoch_engine import mark_registry_delta

    mark_registry_delta(state, index)
    queue_excess_active_balance(spec, state, index)


# -- execution-layer requests (block processing) ----------------------------------


def process_deposit_request(spec, state, request) -> None:
    """EIP-6110: deposits surface as EL receipts, queued in-state."""
    from ..types.containers import for_preset

    ns = for_preset(spec.preset.name)
    if int(state.deposit_requests_start_index) == UNSET_DEPOSIT_REQUESTS_START_INDEX:
        state.deposit_requests_start_index = int(request.index)
    state.pending_deposits = list(state.pending_deposits) + [
        ns.PendingDeposit(
            pubkey=bytes(request.pubkey),
            withdrawal_credentials=bytes(request.withdrawal_credentials),
            amount=int(request.amount),
            signature=bytes(request.signature),
            slot=int(state.slot),
        )
    ]


def process_withdrawal_request(spec, state, request, ctxt=None) -> None:
    """EIP-7002: EL-triggered (partial or full) withdrawal. Invalid
    requests are no-ops, never block failures."""
    amount = int(request.amount)
    is_full_exit = amount == FULL_EXIT_REQUEST_AMOUNT
    # partial withdrawals bounded by queue capacity
    if (
        not is_full_exit
        and len(state.pending_partial_withdrawals)
        >= spec.preset.PENDING_PARTIAL_WITHDRAWALS_LIMIT
    ):
        return
    index = _pubkey_index(state, bytes(request.validator_pubkey), ctxt)
    if index is None:
        return
    v = state.validators[index]
    # source address must own the credentials
    if not has_execution_withdrawal_credential(v):
        return
    if bytes(v.withdrawal_credentials)[12:] != bytes(request.source_address):
        return
    cur = get_current_epoch(spec, state)
    from ..types.helpers import is_active_validator

    if not is_active_validator(v, cur):
        return
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if cur < int(v.activation_epoch) + spec.shard_committee_period:
        return

    pending_balance = get_pending_balance_to_withdraw(state, index)
    if is_full_exit:
        if pending_balance == 0:
            initiate_validator_exit_electra(spec, state, index)
        return
    has_sufficient = (
        has_compounding_withdrawal_credential(v)
        and int(v.effective_balance) >= spec.min_activation_balance
        and int(state.balances[index])
        > spec.min_activation_balance + pending_balance
    )
    if not has_sufficient:
        return
    from ..types.containers import for_preset

    ns = for_preset(spec.preset.name)
    to_withdraw = min(
        int(state.balances[index]) - spec.min_activation_balance - pending_balance,
        amount,
    )
    exit_queue_epoch = compute_exit_epoch_and_update_churn(spec, state, to_withdraw)
    withdrawable_epoch = (
        exit_queue_epoch + spec.min_validator_withdrawability_delay
    )
    state.pending_partial_withdrawals = list(state.pending_partial_withdrawals) + [
        ns.PendingPartialWithdrawal(
            validator_index=index,
            amount=to_withdraw,
            withdrawable_epoch=withdrawable_epoch,
        )
    ]


def process_consolidation_request(spec, state, request, ctxt=None) -> None:
    """EIP-7251: merge source validator's balance into target."""
    from ..types.helpers import is_active_validator

    if _is_valid_switch_to_compounding(spec, state, request, ctxt):
        index = _pubkey_index(state, bytes(request.source_pubkey), ctxt)
        switch_to_compounding_validator(spec, state, index)
        return
    # queue capacity + churn sanity
    if (
        len(state.pending_consolidations)
        >= spec.preset.PENDING_CONSOLIDATIONS_LIMIT
    ):
        return
    if get_consolidation_churn_limit(spec, state) <= spec.min_activation_balance:
        return
    source_index = _pubkey_index(state, bytes(request.source_pubkey), ctxt)
    target_index = _pubkey_index(state, bytes(request.target_pubkey), ctxt)
    if source_index is None or target_index is None or source_index == target_index:
        return
    source = state.validators[source_index]
    target = state.validators[target_index]
    if not has_execution_withdrawal_credential(source):
        return
    if not has_compounding_withdrawal_credential(target):
        return
    if bytes(source.withdrawal_credentials)[12:] != bytes(request.source_address):
        return
    cur = get_current_epoch(spec, state)
    if not is_active_validator(source, cur) or not is_active_validator(target, cur):
        return
    if source.exit_epoch != FAR_FUTURE_EPOCH or target.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if cur < int(source.activation_epoch) + spec.shard_committee_period:
        return
    if get_pending_balance_to_withdraw(state, source_index) > 0:
        return

    from ..types.containers import for_preset

    ns = for_preset(spec.preset.name)
    exit_epoch = compute_consolidation_epoch_and_update_churn(
        spec, state, int(source.effective_balance)
    )
    source.exit_epoch = exit_epoch
    source.withdrawable_epoch = exit_epoch + spec.min_validator_withdrawability_delay
    from ..epoch_engine import mark_registry_delta

    mark_registry_delta(state, source_index)
    state.pending_consolidations = list(state.pending_consolidations) + [
        ns.PendingConsolidation(
            source_index=source_index, target_index=target_index
        )
    ]


def _is_valid_switch_to_compounding(spec, state, request, ctxt=None) -> bool:
    from ..types.helpers import is_active_validator

    if bytes(request.source_pubkey) != bytes(request.target_pubkey):
        return False
    index = _pubkey_index(state, bytes(request.source_pubkey), ctxt)
    if index is None:
        return False
    v = state.validators[index]
    if not has_eth1_withdrawal_credential(v):
        return False
    if bytes(v.withdrawal_credentials)[12:] != bytes(request.source_address):
        return False
    if not is_active_validator(v, get_current_epoch(spec, state)):
        return False
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return False
    return True


def _pubkey_index(state, pubkey: bytes, ctxt=None):
    if ctxt is not None:
        return ctxt.lookup_pubkey_index(state, pubkey)
    for i, v in enumerate(state.validators):
        if bytes(v.pubkey) == pubkey:
            return i
    return None


# -- pending queues (epoch processing) --------------------------------------------


def apply_pending_deposit(spec, state, deposit, ctxt=None) -> None:
    from . import signature_sets as sigs
    from .per_block import add_validator_to_registry

    index = _pubkey_index(state, bytes(deposit.pubkey), ctxt)
    if index is None:
        if sigs.deposit_signature_is_valid(spec, deposit):
            add_validator_to_registry(spec, state, deposit, amount_override=0)
            increase_balance(state, len(state.validators) - 1, int(deposit.amount))
        return
    increase_balance(state, index, int(deposit.amount))


def process_pending_deposits(spec, state, ctxt=None) -> None:
    next_epoch = get_current_epoch(spec, state) + 1
    available = int(state.deposit_balance_to_consume) + get_activation_exit_churn_limit(
        spec, state
    )
    processed_amount = 0
    next_deposit_index = 0
    deposits_to_postpone = []
    is_churn_limit_reached = False
    finalized_slot = spec.start_slot(int(state.finalized_checkpoint.epoch))

    pending = list(state.pending_deposits)
    for deposit in pending:
        # EIP-6110 transition: EL deposit requests wait until every
        # eth1-bridge deposit has been applied
        if (
            int(deposit.slot) > 0
            and int(state.eth1_deposit_index)
            < int(state.deposit_requests_start_index)
        ):
            break
        # deposits snapshotted from EL receipts wait for finality
        if int(deposit.slot) > finalized_slot:
            break
        if next_deposit_index >= spec.preset.MAX_PENDING_DEPOSITS_PER_EPOCH:
            break
        index = _pubkey_index(state, bytes(deposit.pubkey), ctxt)
        is_validator_exited = False
        is_validator_withdrawn = False
        if index is not None:
            v = state.validators[index]
            is_validator_exited = int(v.exit_epoch) < FAR_FUTURE_EPOCH
            is_validator_withdrawn = int(v.withdrawable_epoch) < next_epoch
        if is_validator_withdrawn:
            # deposited balance will simply be withdrawn again: free
            apply_pending_deposit(spec, state, deposit, ctxt)
        elif is_validator_exited:
            deposits_to_postpone.append(deposit)
        else:
            is_churn_limit_reached = (
                processed_amount + int(deposit.amount) > available
            )
            if is_churn_limit_reached:
                break
            apply_pending_deposit(spec, state, deposit, ctxt)
            processed_amount += int(deposit.amount)
        next_deposit_index += 1

    state.pending_deposits = pending[next_deposit_index:] + deposits_to_postpone
    if is_churn_limit_reached:
        state.deposit_balance_to_consume = available - processed_amount
    else:
        state.deposit_balance_to_consume = 0


def process_pending_consolidations(spec, state) -> None:
    next_epoch = get_current_epoch(spec, state) + 1
    next_index = 0
    pending = list(state.pending_consolidations)
    for consolidation in pending:
        source = state.validators[int(consolidation.source_index)]
        if source.slashed:
            next_index += 1
            continue
        if int(source.withdrawable_epoch) > next_epoch:
            break
        # move active balance; excess stays with source as withdrawable
        balance = min(
            int(state.balances[int(consolidation.source_index)]),
            int(source.effective_balance),
        )
        decrease_balance(state, int(consolidation.source_index), balance)
        increase_balance(state, int(consolidation.target_index), balance)
        next_index += 1
    state.pending_consolidations = pending[next_index:]


# -- attestations (EIP-7549) ------------------------------------------------------


def get_committee_indices(committee_bits) -> list[int]:
    return [i for i, b in enumerate(np.asarray(committee_bits, dtype=bool)) if b]


def get_attesting_indices_electra(spec, state, attestation) -> list[int]:
    """Committee-spanning aggregation bits -> attesting validator indices."""
    from .beacon_state_util import get_beacon_committee

    out = []
    bits = np.asarray(attestation.aggregation_bits, dtype=bool)
    offset = 0
    for ci in get_committee_indices(attestation.committee_bits):
        committee = get_beacon_committee(
            spec, state, int(attestation.data.slot), ci
        )
        chunk = bits[offset : offset + committee.size]
        out.extend(int(v) for v, b in zip(committee, chunk) if b)
        offset += committee.size
    return out
