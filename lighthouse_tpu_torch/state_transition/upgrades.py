"""Fork-boundary state upgrades (bellatrix, capella).

Twin of ``consensus/state_processing/src/upgrade/{bellatrix,capella}.rs``.
Upgrades mutate IN PLACE by swapping the container class and adding the new
fork's fields — every holder of the state reference sees the upgraded state,
matching the mutate-in-place convention of the rest of the transition code.
"""

from __future__ import annotations

from ..types.containers import Fork, for_preset
from .per_block import BlockProcessingError
from ..types.spec import ChainSpec
from .beacon_state_util import get_current_epoch, invalidate_caches


def upgrade_to_altair(spec: ChainSpec, state) -> None:
    """phase0 -> altair: participation flags + sync committees; previous-epoch
    pending attestations are translated into participation flags
    (upgrade/altair.rs translate_participation)."""
    import numpy as np

    ns = for_preset(spec.preset.name)
    epoch = get_current_epoch(spec, state)
    n = len(state.validators)
    pending = list(state.previous_epoch_attestations)

    state.fork = Fork(
        previous_version=bytes(state.fork.current_version),
        current_version=spec.altair_fork_version,
        epoch=epoch,
    )
    del state.previous_epoch_attestations
    del state.current_epoch_attestations
    state.__class__ = ns.BeaconStateAltair
    state.previous_epoch_participation = np.zeros(n, np.uint8)
    state.current_epoch_participation = np.zeros(n, np.uint8)
    state.inactivity_scores = np.zeros(n, np.uint64)
    invalidate_caches(state)

    # translate_participation: replay pending attestations as flag sets
    from .beacon_state_util import get_beacon_committee
    from .per_block import get_attestation_participation_flag_indices

    for att in pending:
        try:
            flag_indices = get_attestation_participation_flag_indices(
                spec, state, att.data, int(att.inclusion_delay)
            )
        except BlockProcessingError:
            continue  # source no longer matches after the boundary: no flags
        committee = get_beacon_committee(
            spec, state, int(att.data.slot), int(att.data.index)
        )
        bits = np.asarray(att.aggregation_bits, dtype=bool)
        for pos, vi in enumerate(committee):
            if pos < len(bits) and bits[pos]:
                for fi in flag_indices:
                    state.previous_epoch_participation[int(vi)] |= np.uint8(1 << fi)

    from .per_epoch import get_next_sync_committee

    state.current_sync_committee = get_next_sync_committee(spec, state)
    state.next_sync_committee = get_next_sync_committee(spec, state)


def upgrade_to_bellatrix(spec: ChainSpec, state) -> None:
    """altair -> bellatrix: default execution payload header (pre-merge)."""
    ns = for_preset(spec.preset.name)
    epoch = get_current_epoch(spec, state)
    state.fork = Fork(
        previous_version=bytes(state.fork.current_version),
        current_version=spec.bellatrix_fork_version,
        epoch=epoch,
    )
    state.__class__ = ns.BeaconStateBellatrix
    state.latest_execution_payload_header = ns.ExecutionPayloadHeaderBellatrix()
    invalidate_caches(state)


def upgrade_to_capella(spec: ChainSpec, state) -> None:
    """bellatrix -> capella: withdrawals bookkeeping + header gains
    withdrawals_root + historical accumulation switches to summaries."""
    ns = for_preset(spec.preset.name)
    epoch = get_current_epoch(spec, state)
    state.fork = Fork(
        previous_version=bytes(state.fork.current_version),
        current_version=spec.capella_fork_version,
        epoch=epoch,
    )
    old = state.latest_execution_payload_header
    new_hdr = ns.ExecutionPayloadHeaderCapella(
        **{n: getattr(old, n) for n, _ in type(old).FIELDS}
    )
    state.__class__ = ns.BeaconStateCapella
    state.latest_execution_payload_header = new_hdr
    state.next_withdrawal_index = 0
    state.next_withdrawal_validator_index = 0
    state.historical_summaries = []
    invalidate_caches(state)


def upgrade_to_deneb(spec: ChainSpec, state) -> None:
    """capella -> deneb: payload header gains blob-gas fields
    (upgrade/deneb.rs)."""
    ns = for_preset(spec.preset.name)
    epoch = get_current_epoch(spec, state)
    state.fork = Fork(
        previous_version=bytes(state.fork.current_version),
        current_version=spec.deneb_fork_version,
        epoch=epoch,
    )
    old = state.latest_execution_payload_header
    new_hdr = ns.ExecutionPayloadHeaderDeneb(
        **{n: getattr(old, n) for n, _ in type(old).FIELDS}
    )
    state.__class__ = ns.BeaconStateDeneb
    state.latest_execution_payload_header = new_hdr
    invalidate_caches(state)


def upgrade_to_electra(spec: ChainSpec, state) -> None:
    """deneb -> electra (upgrade/electra.rs): balance-churn bookkeeping,
    pre-activation validators re-queued as pending deposits, compounding
    early adopters get their excess balance queued."""
    from .common import FAR_FUTURE_EPOCH, compute_activation_exit_epoch
    from .electra import (
        G2_POINT_AT_INFINITY,
        UNSET_DEPOSIT_REQUESTS_START_INDEX,
        get_activation_exit_churn_limit,
        get_consolidation_churn_limit,
        has_compounding_withdrawal_credential,
        queue_excess_active_balance,
    )

    ns = for_preset(spec.preset.name)
    epoch = get_current_epoch(spec, state)
    state.fork = Fork(
        previous_version=bytes(state.fork.current_version),
        current_version=spec.electra_fork_version,
        epoch=epoch,
    )
    earliest_exit = compute_activation_exit_epoch(spec, epoch)
    for v in state.validators:
        if v.exit_epoch != FAR_FUTURE_EPOCH:
            earliest_exit = max(earliest_exit, int(v.exit_epoch))
    earliest_exit += 1

    state.__class__ = ns.BeaconStateElectra
    state.deposit_requests_start_index = UNSET_DEPOSIT_REQUESTS_START_INDEX
    state.deposit_balance_to_consume = 0
    state.exit_balance_to_consume = 0
    state.earliest_exit_epoch = earliest_exit
    state.consolidation_balance_to_consume = 0
    state.earliest_consolidation_epoch = compute_activation_exit_epoch(spec, epoch)
    state.pending_deposits = []
    state.pending_partial_withdrawals = []
    state.pending_consolidations = []
    invalidate_caches(state)
    state.exit_balance_to_consume = get_activation_exit_churn_limit(spec, state)
    state.consolidation_balance_to_consume = get_consolidation_churn_limit(
        spec, state
    )

    # re-queue validators that had not activated as pending deposits
    pre_activation = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (
            int(state.validators[i].activation_eligibility_epoch),
            i,
        ),
    )
    for i in pre_activation:
        v = state.validators[i]
        balance = int(state.balances[i])
        state.balances[i] = 0
        v.effective_balance = 0
        v.activation_eligibility_epoch = FAR_FUTURE_EPOCH
        state.pending_deposits = list(state.pending_deposits) + [
            ns.PendingDeposit(
                pubkey=bytes(v.pubkey),
                withdrawal_credentials=bytes(v.withdrawal_credentials),
                amount=balance,
                signature=G2_POINT_AT_INFINITY,
                slot=0,
            )
        ]
    # early compounding adopters keep their excess working
    for i, v in enumerate(state.validators):
        if has_compounding_withdrawal_credential(v):
            queue_excess_active_balance(spec, state, i)


UPGRADES = {
    "altair": upgrade_to_altair,
    "bellatrix": upgrade_to_bellatrix,
    "capella": upgrade_to_capella,
    "deneb": upgrade_to_deneb,
    "electra": upgrade_to_electra,
}

_FORK_RANK = {f: i for i, f in enumerate(["phase0", *UPGRADES])}


def apply_fork_upgrades(spec: ChainSpec, state) -> None:
    """Run any upgrade scheduled exactly at the state's current epoch
    (called by process_slots right after crossing an epoch boundary).
    Upgrades apply strictly in fork order from the state's CURRENT fork, so a
    later upgrade can never fire on a state missing earlier forks' fields."""
    epoch = get_current_epoch(spec, state)
    for fork, fn in UPGRADES.items():
        if (
            spec.fork_epoch(fork) == epoch
            and _FORK_RANK[getattr(state, "fork_name", "phase0")]
            == _FORK_RANK[fork] - 1
        ):
            fn(spec, state)
            # upgrades mutate registry fields (and the kernel fork family)
            # without journaling — force a full mirror re-gather
            from ..epoch_engine import invalidate_registry_journal

            invalidate_registry_journal(state)
