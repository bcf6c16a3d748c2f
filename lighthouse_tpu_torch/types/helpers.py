"""Signing roots, domains, and small spec helpers.

Parity: ``consensus/types/src/chain_spec.rs`` domain computation and the
signing-root flow used by every signature-set constructor
(``consensus/state_processing/src/per_block_processing/signature_sets.rs:74-``).
"""

from __future__ import annotations

from .containers import ForkData, SigningData
from .spec import ChainSpec


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return ForkData(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root,
    ).tree_root()


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes, fork_version: bytes, genesis_validators_root: bytes
) -> bytes:
    fdr = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fdr[:28]


def get_domain(
    spec: ChainSpec, state, domain_type: bytes, epoch: int | None = None
) -> bytes:
    ep = epoch if epoch is not None else spec.compute_epoch_at_slot(state.slot)
    fork = state.fork
    version = (
        fork.previous_version if ep < fork.epoch else fork.current_version
    )
    return compute_domain(domain_type, version, state.genesis_validators_root)


def compute_signing_root(obj, domain: bytes) -> bytes:
    return SigningData(object_root=obj.tree_root(), domain=domain).tree_root()


# -- validator predicates (beacon_state helpers) ----------------------------------


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_eligible_for_activation_queue(v, spec: ChainSpec) -> bool:
    from .spec import FAR_FUTURE_EPOCH

    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == spec.max_effective_balance
    )


def is_slashable_validator(v, epoch: int) -> bool:
    return not v.slashed and v.activation_epoch <= epoch < v.withdrawable_epoch


def is_slashable_attestation_data(d1, d2) -> bool:
    """Double vote or surround vote (proto: is_slashable_attestation_data)."""
    double = d1 != d2 and d1.target.epoch == d2.target.epoch
    surround = (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )
    return double or surround


def sync_committee_signing_root(spec, state_or_fork_info, slot: int,
                                beacon_block_root: bytes) -> bytes:
    """Signing root of a sync-committee message: the block root under the
    sync-committee domain of ``slot``'s epoch. Shared by the BN verifier and
    the VC signer so the two can never diverge."""
    from .containers import SigningData

    domain = get_domain(
        spec, state_or_fork_info, spec.DOMAIN_SYNC_COMMITTEE,
        epoch=spec.compute_epoch_at_slot(int(slot)),
    )
    return SigningData(
        object_root=bytes(beacon_block_root), domain=domain
    ).tree_root()
