"""Block processing: header, randao, eth1 data, operations, sync aggregate.

Parity: ``consensus/state_processing/src/per_block_processing.rs:100-196``
with ``BlockSignatureStrategy`` (``:125-145``) and the bulk signature collector
(``block_signature_verifier.rs:127-396``): under VerifyBulk every signature in
the block lands in ONE ``bls.verify_signature_sets`` batch — the port's
device arm (``lighthouse_tpu_torch.bls``, the CUDA plan and chain kernels). Operations parity: ``per_block_processing/process_operations.rs``.
"""

from __future__ import annotations

import enum
import functools

import numpy as np

from .. import bls
from ..ssz.merkle import next_pow2
from ..ssz.sha256 import sha256
from ..types.helpers import (
    compute_signing_root, get_domain, is_active_validator,
    is_slashable_attestation_data, is_slashable_validator,
)
from ..types.spec import ChainSpec, FAR_FUTURE_EPOCH, fork_at_least
from . import signature_sets as sigs
from .beacon_state_util import (
    StateTransitionError,
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    get_total_active_balance,
    invalidate_caches,
)
from .common import (
    decrease_balance,
    get_validator_churn_limit,
    increase_balance,
    initiate_validator_exit,
    slash_validator,
)

# altair participation flag indices / weights
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT,
]


class BlockProcessingError(StateTransitionError):
    pass


class BlockSignatureStrategy(enum.Enum):
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_BULK = "verify_bulk"
    VERIFY_RANDAO = "verify_randao"


class ConsensusContext:
    """Memoizes proposer index / block root across pipeline stages
    (consensus_context.rs:12)."""

    def __init__(self):
        self.proposer_index: int | None = None
        self.block_root: bytes | None = None
        self.indexed_attestations: dict = {}
        # optional pubkey-bytes -> validator-index lookup (the chain threads
        # its ValidatorPubkeyCache.get_index here to avoid O(n) registry scans)
        self.get_pubkey_index = None

    def lookup_pubkey_index(self, state, pk: bytes) -> int | None:
        """Resolve a pubkey to its index in *this* state (cache hit must be
        bounded by the state's registry and byte-verified — indices are
        append-ordered so cross-fork caches stay consistent)."""
        if self.get_pubkey_index is not None:
            idx = self.get_pubkey_index(pk)
            if (
                idx is not None
                and idx < len(state.validators)
                and bytes(state.validators[idx].pubkey) == pk
            ):
                return idx
            return None
        for i, v in enumerate(state.validators):
            if bytes(v.pubkey) == pk:
                return i
        return None

    def get_proposer_index(self, spec, state) -> int:
        if self.proposer_index is None:
            self.proposer_index = get_beacon_proposer_index(spec, state)
        return self.proposer_index


class BlockSignatureVerifier:
    """Collects every block signature into one batch
    (block_signature_verifier.rs:127-396)."""

    def __init__(self, spec: ChainSpec, state, get_pubkey=None):
        self.spec = spec
        self.state = state
        self.get_pubkey = get_pubkey
        self.sets: list = []

    def include_all_signatures(self, signed_block, ctxt: ConsensusContext):
        self.include_block_proposal(signed_block)
        self.include_all_signatures_except_proposal(signed_block, ctxt)

    def include_all_signatures_except_proposal(self, signed_block, ctxt):
        block = signed_block.message
        self.include_randao_reveal(block)
        self.include_proposer_slashings(block)
        self.include_attester_slashings(block)
        self.include_attestations(block, ctxt)
        self.include_exits(block)
        self.include_sync_aggregate(block)
        self.include_bls_to_execution_changes(block)

    def include_block_proposal(self, signed_block):
        self.sets.append(
            sigs.block_proposal_signature_set(
                self.spec, self.state, signed_block, get_pubkey=self.get_pubkey
            )
        )

    def include_randao_reveal(self, block):
        self.sets.append(
            sigs.randao_signature_set(
                self.spec, self.state, block.proposer_index,
                self.spec.compute_epoch_at_slot(block.slot),
                block.body.randao_reveal, self.get_pubkey,
            )
        )

    def include_proposer_slashings(self, block):
        for sl in block.body.proposer_slashings:
            self.sets.extend(
                sigs.proposer_slashing_signature_sets(
                    self.spec, self.state, sl, self.get_pubkey
                )
            )

    def include_attester_slashings(self, block):
        for sl in block.body.attester_slashings:
            for indexed in (sl.attestation_1, sl.attestation_2):
                self.sets.append(
                    sigs.indexed_attestation_signature_set(
                        self.spec, self.state, indexed, self.get_pubkey
                    )
                )

    def include_attestations(self, block, ctxt: ConsensusContext):
        for i, att in enumerate(block.body.attestations):
            indexed = get_indexed_attestation(self.spec, self.state, att)
            ctxt.indexed_attestations[i] = indexed
            self.sets.append(
                sigs.indexed_attestation_signature_set(
                    self.spec, self.state, indexed, self.get_pubkey
                )
            )

    def include_exits(self, block):
        for ex in block.body.voluntary_exits:
            self.sets.append(
                sigs.exit_signature_set(self.spec, self.state, ex, self.get_pubkey)
            )

    def include_bls_to_execution_changes(self, block):
        for ch in getattr(block.body, "bls_to_execution_changes", []):
            self.sets.append(
                sigs.bls_to_execution_change_signature_set(
                    self.spec, self.state, ch
                )
            )

    def include_sync_aggregate(self, block):
        agg = getattr(block.body, "sync_aggregate", None)
        if agg is None:
            return
        s = sync_aggregate_signature_set(
            self.spec, self.state, block.slot, agg, self.get_pubkey
        )
        if s is not None:
            self.sets.append(s)

    def verify(self) -> None:
        if not bls.verify_signature_sets(self.sets):
            raise BlockProcessingError("bulk signature verification failed")


def sync_aggregate_signature_set(spec, state, block_slot, agg, get_pubkey=None):
    """Signature set for the sync committee aggregate: signs the previous
    slot's block root with the sync-committee domain. None when no bits set
    (infinity signature allowed iff zero participants)."""
    bits = np.asarray(agg.sync_committee_bits, dtype=bool)
    sig = bls.Signature.from_bytes(bytes(agg.sync_committee_signature))
    if not bits.any():
        if sig.point is None:
            return None
        raise BlockProcessingError("non-infinity sync signature with no bits")
    previous_slot = max(int(block_slot), 1) - 1
    domain = get_domain(
        spec, state, spec.DOMAIN_SYNC_COMMITTEE,
        epoch=spec.compute_epoch_at_slot(previous_slot),
    )
    from ..ssz import ByteVector
    from ..types.containers import SigningData

    root = SigningData(
        object_root=get_block_root_at_slot(spec, state, previous_slot),
        domain=domain,
    ).tree_root()
    keys = []
    for i, bit in enumerate(bits):
        if bit:
            pk_bytes = bytes(state.current_sync_committee.pubkeys[i])
            keys.append(bls.PublicKey.from_bytes(pk_bytes))
    return bls.SignatureSet.multiple_pubkeys(sig, keys, root)


# -------------------------------------------------------------------------------
# Top-level entry (per_block_processing.rs:100)
# -------------------------------------------------------------------------------


def per_block_processing(
    spec: ChainSpec,
    state,
    signed_block,
    strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ctxt: ConsensusContext | None = None,
    get_pubkey=None,
    verify_block_root: bool = True,
) -> ConsensusContext:
    ctxt = ctxt or ConsensusContext()
    block = signed_block.message

    if strategy == BlockSignatureStrategy.VERIFY_BULK:
        v = BlockSignatureVerifier(spec, state, get_pubkey)
        v.include_all_signatures(signed_block, ctxt)
        v.verify()
        inner = "none"
    elif strategy == BlockSignatureStrategy.VERIFY_INDIVIDUAL:
        if not bls.verify_signature_sets(
            [sigs.block_proposal_signature_set(spec, state, signed_block, get_pubkey=get_pubkey)]
        ):
            raise BlockProcessingError("invalid proposer signature")
        inner = "individual"
    elif strategy == BlockSignatureStrategy.VERIFY_RANDAO:
        inner = "randao"
    else:
        inner = "none"

    process_block_header(spec, state, block, ctxt)
    fork = getattr(state, "fork_name", "phase0")
    commitments = getattr(block.body, "blob_kzg_commitments", None)
    if commitments is not None and len(commitments) > spec.preset.MAX_BLOBS_PER_BLOCK:
        raise BlockProcessingError(
            f"{len(commitments)} blob commitments exceeds "
            f"MAX_BLOBS_PER_BLOCK {spec.preset.MAX_BLOBS_PER_BLOCK}"
        )
    payload = getattr(block.body, "execution_payload", None)
    if payload is not None and is_execution_enabled(state, payload):
        if fork_at_least(fork, "capella"):
            process_withdrawals(spec, state, payload)
        # EL notify_new_payload happens at the chain layer
        # (block_verification.rs ExecutionPendingBlock); here only the
        # consensus-consistency checks + header update run.
        process_execution_payload(spec, state, payload)
    process_randao(spec, state, block, verify=(inner in ("individual", "randao")))
    process_eth1_data(spec, state, block.body)
    process_operations(spec, state, block.body, ctxt, verify=(inner == "individual"))
    agg = getattr(block.body, "sync_aggregate", None)
    if agg is not None:
        process_sync_aggregate(
            spec, state, block.slot, agg, verify=(inner == "individual"),
            ctxt=ctxt,
        )
    if verify_block_root:
        sr = state.tree_root()
        if bytes(block.state_root) != sr:
            raise BlockProcessingError(
                f"state root mismatch: block {bytes(block.state_root).hex()[:16]} "
                f"!= computed {sr.hex()[:16]}"
            )
    return ctxt


def process_block_header(spec, state, block, ctxt: ConsensusContext):
    if block.slot != state.slot:
        raise BlockProcessingError("block slot != state slot")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block not newer than latest header")
    expected = ctxt.get_proposer_index(spec, state)
    if block.proposer_index != expected:
        raise BlockProcessingError(
            f"wrong proposer {block.proposer_index} != {expected}"
        )
    if bytes(block.parent_root) != state.latest_block_header.tree_root():
        raise BlockProcessingError("parent root mismatch")
    from ..types.containers import BeaconBlockHeader

    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,
        body_root=type(block.body).hash_tree_root(block.body),
    )
    proposer = state.validators[block.proposer_index]
    if proposer.slashed:
        raise BlockProcessingError("proposer slashed")


def process_randao(spec, state, block, verify: bool):
    epoch = get_current_epoch(spec, state)
    if verify:
        s = sigs.randao_signature_set(
            spec, state, block.proposer_index, epoch, block.body.randao_reveal
        )
        if not bls.verify_signature_sets([s]):
            raise BlockProcessingError("invalid randao reveal")
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(spec, state, epoch),
            sha256(bytes(block.body.randao_reveal)),
        )
    )
    state.randao_mixes[epoch % spec.preset.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def process_eth1_data(spec, state, body):
    state.eth1_data_votes = list(state.eth1_data_votes) + [body.eth1_data]
    period = spec.preset.slots_per_eth1_voting_period
    count = sum(1 for v in state.eth1_data_votes if v == body.eth1_data)
    if count * 2 > period:
        state.eth1_data = body.eth1_data


# -------------------------------------------------------------------------------
# Operations (process_operations.rs)
# -------------------------------------------------------------------------------


def process_operations(spec, state, body, ctxt: ConsensusContext, verify: bool):
    electra = fork_at_least(getattr(state, "fork_name", "phase0"), "electra")
    if electra:
        # EIP-6110: legacy eth1 deposits stop at deposit_requests_start_index
        limit = min(
            int(state.eth1_data.deposit_count),
            int(state.deposit_requests_start_index),
        )
        if int(state.eth1_deposit_index) < limit:
            expected_deposits = min(
                spec.preset.MAX_DEPOSITS, limit - int(state.eth1_deposit_index)
            )
        else:
            expected_deposits = 0
    else:
        expected_deposits = min(
            spec.preset.MAX_DEPOSITS,
            state.eth1_data.deposit_count - state.eth1_deposit_index,
        )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )
    for sl in body.proposer_slashings:
        process_proposer_slashing(spec, state, sl, ctxt, verify)
    for sl in body.attester_slashings:
        process_attester_slashing(spec, state, sl, verify)
    for i, att in enumerate(body.attestations):
        process_attestation(spec, state, att, i, ctxt, verify)
    for dep in body.deposits:
        process_deposit(spec, state, dep, ctxt)
    for ex in body.voluntary_exits:
        process_exit(spec, state, ex, verify)
    for change in getattr(body, "bls_to_execution_changes", []):
        process_bls_to_execution_change(spec, state, change, verify)
    requests = getattr(body, "execution_requests", None)
    if requests is not None:
        from .electra import (
            process_consolidation_request,
            process_deposit_request,
            process_withdrawal_request,
        )

        for dr in requests.deposits:
            process_deposit_request(spec, state, dr)
        for wr in requests.withdrawals:
            process_withdrawal_request(spec, state, wr, ctxt)
        for cr in requests.consolidations:
            process_consolidation_request(spec, state, cr, ctxt)


# -- execution payloads (bellatrix+) ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _default_tree_root(cls) -> bytes:
    return cls().tree_root()


@functools.lru_cache(maxsize=None)
def _default_encoding(cls) -> bytes:
    return cls.encode(cls())


def is_merge_transition_complete(state) -> bool:
    hdr = getattr(state, "latest_execution_payload_header", None)
    if hdr is None:
        return False
    return hdr.tree_root() != _default_tree_root(type(hdr))


def payload_is_default(payload) -> bool:
    return type(payload).encode(payload) == _default_encoding(type(payload))


def is_execution_enabled(state, payload) -> bool:
    """Bellatrix is_execution_enabled: post-merge, or this IS the merge
    transition block (non-default payload on a pre-merge state)."""
    return is_merge_transition_complete(state) or not payload_is_default(payload)


def compute_timestamp_at_slot(spec, state, slot: int) -> int:
    return int(state.genesis_time) + slot * spec.preset.SECONDS_PER_SLOT


def process_execution_payload(spec, state, payload) -> None:
    """Consensus-side payload checks + header update (bellatrix
    process_execution_payload minus the engine call, which the chain layer
    performs — the reference's split between per_block_processing.rs:100 and
    block_verification.rs ExecutionPendingBlock)."""
    from .beacon_state_util import get_current_epoch, get_randao_mix

    if is_merge_transition_complete(state):
        if bytes(payload.parent_hash) != bytes(
            state.latest_execution_payload_header.block_hash
        ):
            raise BlockProcessingError("payload parent hash mismatch")
    if bytes(payload.prev_randao) != get_randao_mix(
        spec, state, get_current_epoch(spec, state)
    ):
        raise BlockProcessingError("payload prev_randao mismatch")
    if int(payload.timestamp) != compute_timestamp_at_slot(spec, state, state.slot):
        raise BlockProcessingError("payload timestamp mismatch")

    from ..types.containers import for_preset
    from ..ssz import List as SSZList

    ns = for_preset(spec.preset.name)
    fork = getattr(state, "fork_name", "bellatrix")
    hdr_cls = ns.payload_header_types[fork]
    payload_cls = ns.payload_types[fork]
    tx_type = dict(payload_cls.FIELDS)["transactions"]
    fields = {
        n: getattr(payload, n)
        for n, _ in payload_cls.FIELDS
        if n not in ("transactions", "withdrawals")
    }
    fields["transactions_root"] = tx_type.hash_tree_root(payload.transactions)
    if hasattr(payload, "withdrawals"):
        w_type = dict(payload_cls.FIELDS)["withdrawals"]
        fields["withdrawals_root"] = w_type.hash_tree_root(payload.withdrawals)
    state.latest_execution_payload_header = hdr_cls(**fields)


# -- withdrawals (capella+) --------------------------------------------------------


def has_eth1_withdrawal_credential(validator) -> bool:
    return bytes(validator.withdrawal_credentials)[:1] == b"\x01"


def is_fully_withdrawable_validator(
    validator, balance: int, epoch: int, electra: bool = False
) -> bool:
    if electra:
        from .electra import has_execution_withdrawal_credential

        cred_ok = has_execution_withdrawal_credential(validator)
    else:
        cred_ok = has_eth1_withdrawal_credential(validator)
    return cred_ok and validator.withdrawable_epoch <= epoch and balance > 0


def is_partially_withdrawable_validator(
    spec, validator, balance: int, electra: bool = False
) -> bool:
    if electra:
        from .electra import (
            get_max_effective_balance,
            has_execution_withdrawal_credential,
        )

        max_eb = get_max_effective_balance(spec, validator)
        return (
            has_execution_withdrawal_credential(validator)
            and int(validator.effective_balance) == max_eb
            and balance > max_eb
        )
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.effective_balance == spec.max_effective_balance
        and balance > spec.max_effective_balance
    )


def get_expected_withdrawals(spec, state):
    """Withdrawal sweep. Capella: full/partial sweep only. Electra adds the
    pending-partial-withdrawal queue ahead of the sweep (EIP-7251) and
    credential-dependent effective-balance ceilings.

    Always returns ``(withdrawals, processed_partials)`` — the second
    element is 0 before electra.
    """
    from ..types.containers import Withdrawal
    from .beacon_state_util import get_current_epoch

    electra = fork_at_least(getattr(state, "fork_name", "phase0"), "electra")
    epoch = get_current_epoch(spec, state)
    widx = int(state.next_withdrawal_index)
    vidx = int(state.next_withdrawal_validator_index)
    n = len(state.validators)
    out = []
    processed_partials = 0

    if electra:
        from .electra import has_execution_withdrawal_credential

        for w in state.pending_partial_withdrawals:
            if (
                int(w.withdrawable_epoch) > epoch
                or len(out)
                == spec.preset.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP
            ):
                break
            i = int(w.validator_index)
            v = state.validators[i]
            ok = (
                v.exit_epoch == FAR_FUTURE_EPOCH
                and int(v.effective_balance) >= spec.min_activation_balance
                and int(state.balances[i]) > spec.min_activation_balance
            )
            if ok:
                amount = min(
                    int(state.balances[i]) - spec.min_activation_balance,
                    int(w.amount),
                )
                out.append(
                    Withdrawal(
                        index=widx, validator_index=i,
                        address=bytes(v.withdrawal_credentials)[12:],
                        amount=amount,
                    )
                )
                widx += 1
            processed_partials += 1

    for _ in range(min(n, spec.preset.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)):
        v = state.validators[vidx]
        # balances already claimed by the partial stage don't double-count
        already = sum(
            int(w.amount) for w in out if int(w.validator_index) == vidx
        )
        balance = int(state.balances[vidx]) - already
        address = bytes(v.withdrawal_credentials)[12:]
        if electra:
            from .electra import get_max_effective_balance

            max_eb = get_max_effective_balance(spec, v)
        else:
            max_eb = spec.max_effective_balance
        if is_fully_withdrawable_validator(v, balance, epoch, electra=electra):
            out.append(
                Withdrawal(
                    index=widx, validator_index=vidx, address=address,
                    amount=balance,
                )
            )
            widx += 1
        elif is_partially_withdrawable_validator(
            spec, v, balance, electra=electra
        ):
            out.append(
                Withdrawal(
                    index=widx, validator_index=vidx, address=address,
                    amount=balance - max_eb,
                )
            )
            widx += 1
        if len(out) == spec.preset.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        vidx = (vidx + 1) % n
    return out, processed_partials


def _expected_withdrawals_list(spec, state) -> list:
    return get_expected_withdrawals(spec, state)[0]


def process_withdrawals(spec, state, payload) -> None:
    from .common import decrease_balance

    expected, processed_partials = get_expected_withdrawals(spec, state)
    if processed_partials:
        state.pending_partial_withdrawals = list(
            state.pending_partial_withdrawals
        )[processed_partials:]
    got = list(payload.withdrawals)
    if len(got) != len(expected) or any(
        type(a).encode(a) != type(b).encode(b) for a, b in zip(got, expected)
    ):
        raise BlockProcessingError("payload withdrawals != expected sweep")
    for w in expected:
        decrease_balance(state, int(w.validator_index), int(w.amount))
    n = len(state.validators)
    if expected:
        state.next_withdrawal_index = int(expected[-1].index) + 1
    if len(expected) == spec.preset.MAX_WITHDRAWALS_PER_PAYLOAD:
        state.next_withdrawal_validator_index = (
            int(expected[-1].validator_index) + 1
        ) % n
    else:
        state.next_withdrawal_validator_index = (
            int(state.next_withdrawal_validator_index)
            + spec.preset.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
        ) % n


def process_bls_to_execution_change(spec, state, signed_change, verify: bool):
    """Capella BLS->execution credential rotation. Signature semantics
    (GENESIS fork domain) live in the shared set constructor
    (signature_sets.bls_to_execution_change_signature_set)."""
    import hashlib as _hashlib

    msg = signed_change.message
    idx = int(msg.validator_index)
    if idx >= len(state.validators):
        raise BlockProcessingError("bls change: unknown validator")
    v = state.validators[idx]
    creds = bytes(v.withdrawal_credentials)
    if creds[:1] != b"\x00":
        raise BlockProcessingError("bls change: not a BLS credential")
    if creds[1:] != _hashlib.sha256(bytes(msg.from_bls_pubkey)).digest()[1:]:
        raise BlockProcessingError("bls change: pubkey does not match credential")
    if verify:
        s = sigs.bls_to_execution_change_signature_set(spec, state, signed_change)
        if not bls.verify_signature_sets([s]):
            raise BlockProcessingError("bls change: invalid signature")
    v.withdrawal_credentials = (
        b"\x01" + b"\x00" * 11 + bytes(msg.to_execution_address)
    )


def process_proposer_slashing(spec, state, slashing, ctxt, verify: bool):
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: slots differ")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: proposers differ")
    if h1 == h2:
        raise BlockProcessingError("proposer slashing: identical headers")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(proposer, get_current_epoch(spec, state)):
        raise BlockProcessingError("proposer not slashable")
    if verify:
        for s in sigs.proposer_slashing_signature_sets(spec, state, slashing):
            if not bls.verify_signature_sets([s]):
                raise BlockProcessingError("proposer slashing: bad signature")
    slash_validator(spec, state, h1.proposer_index)


def is_valid_indexed_attestation(spec, state, indexed, verify: bool) -> bool:
    idx = list(indexed.attesting_indices)
    if not idx or idx != sorted(set(int(i) for i in idx)):
        return False
    if any(int(i) >= len(state.validators) for i in idx):
        return False
    if verify:
        s = sigs.indexed_attestation_signature_set(spec, state, indexed)
        return bls.verify_signature_sets([s])
    return True


def process_attester_slashing(spec, state, slashing, verify: bool):
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not is_slashable_attestation_data(a1.data, a2.data):
        raise BlockProcessingError("attestations not slashable")
    for a in (a1, a2):
        if not is_valid_indexed_attestation(spec, state, a, verify):
            raise BlockProcessingError("invalid indexed attestation")
    slashed_any = False
    cur = get_current_epoch(spec, state)
    common = sorted(
        set(int(i) for i in a1.attesting_indices)
        & set(int(i) for i in a2.attesting_indices)
    )
    for index in common:
        if is_slashable_validator(state.validators[index], cur):
            slash_validator(spec, state, index)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("no validators slashed")


def _validate_attestation_common(spec, state, data):
    if data.target.epoch not in (
        get_previous_epoch(spec, state), get_current_epoch(spec, state)
    ):
        raise BlockProcessingError("attestation target epoch out of range")
    if data.target.epoch != spec.compute_epoch_at_slot(data.slot):
        raise BlockProcessingError("attestation target/slot mismatch")
    if data.slot + spec.min_attestation_inclusion_delay > state.slot:
        raise BlockProcessingError("attestation outside inclusion window")
    # EIP-7045 (deneb) removed the one-epoch inclusion upper bound; the
    # target-epoch range check above is the only recency constraint since
    if not fork_at_least(getattr(state, "fork_name", "phase0"), "deneb"):
        if state.slot > data.slot + spec.preset.SLOTS_PER_EPOCH:
            raise BlockProcessingError("attestation outside inclusion window")
    if data.index >= get_committee_count_per_slot(spec, state, data.target.epoch):
        # electra attestations carry index 0 and pass trivially; the real
        # committee bound is checked against committee_bits by the caller
        raise BlockProcessingError("committee index out of range")


def process_attestation(spec, state, attestation, att_index, ctxt, verify: bool):
    data = attestation.data
    _validate_attestation_common(spec, state, data)
    if hasattr(attestation, "committee_bits"):
        # EIP-7549: data.index must be zero; committee structure rides in
        # committee_bits, aggregation bits span the slot's committees
        from .electra import get_committee_indices

        if int(data.index) != 0:
            raise BlockProcessingError("electra attestation: nonzero data.index")
        committee_indices = get_committee_indices(attestation.committee_bits)
        per_slot = get_committee_count_per_slot(spec, state, data.target.epoch)
        if not committee_indices:
            raise BlockProcessingError("electra attestation: no committee bits")
        if any(ci >= per_slot for ci in committee_indices):
            raise BlockProcessingError("electra attestation: committee oob")
        bits = np.asarray(attestation.aggregation_bits, dtype=bool)
        total = sum(
            get_beacon_committee(spec, state, data.slot, ci).size
            for ci in committee_indices
        )
        if bits.size != total:
            raise BlockProcessingError(
                "electra attestation: aggregation bits != committee sizes"
            )
    else:
        committee = get_beacon_committee(spec, state, data.slot, data.index)
        bits = np.asarray(attestation.aggregation_bits, dtype=bool)
        if bits.size != committee.size:
            raise BlockProcessingError("aggregation bits != committee size")

    indexed = ctxt.indexed_attestations.get(att_index)
    if indexed is None:
        indexed = get_indexed_attestation(spec, state, attestation)
    if not is_valid_indexed_attestation(spec, state, indexed, verify):
        raise BlockProcessingError("invalid attestation")

    if getattr(state, "fork_name", "phase0") == "phase0":
        _process_attestation_phase0(spec, state, attestation, data, ctxt)
    else:
        _process_attestation_altair(spec, state, data, indexed, ctxt)


def _process_attestation_phase0(spec, state, attestation, data, ctxt):
    from ..types.containers import for_preset

    ns = for_preset(spec.preset.name)
    pending = ns.PendingAttestation(
        aggregation_bits=attestation.aggregation_bits,
        data=data,
        inclusion_delay=state.slot - data.slot,
        proposer_index=ctxt.get_proposer_index(spec, state),
    )
    if data.target.epoch == get_current_epoch(spec, state):
        if data.source != state.current_justified_checkpoint:
            raise BlockProcessingError("attestation source != current justified")
        state.current_epoch_attestations = list(
            state.current_epoch_attestations
        ) + [pending]
    else:
        if data.source != state.previous_justified_checkpoint:
            raise BlockProcessingError("attestation source != previous justified")
        state.previous_epoch_attestations = list(
            state.previous_epoch_attestations
        ) + [pending]


def get_attestation_participation_flag_indices(spec, state, data, inclusion_delay):
    justified = (
        state.current_justified_checkpoint
        if data.target.epoch == get_current_epoch(spec, state)
        else state.previous_justified_checkpoint
    )
    is_matching_source = data.source == justified
    if not is_matching_source:
        raise BlockProcessingError("attestation source mismatch")
    is_matching_target = is_matching_source and bytes(data.target.root) == bytes(
        get_block_root(spec, state, data.target.epoch)
    )
    is_matching_head = is_matching_target and bytes(
        data.beacon_block_root
    ) == bytes(get_block_root_at_slot(spec, state, data.slot))
    flags = []
    sqrt_epoch = _integer_sqrt(spec.preset.SLOTS_PER_EPOCH)
    if is_matching_source and inclusion_delay <= sqrt_epoch:
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= spec.preset.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def _integer_sqrt(n: int) -> int:
    import math

    return math.isqrt(n)


def _process_attestation_altair(spec, state, data, indexed, ctxt):
    inclusion_delay = state.slot - data.slot
    flag_indices = get_attestation_participation_flag_indices(
        spec, state, data, inclusion_delay
    )
    epoch_participation = (
        state.current_epoch_participation
        if data.target.epoch == get_current_epoch(spec, state)
        else state.previous_epoch_participation
    )
    if not isinstance(epoch_participation, np.ndarray):
        epoch_participation = np.asarray(epoch_participation, dtype=np.uint8)
    total_base = get_base_reward_per_increment(spec, state)
    proposer_reward_numerator = 0
    for index in indexed.attesting_indices:
        index = int(index)
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            has = bool(epoch_participation[index] & (1 << flag_index))
            if flag_index in flag_indices and not has:
                epoch_participation[index] |= np.uint8(1 << flag_index)
                proposer_reward_numerator += (
                    get_base_reward_altair(spec, state, index, total_base) * weight
                )
    if data.target.epoch == get_current_epoch(spec, state):
        state.current_epoch_participation = epoch_participation
    else:
        state.previous_epoch_participation = epoch_participation
    denom = (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    increase_balance(
        state, ctxt.get_proposer_index(spec, state),
        proposer_reward_numerator // denom,
    )


def get_base_reward_per_increment(spec, state) -> int:
    return (
        spec.effective_balance_increment
        * spec.base_reward_factor
        // _integer_sqrt(get_total_active_balance(spec, state))
    )


def get_base_reward_altair(spec, state, index: int, per_increment: int) -> int:
    increments = (
        state.validators[index].effective_balance
        // spec.effective_balance_increment
    )
    return increments * per_increment


def is_valid_merkle_branch(leaf, branch, depth, index, root) -> bool:
    value = bytes(leaf)
    for i in range(depth):
        b = bytes(branch[i])
        if (index >> i) & 1:
            value = sha256(b + value)
        else:
            value = sha256(value + b)
    return value == bytes(root)


def process_deposit(spec, state, deposit, ctxt: ConsensusContext | None = None):
    from ..types.containers import DepositData

    if not is_valid_merkle_branch(
        DepositData.hash_tree_root(deposit.data),
        deposit.proof,
        32 + 1,  # DEPOSIT_CONTRACT_TREE_DEPTH + 1 (mix-in of count)
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise BlockProcessingError("invalid deposit merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(spec, state, deposit.data, ctxt=ctxt)


def apply_deposit(spec, state, data, check_signature: bool = True, ctxt=None):
    pk = bytes(data.pubkey)
    index = (ctxt or ConsensusContext()).lookup_pubkey_index(state, pk)
    if fork_at_least(getattr(state, "fork_name", "phase0"), "electra"):
        # EIP-7251: every deposit flows through the pending queue; new keys
        # join the registry immediately with zero balance
        from ..types.containers import for_preset

        ns = for_preset(spec.preset.name)
        if index is None:
            if check_signature and not sigs.deposit_signature_is_valid(spec, data):
                return
            add_validator_to_registry(spec, state, data, amount_override=0)
        state.pending_deposits = list(state.pending_deposits) + [
            ns.PendingDeposit(
                pubkey=pk,
                withdrawal_credentials=bytes(data.withdrawal_credentials),
                amount=int(data.amount),
                signature=bytes(data.signature),
                slot=0,  # GENESIS_SLOT: eth1-bridge deposits are pre-finalized
            )
        ]
        return
    if index is None:
        if check_signature and not sigs.deposit_signature_is_valid(spec, data):
            return  # invalid deposit signature: skipped, not fatal
        add_validator_to_registry(spec, state, data)
    else:
        increase_balance(state, index, data.amount)


def add_validator_to_registry(spec, state, data, amount_override=None):
    from ..types.containers import Validator

    amount = int(data.amount) if amount_override is None else amount_override
    if fork_at_least(getattr(state, "fork_name", "phase0"), "electra"):
        from .electra import COMPOUNDING_WITHDRAWAL_PREFIX

        max_eff = (
            spec.max_effective_balance_electra
            if bytes(data.withdrawal_credentials)[:1] == COMPOUNDING_WITHDRAWAL_PREFIX
            else spec.min_activation_balance
        )
    else:
        max_eff = spec.max_effective_balance
    effective = min(
        amount - amount % spec.effective_balance_increment, max_eff
    )
    state.validators = list(state.validators) + [
        Validator(
            pubkey=data.pubkey,
            withdrawal_credentials=data.withdrawal_credentials,
            effective_balance=effective,
            slashed=False,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
    ]
    from ..epoch_engine import mark_registry_delta

    mark_registry_delta(state, len(state.validators) - 1)
    state.balances = np.concatenate(
        [np.asarray(state.balances, dtype=np.uint64), [np.uint64(amount)]]
    )
    if getattr(state, "fork_name", "phase0") != "phase0":
        state.previous_epoch_participation = np.concatenate(
            [np.asarray(state.previous_epoch_participation, np.uint8), [0]]
        )
        state.current_epoch_participation = np.concatenate(
            [np.asarray(state.current_epoch_participation, np.uint8), [0]]
        )
        state.inactivity_scores = np.concatenate(
            [np.asarray(state.inactivity_scores, np.uint64), [0]]
        )


def process_exit(spec, state, signed_exit, verify: bool):
    exit_msg = signed_exit.message
    v = state.validators[exit_msg.validator_index]
    cur = get_current_epoch(spec, state)
    if not is_active_validator(v, cur):
        raise BlockProcessingError("exit: validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("exit: already exiting")
    if cur < exit_msg.epoch:
        raise BlockProcessingError("exit: not yet valid")
    if cur < v.activation_epoch + spec.shard_committee_period:
        raise BlockProcessingError("exit: too young")
    if fork_at_least(getattr(state, "fork_name", "phase0"), "electra"):
        from .electra import get_pending_balance_to_withdraw

        if get_pending_balance_to_withdraw(state, int(exit_msg.validator_index)):
            raise BlockProcessingError("exit: pending partial withdrawals")
    if verify:
        s = sigs.exit_signature_set(spec, state, signed_exit)
        if not bls.verify_signature_sets([s]):
            raise BlockProcessingError("exit: bad signature")
    initiate_validator_exit(spec, state, exit_msg.validator_index)


# -------------------------------------------------------------------------------
# Sync aggregate (altair)
# -------------------------------------------------------------------------------


def process_sync_aggregate(spec, state, block_slot, agg, verify: bool, ctxt=None):
    if verify:
        s = sync_aggregate_signature_set(spec, state, block_slot, agg)
        if s is not None and not bls.verify_signature_sets([s]):
            raise BlockProcessingError("invalid sync aggregate signature")
    total_base = get_base_reward_per_increment(spec, state)
    total_active_increments = (
        get_total_active_balance(spec, state) // spec.effective_balance_increment
    )
    max_total_reward = (
        total_base * total_active_increments * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
    )
    participant_reward = max_total_reward // spec.preset.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )
    proposer_index = get_beacon_proposer_index(spec, state)
    pubkeys = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    lookup = ctxt or ConsensusContext()
    if lookup.get_pubkey_index is None:
        # one O(n) build amortized over the committee, not per deposit
        table = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        resolve = table.__getitem__
    else:
        resolve = lambda pk: lookup.lookup_pubkey_index(state, pk)
    bits = np.asarray(agg.sync_committee_bits, dtype=bool)
    for i, bit in enumerate(bits):
        participant_index = resolve(pubkeys[i])
        if bit:
            increase_balance(state, participant_index, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, participant_index, participant_reward)
