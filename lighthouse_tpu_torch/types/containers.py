"""Consensus containers (phase0 + altair core; later forks extend here).

Per-preset container classes are generated once by ``for_preset`` — the Python
analog of the reference's ``EthSpec``-monomorphized types
(``consensus/types/src/*.rs``; fork variants via superstruct become subclass
chains here, e.g. ``BeaconStateAltair(BeaconStatePhase0)`` with extended
FIELDS). Field names and SSZ shapes match the consensus spec exactly so EF
ssz_static vectors apply unchanged.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from ..ssz import (
    Bitlist, Bitvector, ByteList, ByteVector, Container, List, Vector,
    boolean, uint8, uint64, uint256,
)
from .spec import Preset, PRESETS

# -- aliases (fixed across presets) ----------------------------------------------

Root = ByteVector(32)
Hash32 = ByteVector(32)
Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
BLSPubkey = ByteVector(48)
BLSSignature = ByteVector(96)
KZGCommitment = ByteVector(48)

Slot = uint64
Epoch = uint64
Gwei = uint64
ValidatorIndex = uint64
CommitteeIndex = uint64

DEPOSIT_CONTRACT_TREE_DEPTH = 32
JUSTIFICATION_BITS_LENGTH = 4


class Fork(Container):
    FIELDS = [
        ("previous_version", Bytes4),
        ("current_version", Bytes4),
        ("epoch", Epoch),
    ]


class ForkData(Container):
    FIELDS = [("current_version", Bytes4), ("genesis_validators_root", Root)]


class Checkpoint(Container):
    FIELDS = [("epoch", Epoch), ("root", Root)]


class SigningData(Container):
    FIELDS = [("object_root", Root), ("domain", ByteVector(32))]


class Validator(Container):
    FIELDS = [
        ("pubkey", BLSPubkey),
        ("withdrawal_credentials", ByteVector(32)),
        ("effective_balance", Gwei),
        ("slashed", boolean),
        ("activation_eligibility_epoch", Epoch),
        ("activation_epoch", Epoch),
        ("exit_epoch", Epoch),
        ("withdrawable_epoch", Epoch),
    ]


class AttestationData(Container):
    FIELDS = [
        ("slot", Slot),
        ("index", CommitteeIndex),
        ("beacon_block_root", Root),
        ("source", Checkpoint),
        ("target", Checkpoint),
    ]


class Eth1Data(Container):
    FIELDS = [
        ("deposit_root", Root),
        ("deposit_count", uint64),
        ("block_hash", Hash32),
    ]


class DepositMessage(Container):
    FIELDS = [
        ("pubkey", BLSPubkey),
        ("withdrawal_credentials", ByteVector(32)),
        ("amount", Gwei),
    ]


class DepositData(Container):
    FIELDS = [
        ("pubkey", BLSPubkey),
        ("withdrawal_credentials", ByteVector(32)),
        ("amount", Gwei),
        ("signature", BLSSignature),
    ]


class Withdrawal(Container):
    FIELDS = [
        ("index", uint64),
        ("validator_index", ValidatorIndex),
        ("address", Bytes20),
        ("amount", Gwei),
    ]


class BLSToExecutionChange(Container):
    FIELDS = [
        ("validator_index", ValidatorIndex),
        ("from_bls_pubkey", BLSPubkey),
        ("to_execution_address", Bytes20),
    ]


class SignedBLSToExecutionChange(Container):
    FIELDS = [
        ("message", BLSToExecutionChange),
        ("signature", BLSSignature),
    ]


class HistoricalSummary(Container):
    """Capella replacement for HistoricalBatch accumulation
    (consensus/types/src/historical_summary.rs)."""

    FIELDS = [
        ("block_summary_root", Root),
        ("state_summary_root", Root),
    ]


class BeaconBlockHeader(Container):
    FIELDS = [
        ("slot", Slot),
        ("proposer_index", ValidatorIndex),
        ("parent_root", Root),
        ("state_root", Root),
        ("body_root", Root),
    ]


class SignedBeaconBlockHeader(Container):
    FIELDS = [("message", BeaconBlockHeader), ("signature", BLSSignature)]


class ProposerSlashing(Container):
    FIELDS = [
        ("signed_header_1", SignedBeaconBlockHeader),
        ("signed_header_2", SignedBeaconBlockHeader),
    ]


class Deposit(Container):
    FIELDS = [
        ("proof", Vector(ByteVector(32), DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
        ("data", DepositData),
    ]


class VoluntaryExit(Container):
    FIELDS = [("epoch", Epoch), ("validator_index", ValidatorIndex)]


class SignedVoluntaryExit(Container):
    FIELDS = [("message", VoluntaryExit), ("signature", BLSSignature)]


# -- preset-parameterized containers ----------------------------------------------


class _BeaconStateBase(Container):
    """The base of every fork's ``BeaconState``: a copy also carries the
    state's per-epoch caches (``_committee_caches``, kept by
    ``state_transition.beacon_state_util``). The copy is at the original's
    epoch, so they hold for it until its own epoch changes."""

    def copy(self):
        new = super().copy()
        caches = self.__dict__.get("_committee_caches")
        if caches:
            new.__dict__["_committee_caches"] = dict(caches)
        return new


@functools.lru_cache(maxsize=None)
def for_preset(preset_name: str) -> SimpleNamespace:
    p: Preset = PRESETS[preset_name]

    class IndexedAttestation(Container):
        FIELDS = [
            ("attesting_indices", List(uint64, p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData),
            ("signature", BLSSignature),
        ]

    class Attestation(Container):
        FIELDS = [
            ("aggregation_bits", Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData),
            ("signature", BLSSignature),
        ]

    class PendingAttestation(Container):
        FIELDS = [
            ("aggregation_bits", Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", AttestationData),
            ("inclusion_delay", Slot),
            ("proposer_index", ValidatorIndex),
        ]

    class AggregateAndProof(Container):
        """Gossip aggregate envelope (consensus/types/src/aggregate_and_proof.rs)."""

        FIELDS = [
            ("aggregator_index", ValidatorIndex),
            ("aggregate", Attestation),
            ("selection_proof", BLSSignature),
        ]

    class SignedAggregateAndProof(Container):
        FIELDS = [
            ("message", AggregateAndProof),
            ("signature", BLSSignature),
        ]

    class AttesterSlashing(Container):
        FIELDS = [
            ("attestation_1", IndexedAttestation),
            ("attestation_2", IndexedAttestation),
        ]

    class HistoricalBatch(Container):
        FIELDS = [
            ("block_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
        ]

    class SyncCommittee(Container):
        FIELDS = [
            ("pubkeys", Vector(BLSPubkey, p.SYNC_COMMITTEE_SIZE)),
            ("aggregate_pubkey", BLSPubkey),
        ]

    class SyncAggregate(Container):
        FIELDS = [
            ("sync_committee_bits", Bitvector(p.SYNC_COMMITTEE_SIZE)),
            ("sync_committee_signature", BLSSignature),
        ]

    class SyncCommitteeMessage(Container):
        FIELDS = [
            ("slot", uint64),
            ("beacon_block_root", Root),
            ("validator_index", uint64),
            ("signature", BLSSignature),
        ]

    class SyncCommitteeContribution(Container):
        FIELDS = [
            ("slot", uint64),
            ("beacon_block_root", Root),
            ("subcommittee_index", uint64),
            ("aggregation_bits", Bitvector(p.SYNC_COMMITTEE_SIZE // 4)),
            ("signature", BLSSignature),
        ]

    class SyncAggregatorSelectionData(Container):
        FIELDS = [
            ("slot", uint64),
            ("subcommittee_index", uint64),
        ]

    class ContributionAndProof(Container):
        FIELDS = [
            ("aggregator_index", uint64),
            ("contribution", SyncCommitteeContribution),
            ("selection_proof", BLSSignature),
        ]

    class SignedContributionAndProof(Container):
        FIELDS = [
            ("message", ContributionAndProof),
            ("signature", BLSSignature),
        ]

    class BeaconBlockBody(Container):
        FIELDS = [
            ("randao_reveal", BLSSignature),
            ("eth1_data", Eth1Data),
            ("graffiti", ByteVector(32)),
            ("proposer_slashings", List(ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", List(AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)),
            ("attestations", List(Attestation, p.MAX_ATTESTATIONS)),
            ("deposits", List(Deposit, p.MAX_DEPOSITS)),
            ("voluntary_exits", List(SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
        ]

    class BeaconBlock(Container):
        FIELDS = [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBody),
        ]

    class SignedBeaconBlock(Container):
        FIELDS = [("message", BeaconBlock), ("signature", BLSSignature)]

    class BeaconState(_BeaconStateBase):
        FIELDS = [
            ("genesis_time", uint64),
            ("genesis_validators_root", Root),
            ("slot", Slot),
            ("fork", Fork),
            ("latest_block_header", BeaconBlockHeader),
            ("block_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Root, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("historical_roots", List(Root, p.HISTORICAL_ROOTS_LIMIT)),
            ("eth1_data", Eth1Data),
            ("eth1_data_votes", List(Eth1Data, p.slots_per_eth1_voting_period)),
            ("eth1_deposit_index", uint64),
            ("validators", List(Validator, p.VALIDATOR_REGISTRY_LIMIT)),
            ("balances", List(Gwei, p.VALIDATOR_REGISTRY_LIMIT)),
            ("randao_mixes", Vector(Root, p.EPOCHS_PER_HISTORICAL_VECTOR)),
            ("slashings", Vector(Gwei, p.EPOCHS_PER_SLASHINGS_VECTOR)),
            ("previous_epoch_attestations",
             List(PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)),
            ("current_epoch_attestations",
             List(PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)),
            ("justification_bits", Bitvector(JUSTIFICATION_BITS_LENGTH)),
            ("previous_justified_checkpoint", Checkpoint),
            ("current_justified_checkpoint", Checkpoint),
            ("finalized_checkpoint", Checkpoint),
        ]

        fork_name = "phase0"

    # -- altair variants -----------------------------------------------------

    class BeaconBlockBodyAltair(Container):
        FIELDS = BeaconBlockBody.FIELDS + [("sync_aggregate", SyncAggregate)]

    class BeaconBlockAltair(Container):
        FIELDS = [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBodyAltair),
        ]

    class SignedBeaconBlockAltair(Container):
        FIELDS = [("message", BeaconBlockAltair), ("signature", BLSSignature)]

    class BeaconStateAltair(_BeaconStateBase):
        FIELDS = [
            f for f in BeaconState.FIELDS
            if f[0] not in ("previous_epoch_attestations", "current_epoch_attestations")
        ]
        # splice participation in place of pending attestations, append the rest
        _idx = [n for n, _ in FIELDS].index("slashings") + 1
        FIELDS = (
            FIELDS[:_idx]
            + [
                ("previous_epoch_participation",
                 List(uint8, p.VALIDATOR_REGISTRY_LIMIT)),
                ("current_epoch_participation",
                 List(uint8, p.VALIDATOR_REGISTRY_LIMIT)),
            ]
            + FIELDS[_idx:]
            + [
                ("inactivity_scores", List(uint64, p.VALIDATOR_REGISTRY_LIMIT)),
                ("current_sync_committee", SyncCommittee),
                ("next_sync_committee", SyncCommittee),
            ]
        )
        fork_name = "altair"

    # -- bellatrix / capella variants (execution payloads) -------------------

    Transaction = ByteList(p.MAX_BYTES_PER_TRANSACTION)

    _payload_common = [
        ("parent_hash", Hash32),
        ("fee_recipient", Bytes20),
        ("state_root", Root),
        ("receipts_root", Root),
        ("logs_bloom", ByteVector(p.BYTES_PER_LOGS_BLOOM)),
        ("prev_randao", Hash32),
        ("block_number", uint64),
        ("gas_limit", uint64),
        ("gas_used", uint64),
        ("timestamp", uint64),
        ("extra_data", ByteList(p.MAX_EXTRA_DATA_BYTES)),
        ("base_fee_per_gas", uint256),
        ("block_hash", Hash32),
    ]

    class ExecutionPayloadBellatrix(Container):
        FIELDS = _payload_common + [
            ("transactions", List(Transaction, p.MAX_TRANSACTIONS_PER_PAYLOAD)),
        ]

    class ExecutionPayloadHeaderBellatrix(Container):
        FIELDS = _payload_common + [("transactions_root", Root)]

    class ExecutionPayloadCapella(Container):
        FIELDS = ExecutionPayloadBellatrix.FIELDS + [
            ("withdrawals", List(Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD)),
        ]

    class ExecutionPayloadHeaderCapella(Container):
        FIELDS = ExecutionPayloadHeaderBellatrix.FIELDS + [
            ("withdrawals_root", Root),
        ]

    class BeaconBlockBodyBellatrix(Container):
        FIELDS = BeaconBlockBodyAltair.FIELDS + [
            ("execution_payload", ExecutionPayloadBellatrix),
        ]

    class BeaconBlockBellatrix(Container):
        FIELDS = [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBodyBellatrix),
        ]

    class SignedBeaconBlockBellatrix(Container):
        FIELDS = [("message", BeaconBlockBellatrix), ("signature", BLSSignature)]

    class BeaconBlockBodyCapella(Container):
        FIELDS = [
            (n, t) if n != "execution_payload" else (n, ExecutionPayloadCapella)
            for n, t in BeaconBlockBodyBellatrix.FIELDS
        ] + [
            (
                "bls_to_execution_changes",
                List(SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES),
            ),
        ]

    class BeaconBlockCapella(Container):
        FIELDS = [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBodyCapella),
        ]

    class SignedBeaconBlockCapella(Container):
        FIELDS = [("message", BeaconBlockCapella), ("signature", BLSSignature)]

    class BeaconStateBellatrix(_BeaconStateBase):
        FIELDS = BeaconStateAltair.FIELDS + [
            ("latest_execution_payload_header", ExecutionPayloadHeaderBellatrix),
        ]
        fork_name = "bellatrix"

    class BeaconStateCapella(_BeaconStateBase):
        FIELDS = [
            (n, t)
            if n != "latest_execution_payload_header"
            else (n, ExecutionPayloadHeaderCapella)
            for n, t in BeaconStateBellatrix.FIELDS
        ] + [
            ("next_withdrawal_index", uint64),
            ("next_withdrawal_validator_index", ValidatorIndex),
            ("historical_summaries",
             List(HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT)),
        ]
        fork_name = "capella"

    # -- deneb variants (blobs; consensus/types/src/blob_sidecar.rs) ---------

    class ExecutionPayloadDeneb(Container):
        FIELDS = ExecutionPayloadCapella.FIELDS + [
            ("blob_gas_used", uint64),
            ("excess_blob_gas", uint64),
        ]

    class ExecutionPayloadHeaderDeneb(Container):
        FIELDS = ExecutionPayloadHeaderCapella.FIELDS + [
            ("blob_gas_used", uint64),
            ("excess_blob_gas", uint64),
        ]

    class BeaconBlockBodyDeneb(Container):
        FIELDS = [
            (n, t) if n != "execution_payload" else (n, ExecutionPayloadDeneb)
            for n, t in BeaconBlockBodyCapella.FIELDS
        ] + [
            (
                "blob_kzg_commitments",
                List(KZGCommitment, p.MAX_BLOB_COMMITMENTS_PER_BLOCK),
            ),
        ]

    class BeaconBlockDeneb(Container):
        FIELDS = [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBodyDeneb),
        ]

    class SignedBeaconBlockDeneb(Container):
        FIELDS = [("message", BeaconBlockDeneb), ("signature", BLSSignature)]

    class BeaconStateDeneb(_BeaconStateBase):
        FIELDS = [
            (n, t)
            if n != "latest_execution_payload_header"
            else (n, ExecutionPayloadHeaderDeneb)
            for n, t in BeaconStateCapella.FIELDS
        ]
        fork_name = "deneb"

    Blob = ByteVector(32 * p.FIELD_ELEMENTS_PER_BLOB)

    # inclusion-proof depth: commitments-list subtree + length mix-in +
    # body-fields level (17 on mainnet, 9 on minimal)
    _commitments_depth = (p.MAX_BLOB_COMMITMENTS_PER_BLOCK - 1).bit_length()
    _body_depth = (len(BeaconBlockBodyDeneb.FIELDS) - 1).bit_length()
    KZG_COMMITMENT_INCLUSION_PROOF_DEPTH = _commitments_depth + 1 + _body_depth

    class BlobSidecar(Container):
        """Gossiped blob container (consensus/types/src/blob_sidecar.rs)."""

        FIELDS = [
            ("index", uint64),
            ("blob", Blob),
            ("kzg_commitment", KZGCommitment),
            ("kzg_proof", ByteVector(48)),
            ("signed_block_header", SignedBeaconBlockHeader),
            (
                "kzg_commitment_inclusion_proof",
                Vector(Root, KZG_COMMITMENT_INCLUSION_PROOF_DEPTH),
            ),
        ]

    class BlobIdentifier(Container):
        FIELDS = [("block_root", Root), ("index", uint64)]

    # -- PeerDAS / fulu groundwork (EIP-7594) --------------------------------
    # consensus/types/src/data_column_sidecar.rs: columns slice the erasure-
    # extended blob matrix the other way — one cell per blob per column.

    NUMBER_OF_COLUMNS = 128          # spec CELLS_PER_EXT_BLOB geometry
    BYTES_PER_CELL = 2048            # 64 field elements x 32 bytes
    Cell = ByteVector(BYTES_PER_CELL)
    # the proof covers the WHOLE blob_kzg_commitments list root under the
    # body root (one body-depth branch), unlike the per-commitment blob path
    KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH = _body_depth

    class DataColumnSidecar(Container):
        FIELDS = [
            ("index", uint64),
            ("column", List(Cell, p.MAX_BLOB_COMMITMENTS_PER_BLOCK)),
            (
                "kzg_commitments",
                List(KZGCommitment, p.MAX_BLOB_COMMITMENTS_PER_BLOCK),
            ),
            (
                "kzg_proofs",
                List(ByteVector(48), p.MAX_BLOB_COMMITMENTS_PER_BLOCK),
            ),
            ("signed_block_header", SignedBeaconBlockHeader),
            (
                "kzg_commitments_inclusion_proof",
                Vector(Root, KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH),
            ),
        ]

    class DataColumnIdentifier(Container):
        FIELDS = [("block_root", Root), ("index", uint64)]

    # -- electra variants (EIP-6110/7002/7251/7549) --------------------------

    class DepositRequest(Container):
        FIELDS = [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", ByteVector(32)),
            ("amount", Gwei),
            ("signature", BLSSignature),
            ("index", uint64),
        ]

    class WithdrawalRequest(Container):
        FIELDS = [
            ("source_address", Bytes20),
            ("validator_pubkey", BLSPubkey),
            ("amount", Gwei),
        ]

    class ConsolidationRequest(Container):
        FIELDS = [
            ("source_address", Bytes20),
            ("source_pubkey", BLSPubkey),
            ("target_pubkey", BLSPubkey),
        ]

    class ExecutionRequests(Container):
        FIELDS = [
            ("deposits", List(DepositRequest, p.MAX_DEPOSIT_REQUESTS_PER_PAYLOAD)),
            ("withdrawals",
             List(WithdrawalRequest, p.MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD)),
            ("consolidations",
             List(ConsolidationRequest, p.MAX_CONSOLIDATION_REQUESTS_PER_PAYLOAD)),
        ]

    class PendingDeposit(Container):
        FIELDS = [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", ByteVector(32)),
            ("amount", Gwei),
            ("signature", BLSSignature),
            ("slot", Slot),
        ]

    class PendingPartialWithdrawal(Container):
        FIELDS = [
            ("validator_index", ValidatorIndex),
            ("amount", Gwei),
            ("withdrawable_epoch", Epoch),
        ]

    class PendingConsolidation(Container):
        FIELDS = [("source_index", ValidatorIndex), ("target_index", ValidatorIndex)]

    _electra_agg_limit = p.MAX_VALIDATORS_PER_COMMITTEE * p.MAX_COMMITTEES_PER_SLOT

    class AttestationElectra(Container):
        """EIP-7549: committee index moves out of AttestationData into
        committee_bits; aggregation bits span the whole slot."""

        FIELDS = [
            ("aggregation_bits", Bitlist(_electra_agg_limit)),
            ("data", AttestationData),
            ("signature", BLSSignature),
            ("committee_bits", Bitvector(p.MAX_COMMITTEES_PER_SLOT)),
        ]

    class IndexedAttestationElectra(Container):
        FIELDS = [
            ("attesting_indices", List(uint64, _electra_agg_limit)),
            ("data", AttestationData),
            ("signature", BLSSignature),
        ]

    class AttesterSlashingElectra(Container):
        FIELDS = [
            ("attestation_1", IndexedAttestationElectra),
            ("attestation_2", IndexedAttestationElectra),
        ]

    class SingleAttestation(Container):
        """Unaggregated electra gossip attestation."""

        FIELDS = [
            ("committee_index", CommitteeIndex),
            ("attester_index", ValidatorIndex),
            ("data", AttestationData),
            ("signature", BLSSignature),
        ]

    class AggregateAndProofElectra(Container):
        FIELDS = [
            ("aggregator_index", ValidatorIndex),
            ("aggregate", AttestationElectra),
            ("selection_proof", BLSSignature),
        ]

    class SignedAggregateAndProofElectra(Container):
        FIELDS = [
            ("message", AggregateAndProofElectra),
            ("signature", BLSSignature),
        ]

    class BeaconBlockBodyElectra(Container):
        FIELDS = [
            (n,
             List(ProposerSlashing, p.MAX_PROPOSER_SLASHINGS) if n == "proposer_slashings"
             else List(AttesterSlashingElectra, p.MAX_ATTESTER_SLASHINGS_ELECTRA) if n == "attester_slashings"
             else List(AttestationElectra, p.MAX_ATTESTATIONS_ELECTRA) if n == "attestations"
             else t)
            for n, t in BeaconBlockBodyDeneb.FIELDS
        ] + [("execution_requests", ExecutionRequests)]

    class BeaconBlockElectra(Container):
        FIELDS = [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", BeaconBlockBodyElectra),
        ]

    class SignedBeaconBlockElectra(Container):
        FIELDS = [("message", BeaconBlockElectra), ("signature", BLSSignature)]

    class BeaconStateElectra(_BeaconStateBase):
        FIELDS = BeaconStateDeneb.FIELDS + [
            ("deposit_requests_start_index", uint64),
            ("deposit_balance_to_consume", Gwei),
            ("exit_balance_to_consume", Gwei),
            ("earliest_exit_epoch", Epoch),
            ("consolidation_balance_to_consume", Gwei),
            ("earliest_consolidation_epoch", Epoch),
            ("pending_deposits", List(PendingDeposit, p.PENDING_DEPOSITS_LIMIT)),
            ("pending_partial_withdrawals",
             List(PendingPartialWithdrawal, p.PENDING_PARTIAL_WITHDRAWALS_LIMIT)),
            ("pending_consolidations",
             List(PendingConsolidation, p.PENDING_CONSOLIDATIONS_LIMIT)),
        ]
        fork_name = "electra"

    ns = SimpleNamespace(
        preset=p,
        IndexedAttestation=IndexedAttestation,
        Attestation=Attestation,
        PendingAttestation=PendingAttestation,
        AttesterSlashing=AttesterSlashing,
        AggregateAndProof=AggregateAndProof,
        SignedAggregateAndProof=SignedAggregateAndProof,
        HistoricalBatch=HistoricalBatch,
        SyncCommittee=SyncCommittee,
        SyncAggregate=SyncAggregate,
        SyncCommitteeMessage=SyncCommitteeMessage,
        SyncAggregatorSelectionData=SyncAggregatorSelectionData,
        SyncCommitteeContribution=SyncCommitteeContribution,
        ContributionAndProof=ContributionAndProof,
        SignedContributionAndProof=SignedContributionAndProof,
        BeaconBlockBody=BeaconBlockBody,
        BeaconBlock=BeaconBlock,
        SignedBeaconBlock=SignedBeaconBlock,
        BeaconState=BeaconState,
        BeaconBlockBodyAltair=BeaconBlockBodyAltair,
        BeaconBlockAltair=BeaconBlockAltair,
        SignedBeaconBlockAltair=SignedBeaconBlockAltair,
        BeaconStateAltair=BeaconStateAltair,
        ExecutionPayloadBellatrix=ExecutionPayloadBellatrix,
        ExecutionPayloadHeaderBellatrix=ExecutionPayloadHeaderBellatrix,
        ExecutionPayloadCapella=ExecutionPayloadCapella,
        ExecutionPayloadHeaderCapella=ExecutionPayloadHeaderCapella,
        BeaconBlockBodyBellatrix=BeaconBlockBodyBellatrix,
        BeaconBlockBellatrix=BeaconBlockBellatrix,
        SignedBeaconBlockBellatrix=SignedBeaconBlockBellatrix,
        BeaconBlockBodyCapella=BeaconBlockBodyCapella,
        BeaconBlockCapella=BeaconBlockCapella,
        SignedBeaconBlockCapella=SignedBeaconBlockCapella,
        BeaconStateBellatrix=BeaconStateBellatrix,
        BeaconStateCapella=BeaconStateCapella,
        ExecutionPayloadDeneb=ExecutionPayloadDeneb,
        ExecutionPayloadHeaderDeneb=ExecutionPayloadHeaderDeneb,
        BeaconBlockBodyDeneb=BeaconBlockBodyDeneb,
        BeaconBlockDeneb=BeaconBlockDeneb,
        SignedBeaconBlockDeneb=SignedBeaconBlockDeneb,
        BeaconStateDeneb=BeaconStateDeneb,
        Blob=Blob,
        BlobSidecar=BlobSidecar,
        BlobIdentifier=BlobIdentifier,
        KZG_COMMITMENT_INCLUSION_PROOF_DEPTH=KZG_COMMITMENT_INCLUSION_PROOF_DEPTH,
        NUMBER_OF_COLUMNS=NUMBER_OF_COLUMNS,
        BYTES_PER_CELL=BYTES_PER_CELL,
        Cell=Cell,
        DataColumnSidecar=DataColumnSidecar,
        DataColumnIdentifier=DataColumnIdentifier,
        KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH=KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH,
        DepositRequest=DepositRequest,
        WithdrawalRequest=WithdrawalRequest,
        ConsolidationRequest=ConsolidationRequest,
        ExecutionRequests=ExecutionRequests,
        PendingDeposit=PendingDeposit,
        PendingPartialWithdrawal=PendingPartialWithdrawal,
        PendingConsolidation=PendingConsolidation,
        AttestationElectra=AttestationElectra,
        IndexedAttestationElectra=IndexedAttestationElectra,
        AttesterSlashingElectra=AttesterSlashingElectra,
        SingleAttestation=SingleAttestation,
        AggregateAndProofElectra=AggregateAndProofElectra,
        SignedAggregateAndProofElectra=SignedAggregateAndProofElectra,
        BeaconBlockBodyElectra=BeaconBlockBodyElectra,
        BeaconBlockElectra=BeaconBlockElectra,
        SignedBeaconBlockElectra=SignedBeaconBlockElectra,
        BeaconStateElectra=BeaconStateElectra,
        # fork-indexed lookup used by generic code
        state_types={
            "phase0": BeaconState,
            "altair": BeaconStateAltair,
            "bellatrix": BeaconStateBellatrix,
            "capella": BeaconStateCapella,
            "deneb": BeaconStateDeneb,
            "electra": BeaconStateElectra,
        },
        block_types={
            "phase0": SignedBeaconBlock,
            "altair": SignedBeaconBlockAltair,
            "bellatrix": SignedBeaconBlockBellatrix,
            "capella": SignedBeaconBlockCapella,
            "deneb": SignedBeaconBlockDeneb,
            "electra": SignedBeaconBlockElectra,
        },
        body_types={
            "phase0": BeaconBlockBody,
            "altair": BeaconBlockBodyAltair,
            "bellatrix": BeaconBlockBodyBellatrix,
            "capella": BeaconBlockBodyCapella,
            "deneb": BeaconBlockBodyDeneb,
            "electra": BeaconBlockBodyElectra,
        },
        payload_types={
            "bellatrix": ExecutionPayloadBellatrix,
            "capella": ExecutionPayloadCapella,
            "deneb": ExecutionPayloadDeneb,
            "electra": ExecutionPayloadDeneb,  # payload unchanged in electra
        },
        payload_header_types={
            "bellatrix": ExecutionPayloadHeaderBellatrix,
            "capella": ExecutionPayloadHeaderCapella,
            "deneb": ExecutionPayloadHeaderDeneb,
            "electra": ExecutionPayloadHeaderDeneb,
        },
        attestation_types={
            "phase0": Attestation, "altair": Attestation,
            "bellatrix": Attestation, "capella": Attestation,
            "deneb": Attestation, "electra": AttestationElectra,
        },
        indexed_attestation_types={
            "phase0": IndexedAttestation, "altair": IndexedAttestation,
            "bellatrix": IndexedAttestation, "capella": IndexedAttestation,
            "deneb": IndexedAttestation, "electra": IndexedAttestationElectra,
        },
        attester_slashing_types={
            "phase0": AttesterSlashing, "altair": AttesterSlashing,
            "bellatrix": AttesterSlashing, "capella": AttesterSlashing,
            "deneb": AttesterSlashing, "electra": AttesterSlashingElectra,
        },
    )
    return ns
