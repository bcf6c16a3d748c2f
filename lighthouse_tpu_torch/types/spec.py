"""Chain configuration: compile-time presets + runtime ChainSpec.

The reference splits configuration between the ``EthSpec`` trait of typenum
constants selected at compile time (``consensus/types/src/eth_spec.rs:53-165``,
``MainnetEthSpec``/``MinimalEthSpec`` at ``:389,453``) and the runtime
``ChainSpec`` (``consensus/types/src/chain_spec.rs``: fork schedule, domains,
preset values that vary per network). Python has no monomorphization, so a
``Preset`` is a frozen dataclass of the same constants and per-preset container
classes are generated once and cached (``types.containers.for_preset``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

FAR_FUTURE_EPOCH = 2**64 - 1

# Fork names in activation order (superstruct variant order in the reference).
FORK_ORDER = ["phase0", "altair", "bellatrix", "capella", "deneb", "electra"]
_FORK_RANK = {f: i for i, f in enumerate(FORK_ORDER)}


def fork_at_least(fork_name: str, target: str) -> bool:
    """True when fork_name is target or any later fork (single source of
    fork-ordering truth for feature gating)."""
    return _FORK_RANK[fork_name] >= _FORK_RANK[target]


def proportional_slashing_multiplier_for(spec, fork_name: str) -> int:
    """The fork's proportional slashing multiplier (process_slashings) —
    shared by the numpy epoch path and the device epoch kernels so a future
    fork's change cannot silently diverge the two."""
    return {
        "phase0": spec.proportional_slashing_multiplier,
        "altair": spec.proportional_slashing_multiplier_altair,
    }.get(fork_name, spec.proportional_slashing_multiplier_bellatrix)


@dataclass(frozen=True)
class Preset:
    """Compile-time constants (eth_spec.rs trait consts)."""

    name: str
    # time
    SLOTS_PER_EPOCH: int
    SECONDS_PER_SLOT: int
    # state sizes
    SLOTS_PER_HISTORICAL_ROOT: int
    EPOCHS_PER_HISTORICAL_VECTOR: int
    EPOCHS_PER_SLASHINGS_VECTOR: int
    HISTORICAL_ROOTS_LIMIT: int
    VALIDATOR_REGISTRY_LIMIT: int
    EPOCHS_PER_ETH1_VOTING_PERIOD: int
    # committees
    MAX_COMMITTEES_PER_SLOT: int
    TARGET_COMMITTEE_SIZE: int
    MAX_VALIDATORS_PER_COMMITTEE: int
    SHUFFLE_ROUND_COUNT: int
    # block body limits
    MAX_PROPOSER_SLASHINGS: int
    MAX_ATTESTER_SLASHINGS: int
    MAX_ATTESTATIONS: int
    MAX_DEPOSITS: int
    MAX_VOLUNTARY_EXITS: int
    # altair
    SYNC_COMMITTEE_SIZE: int
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD: int
    MIN_SYNC_COMMITTEE_PARTICIPANTS: int
    # bellatrix
    MAX_BYTES_PER_TRANSACTION: int
    MAX_TRANSACTIONS_PER_PAYLOAD: int
    BYTES_PER_LOGS_BLOOM: int
    MAX_EXTRA_DATA_BYTES: int
    # capella
    MAX_WITHDRAWALS_PER_PAYLOAD: int
    MAX_BLS_TO_EXECUTION_CHANGES: int
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP: int
    # deneb
    MAX_BLOB_COMMITMENTS_PER_BLOCK: int
    FIELD_ELEMENTS_PER_BLOB: int
    MAX_BLOBS_PER_BLOCK: int
    # electra
    MAX_ATTESTER_SLASHINGS_ELECTRA: int
    MAX_ATTESTATIONS_ELECTRA: int
    MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP: int
    MAX_PENDING_DEPOSITS_PER_EPOCH: int
    MAX_DEPOSIT_REQUESTS_PER_PAYLOAD: int
    MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD: int
    MAX_CONSOLIDATION_REQUESTS_PER_PAYLOAD: int
    PENDING_DEPOSITS_LIMIT: int
    PENDING_PARTIAL_WITHDRAWALS_LIMIT: int
    PENDING_CONSOLIDATIONS_LIMIT: int

    @property
    def slots_per_eth1_voting_period(self) -> int:
        return self.EPOCHS_PER_ETH1_VOTING_PERIOD * self.SLOTS_PER_EPOCH


MAINNET = Preset(
    name="mainnet",
    SLOTS_PER_EPOCH=32,
    SECONDS_PER_SLOT=12,
    SLOTS_PER_HISTORICAL_ROOT=8192,
    EPOCHS_PER_HISTORICAL_VECTOR=65536,
    EPOCHS_PER_SLASHINGS_VECTOR=8192,
    HISTORICAL_ROOTS_LIMIT=2**24,
    VALIDATOR_REGISTRY_LIMIT=2**40,
    EPOCHS_PER_ETH1_VOTING_PERIOD=64,
    MAX_COMMITTEES_PER_SLOT=64,
    TARGET_COMMITTEE_SIZE=128,
    MAX_VALIDATORS_PER_COMMITTEE=2048,
    SHUFFLE_ROUND_COUNT=90,
    MAX_PROPOSER_SLASHINGS=16,
    MAX_ATTESTER_SLASHINGS=2,
    MAX_ATTESTATIONS=128,
    MAX_DEPOSITS=16,
    MAX_VOLUNTARY_EXITS=16,
    SYNC_COMMITTEE_SIZE=512,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=256,
    MIN_SYNC_COMMITTEE_PARTICIPANTS=1,
    MAX_BYTES_PER_TRANSACTION=2**30,
    MAX_TRANSACTIONS_PER_PAYLOAD=2**20,
    BYTES_PER_LOGS_BLOOM=256,
    MAX_EXTRA_DATA_BYTES=32,
    MAX_WITHDRAWALS_PER_PAYLOAD=16,
    MAX_BLS_TO_EXECUTION_CHANGES=16,
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP=16384,
    MAX_BLOB_COMMITMENTS_PER_BLOCK=4096,
    FIELD_ELEMENTS_PER_BLOB=4096,
    MAX_BLOBS_PER_BLOCK=6,
    MAX_ATTESTER_SLASHINGS_ELECTRA=1,
    MAX_ATTESTATIONS_ELECTRA=8,
    MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP=8,
    MAX_PENDING_DEPOSITS_PER_EPOCH=16,
    MAX_DEPOSIT_REQUESTS_PER_PAYLOAD=8192,
    MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD=16,
    MAX_CONSOLIDATION_REQUESTS_PER_PAYLOAD=2,
    PENDING_DEPOSITS_LIMIT=2**27,
    PENDING_PARTIAL_WITHDRAWALS_LIMIT=2**27,
    PENDING_CONSOLIDATIONS_LIMIT=2**18,
)

MINIMAL = replace(
    MAINNET,
    name="minimal",
    SLOTS_PER_EPOCH=8,
    SECONDS_PER_SLOT=6,
    SLOTS_PER_HISTORICAL_ROOT=64,
    EPOCHS_PER_HISTORICAL_VECTOR=64,
    EPOCHS_PER_SLASHINGS_VECTOR=64,
    EPOCHS_PER_ETH1_VOTING_PERIOD=4,
    MAX_COMMITTEES_PER_SLOT=4,
    TARGET_COMMITTEE_SIZE=4,
    SHUFFLE_ROUND_COUNT=10,
    SYNC_COMMITTEE_SIZE=32,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=8,
    MAX_WITHDRAWALS_PER_PAYLOAD=4,
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP=16,
    MAX_BLOB_COMMITMENTS_PER_BLOCK=16,
    FIELD_ELEMENTS_PER_BLOB=4096,
    MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP=2,
)

PRESETS = {"mainnet": MAINNET, "minimal": MINIMAL}


@dataclass
class ChainSpec:
    """Runtime network parameters (chain_spec.rs). Domains are 4-byte
    little-endian type tags; fork schedule maps fork name -> activation epoch
    (FAR_FUTURE_EPOCH = never)."""

    preset: Preset = MAINNET
    config_name: str = "mainnet"

    # deposits / genesis
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 1606824000
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"
    genesis_delay: int = 604800

    # forks: name -> (version, epoch)
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: int = FAR_FUTURE_EPOCH
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: int = FAR_FUTURE_EPOCH
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    capella_fork_epoch: int = FAR_FUTURE_EPOCH
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    deneb_fork_epoch: int = FAR_FUTURE_EPOCH
    electra_fork_version: bytes = b"\x05\x00\x00\x00"
    electra_fork_epoch: int = FAR_FUTURE_EPOCH

    # validator lifecycle
    min_deposit_amount: int = 10**9
    max_effective_balance: int = 32 * 10**9
    max_effective_balance_electra: int = 2048 * 10**9
    effective_balance_increment: int = 10**9
    ejection_balance: int = 16 * 10**9
    min_per_epoch_churn_limit: int = 4
    max_per_epoch_activation_churn_limit: int = 8
    churn_limit_quotient: int = 65536
    min_per_epoch_churn_limit_electra: int = 128 * 10**9
    max_per_epoch_activation_exit_churn_limit: int = 256 * 10**9

    # time windows
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    min_epochs_to_inactivity_penalty: int = 4

    # rewards & penalties (phase0 values; altair variants below)
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1
    # altair
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # bellatrix
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3
    # electra
    min_activation_balance: int = 32 * 10**9
    whistleblower_reward_quotient_electra: int = 4096
    min_slashing_penalty_quotient_electra: int = 4096

    # deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes(20)
    seconds_per_eth1_block: int = 14
    eth1_follow_distance: int = 2048

    # domains (domain type bytes, little-endian u32 tags)
    DOMAIN_BEACON_PROPOSER: bytes = b"\x00\x00\x00\x00"
    DOMAIN_BEACON_ATTESTER: bytes = b"\x01\x00\x00\x00"
    DOMAIN_RANDAO: bytes = b"\x02\x00\x00\x00"
    DOMAIN_DEPOSIT: bytes = b"\x03\x00\x00\x00"
    DOMAIN_VOLUNTARY_EXIT: bytes = b"\x04\x00\x00\x00"
    DOMAIN_SELECTION_PROOF: bytes = b"\x05\x00\x00\x00"
    DOMAIN_AGGREGATE_AND_PROOF: bytes = b"\x06\x00\x00\x00"
    DOMAIN_SYNC_COMMITTEE: bytes = b"\x07\x00\x00\x00"
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF: bytes = b"\x08\x00\x00\x00"
    DOMAIN_CONTRIBUTION_AND_PROOF: bytes = b"\x09\x00\x00\x00"
    DOMAIN_BLS_TO_EXECUTION_CHANGE: bytes = b"\x0a\x00\x00\x00"
    DOMAIN_APPLICATION_MASK: bytes = b"\x00\x00\x00\x01"

    # misc
    proposer_score_boost: int = 40
    attestation_subnet_count: int = 64
    target_aggregators_per_committee: int = 16

    # ----- fork helpers -------------------------------------------------------

    def fork_epoch(self, fork: str) -> int:
        if fork == "phase0":
            return 0
        return getattr(self, f"{fork}_fork_epoch")

    def fork_version(self, fork: str) -> bytes:
        if fork == "phase0":
            return self.genesis_fork_version
        return getattr(self, f"{fork}_fork_version")

    def fork_name_at_epoch(self, epoch: int) -> str:
        current = "phase0"
        for fork in FORK_ORDER[1:]:
            if epoch >= self.fork_epoch(fork):
                current = fork
        return current

    def fork_name_at_slot(self, slot: int) -> str:
        return self.fork_name_at_epoch(slot // self.preset.SLOTS_PER_EPOCH)

    def fork_version_at_epoch(self, epoch: int) -> bytes:
        return self.fork_version(self.fork_name_at_epoch(epoch))

    # ----- preset-derived helpers --------------------------------------------

    def compute_epoch_at_slot(self, slot: int) -> int:
        return slot // self.preset.SLOTS_PER_EPOCH

    def start_slot(self, epoch: int) -> int:
        return epoch * self.preset.SLOTS_PER_EPOCH


def mainnet_spec(**overrides) -> ChainSpec:
    return ChainSpec(preset=MAINNET, config_name="mainnet", **overrides)


def minimal_spec(**overrides) -> ChainSpec:
    """Minimal preset with the standard minimal-config churn override."""
    overrides.setdefault("churn_limit_quotient", 32)
    overrides.setdefault("min_genesis_active_validator_count", 64)
    overrides.setdefault("eth1_follow_distance", 16)
    overrides.setdefault("shard_committee_period", 64)
    overrides.setdefault("min_validator_withdrawability_delay", 256)
    return ChainSpec(preset=MINIMAL, config_name="minimal", **overrides)
