"""Consensus type system: SSZ containers, presets, runtime ChainSpec.

The port's copy of ``lighthouse_tpu/types``, the twin of Lighthouse's
``consensus/types``: the
``EthSpec`` compile-time preset trait becomes ``spec.Preset`` + per-preset
container generation (``containers.for_preset``); ``ChainSpec`` is a plain
runtime dataclass.
"""

from .spec import (
    ChainSpec,
    FAR_FUTURE_EPOCH,
    FORK_ORDER,
    MAINNET,
    MINIMAL,
    PRESETS,
    Preset,
    mainnet_spec,
    minimal_spec,
)
from .containers import (
    AttestationData,
    BeaconBlockHeader,
    Checkpoint,
    Deposit,
    DepositData,
    DepositMessage,
    Eth1Data,
    Fork,
    ForkData,
    ProposerSlashing,
    SignedBeaconBlockHeader,
    SignedVoluntaryExit,
    SigningData,
    Validator,
    VoluntaryExit,
    for_preset,
)
from .helpers import (
    compute_domain,
    compute_fork_data_root,
    compute_fork_digest,
    compute_signing_root,
    get_domain,
    is_active_validator,
    is_slashable_attestation_data,
    is_slashable_validator,
)
