"""Pure state-transition functions (consensus/state_processing twin): the
port's copy of ``lighthouse_tpu/state_transition``.

Everything here is deterministic and I/O-free: ``per_slot_processing``,
``per_block_processing`` (with pluggable BlockSignatureStrategy feeding the
port's ``bls`` seam in batches: under VERIFY_BULK one device batch per
block), and epoch processing, which the port's ``epoch_engine`` runs on the
device unless the numpy backend is selected (the columnar numpy sweeps of
``per_epoch.py``; Lighthouse's single-pass design,
``per_epoch_processing/single_pass.rs``, maps to array ops in both).
"""

from .beacon_state_util import (
    CommitteeCache,
    get_active_validator_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    get_seed,
    get_total_active_balance,
    get_total_balance,
)
from .per_block import (
    BlockSignatureStrategy,
    BlockProcessingError,
    per_block_processing,
    process_block_header,
    process_operations,
    process_randao,
)
from .per_slot import per_slot_processing, process_slots
from .per_epoch import process_epoch
from .state_advance import complete_state_advance, partial_state_advance
