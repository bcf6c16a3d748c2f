"""Block replayer: re-apply a range of blocks onto a base state
(ref consensus/state_processing/src/block_replayer.rs:30-313).

Used by the freezer's replay layer (states below the finest diff cadence
are reconstructed by replaying canonical blocks from the nearest stored
anchor), historical state queries, and — later — backfill verification.
Signature verification is skipped by default (the blocks were verified at
import; replay is deterministic recomputation), matching the reference's
``no_signature_verification`` builder default for store use.
"""

from __future__ import annotations

from ..types.spec import ChainSpec
from .per_block import BlockSignatureStrategy, per_block_processing
from .per_slot import process_slots


class BlockReplayer:
    def __init__(
        self,
        spec: ChainSpec,
        state,
        verify_signatures: bool = False,
        verify_block_roots: bool = True,
    ):
        self.spec = spec
        self.state = state
        self._strategy = (
            BlockSignatureStrategy.VERIFY_BULK
            if verify_signatures
            else BlockSignatureStrategy.NO_VERIFICATION
        )
        self._verify_roots = verify_block_roots
        # state-root provider seam (block_replayer.rs state_root_iter): lets
        # callers skip recomputing known roots during slot processing
        self.state_root_provider = None

    def apply_blocks(self, blocks, target_slot: int | None = None) -> "BlockReplayer":
        for signed in blocks:
            slot = int(signed.message.slot)
            if self.state.slot < slot:
                process_slots(self.spec, self.state, slot)
            per_block_processing(
                self.spec,
                self.state,
                signed,
                strategy=self._strategy,
                verify_block_root=self._verify_roots,
            )
        if target_slot is not None and self.state.slot < target_slot:
            process_slots(self.spec, self.state, target_slot)
        return self
