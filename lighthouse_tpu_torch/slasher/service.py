"""Slasher service: gossip ingest + periodic batch processing
(ref slasher/service/src/service.rs); the port's copy of
``lighthouse_tpu/slasher/service.py``.

The reference spawns a timer task that runs ``process_queued`` every
``update_period`` at ``slot_offset`` into the slot, then drains found
slashings into the op pool and optionally broadcasts them.  Here the service
exposes the same three edges — observe attestation, observe block, tick —
and the node/test driver supplies the clock.
"""

from __future__ import annotations


class SlasherService:
    def __init__(self, chain, slasher, op_pool=None):
        self.chain = chain
        self.slasher = slasher
        self.op_pool = op_pool if op_pool is not None else getattr(
            chain, "op_pool", None
        )
        self._last_pruned_epoch = -1

    # -- ingest edges ---------------------------------------------------------

    def attestation_observed(self, indexed_attestation) -> None:
        """Feed a gossip-verified indexed attestation (service.rs ingest)."""
        self.slasher.accept_attestation(indexed_attestation)

    def block_observed(self, signed_block) -> None:
        """Feed an imported block's signed header."""
        from ..types.containers import BeaconBlockHeader, SignedBeaconBlockHeader

        blk = signed_block.message
        header = SignedBeaconBlockHeader(
            message=BeaconBlockHeader(
                slot=blk.slot,
                proposer_index=blk.proposer_index,
                parent_root=bytes(blk.parent_root),
                state_root=bytes(blk.state_root),
                body_root=type(blk.body).hash_tree_root(blk.body),
            ),
            signature=bytes(signed_block.signature),
        )
        self.slasher.accept_block_header(header)

    # -- periodic processing --------------------------------------------------

    def tick(self, current_epoch: int | None = None) -> dict:
        """Process queues and drain slashings into the op pool; prunes the
        database once per epoch advance (service.rs prune cadence)."""
        spe = self.chain.spec.preset.SLOTS_PER_EPOCH
        if current_epoch is None:
            current_epoch = self.chain.current_slot() // spe
        stats = self.slasher.process_queued(current_epoch)
        if current_epoch > self._last_pruned_epoch:
            self.slasher.prune_database(current_epoch, spe)
            self._last_pruned_epoch = current_epoch
        if self.op_pool is not None:
            for s in self.slasher.get_attester_slashings():
                self.op_pool.insert_attester_slashing(s)
            for s in self.slasher.get_proposer_slashings():
                self.op_pool.insert_proposer_slashing(s)
        # checkpoint the engine's record index + span planes each tick when
        # a store is attached (restart-from-disk durability) —
        # a persistence failure is recorded, never silently dropped, and
        # the in-memory engine keeps serving
        persist = getattr(self.slasher, "persist", None)
        if persist is not None and getattr(self.slasher, "store", None) is not None:
            try:
                persist()
            except Exception as e:  # noqa: BLE001 — durable tick best-effort
                from ..resilience import faults

                faults.record_fault(
                    "slasher.persist", e, domain="slasher_device"
                )
        return stats
