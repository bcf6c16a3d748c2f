"""Spec fork choice over the proto-array (consensus/fork_choice twin).

Parity: ``consensus/fork_choice/src/fork_choice.rs`` —
``on_block`` (:648), ``on_attestation`` (:1045) with the one-slot queue
(:235), ``get_head`` (:474), proposer boost, and checkpoint management in a
``ForkChoiceStore`` (the beacon-chain layer supplies balances the way
``BeaconForkChoiceStore`` does).

The port's copy of ``lighthouse_tpu/fork_choice/fork_choice.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..types.spec import ChainSpec
from .proto_array import ExecutionStatus, ProtoArrayForkChoice


class ForkChoiceError(Exception):
    pass


@dataclass
class QueuedAttestation:
    slot: int
    attesting_indices: list
    block_root: bytes
    target_epoch: int


@dataclass
class ForkChoiceStore:
    """Justified/finalized tracking + balances provider
    (fork_choice.rs ForkChoiceStore trait + BeaconForkChoiceStore)."""

    current_slot: int
    justified_checkpoint: tuple  # (epoch, root)
    finalized_checkpoint: tuple
    justified_balances: np.ndarray
    unrealized_justified_checkpoint: tuple | None = None
    unrealized_finalized_checkpoint: tuple | None = None
    equivocating_indices: set = field(default_factory=set)
    proposer_boost_root: bytes = b"\x00" * 32


class ForkChoice:
    def __init__(self, spec: ChainSpec, store: ForkChoiceStore, proto: ProtoArrayForkChoice):
        self.spec = spec
        self.store = store
        self.proto = proto
        self.queued_attestations: list[QueuedAttestation] = []

    @classmethod
    def from_anchor(
        cls, spec: ChainSpec, anchor_root: bytes, anchor_slot: int,
        justified_checkpoint, finalized_checkpoint, balances,
    ) -> "ForkChoice":
        proto = ProtoArrayForkChoice(
            finalized_root=anchor_root,
            finalized_slot=anchor_slot,
            justified_epoch=justified_checkpoint[0],
            finalized_epoch=finalized_checkpoint[0],
            justified_root=justified_checkpoint[1],
        )
        store = ForkChoiceStore(
            current_slot=anchor_slot,
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
            justified_balances=np.asarray(balances, dtype=np.uint64),
        )
        return cls(spec, store, proto)

    # -- time -------------------------------------------------------------------

    def update_time(self, current_slot: int) -> None:
        while self.store.current_slot < current_slot:
            self.store.current_slot += 1
            self.store.proposer_boost_root = b"\x00" * 32
            self._process_queued_attestations()

    def _process_queued_attestations(self) -> None:
        ready = [
            a for a in self.queued_attestations if a.slot < self.store.current_slot
        ]
        self.queued_attestations = [
            a for a in self.queued_attestations if a.slot >= self.store.current_slot
        ]
        for a in ready:
            self.proto.process_attestations(a.attesting_indices, a.block_root, a.target_epoch)

    # -- blocks (fork_choice.rs:648) --------------------------------------------

    def on_block(
        self, current_slot: int, block, block_root: bytes, state,
        justified_balances=None,
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
        is_first_block_in_slot: bool = False,
    ) -> None:
        self.update_time(current_slot)
        if block.slot > current_slot:
            raise ForkChoiceError("block from the future")
        fin_epoch, fin_root = self.store.finalized_checkpoint
        if block.slot <= self._finalized_slot():
            raise ForkChoiceError("block slot not beyond finalized")
        if fin_epoch and not self.proto.is_descendant(fin_root, bytes(block.parent_root)):
            raise ForkChoiceError("block does not descend from finalized root")

        # proposer boost: first block in its slot arriving timely
        if is_first_block_in_slot and block.slot == current_slot:
            self.store.proposer_boost_root = block_root

        sj = (state.current_justified_checkpoint.epoch,
              bytes(state.current_justified_checkpoint.root))
        sf = (state.finalized_checkpoint.epoch, bytes(state.finalized_checkpoint.root))
        if sj[0] > self.store.justified_checkpoint[0]:
            self.store.justified_checkpoint = sj
            if justified_balances is not None:
                self.store.justified_balances = np.asarray(
                    justified_balances, dtype=np.uint64
                )
        if sf[0] > self.store.finalized_checkpoint[0]:
            self.store.finalized_checkpoint = sf

        epoch = block.slot // self.spec.preset.SLOTS_PER_EPOCH
        target_slot = epoch * self.spec.preset.SLOTS_PER_EPOCH
        target_root = (
            block_root if block.slot == target_slot
            else self._ancestor_at_slot(bytes(block.parent_root), target_slot)
        )
        self.proto.on_block(
            slot=block.slot,
            root=block_root,
            parent_root=bytes(block.parent_root),
            state_root=bytes(block.state_root),
            target_root=target_root,
            justified_epoch=sj[0],
            finalized_epoch=sf[0],
            execution_status=execution_status,
        )

    def _ancestor_at_slot(self, root: bytes, slot: int) -> bytes:
        idx = self.proto.indices.get(root)
        while idx is not None and self.proto.nodes[idx].slot > slot:
            idx = self.proto.nodes[idx].parent
        return self.proto.nodes[idx].root if idx is not None else root

    def _finalized_slot(self) -> int:
        return self.spec.start_slot(self.store.finalized_checkpoint[0])

    # -- attestations (fork_choice.rs:1045) -------------------------------------

    def on_attestation(
        self, current_slot: int, indexed_attestation, is_from_block: bool = False
    ) -> None:
        self.update_time(current_slot)
        data = indexed_attestation.data
        block_root = bytes(data.beacon_block_root)
        if block_root not in self.proto.indices:
            raise ForkChoiceError("attestation for unknown block")
        block_slot = self.proto.nodes[self.proto.indices[block_root]].slot
        if block_slot > data.slot:
            raise ForkChoiceError("attestation for block newer than slot")
        if not is_from_block and data.slot >= current_slot:
            # queue for the next slot (1-slot delay rule, fork_choice.rs:235)
            self.queued_attestations.append(
                QueuedAttestation(
                    slot=data.slot,
                    attesting_indices=list(indexed_attestation.attesting_indices),
                    block_root=block_root,
                    target_epoch=data.target.epoch,
                )
            )
            return
        self.proto.process_attestations(
            indexed_attestation.attesting_indices, block_root, data.target.epoch
        )

    def on_attester_slashing(self, indices) -> None:
        self.store.equivocating_indices.update(int(i) for i in indices)

    # -- head (fork_choice.rs:474) ----------------------------------------------

    def get_proposer_head(
        self,
        current_slot: int,
        canonical_head: bytes,
        re_org_threshold_pct: int = 20,
    ) -> bytes:
        """Proposer re-org heuristic (fork_choice.rs:522 get_proposer_head):
        when the head block arrived one slot late and carries little attesting
        weight, the proposer builds on its PARENT instead, orphaning the weak
        block. Conservative gate set:

          * the head is exactly one slot behind the proposal slot and its
            parent is exactly one slot behind the head (no skipped slots),
          * head weight < re_org_threshold_pct of one slot's committee weight,
          * finalization is recent (within two epochs),
          * only a single re-org step (parent must be canonical).
        Returns the root to build on (parent for a re-org, else the head)."""
        idx = self.proto.indices.get(bytes(canonical_head))
        if idx is None:
            return canonical_head
        node = self.proto.nodes[idx]
        if node.parent is None:
            return canonical_head
        parent = self.proto.nodes[node.parent]
        if int(node.slot) + 1 != current_slot:
            return canonical_head  # head is on time (or older than one slot)
        if int(parent.slot) + 1 != int(node.slot):
            return canonical_head  # skipped slot below the head: do not re-org
        f_epoch, _ = self.store.finalized_checkpoint
        epochs_since_final = (
            current_slot // self.spec.preset.SLOTS_PER_EPOCH - int(f_epoch)
        )
        if epochs_since_final > 2:
            return canonical_head  # unhealthy chain: never re-org
        total = int(self.store.justified_balances.sum())
        committee_weight = total // self.spec.preset.SLOTS_PER_EPOCH
        threshold = committee_weight * re_org_threshold_pct // 100
        if int(node.weight) >= threshold:
            return canonical_head  # the late block gathered real support
        return parent.root

    def get_head(self, current_slot: int) -> bytes:
        self.update_time(current_slot)
        j_epoch, j_root = self.store.justified_checkpoint
        f_epoch, _ = self.store.finalized_checkpoint
        return self.proto.find_head(
            justified_epoch=j_epoch,
            justified_root=j_root,
            finalized_epoch=f_epoch,
            justified_state_balances=self.store.justified_balances,
            proposer_boost_root=self.store.proposer_boost_root,
            proposer_score_boost=self.spec.proposer_score_boost,
            equivocating_indices=self.store.equivocating_indices,
            current_slot=current_slot,
            slots_per_epoch=self.spec.preset.SLOTS_PER_EPOCH,
        )
