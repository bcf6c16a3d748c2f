"""State-transition harness: deterministic validators producing real blocks.

The port's copy of ``lighthouse_tpu/testing/harness.py``: the state-level core
of Lighthouse's ``BeaconChainHarness``
(``beacon_node/beacon_chain/src/test_utils.rs:645``):
interop keypairs (``:367``), block production with valid proposer/randao
signatures, committee-complete attestation production, and slot advancement —
everything needed to drive ``per_block_processing`` end-to-end without a
network. It signs through the native C++ backend (``native/``), so the
blocks it produces for a seed are the reference harness's, byte for byte.
``apply_block`` verifies through the ``bls`` backend the caller selected.
"""

from __future__ import annotations

import numpy as np

from ..oracle.fields import R as CURVE_ORDER
from ..types.containers import Checkpoint, for_preset
from ..types.helpers import compute_signing_root, get_domain
from ..types.spec import ChainSpec, fork_at_least
from ..ssz import uint64
from ..state_transition import (
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    per_block_processing,
    process_slots,
    BlockSignatureStrategy,
)
from ..state_transition.genesis import interop_genesis_state, interop_secret_keys
from ..state_transition.per_block import ConsensusContext


class StateHarness:
    def __init__(self, spec: ChainSpec, n_validators: int, genesis_time: int = 0):
        self.spec = spec
        self.ns = for_preset(spec.preset.name)
        self.sks = interop_secret_keys(n_validators)
        self.state = interop_genesis_state(spec, n_validators, genesis_time)
        # sign through the native C++ backend: the harness produces thousands
        # of signatures per multi-epoch test and the oracle takes ~1s each
        from ..native import NativeBls

        self._nb = NativeBls()
        # mock execution layer for merge-era forks (test_utils.rs:508-524)
        from ..execution_layer import MockExecutionLayer

        self.el = MockExecutionLayer()

    @staticmethod
    def head_root(state) -> bytes:
        """Canonical block root of the state's head: the latest block header
        with its zero state_root filled in (the pre-process_slot form)."""
        hdr = state.latest_block_header.copy()
        if bytes(hdr.state_root) == b"\x00" * 32:
            hdr.state_root = state.tree_root()
        return hdr.tree_root()

    # -- signing helpers ----------------------------------------------------------

    def _sign(self, sk_index: int, signing_root: bytes) -> bytes:
        return self._nb.sign(
            self.sks[sk_index].to_bytes(32, "big"), signing_root
        )

    def randao_reveal(self, state, proposer: int, epoch: int) -> bytes:
        domain = get_domain(self.spec, state, self.spec.DOMAIN_RANDAO, epoch=epoch)
        from ..types.containers import SigningData

        root = SigningData(
            object_root=uint64.hash_tree_root(epoch), domain=domain
        ).tree_root()
        return self._sign(proposer, root)

    # -- attestations -------------------------------------------------------------

    def attestations_for_slot(self, state, slot: int, head_root: bytes) -> list:
        """One fully-aggregated attestation per committee at ``slot``."""
        spec = self.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        target_root = (
            head_root
            if slot == spec.start_slot(epoch)
            else get_block_root_at_slot(spec, state, spec.start_slot(epoch))
        )
        atts = []
        domain = get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=epoch)
        n_comm = get_committee_count_per_slot(spec, state, epoch)
        from ..types.containers import AttestationData

        electra = fork_at_least(
            spec.fork_name_at_epoch(epoch), "electra"
        )
        for index in range(n_comm):
            committee = get_beacon_committee(spec, state, slot, index)
            data = AttestationData(
                slot=slot,
                index=0 if electra else index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=target_root),
            )
            root = compute_signing_root(data, domain)
            # aggregate of individual signatures == one signature by the
            # summed secret key (saves len(committee)-1 native signs)
            agg_sk = sum(self.sks[int(v)] for v in committee) % CURVE_ORDER
            sig = self._nb.sign(agg_sk.to_bytes(32, "big"), root)
            if electra:
                committee_bits = np.zeros(
                    spec.preset.MAX_COMMITTEES_PER_SLOT, dtype=bool
                )
                committee_bits[index] = True
                atts.append(
                    self.ns.AttestationElectra(
                        aggregation_bits=np.ones(committee.size, dtype=bool),
                        data=data,
                        signature=sig,
                        committee_bits=committee_bits,
                    )
                )
            else:
                atts.append(
                    self.ns.Attestation(
                        aggregation_bits=np.ones(committee.size, dtype=bool),
                        data=data,
                        signature=sig,
                    )
                )
        return atts

    def unaggregated_attestations_for_slot(
        self, state, slot: int, head_root: bytes
    ) -> list:
        """One single-bit attestation per committee member (the gossip-subnet
        shape that feeds batch_verify_unaggregated_attestations)."""
        spec = self.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        target_root = (
            head_root
            if slot == spec.start_slot(epoch)
            else get_block_root_at_slot(spec, state, spec.start_slot(epoch))
        )
        domain = get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=epoch)
        from ..types.containers import AttestationData

        atts = []
        for index in range(get_committee_count_per_slot(spec, state, epoch)):
            committee = get_beacon_committee(spec, state, slot, index)
            data = AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=target_root),
            )
            root = compute_signing_root(data, domain)
            for pos, v in enumerate(committee):
                bits = np.zeros(committee.size, dtype=bool)
                bits[pos] = True
                atts.append(
                    self.ns.Attestation(
                        aggregation_bits=bits,
                        data=data,
                        signature=self._sign(int(v), root),
                    )
                )
        return atts

    def signed_aggregate_and_proofs(
        self, state, slot: int, head_root: bytes
    ) -> list:
        """One SignedAggregateAndProof per committee: the first committee
        member plays aggregator (selection-proof gossip checks are the
        scheduler's job; signatures here are real)."""
        spec = self.spec
        from ..types.containers import SigningData

        saps = []
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        dom_sel = get_domain(
            spec, state, spec.DOMAIN_SELECTION_PROOF, epoch=epoch
        )
        dom_ap = get_domain(
            spec, state, spec.DOMAIN_AGGREGATE_AND_PROOF, epoch=epoch
        )
        root_sel = SigningData(
            object_root=uint64.hash_tree_root(slot), domain=dom_sel
        ).tree_root()
        for index, att in enumerate(
            self.attestations_for_slot(state, slot, head_root)
        ):
            committee = get_beacon_committee(spec, state, slot, index)
            aggor = int(committee[0])
            agg = self.ns.AggregateAndProof(
                aggregator_index=aggor,
                aggregate=att,
                selection_proof=self._sign(aggor, root_sel),
            )
            sig = self._sign(aggor, compute_signing_root(agg, dom_ap))
            saps.append(
                self.ns.SignedAggregateAndProof(message=agg, signature=sig)
            )
        return saps

    # -- blocks -------------------------------------------------------------------

    def produce_block(self, slot: int, attestations=None):
        """Produce a signed block on top of the current state at ``slot``."""
        spec = self.spec
        state = self.state.copy()
        if state.slot < slot:
            process_slots(spec, state, slot)
        proposer = get_beacon_proposer_index(spec, state)
        epoch = get_current_epoch(spec, state)
        parent_root = state.latest_block_header.tree_root()

        fork = spec.fork_name_at_epoch(epoch)
        body_cls = self.ns.body_types[fork]
        block_cls = self.ns.block_types[fork]
        # fork boundary: drop attestations whose container shape predates the
        # body's list type (EIP-7549 changed the attestation wire format)
        att_elem = dict(body_cls.FIELDS)["attestations"].elem
        attestations = [
            a for a in (attestations or []) if isinstance(a, att_elem)
        ]
        body = body_cls(
            randao_reveal=self.randao_reveal(state, proposer, epoch),
            eth1_data=state.eth1_data,
            attestations=attestations,
        )
        if fork != "phase0":
            body.sync_aggregate = self._sync_aggregate(state, slot)
        if fork_at_least(fork, "bellatrix"):
            body.execution_payload = self._execution_payload(state, slot, fork)
        inner_cls = dict(block_cls.FIELDS)["message"]
        block = inner_cls(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=body,
        )
        # compute post-state root with signatures skipped
        trial = state.copy()
        signed_trial = block_cls(message=block, signature=b"\x00" * 96)
        per_block_processing(
            spec, trial, signed_trial,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            verify_block_root=False,
        )
        block.state_root = trial.tree_root()
        # proposer signature
        domain = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
        sig = self._sign(proposer, compute_signing_root(block, domain))
        return block_cls(message=block, signature=sig)

    def produce_block_with_blobs(self, slot: int, blobs: list, kzg):
        """Deneb: produce a signed block carrying blob commitments plus its
        gossip sidecars (the BlockContents production path)."""
        from ..beacon_chain.data_availability import make_blob_sidecars

        signed = self.produce_block(slot)
        block = signed.message
        commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
        block.body.blob_kzg_commitments = commitments
        signed = self.resign_block(signed)
        proofs = [
            kzg.compute_blob_kzg_proof(b, c)
            for b, c in zip(blobs, commitments)
        ]
        sidecars = make_blob_sidecars(self.ns, signed, blobs, proofs)
        return signed, sidecars

    def resign_block(self, signed_block):
        """Recompute state_root + proposer signature after mutating a
        produced block's body (test-only convenience)."""
        block = signed_block.message
        spec = self.spec
        state = self.state.copy()
        if state.slot < block.slot:
            process_slots(spec, state, block.slot)
        trial = state.copy()
        block.state_root = b"\x00" * 32
        per_block_processing(
            spec, trial, type(signed_block)(message=block, signature=b"\x00" * 96),
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            verify_block_root=False,
        )
        block.state_root = trial.tree_root()
        epoch = get_current_epoch(spec, state)
        domain = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
        sig = self._sign(
            int(block.proposer_index), compute_signing_root(block, domain)
        )
        return type(signed_block)(message=block, signature=sig)

    def _execution_payload(self, state, slot: int, fork: str):
        """Build the next mock execution payload on the state's payload head
        (MockExecutionLayer/ExecutionBlockGenerator parity)."""
        from ..state_transition import get_current_epoch, get_randao_mix
        from ..state_transition.per_block import (
            compute_timestamp_at_slot,
            _expected_withdrawals_list,
        )

        from ..execution_layer.mock import GENESIS_BLOCK_HASH
        from ..state_transition.per_block import is_merge_transition_complete

        payload_cls = self.ns.payload_types[fork]
        withdrawals = None
        if fork_at_least(fork, "capella"):
            withdrawals = _expected_withdrawals_list(self.spec, state)
        # pre-merge bellatrix state: this block IS the merge transition —
        # build the first payload on the mock EL's genesis block
        parent_hash = (
            bytes(state.latest_execution_payload_header.block_hash)
            if is_merge_transition_complete(state)
            else GENESIS_BLOCK_HASH
        )
        return self.el.generator.produce_payload(
            payload_cls,
            parent_hash=parent_hash,
            timestamp=compute_timestamp_at_slot(self.spec, state, slot),
            prev_randao=get_randao_mix(
                self.spec, state, get_current_epoch(self.spec, state)
            ),
            withdrawals=withdrawals,
        )

    def _sync_aggregate(self, state, slot: int):
        spec = self.spec
        prev_slot = max(slot, 1) - 1
        root = get_block_root_at_slot(spec, state, prev_slot)
        domain = get_domain(
            spec, state, spec.DOMAIN_SYNC_COMMITTEE,
            epoch=spec.compute_epoch_at_slot(prev_slot),
        )
        from ..types.containers import SigningData

        signing_root = SigningData(object_root=root, domain=domain).tree_root()
        pk_to_idx = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        agg_sk = 0
        bits = []
        for pk in state.current_sync_committee.pubkeys:
            idx = pk_to_idx[bytes(pk)]
            bits.append(True)
            agg_sk = (agg_sk + self.sks[idx]) % CURVE_ORDER
        return self.ns.SyncAggregate(
            sync_committee_bits=np.array(bits, dtype=bool),
            sync_committee_signature=self._nb.sign(
                agg_sk.to_bytes(32, "big"), signing_root
            ),
        )

    def apply_block(self, signed_block, strategy=BlockSignatureStrategy.VERIFY_BULK):
        """Advance self.state through the block's slot and apply it."""
        spec = self.spec
        if self.state.slot < signed_block.message.slot:
            process_slots(spec, self.state, signed_block.message.slot)
        ctxt = per_block_processing(spec, self.state, signed_block, strategy=strategy)
        return ctxt

    def extend_chain(self, n_blocks: int, with_attestations: bool = True):
        """Produce + apply n blocks, attesting to each head (test_utils.rs
        extend_chain shape)."""
        for _ in range(n_blocks):
            slot = self.state.slot + 1
            atts = []
            if with_attestations and slot > 1:
                # attest to the previous slot's head from the pre-state; the
                # true block root needs the header's state_root filled in
                prev = self.state
                head_root = self.head_root(prev)
                att_slot = prev.slot
                if att_slot + self.spec.min_attestation_inclusion_delay <= slot:
                    atts = self.attestations_for_slot(prev, att_slot, head_root)
            block = self.produce_block(slot, attestations=atts)
            self.apply_block(block)
        return self.state
