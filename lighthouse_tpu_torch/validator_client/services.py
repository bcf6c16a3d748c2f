"""Validator-client services: duties, attestation, block production — the port's copy of
``lighthouse_tpu/validator_client/services.py``.

Lighthouse's ``validator_client/validator_services/src/{duties_service,
attestation_service,block_service}.rs``: duties polled from the BN over HTTP,
per-slot attestation signing + publication, proposer-duty block production —
all signing through the ValidatorStore (slashing-protected) and all BN
interaction through the typed HTTP client only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api_client import BeaconNodeHttpClient
from ..api_client.client import AttesterDuty, ProposerDuty
from ..types.containers import AttestationData, Fork, for_preset
from .slashing_protection import NotSafe
from .validator_store import ValidatorStore


@dataclass
class ForkInfo:
    """The slice of state that domain computation needs (fork +
    genesis_validators_root), built from API responses — the VC never holds a
    BeaconState."""

    fork: Fork
    genesis_validators_root: bytes


class DutiesService:
    """Polls proposer/attester duties per epoch (duties_service.rs)."""

    def __init__(self, client: BeaconNodeHttpClient, store: ValidatorStore):
        self.client = client
        self.store = store
        self._indices: dict[bytes, int] = {}
        self.proposer: dict[int, list[ProposerDuty]] = {}
        self.attester: dict[int, list[AttesterDuty]] = {}

    def validator_indices(self) -> dict[bytes, int]:
        # Re-poll while any managed key is still unresolved — validators can
        # activate after the first poll (duties_service.rs re-polls per cycle).
        # Only the managed keys are asked for (the ``id=`` filter, in chunks):
        # the reference GETs the whole registry, hundreds of MB of JSON at 2^20.
        if len(self._indices) < len(self.store.validators):
            all_indices = self.client.get_validator_indices(
                list(self.store.validators)
            )
            self._indices = {
                pk: idx
                for pk, idx in all_indices.items()
                if pk in self.store.validators
            }
        return self._indices

    def poll(self, epoch: int) -> None:
        ours = set(self.validator_indices().values())
        props = self.client.get_proposer_duties(epoch)
        self.proposer[epoch] = [
            d for d in props if d.validator_index in ours
        ]
        self.attester[epoch] = self.client.get_attester_duties(
            epoch, sorted(ours)
        )

    def proposers_at(self, slot: int, epoch: int) -> list[ProposerDuty]:
        return [d for d in self.proposer.get(epoch, []) if d.slot == slot]

    def attesters_at(self, slot: int, epoch: int) -> list[AttesterDuty]:
        return [d for d in self.attester.get(epoch, []) if d.slot == slot]


class ValidatorClientContext:
    """Shared per-VC context: spec, fork info from the BN."""

    def __init__(self, client: BeaconNodeHttpClient, store: ValidatorStore):
        self.client = client
        self.store = store
        genesis = client.get_genesis()
        self.genesis = genesis
        self.store.genesis_validators_root = genesis.genesis_validators_root

    def fork_info(self) -> ForkInfo:
        f = self.client.get_fork("head")
        return ForkInfo(
            fork=Fork(
                previous_version=f["previous_version"],
                current_version=f["current_version"],
                epoch=f["epoch"],
            ),
            genesis_validators_root=self.genesis.genesis_validators_root,
        )


class AttestationService:
    """Per-slot attestation duty execution (attestation_service.rs:231-507,
    minus the aggregation phase which rides sign_selection_proof)."""

    def __init__(self, ctx: ValidatorClientContext, duties: DutiesService):
        self.ctx = ctx
        self.duties = duties
        # (slot, committee_index) -> AttestationData, shared with aggregation
        self.data_cache: dict = {}

    def attest(self, slot: int) -> int:
        """Sign + publish one attestation per owned attester duty at slot.
        Returns the number published. The fetched AttestationData is cached
        per (slot, committee) for the aggregation phase."""
        spec = self.ctx.store.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        my = self.duties.attesters_at(slot, epoch)
        if not my:
            return 0
        fork_info = self.ctx.fork_info()
        ns = for_preset(spec.preset.name)
        published = []
        for duty in my:
            data = AttestationData.decode(
                self.ctx.client.get_attestation_data(slot, duty.committee_index)
            )
            self.data_cache[(slot, duty.committee_index)] = data
            if len(self.data_cache) > 256:
                self.data_cache = {
                    k: v for k, v in self.data_cache.items() if k[0] >= slot - 2
                }
            try:
                sig = self.ctx.store.sign_attestation(
                    duty.pubkey, data, fork_info
                )
            except NotSafe:
                # held back (doppelganger) or slashing-protected — skip this
                # validator, keep attesting with the rest
                continue
            bits = np.zeros(duty.committee_length, dtype=bool)
            bits[duty.validator_committee_index] = True
            att = ns.Attestation(
                aggregation_bits=bits, data=data, signature=sig.serialize()
            )
            published.append(ns.Attestation.encode(att))
        if published:
            self.ctx.client.publish_attestations(published)
        return len(published)


class AggregationService:
    """The aggregation phase of attestation duties
    (attestation_service.rs:231-507 second half): a validator whose selection
    proof selects it as the committee aggregator fetches the naive pool's
    aggregate from the BN, wraps it in a SignedAggregateAndProof, and
    publishes it through the 3-sets verification endpoint."""

    def __init__(self, ctx: ValidatorClientContext, duties: DutiesService,
                 attestations: "AttestationService | None" = None):
        self.ctx = ctx
        self.duties = duties
        self.attestations = attestations

    @staticmethod
    def is_aggregator(committee_length: int, target_per_committee: int,
                      selection_proof: bytes) -> bool:
        """spec is_aggregator: hash(proof) mod ceil-ish committee/TARGET."""
        import hashlib

        modulo = max(1, committee_length // target_per_committee)
        digest = hashlib.sha256(bytes(selection_proof)).digest()
        return int.from_bytes(digest[0:8], "little") % modulo == 0

    def aggregate(self, slot: int) -> int:
        """Run after attest(slot): publish one SignedAggregateAndProof per
        owned aggregator duty. Returns the number published."""
        spec = self.ctx.store.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        my = self.duties.attesters_at(slot, epoch)
        if not my:
            return 0
        fork_info = self.ctx.fork_info()
        ns = for_preset(spec.preset.name)
        published = []
        seen_committees = set()
        for duty in my:
            if duty.committee_index in seen_committees:
                continue
            try:
                proof = self.ctx.store.sign_selection_proof(
                    duty.pubkey, slot, fork_info
                )
            except NotSafe:
                continue
            if not self.is_aggregator(
                duty.committee_length,
                spec.target_aggregators_per_committee,
                proof.serialize(),
            ):
                continue
            data = None
            if self.attestations is not None:
                data = self.attestations.data_cache.get(
                    (slot, duty.committee_index)
                )
            if data is None:
                data = AttestationData.decode(
                    self.ctx.client.get_attestation_data(
                        slot, duty.committee_index
                    )
                )
            from ..api_client import ApiClientError

            try:
                agg_ssz = self.ctx.client.get_aggregate_attestation(
                    AttestationData.hash_tree_root(data)
                )
            except ApiClientError as e:
                if e.code != 404:
                    raise  # outages must not masquerade as 'nothing pooled'
                continue
            aggregate = ns.Attestation.decode(agg_ssz)
            aap = ns.AggregateAndProof(
                aggregator_index=duty.validator_index,
                aggregate=aggregate,
                selection_proof=proof.serialize(),
            )
            sig = self.ctx.store.sign_aggregate_and_proof(
                duty.pubkey, aap, fork_info
            )
            sap = ns.SignedAggregateAndProof(
                message=aap, signature=sig.serialize()
            )
            published.append(ns.SignedAggregateAndProof.encode(sap))
            seen_committees.add(duty.committee_index)
        if published:
            self.ctx.client.publish_aggregate_and_proofs(published)
        return len(published)


class SyncCommitteeService:
    """Per-slot sync-committee duty (sync_committee_service.rs): every owned
    validator in the current committee signs the head root each slot."""

    def __init__(self, ctx: ValidatorClientContext, duties: DutiesService):
        self.ctx = ctx
        self.duties = duties
        self._duty_cache: dict[int, list] = {}  # epoch -> sync duties

    def _sync_duties(self, epoch: int) -> list:
        if epoch not in self._duty_cache:
            indices = self.duties.validator_indices()
            self._duty_cache[epoch] = self.ctx.client.get_sync_duties(
                epoch, sorted(indices.values())
            )
            self._duty_cache = {
                e: d for e, d in self._duty_cache.items() if e >= epoch - 1
            }
        return self._duty_cache[epoch]

    def sign_and_publish(self, slot: int) -> int:
        spec = self.ctx.store.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        duties = self._sync_duties(epoch)
        if not duties:
            return 0
        head = self.ctx.client.get_head_header()
        fork_info = self.ctx.fork_info()
        ns = for_preset(spec.preset.name)
        out = []
        for duty in duties:
            pubkey = bytes.fromhex(duty["pubkey"][2:])
            try:
                sig = self.ctx.store.sign_sync_committee_message(
                    pubkey, slot, head["root"], fork_info
                )
            except NotSafe:
                continue
            msg = ns.SyncCommitteeMessage(
                slot=slot,
                beacon_block_root=head["root"],
                validator_index=int(duty["validator_index"]),
                signature=sig.serialize(),
            )
            out.append(ns.SyncCommitteeMessage.encode(msg))
        if out:
            self.ctx.client.publish_sync_messages(out)
        return len(out)


class BlockService:
    """Proposer duty execution (block_service.rs): randao sign -> produce via
    BN -> sign -> publish."""

    def __init__(self, ctx: ValidatorClientContext, duties: DutiesService):
        self.ctx = ctx
        self.duties = duties

    def propose(self, slot: int) -> bool:
        spec = self.ctx.store.spec
        epoch = slot // spec.preset.SLOTS_PER_EPOCH
        my = self.duties.proposers_at(slot, epoch)
        if not my:
            return False
        duty = my[0]
        fork_info = self.ctx.fork_info()
        try:
            randao = self.ctx.store.sign_randao(duty.pubkey, epoch, fork_info)
        except NotSafe:
            return False  # held back (doppelganger) — skip the proposal
        version, block_ssz = self.ctx.client.produce_block(
            slot, randao.serialize()
        )
        ns = for_preset(spec.preset.name)
        block_cls = ns.block_types[version]
        inner_cls = dict(block_cls.FIELDS)["message"]
        block = inner_cls.decode(block_ssz)
        sig = self.ctx.store.sign_block(duty.pubkey, block, fork_info)
        signed = block_cls(message=block, signature=sig.serialize())
        self.ctx.client.publish_block(version, block_cls.encode(signed))
        return True
