"""Validator store: key management + slashing-protected signing — the port's copy of
``lighthouse_tpu/validator_client/validator_store.py``.

Lighthouse's ``validator_client/validator_store`` + ``signing_method``: local
keystore signing (the Web3Signer remote path plugs into the same seam as an
alternative ``SigningMethod``), every block/attestation signature gated by the
SlashingDatabase, doppelganger-aware.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import bls
from ..types.helpers import compute_signing_root, get_domain
from ..types.spec import ChainSpec
from .slashing_protection import NotSafe, SlashingDatabase


class SigningMethod:
    """Local secret key (keystore-decrypted). Web3Signer would implement the
    same interface with an HTTP call (signing_method/src/web3signer.rs)."""

    def __init__(self, sk: bls.SecretKey):
        self.sk = sk

    def sign(self, signing_root: bytes) -> bls.Signature:
        return self.sk.sign(signing_root)


@dataclass
class InitializedValidator:
    pubkey: bytes
    method: SigningMethod
    enabled: bool = True


class ValidatorStore:
    def __init__(
        self,
        spec: ChainSpec,
        slashing_db: SlashingDatabase | None = None,
        genesis_validators_root: bytes = b"\x00" * 32,
    ):
        self.spec = spec
        self.slashing_db = slashing_db or SlashingDatabase()
        self.genesis_validators_root = genesis_validators_root
        self.validators: dict[bytes, InitializedValidator] = {}
        self.doppelganger_suspect: set[bytes] = set()

    # -- registration ------------------------------------------------------------

    def add_validator_sk(self, sk: bls.SecretKey) -> bytes:
        pk = sk.public_key().serialize()
        self.validators[pk] = InitializedValidator(pk, SigningMethod(sk))
        self.slashing_db.register_validator(pk)
        return pk

    def add_validator_keystore(self, keystore, password: str) -> bytes:
        secret = keystore.decrypt(password)
        return self.add_validator_sk(bls.SecretKey.from_bytes(secret))

    def add_validator_remote(self, pubkey: bytes, signer_url: str) -> bytes:
        """Register a Web3Signer-backed validator (remote key; local slashing
        protection still gates every signature)."""
        from .web3signer import Web3SignerMethod

        pk = bytes(pubkey)
        self.validators[pk] = InitializedValidator(
            pk, Web3SignerMethod(pk, signer_url)
        )
        self.slashing_db.register_validator(pk)
        return pk

    def remove_validator(self, pubkey: bytes) -> bool:
        """Delete a key from the store (keymanager DELETE). The slashing
        history stays in the database — it must survive key round-trips."""
        return self.validators.pop(bytes(pubkey), None) is not None

    def voting_pubkeys(self) -> list[bytes]:
        return [pk for pk, v in self.validators.items() if v.enabled]

    def _method(self, pubkey: bytes) -> SigningMethod:
        v = self.validators.get(bytes(pubkey))
        if v is None or not v.enabled:
            raise NotSafe("unknown or disabled validator")
        if bytes(pubkey) in self.doppelganger_suspect:
            raise NotSafe("doppelganger protection active")
        return v.method

    # -- signing (each gated by slashing protection) -------------------------------

    def sign_block(self, pubkey: bytes, block, state) -> bls.Signature:
        method = self._method(pubkey)
        domain = get_domain(
            self.spec, state, self.spec.DOMAIN_BEACON_PROPOSER,
            epoch=self.spec.compute_epoch_at_slot(block.slot),
        )
        root = compute_signing_root(block, domain)
        self.slashing_db.check_and_insert_block_proposal(
            bytes(pubkey), int(block.slot), root
        )
        # crash point BETWEEN the recorded watermark and the signature
        # leaving this process: the EIP-3076 record is committed first, so
        # a kill here can never lead to a conflicting re-sign after restart
        from ..resilience.crashpoints import maybe_crash

        maybe_crash("persist.slashing_protection")
        return method.sign(root)

    def sign_attestation(self, pubkey: bytes, data, state) -> bls.Signature:
        method = self._method(pubkey)
        domain = get_domain(
            self.spec, state, self.spec.DOMAIN_BEACON_ATTESTER,
            epoch=data.target.epoch,
        )
        root = compute_signing_root(data, domain)
        self.slashing_db.check_and_insert_attestation(
            bytes(pubkey), int(data.source.epoch), int(data.target.epoch), root
        )
        from ..resilience.crashpoints import maybe_crash

        maybe_crash("persist.slashing_protection")
        return method.sign(root)

    def sign_randao(self, pubkey: bytes, epoch: int, state) -> bls.Signature:
        from ..ssz import uint64
        from ..types.containers import SigningData

        method = self._method(pubkey)
        domain = get_domain(self.spec, state, self.spec.DOMAIN_RANDAO, epoch=epoch)
        root = SigningData(
            object_root=uint64.hash_tree_root(epoch), domain=domain
        ).tree_root()
        return method.sign(root)

    def sign_selection_proof(self, pubkey: bytes, slot: int, state) -> bls.Signature:
        from ..ssz import uint64
        from ..types.containers import SigningData

        method = self._method(pubkey)
        domain = get_domain(
            self.spec, state, self.spec.DOMAIN_SELECTION_PROOF,
            epoch=self.spec.compute_epoch_at_slot(slot),
        )
        root = SigningData(
            object_root=uint64.hash_tree_root(slot), domain=domain
        ).tree_root()
        return method.sign(root)

    def sign_aggregate_and_proof(self, pubkey: bytes, agg_and_proof, state):
        method = self._method(pubkey)
        domain = get_domain(
            self.spec, state, self.spec.DOMAIN_AGGREGATE_AND_PROOF,
            epoch=self.spec.compute_epoch_at_slot(agg_and_proof.aggregate.data.slot),
        )
        root = compute_signing_root(agg_and_proof, domain)
        return method.sign(root)

    def sign_sync_committee_message(
        self, pubkey: bytes, slot: int, beacon_block_root: bytes, state
    ) -> bls.Signature:
        from ..types.helpers import sync_committee_signing_root

        method = self._method(pubkey)
        return method.sign(
            sync_committee_signing_root(
                self.spec, state, slot, beacon_block_root
            )
        )

    def sign_voluntary_exit(self, pubkey: bytes, exit_msg, state) -> bls.Signature:
        method = self._method(pubkey)
        domain = get_domain(
            self.spec, state, self.spec.DOMAIN_VOLUNTARY_EXIT,
            epoch=exit_msg.epoch,
        )
        root = compute_signing_root(exit_msg, domain)
        return method.sign(root)
