"""SignatureSet constructors for every consensus message type.

Parity: ``consensus/state_processing/src/per_block_processing/
signature_sets.rs:74-609``. Each constructor resolves pubkeys through a
``get_pubkey`` callback (the decompressed-cache seam — the chain layer passes
its ValidatorPubkeyCache lookup) and returns a ``bls.SignatureSet`` ready for
batched verification.
"""

from __future__ import annotations

from .. import bls
from ..types.helpers import compute_signing_root, get_domain
from ..types.spec import ChainSpec
from .beacon_state_util import get_indexed_attestation


class SignatureSetError(bls.BlsError):
    """Set construction failed on untrusted input (subclasses BlsError so the
    chain's block-rejection handling catches it as a clean BlockError)."""


def _pubkey(get_pubkey, state, index: int) -> bls.PublicKey:
    pk = get_pubkey(int(index)) if get_pubkey else None
    if pk is None:
        try:
            pk = bls.PublicKey.from_bytes(bytes(state.validators[int(index)].pubkey))
        except bls.BlsError as e:
            raise SignatureSetError(f"validator {index}: {e}") from None
    return pk


def _header_signature_ok(spec: ChainSpec, state, signed_header, pubkey) -> bool:
    """Proposer signature over a SignedBeaconBlockHeader (the blob-sidecar
    gossip check, blob_verification.rs verify_header_signature).

    The domain's fork version comes from the SPEC's schedule at the header's
    slot, not from ``state.fork`` — the head state can lag a fork boundary
    the header has already crossed."""
    from ..types.helpers import compute_domain

    hdr = signed_header.message
    epoch = spec.compute_epoch_at_slot(int(hdr.slot))
    version = spec.fork_version(spec.fork_name_at_epoch(epoch))
    domain = compute_domain(
        spec.DOMAIN_BEACON_PROPOSER,
        version,
        bytes(state.genesis_validators_root),
    )
    root = compute_signing_root(hdr, domain)
    try:
        sig = bls.Signature.from_bytes(bytes(signed_header.signature))
    except bls.BlsError:
        return False
    return bls.verify_signature_sets(
        [bls.SignatureSet.single_pubkey(sig, pubkey, root)]
    )


def block_proposal_signature_set(
    spec: ChainSpec, state, signed_block, block_root=None, get_pubkey=None
) -> bls.SignatureSet:
    block = signed_block.message
    domain = get_domain(
        spec, state, spec.DOMAIN_BEACON_PROPOSER,
        epoch=spec.compute_epoch_at_slot(block.slot),
    )
    root = compute_signing_root(block, domain)
    return bls.SignatureSet.single_pubkey(
        bls.Signature.from_bytes(bytes(signed_block.signature)),
        _pubkey(get_pubkey, state, block.proposer_index),
        root,
    )


def randao_signature_set(
    spec: ChainSpec, state, proposer_index: int, epoch: int, randao_reveal,
    get_pubkey=None,
) -> bls.SignatureSet:
    from ..ssz import uint64

    domain = get_domain(spec, state, spec.DOMAIN_RANDAO, epoch=epoch)
    # signing root of the epoch number itself
    from ..types.containers import SigningData

    root = SigningData(
        object_root=uint64.hash_tree_root(epoch), domain=domain
    ).tree_root()
    return bls.SignatureSet.single_pubkey(
        bls.Signature.from_bytes(bytes(randao_reveal)),
        _pubkey(get_pubkey, state, proposer_index),
        root,
    )


def proposer_slashing_signature_sets(
    spec: ChainSpec, state, slashing, get_pubkey=None
) -> list:
    sets = []
    for signed_header in (slashing.signed_header_1, slashing.signed_header_2):
        header = signed_header.message
        domain = get_domain(
            spec, state, spec.DOMAIN_BEACON_PROPOSER,
            epoch=spec.compute_epoch_at_slot(header.slot),
        )
        root = compute_signing_root(header, domain)
        sets.append(
            bls.SignatureSet.single_pubkey(
                bls.Signature.from_bytes(bytes(signed_header.signature)),
                _pubkey(get_pubkey, state, header.proposer_index),
                root,
            )
        )
    return sets


def indexed_attestation_signature_set(
    spec: ChainSpec, state, indexed, get_pubkey=None
) -> bls.SignatureSet:
    if not indexed.attesting_indices:
        raise SignatureSetError("empty attesting indices")
    domain = get_domain(
        spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=indexed.data.target.epoch
    )
    root = compute_signing_root(indexed.data, domain)
    keys = [_pubkey(get_pubkey, state, i) for i in indexed.attesting_indices]
    return bls.SignatureSet.multiple_pubkeys(
        bls.Signature.from_bytes(bytes(indexed.signature)), keys, root
    )


def attestation_signature_set(
    spec: ChainSpec, state, attestation, get_pubkey=None
) -> bls.SignatureSet:
    indexed = get_indexed_attestation(spec, state, attestation)
    return indexed_attestation_signature_set(spec, state, indexed, get_pubkey)


def exit_signature_set(
    spec: ChainSpec, state, signed_exit, get_pubkey=None
) -> bls.SignatureSet:
    exit_msg = signed_exit.message
    from ..types.spec import fork_at_least

    if fork_at_least(getattr(state, "fork_name", "phase0"), "deneb"):
        # deneb pins exit domains to the capella fork version forever
        # (EIP-7044; ref signature_sets.rs eip7044 handling)
        from ..types.helpers import compute_domain

        domain = compute_domain(
            spec.DOMAIN_VOLUNTARY_EXIT,
            spec.capella_fork_version,
            bytes(state.genesis_validators_root),
        )
    else:
        domain = get_domain(
            spec, state, spec.DOMAIN_VOLUNTARY_EXIT, epoch=exit_msg.epoch
        )
    root = compute_signing_root(exit_msg, domain)
    return bls.SignatureSet.single_pubkey(
        bls.Signature.from_bytes(bytes(signed_exit.signature)),
        _pubkey(get_pubkey, state, exit_msg.validator_index),
        root,
    )


def bls_to_execution_change_signature_set(
    spec: ChainSpec, state, signed_change
) -> bls.SignatureSet:
    """Capella credential rotation: signed by the OLD BLS key under the
    GENESIS fork domain (signature_sets.rs bls_execution_change_signature_set)."""
    from ..types.helpers import compute_domain

    msg = signed_change.message
    domain = compute_domain(
        spec.DOMAIN_BLS_TO_EXECUTION_CHANGE,
        spec.genesis_fork_version,
        bytes(state.genesis_validators_root),
    )
    root = compute_signing_root(msg, domain)
    try:
        pk = bls.PublicKey.from_bytes(bytes(msg.from_bls_pubkey))
    except bls.BlsError as e:
        raise SignatureSetError(str(e)) from None
    return bls.SignatureSet.single_pubkey(
        bls.Signature.from_bytes(bytes(signed_change.signature)), pk, root
    )


def deposit_signature_is_valid(spec: ChainSpec, deposit_data) -> bool:
    """Deposits verify standalone against the *deposit* domain (no fork —
    compute_domain with genesis_validators_root = zero), and invalid
    signatures merely skip the deposit rather than failing the block."""
    from ..types.containers import DepositMessage
    from ..types.helpers import compute_domain

    try:
        pk = bls.PublicKey.from_bytes(bytes(deposit_data.pubkey))
    except bls.BlsError:
        return False
    domain = compute_domain(
        spec.DOMAIN_DEPOSIT, spec.genesis_fork_version, b"\x00" * 32
    )
    msg = DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    root = compute_signing_root(msg, domain)
    sig = bls.Signature.from_bytes(bytes(deposit_data.signature))
    return sig.verify(pk, root)
