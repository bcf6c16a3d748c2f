"""KZG commitments on the port's own BLS12-381 stack: the port of
``lighthouse_tpu.kzg`` (blob commitments, proofs and batch verify with a
backend-pluggable MSM; PeerDAS cells; the device-batched cell engine)."""

from .kzg import (
    BYTES_PER_BLOB,
    BYTES_PER_COMMITMENT,
    BYTES_PER_FIELD_ELEMENT,
    BYTES_PER_PROOF,
    FIELD_ELEMENTS_PER_BLOB,
    Kzg,
    KzgError,
    VERSIONED_HASH_VERSION_KZG,
    kzg_commitment_to_versioned_hash,
)
from .setup import TrustedSetup, load as load_trusted_setup

__all__ = [
    "BYTES_PER_BLOB",
    "BYTES_PER_COMMITMENT",
    "BYTES_PER_FIELD_ELEMENT",
    "BYTES_PER_PROOF",
    "FIELD_ELEMENTS_PER_BLOB",
    "Kzg",
    "KzgError",
    "TrustedSetup",
    "VERSIONED_HASH_VERSION_KZG",
    "kzg_commitment_to_versioned_hash",
    "load_trusted_setup",
]
