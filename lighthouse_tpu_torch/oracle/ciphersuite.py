"""Ethereum BLS signature ciphersuite (oracle), the port's own copy.

BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_ — minimal-pubkey-size variant:
public keys in G1 (48 B compressed), signatures in G2 (96 B compressed).
A copy of ``lighthouse_tpu/ops/bls_oracle/ciphersuite.py``, the oracle twin
of Lighthouse's blst backend (``crypto/bls/src/impls/blst.rs``):

  * sign / verify / aggregate                 -> blst.rs:172-283 equivalents
  * verify_multiple_aggregate_signatures      -> blst.rs:37-119 (random linear
    combination batch verification with 64-bit scalars, RAND_BITS at blst.rs:16)
  * key validation (infinity + subgroup)      -> blst.rs:75 key_validate

Used (a) as the trusted reference for the port's kernels and fixtures, and
(b) as the CPU arm (``"oracle"``) of ``lighthouse_tpu_torch.bls``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .fields import R
from .curves import (
    g1_generator, g1_add, g1_neg, g1_mul, g1_compress, g1_decompress, g1_in_subgroup,
    g2_add, g2_mul, g2_compress, g2_decompress, g2_in_subgroup,
)
from .hash_to_curve import hash_to_curve_g2
from .pairing import multi_pairing_is_one

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# Matches blst.rs:16 — 64-bit random scalars are enough for batch soundness.
RAND_BITS = 64


def hash_to_g2(message: bytes):
    return hash_to_curve_g2(message, DST)


def keygen_from_ikm(ikm: bytes, key_info: bytes = b"") -> int:
    """RFC-style HKDF KeyGen (draft-irtf-cfrg-bls-signature-05 2.3)."""
    import hmac

    def hkdf_extract(salt, ikm_):
        return hmac.new(salt, ikm_, hashlib.sha256).digest()

    def hkdf_expand(prk, info, length):
        out, t, i = b"", b"", 1
        while len(out) < length:
            t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
            out += t
            i += 1
        return out[:length]

    if len(ikm) < 32:
        raise ValueError("IKM must be at least 32 bytes (BLS keygen spec 2.3)")
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = hkdf_extract(salt, ikm + b"\x00")
        okm = hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def sk_to_pk(sk: int):
    return g1_mul(g1_generator(), sk % R)


def sign(sk: int, message: bytes):
    return g2_mul(hash_to_g2(message), sk % R)


def pk_validate(pk) -> bool:
    """blst key_validate: not infinity, on curve, in subgroup."""
    return pk is not None and g1_in_subgroup(pk)


def sig_validate(sig, allow_infinity: bool = False) -> bool:
    if sig is None:
        return allow_infinity
    return g2_in_subgroup(sig)


def verify(pk, message: bytes, sig) -> bool:
    if not pk_validate(pk) or not sig_validate(sig):
        return False
    # e(pk, H(m)) == e(g1, sig)  <=>  e(pk, H(m)) * e(-g1, sig) == 1
    return multi_pairing_is_one(
        [(pk, hash_to_g2(message)), (g1_neg(g1_generator()), sig)]
    )


def aggregate_pubkeys(pks):
    acc = None
    for pk in pks:
        acc = g1_add(acc, pk)
    return acc


def aggregate_signatures(sigs):
    acc = None
    for s in sigs:
        acc = g2_add(acc, s)
    return acc


def fast_aggregate_verify(pks, message: bytes, sig) -> bool:
    """All signers signed the same message (Ethereum attestation aggregation)."""
    if not pks or not all(pk_validate(pk) for pk in pks) or not sig_validate(sig):
        return False
    return verify_already_validated(aggregate_pubkeys(pks), message, sig)


def aggregate_verify(pks, messages, sig) -> bool:
    """Distinct messages per signer."""
    if not pks or len(pks) != len(messages):
        return False
    if not all(pk_validate(pk) for pk in pks) or not sig_validate(sig):
        return False
    pairs = [(pk, hash_to_g2(m)) for pk, m in zip(pks, messages)]
    pairs.append((g1_neg(g1_generator()), sig))
    return multi_pairing_is_one(pairs)


def verify_already_validated(pk, message: bytes, sig) -> bool:
    if pk is None or sig is None:
        return False
    return multi_pairing_is_one(
        [(pk, hash_to_g2(message)), (g1_neg(g1_generator()), sig)]
    )


@dataclass
class SignatureSet:
    """One verification task: signature over message by (the aggregate of)
    signing_keys. Mirrors GenericSignatureSet
    (Lighthouse ``crypto/bls/src/generic_signature_set.rs:61-72``)."""

    signature: object          # G2 point or None
    signing_keys: list         # list of G1 points (pre-validated)
    message: bytes             # 32-byte signing root


def verify_signature_sets(sets: list[SignatureSet], rand_fn=None) -> bool:
    """Random-linear-combination batch verification (blst.rs:37-119 semantics).

    Check: prod_i e(r_i * agg_pk_i, H(m_i)) * e(-g1, sum_i r_i * sig_i) == 1.
    """
    if not sets:
        return False
    import secrets

    # Nonzero 64-bit scalars, matching blst's RAND_BITS draw (blst.rs:16,56-60).
    rand_fn = rand_fn or (lambda: secrets.randbits(RAND_BITS) or 1)
    pairs = []
    sig_acc = None
    for s in sets:
        if s.signature is None or not s.signing_keys:
            return False
        # Per-set signature group check (sigs_groupcheck in blst.rs:75-78).
        if not g2_in_subgroup(s.signature):
            return False
        r = rand_fn()
        agg_pk = aggregate_pubkeys(s.signing_keys)
        if agg_pk is None:
            return False
        pairs.append((g1_mul(agg_pk, r), hash_to_g2(s.message)))
        sig_acc = g2_add(sig_acc, g2_mul(s.signature, r))
    pairs.append((g1_neg(g1_generator()), sig_acc))
    return multi_pairing_is_one(pairs)


# Serialization re-exports for the API layer.
pubkey_to_bytes = g1_compress
pubkey_from_bytes = g1_decompress
signature_to_bytes = g2_compress
signature_from_bytes = g2_decompress
