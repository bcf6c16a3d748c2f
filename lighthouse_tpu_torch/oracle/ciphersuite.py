"""Ethereum BLS signature ciphersuite (oracle), trimmed to what the port needs.

BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_ — minimal-pubkey-size variant:
public keys in G1 (48 B compressed), signatures in G2 (96 B compressed). The
port's own copy of the parts of ``lighthouse_tpu/ops/bls_oracle/ciphersuite.py``
that fixtures and tests use: the DST, key derivation, signing and aggregation.
"""

from __future__ import annotations

from .curves import g1_add, g1_generator, g1_mul, g2_add, g2_mul
from .fields import R
from .hash_to_curve import hash_to_curve_g2

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# Matches blst.rs:16 — 64-bit random scalars are enough for batch soundness.
RAND_BITS = 64


def hash_to_g2(message: bytes):
    return hash_to_curve_g2(message, DST)


def sk_to_pk(sk: int):
    return g1_mul(g1_generator(), sk % R)


def sign(sk: int, message: bytes):
    return g2_mul(hash_to_g2(message), sk % R)


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
