"""Plain BLS signature-set verification: the reference that decides ``correct``.

One signature set is (signing keys, message, compressed signature). It is
valid when the signature decompresses to a point of G2's prime-order
subgroup, the keys aggregate to a point other than infinity, and

    e(aggregate key, H(message)) == e(g1, signature)

which is Ethereum's ``FastAggregateVerify`` (consensus-specs, BLS section;
the minimal-pubkey-size ciphersuite with the proof-of-possession DST). Each
set is judged alone, with no random linear combination and no batching:
the simplest statement of the guarantee the configurations name. Public
keys come from the registry's raw affine bytes (the benchmark made them;
a registry key is valid by construction, as a Lighthouse node's validator
pubkey cache holds only keys it has checked).

Built on the frozen pure-Python arithmetic beside this file; it imports
nothing of the program under test.
"""

from __future__ import annotations

from . import curves as oc
from .hash_to_curve import hash_to_curve_g2
from .pairing import multi_pairing_is_one

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

_NEG_G1 = oc.g1_neg(oc.g1_generator())


class HashCache:
    """H(m) once per distinct message (the reference still computes each)."""

    def __init__(self):
        self._memo: dict = {}

    def __call__(self, msg: bytes):
        h = self._memo.get(msg)
        if h is None:
            h = self._memo[msg] = hash_to_curve_g2(bytes(msg), DST)
        return h


def registry_point(raw, v: int):
    """Validator ``v``'s affine pubkey from the registry's raw [n, 96] bytes."""
    row = raw[int(v)]
    return (int.from_bytes(row[:48].tobytes(), "big"), int.from_bytes(row[48:].tobytes(), "big"))


def aggregate_keys(raw, indices):
    """Sum of the registry keys at ``indices`` (Jacobian adds, one
    normalisation); None for an empty list or a sum at infinity."""
    ops = oc.OPS_FQ
    acc = None
    for v in indices:
        p = oc._to_jac(registry_point(raw, v), ops)
        acc = p if acc is None else oc._jac_add(acc, p, ops)
    if acc is None:
        return None
    return oc._to_affine(acc, ops)


def decode_signature(sig_bytes: bytes):
    """A compressed G2 signature as a subgroup point, or None when it is
    malformed, the point at infinity, off the curve or outside the
    subgroup."""
    try:
        sig = oc.g2_decompress(bytes(sig_bytes))
    except (ValueError, AssertionError):
        return None
    if sig is None or not oc.g2_in_subgroup(sig):
        return None
    return sig


def verify_set(raw, indices, msg: bytes, sig_bytes: bytes, hashes: HashCache) -> bool:
    """The verdict of one signature set, from the inputs alone."""
    sig = decode_signature(sig_bytes)
    if sig is None:
        return False
    apk = aggregate_keys(raw, indices)
    if apk is None:
        return False
    return multi_pairing_is_one([(apk, hashes(msg)), (_NEG_G1, sig)])


def verify_group(raw, group, hashes: HashCache) -> bool:
    """A payload's verdict: every set of its group valid."""
    return all(verify_set(raw, ix, m, s, hashes) for ix, m, s in group)


def well_formed_set(raw, indices, msg: bytes, sig_bytes: bytes, hashes: HashCache) -> bool:
    """The control's judgement: the signature decodes into the subgroup and
    the keys aggregate, with the pairing equation left out. It breaks the
    guarantee that every invalid set is rejected: a signature over another
    message passes."""
    return decode_signature(sig_bytes) is not None and aggregate_keys(raw, indices) is not None


__all__ = [
    "DST", "HashCache", "aggregate_keys", "decode_signature", "registry_point",
    "verify_group", "verify_set", "well_formed_set",
]
