"""Scalar-field (Fr) helpers for KZG: roots of unity, bit-reversal order,
barycentric evaluation with batched inversion. The port's copy of
``lighthouse_tpu/kzg/fr.py`` (host Python, over the port's ``oracle``).

The blob polynomial lives in *evaluation form* on the 4096th roots of unity
in bit-reversal permutation, per the consensus spec's polynomial-commitments
scheme that the reference wraps via c-kzg (crypto/kzg/src/lib.rs:14-20).
"""

from __future__ import annotations

from ..oracle.fields import R as BLS_MODULUS

BYTES_PER_FIELD_ELEMENT = 32
PRIMITIVE_ROOT_OF_UNITY = 7


def bytes_to_bls_field(b: bytes) -> int:
    """Big-endian 32-byte scalar; must be canonical (< r)."""
    if len(b) != BYTES_PER_FIELD_ELEMENT:
        raise ValueError(f"field element must be 32 bytes, got {len(b)}")
    v = int.from_bytes(b, "big")
    if v >= BLS_MODULUS:
        raise ValueError("non-canonical field element")
    return v


def bls_field_to_bytes(v: int) -> bytes:
    return int(v % BLS_MODULUS).to_bytes(32, "big")


def hash_to_bls_field(data: bytes) -> int:
    from hashlib import sha256

    return int.from_bytes(sha256(data).digest(), "big") % BLS_MODULUS


def bit_reversal_permutation(seq):
    n = len(seq)
    bits = n.bit_length() - 1
    assert 1 << bits == n, "length must be a power of two"
    return [seq[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)]


def compute_roots_of_unity(order: int) -> list[int]:
    """Bit-reversed list of the ``order``-th roots of unity."""
    assert (BLS_MODULUS - 1) % order == 0
    w = pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // order, BLS_MODULUS)
    roots, acc = [], 1
    for _ in range(order):
        roots.append(acc)
        acc = acc * w % BLS_MODULUS
    return bit_reversal_permutation(roots)


def batch_inverse(values: list[int]) -> list[int]:
    """Montgomery's trick: n inversions for one modexp + 3n mulmods."""
    r = BLS_MODULUS
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        if v % r == 0:
            raise ZeroDivisionError("batch_inverse: zero element")
        prefix[i + 1] = prefix[i] * v % r
    inv_all = pow(prefix[-1], r - 2, r)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % r
        inv_all = inv_all * values[i] % r
    return out


def evaluate_polynomial_in_evaluation_form(
    poly: list[int], z: int, roots: list[int]
) -> int:
    """Barycentric formula: f(z) = (z^N - 1)/N * sum f_i * w_i / (z - w_i),
    with the exact-evaluation special case when z is one of the roots."""
    r = BLS_MODULUS
    n = len(poly)
    if z in roots:
        return poly[roots.index(z)]
    diffs = [(z - w) % r for w in roots]
    inv_diffs = batch_inverse(diffs)
    total = 0
    for f, w, inv in zip(poly, roots, inv_diffs):
        total = (total + f * w % r * inv) % r
    zn = pow(z, n, r)
    return total * (zn - 1) % r * pow(n, r - 2, r) % r
