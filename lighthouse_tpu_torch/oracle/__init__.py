"""Pure-Python BLS12-381 oracle, the port's own copy.

``lighthouse_tpu_torch`` imports nothing of ``lighthouse_tpu``; this package
holds what the port needs of ``lighthouse_tpu/ops/bls_oracle``: the field
tower, G1/G2 arithmetic and serialization, hash-to-curve, the pairing and the
ciphersuite. Tests pin the copy against the original.
"""

from .fields import P, R, BLS_X, Fq2, Fq6, Fq12, fq_inv, fq_sqrt
from .curves import (
    g1_generator, g2_generator, g1_add, g2_add, g1_mul, g2_mul, g1_neg, g2_neg,
    g1_is_on_curve, g2_is_on_curve, g1_compress, g1_decompress, g2_compress,
    g2_decompress,
)
from .pairing import miller_loop, final_exponentiation, pairing, multi_pairing_is_one
from .hash_to_curve import hash_to_curve_g2, expand_message_xmd, hash_to_field_fq2
from .ciphersuite import (
    DST, sk_to_pk, sign, aggregate_pubkeys, aggregate_signatures,
)
