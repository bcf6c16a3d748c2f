"""Trusted-setup loading: the port's copy of ``lighthouse_tpu/kzg/setup.py``.

``setup_mainnet.bin`` (a byte-for-byte copy of the reference package's file)
is the public KZG ceremony output, stored as decompressed affine
coordinates with every point validated when it was converted.

Layout: ``KZGS`` magic + u32 counts (lagrange, monomial, g2), then raw
big-endian affine coords — G1 as x||y (96B), G2 as x.c0||x.c1||y.c0||y.c1
(192B). Lagrange points are stored in natural index order; ``load()``
applies the bit-reversal permutation so they align with the bit-reversed
evaluation domain (spec ``load_trusted_setup``).
"""

from __future__ import annotations

import functools
import os
import struct

from .fr import bit_reversal_permutation

_BIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "setup_mainnet.bin")


class TrustedSetup:
    def __init__(self, g1_lagrange_brp, g1_monomial, g2_monomial):
        self.g1_lagrange_brp = g1_lagrange_brp  # oracle affine, brp order
        self.g1_monomial = g1_monomial
        self.g2_monomial = g2_monomial

    @property
    def field_elements_per_blob(self) -> int:
        return len(self.g1_lagrange_brp)


def insecure_setup(n: int, tau: int = 0x1234ABCD, n_g2: int = 2) -> TrustedSetup:
    """TEST ONLY: a setup with known tau at domain size ``n``.

    Lets the full commit/prove/verify cycle run at small blob sizes. L_i(tau)
    is computed in Fr via the barycentric form, so the Lagrange points are
    exactly consistent with the monomial points — the same invariant the
    ceremony output satisfies."""
    from ..oracle import curves as oc
    from ..oracle.fields import R
    from .fr import compute_roots_of_unity

    g1, g2 = oc.g1_generator(), oc.g2_generator()
    roots_brp = compute_roots_of_unity(n)
    zn = (pow(tau, n, R) - 1) % R
    inv_n = pow(n, R - 2, R)
    lagrange_brp = [
        oc.g1_mul(g1, zn * w % R * pow((tau - w) % R, R - 2, R) % R * inv_n % R)
        for w in roots_brp
    ]
    monomial = [oc.g1_mul(g1, pow(tau, i, R)) for i in range(n)]
    # cell proofs pair against [tau^k]_2, so setups can carry more G2 powers
    # (the ceremony output ships 65 for exactly this reason)
    g2s = [oc.g2_mul(g2, pow(tau, i, R)) for i in range(max(2, n_g2))]
    return TrustedSetup(lagrange_brp, monomial, g2s)


@functools.lru_cache(maxsize=1)
def load() -> TrustedSetup:
    from ..oracle.fields import Fq2

    with open(_BIN, "rb") as fh:
        raw = fh.read()
    magic, n_lag, n_mono, n_g2 = struct.unpack_from("<4sIII", raw)
    if magic != b"KZGS":
        raise ValueError("bad trusted setup file")
    off = 16

    def g1(o):
        x = int.from_bytes(raw[o : o + 48], "big")
        y = int.from_bytes(raw[o + 48 : o + 96], "big")
        return (x, y)

    def g2(o):
        c = [int.from_bytes(raw[o + i * 48 : o + (i + 1) * 48], "big") for i in range(4)]
        return (Fq2(c[0], c[1]), Fq2(c[2], c[3]))

    lag = [g1(off + i * 96) for i in range(n_lag)]
    off += n_lag * 96
    mono = [g1(off + i * 96) for i in range(n_mono)]
    off += n_mono * 96
    g2s = [g2(off + i * 192) for i in range(n_g2)]
    return TrustedSetup(bit_reversal_permutation(lag), mono, g2s)
