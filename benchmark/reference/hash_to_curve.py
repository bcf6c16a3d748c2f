"""RFC 9380 hash-to-curve for BLS12-381 G2 (oracle).

The benchmark's frozen copy of ``lighthouse_tpu_torch/oracle/hash_to_curve.py``.

Suite BLS12381G2_XMD:SHA-256_SSWU_RO_ — the suite Ethereum's BLS signatures use
(DST fixed by the spec; see ciphersuite.py). Components:

  expand_message_xmd (SHA-256) -> hash_to_field (Fq2, m=2, L=64)
  -> simplified SWU on the 3-isogenous curve E' (A' = 240*u, B' = 1012*(1+u), Z = -(2+u))
  -> 3-isogeny map back to E2 -> cofactor clearing.

Cofactor clearing is done two independent ways (scalar-mul by h_eff, and the
psi-endomorphism method); tests assert they agree — this cross-validates the
remembered RFC constants, since neither path shares constants with the other.

Parity: Lighthouse reaches hash-to-curve inside blst via
Lighthouse ``crypto/bls/src/impls/blst.rs`` sign/verify (the HASH_OR_ENCODE
flag); it is surfaced explicitly because the device backend runs the map on the card.
"""

from __future__ import annotations

import hashlib

from .fields import P, BLS_X, Fq2
from .curves import g2_add, g2_mul

# --- expand_message_xmd --------------------------------------------------------------

_B_IN_BYTES = 32   # SHA-256 output size
_R_IN_BYTES = 64   # SHA-256 block size


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = bytes(_R_IN_BYTES)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = _sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime)
    b = [_sha256(b0 + b"\x01" + dst_prime)]
    for i in range(2, ell + 1):
        tmp = bytes(x ^ y for x, y in zip(b0, b[-1]))
        b.append(_sha256(tmp + i.to_bytes(1, "big") + dst_prime))
    return b"".join(b)[:len_in_bytes]


_L = 64  # ceil((ceil(log2(p)) + k) / 8) = ceil((381 + 128) / 8)


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int) -> list[Fq2]:
    m = 2
    uniform = expand_message_xmd(msg, dst, count * m * _L)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(m):
            off = _L * (j + i * m)
            coeffs.append(int.from_bytes(uniform[off : off + _L], "big") % P)
        out.append(Fq2(coeffs[0], coeffs[1]))
    return out


# --- simplified SWU on E': y^2 = x^3 + A'x + B' --------------------------------------

ISO_A = Fq2(0, 240)
ISO_B = Fq2(1012, 1012)
SSWU_Z = Fq2(P - 2, P - 1)  # -(2 + u)


def _inv0(a: Fq2) -> Fq2:
    return Fq2(0, 0) if a.is_zero() else a.inv()


def map_to_curve_sswu(u: Fq2):
    """Simplified SWU for AB != 0 (RFC 9380 6.6.2). Returns a point on E'."""
    u2 = u.square()
    tv1 = _inv0(SSWU_Z.square() * u2.square() + SSWU_Z * u2)
    x1 = (-ISO_B) * ISO_A.inv() * (Fq2.ONE + tv1)
    if tv1.is_zero():
        x1 = ISO_B * (SSWU_Z * ISO_A).inv()
    gx1 = (x1.square() + ISO_A) * x1 + ISO_B
    x2 = SSWU_Z * u2 * x1
    gx2 = (x2.square() + ISO_A) * x2 + ISO_B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x, y = x2, gx2.sqrt()
        assert y is not None, "SSWU: gx2 must be square when gx1 is not"
    if u.sgn0() != y.sgn0():
        y = -y
    return (x, y)


def is_on_iso_curve(p) -> bool:
    x, y = p
    return y.square() == (x.square() + ISO_A) * x + ISO_B


# --- 3-isogeny map E' -> E2 (RFC 9380 appendix E.3 constants) ------------------------

_K = {
    "x_num": [
        Fq2(0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
            0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6),
        Fq2(0,
            0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A),
        Fq2(0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
            0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D),
        Fq2(0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
            0),
    ],
    "x_den": [
        Fq2(0,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63),
        Fq2(0xC,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
        Fq2.ONE,
    ],
    "y_num": [
        Fq2(0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
            0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706),
        Fq2(0,
            0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE),
        Fq2(0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
            0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F),
        Fq2(0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
            0),
    ],
    "y_den": [
        Fq2(0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB),
        Fq2(0,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3),
        Fq2(0x12,
            0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99),
        Fq2.ONE,
    ],
}


def _horner(coeffs: list[Fq2], x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def iso_map(p):
    """Apply the 3-isogeny E' -> E2."""
    x, y = p
    x_num = _horner(_K["x_num"], x)
    x_den = _horner(_K["x_den"], x)
    y_num = _horner(_K["y_num"], x)
    y_den = _horner(_K["y_den"], x)
    return (x_num * x_den.inv(), y * y_num * y_den.inv())


# --- cofactor clearing ---------------------------------------------------------------

# h_eff for G2 (RFC 9380 8.8.2).
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def clear_cofactor_h_eff(p):
    return g2_mul(p, H_EFF)


# psi endomorphism, computed through untwist -> frobenius -> twist so that no new
# constants are introduced (self-validating against the pairing tower).
def _psi_constants():
    from .pairing import _W  # local import to avoid cycle at module load
    w2 = _W * _W
    w3 = w2 * _W
    # untwist: X = x * w^-2 ; frobenius: X^p ; twist back: * w^2
    # psi(x, y) = (conj(x) * cx, conj(y) * cy) with:
    cx12 = w2.frobenius(1).inv() * w2  # w^2 / (w^2)^p ... as Fq12; must be Fq2-rational
    cy12 = w3.frobenius(1).inv() * w3
    def extract_fq2(a):
        # assert only the c0.c0 Fq2 coefficient is populated
        assert a.c0.c1.is_zero() and a.c0.c2.is_zero() and a.c1.is_zero(), a
        return a.c0.c0
    return extract_fq2(cx12), extract_fq2(cy12)


_PSI_CX, _PSI_CY = None, None


def psi(p):
    """The untwist-Frobenius-twist endomorphism on E2."""
    global _PSI_CX, _PSI_CY
    if _PSI_CX is None:
        _PSI_CX, _PSI_CY = _psi_constants()
    if p is None:
        return None
    x, y = p
    return (x.conjugate() * _PSI_CX, y.conjugate() * _PSI_CY)


def clear_cofactor_psi(p):
    """Budroni-Pintore fast clearing: [x^2-x-1]P + [x-1]psi(P) + psi^2(2P)."""
    x = BLS_X
    t = g2_add(g2_mul(p, x * x - x - 1), g2_mul(psi(p), x - 1))
    return g2_add(t, psi(psi(g2_mul(p, 2))))


# --- full hash_to_curve --------------------------------------------------------------

def hash_to_curve_g2(msg: bytes, dst: bytes):
    u0, u1 = hash_to_field_fq2(msg, dst, 2)
    q0 = iso_map(map_to_curve_sswu(u0))
    q1 = iso_map(map_to_curve_sswu(u1))
    return clear_cofactor_psi(g2_add(q0, q1))
