"""BLS12-381 G1/G2 group arithmetic + ZCash-format serialization (oracle).

The benchmark's frozen copy of ``lighthouse_tpu_torch/oracle/curves.py``.

Parity targets in Lighthouse:
  - point types / compression: Lighthouse ``crypto/bls/src/generic_public_key.rs``
    (48-byte compressed G1 pubkeys) and ``generic_signature.rs`` (96-byte compressed
    G2 signatures).
  - subgroup checks: blst's ``key_validate`` / sig group-check behavior used at
    Lighthouse ``crypto/bls/src/impls/blst.rs:75``.

Points are affine (x, y) with a separate infinity flag; hot loops use Jacobian
coordinates internally. Fq elements are Python ints, Fq2 elements `fields.Fq2`.
"""

from __future__ import annotations

from .fields import P, R, Fq2, fq_inv, fq_sqrt

# Curve coefficients: E1: y^2 = x^3 + 4;  E2: y^2 = x^3 + 4(u+1).
B1 = 4
B2 = Fq2(4, 4)

# Generators (spec constants).
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = Fq2(
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = Fq2(
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

INF = None  # affine representation of the point at infinity


# --------------------------------------------------------------------------------------
# Generic affine/Jacobian arithmetic, parameterized by the field.
# Field ops are dispatched through small helper lambdas so the same code serves
# Fq (ints) and Fq2.
# --------------------------------------------------------------------------------------

class _Ops:
    """Field operation table for int (Fq) or Fq2 elements."""

    def __init__(self, is_fq2: bool):
        if is_fq2:
            self.add = lambda a, b: a + b
            self.sub = lambda a, b: a - b
            self.mul = lambda a, b: a * b
            self.sqr = lambda a: a.square()
            self.neg = lambda a: -a
            self.inv = lambda a: a.inv()
            self.eq = lambda a, b: a == b
            self.zero = Fq2.ZERO
            self.one = Fq2.ONE
            self.is_zero = lambda a: a.is_zero()
        else:
            self.add = lambda a, b: (a + b) % P
            self.sub = lambda a, b: (a - b) % P
            self.mul = lambda a, b: (a * b) % P
            self.sqr = lambda a: (a * a) % P
            self.neg = lambda a: (-a) % P
            self.inv = fq_inv
            self.eq = lambda a, b: a % P == b % P
            self.zero = 0
            self.one = 1
            self.is_zero = lambda a: a % P == 0


OPS_FQ = _Ops(False)
OPS_FQ2 = _Ops(True)


def _jac_double(p, ops):
    """Jacobian doubling (a = 0 curve)."""
    if p is None:
        return None
    x, y, z = p
    if ops.is_zero(y):
        return None
    a = ops.sqr(x)
    b = ops.sqr(y)
    c = ops.sqr(b)
    d = ops.sub(ops.sqr(ops.add(x, b)), ops.add(a, c))
    d = ops.add(d, d)
    e = ops.add(ops.add(a, a), a)
    f = ops.sqr(e)
    x3 = ops.sub(f, ops.add(d, d))
    c8 = ops.add(ops.add(c, c), ops.add(c, c))
    c8 = ops.add(c8, c8)
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), c8)
    z3 = ops.mul(ops.add(y, y), z)
    return (x3, y3, z3)


def _jac_add(p, q, ops):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = ops.sqr(z1)
    z2z2 = ops.sqr(z2)
    u1 = ops.mul(x1, z2z2)
    u2 = ops.mul(x2, z1z1)
    s1 = ops.mul(ops.mul(y1, z2), z2z2)
    s2 = ops.mul(ops.mul(y2, z1), z1z1)
    if ops.eq(u1, u2):
        if ops.eq(s1, s2):
            return _jac_double(p, ops)
        return None
    h = ops.sub(u2, u1)
    i = ops.sqr(ops.add(h, h))
    j = ops.mul(h, i)
    rr = ops.add(ops.sub(s2, s1), ops.sub(s2, s1))
    v = ops.mul(u1, i)
    x3 = ops.sub(ops.sub(ops.sqr(rr), j), ops.add(v, v))
    s1j = ops.mul(s1, j)
    y3 = ops.sub(ops.mul(rr, ops.sub(v, x3)), ops.add(s1j, s1j))
    z3 = ops.mul(ops.sub(ops.sqr(ops.add(z1, z2)), ops.add(z1z1, z2z2)), h)
    return (x3, y3, z3)


def _to_jac(p, ops):
    return None if p is None else (p[0], p[1], ops.one)


def _to_affine(p, ops):
    if p is None:
        return None
    x, y, z = p
    zi = ops.inv(z)
    zi2 = ops.sqr(zi)
    return (ops.mul(x, zi2), ops.mul(y, ops.mul(zi2, zi)))


def _mul(p, k: int, ops):
    """Scalar multiplication (double-and-add, MSB first)."""
    if k < 0:
        p = _neg_affine(p, ops)
        k = -k
    acc = None
    pj = _to_jac(p, ops)
    for bit in bin(k)[2:] if k else "":
        acc = _jac_double(acc, ops)
        if bit == "1":
            acc = _jac_add(acc, pj, ops)
    return _to_affine(acc, ops)


def _add_affine(p, q, ops):
    return _to_affine(_jac_add(_to_jac(p, ops), _to_jac(q, ops), ops), ops)


def _neg_affine(p, ops):
    return None if p is None else (p[0], ops.neg(p[1]))


# --------------------------------------------------------------------------------------
# G1 (over Fq)
# --------------------------------------------------------------------------------------

def g1_generator():
    return (G1_X, G1_Y)


def g1_add(p, q):
    return _add_affine(p, q, OPS_FQ)


def g1_neg(p):
    return _neg_affine(p, OPS_FQ)


def g1_mul(p, k: int):
    return _mul(p, k, OPS_FQ)


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + B1)) % P == 0


def g1_in_subgroup(p) -> bool:
    return g1_is_on_curve(p) and g1_mul(p, R) is None


def g1_msm(points, scalars):
    """Naive multi-scalar multiplication (oracle only)."""
    acc = None
    for pt, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(pt, s))
    return acc


# --------------------------------------------------------------------------------------
# G2 (over Fq2)
# --------------------------------------------------------------------------------------

def g2_generator():
    return (G2_X, G2_Y)


def g2_add(p, q):
    return _add_affine(p, q, OPS_FQ2)


def g2_neg(p):
    return _neg_affine(p, OPS_FQ2)


def g2_mul(p, k: int):
    return _mul(p, k, OPS_FQ2)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y.square() == x.square() * x + B2


def g2_in_subgroup(p) -> bool:
    return g2_is_on_curve(p) and g2_mul(p, R) is None


# --------------------------------------------------------------------------------------
# Serialization — ZCash/Ethereum compressed format.
#   G1: 48 bytes big-endian x | flags in top 3 bits of byte 0.
#   G2: 96 bytes: x.c1 (48B, flagged) || x.c0 (48B).
#   flags: bit7 compression=1, bit6 infinity, bit5 y-sign (lexicographically largest).
# --------------------------------------------------------------------------------------

_HALF_P = (P - 1) // 2


def g1_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0]) + bytes(47)
    x, y = p
    flags = 0x80 | (0x20 if y > _HALF_P else 0)
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g1_decompress(data: bytes):
    """Returns the affine point, or raises ValueError on invalid encoding.
    Performs on-curve check; subgroup check is the caller's responsibility
    (mirroring blst's split between deserialize and key_validate)."""
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    c_flag = (data[0] >> 7) & 1
    i_flag = (data[0] >> 6) & 1
    s_flag = (data[0] >> 5) & 1
    if not c_flag:
        raise ValueError("uncompressed flag on compressed input")
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if i_flag:
        if x != 0 or s_flag:
            raise ValueError("invalid infinity encoding")
        return None
    if x >= P:
        raise ValueError("x >= p")
    y = fq_sqrt((x * x * x + B1) % P)
    if y is None:
        raise ValueError("x not on curve")
    if (y > _HALF_P) != bool(s_flag):
        y = P - y
    return (x, y)


def g2_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0]) + bytes(95)
    x, y = p
    # sign: lexicographically largest comparing c1 then c0
    if y.c1 != 0:
        sign = y.c1 > _HALF_P
    else:
        sign = y.c0 > _HALF_P
    flags = 0x80 | (0x20 if sign else 0)
    b = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g2_decompress(data: bytes):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    c_flag = (data[0] >> 7) & 1
    i_flag = (data[0] >> 6) & 1
    s_flag = (data[0] >> 5) & 1
    if not c_flag:
        raise ValueError("uncompressed flag on compressed input")
    x_c1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x_c0 = int.from_bytes(data[48:], "big")
    if i_flag:
        if x_c0 != 0 or x_c1 != 0 or s_flag:
            raise ValueError("invalid infinity encoding")
        return None
    if x_c0 >= P or x_c1 >= P:
        raise ValueError("x >= p")
    x = Fq2(x_c0, x_c1)
    y = (x.square() * x + B2).sqrt()
    if y is None:
        raise ValueError("x not on curve")
    if y.c1 != 0:
        sign = y.c1 > _HALF_P
    else:
        sign = y.c0 > _HALF_P
    if sign != bool(s_flag):
        y = -y
    return (x, y)
