"""BLS12-381 field tower arithmetic over Python integers: the benchmark's
frozen copy of the pure-Python oracle (``lighthouse_tpu_torch/oracle/fields.py``
as of the benchmark's first commit), kept here so that the yardstick that
decides ``correct`` shares no code with the program it judges.

Tower construction (standard for BLS12-381):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - (u + 1))
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

# Base field modulus (public spec constant).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order (scalar field modulus).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative; |x| has Hamming weight 6).
BLS_X = -0xD201000000010000


def fq_inv(a: int) -> int:
    return pow(a % P, P - 2, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p = 3 mod 4). Returns None if a is not a QR."""
    a %= P
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a else None


class Fq2:
    """c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    ZERO: "Fq2"
    ONE: "Fq2"

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
        return Fq2(
            self.c0 * o.c0 - self.c1 * o.c1,
            self.c0 * o.c1 + self.c1 * o.c0,
        )

    __rmul__ = __mul__

    def square(self):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        return Fq2((self.c0 + self.c1) * (self.c0 - self.c1), 2 * self.c0 * self.c1)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def mul_by_nonresidue(self):
        """Multiply by (u + 1), the Fq6 non-residue."""
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def inv(self):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        t = fq_inv(self.c0 * self.c0 + self.c1 * self.c1)
        return Fq2(self.c0 * t, -self.c1 * t)

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fq2.ONE, self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 (RFC 9380 style for q = 9 mod 16 ... BLS12-381 uses
        the p = 3 mod 4 complex-method algorithm)."""
        if self.is_zero():
            return Fq2(0, 0)
        # Algorithm (p = 3 mod 4): a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0.
        a1 = self.pow((P - 3) // 4)
        x0 = a1 * self
        alpha = a1 * x0
        if alpha == Fq2(P - 1, 0):
            cand = Fq2(-x0.c1, x0.c0)  # u * x0
        else:
            b = (alpha + Fq2.ONE).pow((P - 1) // 2)
            cand = b * x0
        return cand if cand.square() == self else None

    def sgn0(self) -> int:
        """RFC 9380 sign of an Fq2 element."""
        s0 = self.c0 & 1
        z0 = self.c0 == 0
        s1 = self.c1 & 1
        return s0 | (z0 & s1)

    def __repr__(self):
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"


Fq2.ZERO = Fq2(0, 0)
Fq2.ONE = Fq2(1, 0)

# Frobenius coefficient for Fq2 -> handled by conjugate().

# Frobenius coefficients: for the power-k map the v / v^2 / w coefficients are
# (u+1)^((p^k-1)/3), (u+1)^(2(p^k-1)/3), (u+1)^((p^k-1)/6). We store the power-1
# constants and realize higher powers by composing the power-1 map.
_FROB_FQ6_C1_1 = Fq2(1, 1).pow((P - 1) // 3)
_FROB_FQ6_C2_1 = Fq2(1, 1).pow(2 * (P - 1) // 3)
_FROB_FQ12_C1_1 = Fq2(1, 1).pow((P - 1) // 6)


class Fq6:
    """c0 + c1*v + c2*v^2 with v^3 = u + 1."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    ZERO: "Fq6"
    ONE: "Fq6"

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fq2):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        """Multiply by v (for the Fq12 tower)."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + (a2 * t1 + a1 * t2).mul_by_nonresidue()
        dinv = denom.inv()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def _frobenius1(self):
        return Fq6(
            self.c0.conjugate(),
            self.c1.conjugate() * _FROB_FQ6_C1_1,
            self.c2.conjugate() * _FROB_FQ6_C2_1,
        )

    def frobenius(self, power: int):
        out = self
        for _ in range(power % 6):
            out = out._frobenius1()
        return out

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"


Fq6.ZERO = Fq6(Fq2.ZERO, Fq2.ZERO, Fq2.ZERO)
Fq6.ONE = Fq6(Fq2.ONE, Fq2.ZERO, Fq2.ZERO)


def _frob_fq2(a: Fq2, power: int) -> Fq2:
    return a if power % 2 == 0 else a.conjugate()


class Fq12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    ZERO: "Fq12"
    ONE: "Fq12"

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_nonresidue()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        a0, a1 = self.c0, self.c1
        t0 = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t0 - t0.mul_by_nonresidue()
        return Fq12(c0, t0 + t0)

    def conjugate(self):
        """The p^6 Frobenius: negate the w coefficient."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def _frobenius1(self):
        c0 = self.c0._frobenius1()
        c1 = self.c1._frobenius1()
        c1 = Fq6(c1.c0 * _FROB_FQ12_C1_1, c1.c1 * _FROB_FQ12_C1_1, c1.c2 * _FROB_FQ12_C1_1)
        return Fq12(c0, c1)

    def frobenius(self, power: int):
        out = self
        for _ in range(power % 12):
            out = out._frobenius1()
        return out

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fq12.ONE, self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def cyclotomic_square(self):
        """Granger-Scott squaring for elements of the cyclotomic subgroup
        (norm 1 after the easy part of the final exponentiation)."""
        # Decompose into Fq4 pieces: (c0.c0, c1.c1), (c1.c0, c0.c2), (c0.c1, c1.c2)
        z0, z4, z3, z2, z1, z5 = (
            self.c0.c0, self.c0.c1, self.c0.c2, self.c1.c0, self.c1.c1, self.c1.c2,
        )

        def fq4_square(a: Fq2, b: Fq2):
            t0 = a.square()
            t1 = b.square()
            return t1.mul_by_nonresidue() + t0, (a + b).square() - t0 - t1

        t0, t1 = fq4_square(z0, z1)
        t2, t3 = fq4_square(z2, z3)
        t4, t5 = fq4_square(z4, z5)
        z0 = (t0 - z0) * 2 + t0
        z1 = (t1 + z1) * 2 + t1
        z2 = (t5.mul_by_nonresidue() + z2) * 2 + t5.mul_by_nonresidue()
        z3 = (t4 - z3) * 2 + t4
        z4 = (t2 - z4) * 2 + t2
        z5 = (t3 + z5) * 2 + t3
        return Fq12(Fq6(z0, z4, z3), Fq6(z2, z1, z5))

    def is_one(self):
        return self == Fq12.ONE

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"


Fq12.ZERO = Fq12(Fq6.ZERO, Fq6.ZERO)
Fq12.ONE = Fq12(Fq6.ONE, Fq6.ZERO)
