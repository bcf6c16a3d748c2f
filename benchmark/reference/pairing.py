"""Optimal-ate pairing on BLS12-381 (oracle).

The benchmark's frozen copy of ``lighthouse_tpu_torch/oracle/pairing.py``.

Strategy (correctness over speed): untwist G2 points into E(Fq12) and run a plain
affine Miller loop with denominator elimination, then a final exponentiation.
Two final-exponentiation routines are provided:

  * ``final_exponentiation``      — easy part + hard part via the x-addition chain,
                                    computing f^(3*(p^4-p^2+1)/r). The factor 3 is
                                    harmless for every pairing *check* (gcd(3, r) = 1),
                                    and is what blst-style implementations use.
  * ``final_exponentiation_naive`` — literal f^((p^12-1)/r) by square-and-multiply;
                                    used in tests to cross-check the chain.

Parity target: the pairing entry points used by
Lighthouse ``crypto/bls/src/impls/blst.rs:37-119`` (verify_multiple_aggregate_
signatures) and ``generic_signature.rs`` verify.
"""

from __future__ import annotations

from .fields import P, R, BLS_X, Fq2, Fq6, Fq12
from .curves import g1_is_on_curve, g2_is_on_curve

# w^2 = v: untwist divides x by w^2 = v and y by w^3 = v*w.
# x' in Fq2 embeds at position c0 of Fq6 coefficient; easier: work with generic Fq12.


def _fq12_from_fq(a: int) -> Fq12:
    return Fq12(Fq6(Fq2(a, 0), Fq2.ZERO, Fq2.ZERO), Fq6.ZERO)


def _fq12_from_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.ZERO, Fq2.ZERO), Fq6.ZERO)


# w = (0, 1) in the (c0, c1) Fq6 decomposition: w = 0 + 1*w.
_W = Fq12(Fq6.ZERO, Fq6.ONE)
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


def untwist(q):
    """Map a G2 point (over Fq2) to E(Fq12): (x/w^2, y/w^3)."""
    if q is None:
        return None
    x, y = q
    return (_fq12_from_fq2(x) * _W2_INV, _fq12_from_fq2(y) * _W3_INV)


def _line(p1, p2, t):
    """Evaluate the line through p1 and p2 (or tangent if equal) at point t.
    All points affine over Fq12. Denominators are omitted (killed by the final
    exponentiation since the embedding degree is even)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 == x2):
        # chord
        lam_num = y2 - y1
        lam_den = x2 - x1
    elif y1 == y2:
        # tangent
        three = _fq12_from_fq(3)
        two = _fq12_from_fq(2)
        lam_num = three * x1 * x1
        lam_den = two * y1
    else:
        # vertical
        return (xt - x1, Fq12.ONE)
    # l(t) = lam*(xt - x1) - (yt - y1); return (numerator, denominator) lazily
    return (lam_num * (xt - x1) - lam_den * (yt - y1), lam_den)


def _ec_double(p):
    x, y = p
    lam = _fq12_from_fq(3) * x * x * (_fq12_from_fq(2) * y).inv()
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    return (x3, y3)


def _ec_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _ec_double(p)
        return None
    lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(p, q) -> Fq12:
    """Miller loop for e(P, Q): P in G1 (affine over Fq), Q in G2 (affine over Fq2).

    Returns the unreduced pairing value; apply final_exponentiation to obtain the
    pairing. Infinity in either argument yields one.
    """
    if p is None or q is None:
        return Fq12.ONE
    assert g1_is_on_curve(p) and g2_is_on_curve(q)
    pe = (_fq12_from_fq(p[0]), _fq12_from_fq(p[1]))
    qe = untwist(q)
    t = qe
    f_num = Fq12.ONE
    f_den = Fq12.ONE
    x_abs = -BLS_X
    for bit in bin(x_abs)[3:]:  # MSB already consumed (t starts at Q)
        ln, ld = _line(t, t, pe)
        f_num = f_num * f_num * ln
        f_den = f_den * f_den * ld
        t = _ec_double(t)
        if bit == "1":
            ln, ld = _line(t, qe, pe)
            f_num = f_num * ln
            f_den = f_den * ld
            t = _ec_add(t, qe)
    f = f_num * f_den.inv()
    # x < 0: conjugate (equivalent to inversion after the easy part).
    return f.conjugate()


# ------------------------------------------------------------------------------
# Final exponentiation
# ------------------------------------------------------------------------------

def _cyclotomic_exp_abs_x(f: Fq12) -> Fq12:
    """f^|x| using cyclotomic squarings (f must be in the cyclotomic subgroup)."""
    x_abs = -BLS_X
    res = Fq12.ONE
    started = False
    for bit in bin(x_abs)[2:]:
        if started:
            res = res.cyclotomic_square()
        if bit == "1":
            res = res * f if started else f
            started = True
    return res


def _exp_x_minus_1(f: Fq12) -> Fq12:
    """f^(|x|+1)?? No: f^(x-1) with x negative = conj(f^(|x|+1))."""
    # x - 1 = -(|x| + 1)
    fx = _cyclotomic_exp_abs_x(f)  # f^|x|
    return (fx * f).conjugate()


def final_exponentiation(f: Fq12) -> Fq12:
    """Easy part then hard part computing f^(3*(p^4-p^2+1)/r).

    Uses 3*(p^4-p^2+1)/r = (x-1)^2 * (x+p) * (x^2+p^2-1) + 3.
    """
    # Easy part: f^((p^6-1)(p^2+1))
    f = f.conjugate() * f.inv()           # f^(p^6 - 1)
    f = f.frobenius(2) * f                # ^(p^2 + 1); now f is cyclotomic
    # Hard part
    m1 = _exp_x_minus_1(f)                # f^(x-1)
    m2 = _exp_x_minus_1(m1)               # f^((x-1)^2)
    # ^(x+p): m3 = m2^x * m2^p
    m2x = _cyclotomic_exp_abs_x(m2).conjugate()   # m2^x (x negative)
    m3 = m2x * m2.frobenius(1)
    # ^(x^2+p^2-1): m4 = m3^(x^2) * m3^(p^2) * m3^(-1)
    m3x = _cyclotomic_exp_abs_x(m3).conjugate()
    m3x2 = _cyclotomic_exp_abs_x(m3x).conjugate()
    m4 = m3x2 * m3.frobenius(2) * m3.conjugate()  # conjugate = inverse (cyclotomic)
    return m4 * f * f * f


def final_exponentiation_naive(f: Fq12) -> Fq12:
    return f.pow((P ** 12 - 1) // R)


def pairing(p, q) -> Fq12:
    """Reduced pairing e(P, Q)^3 (the cube is consistent across all uses)."""
    return final_exponentiation(miller_loop(p, q))


def multi_pairing_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 with a single final exponentiation."""
    acc = Fq12.ONE
    for p, q in pairs:
        acc = acc * miller_loop(p, q)
    return final_exponentiation(acc).is_one()
