"""Hash-to-curve G2 (RFC 9380, suite BLS12381G2_XMD:SHA-256_SSWU_RO_).

Port of ``lighthouse_tpu/ops/bls/h2c.py``. ``hash_to_field_batch`` is host
SHA-256; everything algebraic — simplified SWU on the 3-isogenous curve in
fraction form, the 3-isogeny, Budroni–Pintore cofactor clearing — runs
branchless on the device over the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve, fq, g2, plans, tower
from ...oracle import hash_to_curve as _oh
from ...oracle.fields import BLS_X, Fq2


def hash_to_field_batch(msgs: list[bytes], dst: bytes, device):
    """[n messages] -> (u0, u1) fq2 tensors [n, 2, 25] each (canonical)."""
    u0s, u1s = [], []
    for m in msgs:
        u0, u1 = _oh.hash_to_field_fq2(m, dst, 2)
        u0s.append([fq.int_to_limbs(u0.c0), fq.int_to_limbs(u0.c1)])
        u1s.append([fq.int_to_limbs(u1.c0), fq.int_to_limbs(u1.c1)])
    return (
        torch.from_numpy(np.array(u0s, dtype=np.int64).reshape(len(msgs), 2, fq.NLIMBS)).to(device),
        torch.from_numpy(np.array(u1s, dtype=np.int64).reshape(len(msgs), 2, fq.NLIMBS)).to(device),
    )


def _c2(v: Fq2) -> np.ndarray:
    return np.stack([fq.int_to_limbs(v.c0), fq.int_to_limbs(v.c1)])


_A = _c2(_oh.ISO_A)
_B = _c2(_oh.ISO_B)
_Z = _c2(_oh.SSWU_Z)
_ZERO2 = np.zeros((2, fq.NLIMBS), dtype=np.int64)

_KX_NUM = [_c2(k) for k in _oh._K["x_num"]]
_KX_DEN = [_c2(k) for k in _oh._K["x_den"]]
_KY_NUM = [_c2(k) for k in _oh._K["y_num"]]
_KY_DEN = [_c2(k) for k in _oh._K["y_den"]]


def _bc(c: np.ndarray, like):
    return fq.dconst(c, like).expand(like.shape[:-2] + (2, fq.NLIMBS))


def map_to_curve_sswu_fraction(u):
    """u [..., 2, 25] (canonical) -> (xn, xd, y): x = xn/xd on E', y exact;
    one sqrt_ratio chain serves both SWU candidates."""
    A_M = _bc(_A, u)
    B_M = _bc(_B, u)
    u2 = tower.fq2_sqr(u)
    tv1 = tower.fq2_mul(_bc(_Z, u), u2)
    tv2 = plans.carry_norm(tower.fq2_sqr(tv1) + tv1)
    tv2_nz = ~tower.t_is_zero(tv2)
    one = tower.one_like(2, u)
    tv3 = tower.fq2_mul(B_M, plans.carry_norm(tv2 + one))
    neg_tv2 = plans.carry_norm(tower.fq2_neg(tv2))
    tv4 = tower.fq2_mul(A_M, tower.t_select(tv2_nz, neg_tv2, _bc(_Z, u)))
    tv3s, tv4s = tower.fq2_mul_many([(tv3, tv3), (tv4, tv4)])
    tv3c, tv4c, t34 = tower.fq2_mul_many([(tv3s, tv3), (tv4s, tv4), (tv4s, tv3)])
    a34, b4c = tower.fq2_mul_many([(t34, A_M), (tv4c, B_M)])
    gx1_num = plans.carry_norm(tv3c + a34 + b4c)
    is_sq, y1 = tower.fq2_sqrt_ratio(gx1_num, tv4c)
    t1u = tower.fq2_mul(tv1, u)
    y2, x2n = tower.fq2_mul_many([(t1u, y1), (tv1, tv3)])
    xn = tower.t_select(is_sq, tv3, x2n)
    y = tower.t_select(is_sq, y1, y2)
    flip = tower.fq2_sgn0_canon(u) != tower.fq2_sgn0(y)
    y = plans.carry_norm(tower.t_select(flip, tower.fq2_neg(y), y))
    return xn, tv4, y


def iso_map_fraction(xn, xd, y):
    """E' point with x = xn/xd and exact y -> projective E2 point [..., 6, 25]
    (homogenized Horner levels, each level one stacked fq2_mul_many)."""
    tables = [_KX_NUM, _KX_DEN, _KY_NUM, _KY_DEN]
    max_len = max(len(t) for t in tables)
    tables = [t + [_ZERO2] * (max_len - len(t)) for t in tables]
    xd2 = tower.fq2_sqr(xd)
    xd3 = tower.fq2_mul(xd2, xd)
    xd_pows = [None, xd, xd2, xd3]
    accs = [_bc(t[-1], xn) for t in tables]
    for lvl in range(max_len - 2, -1, -1):
        pairs = [(a, xn) for a in accs] + [
            (_bc(t[lvl], xn), xd_pows[max_len - 1 - lvl]) for t in tables
        ]
        prods = tower.fq2_mul_many(pairs)
        accs = [plans.carry_norm(p + kx) for p, kx in zip(prods[:4], prods[4:])]
    x_num, x_den, y_num, y_den = accs
    xz, yz, zz = tower.fq2_mul_many(
        [(x_num, y_den), (tower.fq2_mul(y, y_num), x_den), (x_den, y_den)]
    )
    return torch.cat([xz, yz, zz], dim=-2)


def clear_cofactor(p):
    """[x^2-x-1]P + [x-1]psi(P) + psi^2(2P) (Budroni–Pintore), two |x| chains."""
    xP = curve.scale_fixed(2, p, BLS_X)
    xxP = curve.scale_fixed(2, xP, BLS_X)
    psiP = g2.psi(p)
    xpsiP = g2.psi(xP)
    psi2_2P = g2.psi(g2.psi(curve.point_dbl(2, p)))
    acc = curve.point_add(2, xxP, curve.point_neg(2, xP))
    acc = curve.point_add(2, acc, curve.point_neg(2, p))
    acc = curve.point_add(2, acc, xpsiP)
    acc = curve.point_add(2, acc, curve.point_neg(2, psiP))
    return curve.point_add(2, acc, psi2_2P)


def map_to_g2(u0, u1):
    """Two field elements per message -> projective G2 point; u0/u1 stacked
    into one doubled leading batch for SSWU and the isogeny."""
    u = torch.stack([u0, u1], dim=0)
    q = iso_map_fraction(*map_to_curve_sswu_fraction(u))
    return clear_cofactor(curve.point_add(2, q[0], q[1]))
