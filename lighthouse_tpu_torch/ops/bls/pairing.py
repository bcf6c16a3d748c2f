"""Optimal-ate multi-pairing check on BLS12-381 (the verify path's arm).

Port of ``lighthouse_tpu/ops/bls/pairing.py``, the arm its digits/Pallas
backends take: the shared-accumulator ``miller_loop_product`` (one fq12
accumulator for all pairs, sparse-first cross-pair line products), then ONE
``final_exponentiation``. The line plans are copies of the reference builders
(pinned by tests); ``lax.scan`` loops over the host-known |x| schedule become
Python loops.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plans, tower
from .plans import LC, PUB_BOUND, v2_add, v2_sub, v2_nr, v6_add, v6_sub, v6_nr
from ...oracle.fields import BLS_X

X_ABS = -BLS_X  # 0xd201000000010000

# --------------------------------------------------------------------------------------
# Sparse fold plans (copies of the reference builders)
# --------------------------------------------------------------------------------------


def _mul6_sp2(p: plans.Plan, xs, d0, d1):
    x0, x1, x2 = xs[0:2], xs[2:4], xs[4:6]
    m00 = p.mul2(x0, d0)
    m11 = p.mul2(x1, d1)
    mx = p.mul2(v2_add(x0, x1), v2_add(d0, d1))
    m20 = p.mul2(x2, d0)
    m21 = p.mul2(x2, d1)
    r0 = v2_add(m00, v2_nr(m21))
    r1 = v2_sub(v2_sub(mx, m00), m11)
    r2 = v2_add(m11, m20)
    return r0 + r1 + r2


def _mul6_sp1(p: plans.Plan, xs, d):
    x0, x1, x2 = xs[0:2], xs[2:4], xs[4:6]
    n0 = p.mul2(x0, d)
    n1 = p.mul2(x1, d)
    n2 = p.mul2(x2, d)
    return v2_nr(n2) + n0 + n1


def _mul6_sp12(p: plans.Plan, xs, d1, d2):
    x0, x1, x2 = xs[0:2], xs[2:4], xs[4:6]
    m01 = p.mul2(x0, d1)
    m02 = p.mul2(x0, d2)
    m11 = p.mul2(x1, d1)
    m22 = p.mul2(x2, d2)
    mx = p.mul2(v2_add(x1, x2), v2_add(d1, d2))
    r0 = v2_nr(v2_sub(v2_sub(mx, m11), m22))
    r1 = v2_add(m01, v2_nr(m22))
    r2 = v2_add(m02, m11)
    return r0 + r1 + r2


def _build_mul_by_014() -> plans.Plan:
    p = plans.Plan(12, 6)
    x = plans.vbasis(12)
    a0, a1 = x[0:6], x[6:12]
    c0 = [LC.basis(0), LC.basis(1)]
    c1 = [LC.basis(2), LC.basis(3)]
    c4 = [LC.basis(4), LC.basis(5)]
    t0 = _mul6_sp2(p, a0, c0, c1)
    t1 = _mul6_sp1(p, a1, c4)
    t2 = _mul6_sp2(p, plans.v6_add(a0, a1), c0, v2_add(c1, c4))
    out0 = plans.v6_add(t0, plans.v6_nr(t1))
    out1 = plans.v6_sub(plans.v6_sub(t2, t0), t1)
    p.out_rows = out0 + out1
    return p


MUL_BY_014 = _build_mul_by_014()


def _build_mul_by_01245() -> plans.Plan:
    p = plans.Plan(12, 10)
    x = plans.vbasis(12)
    a0, a1 = x[0:6], x[6:12]
    b0 = plans.vbasis(6)
    d1 = [LC.basis(6), LC.basis(7)]
    d2 = [LC.basis(8), LC.basis(9)]
    t0 = p.mul6(a0, b0)
    t1 = _mul6_sp12(p, a1, d1, d2)
    ysum = b0[0:2] + v2_add(b0[2:4], d1) + v2_add(b0[4:6], d2)
    t2 = p.mul6(v6_add(a0, a1), ysum)
    out0 = v6_add(t0, v6_nr(t1))
    out1 = v6_sub(v6_sub(t2, t0), t1)
    p.out_rows = out0 + out1
    return p


MUL_BY_01245 = _build_mul_by_01245()


def _build_sp_sp() -> plans.Plan:
    p = plans.Plan(6, 6)
    x, y = plans.vbasis(6), plans.vbasis(6)
    a0, a1, a4 = x[0:2], x[2:4], x[4:6]
    b0, b1, b4 = y[0:2], y[2:4], y[4:6]
    m00 = p.mul2(a0, b0)
    m11 = p.mul2(a1, b1)
    m44 = p.mul2(a4, b4)
    mx01 = p.mul2(v2_add(a0, a1), v2_add(b0, b1))
    mx04 = p.mul2(v2_add(a0, a4), v2_add(b0, b4))
    mx14 = p.mul2(v2_add(a1, a4), v2_add(b1, b4))
    c0 = v2_add(m00, v2_nr(m44))
    c1 = v2_sub(v2_sub(mx01, m00), m11)
    c2 = m11
    c4 = v2_sub(v2_sub(mx04, m00), m44)
    c5 = v2_sub(v2_sub(mx14, m11), m44)
    p.out_rows = c0 + c1 + c2 + c4 + c5
    return p


SP_SP = _build_sp_sp()


def _build_scale_line() -> plans.Plan:
    p = plans.Plan(6, 2)
    px, py = LC.basis(0), LC.basis(1)
    l10 = p.lane(LC.basis(2), px)
    l11 = p.lane(LC.basis(3), px)
    l20 = p.lane(LC.basis(4), py)
    l21 = p.lane(LC.basis(5), py)
    p.out_rows = [p.inp(0), p.inp(1), l10, l11, l20, l21]
    return p


SCALE_LINE = _build_scale_line()


def _mul014_lazy(f, c):
    bd, ob = plans.f12_interior()
    return plans.execute(MUL_BY_014, f, c, bd, bd, "mul014_c", out_bound=ob)


def _build_dbl_plans() -> tuple[plans.Plan, plans.Plan]:
    p1 = plans.Plan(6, 6)
    x = plans.vbasis(6)
    X, Y, Z = x[0:2], x[2:4], x[4:6]
    aj = p1.mul2(X, Y)
    b = p1.sqr2(Y)
    c = p1.sqr2(Z)
    j = p1.sqr2(X)
    s = p1.sqr2(v2_add(Y, Z))
    e = [t.scale(12) for t in v2_nr(c)]
    e3 = [t.scale(3) for t in e]
    bmf = v2_sub(b, e3)
    bpf = v2_add(b, e3)
    h = v2_sub(v2_sub(s, b), c)
    p1.out_rows = aj + bmf + bpf + e + b + h + j

    p2 = plans.Plan(14, 14)
    y = plans.vbasis(14)
    aj2, bmf2, bpf2, e2, b2, h2 = y[0:2], y[2:4], y[4:6], y[6:8], y[8:10], y[10:12]
    m0 = p2.mul2(aj2, bmf2)
    m1 = p2.sqr2(bpf2)
    m2 = p2.sqr2(e2)
    m3 = p2.mul2(b2, h2)
    x3 = [t.scale(2) for t in m0]
    y3 = v2_sub(m1, [t.scale(12) for t in m2])
    z3 = [t.scale(4) for t in m3]
    l0 = [p2.inp(6) - p2.inp(8), p2.inp(7) - p2.inp(9)]
    l1 = [p2.inp(12).scale(3), p2.inp(13).scale(3)]
    l2 = [-p2.inp(10), -p2.inp(11)]
    p2.out_rows = x3 + y3 + z3 + l0 + l1 + l2
    return p1, p2


DBL1, DBL2 = _build_dbl_plans()


def _dbl_step(r):
    """Twist point (F12-bounded) -> (4-scaled doubled point, unscaled line)."""
    bd, ob = plans.f12_interior()
    mid = plans.execute(DBL1, r, r, bd, bd, "mldbl1", out_bound=ob)
    out = plans.execute(DBL2, mid, mid, bd, bd, "mldbl2", out_bound=ob)
    return out[..., 0:6, :], out[..., 6:12, :]


def _add_step(r, qx, qy):
    """Mixed addition r + Q (Q affine) -> (new point, unscaled line)."""
    B = plans.f12_interior()[0]
    x, y, z = r[..., 0:2, :], r[..., 2:4, :], r[..., 4:6, :]
    qyz, qxz = tower.fq2_mul_many([(qy, z), (qx, z)], in_bound=B)
    pre = plans.carry_norm(
        torch.cat([tower.t_sub(y, qyz, B), tower.t_sub(x, qxz, B)], dim=-2)
    )
    theta, lam = pre[..., 0:2, :], pre[..., 2:4, :]
    c, d = tower.fq2_mul_many([(theta, theta), (lam, lam)])
    e, f, g = tower.fq2_mul_many([(lam, d), (z, c), (x, d)], in_bound=B)
    h = plans.carry_norm(tower.t_sub(e + f, g * 2, PUB_BOUND.scaled(2)))
    gmh = plans.carry_norm(tower.t_sub(g, h))
    x3, t1, t2, z3, j1, j2 = tower.fq2_mul_many(
        [(lam, h), (theta, gmh), (e, y), (z, e), (theta, qx), (lam, qy)], in_bound=B
    )
    out = torch.cat(
        [x3, tower.t_sub(t1, t2), z3, tower.t_sub(j1, j2), tower.t_neg(theta), lam],
        dim=-2,
    )
    out = plans.carry_norm(out)
    return out[..., 0:6, :], out[..., 6:12, :]


def _expand_01245(m):
    z = torch.zeros_like(m[..., 0:2, :])
    return torch.cat([m[..., 0:6, :], z, m[..., 6:8, :], m[..., 8:10, :]], dim=-2)


def _expand_014(c):
    z = torch.zeros_like(c[..., 0:2, :])
    return torch.cat([c[..., 0:4, :], z, z, c[..., 4:6, :], z], dim=-2)


def _collect_lines(px, py, qx, qy):
    """Pass 1: iterate only the twist points over the |x| schedule, collect
    the 63 doubling + 5 addition lines, scale all 68 by the G1 coordinates in
    one stacked plan execution. Returns (segs, add_pos, sd, sa)."""
    from .curve import fixed_schedule

    segs = fixed_schedule(X_ABS)
    bd, ob = plans.f12_interior()
    r = torch.cat([qx, qy, tower.one_like(2, qx)], dim=-2)
    dbl_lines = []
    add_lines = []
    for run, add in segs:
        for _ in range(run):
            r, line = _dbl_step(r)
            dbl_lines.append(line)
        if add:
            r, la = _add_step(r, qx, qy)
            add_lines.append(la)
    dbl_lines = torch.stack(dbl_lines, dim=0)   # [63, *batch, 6, 25]
    add_lines = torch.stack(add_lines, dim=0)   # [5, *batch, 6, 25]
    pxy = torch.stack([px, py], dim=-2)
    all_lines = torch.cat([dbl_lines, add_lines], dim=0)
    scaled = plans.execute(
        SCALE_LINE, all_lines, pxy.expand(all_lines.shape[:1] + pxy.shape),
        bd, PUB_BOUND, "ml_scale", out_bound=ob,
    )
    ends = np.cumsum([run for run, _ in segs])
    add_pos = [int(e) - 1 for e, (_, a) in zip(ends, segs) if a]
    n_dbl = dbl_lines.shape[0]
    return segs, add_pos, scaled[:n_dbl], scaled[n_dbl:]


def _conj_norm(f):
    """x < 0: conjugate the accumulator; restore the public bound."""
    bd = plans.f12_interior()[0]
    f = torch.cat([f[..., 0:6, :], tower.t_neg(f[..., 6:12, :], bd)], dim=-2)
    return plans.carry_norm(f)


def _cross_pair_products(lines, valid=None):
    """[P, n, 6, 25] sparse-014 lines -> [P, 12, 25]: per-position product over
    the n pairs (one sparse SP_SP level, a halving fq12 tree, one sparse fold
    of the odd leftover). ``valid`` replaces masked pairs' lines with one."""
    if valid is not None:
        ident = torch.cat(
            [tower.one_like(2, lines[..., 0:2, :]), torch.zeros_like(lines[..., 0:4, :])],
            dim=-2,
        )
        mask = valid[None].expand(lines.shape[:2])
        lines = tower.t_select(mask, lines, ident)
    n = lines.shape[1]
    if n == 1:
        return _expand_014(lines[:, 0])
    bd, ob = plans.f12_interior()
    half = n // 2
    leftover = lines[:, -1] if n % 2 else None
    sp = plans.execute(
        SP_SP, lines[:, :half], lines[:, half : 2 * half], bd, bd, "ml_spsp", out_bound=ob
    )
    L = _expand_01245(sp)
    m = L.shape[1]
    while m > 1:
        h = m // 2
        prod = tower.fq12_mul_lazy(L[:, :h], L[:, h : 2 * h])
        if m % 2:
            prod = torch.cat([prod, L[:, 2 * h :]], dim=1)
        L = prod
        m = L.shape[1]
    L = L[:, 0]
    if leftover is not None:
        L = _mul014_lazy(L, leftover)
    return L


def miller_loop_product(px, py, qx, qy, valid=None):
    """prod_i f_{x,Q_i}(P_i) over the leading batch axis with ONE shared
    accumulator; ``valid`` masks pairs (a masked pair contributes one)."""
    segs, add_pos, sd, sa = _collect_lines(px, py, qx, qy)
    n_dbl = sd.shape[0]
    L = _cross_pair_products(torch.cat([sd, sa], dim=0), valid)
    ap = torch.tensor(add_pos, device=L.device)
    Lm = tower.fq12_mul_lazy(L[ap], L[n_dbl:])
    Ld = L[:n_dbl].clone()
    Ld[ap] = Lm
    f = Ld[0]
    for i in range(1, n_dbl):
        f = tower.fq12_mul_lazy(tower.fq12_sqr_lazy(f), Ld[i])
    return _conj_norm(f)


def final_exponentiation(f, *, compressed: bool = False):
    """f^((p^6-1)(p^2+1)) then the hard part via the x-addition chain
    (3 lambda = (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3). ``compressed`` routes
    the five |x| powers through Karabina squaring
    (``tower.fq12_cyclotomic_exp_abs_x``)."""
    f = tower.fq12_mul(tower.fq12_conj(f), tower.fq12_inv(f))
    f = tower.fq12_mul(tower.fq12_frobenius(f, 2), f)

    def exp_abs_x(g):
        return tower.fq12_cyclotomic_exp_abs_x(g, compressed=compressed)

    def exp_x_minus_1(g):
        return tower.fq12_conj(tower.fq12_mul(exp_abs_x(g), g))

    m1 = exp_x_minus_1(f)
    m2 = exp_x_minus_1(m1)
    m2x = tower.fq12_conj(exp_abs_x(m2))
    m3 = tower.fq12_mul(m2x, tower.fq12_frobenius(m2, 1))
    m3x = tower.fq12_conj(exp_abs_x(m3))
    m3x2 = tower.fq12_conj(exp_abs_x(m3x))
    m4 = tower.fq12_mul(m3x2, tower.fq12_mul(tower.fq12_frobenius(m3, 2), tower.fq12_conj(m3)))
    f3 = tower.fq12_mul(tower.fq12_mul(f, f), f)
    return tower.fq12_mul(m4, f3)


def multi_pairing_is_one(px, py, qx, qy, valid=None, *, compressed: bool = False):
    """prod_i e(P_i, Q_i) == 1 with ONE final exponentiation; ``valid``
    masks entries (a masked entry contributes one); ``compressed`` as in
    ``final_exponentiation``."""
    f = miller_loop_product(px, py, qx, qy, valid)
    return tower.fq12_is_one(final_exponentiation(f, compressed=compressed))
