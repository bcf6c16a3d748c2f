"""Branchless projective curve ops for BLS12-381 G1/G2 (plan-compiled).

Port of ``lighthouse_tpu/ops/bls/curve.py``. Points are homogeneous projective
(X : Y : Z) on y^2 z = x^3 + b z^3, infinity (0 : 1 : 0), one flat tensor
``[..., 3k, 25]`` (k = 1 for G1, k = 2 for G2). Group ops are the
Renes–Costello–Batina complete formulas (eprint 2015/1060, algorithms 7 and
9), each depth-2 in multiplications: two plan executions, i.e. two launches of
the fused kernel, per add or double.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fq
from . import plans
from . import tower
from .plans import LC, PUB_BOUND


def _vec(k: int, off: int):
    return [LC.basis(off + i) for i in range(k)]


def _vadd(x, y):
    return [a + b for a, b in zip(x, y)]


def _vsub(x, y):
    return [a - b for a, b in zip(x, y)]


def _vscale(x, c: int):
    return [a.scale(c) for a in x]


def _b3(k: int, v):
    """Multiply by 3b: G1 b = 4 -> 12; G2 b = 4(u+1) -> 12 (u+1)."""
    if k == 1:
        return _vscale(v, 12)
    return _vscale(plans.v2_nr(v), 12)


def _kmul(p: plans.Plan, k: int, x, y):
    return [p.lane(x[0], y[0])] if k == 1 else p.mul2(x, y)


def _ksqr(p: plans.Plan, k: int, x):
    return [p.lane(x[0], x[0])] if k == 1 else p.sqr2(x)


_ADD_PLANS: dict[int, tuple] = {}
_DBL_PLANS: dict[int, tuple] = {}


def _add_plans(k: int):
    """RCB15 algorithm 7 as two plans (a copy of the reference builder)."""
    if k in _ADD_PLANS:
        return _ADD_PLANS[k]
    p1 = plans.Plan(3 * k, 3 * k)
    x1, y1, z1 = _vec(k, 0), _vec(k, k), _vec(k, 2 * k)
    x2, y2, z2 = _vec(k, 0), _vec(k, k), _vec(k, 2 * k)
    pxx = _kmul(p1, k, x1, x2)
    pyy = _kmul(p1, k, y1, y2)
    pzz = _kmul(p1, k, z1, z2)
    pxy = _kmul(p1, k, _vadd(x1, y1), _vadd(x2, y2))
    pyz = _kmul(p1, k, _vadd(y1, z1), _vadd(y2, z2))
    pxz = _kmul(p1, k, _vadd(x1, z1), _vadd(x2, z2))
    m_a = _vsub(_vsub(pxy, pxx), pyy)
    m_b = _vsub(_vsub(pyz, pyy), pzz)
    m_c = _vsub(_vsub(pxz, pxx), pzz)
    t0 = _vscale(pxx, 3)
    t1 = pyy
    t2n = _b3(k, pzz)
    p1.out_rows = m_a + m_b + m_c + t0 + t1 + t2n

    p2 = plans.Plan(6 * k, 6 * k)
    ma, mb, mc, t0v, t1v, t2v = (_vec(k, i * k) for i in range(6))
    y3 = _b3(k, mc)
    z3p = _vadd(t1v, t2v)
    t1p = _vsub(t1v, t2v)
    q1 = _kmul(p2, k, mb, y3)
    q2 = _kmul(p2, k, ma, t1p)
    q3 = _kmul(p2, k, y3, t0v)
    q4 = _kmul(p2, k, t1p, z3p)
    q5 = _kmul(p2, k, t0v, ma)
    q6 = _kmul(p2, k, z3p, mb)
    p2.out_rows = _vsub(q2, q1) + _vadd(q4, q3) + _vadd(q6, q5)
    _ADD_PLANS[k] = (p1, p2)
    return p1, p2


def _dbl_plans(k: int):
    """RCB15 algorithm 9 as two plans (a copy of the reference builder)."""
    if k in _DBL_PLANS:
        return _DBL_PLANS[k]
    p1 = plans.Plan(3 * k, 3 * k)
    x, y, z = _vec(k, 0), _vec(k, k), _vec(k, 2 * k)
    w0 = _ksqr(p1, k, y)
    szz = _ksqr(p1, k, z)
    pyz = _kmul(p1, k, y, z)
    pxy = _kmul(p1, k, x, y)
    p1.out_rows = w0 + _vscale(w0, 8) + _b3(k, szz) + pyz + pxy

    p2 = plans.Plan(5 * k, 5 * k)
    w0v, z8v, t2v, pyzv, pxyv = (_vec(k, i * k) for i in range(5))
    t0m = _vsub(w0v, _vscale(t2v, 3))
    y3p = _vadd(w0v, t2v)
    d1 = _kmul(p2, k, t2v, z8v)
    d2 = _kmul(p2, k, pyzv, z8v)
    d3 = _kmul(p2, k, t0m, y3p)
    d4 = _kmul(p2, k, t0m, pxyv)
    p2.out_rows = _vscale(d4, 2) + _vadd(d1, d3) + d2
    _DBL_PLANS[k] = (p1, p2)
    return p1, p2


def point_add(k: int, p, q):
    """Complete addition (any on-curve inputs, infinity included)."""
    p1, p2 = _add_plans(k)
    mid = plans.execute(p1, p, q, PUB_BOUND, PUB_BOUND, f"g{k}add1")
    return plans.execute(p2, mid, mid, PUB_BOUND, PUB_BOUND, f"g{k}add2")


def point_dbl(k: int, p):
    p1, p2 = _dbl_plans(k)
    mid = plans.execute(p1, p, p, PUB_BOUND, PUB_BOUND, f"g{k}dbl1")
    return plans.execute(p2, mid, mid, PUB_BOUND, PUB_BOUND, f"g{k}dbl2")


def point_neg(k: int, p):
    """(X : -Y : Z), renormalized to public bounds."""
    y = plans.carry_norm(tower.t_neg(p[..., k : 2 * k, :]))
    return torch.cat([p[..., 0:k, :], y, p[..., 2 * k :, :]], dim=-2)


def point_select(cond, p, q):
    return torch.where(cond[..., None, None], p, q)


_INF: dict[int, np.ndarray] = {}


def inf_np(k: int) -> np.ndarray:
    if k not in _INF:
        z = np.zeros((3 * k, fq.NLIMBS), dtype=np.int64)
        z[k] = fq.int_to_limbs(fq.R_MONT % fq.P)
        _INF[k] = z
    return _INF[k]


def inf_point(k: int, shape, device):
    """(0 : 1 : 0) on ``device`` (no default, as ``tower.one``), broadcast to
    ``shape``."""
    t = torch.from_numpy(inf_np(k)).to(device)
    return t.expand(tuple(shape) + (3 * k, fq.NLIMBS))


def inf_like(k: int, like):
    return fq.dconst(inf_np(k), like).expand(like.shape[:-2] + (3 * k, fq.NLIMBS))


def is_inf(k: int, p):
    return tower.t_is_zero(p[..., 2 * k :, :])


def point_eq(k: int, p, q):
    """Projective equality X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    x1, y1, z1 = p[..., 0:k, :], p[..., k : 2 * k, :], p[..., 2 * k :, :]
    x2, y2, z2 = q[..., 0:k, :], q[..., k : 2 * k, :], q[..., 2 * k :, :]
    mul = fq.mont_mul if k == 1 else tower.fq2_mul
    ex = tower.t_eq(mul(x1, z2), mul(x2, z1))
    ey = tower.t_eq(mul(y1, z2), mul(y2, z1))
    return ex & ey


def to_affine(k: int, p):
    """(x, y) = (X/Z, Y/Z), each [..., k, 25]; infinity maps to (0, 0)."""
    x, y, z = p[..., 0:k, :], p[..., k : 2 * k, :], p[..., 2 * k :, :]
    if k == 1:
        zi = fq.inv(z[..., 0, :])[..., None, :]
        return fq.mont_mul(x, zi), fq.mont_mul(y, zi)
    zi = tower.fq2_inv(z)
    return tower.fq2_mul(x, zi), tower.fq2_mul(y, zi)


def from_affine(k: int, x, y, inf=None):
    """Affine coords -> projective; optional inf mask selects (0:1:0)."""
    pt = torch.cat([x, y, tower.one_like(k, x)], dim=-2)
    if inf is not None:
        pt = point_select(inf, inf_like(k, pt), pt)
    return pt


# --------------------------------------------------------------------------------------
# Scalar multiplication
# --------------------------------------------------------------------------------------


def scale_u64(k: int, point, scalars, window: int = 4):
    """Per-point 64-bit scalar multiply (the RLC scaling path)."""
    return scale_u64_with_fixed(k, point, scalars, (), window)[0]


def scale_u64_with_fixed(k: int, point, scalars, fixed: tuple = (), window: int = 4):
    """[r]P for device scalars r PLUS [e]P for each host-fixed e, sharing ONE
    multiples table and ONE w-bit windowed ladder. ``scalars`` are int64
    tensors holding the 64-bit patterns of the uint64 scalars (values >= 2^63
    are negative here): windows are taken with masks, so the arithmetic shift
    of a negative int64 never leaks into a digit. Returns
    [1 + len(fixed), *batch, 3k, 25]."""
    if 64 % window:
        raise ValueError("window must divide the 64-bit scalar width")
    if not all(0 <= e < 1 << 64 for e in fixed):
        raise ValueError("fixed scalars must be in [0, 2^64)")
    n_ent = 1 << window
    n_lane = 1 + len(fixed)
    inf = inf_like(k, point)
    entries = [inf, point]
    acc = point
    for _ in range(n_ent - 2):
        acc = point_add(k, acc, point)
        entries.append(acc)
    table = torch.stack(entries, dim=0)  # [2^w, *batch, 3k, 25]
    n_dig = 64 // window
    bshape = scalars.shape
    digits = [
        ((scalars >> (window * (n_dig - 1 - i))) & (n_ent - 1)) for i in range(n_dig)
    ]  # each [*batch], masked: exact for the full 64-bit pattern
    fx = [
        [(e >> (window * (n_dig - 1 - i))) & (n_ent - 1) for e in fixed]
        for i in range(n_dig)
    ]
    tab_l = table[:, None].expand((n_ent, n_lane) + table.shape[1:])

    acc = inf_like(k, point)[None].expand((n_lane,) + point.shape)
    for i in range(n_dig):
        for _ in range(window):
            acc = point_dbl(k, acc)
        dig = digits[i][None]
        if fixed:
            fdig = torch.tensor(fx[i], dtype=torch.int64, device=scalars.device)
            dig = torch.cat(
                [dig, fdig.reshape((len(fixed),) + (1,) * len(bshape)).expand((len(fixed),) + bshape)],
                dim=0,
            )  # [L, *batch]
        idx = dig[None, ..., None, None].expand((1,) + tab_l.shape[1:])
        sel = torch.gather(tab_l, 0, idx)[0]
        acc = point_add(k, acc, sel)
    return acc


def fixed_schedule(e: int) -> list[tuple[int, int]]:
    """Double-and-add schedule of a positive scalar with the MSB consumed by
    initialization: list of (doubling_run, add_flag) segments."""
    bits = bin(e)[2:]
    segs = []
    i = 1
    while i < len(bits):
        j = bits.find("1", i)
        if j == -1:
            segs.append((len(bits) - i, 0))
            break
        segs.append((j - i + 1, 1))
        i = j + 1
    return segs


def scale_fixed(k: int, point, e: int, window: int | None = None):
    """Multiply by a host-fixed scalar (the chain compiler's schedule)."""
    from . import chain_plans

    return chain_plans.scale_fixed_chain(k, point, e, window)


def point_sum(k: int, pts, valid=None):
    """Sum points over the leading axis by a halving tree; ``valid`` masks
    entries (invalid -> infinity)."""
    n = pts.shape[0]
    if valid is not None:
        pts = point_select(valid, pts, inf_like(k, pts))
    while n > 1:
        if n % 2:
            pts = torch.cat([pts, inf_like(k, pts[:1])], dim=0)
            n += 1
        pts = point_add(k, pts[: n // 2], pts[n // 2 :])
        n //= 2
    return pts[0]
