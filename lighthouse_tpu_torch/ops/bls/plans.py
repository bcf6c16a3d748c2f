"""Lane-plan compiler: tower algebra flattened into lincomb -> fused multiply.

Port of ``lighthouse_tpu/ops/bls/plans.py`` (the builders are copies, pinned
equal to the reference by tests). A multiplication in Fq2/Fq6/Fq12 is a
bilinear map; Karatsuba decomposes it into L base-field products whose
operands are small integer linear combinations of the input coefficients and
whose outputs recombine linearly. A tower op then runs as ONE launch of the
plan kernel (fused_mul.execute_plan) on the raw operands:

    A = lincomb(a), B = lincomb(b)   # [L, 25] int64 per row, no carries
    conv, output map, reduction      # per lane / per output row

Subtraction never goes negative: a - b is a + (C - b) with C a
borrow-inflated multiple of p dominating b's static limb bounds. Bounds
(value in units of p, per-limb magnitude, top limb) are tracked through every
linear combination and checked against the lazy operand budget (value <
1200p, limbs < 2^22) when a plan's tables are built.

Element layout (little-endian coefficient order, flat over the tower):
fq2 = [..., 2, 25], fq6 = [..., 6, 25], fq12 = [..., 12, 25].
"""

from __future__ import annotations

import numpy as np
import torch

from . import fq
from ...oracle.fields import P

PUB_VALUE_P = 16
PUB_LIMB = fq.PUB_LIMB_TARGET
PUB_TOP_LIMB = 2

MAX_VALUE_P = 1200
fq._cert("lincomb_budget_value", MAX_VALUE_P * P, fq._IN_VALUE)
MAX_LIMB = fq._IN_LIMB + 1  # strict bound: limbs < 2^22


class LC:
    """Integer linear combination over a basis (dict idx -> coeff)."""

    __slots__ = ("d",)

    def __init__(self, d=None):
        self.d = {k: v for k, v in (d or {}).items() if v}

    @staticmethod
    def basis(i):
        return LC({i: 1})

    def __add__(self, o):
        d = dict(self.d)
        for k, v in o.d.items():
            d[k] = d.get(k, 0) + v
        return LC(d)

    def __sub__(self, o):
        d = dict(self.d)
        for k, v in o.d.items():
            d[k] = d.get(k, 0) - v
        return LC(d)

    def __neg__(self):
        return LC({k: -v for k, v in self.d.items()})

    def scale(self, k: int):
        return LC({i: v * k for i, v in self.d.items()})

    def __repr__(self):
        return f"LC({self.d})"


def v2_add(x, y):
    return [x[0] + y[0], x[1] + y[1]]


def v2_sub(x, y):
    return [x[0] - y[0], x[1] - y[1]]


def v2_nr(x):
    """Multiply by (u+1)."""
    return [x[0] - x[1], x[0] + x[1]]


def v2_neg(x):
    return [-x[0], -x[1]]


def v2_conj(x):
    return [x[0], -x[1]]


def v6_add(x, y):
    return [a + b for a, b in zip(x, y)]


def v6_sub(x, y):
    return [a - b for a, b in zip(x, y)]


def v6_nr(x):
    """Multiply by v: (c0, c1, c2) -> (nr(c2), c0, c1)."""
    return v2_nr(x[4:6]) + x[0:4]


def vbasis(n, off=0):
    return [LC.basis(off + i) for i in range(n)]


class Plan:
    """a_rows/b_rows: LCs over the A/B input coefficient bases (B may reference a
    constant pool via indices >= n_b). out_rows: LCs over the lane basis."""

    def __init__(self, n_a: int, n_b: int, consts=None):
        self.n_a = n_a
        self.n_b = n_b
        self.consts = consts or []
        self.a_rows: list[LC] = []
        self.b_rows: list[LC] = []
        self.out_rows: list[LC] = []

    def lane(self, va: LC, vb: LC) -> LC:
        self.a_rows.append(va)
        self.b_rows.append(vb)
        return LC.basis(len(self.a_rows) - 1)

    @staticmethod
    def inp(i: int) -> LC:
        """Reference input coefficient i inside an out_row (pass-through),
        encoded as negative basis index -(i+1)."""
        return LC.basis(-(i + 1))

    def mul2(self, x, y):
        l0 = self.lane(x[0], y[0])
        l1 = self.lane(x[1], y[1])
        l2 = self.lane(x[0] + x[1], y[0] + y[1])
        return [l0 - l1, l2 - l0 - l1]

    def sqr2(self, x):
        l0 = self.lane(x[0] + x[1], x[0] - x[1])
        l1 = self.lane(x[0], x[1])
        return [l0, l1 + l1]

    def mul6(self, x, y):
        x0, x1, x2 = x[0:2], x[2:4], x[4:6]
        y0, y1, y2 = y[0:2], y[2:4], y[4:6]
        t0 = self.mul2(x0, y0)
        t1 = self.mul2(x1, y1)
        t2 = self.mul2(x2, y2)
        t12 = self.mul2(v2_add(x1, x2), v2_add(y1, y2))
        t01 = self.mul2(v2_add(x0, x1), v2_add(y0, y1))
        t02 = self.mul2(v2_add(x0, x2), v2_add(y0, y2))
        c0 = v2_add(v2_nr(v2_sub(v2_sub(t12, t1), t2)), t0)
        c1 = v2_add(v2_sub(v2_sub(t01, t0), t1), v2_nr(t2))
        c2 = v2_add(v2_sub(v2_sub(t02, t0), t2), t1)
        return c0 + c1 + c2

    def mul12(self, x, y):
        x0, x1 = x[0:6], x[6:12]
        y0, y1 = y[0:6], y[6:12]
        t0 = self.mul6(x0, y0)
        t1 = self.mul6(x1, y1)
        t2 = self.mul6(v6_add(x0, x1), v6_add(y0, y1))
        c0 = v6_add(t0, v6_nr(t1))
        c1 = v6_sub(v6_sub(t2, t0), t1)
        return c0 + c1


# --------------------------------------------------------------------------------------
# Borrow-inflated subtraction constants
# --------------------------------------------------------------------------------------

_SUBC_CACHE: dict[tuple[int, int], tuple[np.ndarray, int]] = {}


def _subc(limb_cover: int, top_cover: int):
    """C = K*p whose borrow-inflated limbs 0..23 are >= limb_cover and limb 24
    >= top_cover. Returns (int64[25] limbs, K)."""
    key = (limb_cover, top_cover)
    if key in _SUBC_CACHE:
        return _SUBC_CACHE[key]
    m = max(-(-limb_cover // ((1 << 16) - 1)), 1)
    K = 1
    while True:
        if (K * P).bit_length() > 400:
            raise fq.BoundError("subc constant exceeds 25 limbs")
        c = [int(v) for v in fq.int_to_limbs(K * P)]
        for i in range(1, 25):
            c[i - 1] += m << 16
            c[i] -= m
        if (
            all(v >= 0 for v in c)
            and all(c[i] >= limb_cover for i in range(24))
            and c[24] >= top_cover
        ):
            if sum(v << (16 * i) for i, v in enumerate(c)) != K * P:
                raise fq.BoundError("subc constant is not K*p")
            arr = np.array(c, dtype=np.int64)
            _SUBC_CACHE[key] = (arr, K)
            return arr, K
        K += 1


class _Bound:
    """Static (value_p, limb, top_limb) bound triple."""

    __slots__ = ("value_p", "limb", "top")

    def __init__(self, value_p, limb, top):
        self.value_p = value_p
        self.limb = limb
        self.top = top

    def __add__(self, o: "_Bound") -> "_Bound":
        return _Bound(self.value_p + o.value_p, self.limb + o.limb, self.top + o.top)

    def __or__(self, o: "_Bound") -> "_Bound":
        return _Bound(
            max(self.value_p, o.value_p), max(self.limb, o.limb), max(self.top, o.top)
        )

    def scaled(self, k: int) -> "_Bound":
        return _Bound(self.value_p * k, self.limb * k, self.top * k)


def sub_bound(minuend: _Bound, subtrahend: _Bound) -> _Bound:
    sc, K = _subc(subtrahend.limb, subtrahend.top)
    return _Bound(
        minuend.value_p + K, minuend.limb + int(max(sc[:24])), minuend.top + int(sc[24])
    )


PUB_BOUND = _Bound(PUB_VALUE_P, PUB_LIMB, PUB_TOP_LIMB)
CANON_BOUND = _Bound(1, (1 << 16) - 1, 0)
CHAIN_BOUND = _Bound(fq.CHAIN_VALUE_P, fq.CHAIN_LIMB_TARGET, fq.chain_top_limb())
F12_BOUND = _Bound(
    fq.CHAIN_VALUE_P,
    (1 << 18) - 1,
    min((1 << 18) - 1, fq.CHAIN_VALUE_LIMIT >> (16 * 24)),
)
fq._cert("f12_bound_limb", F12_BOUND.limb, fq.CHAIN_LIMB_TARGET)


def f12_interior():
    """(in/out bound, out_bound kwarg) for fq12 chain interiors: the digit
    conv's accumulator bound does not grow with the input limb width, so the
    fused kernel takes the reference's digits/pallas arm (F12_BOUND)."""
    return F12_BOUND, F12_BOUND


def _lincomb_bounds(rows: list[LC], bound_for, name: str):
    """Per-row borrow constants [n_rows, 25] and the worst output _Bound."""
    consts = np.zeros((len(rows), fq.NLIMBS), dtype=np.int64)
    worst = _Bound(0, 0, 0)
    for r, lc in enumerate(rows):
        value_p = limb = top = 0
        n_limb = n_top = 0
        any_neg = False
        for idx, c in sorted(lc.d.items()):
            b = bound_for(idx)
            mag = abs(c)
            if c > 0:
                value_p += mag * b.value_p
                limb += mag * b.limb
                top += mag * b.top
            else:
                any_neg = True
                n_limb += mag * b.limb
                n_top += mag * b.top
        if any_neg:
            subc, K = _subc(n_limb, n_top)
            consts[r] = subc
            value_p += K
            limb += int(max(subc[:24]))
            top += int(subc[24])
        fq._cert("lincomb_value_budget", value_p, MAX_VALUE_P - 1, note=name)
        fq._cert("lincomb_limb_budget", limb, MAX_LIMB - 1, note=name)
        worst.value_p = max(worst.value_p, value_p)
        worst.limb = max(worst.limb, limb)
        worst.top = max(worst.top, top)
    return consts, worst


def _lincomb_matrices(rows: list[LC], n_in: int):
    """The integer row matrix as positive / negative-magnitude halves."""
    m_pos = np.zeros((len(rows), n_in), dtype=np.int64)
    m_neg = np.zeros((len(rows), n_in), dtype=np.int64)
    for r, lc in enumerate(rows):
        for idx, c in lc.d.items():
            if c > 0:
                m_pos[r, idx] = c
            else:
                m_neg[r, idx] = -c
    return m_pos, m_neg


def _apply_matrices(m_pos, m_neg, consts, x):
    """out[..., r, :] = (M_pos @ x) + (C_r - M_neg @ x), int64 (torch has no
    int64 matmul on CUDA, so a broadcast multiply and a sum). Every bound is
    checked far below 2^63 by the callers (limbs < 2^22). The tables are
    long-lived (cached per plan signature) and stay on the device."""
    pos = (fq.dconst(m_pos, x)[:, :, None] * x[..., None, :, :]).sum(dim=-2)
    if not m_neg.any():
        return pos
    neg = (fq.dconst(m_neg, x)[:, :, None] * x[..., None, :, :]).sum(dim=-2)
    return pos + (fq.dconst(consts, x) - neg)


def lincomb_tables(rows: list[LC], n_in: int, in_bound: _Bound, name: str = "", bound_for=None):
    """The static half of ``lincomb``: ((m_pos, m_neg, consts), worst bound)."""
    bound_for = bound_for or (lambda _i: in_bound)
    consts, worst = _lincomb_bounds(rows, bound_for, name)
    m_pos, m_neg = _lincomb_matrices(rows, n_in)
    return (m_pos, m_neg, consts), worst


def apply_tables(tables, x):
    """The lincomb in torch (the kernel applies the same tables itself)."""
    return _apply_matrices(*tables, x)


_CPOOLS: dict = {}


def append_const_pool(plan: Plan, b):
    """Concatenate the plan's constant pool onto the B operand (the pool's
    order defines what b_rows indices >= n_b mean)."""
    if not plan.consts:
        return b
    hit = _CPOOLS.get(id(plan))
    if hit is None:
        hit = (plan, np.stack([fq.int_to_limbs(c) for c in plan.consts]))
        _CPOOLS[id(plan)] = hit
    cpool = fq.dconst(hit[1], b)
    return torch.cat([b, cpool.expand(b.shape[:-2] + cpool.shape)], dim=-2)


def remap_passthrough_rows(plan: Plan, n_lanes: int) -> list[LC]:
    """Out rows with pass-through references remapped onto [lanes | a]."""
    return [
        LC({(i if i >= 0 else n_lanes - 1 - i): c for i, c in lc.d.items()})
        for lc in plan.out_rows
    ]


def _verify_carry_norm_schedule(n_folds: int) -> None:
    """Import-time proof that carry_norm lands on PUB_BOUND for any input
    within the lazy budget (and stays below 2^63 on the way)."""
    limbs = [MAX_LIMB - 1] * fq.NLIMBS
    value = MAX_VALUE_P * P
    rt = [int(v) for v in fq._RT384_NP]
    rt_val = fq._RT384_VAL
    for _ in range(n_folds):
        carried = [0] + [b >> 16 for b in limbs[:-1]]
        limbs = [min(b, 0xFFFF) + c for b, c in zip(limbs, carried)]
        limbs = [min(b, value >> (16 * i)) for i, b in enumerate(limbs)]
        top = limbs[24]
        fq._cert(
            "carry_norm_fold_nowrap", top * max(rt) + max(limbs[:24]), fq._CAP - 1,
            note="carry_norm",
        )
        lo_val = sum(b << (16 * i) for i, b in enumerate(limbs[:24]))
        value = min(lo_val, value) + top * rt_val
        limbs = [b + top * rt[i] for i, b in enumerate(limbs[:24])] + [top * rt[24]]
        limbs = [min(b, value >> (16 * i)) for i, b in enumerate(limbs)]
    carried = [0] + [b >> 16 for b in limbs[:-1]]
    limbs = [min(b, 0xFFFF) + c for b, c in zip(limbs, carried)]
    limbs = [min(b, value >> (16 * i)) for i, b in enumerate(limbs)]
    fq._cert("carry_norm_value", value, PUB_VALUE_P * P - 1, note="carry_norm")
    fq._cert("carry_norm_limb", max(limbs), PUB_LIMB, note="carry_norm")
    fq._cert("carry_norm_top_limb", limbs[24], PUB_TOP_LIMB, note="carry_norm")


_CARRY_NORM_FOLDS = 3
_verify_carry_norm_schedule(_CARRY_NORM_FOLDS)


def carry_norm(x):
    """Restore public bounds (value < 16p, 17-bit limbs, top limb <= 2) for any
    input within the lazy budget: carry-save rounds alternating with folds of
    the 2^384-and-up excess (schedule proved at import)."""
    mask = fq.dconst(fq._MASK_NO24, x)
    rt = fq.dconst(fq._RT384_NP, x)
    for _ in range(_CARRY_NORM_FOLDS):
        x = fq._carry_rounds(x, 1)
        x = x * mask + x[..., 24:25] * rt
    return fq._carry_rounds(x, 1)


def execute(plan: Plan, a, b, in_bound_a=PUB_BOUND, in_bound_b=PUB_BOUND, name="",
            out_bound: "_Bound | None" = None):
    """Run a plan: [..., n_out, 25] at PUB_BOUND (or ``out_bound``). The
    reference's Pallas arm: one plan-kernel launch, input lincombs included
    (fused_mul.execute_plan)."""
    from . import fused_mul

    return fused_mul.execute_plan(plan, a, b, in_bound_a, in_bound_b, name, out_bound)


# --------------------------------------------------------------------------------------
# Prebuilt plans (copies of the reference builders)
# --------------------------------------------------------------------------------------


def _build_mul(k: int) -> Plan:
    p = Plan(k, k)
    x, y = vbasis(k), vbasis(k)
    if k == 2:
        p.out_rows = p.mul2(x, y)
    elif k == 6:
        p.out_rows = p.mul6(x, y)
    elif k == 12:
        p.out_rows = p.mul12(x, y)
    return p


MUL2 = _build_mul(2)
MUL6 = _build_mul(6)
MUL12 = _build_mul(12)


def _build_sqr2() -> Plan:
    p = Plan(2, 2)
    x = vbasis(2)
    p.out_rows = p.sqr2(x)
    return p


SQR2 = _build_sqr2()


def _build_sqr12() -> Plan:
    """fq12 square via 2 fq6 products: t = a0*a1; s = (a0+a1)(a0 + nr(a1));
    c0 = s - t - nr(t); c1 = 2t."""
    p = Plan(12, 12)
    x = vbasis(12)
    a0, a1 = x[0:6], x[6:12]
    t = p.mul6(a0, a1)
    s = p.mul6(v6_add(a0, a1), v6_add(a0, v6_nr(a1)))
    c0 = v6_sub(v6_sub(s, t), v6_nr(t))
    c1 = v6_add(t, t)
    p.out_rows = c0 + c1
    return p


SQR12 = _build_sqr12()


def _build_cyc_sqr() -> Plan:
    """Granger-Scott cyclotomic square: 9 Fq2 squares (18 lanes) + linear glue."""
    p = Plan(12, 12)
    x = vbasis(12)
    z0, z4, z3 = x[0:2], x[2:4], x[4:6]
    z2, z1, z5 = x[6:8], x[8:10], x[10:12]
    iz0, iz4, iz3 = [p.inp(0), p.inp(1)], [p.inp(2), p.inp(3)], [p.inp(4), p.inp(5)]
    iz2, iz1, iz5 = [p.inp(6), p.inp(7)], [p.inp(8), p.inp(9)], [p.inp(10), p.inp(11)]
    sq = {}
    for nm, (u, v) in {"a": (z0, z1), "b": (z2, z3), "c": (z4, z5)}.items():
        sq[nm + "0"] = p.sqr2(u)
        sq[nm + "1"] = p.sqr2(v)
        sq[nm + "x"] = p.sqr2(v2_add(u, v))

    def fq4(nm):
        t0, t1, txy = sq[nm + "0"], sq[nm + "1"], sq[nm + "x"]
        return v2_add(v2_nr(t1), t0), v2_sub(v2_sub(txy, t0), t1)

    t0, t1 = fq4("a")
    t2, t3 = fq4("b")
    t4, t5 = fq4("c")

    def tri_sub(t, z):
        d = v2_sub(t, z)
        return v2_add(v2_add(d, d), t)

    def tri_add(t, z):
        s = v2_add(t, z)
        return v2_add(v2_add(s, s), t)

    z0n = tri_sub(t0, iz0)
    z1n = tri_add(t1, iz1)
    z2n = tri_add(v2_nr(t5), iz2)
    z3n = tri_sub(t4, iz3)
    z4n = tri_sub(t2, iz4)
    z5n = tri_add(t3, iz5)
    p.out_rows = z0n + z4n + z3n + z2n + z1n + z5n
    return p


CYC_SQR = _build_cyc_sqr()


def _build_frob12() -> Plan:
    """Power-1 Frobenius on fq12: lanes multiply conjugated coefficients by
    the Frobenius constants (a constant pool on the B side)."""
    from ...oracle import fields as _of

    g6c1, g6c2, g12 = _of._FROB_FQ6_C1_1, _of._FROB_FQ6_C2_1, _of._FROB_FQ12_C1_1
    consts = []

    def cidx(val: int) -> LC:
        v = val * fq.R_MONT % P
        if v not in consts:
            consts.append(v)
        return LC.basis(12 + consts.index(v))

    p = Plan(12, 12)
    x = vbasis(12)

    def fq6_frob(sl, extra):
        cs = [v2_conj(sl[0:2]), v2_conj(sl[2:4]), v2_conj(sl[4:6])]
        gammas = [_of.Fq2(1, 0), g6c1, g6c2]
        out = []
        for coef, gam in zip(cs, gammas):
            g = gam * extra if extra is not None else gam
            g0, g1 = cidx(g.c0), cidx(g.c1)
            l00 = p.lane(coef[0], g0)
            l11 = p.lane(coef[1], g1)
            lx = p.lane(coef[0] + coef[1], g0 + g1)
            out += [l00 - l11, lx - l00 - l11]
        return out

    c0 = fq6_frob(x[0:6], None)
    c1 = fq6_frob(x[6:12], g12)
    p.out_rows = c0 + c1
    p.consts = consts
    return p


FROB12 = _build_frob12()
