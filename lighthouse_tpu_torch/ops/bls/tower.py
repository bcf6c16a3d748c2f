"""Fq2 / Fq6 / Fq12 tower arithmetic on int64 limb tensors (plan-compiled).

Port of ``lighthouse_tpu/ops/bls/tower.py`` (Karabina compressed squaring is
left out: it is opt-in and off by default in the reference). Flat layout:
fq2 = [..., 2, 25], fq6 = [..., 6, 25], fq12 = [..., 12, 25] at the public
bound (plans.PUB_BOUND), reduced mod p only at comparisons. Every multiply
runs as one plan execution — one launch of the plan kernel — except inside
the fixed-exponent chains (the Fq2 square root, the |x| cyclotomic power),
which run whole as one launch of the chain kernel. Tower layout
matches the oracle: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(u+1)),
Fq12 = Fq6[w]/(w^2-v).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import fq
from . import plans
from .plans import PUB_BOUND, _Bound
from ...oracle import fields as _of

# --------------------------------------------------------------------------------------
# Generic helpers on flat elements
# --------------------------------------------------------------------------------------


def t_sub(a, b, b_bound: _Bound = PUB_BOUND):
    """Lazy a - b via a borrow-inflated constant that dominates b's bound."""
    sc, _ = plans._subc(b_bound.limb, b_bound.top)
    return a + (fq.dconst(sc, a) - b)


def t_neg(b, b_bound: _Bound = PUB_BOUND):
    sc, _ = plans._subc(b_bound.limb, b_bound.top)
    return fq.dconst(sc, b) - b


def nr_bound(in_b: _Bound = PUB_BOUND) -> _Bound:
    return plans.sub_bound(in_b, in_b) | in_b.scaled(2)


def t_select(cond, a, b):
    """cond ? a : b with cond of batch shape (no component/limb axes)."""
    return torch.where(cond[..., None, None], a, b)


def t_canon(a):
    return fq.canonical(a)


def t_eq(a, b, b_bound: _Bound = PUB_BOUND):
    """Equality mod p via one canonicalization of the lazy difference."""
    return torch.all(fq.canonical(t_sub(a, b, b_bound)) == 0, dim=-1).all(dim=-1)


def t_is_zero(a):
    return torch.all(t_canon(a) == 0, dim=-1).all(dim=-1)


_ONES: dict[int, np.ndarray] = {}


def one_np(k: int) -> np.ndarray:
    """The multiplicative identity of a k-coefficient element, [k, 25]."""
    if k not in _ONES:
        z = np.zeros((k, fq.NLIMBS), dtype=np.int64)
        z[0] = fq.int_to_limbs(fq.R_MONT % _of.P)
        _ONES[k] = z
    return _ONES[k]


def one(k: int, shape, device):
    """one(k) on ``device`` (no default: a forgotten device must not become
    the CPU), broadcast to ``shape``."""
    t = torch.from_numpy(one_np(k)).to(device)
    return t.expand(tuple(shape) + (k, fq.NLIMBS))


def one_like(k: int, like):
    """one(k) on ``like``'s device, broadcast over like's batch shape."""
    return fq.dconst(one_np(k), like).expand(like.shape[:-2] + (k, fq.NLIMBS))


# host <-> device ----------------------------------------------------------------------


def from_ints(coeffs, device):
    return fq.from_ints(coeffs, device)


def to_ints(a):
    return fq.to_ints(a)


def fq12_from_oracle(x: _of.Fq12, device):
    return from_ints(
        [
            x.c0.c0.c0, x.c0.c0.c1, x.c0.c1.c0, x.c0.c1.c1, x.c0.c2.c0, x.c0.c2.c1,
            x.c1.c0.c0, x.c1.c0.c1, x.c1.c1.c0, x.c1.c1.c1, x.c1.c2.c0, x.c1.c2.c1,
        ],
        device,
    )


def fq12_to_oracle(a) -> _of.Fq12:
    v = to_ints(t_canon(a))
    f2 = lambda i: _of.Fq2(v[i], v[i + 1])  # noqa: E731
    return _of.Fq12(_of.Fq6(f2(0), f2(2), f2(4)), _of.Fq6(f2(6), f2(8), f2(10)))


def _fq2_np(x: _of.Fq2) -> np.ndarray:
    return np.stack([fq.int_to_limbs(x.c0), fq.int_to_limbs(x.c1)])


# --------------------------------------------------------------------------------------
# Fq2
# --------------------------------------------------------------------------------------


def fq2_mul(a, b, in_bound=PUB_BOUND):
    return plans.execute(plans.MUL2, a, b, in_bound, in_bound, "fq2_mul")


def fq2_sqr(a, in_bound=PUB_BOUND):
    return plans.execute(plans.SQR2, a, a, in_bound, in_bound, "fq2_sqr")


def fq2_add(a, b):
    return a + b


def fq2_sub(a, b, b_bound: _Bound = PUB_BOUND):
    return t_sub(a, b, b_bound)


def fq2_neg(a, b_bound: _Bound = PUB_BOUND):
    return t_neg(a, b_bound)


def fq2_conj(a, b_bound: _Bound = PUB_BOUND):
    return torch.stack([a[..., 0, :], t_neg(a[..., 1, :], b_bound)], dim=-2)


def fq2_mul_by_nonresidue(a, b_bound: _Bound = PUB_BOUND):
    """(u+1) * a = (c0 - c1, c0 + c1). Output bound: nr_bound(b_bound)."""
    c0, c1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([t_sub(c0, c1, b_bound), c0 + c1], dim=-2)


def fq2_inv(a):
    """1/(c0 + c1 u) = (c0 - c1 u) / (c0^2 + c1^2); inv0 semantics."""
    a = t_canon(a)
    c0, c1 = a[..., 0, :], a[..., 1, :]
    n = fq.mont_sqr(c0) + fq.mont_sqr(c1)
    t = fq.inv(n)
    return fq.mont_mul(torch.stack([c0, fq.neg(c1)], dim=-2), t[..., None, :].expand(a.shape))


def fq2_sgn0(a):
    return fq2_sgn0_canon(fq.canonical(a))


def fq2_sgn0_canon(c):
    """RFC 9380 sgn0 of an already-canonical element."""
    c0, c1 = c[..., 0, :], c[..., 1, :]
    s0 = c0[..., 0] & 1
    z0 = fq.is_zero(c0)
    s1 = c1[..., 0] & 1
    return s0 | (z0.to(torch.int64) & s1)


def fq2_sqr_lazy(a, in_bound=None):
    b = in_bound or plans.CHAIN_BOUND
    return plans.execute(plans.SQR2, a, a, b, b, "fq2_sqr_c", out_bound=plans.CHAIN_BOUND)


def fq2_mul_lazy(a, b, in_bound=None):
    bd = in_bound or plans.CHAIN_BOUND
    return plans.execute(plans.MUL2, a, b, bd, bd, "fq2_mul_c", out_bound=plans.CHAIN_BOUND)


# --------------------------------------------------------------------------------------
# Fq2 square roots: one fixed-exponent chain (q = p^2, q = 9 mod 16)
# --------------------------------------------------------------------------------------

_Q = _of.P * _of.P
_M8 = (_Q - 1) // 8
_SQRT_E = (_Q - 9) // 16
_SQRT_E1, _SQRT_E0 = divmod(_SQRT_E, _of.P)


def _fq2_pow_host(a: "_of.Fq2", e: int) -> "_of.Fq2":
    r = _of.Fq2(1, 0)
    while e:
        if e & 1:
            r = r * a
        a = a.square()
        e >>= 1
    return r


def _sqrt_constants():
    from ...oracle.fields import fq_sqrt
    from ...oracle.hash_to_curve import SSWU_Z

    b = fq_sqrt((-pow(2, _of.P - 2, _of.P)) % _of.P)
    zeta = _of.Fq2(b, _of.P - b)
    if _fq2_pow_host(zeta, 8) != _of.Fq2(1, 0) or _fq2_pow_host(zeta, 4) == _of.Fq2(1, 0):
        raise ValueError("zeta is not a primitive 8th root of unity")
    roots8 = [_fq2_pow_host(zeta, i) for i in range(8)]
    zm = _fq2_pow_host(SSWU_Z, _M8)
    jz = roots8.index(zm)
    z_half = _fq2_pow_host(SSWU_Z, (_M8 + 1) // 2)
    cf = []
    for j in range(8):
        if j % 2 == 0:
            cf.append(roots8[(8 - j) // 2 % 8])
        else:
            j2 = (j + jz) % 8
            cf.append(z_half * roots8[(8 - j2) // 2 % 8])
    return np.stack([_fq2_np(r) for r in roots8]), np.stack([_fq2_np(c) for c in cf])


_ROOTS8, _SQRT_CF = _sqrt_constants()


@functools.lru_cache(maxsize=None)
def _sqrt_program():
    """The joint (w, conj(w)) Fq2 chain as a chain-kernel program: steps are
    the fq2_sqr_lazy / fq2_mul_lazy plans (SQR2 / MUL2 at CHAIN_BOUND)."""
    from . import chain_plans, fused_mul

    cb = plans.CHAIN_BOUND
    sqr = fused_mul.prepare_plan(plans.SQR2, 2, cb, cb, "fq2_sqr_c", cb).sched
    mul = fused_mul.prepare_plan(plans.MUL2, 2, cb, cb, "fq2_mul_c", cb).sched
    sched = chain_plans.compile_chains((_SQRT_E0, _SQRT_E1), signed=False)
    return chain_plans.field_chain_program("fq2_sqrt", sched, sqr, mul, one_np(2))


def _sqrt_chain(w):
    """w^((q-9)/16) as the 2-lane joint Frobenius chain: one chain-kernel
    launch, then the product of the two chains."""
    from . import fused_mul

    bases = torch.stack([w, plans.carry_norm(fq2_conj(w))])
    out = fused_mul.run_chain(_sqrt_program(), bases)
    return plans.execute(
        plans.MUL2, out[0], out[1], plans.CHAIN_BOUND, plans.CHAIN_BOUND, "sqrt_t"
    )


def _sqrt_core(w):
    """(is_qr, t, cf) for w: t = w^((q-9)/16); cf the mu8 correction."""
    t = _sqrt_chain(w)
    z = fq2_mul(fq2_sqr(t), w)
    zc = t_canon(z)
    roots = fq.dconst(_ROOTS8, zc)
    matches = torch.all(
        zc[None] == roots.reshape((8,) + (1,) * (zc.dim() - 2) + zc.shape[-2:]), dim=-1
    ).all(dim=-1)  # [8, *batch]
    odd = matches[1::2].any(dim=0)
    is_qr = ~odd
    cfs = fq.dconst(_SQRT_CF, zc)
    cf = torch.zeros_like(zc)
    for j in range(8):
        cf = cf + torch.where(matches[j][..., None, None], cfs[j], torch.zeros_like(cf))
    return is_qr, t, cf


def fq2_sqrt(a):
    """Square root in Fq2: (root, is_square); the root's sign is unspecified."""
    is_qr, t, cf = _sqrt_core(a)
    root = fq2_mul(fq2_mul(t, a), cf)
    return root, is_qr


def fq2_sqrt_ratio(u, v):
    """RFC 9380 sqrt_ratio in Fq2: (b, y) with y^2 = u/v when b else Z*u/v."""
    v2 = fq2_sqr(v)
    uv = fq2_mul(u, v)
    w = fq2_mul(uv, v2)
    is_qr, t, cf = _sqrt_core(w)
    y = fq2_mul(fq2_mul(t, uv), cf)
    return is_qr, y


_MUL2_MANY: dict[int, plans.Plan] = {}


def _mul2_many_plan(k: int) -> plans.Plan:
    if k not in _MUL2_MANY:
        p = plans.Plan(2 * k, 2 * k)
        out = []
        for i in range(k):
            x = [plans.LC.basis(2 * i), plans.LC.basis(2 * i + 1)]
            out += p.mul2(x, x)
        p.out_rows = out
        _MUL2_MANY[k] = p
    return _MUL2_MANY[k]


def fq2_mul_many(pairs, in_bound=PUB_BOUND):
    """k independent fq2 products in one kernel launch."""
    k = len(pairs)
    plan = _mul2_many_plan(k)
    A = torch.cat([p[0] for p in pairs], dim=-2)
    B = torch.cat([p[1] for p in pairs], dim=-2)
    out = plans.execute(plan, A, B, in_bound, in_bound, f"fq2_mul_many{k}")
    return [out[..., 2 * i : 2 * i + 2, :] for i in range(k)]


# --------------------------------------------------------------------------------------
# Fq6 (used by fq12 inversion)
# --------------------------------------------------------------------------------------


def fq6_mul(a, b, in_bound=PUB_BOUND):
    return plans.execute(plans.MUL6, a, b, in_bound, in_bound, "fq6_mul")


def fq6_nr(a):
    c2 = fq2_mul_by_nonresidue(a[..., 4:6, :])
    return torch.cat([c2, a[..., 0:4, :]], dim=-2)


def fq6_neg(a, b_bound: _Bound = PUB_BOUND):
    return t_neg(a, b_bound)


def fq6_inv(a):
    PUB = PUB_BOUND
    a0, a1, a2 = a[..., 0:2, :], a[..., 2:4, :], a[..., 4:6, :]
    s0, s2, s1, m12, m01, m02 = fq2_mul_many(
        [(a0, a0), (a2, a2), (a1, a1), (a1, a2), (a0, a1), (a0, a2)]
    )
    nrb = nr_bound(PUB)
    t0 = t_sub(s0, fq2_mul_by_nonresidue(m12), nrb)
    t0_b = plans.sub_bound(PUB, nrb)
    t1 = fq2_sub(fq2_mul_by_nonresidue(s2), m01)
    t1_b = plans.sub_bound(nrb, PUB)
    t2 = fq2_sub(s1, m02)
    t2_b = plans.sub_bound(PUB, PUB)
    lazy = t0_b | t1_b | t2_b
    m0, m1, m2 = fq2_mul_many([(a0, t0), (a2, t1), (a1, t2)], in_bound=lazy)
    denom = fq2_add(m0, fq2_mul_by_nonresidue(fq2_add(m1, m2), PUB.scaled(2)))
    dinv = fq2_inv(denom)
    r0, r1, r2 = fq2_mul_many([(t0, dinv), (t1, dinv), (t2, dinv)], in_bound=lazy)
    return torch.cat([r0, r1, r2], dim=-2)


# --------------------------------------------------------------------------------------
# Fq12
# --------------------------------------------------------------------------------------


def fq12_mul(a, b, in_bound=PUB_BOUND):
    return plans.execute(plans.MUL12, a, b, in_bound, in_bound, "fq12_mul")


def fq12_sqr(a, in_bound=PUB_BOUND):
    return plans.execute(plans.SQR12, a, a, in_bound, in_bound, "fq12_sqr")


def fq12_conj(a):
    """p^6 Frobenius: negate the w coefficient (carry-normalized)."""
    return torch.cat([a[..., 0:6, :], plans.carry_norm(fq6_neg(a[..., 6:12, :]))], dim=-2)


def fq12_inv(a):
    a0, a1 = a[..., 0:6, :], a[..., 6:12, :]
    s0 = fq6_mul(a0, a0)
    s1 = fq6_mul(a1, a1)
    t = fq6_inv(t_canon(t_sub(s0, fq6_nr(s1), nr_bound(PUB_BOUND))))
    c0 = fq6_mul(a0, t)
    c1 = plans.carry_norm(fq6_neg(fq6_mul(a1, t)))
    return torch.cat([c0, c1], dim=-2)


def fq12_frobenius1(a):
    return plans.execute(plans.FROB12, a, a, PUB_BOUND, PUB_BOUND, "frob12")


def fq12_frobenius(a, power: int):
    for _ in range(power % 12):
        a = fq12_frobenius1(a)
    return a


def fq12_cyclotomic_sqr(a, in_bound=PUB_BOUND):
    return plans.execute(plans.CYC_SQR, a, a, in_bound, in_bound, "cyc_sqr")


def fq12_mul_lazy(a, b, in_bound=None):
    bd, ob = plans.f12_interior()
    bd = in_bound or bd
    return plans.execute(plans.MUL12, a, b, bd, bd, "fq12_mul_c", out_bound=ob)


def fq12_sqr_lazy(a, in_bound=None):
    bd, ob = plans.f12_interior()
    bd = in_bound or bd
    return plans.execute(plans.SQR12, a, a, bd, bd, "fq12_sqr_c", out_bound=ob)


def fq12_cyclotomic_sqr_lazy(a, in_bound=None):
    bd, ob = plans.f12_interior()
    bd = in_bound or bd
    return plans.execute(plans.CYC_SQR, a, a, bd, bd, "cyc_sqr_c", out_bound=ob)


@functools.lru_cache(maxsize=None)
def _cyc_exp_program():
    """The |x| double-and-add unroll (curve.fixed_schedule(-x)) as a
    chain-kernel program: slot 0 the base, slot 1 the accumulator; steps
    CYC_SQR and MUL12 at the fq12 interior bound."""
    from . import fused_mul
    from .curve import fixed_schedule

    segs = fixed_schedule(-_of.BLS_X)
    if segs[0] != (1, 1):
        raise ValueError("BLS |x| starts 0b11")
    bd, ob = plans.f12_interior()
    cyc = fused_mul.prepare_plan(plans.CYC_SQR, 12, bd, bd, "cyc_sqr_c", ob).sched
    mul = fused_mul.prepare_plan(plans.MUL12, 12, bd, bd, "fq12_mul_c", ob).sched
    CYC, MUL, BASE, ACC = 0, 1, 0, 1
    steps = [(CYC, ACC, BASE, (BASE,)), (MUL, ACC, ACC, (BASE,))]
    for run, mul_after in segs[1:]:
        steps += [(CYC, ACC, ACC, (ACC,))] * run
        if mul_after:
            steps.append((MUL, ACC, ACC, (BASE,)))
    return fused_mul.ChainProgram("cyc_exp_abs_x", (cyc, mul), 1, 12, 2, BASE, ACC, steps)


def fq12_cyclotomic_exp_abs_x(a):
    """a^|x| (|x| = 0xd201000000010000): the |x| double-and-add schedule
    unrolled on the host and run as ONE chain-kernel launch, lazy fq12
    interiors, one public-bound walk at the end (the reference's default,
    uncompressed arm)."""
    from . import fused_mul

    return plans.carry_norm(fused_mul.run_chain(_cyc_exp_program(), a[None])[0])


def fq12_is_one(a):
    return t_eq(a, one_like(12, a))
