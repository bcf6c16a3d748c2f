"""G2 (E'(Fq2): y^2 = x^3 + 4(u+1)) ops: curve.py at k = 2 plus psi and
decompression.

Port of ``lighthouse_tpu/ops/bls/g2.py`` (the parts the verify path uses):
psi(x, y) = (CX conj(x), CY conj(y)) acts as multiplication by the BLS
parameter x on the r-order subgroup; ``decompress`` recovers y from a
compressed signature's x and sign bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve, fq, plans, tower
from ...oracle.fields import P, Fq2

K = 2

_XI = Fq2(1, 1)
_CX = _XI.pow((P - 1) // 3).inv()
_CY = _XI.pow((P - 1) // 2).inv()

_CX_NP = np.stack([fq.int_to_limbs(_CX.c0), fq.int_to_limbs(_CX.c1)])
_CY_NP = np.stack([fq.int_to_limbs(_CY.c0), fq.int_to_limbs(_CY.c1)])
B2_NP = np.stack([fq.int_to_limbs(4), fq.int_to_limbs(4)])  # curve constant 4(u+1)


def scale_u64(p, scalars):
    return curve.scale_u64(K, p, scalars)


def scale_fixed(p, e: int):
    return curve.scale_fixed(K, p, e)


def psum(pts, valid=None):
    return curve.point_sum(K, pts, valid)


def to_affine(p):
    return curve.to_affine(K, p)


def is_inf(p):
    return curve.is_inf(K, p)


def psi(p):
    """(CX conj(X) : CY conj(Y) : conj(Z))."""
    x, y, z = p[..., 0:2, :], p[..., 2:4, :], p[..., 4:6, :]

    def conj(a):
        return plans.carry_norm(tower.fq2_conj(a))

    xn = tower.fq2_mul(conj(x), fq.dconst(_CX_NP, x).expand(x.shape))
    yn = tower.fq2_mul(conj(y), fq.dconst(_CY_NP, y).expand(y.shape))
    return torch.cat([xn, yn, conj(z)], dim=-2)


def lex_sign(y):
    """ZCash G2 sign bit: c1 > (p-1)/2 if c1 != 0 else c0 > (p-1)/2."""
    c = fq.canonical(y)
    c0, c1 = c[..., 0, :], c[..., 1, :]
    return torch.where(fq.is_zero(c1), fq.lex_gt_half_canon(c0), fq.lex_gt_half_canon(c1))


def decompress(x_mont, s_flag):
    """x [..., 2, 25] (raw residue limbs); s_flag [...]. Returns
    (point [..., 6, 25], ok [...]): ok = y^2 = x^3 + b is solvable.
    Infinity and flag parsing happen on the host (serde)."""
    x = x_mont
    rhs = plans.carry_norm(tower.fq2_mul(tower.fq2_sqr(x), x) + fq.dconst(B2_NP, x).expand(x.shape))
    y, ok = tower.fq2_sqrt(rhs)
    flip = lex_sign(y) ^ (s_flag == 1)
    y = plans.carry_norm(tower.t_select(flip, tower.fq2_neg(tower.t_canon(y)), y))
    return curve.from_affine(K, x, y), ok


def from_oracle(p, device):
    if p is None:
        return curve.inf_point(K, (), device).clone()
    return torch.cat(
        [
            tower.from_ints([p[0].c0, p[0].c1], device),
            tower.from_ints([p[1].c0, p[1].c1], device),
            tower.one(2, (), device),
        ],
        dim=0,
    )


def from_oracle_batch(pts, device):
    """Oracle affine points (None = infinity) -> projective [n, 6, 25] on
    ``device``: the limbs built on the host in one array, one upload."""
    out = np.broadcast_to(curve.inf_np(K), (len(pts), 6, fq.NLIMBS)).copy()
    fin = [i for i, p in enumerate(pts) if p is not None]
    if fin:
        for j, (c, part) in enumerate(((0, "c0"), (0, "c1"), (1, "c0"), (1, "c1"))):
            out[fin, j] = fq.ints_to_limbs([getattr(pts[i][c], part) for i in fin])
        out[fin, 4:6] = tower.one_np(K)
    return torch.from_numpy(out).to(device)


def to_oracle(p):
    if bool(is_inf(p)):
        return None
    x, y = to_affine(p)
    return (Fq2(*tower.to_ints(tower.t_canon(x))), Fq2(*tower.to_ints(tower.t_canon(y))))
