"""G1 (E(Fq): y^2 = x^3 + 4) ops: curve.py at k = 1.

Port of the parts of ``lighthouse_tpu/ops/bls/g1.py`` that the verify path
uses (scale_u64, psum, to_affine, is_inf) plus host conversions for tests.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve, fq, tower

K = 1


def scale_u64(p, scalars):
    return curve.scale_u64(K, p, scalars)


def psum(pts, valid=None):
    return curve.point_sum(K, pts, valid)


def to_affine(p):
    return curve.to_affine(K, p)


def is_inf(p):
    return curve.is_inf(K, p)


def from_oracle(p, device):
    """Oracle affine point (or None) -> projective [3, 25] on ``device``."""
    if p is None:
        return curve.inf_point(K, (), device).clone()
    return torch.cat(
        [fq.from_int(p[0], device)[None], fq.from_int(p[1], device)[None], tower.one(1, (), device)],
        dim=0,
    )


def oracle_limbs(pts):
    """Oracle affine points (None = infinity) -> projective [n, 3, 25] int64
    limbs in one host array."""
    out = np.broadcast_to(curve.inf_np(K), (len(pts), 3, fq.NLIMBS)).copy()
    fin = [i for i, p in enumerate(pts) if p is not None]
    if fin:
        out[fin, 0] = fq.ints_to_limbs([pts[i][0] for i in fin])
        out[fin, 1] = fq.ints_to_limbs([pts[i][1] for i in fin])
        out[fin, 2] = tower.one_np(K)[0]
    return out


def from_oracle_batch(pts, device):
    """Oracle affine points (None = infinity) -> projective [n, 3, 25] on
    ``device``: the limbs built on the host in one array, one upload."""
    return torch.from_numpy(oracle_limbs(pts)).to(device)


def to_oracle(p):
    """Projective point -> oracle affine (or None)."""
    if bool(is_inf(p)):
        return None
    x, y = to_affine(p)
    return (fq.to_int(x[0]), fq.to_int(y[0]))
