"""G1 (E(Fq): y^2 = x^3 + 4) ops: curve.py at k = 1.

Port of the parts of ``lighthouse_tpu/ops/bls/g1.py`` that the verify path
uses (scale_u64, psum, to_affine, is_inf) plus host conversions for tests.
"""

from __future__ import annotations

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


def from_oracle_batch(pts, device):
    return torch.stack([from_oracle(p, device) for p in pts])


def to_oracle(p):
    """Projective point -> oracle affine (or None)."""
    if bool(is_inf(p)):
        return None
    x, y = to_affine(p)
    return (fq.to_int(x[0]), fq.to_int(y[0]))
