"""Batched KZG cell-proof verification: ONE combined pairing check per batch.

The port of ``lighthouse_tpu/ops/kzg/verify.py``. Per cell (EIP-7594
verify_cell_kzg_proof): with coset H_i = {c_i mu^t}, d_i = c_i^k, interpolant
I_i of the cell values on H_i, and proof Q_i,

    e(C_i - [I_i(tau)], G2) * e(-Q_i, [tau^k - d_i]G2) == 1.

Expanding the second pair through T2 = [tau^k]G2 and folding the batch with
Fiat-Shamir weights r_i turns B checks into TWO pairs:

    e( sum_i r_i (C_i - [I_i] + d_i Q_i),  G2 )
  * e( -sum_i r_i Q_i,                     T2 )  ==  1

where sum_i r_i [I_i] is ONE trusted-setup MSM with device-computed scalars:
cell values arrive in bit-reversed coset order, so one static gather plus one
shared k x k inverse-NTT matrix over mu and a per-coset descale c_i^{-t}
yield the monomial interpolant coefficients,

    a_{i,t} = c_i^{-t} * U_{i,t},   U_i = M v'_i,  M[t,j] = mu^{-jt}/k,

and the aggregated setup scalars s_t = sum_i (r_i c_i^{-t}) U_{i,t} are one
``frops.fr_weighted_sum``. Every scalar multiply funnels into ONE
``curve.scale_bits`` ladder over 3B + k lanes, two halving point trees and
one Miller product with a single final exponentiation.

``PROBE`` counts at run time what each call runs — pairing checks, pairs and
scale ladders (the reference counts them at trace time; a torch program is
its run).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bls import curve, pairing
from . import frops

PROBE = {"pairing_checks": 0, "pairs": 0, "scale_scans": 0}

# elements of the digit outer products interpolate_rows holds at once (int64:
# 512 MiB)
_INTERP_ELEMS = 1 << 26


class VerifyTables(NamedTuple):
    """Static per-context constants (host-built once per CellContext), as
    int64 tensors on the engine's device.

    perm   [k]             bit-reversal chunk order -> natural coset order
    idft   [k, k, 25]      M[t, j] = mu^{-jt} / k mod r (Fr limbs)
    cinv   [cells, k, 25]  c_i^{-t} descale rows
    dtab   [cells, 25]     d_i = c_i^k
    setup  [k, 3, 25]      G1 monomial setup points (projective)
    g2x/y  [2, 25]         G2 generator (affine Fq2)
    t2x/y  [2, 25]         [tau^k]G2 (affine Fq2)
    """

    perm: torch.Tensor
    idft: torch.Tensor
    cinv: torch.Tensor
    dtab: torch.Tensor
    setup: torch.Tensor
    g2x: torch.Tensor
    g2y: torch.Tensor
    t2x: torch.Tensor
    t2y: torch.Tensor


def interpolate_rows(tables: VerifyTables, v):
    """Cell values [B, k, 25] (bit-reversed coset order) -> mu-basis
    interpolant rows U [B, k, 25]: the static permutation gather, then the
    shared inverse-NTT matrix a chunk of cells and rows at a time, and one
    reduction of every row's exact accumulators at the end (the reference
    reduces row by row: the same canonical values). A chunk's digit outer
    products [cells, rows, k, 51, 51] are held under ``_INTERP_ELEMS`` at any
    batch size, as the reference's scan holds one row's; only when a single
    (cell, row) product, k * 51 * 51 elements, exceeds the cap is a chunk
    that one product."""
    nat = v[:, tables.perm][:, None]  # [B, 1, k, 25]
    b, k = v.shape[0], v.shape[1]
    per = k * 51 * 51  # elements of one (cell, row) outer product
    cells = max(1, min(b, _INTERP_ELEMS // per))
    rows = max(1, _INTERP_ELEMS // (cells * per))
    acc = torch.cat([
        torch.cat([
            frops.dot_accumulators(nat[c0 : c0 + cells], tables.idft[t0 : t0 + rows][None])
            for t0 in range(0, tables.idft.shape[0], rows)
        ], dim=1)
        for c0 in range(0, b, cells)
    ], dim=0)
    return frops.fr_wide_reduce(acc, k * frops.R2_INT)


def batch_scalars(tables: VerifyTables, v, r, idx):
    """The Fr stage of the batch check: the interpolant rows, the per-cell
    descaled weights r_i c_i^{-t}, the aggregated setup scalars s [k, 25]
    and the shift weights r_i d_i [B, 25]."""
    u = interpolate_rows(tables, v)
    w = frops.fr_mul(r[:, None, :], tables.cinv[idx])  # [B, k, 25]
    s = frops.fr_weighted_sum(w, u, v.shape[0])
    return s, frops.fr_mul(r, tables.dtab[idx])


def cell_batch_check(tables: VerifyTables, v, r, idx, cx, cy, cinf, qx, qy, qinf):
    """The one-combined-check verification.

    v    [B, k, 25]  cell field elements (canonical Fr limbs)
    r    [B, 25]     Fiat-Shamir weights (canonical, nonzero)
    idx  [B]         cell/coset indices
    cx/cy/cinf, qx/qy/qinf: commitment / proof affine Fq limbs [B, 25]
                     and infinity masks [B]

    Returns a 0-d bool tensor. Zero-weight rows (r_i = 0) contribute the
    identity on both sides, so callers pad ragged batches with
    (r = 0, C = Q = inf) rows to keep shapes bucketed.
    """
    b = v.shape[0]
    s, rd = batch_scalars(tables, v, r, idx)

    # every scalar multiply in one ladder: C by r, Q by r*d, Q by r, setup by s
    c_pt = curve.from_affine(1, cx[:, None, :], cy[:, None, :], inf=cinf)
    q_pt = curve.from_affine(1, qx[:, None, :], qy[:, None, :], inf=qinf)
    setup_neg = curve.point_neg(1, tables.setup)
    pts = torch.cat([c_pt, q_pt, q_pt, setup_neg], dim=0)
    bits = torch.cat(
        [frops.fr_bits(r), frops.fr_bits(rd), frops.fr_bits(r), frops.fr_bits(s)], dim=1
    )
    scaled = curve.scale_bits(1, pts, bits)  # [3B + k, 3, 25]
    PROBE["scale_scans"] += 1

    # lhs = sum r_i C_i + sum r_i d_i Q_i - sum s_t setup_t
    lhs = curve.point_sum(1, torch.cat([scaled[: 2 * b], scaled[3 * b :]], dim=0))
    q_neg = curve.point_neg(1, curve.point_sum(1, scaled[2 * b : 3 * b]))
    return _two_pair_check(lhs, q_neg, tables.g2x, tables.g2y, tables.t2x, tables.t2y)


def cell_single_check(z2_tab, v, r_one, idx, cx, cy, cinf, qx, qy, qinf, tables: VerifyTables):
    """Single-cell check against the coset table ``z2_tab`` ([cells, 6, 25]
    projective [tau^k - d_i]G2 rows): the direct two-pair form
    e(C - [I], G2) * e(-Q, Z_i) == 1 without RLC weights. Shapes are the
    B = 1 slice of the batch layout."""
    u = interpolate_rows(tables, v)  # [1, k, 25]
    a = frops.fr_mul(r_one[:, None, :], tables.cinv[idx])  # r_one = 1: descale only
    s = frops.fr_weighted_sum(a, u, 1)  # [k, 25]

    setup_scaled = curve.scale_bits(1, tables.setup, frops.fr_bits(s))
    PROBE["scale_scans"] += 1
    i_commit = curve.point_sum(1, setup_scaled)
    c_pt = curve.from_affine(1, cx[:, None, :], cy[:, None, :], inf=cinf)[0]
    q_pt = curve.from_affine(1, qx[:, None, :], qy[:, None, :], inf=qinf)[0]
    lhs = curve.point_add(1, c_pt, curve.point_neg(1, i_commit))
    q_neg = curve.point_neg(1, q_pt)
    z2x, z2y = curve.to_affine(2, z2_tab[idx[0]])
    return _two_pair_check(lhs, q_neg, tables.g2x, tables.g2y, z2x, z2y)


def _two_pair_check(lhs, q_neg, g2x, g2y, qx2, qy2):
    """e(lhs, (g2x, g2y)) * e(q_neg, (qx2, qy2)) == 1; an infinity side
    contributes e(inf, .) = 1 and is masked out."""
    lx, ly = curve.to_affine(1, lhs)
    nx, ny = curve.to_affine(1, q_neg)
    px = torch.stack([lx[0], nx[0]], dim=0)
    py = torch.stack([ly[0], ny[0]], dim=0)
    g2qx = torch.stack([g2x, qx2])
    g2qy = torch.stack([g2y, qy2])
    valid = torch.stack([~curve.is_inf(1, lhs), ~curve.is_inf(1, q_neg)])
    PROBE["pairing_checks"] += 1
    PROBE["pairs"] += 2
    return pairing.multi_pairing_is_one(px, py, g2qx, g2qy, valid)
