"""Vectorized compressed-point byte parsing (ZCash/Eth2 serialization).

The port's own copy of the parts of ``lighthouse_tpu/bls/serde.py`` the verify
path uses: big-endian bytes with 3 flag bits in the top byte (compression,
infinity, lex-largest-y sign) become 16-bit limb arrays plus flag and
validity vectors, in numpy, with no per-item Python.
"""

from __future__ import annotations

import numpy as np

from ..oracle.fields import P

_P_LIMBS24 = np.array([(P >> (16 * i)) & 0xFFFF for i in range(24)], dtype=np.int64)


def _be_bytes_to_limbs(chunk: np.ndarray) -> np.ndarray:
    """[n, 48] big-endian bytes (flags cleared) -> [n, 25] int64 little-endian
    16-bit limbs (raw residue)."""
    n = chunk.shape[0]
    pairs = chunk.reshape(n, 24, 2).astype(np.int64)
    limbs_be = (pairs[:, :, 0] << 8) | pairs[:, :, 1]
    limbs = limbs_be[:, ::-1]
    return np.concatenate([limbs, np.zeros((n, 1), dtype=np.int64)], axis=1)


def _limbs_lt_p(limbs: np.ndarray) -> np.ndarray:
    """[n, 25] raw limbs < p? (big-endian compare on 24 limbs)."""
    a = limbs[:, :24]
    gt = np.zeros(a.shape[0], dtype=bool)
    lt = np.zeros(a.shape[0], dtype=bool)
    for i in range(23, -1, -1):
        ai, pi = a[:, i], _P_LIMBS24[i]
        gt |= ~lt & ~gt & (ai > pi)
        lt |= ~lt & ~gt & (ai < pi)
    return lt


def parse_g2_bytes(data: np.ndarray):
    """[n, 96] uint8 -> x_c0/x_c1 [n, 25] int64, s_flag [n] int64, is_inf,
    wf_ok (compression bit set, canonical coordinates, legal flags, exact
    infinity pattern). Byte layout: x.c1 first (with flags), then x.c0."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    top = data[:, 0]
    c_flag = (top >> 7) & 1
    i_flag = (top >> 6) & 1
    s_flag = (top >> 5) & 1
    cleared = data.copy()
    cleared[:, 0] &= 0x1F
    c1 = _be_bytes_to_limbs(cleared[:, 0:48])
    c0 = _be_bytes_to_limbs(cleared[:, 48:96])
    rest_zero = (cleared == 0).all(axis=1)
    wf = (c_flag == 1) & _limbs_lt_p(c0) & _limbs_lt_p(c1)
    inf_ok = (i_flag == 1) & (s_flag == 0) & rest_zero
    wf = wf & ((i_flag == 0) | inf_ok)
    return {
        "x_c0": c0,
        "x_c1": c1,
        "s_flag": s_flag.astype(np.int64),
        "is_inf": i_flag == 1,
        "wf_ok": wf,
    }


def raw_to_mont(x):
    """Raw-residue limbs -> field-element limbs: the field layer works on
    plain residues, so parsed canonical limbs ARE the element (the
    reference's name, kept)."""
    return x
