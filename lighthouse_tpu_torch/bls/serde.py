"""Vectorized compressed-point byte parsing (ZCash/Eth2 serialization).

The port's own copy of ``lighthouse_tpu/bls/serde.py``: G1 public keys are
48 bytes, G2 signatures 96; big-endian field elements with 3 flag bits in
the top byte (compression, infinity, lex-largest-y sign) become 16-bit limb
arrays plus flag and validity vectors, and back, in numpy, with no per-item
Python. Limbs are int64 (the port's limb dtype), not the reference's uint64.
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


def parse_g1_bytes(data: np.ndarray):
    """[n, 48] uint8 -> x [n, 25] int64 (flags cleared), s_flag [n] int64,
    is_inf, wf_ok (compression bit set, canonical field element, legal flag
    combination, exact infinity pattern)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    top = data[:, 0]
    c_flag = (top >> 7) & 1
    i_flag = (top >> 6) & 1
    s_flag = (top >> 5) & 1
    cleared = data.copy()
    cleared[:, 0] &= 0x1F
    x = _be_bytes_to_limbs(cleared)
    rest_zero = (cleared == 0).all(axis=1)
    wf = (c_flag == 1) & _limbs_lt_p(x)
    # infinity: i_flag set requires s_flag clear and x == 0
    inf_ok = (i_flag == 1) & (s_flag == 0) & rest_zero
    wf = wf & ((i_flag == 0) | inf_ok)
    return {
        "x": x,
        "s_flag": s_flag.astype(np.int64),
        "is_inf": i_flag == 1,
        "wf_ok": wf,
    }


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


def _limbs_to_be_bytes(limbs: np.ndarray) -> np.ndarray:
    """[n, 25] canonical limbs -> [n, 48] big-endian bytes."""
    n = limbs.shape[0]
    a = np.asarray(limbs[:, :24], dtype=np.int64)[:, ::-1]  # big-endian limbs
    out = np.zeros((n, 24, 2), dtype=np.uint8)
    out[:, :, 0] = (a >> 8).astype(np.uint8)
    out[:, :, 1] = (a & 0xFF).astype(np.uint8)
    return out.reshape(n, 48)


def _flags(sign, is_inf) -> np.ndarray:
    return (0x80 | np.where(is_inf, 0x40, np.where(sign.astype(bool), 0x20, 0))).astype(np.uint8)


def encode_g1_bytes(x_raw: np.ndarray, sign: np.ndarray, is_inf: np.ndarray):
    """Canonical affine-x limbs [n, 25] + sign bits + infinity mask -> [n, 48]."""
    x_raw = np.where(is_inf[:, None], 0, np.asarray(x_raw, dtype=np.int64))
    out = _limbs_to_be_bytes(x_raw)
    out[:, 0] |= _flags(sign, is_inf)
    return out


def encode_g2_bytes(c0_raw, c1_raw, sign, is_inf):
    """Canonical affine-x limbs c0, c1 [n, 25] + sign bits + infinity mask ->
    [n, 96] (x.c1 first, then x.c0)."""
    c0_raw = np.where(is_inf[:, None], 0, np.asarray(c0_raw, dtype=np.int64))
    c1_raw = np.where(is_inf[:, None], 0, np.asarray(c1_raw, dtype=np.int64))
    out = np.concatenate([_limbs_to_be_bytes(c1_raw), _limbs_to_be_bytes(c0_raw)], axis=1)
    out[:, 0] |= _flags(sign, is_inf)
    return out
