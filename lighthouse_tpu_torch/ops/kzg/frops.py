"""Fr (BLS12-381 scalar field) limb arithmetic on int64 tensors.

The port of ``lighthouse_tpu/ops/kzg/frops.py``. Fr elements reuse the
25x16-bit limb layout of ``ops/bls/fq`` (canonical values < r, 255 bits, in
the low 16 limbs; the top 9 limbs zero), held as int64. A product is
``fq.conv_product`` (the reference's digit convolution, 50 exact
accumulators), a dot product sums the digit outer products before one shear
(the convolution is linear, so the sum equals the sum of the products'
accumulators), and one ``fr_wide_reduce`` brings a wide value back to
canonical form mod r:

    carry-normalize to exact 16-bit limbs
      -> fold limbs >= 16 with rows 2^(16*(16+j)) mod r  (repeat; each tail
         round shaves ~3.3 bits since 2^256 mod r ~ 2^252.7)
      -> conditional-subtract ladder of 2r, r

The reference proves its accumulators against 2^63 - 1 in uint64; here they
are int64, so the same numbers are proved against the same limit through
the port's raising ``fq._cert`` (``kzg.*`` kinds).
"""

from __future__ import annotations

import numpy as np
import torch

from ...oracle.fields import R as R_INT
from ..bls import fq

NLIMBS = fq.NLIMBS
LIMB_BITS = fq.LIMB_BITS
R2_INT = R_INT * R_INT
_I64_MAX = (1 << 63) - 1

# fold rows: 2^(16*(16+j)) mod r as exact 16-limb rows (j up to 24 covers wide
# values through 2^640 — far past the 2^522 worst case certified)
_N_FOLD = 24
_FOLD_INT = [pow(2, LIMB_BITS * (16 + j), R_INT) for j in range(_N_FOLD)]
_FOLD_TAB = np.stack([fq.int_to_limbs(v)[:16] for v in _FOLD_INT])

# conditional-subtract ladder constants (25 exact 16-bit limbs)
_MR_LIMBS = {m: fq.int_to_limbs(m * R_INT) for m in (2, 1)}

# MSB-first bit extraction: bit m (m = 0 is bit 254) lives in limb pos // 16
# at offset pos % 16 with pos = 254 - m
_BIT_POS = np.arange(254, -1, -1)
_BIT_LIMB = (_BIT_POS // LIMB_BITS).astype(np.int64)
_BIT_OFF = (_BIT_POS % LIMB_BITS).astype(np.int64)


def fr_to_limbs(vals) -> np.ndarray:
    """Host: iterable of canonical ints -> int64 [n, 25] limb rows."""
    vals = list(vals)
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    a = np.frombuffer(raw, dtype="<u2").reshape(len(vals), 16)
    out = np.zeros((len(vals), NLIMBS), dtype=np.int64)
    out[:, :16] = a
    return out


def limbs_to_fr(a) -> int:
    """Host: one canonical limb row -> Python int."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return fq.limbs_to_int(a)


def _normalize(t, width: int):
    """Exact 16-bit limbs over ``width`` limbs (padded first, so carries can
    spill into the high limbs the value is entitled to)."""
    if t.shape[-1] < width:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (width - t.shape[-1],))], dim=-1)
    return fq._carry_propagate(t, width)


def fr_wide_reduce(t, value_bound: int):
    """Wide 16-bit-radix int64 accumulator [..., L] with value < value_bound
    -> canonical Fr limbs [..., 25]. The fold/normalize schedule is resolved
    from ``value_bound`` on the host; no branch depends on the data."""
    fq._cert("kzg.fr_reduce.in_value", value_bound, 1 << (LIMB_BITS * 40),
             note="wide Fr value fits the fold table")
    width = max(16, -(-value_bound.bit_length() // LIMB_BITS))
    t = _normalize(t, width)  # exact 16-bit limbs, value-preserving
    vb = value_bound
    while width > 16 and vb > (1 << 256) + _FOLD_INT[0]:
        hi_w = width - 16
        caps = [
            min((1 << LIMB_BITS) - 1, vb >> (LIMB_BITS * (16 + j))) for j in range(hi_w)
        ]
        # fold contribution per output limb: sum_j cap_j * 0xFFFF, plus the
        # 16-bit low limb
        limb_bound = ((1 << LIMB_BITS) - 1) * (1 + sum(caps))
        fq._cert("kzg.fr_reduce.fold_limb", limb_bound, _I64_MAX,
                 note="fold accumulator limbs stay exact in int64")
        rows = fq.dconst(_FOLD_TAB, t)[:hi_w]
        fold = (t[..., 16:width, None] * rows).sum(dim=-2)
        vb = (1 << 256) - 1 + sum(c * f for c, f in zip(caps, _FOLD_INT))
        width = max(16, -(-vb.bit_length() // LIMB_BITS))
        t = _normalize(t[..., :16] + fold, width)
    fq._cert("kzg.fr_reduce.tail", vb, 4 * R_INT,
             note="post-fold value inside the 2r/r subtract ladder")
    t = torch.cat([t, t.new_zeros(t.shape[:-1] + (NLIMBS - t.shape[-1],))], dim=-1)
    for m in (2, 1):
        diff, borrow = fq._sub_limbs(t, fq.dconst(_MR_LIMBS[m], t))
        t = torch.where((borrow == 1)[..., None], t, diff)
    return t


def _conv_bound() -> int:
    return max(fq.conv_limb_bounds((1 << LIMB_BITS) - 1))


def fr_mul(a, b):
    """Canonical [..., 25] x [..., 25] (broadcast) -> canonical product mod r."""
    _conv_bound()  # certify conv exactness
    return fr_wide_reduce(fq.conv_product(a, b), R2_INT)


def dot_accumulators(a, b):
    """The unreduced 50 accumulators of sum_j a[..., j, :] * b[..., j, :]
    for canonical inputs [..., K, 25] (broadcast), value < K r^2: the K digit
    outer products summed, one shear. The summed digit accumulators are each
    below the summed limb accumulators, which the certificate bounds."""
    k = torch.broadcast_shapes(a.shape, b.shape)[-2]
    fq._cert("kzg.fr_dot.acc", k * _conv_bound(), _I64_MAX,
             note="summed conv accumulators stay exact in int64")
    return fq.conv_from_outer(fq.digit_outer(a, b).sum(dim=-3))


def fr_dot(a, b):
    """sum_j a[..., j, :] * b[..., j, :] mod r for canonical inputs
    [..., K, 25] (broadcast): ``dot_accumulators`` and one reduction."""
    k = torch.broadcast_shapes(a.shape, b.shape)[-2]
    return fr_wide_reduce(dot_accumulators(a, b), k * R2_INT)


def fr_weighted_sum(w, u, batch: int):
    """sum over the LEADING axis of w*u mod r (w, u: [B, ..., 25] canonical;
    ``batch`` must equal the leading extent): the aggregation stage of the
    batched verifier, one accumulator sum over the batch, one reduction per
    output element."""
    if w.shape[0] != batch or u.shape[0] != batch:
        raise ValueError("fr_weighted_sum: batch extent mismatch")
    fq._cert("kzg.fr_wsum.acc", batch * _conv_bound(), _I64_MAX,
             note="batch-summed conv accumulators stay exact in int64")
    t = fq.conv_from_outer(fq.digit_outer(w, u).sum(dim=0))
    return fr_wide_reduce(t, batch * R2_INT)


def fr_bits(s):
    """Canonical limbs [..., 25] -> int64 bit plane [255, ...] MSB-first (the
    ``curve.scale_bits`` input layout), extracted on the device."""
    v = s[..., fq.dconst(_BIT_LIMB, s)]
    bits = (v >> fq.dconst(_BIT_OFF, s)) & 1
    return torch.movedim(bits, -1, 0)
