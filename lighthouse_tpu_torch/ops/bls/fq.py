"""Fq (BLS12-381 base field) arithmetic on int64 limb tensors.

Port of ``lighthouse_tpu/ops/bls/fq.py``, the arm its "pallas" conv backend
takes. Representation: little-endian 16-bit limbs, 25 limbs, plain residues
(no Montgomery domain), shape ``[..., 25]`` — held as **int64** because torch
has no uint64 arithmetic. Every bound the reference proves against 2^64 is
proved here against 2^63 (``_CAP``), and a bound that fails raises.

* Lazy ``add``/``sub``/``neg`` are elementwise limb ops (no carries); the
  operand budget is values < 1200p, limbs < 2^22 (``_IN_VALUE``/``_IN_LIMB``).
* ``mont_mul``/``mont_mul_lazy`` (names kept from the reference) are the fused
  multiply: digit convolution, congruence folds and carry rounds in ONE launch
  of the hand-written CUDA plan kernel (``fused_mul.py``). The output is
  public-bounded: value <= 13p, 17-bit limbs, top limb <= 2.
* ``pow_fixed_scan`` (``inv``, ``sqrt_candidate``) runs its whole chain of
  lazy multiplies as ONE launch of the chain kernel.
* ``canonical`` finishes the reduction to < p with the statically scheduled
  fold/carry walk ``reduce_limbs`` (int64 torch ops outside the kernel, as in
  the reference, where it is u64 XLA code).

Constants are numpy at import time and move to a device on first use, once per
device (``dconst``): importing this module touches no device.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from ...oracle.fields import P

NLIMBS = 25
LIMB_BITS = 16
MASK = 0xFFFF

R_MONT = 1  # plain-residue domain (name kept for call-site parity)

# int64 limbs: every accumulator bound is proved below 2^63
_CAP = 1 << 63


class BoundError(AssertionError):
    """A static bound obligation of the limb arithmetic does not hold."""


# --------------------------------------------------------------------------------------
# Certification sink: every static bound is checked (raising on failure) and,
# when a sink is installed, recorded as (kind, proven, limit, note, ok).
# --------------------------------------------------------------------------------------

_CERT_SINK = None
# per thread: the obligation logs of the static derivations in progress
_CAPTURE = threading.local()


def _record(rec: tuple) -> None:
    """One obligation (kind, proven, limit, note, ok) into the sink and into
    every derivation log open on this thread."""
    if _CERT_SINK is not None:
        kind, proven, limit, note, ok = rec
        _CERT_SINK.record(kind, proven, limit, note=note, ok=ok)
    for log in getattr(_CAPTURE, "stack", ()):
        log.append(rec)


def _cert(kind: str, proven: int, limit: int, note: str = "") -> bool:
    """Check the obligation ``proven <= limit``: record it in the sink (if
    one is installed) and raise ``BoundError`` when it fails."""
    ok = proven <= limit
    _record((kind, proven, limit, note, ok))
    if not ok:
        raise BoundError(f"{kind} ({note}): bound {proven} exceeds {limit}")
    return ok


@contextlib.contextmanager
def capture_certs():
    """Collect the obligations recorded (or replayed) on this thread while
    active, nested logs included in their enclosing ones."""
    stack = _CAPTURE.__dict__.setdefault("stack", [])
    log: list = []
    stack.append(log)
    try:
        yield log
    finally:
        stack.pop()


def replay_certs(log) -> None:
    """Record a cached derivation's obligations again (a cache hit proves
    what the miss proved)."""
    if _CERT_SINK is None and not getattr(_CAPTURE, "stack", None):
        return
    for rec in log:
        _record(rec)


# Build counters: what a steady loop must not redo once warm (uploads of
# constants to a device, misses of the static builders, and fused_mul's
# schedules, uploads and library loads). The build sentinel
# (analysis/recompile.py) reads them.
builds: dict = {"dconst": 0}
_BUILDS_LOCK = threading.Lock()


def _bump(counter: str) -> None:
    with _BUILDS_LOCK:
        builds[counter] = builds.get(counter, 0) + 1


def certified_cache(fn):
    """``functools.lru_cache(maxsize=None)`` for a static builder whose
    derivation proves bound obligations: a miss derives (recording into an
    installed sink as it goes) and keeps what it recorded, a hit replays it,
    so a sink sees the same obligations on every call whatever ran before.
    Misses count in ``builds["cache:<name>"]``."""
    cache: dict = {}
    counter = f"cache:{fn.__name__}"
    with _BUILDS_LOCK:
        builds.setdefault(counter, 0)

    @functools.wraps(fn)
    def cached(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items()))) if kwargs else args
        hit = cache.get(key)
        if hit is not None:
            replay_certs(hit[1])
            return hit[0]
        with capture_certs() as log:
            value = fn(*args, **kwargs)
        _bump(counter)
        return cache.setdefault(key, (value, tuple(log)))[0]

    cached.cache_clear = cache.clear
    return cached


# --------------------------------------------------------------------------------------
# Host helpers and per-device constants
# --------------------------------------------------------------------------------------


def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> int64[25] little-endian 16-bit limbs."""
    return np.array(
        [(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)], dtype=np.int64
    )


def ints_to_limbs(xs) -> np.ndarray:
    """Python ints in [0, 2^400) -> int64 [len(xs), 25] little-endian 16-bit
    limbs, through one byte buffer (no per-limb Python)."""
    buf = b"".join(x.to_bytes(2 * NLIMBS, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, NLIMBS).astype(np.int64)


def limbs_to_int(a) -> int:
    """Limb array (last axis 25, any non-negative limb values) -> Python int."""
    a = np.asarray(a)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a))


_DCONST: dict = {}


def dconst(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` (a long-lived numpy constant) as a tensor on ``like``'s device,
    uploaded once per (array, device). The cache keeps ``arr`` alive, so its
    id cannot be reused by another array."""
    key = (id(arr), like.device)
    hit = _DCONST.get(key)
    if hit is None:
        hit = (arr, torch.from_numpy(np.ascontiguousarray(arr)).to(like.device))
        _DCONST[key] = hit
        _bump("dconst")
    return hit[1]


def from_int(x: int, device) -> torch.Tensor:
    return torch.from_numpy(int_to_limbs(x % P)).to(device)


def from_ints(xs, device) -> torch.Tensor:
    """list of ints -> int64[len(xs), 25] on ``device``."""
    return torch.from_numpy(np.stack([int_to_limbs(x % P) for x in xs])).to(device)


def to_int(a) -> int:
    """Limbs -> Python int mod p (accepts lazy values)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()  # lint: allow(host-sync) host helper: limbs to a Python int
    return limbs_to_int(a) % P


def to_ints(a) -> list:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()  # lint: allow(host-sync) host helper: limbs to Python ints
    return [to_int(a[i]) for i in range(a.shape[0])]


def _inflated_kp(limb_cover: int, top_cover: int) -> np.ndarray:
    """Limbs of the smallest K*p whose borrow-inflated representation has every
    limb 0..23 >= limb_cover and limb 24 >= top_cover."""
    m = max(-(-limb_cover // ((1 << LIMB_BITS) - 1)), 1)
    K = 1
    while True:
        c = [int(v) for v in int_to_limbs(K * P)]
        if (K * P).bit_length() > NLIMBS * LIMB_BITS:
            raise BoundError("inflated K*p exceeds 25 limbs")
        for i in range(1, NLIMBS):
            c[i - 1] += m << LIMB_BITS
            c[i] -= m
        if (
            all(v >= 0 for v in c)
            and all(c[i] >= limb_cover for i in range(24))
            and c[24] >= top_cover
        ):
            if sum(v << (LIMB_BITS * i) for i, v in enumerate(c)) != K * P:
                raise BoundError("inflated constant is not K*p")
            return np.array(c, dtype=np.int64)
        K += 1


P_LIMBS = int_to_limbs(P)
# covers any plans.PUB_BOUND subtrahend (17-bit limbs, top limb <= 2)
SUBPUB = _inflated_kp((1 << 17) - 1, 2)
ONE_M = int_to_limbs(1)

# --------------------------------------------------------------------------------------
# Lazy ring operations
# --------------------------------------------------------------------------------------


def add(a, b):
    return a + b


def sub(a, b):
    """a - b + Kp. b must be public-bounded; a may be lazy."""
    return a + (dconst(SUBPUB, a) - b)


def neg(a):
    """Kp - a. a must be public-bounded."""
    return dconst(SUBPUB, a) - a


def double(a):
    return a + a


def is_zero(a):
    return torch.all(a == 0, dim=-1)


def eq(a, b):
    return torch.all(a == b, dim=-1)


def select(cond, a, b):
    """cond ? a : b, with cond of batch shape (no limb axis)."""
    return torch.where(cond[..., None], a, b)


# --------------------------------------------------------------------------------------
# Carry machinery (exact normalization for comparison sites)
# --------------------------------------------------------------------------------------


def _shift_up_one(t):
    """Shift limbs up one position (the top limb's value is dropped — the
    caller guarantees it is zero)."""
    return torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1]], dim=-1)


def _carry_lookahead(g, p):
    """Inclusive generate/propagate scan over the limb axis (Kogge–Stone, log
    depth): the same result as the reference's associative_scan with the
    carry operator (ga, pa) . (gb, pb) = (gb | (pb & ga), pb & pa)."""
    n = g.shape[-1]
    d = 1
    while d < n:
        g_prev = torch.cat([torch.zeros_like(g[..., :d]), g[..., :-d]], dim=-1)
        p_prev = torch.cat([torch.ones_like(p[..., :d]), p[..., :-d]], dim=-1)
        g = g | (p & g_prev)
        p = p & p_prev
        d *= 2
    return g, p


def _split16(t):
    return t & MASK, t >> LIMB_BITS


def _carry_rounds(t, rounds: int):
    """Width-preserving carry-save rounds: limb bound b -> 0xFFFF + (b >> 16)."""
    for _ in range(rounds):
        lo, hi = _split16(t)
        t = lo + _shift_up_one(hi)
    return t


def _carry_propagate(t, out_limbs: int):
    """Normalize to exact 16-bit limbs, dropping any final carry (the caller
    guarantees the value fits out_limbs limbs)."""
    t = _carry_rounds(t[..., :out_limbs], 4)
    r = t & MASK
    gs = _shift_up_one(t >> LIMB_BITS)
    ssum = r + gs  # <= 0x10000
    G, _ = _carry_lookahead(ssum > MASK, ssum == MASK)
    cin = _shift_up_one(G.to(t.dtype))
    return (ssum + cin) & MASK


def _sub_limbs(a, b):
    """a - b with a borrow chain (canonical operands): (diff, borrow_out)."""
    b = torch.broadcast_to(b, a.shape)
    G, _ = _carry_lookahead(a < b, a == b)
    bin_ = _shift_up_one(G.to(a.dtype))
    diff = (a - b - bin_) & MASK
    return diff, G[..., -1].to(a.dtype)


def _cond_sub_p(a):
    """Subtract p when a >= p (a < 2p, canonical limbs on entry)."""
    diff, borrow = _sub_limbs(a, dconst(P_LIMBS, a))
    return torch.where((borrow == 1)[..., None], a, diff)


# --------------------------------------------------------------------------------------
# Digit layout shared with the fused kernel
# --------------------------------------------------------------------------------------

# Base-2^8 digit split: limb i (< 2^22) contributes bytes to digit positions
# 2i, 2i+1, 2i+2; overlapping chunks add, so digits are <= 255 + (limb >> 16).
_N_DIGITS = 2 * NLIMBS + 1  # 51


def _digit_bound(limb_bound: int) -> int:
    return min(limb_bound, 255) + (limb_bound >> 16)


def to_digits(x):
    """int64 limbs [..., 25] -> int64 digits [..., 51] (base 2^8,
    overlap-added): digit[2i] = c0(i) + c2(i-1), digit[2i+1] = c1(i),
    digit[50] = c2(24) — the layout of the reference's ``_to_digits_f32``."""
    c0 = x & 0xFF
    c1 = (x >> 8) & 0xFF
    c2 = x >> 16
    z = torch.zeros_like(x[..., :1])
    even = torch.cat([c0, z], dim=-1) + torch.cat([z, c2], dim=-1)  # [..., 26]
    odd = torch.cat([c1, z], dim=-1)
    d = torch.stack([even, odd], dim=-1).reshape(x.shape[:-1] + (2 * (NLIMBS + 1),))
    return d[..., :_N_DIGITS]


# --------------------------------------------------------------------------------------
# The bare convolution: the reference's ``_conv_product`` on its digit arm
# (``_conv_product_digits``), for callers outside the fused kernel (the Fr
# limb math of ``ops/kzg/frops``). Integer broadcast multiply-sums, exact in
# int64: torch has no int64 matmul on CUDA.
# --------------------------------------------------------------------------------------

_CONV_DIGITS = 2 * _N_DIGITS - 1  # 101 digit positions


def digit_outer(a, b):
    """Limb rows a, b [..., 25] (broadcast) -> their digit outer products
    [..., 51, 51]. A sum of these over any axis is again a valid input of
    ``conv_from_outer`` (the convolution is linear)."""
    return to_digits(a)[..., :, None] * to_digits(b)[..., None, :]


def antidiagonal_sums(prod):
    """Digit outer products [..., 51, 51] -> their anti-diagonal sums
    [..., 101], the digit convolution (the shear: row i of the padded outer
    product lands shifted by i)."""
    batch = prod.shape[:-2]
    prod = torch.cat(
        [prod, prod.new_zeros(batch + (_N_DIGITS, _CONV_DIGITS + 1 - _N_DIGITS))], dim=-1
    )
    flat = prod.reshape(batch + (_N_DIGITS * (_CONV_DIGITS + 1),))
    d = flat[..., : _N_DIGITS * _CONV_DIGITS].reshape(batch + (_N_DIGITS, _CONV_DIGITS))
    return d.sum(dim=-2)


def conv_from_outer(prod):
    """Digit outer products [..., 51, 51] (or a sum of them) -> the 50
    16-bit-radix accumulators of ``conv_product``: the anti-diagonal sums,
    then limb s = D[2s] + 2^8 D[2s+1], with limb 50 (digit position 100)
    folded into limb 49 as the reference does."""
    d = antidiagonal_sums(prod)  # [..., 101] digit accumulators
    batch = d.shape[:-1]
    pairs = torch.cat([d, d.new_zeros(batch + (1,))], dim=-1).reshape(batch + (_N_DIGITS, 2))
    limbs = pairs[..., 0] + (pairs[..., 1] << 8)  # [..., 51]
    top = 2 * NLIMBS - 1
    return torch.cat(
        [limbs[..., :top], limbs[..., top : top + 1] + (limbs[..., top + 1 :] << LIMB_BITS)],
        dim=-1,
    )


def conv_product(a, b):
    """Convolution product of limb rows [..., 25] -> 50 int64 accumulators
    (value-preserving; bounds from ``conv_limb_bounds``), equal limb for limb
    to the reference's ``_conv_product_digits``."""
    return conv_from_outer(digit_outer(a, b))


def conv_limb_bounds(in_limb_a: int, in_limb_b: int | None = None) -> list[int]:
    """Static per-accumulator bounds of ``conv_product`` for inputs with limbs
    <= in_limb_a / in_limb_b (the reference's digit-arm formulas), each proved
    below 2^63 through ``_cert``."""
    if in_limb_b is None:
        in_limb_b = in_limb_a
    da, db = _digit_bound(in_limb_a), _digit_bound(in_limb_b)
    # digit conv position d has min(d, 100 - d, 50) + 1 terms
    per_digit = [
        (min(d, _CONV_DIGITS - 1 - d, _N_DIGITS - 1) + 1) * da * db
        for d in range(_CONV_DIGITS)
    ] + [0]
    _cert("conv_digit_i64_acc", max(per_digit), _CAP - 1,
          note="digit conv accumulators exact in int64")
    limb_b = [per_digit[2 * s] + (per_digit[2 * s + 1] << 8) for s in range(_N_DIGITS)]
    limb_b[2 * NLIMBS - 1] += limb_b[2 * NLIMBS] << LIMB_BITS  # limb 50 folded into 49
    _cert("conv_digit_limb_acc", max(limb_b), _CAP - 1,
          note="recombined conv accumulators exact in int64")
    return limb_b[: 2 * NLIMBS]


# --------------------------------------------------------------------------------------
# Congruence-fold reduction walk (reduce_limbs), statically scheduled
# --------------------------------------------------------------------------------------

# _FOLD_NP[j] = 16-bit limbs of 2^(16*(25+j)) mod p.
_N_FOLD = 40
_FOLD_NP = np.stack(
    [int_to_limbs((1 << (LIMB_BITS * (NLIMBS + j))) % P) for j in range(_N_FOLD)]
)
_FOLD_VALS = [(1 << (LIMB_BITS * (NLIMBS + j))) % P for j in range(_N_FOLD)]

PUB_VALUE_LIMIT = 13 * P

_RT384_VAL = (1 << 384) % P
_RT384_NP = int_to_limbs(_RT384_VAL)
_RT381_VAL = (1 << 381) % P
_RT381_NP = int_to_limbs(_RT381_VAL)
# keep bits < 381: full limbs 0..22, 13 bits of limb 23, none of limb 24
_MASK_LOW381 = np.array([0xFFFF] * 23 + [0x1FFF, 0], dtype=np.int64)
_MASK_NO24 = np.array([1] * 24 + [0], dtype=np.int64)

PUB_LIMB_TARGET = (1 << 17) - 1


class _RState:
    """Exact static bound state: per-limb bounds plus a value bound, mutually
    refined (t_i <= value >> 16i since limbs are non-negative)."""

    __slots__ = ("limbs", "value")

    def __init__(self, limbs, value):
        limbs = list(limbs)
        value = min(value, sum(b << (LIMB_BITS * i) for i, b in enumerate(limbs)))
        self.limbs = [min(b, value >> (LIMB_BITS * i)) for i, b in enumerate(limbs)]
        self.value = value


def _carry_round_state(s: _RState) -> _RState:
    lo_b = [min(b, MASK) for b in s.limbs] + [0]
    hi_b = [0] + [b >> LIMB_BITS for b in s.limbs]
    return _RState([a + b for a, b in zip(lo_b, hi_b)], s.value)


def _fold_high_state(s: _RState) -> _RState:
    lo_b, hi_b = s.limbs[:NLIMBS], s.limbs[NLIMBS:]
    limbs = [
        b + sum(hb * int(_FOLD_NP[j, i]) for j, hb in enumerate(hi_b))
        for i, b in enumerate(lo_b)
    ]
    _cert("fold_acc_nowrap", max(limbs), _CAP - 1)
    lo_val = sum(b << (LIMB_BITS * i) for i, b in enumerate(lo_b))
    value = min(s.value, lo_val) + sum(hb * _FOLD_VALS[j] for j, hb in enumerate(hi_b))
    return _RState(limbs, value)


def _fold_384_state(s: _RState) -> _RState:
    top_b = s.limbs[24]
    limbs = [b + top_b * int(_RT384_NP[i]) for i, b in enumerate(s.limbs[:24])] + [
        top_b * int(_RT384_NP[24])
    ]
    _cert("fold384_acc_nowrap", max(limbs), _CAP - 1)
    lo_val = sum(b << (LIMB_BITS * i) for i, b in enumerate(s.limbs[:24]))
    return _RState(limbs, min(s.value, lo_val) + top_b * _RT384_VAL)


def _propagate_approx_plan(s: _RState, n_out: int, target: int, ops: list) -> _RState:
    _cert("carry_walk_width", s.value, (1 << (LIMB_BITS * n_out)) - 1)
    ops.append(("pad", n_out))
    limbs = list(s.limbs) + [0] * (n_out - len(s.limbs))
    limbs = [min(b, s.value >> (LIMB_BITS * i)) for i, b in enumerate(limbs)]
    for _ in range(8):
        if max(limbs) <= target:
            break
        ops.append(("round",))
        carried = [0] + [b >> LIMB_BITS for b in limbs[:-1]]
        limbs = [min(b, MASK) + c for b, c in zip(limbs, carried)]
        limbs = [min(b, s.value >> (LIMB_BITS * i)) for i, b in enumerate(limbs)]
    else:  # pragma: no cover - static schedule
        raise BoundError("carry walk did not converge")
    return _RState(limbs, s.value)


def _drop_zero_tops_plan(w: int, s: _RState, ops: list):
    while w > NLIMBS and s.limbs[w - 1] == 0:
        w -= 1
        s = _RState(s.limbs[:w], s.value)
    if w != len(s.limbs):  # pragma: no cover - kept in step above
        raise BoundError("width bookkeeping")
    return w, s


@certified_cache
def _reduce_plan(
    width: int, limb_bounds: tuple, value_bound: int, value_limit: int, limb_target: int
) -> tuple:
    """The static schedule of ``reduce_limbs`` (the reference's four phases,
    decided on exact Python-int bounds, cached per static signature). Ops:
    ("trim", w), ("fold",) [fold limbs >= 25], ("carry",) [appending carry
    round], ("pad", n), ("round",) [width-preserving round], ("fold384",)."""
    cap = _CAP
    ops: list = []
    s = _RState(list(limb_bounds), value_bound)
    w = width

    def drop(w, s):
        w2, s2 = _drop_zero_tops_plan(w, s, ops)
        if w2 != w:
            ops.append(("trim", w2))
        return w2, s2

    for _ in range(64):
        w, s = drop(w, s)
        if w == NLIMBS:
            break
        n_hi = w - NLIMBS
        prod = max(s.limbs[:NLIMBS]) + sum(hb * MASK for hb in s.limbs[NLIMBS:])
        if n_hi <= _N_FOLD and prod < cap:
            s = _fold_high_state(s)
            ops.append(("fold",))
            w = NLIMBS
        else:
            s = _carry_round_state(s)
            ops.append(("carry",))
            w += 1
    else:  # pragma: no cover - static schedule
        raise BoundError("reduce_limbs: phase 1 did not converge")
    n_out = max(NLIMBS + 1, -(-s.value.bit_length() // LIMB_BITS) + 1)
    s = _propagate_approx_plan(s, n_out, limb_target, ops)
    w = n_out
    for _ in range(64):
        w, s = drop(w, s)
        if w > NLIMBS:
            prod = max(s.limbs[:NLIMBS]) + sum(hb * MASK for hb in s.limbs[NLIMBS:])
            if prod < cap:
                s = _fold_high_state(s)
                ops.append(("fold",))
                w = NLIMBS
            else:
                s = _carry_round_state(s)
                ops.append(("carry",))
                w += 1
        elif s.value > value_limit:
            lo_val = sum(b << (LIMB_BITS * i) for i, b in enumerate(s.limbs[:24]))
            predicted = min(s.value, lo_val) + s.limbs[24] * _RT384_VAL
            safe = s.limbs[24] * MASK + max(s.limbs[:24]) < cap
            if safe and predicted < s.value:
                s = _fold_384_state(s)
                ops.append(("fold384",))
            else:
                s = _carry_round_state(s)
                ops.append(("carry",))
                w += 1
        else:
            break
    else:  # pragma: no cover - static schedule
        raise BoundError("reduce_limbs: phase 3 did not converge")
    s = _propagate_approx_plan(s, NLIMBS, limb_target, ops)
    _cert("reduce_value", s.value, value_limit)
    _cert("reduce_limb", max(s.limbs), limb_target)
    if value_limit == PUB_VALUE_LIMIT:
        _cert("reduce_top_limb", min(s.limbs[24], s.value >> (LIMB_BITS * 24)), 2)
    return tuple(ops)


def _pad_to(t, n: int):
    if t.shape[-1] < n:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (n - t.shape[-1],))], dim=-1)
    return t


def reduce_limbs(
    t,
    limb_bounds,
    value_bound: int,
    value_limit: int = PUB_VALUE_LIMIT,
    limb_target: int = PUB_LIMB_TARGET,
):
    """Reduce [..., N] (N >= 25) to value <= value_limit, limbs <= limb_target
    (defaults: plans.PUB_BOUND). Replays the cached static schedule of
    ``_reduce_plan``: congruence folds and carry rounds, bounds proved below
    2^63 before any op runs."""
    ops = _reduce_plan(
        t.shape[-1], tuple(int(b) for b in limb_bounds), int(value_bound),
        int(value_limit), int(limb_target),
    )
    for op in ops:
        kind = op[0]
        if kind == "trim":
            t = t[..., : op[1]]
        elif kind == "fold":
            n_hi = t.shape[-1] - NLIMBS
            rows = dconst(_FOLD_NP, t)[:n_hi]
            t = t[..., :NLIMBS] + (t[..., NLIMBS:, None] * rows).sum(dim=-2)
        elif kind == "carry":
            lo, hi = _split16(t)
            t = _pad_to(lo, t.shape[-1] + 1) + torch.cat(
                [torch.zeros_like(hi[..., :1]), hi], dim=-1
            )
        elif kind == "pad":
            t = _pad_to(t, op[1])
        elif kind == "round":
            t = _carry_rounds(t, 1)
        else:  # fold384
            top = t[..., 24:25]
            t = t * dconst(_MASK_NO24, t) + top * dconst(_RT384_NP, t)
    return t


# --------------------------------------------------------------------------------------
# Multiplication: the fused kernel
# --------------------------------------------------------------------------------------

# Conv-input budget (the plans.lincomb contract): limbs < 2^22, value < 1200p.
_IN_LIMB = (1 << 22) - 1
_IN_VALUE = 1200 * P

# Lazy chain bound: a chain step's output re-enters the next multiply directly
# (inside the conv budget, digit conv exact: 51 * (255 + 2^4)^2 < 2^24).
CHAIN_VALUE_P = 64
CHAIN_LIMB_TARGET = (1 << 20) - 1
CHAIN_VALUE_LIMIT = CHAIN_VALUE_P * P


def chain_top_limb() -> int:
    """Provable limb-24 bound of a chain-interior value: min(limb bound,
    value >> 384)."""
    return min(CHAIN_LIMB_TARGET, CHAIN_VALUE_LIMIT >> (LIMB_BITS * 24))


def _import_certs() -> None:
    """The chain bound's fit in the conv budget: proved at import, and again
    by the bounds certifier (analysis/bounds.py) into its sink."""
    _cert("chain_in_budget_limb", CHAIN_LIMB_TARGET, _IN_LIMB)
    _cert("chain_in_budget_value", CHAIN_VALUE_LIMIT, _IN_VALUE)


_import_certs()


def mont_mul(a, b):
    """a*b mod p (plain domain; the reference's name). Operands within the
    lazy budget; output at plans.PUB_BOUND. One plan-kernel launch."""
    from . import fused_mul

    return fused_mul.fused_mul(a, b, lazy=False)


def mont_sqr(a):
    return mont_mul(a, a)


def mont_mul_lazy(a, b):
    """Chain-interior product: chain-bound operands and output (the step of
    pow_fixed_scan's chain, which the chain kernel runs in-launch)."""
    from . import fused_mul

    return fused_mul.fused_mul(a, b, lazy=True)


def mont_sqr_lazy(a):
    return mont_mul_lazy(a, a)


def canonical(a):
    """Fully reduce to the canonical residue < p (comparisons, parity,
    serialization). Accepts anything within the lazy budget."""
    t = reduce_limbs(a, [_IN_LIMB] * a.shape[-1], _IN_VALUE)
    # reduce_limbs leaves 17-bit limbs; the 2^381 folds mask limbs to 16 bits,
    # so an exact propagation comes first
    t = _carry_propagate(t, NLIMBS)
    mask381 = dconst(_MASK_LOW381, t)
    rt381 = dconst(_RT381_NP, t)
    for _ in range(2):
        hi = (t[..., 23] >> 13) + (t[..., 24] << 3)
        t = (t & mask381) + hi[..., None] * rt381
        t = _carry_propagate(t, NLIMBS)
    return _cond_sub_p(t)



# --------------------------------------------------------------------------------------
# Fixed-exponent powers
# --------------------------------------------------------------------------------------


@certified_cache
def _pow_program(e: int, name: str):
    from . import chain_plans, fused_mul

    k2 = fused_mul.mul_schedule(True)
    sched = chain_plans.compile_chains((e,), signed=False)
    return chain_plans.field_chain_program(name, sched, k2, k2, ONE_M)


def pow_fixed_scan(a, e: int, name: str):
    """a^e for a host-fixed exponent through the chain compiler, with lazy
    interior bounds: the whole chain is ONE chain-kernel launch (its steps
    are K2 multiplies); only the result pays the full normalization walk.
    ``name`` names the chain program (launch counts, ``fused_mul.CHAINS``):
    one name per exponent."""
    from . import fused_mul

    a = reduce_limbs(
        a, [_IN_LIMB] * a.shape[-1], _IN_VALUE, CHAIN_VALUE_LIMIT, CHAIN_LIMB_TARGET
    )
    out = fused_mul.run_chain(_pow_program(int(e), name), a[None, ..., None, :])[0, ..., 0, :]
    return reduce_limbs(out, [CHAIN_LIMB_TARGET] * NLIMBS, CHAIN_VALUE_LIMIT)


def inv(a):
    """Field inverse via Fermat (a^(p-2)); inv(0) = 0."""
    return pow_fixed_scan(a, P - 2, "inv")


def sqrt_candidate(a):
    """a^((p+1)/4) — a square root when a is a QR (p = 3 mod 4)."""
    return pow_fixed_scan(a, (P + 1) // 4, "sqrt_candidate")


def sgn0(a):
    """RFC 9380 sgn0 (parity) of a lazy plain-residue element."""
    return canonical(a)[..., 0] & 1


_HALF_NP = int_to_limbs((P - 1) // 2)


def lex_gt_half_canon(canon):
    """x > (p-1)/2 on a canonical limb array (MSB-first limb compare)."""
    half = [int(v) for v in _HALF_NP]
    gt = torch.zeros(canon.shape[:-1], dtype=torch.bool, device=canon.device)
    decided = torch.zeros_like(gt)
    for i in range(NLIMBS - 1, -1, -1):
        ai, hi = canon[..., i], half[i]
        gt = torch.where(~decided & (ai > hi), True, gt)
        decided = decided | (ai != hi)
    return gt


def lex_gt_half(a):
    return lex_gt_half_canon(canonical(a))
