"""The fused field multiply: host-side schedules, the two CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces the TPU kernel ``lighthouse_tpu/ops/bls/pallas_kernels.py:_build_call``
(its ``pl.pallas_call``), entered through ``fused_mul`` (behind
``fq.mont_mul``/``fq.mont_mul_lazy``: entries K1/K2) and ``execute_plan``
(behind ``plans.execute``: K3). The kernels are in ``csrc/fused_mul.cu``,
CUDA C++ for ``sm_90a``, built with nvcc into a shared library on first use
and bound with ctypes:

* the **plan kernel** runs one multiply step per row, input lincombs
  included (K1 and K3 launches; K1/K2 are the step with L = 1 and an
  identity lincomb):

      raw int64 limbs a [rows, n_a, 25], b [rows, n_b, 25] (+ constant pool)
        -> lane operands: signed (index, coefficient) lists + borrow
           constants, int64 (the tables of plans.lincomb_tables)
        -> base-2^8 digits -> 51x51 digit convolution per lane
        -> pre-split schedule -> optional [R, L(+n_pass)] output map
           (signed coefficients, digit-space borrow constants == 0 mod p,
           pass-through rows of the raw ``a``)
        -> post schedule of splits, trims and congruence folds
        -> int64 limbs [rows, R, 25]

  A warp owns a lane (and later an output row); the lanes of a row are
  split over a thread-block cluster of C CTAs, which read each other's lane
  planes through distributed shared memory for the output map. C is picked
  here from rows x L against the card's 132 SMs (``cluster_size``).
* the **chain kernel** runs a whole fixed-exponent chain (``ChainProgram``:
  the table ladder, the gathers and every squaring and multiply of
  ``chain_plans.run_field_chains`` or the |x| unroll) in ONE launch, each
  step the plan kernel's body, with the accumulator and table resident in
  shared memory. Its users: ``fq.pow_fixed_scan`` (K2 steps),
  ``tower._sqrt_chain`` (SQR2/MUL2 at the chain bound) and
  ``tower.fq12_cyclotomic_exp_abs_x`` (CYC_SQR/MUL12).

The schedules are derived here exactly as the reference derives them
(``_DState``, ``_reduce_schedule``, ``_final_certs``, ``_dsubc_wide`` and the
bound walks of ``fused_mul``/``execute_plan`` are copies), cached per static
signature, encoded once into int32/int64 tables and uploaded once per
device. Every digit intermediate is proven below 2^24, so the kernels' int32
arithmetic is exact.

What bounds the kernels on the H100: at the verify path's shapes (one to a
few hundred rows, 1 to 54 lanes) neither memory traffic nor int32
operations but the latency of a step's dependent phases and, before this
design, a launch per step; see the source's header.

Beside the kernels: ``plain_fused`` (lanes in) and ``plain_plan`` (raw
operands in, lincombs by ``plans.apply_tables`` from the schedule's tables,
not from their encoding) replay the same schedule on int64 torch tensors,
so holding a kernel against them also checks the encoding; ``plain_chain``
replays a chain program step by step. The wrappers ``run_fused`` and
``run_chain`` take the plain versions only for CPU tensors; for a CUDA
tensor they launch the kernel or raise. ``launches`` counts kernel
launches, ``plain_calls`` calls of the plain version.

Threads: the firehose calls the kernels from its device thread and the
supervisor's watchdog workers. One module lock (``_LOCK``) guards the
build and load of the library, the plan cache with its label assignment,
the per-device table uploads and every counter, so labels and counts do
not depend on which thread arrives first.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np
import torch

from . import fq, plans
from ...oracle.fields import P

_D = 51                 # digits per 25-limb element
_CONV_D = 2 * _D - 1    # 101 conv output digit positions
_FOLD_BASE = 48         # digit position of 2^384
_F32_CAP = (1 << 24) - 1  # the reference's f32 exactness cap, kept as the bound
_N_FOLD8 = 64
_OUT_D = 50             # output digit positions (25 limbs)
_W_MAX = 128            # widest digit plane the kernel's warp mapping covers

# launch limit of dynamic shared memory per block on the H100 (sm_90)
SMEM_LIMIT = 232448
N_SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8         # portable thread-block cluster size
_MAX_WARPS = 8
_SCR_WORDS = 500        # per-warp scratch of the kernels, int32 words

# guards the library build and load, _PLAN_CACHE and SCHEDULES, the device
# table caches and the counters below (re-entrant: a plan miss builds
# schedules that register themselves)
_LOCK = threading.RLock()

launches = 0      # kernel launches (CUDA tensors)
plain_calls = 0   # plain-version calls (CPU tensors, or chip-side comparisons)
# kernel launches by entry: "K1" fused_mul, "K2" fused_mul(lazy), "K3"
# execute_plan (plan kernel); "CHAIN" a fixed-exponent chain (chain kernel)
launches_by = {"K1": 0, "K2": 0, "K3": 0, "CHAIN": 0}
# (kind, schedule label or chain name, rows) -> launches: the shapes the path
# gives the kernels
launch_log: dict = {}
# schedule label -> Schedule: every plan signature prepared so far (a label is
# the call site's name, suffixed "#k" when one name has k bound signatures)
SCHEDULES: dict = {}


def reset_counts() -> None:
    global launches, plain_calls
    with _LOCK:
        launches = 0
        plain_calls = 0
        for k in launches_by:
            launches_by[k] = 0
        launch_log.clear()


def _count(kind: str, label: str, rows: int) -> None:
    global launches
    key = (kind, label, rows)
    with _LOCK:
        launches += 1
        launches_by[kind] += 1
        launch_log[key] = launch_log.get(key, 0) + 1


def _count_plain() -> None:
    global plain_calls
    with _LOCK:
        plain_calls += 1


def _int_to_digits(x: int, n: int) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


# F8[h] = digits48(2^(8*(48+h)) mod p)
_FOLD8_NP = np.stack(
    [
        np.array(_int_to_digits((1 << (8 * (_FOLD_BASE + h))) % P, _FOLD_BASE))
        for h in range(_N_FOLD8)
    ]
).astype(np.int64)
_FOLD8_I32 = _FOLD8_NP.astype(np.int32)
_FOLD8_INT = [[int(v) for v in _FOLD8_NP[h]] for h in range(_N_FOLD8)]
_FOLD8_VALS = [(1 << (8 * (_FOLD_BASE + h))) % P for h in range(_N_FOLD8)]


# --------------------------------------------------------------------------------------
# Exact digit-domain bound state and the static schedules (copied from the
# reference, pallas_kernels.py:156-320)
# --------------------------------------------------------------------------------------


class _DState:
    """Per-digit-position bounds plus an exact value bound, mutually refined:
    digits are non-negative, so d_i <= value >> 8i."""

    __slots__ = ("digits", "value")

    def __init__(self, digits, value: int):
        digits = list(digits)
        value = min(value, sum(b << (8 * i) for i, b in enumerate(digits)))
        self.digits = [min(b, value >> (8 * i)) for i, b in enumerate(digits)]
        self.value = value


def _split_state(s: _DState) -> _DState:
    lo = [min(b, 0xFF) for b in s.digits] + [0]
    hi = [0] + [b >> 8 for b in s.digits]
    return _DState([a + b for a, b in zip(lo, hi)], s.value)


def _fold_state(s: _DState, name: str) -> _DState:
    n_hi = len(s.digits) - _FOLD_BASE
    lo_b, hi_b = s.digits[:_FOLD_BASE], s.digits[_FOLD_BASE:]
    digits = [
        b + sum(hb * _FOLD8_INT[h][i] for h, hb in enumerate(hi_b))
        for i, b in enumerate(lo_b)
    ]
    fq._cert("pallas_fold_f32_exact", max(digits), _F32_CAP, note=name)
    lo_val = sum(b << (8 * i) for i, b in enumerate(lo_b))
    value = min(s.value, lo_val) + sum(hb * _FOLD8_VALS[h] for h, hb in enumerate(hi_b))
    fq._cert("pallas_fold_rows", n_hi, _N_FOLD8, note=name)
    return _DState(digits, value)


def _fold_budget(s: _DState) -> int:
    lo_b, hi_b = s.digits[:_FOLD_BASE], s.digits[_FOLD_BASE:]
    return max(
        b + sum(hb * _FOLD8_INT[h][i] for h, hb in enumerate(hi_b))
        for i, b in enumerate(lo_b)
    )


def _trim_state(s: _DState) -> _DState:
    digits = list(s.digits)
    while len(digits) > _FOLD_BASE and digits[-1] == 0:
        digits.pop()
    return _DState(digits, s.value)


def _reduce_schedule(
    s: _DState, value_limit: int, limb_target: int, name: str
) -> tuple[list, _DState]:
    """Static split/fold schedule to value <= value_limit and recombined
    16-bit limbs <= limb_target. Returns (ops, final state)."""
    ops: list = []

    def trim(s: _DState) -> _DState:
        t = _trim_state(s)
        if len(t.digits) != len(s.digits):
            ops.append(("trim", len(t.digits)))
        return t

    def limbs_fit(s: _DState) -> bool:
        if len(s.digits) > _OUT_D:
            return False
        d = list(s.digits) + [0] * (_OUT_D - len(s.digits))
        return all(
            d[2 * i] + (d[2 * i + 1] << 8) <= limb_target for i in range(_OUT_D // 2)
        )

    for _ in range(96):
        s = trim(s)
        w = len(s.digits)
        if w > _OUT_D or (s.value > value_limit and w > _FOLD_BASE):
            if _fold_budget(s) <= _F32_CAP:
                s = _fold_state(s, name)
                ops.append(("fold", w - _FOLD_BASE))
            else:
                s = _split_state(s)
                ops.append(("split",))
        elif s.value > value_limit or not limbs_fit(s):
            s = _split_state(s)
            ops.append(("split",))
        else:
            break
    else:  # pragma: no cover - static schedule
        raise fq.BoundError(f"{name}: reduce schedule did not converge")
    fq._cert(
        "pallas_out_width",
        sum(b << (8 * i) for i, b in enumerate(s.digits)),
        (1 << (8 * _OUT_D)) - 1,
        note=name,
    )
    return ops, s


def _final_certs(s: _DState, value_limit: int, limb_target: int, name: str) -> None:
    digits = list(s.digits) + [0] * (_OUT_D - len(s.digits))
    limbs = [digits[2 * i] + (digits[2 * i + 1] << 8) for i in range(_OUT_D // 2)]
    fq._cert("pallas_reduce_value", s.value, value_limit, note=name)
    fq._cert("pallas_reduce_limb", max(limbs), limb_target, note=name)
    # the kernel's int32 planes and the int64 recombination are lossless
    fq._cert("pallas_digit_i32_nowrap", max(digits), (1 << 31) - 1, note=name)
    if value_limit == fq.PUB_VALUE_LIMIT:
        fq._cert(
            "pallas_reduce_top_limb", min(limbs[24], s.value >> (16 * 24)), 2, note=name
        )


_DSUBC_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _dsubc_wide(n_digits: int, cover: int) -> np.ndarray:
    """A constant == 0 mod p in n_digits-digit space with every digit >= cover."""
    key = (n_digits, cover)
    if key not in _DSUBC_CACHE:
        c = [cover] * n_digits
        adj = (-sum(v << (8 * i) for i, v in enumerate(c))) % P
        for i in range(_FOLD_BASE):
            c[i] += (adj >> (8 * i)) & 0xFF
        if sum(v << (8 * i) for i, v in enumerate(c)) % P != 0:
            raise fq.BoundError("digit borrow constant is not 0 mod p")
        _DSUBC_CACHE[key] = np.array(c, dtype=np.int64)
    return _DSUBC_CACHE[key]


def _conv_state(dig_a: int, dig_b: int, name: str) -> list[int]:
    conv = [(min(d, 2 * _D - 2 - d, _D - 1) + 1) * dig_a * dig_b for d in range(_CONV_D)]
    fq._cert("pallas_conv_digit_f32_exact", max(conv), _F32_CAP, note=name)
    return conv


def _widths(ops, w: int) -> tuple[int, int]:
    """(final width, widest width) of a schedule replayed from width w."""
    widest = w
    for op in ops:
        if op[0] == "split":
            w += 1
        elif op[0] == "trim":
            w = op[1]
        else:
            w = _FOLD_BASE
        widest = max(widest, w)
    return w, widest


def _encode(ops) -> list[int]:
    out = []
    for op in ops:
        if op[0] == "split":
            out.append(0)
        elif op[0] == "trim":
            out.append(1 | (op[1] << 8))
        else:
            out.append(2 | (op[1] << 8))
    return out



class Schedule:
    """One static call signature of the plan kernel: input lincomb tables,
    schedules and output map, their int32/int64 encoding and its device
    copies (uploaded once per device).

    ``lin`` is (lin_a, lin_b): the (m_pos, m_neg, consts) tables of
    ``plans.lincomb_tables`` for A over a's n_a rows and for B over b's n_b
    rows followed by ``plan``'s constant pool. None is the identity lincomb
    of K1/K2 (L = n_a = n_b = 1). ``in_bounds`` holds, for a and for b, the
    (limb, value, top limb) maxima the schedule was proved for."""

    def __init__(self, kind, name, L, pre_ops, post_ops, out=None, n_pass=0, lin=None,
                 plan=None, in_bounds=None):
        self.kind = kind
        self.name = name
        self.label = name
        self.L = L
        self.pre_ops = tuple(pre_ops)
        self.post_ops = tuple(post_ops)
        self.n_pass = n_pass
        self.has_out = out is not None
        self.identity = lin is None
        self.in_bounds = in_bounds
        self.plan = plan
        if lin is None:
            one, zero = np.ones((1, 1), np.int64), np.zeros((1, 1), np.int64)
            c0 = np.zeros((1, fq.NLIMBS), np.int64)
            lin = ((one, zero, c0), (one, zero, c0))
        self.lin_a, self.lin_b = lin
        consts = plan.consts if plan is not None else ()
        self.pool = np.array([fq.int_to_limbs(c) for c in consts], np.int64).reshape(-1, fq.NLIMBS)
        self.n_a = self.lin_a[0].shape[1]
        self.n_b = self.lin_b[0].shape[1] - len(self.pool)
        w_mid, wide_pre = _widths(self.pre_ops, _CONV_D)
        self.w_mid = w_mid
        if self.has_out:
            self.R, self.mpos, self.mneg, self.oconst = out
            self.has_neg = bool(self.mneg.any())
            w_out, wide_post = _widths(self.post_ops, w_mid)
        else:
            self.R = L
            self.mpos = self.mneg = self.oconst = None
            self.has_neg = False
            w_out, wide_post = w_mid, w_mid
        self.w_out = w_out
        self.wmax = max(wide_pre, wide_post)
        fq._cert("pallas_out_digits", w_out, _OUT_D)
        fq._cert("cuda_plane_width", self.wmax, _W_MAX, note=name)
        self.ints, self.i64, self.offs = self._encode()
        self._dev: dict = {}
        self._shape = {}
        for C in (1, 2, 4, MAX_CLUSTER):
            smem = self.smem_bytes(C)
            fq._cert("cuda_smem_bytes", smem, SMEM_LIMIT, note=f"{name} L={L} C={C}")
            self._shape[C] = (self.threads(C), smem)

    # -- launch shape --------------------------------------------------------------

    def lanes_per_cta(self, C: int) -> int:
        return -(-self.L // C)

    def threads(self, C: int) -> int:
        """One warp per lane of the CTA's share (phase 1) and per output row
        of its share (phase 2), at most 8."""
        rows = -(-self.R // C) if self.has_out else 0
        return 32 * min(_MAX_WARPS, max(self.lanes_per_cta(C), rows, 1))

    @property
    def plane_stride(self) -> int:
        """Words between digit planes in shared memory (16-byte aligned)."""
        return -(-self.wmax // 4) * 4

    def smem_bytes(self, C: int) -> int:
        """Dynamic shared memory of one CTA (csrc: lh_plan_smem_bytes): the
        raw operands, the CTA's lane planes, at C > 1 every lane plane of
        the row gathered for the output map, and the warps' scratch."""
        io = -(-(self.n_a + self.n_b) * fq.NLIMBS * 8 // 16) * 16
        planes = (self.lanes_per_cta(C) + (self.L if C > 1 else 0)) * self.plane_stride
        return io + planes * 4 + (self.threads(C) // 32) * _SCR_WORDS * 4

    # -- encoding ------------------------------------------------------------------

    def _encode(self):
        """ints: the ops, then per lincomb / output map a block of row starts
        (absolute offsets) and the (index, signed coefficient) pairs of each
        row, then the output map's digit borrow constants; i64: the A and B
        borrow constants and the constant pool."""
        ints = _encode(self.pre_ops) + _encode(self.post_ops)

        def lists(pos, neg):
            n = pos.shape[0]
            start = len(ints)
            ints.extend([0] * (n + 1))
            for r in range(n):
                ints[start + r] = len(ints)
                for j in range(pos.shape[1]):
                    c = int(pos[r, j]) - int(neg[r, j])
                    if c:
                        ints.extend((j, c))
            ints[start + n] = len(ints)
            return start

        offs = {"off_ops": 0, "off_la": lists(*self.lin_a[:2]), "off_lb": lists(*self.lin_b[:2])}
        if self.has_out:
            offs["off_out"] = lists(self.mpos, self.mneg)
            offs["off_oconst"] = len(ints)
            ints.extend(int(v) for v in self.oconst.reshape(-1))
        else:
            offs["off_out"] = offs["off_oconst"] = 0
        fq._cert("cuda_table_i32", max(abs(v) for v in ints), (1 << 31) - 1, note=self.name)
        n_lc = self.L * fq.NLIMBS
        offs.update(off_ca=0, off_cb=n_lc, off_pool=2 * n_lc)
        i64 = np.concatenate(
            [self.lin_a[2].reshape(-1), self.lin_b[2].reshape(-1), self.pool.reshape(-1)]
        ).astype(np.int64)
        return np.array(ints, dtype=np.int32), i64, offs

    def device_desc(self, device) -> "_PlanDesc":
        """The kernel's descriptor, its tables on ``device`` (kept alive here)."""
        with _LOCK:
            hit = self._dev.get(device)
            if hit is None:
                ints = torch.from_numpy(self.ints).to(device)
                i64 = torch.from_numpy(self.i64).to(device)
                desc = _PlanDesc(
                    ints.data_ptr(), i64.data_ptr(), self.L, self.R, self.n_a, self.n_b,
                    int(self.has_out), len(self.pre_ops), len(self.post_ops), self.w_mid,
                    self.wmax, **self.offs,
                )
                hit = (desc, ints, i64)
                self._dev[device] = hit
            return hit[0]


# --------------------------------------------------------------------------------------
# The plain PyTorch versions (same schedule and tables, int64 tensors)
# --------------------------------------------------------------------------------------


def _conv_digits(A, B):
    """Digit planes [..., 51] x [..., 51] -> anti-diagonal sums [..., 101]
    (the shear: row i of the padded outer product lands shifted by i)."""
    prod = A[..., :, None] * B[..., None, :]  # [..., 51, 51]
    batch = prod.shape[:-2]
    prod = torch.cat([prod, prod.new_zeros(batch + (_D, _CONV_D + 1 - _D))], dim=-1)
    flat = prod.reshape(batch + (_D * (_CONV_D + 1),))
    return flat[..., : _D * _CONV_D].reshape(batch + (_D, _CONV_D)).sum(dim=-2)


def _replay_plain(t, ops, f8):
    for op in ops:
        if op[0] == "split":
            lo, hi = t & 0xFF, t >> 8
            z = torch.zeros_like(t[..., :1])
            t = torch.cat([lo, z], dim=-1) + torch.cat([z, hi], dim=-1)
        elif op[0] == "trim":
            t = t[..., : op[1]]
        else:
            n_hi = op[1]
            t = t[..., :_FOLD_BASE] + (t[..., _FOLD_BASE:, None] * f8[:n_hi]).sum(dim=-2)
    return t


def plain_fused(sched: Schedule, A, B, Ain=None):
    """The plain version from lane operands on: A, B int64 limbs
    [rows, L, 25] (and Ain [rows, n_pass, 25]) -> int64 limbs [rows, R, 25]."""
    _count_plain()
    f8 = fq.dconst(_FOLD8_NP, A)
    t = _conv_digits(fq.to_digits(A), fq.to_digits(B))  # [rows, L, 101]
    t = _replay_plain(t, sched.pre_ops, f8)
    if sched.has_out:
        w = t.shape[-1]
        if sched.n_pass:
            pd = fq.to_digits(Ain)
            pd = torch.cat([pd, pd.new_zeros(pd.shape[:-1] + (w - _D,))], dim=-1)
            t = torch.cat([t, pd], dim=-2)
        pos = (fq.dconst(sched.mpos, t)[None, :, :, None] * t[:, None]).sum(dim=2)
        if sched.has_neg:
            neg = (fq.dconst(sched.mneg, t)[None, :, :, None] * t[:, None]).sum(dim=2)
            t = pos + (fq.dconst(sched.oconst, t)[None] - neg)
        else:
            t = pos
        t = _replay_plain(t, sched.post_ops, f8)
    if t.shape[-1] < _OUT_D:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (_OUT_D - t.shape[-1],))], dim=-1)
    return t[..., 0::2] + (t[..., 1::2] << 8)


def plain_plan(sched: Schedule, a, b):
    """The plain version of the plan kernel: raw operands a [rows, n_a, 25],
    b [rows, n_b, 25] -> int64 limbs [rows, R, 25]. The input lincombs run
    in torch from the schedule's tables (plans.apply_tables and the plan's
    constant pool), not from the encoded lists the kernel reads, so the
    comparison on the card also holds the encoding to those tables."""
    if sched.identity:
        return plain_fused(sched, a, b)
    A = plans.apply_tables(sched.lin_a, a)
    B = plans.apply_tables(sched.lin_b, plans.append_const_pool(sched.plan, b))
    return plain_fused(sched, A, B, a if sched.n_pass else None)


# --------------------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# --------------------------------------------------------------------------------------

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc"
)
_SRC = os.path.join(_CSRC, "fused_mul.cu")
BUILD_DIR = os.path.join(os.path.dirname(_CSRC), "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
]
_LIB = None

_DESC_INTS = (
    "L", "R", "n_a", "n_b", "has_out", "n_pre", "n_post", "w_mid", "wmax",
    "off_ops", "off_la", "off_lb", "off_out", "off_oconst", "off_ca", "off_cb", "off_pool",
)


class _PlanDesc(ctypes.Structure):
    """Mirror of ``struct PlanDesc`` in csrc/fused_mul.cu."""

    _fields_ = [("ints", ctypes.c_void_p), ("i64", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in _DESC_INTS
    ]


class _ChainArgs(ctypes.Structure):
    """Mirror of ``struct ChainArgs`` in csrc/fused_mul.cu."""

    _fields_ = [
        ("d", _PlanDesc * 2), ("prog", ctypes.c_void_p), ("one", ctypes.c_void_p),
    ] + [
        (n, ctypes.c_int)
        for n in (
            "n_steps", "step_len", "batch", "n_el", "n_state", "slot_one", "slot_base",
            "slot_acc",
        )
    ]


def _sources() -> list:
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def build(verbose: bool = False) -> str:
    """Compile csrc/fused_mul.cu for sm_90a into BUILD_DIR, keyed by the hash
    of every source under csrc/ and the flags (an edit to any of them
    rebuilds). Returns the library path. One build at a time per process."""
    with _LOCK:
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for path in _sources():
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib = os.path.join(BUILD_DIR, f"libfused_mul_{h.hexdigest()[:16]}.so")
        if not os.path.exists(lib):
            nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
            if not os.path.exists(nvcc):
                nvcc = "nvcc"
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [nvcc] + (["-Xptxas=-v"] if verbose else []) + _NVCC_FLAGS + ["-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
            if verbose:
                print(res.stdout + res.stderr, flush=True)
            os.replace(tmp, lib)
        return lib


def _lib():
    """The loaded library, built and bound on first use (once per process,
    under ``_LOCK``)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.lh_plan_launch.argtypes = [
                ctypes.POINTER(_PlanDesc), vp, ll, ll, vp, ll, ll, vp, vp, i, i, i, ll, vp,
            ]
            lib.lh_plan_launch.restype = i
            lib.lh_chain_launch.argtypes = [
                ctypes.POINTER(_ChainArgs), vp, vp, vp, i, i, i, i, i, ll, vp,
            ]
            lib.lh_chain_launch.restype = i
            lib.lh_plan_smem_bytes.argtypes = [i] * 7
            lib.lh_plan_smem_bytes.restype = ll
            lib.lh_chain_smem_bytes.argtypes = [i] * 5
            lib.lh_chain_smem_bytes.restype = ll
            for fn, ty in ((lib.lh_plan_desc_size, _PlanDesc), (lib.lh_chain_args_size, _ChainArgs)):
                fn.restype = i
                if fn() != ctypes.sizeof(ty):
                    raise RuntimeError(f"{ty.__name__}: ctypes layout != the CUDA struct")
            _LIB = lib
        return _LIB


def cluster_size(rows: int, lanes: int) -> int:
    """Thread-block cluster size for ``rows`` rows of ``lanes`` lanes: the
    largest power of two up to 8 that leaves every CTA at least 4 lanes and
    keeps rows x C CTAs within one wave of the 132 SMs (1 when the rows
    already fill the card). Fewer lanes per CTA do not repay the cluster's
    barrier and plane exchange: on the H100, CYC_SQR (18 lanes) at rows 1
    is fastest at C = 4, and the 3-lane Fq2 chain slower at C = 2 than at 1."""
    c = 1
    while c < MAX_CLUSTER and 8 * c <= lanes and rows * 2 * c <= N_SMS:
        c *= 2
    return c


def _check_operand(x, shape, what: str):
    if x.dtype != torch.int64:
        raise TypeError(f"fused_mul kernel takes int64 limb planes ({what}: {x.dtype})")
    if tuple(x.shape) != shape:
        raise ValueError(f"fused_mul kernel: bad {what} shape {tuple(x.shape)}, want {shape}")
    if x.device.type != "cuda" or x.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"fused_mul kernel: {what} is not on the current CUDA device")


def _inner_contiguous(x):
    return x if x.stride(2) == 1 else x.contiguous()


def cuda_fused(sched: Schedule, a, b, cluster: int | None = None):
    """Launch the plan kernel on the current stream: raw operands
    a [rows, n_a, 25], b [rows, n_b, 25] (any row and element strides, limbs
    contiguous) on one CUDA device -> int64 [rows, R, 25]."""
    rows = a.shape[0]
    _check_operand(a, (rows, sched.n_a, fq.NLIMBS), "a")
    _check_operand(b, (rows, sched.n_b, fq.NLIMBS), "b")
    if b.device != a.device:
        raise ValueError("fused_mul kernel: operands on different devices")
    a, b = _inner_contiguous(a), _inner_contiguous(b)
    out = torch.empty((rows, sched.R, fq.NLIMBS), dtype=torch.int64, device=a.device)
    if rows == 0:
        return out
    C = cluster or (cluster_size(rows, sched.L) if sched.has_out else 1)
    if C > 1 and not sched.has_out:
        raise ValueError("fused_mul kernel: a cluster needs an output map")
    threads, smem = sched._shape[C]
    err = _lib().lh_plan_launch(
        ctypes.byref(sched.device_desc(a.device)), a.data_ptr(), a.stride(0), a.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
        fq.dconst(_FOLD8_I32, a).data_ptr(), rows, C, threads, smem,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"plan kernel launch failed: CUDA error {err}")
    _count(sched.kind, sched.label, rows)
    return out


def run_fused(sched: Schedule, a, b):
    """The plan kernel's wrapper: the plain version for CPU tensors; the
    CUDA kernel (or an error) for CUDA tensors."""
    if a.device.type == "cpu":
        return plain_plan(sched, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fused_mul: unsupported device {a.device}")
    return cuda_fused(sched, a, b)


# --------------------------------------------------------------------------------------
# Entries: fused_mul (K1 / K2) and execute_plan (K3)
# --------------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def mul_schedule(lazy: bool) -> Schedule:
    """The static schedule of ``fused_mul`` (the reference's bound walk)."""
    name = "pallas_mul_lazy" if lazy else "pallas_mul"
    with _LOCK:  # the cache may miss in two threads at once: build once
        held = SCHEDULES.get(name)
        return held if held is not None else _new_mul_schedule(lazy, name)


def _new_mul_schedule(lazy: bool, name: str) -> Schedule:
    if lazy:
        in_limb, in_value = fq.CHAIN_LIMB_TARGET, fq.CHAIN_VALUE_LIMIT
        value_limit, limb_target = fq.CHAIN_VALUE_LIMIT, fq.CHAIN_LIMB_TARGET
    else:
        in_limb, in_value = fq._IN_LIMB, fq._IN_VALUE
        value_limit, limb_target = fq.PUB_VALUE_LIMIT, fq.PUB_LIMB_TARGET
    dig = fq._digit_bound(in_limb)
    state = _DState(_conv_state(dig, dig, name), in_value * in_value)
    ops, state = _reduce_schedule(state, value_limit, limb_target, name)
    _final_certs(state, value_limit, limb_target, name)
    top = min(in_limb, in_value >> (16 * 24))
    bounds = ((in_limb, in_value - 1, top),) * 2
    sched = Schedule("K2" if lazy else "K1", name, 1, ops, (), in_bounds=bounds)
    SCHEDULES[sched.label] = sched
    return sched


def _batch_shape(a, b, k: int):
    """The broadcast of a's and b's batch dims (all but the last k): equal
    shapes (the path's usual case) skip torch.broadcast_shapes, which costs
    ~15 us of host time per call."""
    sa, sb = a.shape[:-k], b.shape[:-k]
    return sa if sa == sb else torch.broadcast_shapes(sa, sb)


def _rows(x, batch, n: int):
    """x [..., n, 25] broadcast to ``batch`` as a [rows, n, 25] view (a copy
    only when the broadcast batch dims do not fold into one stride)."""
    if x.shape[:-2] != batch:
        x = x.expand(batch + (n, fq.NLIMBS))
    try:
        return x.view(-1, n, fq.NLIMBS)
    except RuntimeError:
        return x.reshape(-1, n, fq.NLIMBS)


def fused_mul(a, b, lazy: bool = False):
    """a*b mod p in one plan-kernel launch (lazy=False: lazy-budget operands,
    output at plans.PUB_BOUND — K1; lazy=True: chain-bound operands and
    output — K2, which the path runs inside chains)."""
    batch = _batch_shape(a, b, 1)
    out = run_fused(
        mul_schedule(bool(lazy)), _rows(a[..., None, :], batch, 1), _rows(b[..., None, :], batch, 1)
    )
    return out.reshape(batch + (fq.NLIMBS,))


def _bound_key(b):
    return None if b is None else (b.value_p, b.limb, b.top)


_PLAN_CACHE: dict = {}


class _PreparedPlan:
    """Everything ``execute_plan`` derives statically for one plan and bound
    signature: the input lincomb tables, the constant pool and the kernel
    schedule with its output map."""

    def __init__(self, plan, n_a, in_bound_a, in_bound_b, name, out_bound):
        kname = name or "plan"
        self.plan = plan  # keeps the plan (the cache key's id) alive
        L = len(plan.a_rows)
        self.lin_a, ba = plans.lincomb_tables(plan.a_rows, n_a, in_bound_a, kname + ".A")
        n_b = plan.n_b + len(plan.consts)
        self.lin_b, bb = plans.lincomb_tables(plan.b_rows, n_b, in_bound_b, kname + ".B")
        dig_a, dig_b = fq._digit_bound(ba.limb), fq._digit_bound(bb.limb)
        conv = _conv_state(dig_a, dig_b, kname)
        lane_state = _DState(conv, (ba.value_p * P) * (bb.value_p * P))

        has_pass = any(i < 0 for lc in plan.out_rows for i in lc.d)
        n_pass = n_a if has_pass else 0
        pass_dig = fq._digit_bound(in_bound_a.limb)
        pass_value = in_bound_a.value_p * P
        out_rows = plans.remap_passthrough_rows(plan, L) if has_pass else plan.out_rows

        coeff_pos = [sum(c for c in lc.d.values() if c > 0) for lc in out_rows]
        coeff_neg = [sum(-c for c in lc.d.values() if c < 0) for lc in out_rows]
        pre_ops: list = []
        for _ in range(8):
            worst_lane = max(lane_state.digits)
            worst_in = max(worst_lane, pass_dig if has_pass else 0)
            cover = max(coeff_neg) * worst_in if any(coeff_neg) else 0
            budget = max(coeff_pos + [1]) * worst_in + cover + 255
            if budget <= _F32_CAP:
                break
            lane_state = _split_state(lane_state)
            pre_ops.append(("split",))
        else:  # pragma: no cover - static schedule
            raise fq.BoundError(f"{kname}: out-lincomb does not fit the digit cap")
        w = len(lane_state.digits)

        def profile(idx):
            if idx < L:
                return lane_state.digits, lane_state.value
            return [pass_dig] * _D + [0] * (w - _D), pass_value

        R = len(out_rows)
        mpos = np.zeros((R, L + n_pass), dtype=np.int64)
        mneg = np.zeros((R, L + n_pass), dtype=np.int64)
        oconst = np.zeros((R, w), dtype=np.int64)
        out_digits = [0] * w
        out_value = 0
        for r, lc in enumerate(out_rows):
            row_d = [0] * w
            row_v = 0
            n_cover = 0
            for idx, c in sorted(lc.d.items()):
                pdig, pval = profile(idx)
                if c > 0:
                    mpos[r, idx] = c
                    row_d = [x + c * y for x, y in zip(row_d, pdig)]
                    row_v += c * pval
                else:
                    mneg[r, idx] = -c
                    n_cover += (-c) * max(pdig)
            if n_cover:
                subc = _dsubc_wide(w, n_cover)
                oconst[r] = subc
                row_d = [x + int(y) for x, y in zip(row_d, subc)]
                row_v += sum(int(y) << (8 * i) for i, y in enumerate(subc))
            fq._cert("pallas_lincomb_f32_exact", max(row_d), _F32_CAP, note=kname)
            out_digits = [max(x, y) for x, y in zip(out_digits, row_d)]
            out_value = max(out_value, row_v)

        out_state = _DState(out_digits, out_value)
        if out_bound is None:
            value_limit, limb_target = fq.PUB_VALUE_LIMIT, fq.PUB_LIMB_TARGET
        else:
            fq._cert(
                "pallas_out_bound_top_sound",
                min(out_bound.limb, (out_bound.value_p * P) >> (16 * 24)),
                out_bound.top,
                note=kname,
            )
            value_limit, limb_target = out_bound.value_p * P, out_bound.limb
        post_ops, out_state = _reduce_schedule(out_state, value_limit, limb_target, kname)
        _final_certs(out_state, value_limit, limb_target, kname)
        self.sched = Schedule(
            "K3", kname, L, pre_ops, post_ops, (R, mpos, mneg, oconst), n_pass,
            lin=(self.lin_a, self.lin_b), plan=plan,
            in_bounds=tuple(
                (bd.limb, bd.value_p * P - 1, bd.top) for bd in (in_bound_a, in_bound_b)
            ),
        )


def prepare_plan(plan, n_a, in_bound_a, in_bound_b, name="", out_bound=None):
    """The cached static half of ``execute_plan`` for one call signature."""
    key = (
        id(plan), n_a, _bound_key(in_bound_a), _bound_key(in_bound_b), name,
        _bound_key(out_bound),
    )
    with _LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is None:
            hit = _PreparedPlan(plan, n_a, in_bound_a, in_bound_b, name, out_bound)
            label, k = hit.sched.name, 1
            while label in SCHEDULES:
                k += 1
                label = f"{hit.sched.name}#{k}"
            hit.sched.label = label
            SCHEDULES[label] = hit.sched
            _PLAN_CACHE[key] = hit
        return hit


def execute_plan(plan, a, b, in_bound_a, in_bound_b, name: str = "", out_bound=None):
    """The arm of plans.execute that the reference's Pallas backend takes:
    ONE plan-kernel launch for input lincombs -> conv -> output map ->
    congruence folds -> carries (K3), on the raw operands."""
    prep = prepare_plan(plan, a.shape[-2], in_bound_a, in_bound_b, name, out_bound)
    batch = _batch_shape(a, b, 2)
    out = run_fused(prep.sched, _rows(a, batch, a.shape[-2]), _rows(b, batch, b.shape[-2]))
    return out.reshape(batch + (prep.sched.R, fq.NLIMBS))


# --------------------------------------------------------------------------------------
# Fixed-exponent chains: the step program and the chain kernel
# --------------------------------------------------------------------------------------

COPY = -1  # step descriptor of a gather (no multiply)
CHAINS: dict = {}  # chain name -> ChainProgram, every program built so far


class ChainProgram:
    """A fixed-exponent chain as the chain kernel's static step program.

    Each row carries ``n_state`` slots of one element [n_el, 25]: the base,
    optionally the identity, the table entries and the accumulator. A step
    (desc, dst, src_a, src_b) computes slot dst = sched[desc](slot src_a,
    slot src_b[chain]) for the row's chain (rows are chain-major: row r
    belongs to chain r // (rows / n_chains)); desc ``COPY`` gathers slot
    src_b[chain] into dst. Every multiply sees the operands of the step loop
    it encodes, so the raw limbs equal that loop's."""

    def __init__(self, name, scheds, n_chains, n_el, n_state, slot_base, slot_acc,
                 steps, one=None, slot_one=-1):
        if len(scheds) > 2:
            raise ValueError("a chain program takes at most two step schedules")
        for s in scheds:
            if (s.n_a, s.n_b, s.R) != (n_el, n_el, n_el):
                raise ValueError(f"{name}: step schedule {s.name} does not map slots to slots")
        self.name = name
        self.scheds = tuple(scheds)
        self.n_chains = n_chains
        self.n_el = n_el
        self.n_state = n_state
        self.slot_base = slot_base
        self.slot_acc = slot_acc
        self.slot_one = slot_one
        self.one = None if one is None else np.ascontiguousarray(one, dtype=np.int64)
        self.steps = tuple((d, dst, sa, tuple(sb)) for d, dst, sa, sb in steps)
        self.prog = np.array(
            [[d, dst, sa, *sb] for d, dst, sa, sb in self.steps], dtype=np.int32
        )
        self._dev: dict = {}
        for C in (1, 2, 4, MAX_CLUSTER):
            fq._cert("cuda_smem_bytes", self.launch_shape(C)[3], SMEM_LIMIT, note=f"{name} C={C}")
        with _LOCK:
            held = CHAINS.get(name)
            if held is not None and not self._same(held):
                raise ValueError(f"chain name {name!r} is held by a different program")
            CHAINS[name] = self

    def _same(self, other: "ChainProgram") -> bool:
        return (
            self.scheds == other.scheds and self.n_chains == other.n_chains
            and self.n_el == other.n_el and self.steps == other.steps
            and (self.slot_base, self.slot_acc, self.slot_one)
            == (other.slot_base, other.slot_acc, other.slot_one)
            and (self.one is None) == (other.one is None)
            and (self.one is None or np.array_equal(self.one, other.one))
        )

    @property
    def n_mults(self) -> int:
        return sum(1 for d, *_ in self.steps if d != COPY)

    def cluster(self, rows: int) -> int:
        if not all(s.has_out for s in self.scheds):
            return 1
        return cluster_size(rows, max(s.L for s in self.scheds))

    def launch_shape(self, C: int):
        """(threads, lane_words, all_words, smem bytes) of one CTA at cluster
        size C (csrc: lh_chain_smem_bytes): every CTA runs all R output rows
        of a step (the state stays replicated), so a warp per lane of its
        share or per output row; two buffers of its lane planes and, at
        C > 1, the row's gathered planes."""
        warps = max(max(s.lanes_per_cta(C), s.R if s.has_out else 1) for s in self.scheds)
        threads = 32 * min(_MAX_WARPS, warps)
        lane_words = max(s.lanes_per_cta(C) * s.plane_stride for s in self.scheds)
        all_words = max(s.L * s.plane_stride for s in self.scheds) if C > 1 else 0
        state = -(-(self.n_state + 1) * self.n_el * fq.NLIMBS * 8 // 16) * 16
        smem = (
            state + _N_FOLD8 * _FOLD_BASE * 4 + (2 * lane_words + all_words) * 4
            + (threads // 32) * _SCR_WORDS * 4
        )
        return threads, lane_words, all_words, smem

    def device_args(self, device, batch: int) -> _ChainArgs:
        """The kernel's arguments for ``batch`` rows per chain: a fresh copy
        of the per-device template (its tables kept alive here), so threads
        launching one program at different row counts share nothing
        mutable."""
        with _LOCK:
            hit = self._dev.get(device)
            if hit is None:
                prog = torch.from_numpy(self.prog).to(device)
                one = torch.from_numpy(
                    self.one if self.one is not None else np.zeros(1, np.int64)
                ).to(device)
                descs = [s.device_desc(device) for s in self.scheds]
                args = _ChainArgs()
                for k, d in enumerate(descs):
                    args.d[k] = d
                args.prog, args.one = prog.data_ptr(), one.data_ptr()
                args.n_steps, args.step_len = len(self.steps), 3 + self.n_chains
                args.n_el, args.n_state = self.n_el, self.n_state
                args.slot_one, args.slot_base, args.slot_acc = (
                    self.slot_one, self.slot_base, self.slot_acc,
                )
                hit = (args, prog, one)
                self._dev[device] = hit
        args = _ChainArgs.from_buffer_copy(hit[0])
        args.batch = batch
        return args


def replay_chain(prog: ChainProgram, base, step):
    """The step program replayed one plan step at a time through
    ``step(sched, a, b)`` on base [rows, n_el, 25] (chain-major rows)."""
    rows = base.shape[0]
    batch = rows // prog.n_chains
    state = {prog.slot_base: base}
    if prog.slot_one >= 0:
        state[prog.slot_one] = fq.dconst(prog.one, base).expand(base.shape)
    for d, dst, sa, sb in prog.steps:
        if len(set(sb)) == 1:
            b = state[sb[0]]
        else:
            b = torch.cat([state[s][c * batch : (c + 1) * batch] for c, s in enumerate(sb)])
        state[dst] = b if d == COPY else step(prog.scheds[d], state[sa], b)
    return state[prog.slot_acc]


def plain_chain(prog: ChainProgram, base):
    """The plain version of the chain kernel: the program through
    ``plain_plan``."""
    return replay_chain(prog, base, plain_plan)


def cuda_chain(prog: ChainProgram, base, cluster: int | None = None):
    """Launch the chain kernel on the current stream: base int64
    [rows, n_el, 25] (chain-major rows) -> the chains' results, same shape."""
    rows = base.shape[0]
    _check_operand(base, (rows, prog.n_el, fq.NLIMBS), "chain base")
    if rows % prog.n_chains:
        raise ValueError(f"{prog.name}: {rows} rows do not split into {prog.n_chains} chains")
    base = base.contiguous()
    out = torch.empty_like(base)
    if rows == 0:
        return out
    C = cluster or prog.cluster(rows)
    if C > 1 and not all(s.has_out for s in prog.scheds):
        raise ValueError("chain kernel: a cluster needs output maps in every step")
    threads, lane_words, all_words, smem = prog.launch_shape(C)
    fq._cert("cuda_smem_bytes", smem, SMEM_LIMIT, note=prog.name)
    args = prog.device_args(base.device, rows // prog.n_chains)
    err = _lib().lh_chain_launch(
        ctypes.byref(args), base.data_ptr(), out.data_ptr(),
        fq.dconst(_FOLD8_I32, base).data_ptr(), rows, C, threads, lane_words, all_words, smem,
        torch.cuda.current_stream(base.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {err}")
    _count("CHAIN", prog.name, rows)
    return out


def run_chain(prog: ChainProgram, bases):
    """The chain kernel's wrapper: bases [n_chains, *batch, n_el, 25] -> the
    per-chain results, same shape. The plain version for CPU tensors; the
    CUDA kernel (or an error) for CUDA tensors."""
    flat = bases.reshape(-1, prog.n_el, fq.NLIMBS)
    if bases.device.type == "cpu":
        out = plain_chain(prog, flat)
    elif bases.device.type == "cuda":
        out = cuda_chain(prog, flat)
    else:
        raise ValueError(f"chain kernel: unsupported device {bases.device}")
    return out.reshape(bases.shape)
