"""The fused field multiply: host-side schedules, the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``lighthouse_tpu/ops/bls/pallas_kernels.py:_build_call``
(its ``pl.pallas_call``), entered through ``fused_mul`` (behind
``fq.mont_mul``/``fq.mont_mul_lazy``: kernels K1/K2) and ``execute_plan``
(behind ``plans.execute``: K3). The kernel is ``csrc/fused_mul.cu``, CUDA C++
for ``sm_90a``, built with nvcc into a shared library on first use and bound
with ctypes. It computes the same function as the Pallas kernel:

    int64 limb planes (after the host-side input lincombs)
      -> base-2^8 digits -> 51x51 digit convolution per lane
      -> pre-split schedule -> optional [R, L(+n_pass)] output map
         (positive / negative coefficient matrices, digit-space borrow
         constants == 0 mod p, pass-through rows of the raw ``a``)
      -> post schedule of splits, trims and congruence folds
      -> int64 limbs [rows, R, 25]

The schedules are derived here exactly as the reference derives them
(``_DState``, ``_reduce_schedule``, ``_final_certs``, ``_dsubc_wide`` and the
bound walks of ``fused_mul``/``execute_plan`` are copies), cached per static
signature, and replayed by the kernel. Every intermediate is proven below
2^24, so the kernel's int32 arithmetic is exact.

What bounds the kernel on the H100: at the verify path's shapes (one to a few
thousand rows, 1 to 54 lanes) neither memory traffic nor int32 operations —
a launch is microseconds of fixed cost, and the path makes thousands of them.
The design keeps conv, output map and reduction inside one launch per field
op with every plane in shared memory; CUDA graphs and wider blocks are later
work.

Beside the kernel: ``plain_fused`` replays the same schedule on int64 torch
tensors. The wrapper ``run_fused`` takes it only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. ``launches`` counts kernel launches,
``plain_calls`` calls of the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np
import torch

from . import fq
from ...oracle.fields import P

_D = 51                 # digits per 25-limb element
_CONV_D = 2 * _D - 1    # 101 conv output digit positions
_FOLD_BASE = 48         # digit position of 2^384
_F32_CAP = (1 << 24) - 1  # the reference's f32 exactness cap, kept as the bound
_N_FOLD8 = 64
_OUT_D = 50             # output digit positions (25 limbs)

# launch limit of dynamic shared memory per block on the H100 (sm_90)
SMEM_LIMIT = 232448

launches = 0      # kernel launches (CUDA tensors)
plain_calls = 0   # plain-version calls (CPU tensors, or chip-side comparisons)
# kernel launches by entry: "K1" fused_mul, "K2" fused_mul(lazy), "K3" execute_plan
launches_by = {"K1": 0, "K2": 0, "K3": 0}
# (kind, schedule name, rows) -> launches: the shapes the path gives the kernel
launch_log: dict = {}


def reset_counts() -> None:
    global launches, plain_calls
    launches = 0
    plain_calls = 0
    for k in launches_by:
        launches_by[k] = 0
    launch_log.clear()


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
    """One static call signature of the kernel: schedules, output map and
    their device copies (uploaded once per device)."""

    def __init__(self, kind, name, L, pre_ops, post_ops, out=None, n_pass=0):
        self.kind = kind
        self.name = name
        self.L = L
        self.pre_ops = tuple(pre_ops)
        self.post_ops = tuple(post_ops)
        self.n_pass = n_pass
        self.has_out = out is not None
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
        slots = max(L + n_pass, self.R)
        self.smem_bytes = (2 * L * _D + 2 * slots * self.wmax) * 4
        fq._cert("cuda_smem_bytes", self.smem_bytes, SMEM_LIMIT, note=f"L={L}")
        self.ops_np = np.array(
            _encode(self.pre_ops) + _encode(self.post_ops) + [0], dtype=np.int32
        )
        self._dev: dict = {}

    def device_tables(self, device):
        """(ops, f8, mpos, mneg, oconst) as int32 tensors on ``device``."""
        hit = self._dev.get(device)
        if hit is None:
            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

            dummy = np.zeros(1, dtype=np.int32)
            hit = (
                up(self.ops_np),
                fq.dconst(_FOLD8_I32, torch.empty(0, device=device)),
                up(self.mpos if self.has_out else dummy),
                up(self.mneg if self.has_out else dummy),
                up(self.oconst if self.has_out else dummy),
            )
            self._dev[device] = hit
        return hit


# --------------------------------------------------------------------------------------
# The plain PyTorch version (same schedule, int64 tensors)
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
    """The plain version of the kernel: A, B int64 limbs [rows, L, 25] (and
    Ain [rows, n_pass, 25]) -> int64 limbs [rows, R, 25]."""
    global plain_calls
    plain_calls += 1
    f8 = fq.dconst(_FOLD8_NP, A)
    t = _conv_digits(fq.to_digits(A), fq.to_digits(B))  # [rows, L, 101]
    t = _replay_plain(t, sched.pre_ops, f8)
    if sched.has_out:
        w = t.shape[-1]
        if sched.n_pass:
            pd = fq.to_digits(Ain)
            pd = torch.cat([pd, pd.new_zeros(pd.shape[:-1] + (w - _D,))], dim=-1)
            t = torch.cat([t, pd], dim=-2)
        mpos = fq.dconst(sched.mpos, t)
        pos = (mpos[None, :, :, None] * t[:, None]).sum(dim=2)
        if sched.has_neg:
            neg = (fq.dconst(sched.mneg, t)[None, :, :, None] * t[:, None]).sum(dim=2)
            t = pos + (fq.dconst(sched.oconst, t)[None] - neg)
        else:
            t = pos
        t = _replay_plain(t, sched.post_ops, f8)
    if t.shape[-1] < _OUT_D:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (_OUT_D - t.shape[-1],))], dim=-1)
    return t[..., 0::2] + (t[..., 1::2] << 8)


# --------------------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# --------------------------------------------------------------------------------------

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc", "fused_mul.cu",
)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "_build")
_LIB = None


def build(verbose: bool = False) -> str:
    """Compile csrc/fused_mul.cu for sm_90a into BUILD_DIR (keyed by the
    source's hash, so an edited source rebuilds). Returns the library path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libfused_mul_{digest}.so")
    if not os.path.exists(lib):
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if not os.path.exists(nvcc):
            nvcc = "nvcc"
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", tmp, _SRC,
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        fn = lib.lh_fused_mul
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def cuda_fused(sched: Schedule, A, B, Ain=None):
    """Launch the kernel on the current stream: A, B int64 [rows, L, 25]
    (Ain [rows, n_pass, 25]) on one CUDA device -> int64 [rows, R, 25]."""
    global launches
    rows, L = A.shape[0], A.shape[1]
    if A.dtype != torch.int64 or B.dtype != torch.int64:
        raise TypeError("fused_mul kernel takes int64 limb planes")
    if A.shape != (rows, sched.L, fq.NLIMBS) or B.shape != A.shape:
        raise ValueError(f"fused_mul kernel: bad operand shapes {A.shape} {B.shape}")
    if B.device != A.device:
        raise ValueError("fused_mul kernel: operands on different devices")
    if A.device.index not in (None, torch.cuda.current_device()):
        raise ValueError("fused_mul kernel: operands are not on the current CUDA device")
    A = A.contiguous()
    B = B.contiguous()
    if sched.n_pass:
        if Ain is None or Ain.shape != (rows, sched.n_pass, fq.NLIMBS):
            raise ValueError("fused_mul kernel: bad pass-through operand")
        Ain = Ain.contiguous()
    out = torch.empty((rows, sched.R, fq.NLIMBS), dtype=torch.int64, device=A.device)
    if rows == 0:
        return out
    ops, f8, mpos, mneg, oconst = sched.device_tables(A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _lib().lh_fused_mul(
        A.data_ptr(), B.data_ptr(), Ain.data_ptr() if sched.n_pass else None,
        f8.data_ptr(), mpos.data_ptr(), mneg.data_ptr(), oconst.data_ptr(),
        ops.data_ptr(), out.data_ptr(),
        rows, L, sched.n_pass, sched.R, int(sched.has_out), int(sched.has_neg),
        len(sched.pre_ops), len(sched.post_ops), sched.wmax, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mul kernel launch failed: CUDA error {err}")
    launches += 1
    launches_by[sched.kind] += 1
    key = (sched.kind, sched.name, rows)
    launch_log[key] = launch_log.get(key, 0) + 1
    return out


def run_fused(sched: Schedule, A, B, Ain=None):
    """The wrapper: the plain version for CPU tensors; the CUDA kernel (or an
    error) for CUDA tensors."""
    if A.device.type == "cpu":
        return plain_fused(sched, A, B, Ain)
    if A.device.type != "cuda":
        raise ValueError(f"fused_mul: unsupported device {A.device}")
    return cuda_fused(sched, A, B, Ain)


# --------------------------------------------------------------------------------------
# Entries: fused_mul (K1 / K2) and execute_plan (K3)
# --------------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def mul_schedule(lazy: bool) -> Schedule:
    """The static schedule of ``fused_mul`` (the reference's bound walk)."""
    name = "pallas_mul_lazy" if lazy else "pallas_mul"
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
    return Schedule("K2" if lazy else "K1", name, 1, ops, ())


def fused_mul(a, b, lazy: bool = False):
    """a*b mod p in one fused launch (lazy=False: lazy-budget operands, output
    at plans.PUB_BOUND — K1; lazy=True: chain-bound operands and output — K2)."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[:-1]
    A = a.reshape(-1, 1, fq.NLIMBS)
    B = b.reshape(-1, 1, fq.NLIMBS)
    out = run_fused(mul_schedule(bool(lazy)), A, B)
    return out.reshape(batch + (fq.NLIMBS,))


def _bound_key(b):
    return None if b is None else (b.value_p, b.limb, b.top)


_PLAN_CACHE: dict = {}


class _PreparedPlan:
    """Everything ``execute_plan`` derives statically for one plan and bound
    signature: the input lincomb matrices, the constant pool and the kernel
    schedule with its output map."""

    def __init__(self, plan, n_a, in_bound_a, in_bound_b, name, out_bound):
        from . import plans

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
            "K3", kname, L, pre_ops, post_ops, (R, mpos, mneg, oconst), n_pass
        )


def prepare_plan(plan, n_a, in_bound_a, in_bound_b, name="", out_bound=None):
    """The cached static half of ``execute_plan`` for one call signature."""
    key = (
        id(plan), n_a, _bound_key(in_bound_a), _bound_key(in_bound_b), name,
        _bound_key(out_bound),
    )
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        hit = _PreparedPlan(plan, n_a, in_bound_a, in_bound_b, name, out_bound)
        _PLAN_CACHE[key] = hit
    return hit


def execute_plan(plan, a, b, in_bound_a, in_bound_b, name: str = "", out_bound=None):
    """The arm of plans.execute that the reference's Pallas backend takes:
    input lincombs (torch, outside the kernel), then ONE kernel launch for
    conv -> output map -> congruence folds -> carries (K3)."""
    from . import plans

    prep = prepare_plan(plan, a.shape[-2], in_bound_a, in_bound_b, name, out_bound)
    A = plans.apply_tables(prep.lin_a, a)
    B = plans.apply_tables(prep.lin_b, plans.append_const_pool(plan, b))
    A, B = torch.broadcast_tensors(A, B)
    batch = A.shape[:-2]
    L = A.shape[-2]
    Ain = None
    if prep.sched.n_pass:
        Ain = a.expand(batch + a.shape[-2:]).reshape(-1, a.shape[-2], fq.NLIMBS)
    out = run_fused(
        prep.sched, A.reshape(-1, L, fq.NLIMBS), B.reshape(-1, L, fq.NLIMBS), Ain
    )
    return out.reshape(batch + (prep.sched.R, fq.NLIMBS))
