"""Fixed-scalar chain schedules for host-known scalars and exponents.

Port of ``lighthouse_tpu/ops/bls/chain_plans.py``. ``wnaf_digits``,
``ChainSchedule`` and ``compile_chains`` are copies (pinned equal to the
reference by tests). The executors replace the reference's ``lax.scan`` /
``fori_loop`` with Python loops over the host-known segments, and its
device-side table gathers with static indexing: the digit of every chain at
every segment is a host constant. ``field_chain_program`` encodes the field
executor's loop as a step program that the chain kernel runs in one launch
(``fused_mul.run_chain``); ``run_field_chains`` stays as the step loop that
program is held to.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def wnaf_digits(e: int, w: int) -> list[int]:
    """LSB-first width-w NAF (w = 1: plain binary; w = 2: classic NAF)."""
    if e < 0:
        raise ValueError("wnaf_digits takes a non-negative scalar")
    if w == 1:
        return [int(b) for b in bin(e)[2:][::-1]] if e else [0]
    out = []
    while e:
        if e & 1:
            d = e & ((1 << w) - 1)
            if d >= 1 << (w - 1):
                d -= 1 << w
            out.append(d)
            e -= d
        else:
            out.append(0)
        e >>= 1
    return out or [0]


class ChainSchedule:
    """Joint MSB-first schedule for C chains sharing doubling runs.

    segments: list of (run, digits) — ``run`` doublings (squarings), then one
    add (multiply) consuming per-chain signed digit ``digits[c]`` (0 = no-op
    via the identity table slot). The leading segment has run = 0 and
    initializes the accumulators from the table."""

    __slots__ = ("segments", "n_chains", "table_max", "signed", "negate")

    def __init__(self, segments, n_chains, table_max, signed, negate):
        self.segments = segments
        self.n_chains = n_chains
        self.table_max = table_max
        self.signed = signed
        self.negate = negate

    @property
    def n_doublings(self) -> int:
        return sum(r for r, _ in self.segments)

    @property
    def n_adds(self) -> int:
        return len(self.segments)

    def table_slots(self) -> list[int]:
        if self.signed:
            return [0] + list(range(1, self.table_max + 1, 2))
        return list(range(self.table_max + 1))

    def slot_index(self, d: int) -> int:
        if self.signed:
            return 0 if d == 0 else (abs(d) + 1) // 2
        return d


def _merge_digit_columns(digit_rows: list[list[int]]):
    n = max(len(r) for r in digit_rows)
    cols = []
    for i in range(n - 1, -1, -1):
        cols.append(tuple(r[i] if i < len(r) else 0 for r in digit_rows))
    segments = []
    run = 0
    started = False
    for col in cols:
        if any(col):
            segments.append((run if started else 0, col))
            run = 1
            started = True
        else:
            run += 1
    if not started:
        return [(0, tuple(0 for _ in digit_rows))]
    if run > 1:
        segments.append((run - 1, tuple(0 for _ in digit_rows)))
    return segments


def _schedule_cost(schedule: ChainSchedule, dbl_cost=1.0, add_cost=1.2) -> float:
    slots = len(schedule.table_slots())
    return (
        schedule.n_doublings * dbl_cost
        + schedule.n_adds * add_cost
        + max(0, slots - 2) * add_cost
    )


@functools.lru_cache(maxsize=None)
def compile_chains(scalars: tuple, window: int | None = None, signed: bool = True) -> ChainSchedule:
    """Compile host-known scalars into the cheapest joint schedule."""
    mags = [abs(int(e)) for e in scalars]
    negate = tuple(e < 0 for e in scalars)

    def build(w: int) -> ChainSchedule:
        if signed and w > 1:
            rows = [wnaf_digits(e, w) for e in mags]
            table_max = max([1] + [max((abs(d) for d in r), default=0) for r in rows])
            return ChainSchedule(_merge_digit_columns(rows), len(mags), table_max, True, negate)
        rows = []
        for e in mags:
            r = []
            while True:
                r.append(e & ((1 << w) - 1))
                e >>= w
                if not e:
                    break
            rows.append(r)
        table_max = max(max(r) for r in rows)
        segs = _merge_digit_columns(rows)
        segs = [(r * w, col) for r, col in segs]
        segs[0] = (0, segs[0][1])
        return ChainSchedule(segs, len(mags), table_max, False, negate)

    candidates = [build(w) for w in ((window,) if window else range(1, 7))]
    return min(candidates, key=_schedule_cost)


# --------------------------------------------------------------------------------------
# Executors (Python loops over the static segments)
# --------------------------------------------------------------------------------------


def _gather_static(table: list, col, schedule: ChainSchedule):
    """Per-chain table entries for one digit column: [C, *batch, ...]."""
    return torch.stack(
        [table[schedule.slot_index(d)][c] for c, d in enumerate(col)], dim=0
    )


def run_point_chains(k: int, points, schedule: ChainSchedule):
    """Execute a compiled schedule on stacked points [C, *batch, 3k, 25]."""
    from . import curve

    if points.shape[0] != schedule.n_chains:
        raise ValueError("one stacked point per chain")
    inf = curve.inf_point(k, points.shape[:-2], points.device)
    slots = schedule.table_slots()
    entries = {0: inf, 1: points}
    if schedule.signed:
        step2 = curve.point_dbl(k, points) if schedule.table_max > 1 else None
        for s in slots[2:]:
            entries[s] = curve.point_add(k, entries[s - 2], step2)
    else:
        for s in slots[2:]:
            entries[s] = curve.point_add(k, entries[s - 1], points)
    table = [entries[s] for s in slots]
    bshape = points.shape[1:-2]

    def gather(col):
        ent = _gather_static(table, col, schedule)
        sign = [d < 0 for d in col]
        if not any(sign):
            return ent
        neg = curve.point_neg(k, ent)
        m = torch.tensor(sign, device=ent.device).reshape((len(col),) + (1,) * len(bshape))
        return curve.point_select(m.expand(ent.shape[:-2]), neg, ent)

    acc = gather(schedule.segments[0][1])
    for run, col in schedule.segments[1:]:
        for _ in range(run):
            acc = curve.point_dbl(k, acc)
        acc = curve.point_add(k, acc, gather(col))
    if any(schedule.negate):
        m = torch.tensor(schedule.negate, device=acc.device).reshape(
            (schedule.n_chains,) + (1,) * len(bshape)
        )
        acc = curve.point_select(m.expand(acc.shape[:-2]), curve.point_neg(k, acc), acc)
    return acc


def scale_fixed_chain(k: int, point, e: int, window: int | None = None):
    """[e] * point via the chain compiler (handles e < 0 and e == 0)."""
    from . import curve

    if e == 0:
        return curve.inf_point(k, point.shape[:-2], point.device)
    return run_point_chains(k, point[None], compile_chains((e,), window))[0]


def run_field_chains(schedule: ChainSchedule, bases, sqr_fn, mul_fn, one_arr, mul_many_fn=None):
    """Execute an unsigned schedule in a multiplicative group: bases
    [C, *batch, k, 25] -> per-chain powers, same shape. The table is built
    with a log-depth ladder (one stacked multiply per level)."""
    from . import fq

    if schedule.signed or any(schedule.negate):
        raise ValueError("field chains take unsigned schedules")
    mul_many_fn = mul_many_fn or mul_fn
    n_slots = len(schedule.table_slots())
    one = fq.dconst(one_arr, bases).expand(bases.shape)
    entries = [one, bases]
    while len(entries) < n_slots:
        take = min(len(entries) - 1, n_slots - len(entries))
        lhs = entries[-1][None].expand((take,) + entries[-1].shape)
        rhs = torch.stack(entries[1 : take + 1], dim=0)
        prod = mul_many_fn(lhs, rhs)
        for j in range(take):
            entries.append(prod[j])
    acc = _gather_static(entries, schedule.segments[0][1], schedule)
    for run, col in schedule.segments[1:]:
        for _ in range(run):
            acc = sqr_fn(acc)
        acc = mul_fn(acc, _gather_static(entries, col, schedule))
    return acc


def field_chain_program(name: str, schedule: ChainSchedule, sqr_sched, mul_sched, one_arr):
    """``run_field_chains`` as a chain-kernel step program (fused_mul.
    ChainProgram), operand for operand: slot 0 the identity, slot 1 the
    base, slots 2.. the ladder's table entries (slot k = table position k),
    the last slot the accumulator. ``sqr_sched``/``mul_sched`` are the plan
    schedules behind the loop's sqr_fn/mul_fn."""
    from .fused_mul import COPY, ChainProgram

    if schedule.signed or any(schedule.negate):
        raise ValueError("field chains take unsigned schedules")
    scheds = (mul_sched,) if sqr_sched is mul_sched else (mul_sched, sqr_sched)
    MUL, SQR = 0, len(scheds) - 1
    n_slots = len(schedule.table_slots())
    C = schedule.n_chains
    steps = []
    n = 2  # entries built: the identity and the base
    while n < n_slots:
        take = min(n - 1, n_slots - n)
        steps += [(MUL, n + j, n - 1, (1 + j,) * C) for j in range(take)]
        n += take
    acc = n_slots

    def gather(col):
        return tuple(schedule.slot_index(d) for d in col)

    steps.append((COPY, acc, acc, gather(schedule.segments[0][1])))
    for run, col in schedule.segments[1:]:
        steps += [(SQR, acc, acc, (acc,) * C)] * run
        steps.append((MUL, acc, acc, gather(col)))
    one = np.asarray(one_arr, dtype=np.int64).reshape(-1, 25)
    return ChainProgram(
        name, scheds, C, one.shape[0], n_slots + 1, 1, acc, steps, one=one, slot_one=0
    )
