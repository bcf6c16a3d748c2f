"""The port's fixed-exponent chains (the chain kernel's step programs).

``lighthouse_tpu_torch.ops.bls.fused_mul.run_chain`` runs a whole chain as
one launch of the chain kernel; on the CPU it replays the same step program
through the plan kernel's plain version. Held here, with exact integer
equality:

* the program replayed equals the step-by-step loop it encodes, raw limbs,
  at the full exponents of the path's chains (Fermat inversion,
  sqrt_candidate, the Fq2 square-root chain, the |x| cyclotomic power);
* the canonical results equal the oracle's powers;
* on a short exponent, the raw limbs equal the reference's
  ``run_field_chains`` with its Pallas kernel in interpret mode;
* the step-program encoder round-trips the ChainSchedule segments.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.ops.bls import chain_plans as r_chain, fq as r_fq, tower as r_tower

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops.bls import chain_plans, fq, fused_mul as fm, plans, tower
from lighthouse_tpu_torch.ops.bls.curve import fixed_schedule
from lighthouse_tpu_torch.oracle import fields as of

P = of.P
rng = random.Random(0xC4A1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tests run at small shapes: one intra-op thread keeps torch
    from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def pallas_backend():
    """Run the reference's multiplies through its Pallas kernel (interpret
    mode on the CPU), restoring the backend afterwards."""
    old = r_fq._CONV_IMPL
    r_fq._CONV_IMPL = "pallas"
    yield
    r_fq._CONV_IMPL = old


def _fq_rows(n, bound_limb=None):
    """n random residues as [n, 25] int64, the last one with every limb at
    ``bound_limb`` (an edge of the chain's input bound) when given."""
    x = fq.from_ints([rng.randrange(P) for _ in range(n)], "cpu")
    if bound_limb is not None:
        x[-1] = bound_limb
        x[-1, 24] = 0
    return x


def _chain_in(x):
    """A base brought to the chain bound, as pow_fixed_scan does."""
    return fq.reduce_limbs(
        x, [fq._IN_LIMB] * 25, fq._IN_VALUE, fq.CHAIN_VALUE_LIMIT, fq.CHAIN_LIMB_TARGET
    )


def _rfq12():
    r = lambda: of.Fq2(rng.randrange(P), rng.randrange(P))  # noqa: E731
    return of.Fq12(of.Fq6(r(), r(), r()), of.Fq6(r(), r(), r()))


def _cyclotomic(n):
    gs = []
    for _ in range(n):
        a = _rfq12()
        g = a.conjugate() * a.inv()
        gs.append(g.frobenius(2) * g)
    return gs


def _cyc_exp_steps(a):
    """fq12_cyclotomic_exp_abs_x as a step loop: one plan execution per
    step (the loop the chain program encodes)."""
    segs = fixed_schedule(-of.BLS_X)
    res = tower.fq12_mul_lazy(tower.fq12_cyclotomic_sqr_lazy(a), a)
    for run, mul in segs[1:]:
        for _ in range(run):
            res = tower.fq12_cyclotomic_sqr_lazy(res)
        if mul:
            res = tower.fq12_mul_lazy(res, a)
    return res


# --------------------------------------------------------------------------------------
# The program replayed == the step loop, raw limbs, full exponents
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "e,name", [(P - 2, "inv"), ((P + 1) // 4, "sqrt_candidate")], ids=["inv", "sqrt_candidate"]
)
def test_fq_chain_equals_step_loop(e, name):
    """pow_fixed_scan's chain: the program == run_field_chains over K2
    multiplies, raw limbs; the result == the oracle's power."""
    a = _chain_in(_fq_rows(3, bound_limb=fq.CHAIN_LIMB_TARGET))
    bases = a[None, :, None, :]
    sched = chain_plans.compile_chains((e,), signed=False)
    loop = chain_plans.run_field_chains(sched, bases, fq.mont_sqr_lazy, fq.mont_mul_lazy, fq.ONE_M)
    got = fm.run_chain(fq._pow_program(e, name), bases)
    assert torch.equal(got, loop)
    vals = [fq.to_int(r) for r in a]
    out = fq.reduce_limbs(got[0, :, 0], [fq.CHAIN_LIMB_TARGET] * 25, fq.CHAIN_VALUE_LIMIT)
    assert fq.to_ints(out) == [pow(v, e, P) for v in vals]
    public = {"inv": fq.inv, "sqrt_candidate": fq.sqrt_candidate}[name](a)
    assert torch.equal(public, out)


def test_fq2_sqrt_chain_equals_step_loop():
    """The joint (w, conj(w)) Fq2 chain: the program == run_field_chains over
    SQR2/MUL2 plans at the chain bound, raw limbs, per chain; the product
    == the oracle's w^((p^2-9)/16)."""
    ws = [of.Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(3)]
    w = torch.stack([fq.from_ints([x.c0, x.c1], "cpu") for x in ws])
    bases = torch.stack([w, plans.carry_norm(tower.fq2_conj(w))])
    sched = chain_plans.compile_chains((tower._SQRT_E0, tower._SQRT_E1), signed=False)
    loop = chain_plans.run_field_chains(
        sched, bases, tower.fq2_sqr_lazy, tower.fq2_mul_lazy, tower.one_np(2)
    )
    got = fm.run_chain(tower._sqrt_program(), bases)
    assert torch.equal(got, loop)
    t = tower._sqrt_chain(w)
    for i, x in enumerate(ws):
        want = tower._fq2_pow_host(x, tower._SQRT_E)
        assert fq.to_ints(t[i]) == [want.c0, want.c1]


def test_cyclotomic_exp_equals_step_loop():
    """The |x| unroll: the program == the step loop of CYC_SQR / MUL12 plan
    executions, raw limbs; the result == the oracle's g^|x|."""
    gs = _cyclotomic(2)
    g = torch.stack([tower.fq12_from_oracle(x, "cpu") for x in gs])
    loop = _cyc_exp_steps(g)
    got = fm.run_chain(tower._cyc_exp_program(), g[None])[0]
    assert torch.equal(got, loop)
    out = tower.fq12_cyclotomic_exp_abs_x(g)
    assert torch.equal(out, plans.carry_norm(loop))
    for i, x in enumerate(gs):
        assert tower.fq12_to_oracle(out[i]) == x.pow(-of.BLS_X)


# --------------------------------------------------------------------------------------
# Against the reference on a short exponent (Pallas interpret mode)
# --------------------------------------------------------------------------------------


def test_fq_chain_equals_reference_short_exponent():
    """A 20-bit exponent through the port's program and the reference's
    run_field_chains (Pallas kernel, interpret mode): raw limbs equal."""
    e = 0xB5A3D
    a = _chain_in(_fq_rows(2, bound_limb=fq.CHAIN_LIMB_TARGET))
    bases = a[None, :, None, :]
    sched = chain_plans.compile_chains((e,), signed=False)
    rsched = r_chain.compile_chains((e,), signed=False)
    want = np.asarray(
        r_chain.run_field_chains(
            rsched, jnp.asarray(convert.to_numpy(bases)), r_fq.mont_sqr_lazy,
            r_fq.mont_mul_lazy, r_fq.ONE_M,
        )
    )
    k2 = fm.mul_schedule(True)
    prog = chain_plans.field_chain_program("pow_short", sched, k2, k2, fq.ONE_M)
    got = fm.run_chain(prog, bases)
    assert (convert.to_numpy(got) == want).all()
    assert fq.to_ints(fq.canonical(got[0, :, 0])) == [pow(fq.to_int(r), e, P) for r in a]


def test_fq2_chain_equals_reference_short_exponent():
    """Two Fq2 chains of different bases and 16-bit exponents: the port's
    program (per-chain table gathers) == the reference's run_field_chains
    over its SQR2/MUL2 plans (Pallas kernel, interpret mode), raw limbs."""
    exps = (0xB3A5, 0x61F3)
    w = torch.stack(
        [fq.from_ints([rng.randrange(P), rng.randrange(P)], "cpu") for _ in range(2)]
    )
    bases = torch.stack([w, plans.carry_norm(tower.fq2_conj(w))])
    rsched = r_chain.compile_chains(exps, signed=False)
    want = np.asarray(
        r_chain.run_field_chains(
            rsched, jnp.asarray(convert.to_numpy(bases)), r_tower.fq2_sqr_lazy,
            r_tower.fq2_mul_lazy, r_tower.one(2),
        )
    )
    base_prog = tower._sqrt_program()
    sqr, mul = base_prog.scheds[1], base_prog.scheds[0]
    sched = chain_plans.compile_chains(exps, signed=False)
    prog = chain_plans.field_chain_program("fq2_short", sched, sqr, mul, tower.one_np(2))
    got = fm.run_chain(prog, bases)
    assert (convert.to_numpy(got) == want).all()


# --------------------------------------------------------------------------------------
# The encoder
# --------------------------------------------------------------------------------------


def _run_exponents(prog):
    """Replay a program on exponents instead of elements: slot values are
    per-chain exponents of the base; a multiply adds, a square doubles."""
    C = prog.n_chains
    state = {prog.slot_base: [1] * C}
    if prog.slot_one >= 0:
        state[prog.slot_one] = [0] * C
    for d, dst, sa, sb in prog.steps:
        b = [state[s][c] for c, s in enumerate(sb)]
        state[dst] = b if d == fm.COPY else [x + y for x, y in zip(state[sa], b)]
    return state[prog.slot_acc]


@pytest.mark.parametrize(
    "scalars", [(P - 2,), ((P + 1) // 4,), (tower._SQRT_E0, tower._SQRT_E1), (0xB3A5, 0x61F3), (1,), (2, 7)]
)
def test_program_round_trips_segments(scalars):
    """The field program decodes back to the schedule: the ladder fills
    slot k with base^k, the first gather and each segment's (run, per-chain
    slot) equal the schedule's segments, and replayed on exponents the
    program computes each chain's scalar."""
    sched = chain_plans.compile_chains(scalars, signed=False)
    k2 = fm.mul_schedule(True)
    one = np.zeros((1, 25), np.int64)
    name = "enc_" + "_".join(f"{x:x}" for x in scalars)
    prog = chain_plans.field_chain_program(name, sched, k2, k2, one)
    n_slots = len(sched.table_slots())
    steps = list(prog.steps)
    ladder = [s for s in steps if s[1] < n_slots]
    exps = {0: 0, 1: 1}
    for d, dst, sa, sb in ladder:
        assert d != fm.COPY and len(set(sb)) == 1
        exps[dst] = exps[sa] + exps[sb[0]]
    assert exps == {k: k for k in range(n_slots)}
    rest = steps[len(ladder):]
    assert rest[0][0] == fm.COPY
    decoded = [(0, rest[0][3])]
    run = 0
    for d, dst, sa, sb in rest[1:]:
        assert dst == prog.slot_acc and sa == prog.slot_acc
        if sb == (prog.slot_acc,) * prog.n_chains:
            run += 1
        else:
            decoded.append((run, sb))
            run = 0
    assert run == 0
    assert decoded == [
        (r, tuple(sched.slot_index(d) for d in col)) for r, col in sched.segments
    ]
    assert _run_exponents(prog) == list(scalars)


def test_cyclotomic_program_computes_abs_x():
    prog = tower._cyc_exp_program()
    assert _run_exponents(prog) == [-of.BLS_X]
    assert prog.n_mults == len(prog.steps) == 68


def test_chain_wrapper_routes_and_rejects():
    """CPU bases take the plain version (plain calls counted, no launch);
    meta bases the abstract arm (an empty output, no launch, no plain call;
    a bad shape raises); the CUDA wrapper checks dtype and shape before any
    launch (host-side checks, testable without a card)."""
    prog = fq._pow_program(P - 2, "inv")
    fm.reset_counts()
    x = _chain_in(fq.from_ints([5], "cpu"))[None, :, None, :]
    fm.run_chain(prog, x)
    assert fm.launches == 0 and fm.plain_calls == prog.n_mults
    fm.reset_counts()
    out = fm.run_chain(prog, x.to("meta"))
    assert out.device.type == "meta" and out.shape == x.shape
    assert fm.launches == 0 and fm.plain_calls == 0
    with pytest.raises(ValueError):
        fm.meta_chain(prog, torch.zeros((2, 2, 25), dtype=torch.int64, device="meta"))
    with pytest.raises(TypeError):
        fm.cuda_chain(prog, torch.zeros((2, 1, 25), dtype=torch.int32))
    with pytest.raises(ValueError):
        fm.cuda_chain(prog, torch.zeros((2, 2, 25), dtype=torch.int64))


def test_chain_launch_shapes():
    """Cluster sizes and shared memory of the path's chains: the |x| chain
    at rows 1 spreads over 8 CTAs, the Fq2 chain at 128 rows and every K2
    chain stay at 1; each CTA's share fits the launch limit."""
    cyc, sq, inv = tower._cyc_exp_program(), tower._sqrt_program(), fq._pow_program(P - 2, "inv")
    assert cyc.cluster(1) == 8 and sq.cluster(128) == 1 and inv.cluster(1) == 1
    for prog in (cyc, sq, inv):
        for C in (1, 2, 4, 8):
            threads, lane_words, all_words, smem = prog.launch_shape(C)
            assert 32 <= threads <= 256 and smem <= fm.SMEM_LIMIT


def test_chain_names_name_one_program():
    """A chain name names one program: rebuilding the same program under it
    is fine, a different one (another exponent) raises, so the launch
    counts and ``fused_mul.CHAINS`` never mix two chains."""
    k2 = fm.mul_schedule(True)
    build = lambda e: chain_plans.field_chain_program(  # noqa: E731
        "names_once", chain_plans.compile_chains((e,), signed=False), k2, k2, fq.ONE_M
    )
    first = build(0xB5A3D)
    again = build(0xB5A3D)
    assert fm.CHAINS["names_once"] is again and again._same(first)
    with pytest.raises(ValueError):
        build(0xB5A3F)
    with pytest.raises(TypeError):
        fq.pow_fixed_scan(fq.from_ints([5], "cpu"), 7)
