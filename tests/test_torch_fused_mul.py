"""The port's fused field multiply against the reference's Pallas kernel.

``lighthouse_tpu_torch.ops.bls.fused_mul`` replaces the reference's only
Pallas kernel (``ops/bls/pallas_kernels.py:_build_call``, entered through
``fused_mul`` and ``execute_plan``). On the CPU its wrapper runs the plain
PyTorch version, which replays the same static schedule as the CUDA kernel.
Held here, with exact integer equality:

* the schedules (op lists, output maps, input lincomb tables) equal the
  reference's, for K1, K2 and every plan signature the verify path runs;
* the plain version's RAW output limbs equal the reference kernel's, run in
  Pallas interpret mode, on random and edge inputs;
* the plan kernel's plain version (input lincombs from the schedule's
  tables) equals what the kernel computes from its encoded tables, and
  those tables decode back to the schedule;
* the wrapper's views, cluster sizes and ctypes layouts;
* the copied builders, chain schedules and oracle equal the reference's.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.ops.bls import (
    chain_plans as r_chain,
    curve as r_curve,
    fq as r_fq,
    pairing as r_pairing,
    pallas_kernels as r_pk,
    plans as r_plans,
    tower as r_tower,
)
from lighthouse_tpu.ops.bls_oracle import fields as r_of, hash_to_curve as r_oh

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops.bls import (
    chain_plans,
    curve,
    fq,
    fused_mul as fm,
    pairing,
    plans,
    tower,
)
from lighthouse_tpu_torch.oracle import fields as of, hash_to_curve as oh

P = of.P
rng = random.Random(0xF05ED)


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
    """Run the reference kernels through the Pallas backend (interpret mode
    on the CPU), restoring the backend afterwards."""
    old = r_fq._CONV_IMPL
    r_fq._CONV_IMPL = "pallas"
    yield
    r_fq._CONV_IMPL = old


def _rb(b):
    """Port bound -> reference bound."""
    return None if b is None else r_plans._Bound(b.value_p, b.limb, b.top)


def edge_limbs(lim: int, value_max: int, top: int | None = None) -> list[int]:
    """Limbs as large as the budget allows: limbs 0..22 at ``lim``, the top
    two filled greedily up to ``value_max`` (top limb capped at ``top``)."""
    edge = [lim] * 23
    room = value_max - sum(v << (16 * i) for i, v in enumerate(edge))
    l24 = min(lim, room >> 384, lim if top is None else top)
    l23 = min(lim, (room - (l24 << 384)) >> 368)
    out = edge + [l23, l24]
    assert sum(v << (16 * i) for i, v in enumerate(out)) <= value_max
    return out


def _limbs(vals):
    return np.array([fq.int_to_limbs(v % P) for v in vals], dtype=np.uint64)


def _spy_reference(monkeypatch):
    """Capture the reference's (pre_ops, out_key, post_ops) per kernel call."""
    seen = []
    orig = r_pk._run_fused

    def spy(A_d, B_d, pre_ops, out_key, post_ops, Ain_d=None):
        seen.append((tuple(pre_ops), out_key, tuple(post_ops)))
        return orig(A_d, B_d, pre_ops, out_key, post_ops, Ain_d)

    monkeypatch.setattr(r_pk, "_run_fused", spy)
    return seen


# --------------------------------------------------------------------------------------
# K1 / K2
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("lazy", [False, True])
def test_fused_mul_raw_parity(lazy, monkeypatch):
    """Plain version == reference fused_mul (interpret), raw limbs, on
    random inputs and edges: 0, 1, p-1, the conv-budget maxima (limbs
    2^22-1 at value ~1200p) and the chain-bound maxima."""
    xs = [rng.randrange(P) for _ in range(5)] + [0, 1, P - 1]
    ys = [rng.randrange(P) for _ in range(5)] + [P - 1, 1, P - 1]
    a = _limbs(xs)
    b = _limbs(ys)
    chain_edge = edge_limbs(fq.CHAIN_LIMB_TARGET, fq.CHAIN_VALUE_LIMIT - 1)
    edges = [chain_edge]
    if not lazy:
        edges.append(edge_limbs(fq._IN_LIMB, fq._IN_VALUE - 1))
    for e in edges:
        a = np.concatenate([a, np.array([e], dtype=np.uint64)])
        b = np.concatenate([b, np.array([e], dtype=np.uint64)])
    seen = _spy_reference(monkeypatch)
    want = np.asarray(r_pk.fused_mul(jnp.asarray(a), jnp.asarray(b), lazy=lazy))
    got = fm.fused_mul(convert.to_torch(a, "cpu"), convert.to_torch(b, "cpu"), lazy=lazy)
    assert (convert.to_numpy(got) == want).all()
    # the schedule replayed is the reference's, op for op
    (pre, out_key, post), = seen
    sched = fm.mul_schedule(lazy)
    assert out_key is None and post == ()
    assert sched.pre_ops == pre
    vals = [fq.limbs_to_int(r) for r in a], [fq.limbs_to_int(r) for r in b]
    assert fq.to_ints(got) == [x * y % P for x, y in zip(*vals)]


def test_wrapper_routes_by_device():
    """A CPU tensor takes the plain version (and counts a plain call); the
    launch counter moves only for kernel launches."""
    fm.reset_counts()
    x = fq.from_ints([3, 5], "cpu")
    out = fq.mont_mul(x, x)
    assert fq.to_ints(out) == [9, 25]
    assert fm.plain_calls == 1 and fm.launches == 0
    fm.reset_counts()


def test_kernel_wrapper_rejects_bad_operands():
    """The CUDA wrapper checks dtype, shape and device before any launch
    (these checks run on the host, so they are testable without a card)."""
    sched = fm.mul_schedule(False)
    a = torch.zeros((2, 1, 25), dtype=torch.int64)
    with pytest.raises(TypeError):
        fm.cuda_fused(sched, a.to(torch.int32), a.to(torch.int32))
    with pytest.raises(ValueError):
        fm.cuda_fused(sched, torch.zeros((2, 2, 25), dtype=torch.int64), a)
    with pytest.raises(ValueError):
        fm.run_fused(sched, a.to("meta"), a.to("meta"))


# --------------------------------------------------------------------------------------
# K3: execute_plan on the path's plans
# --------------------------------------------------------------------------------------


def _canon_rand(shape):
    n = int(np.prod(shape[:-1]))
    return _limbs([rng.randrange(P) for _ in range(n)]).reshape(shape)


PLAN_CASES = [
    ("MUL2", lambda: (plans.MUL2, r_plans.MUL2), plans.PUB_BOUND, None),
    ("SQR2", lambda: (plans.SQR2, r_plans.SQR2), plans.PUB_BOUND, None),
    ("MUL12", lambda: (plans.MUL12, r_plans.MUL12), plans.PUB_BOUND, None),
    ("CYC_SQR", lambda: (plans.CYC_SQR, r_plans.CYC_SQR), plans.F12_BOUND, plans.F12_BOUND),
    ("FROB12", lambda: (plans.FROB12, r_plans.FROB12), plans.PUB_BOUND, None),
    ("g2add1", lambda: (curve._add_plans(2)[0], r_curve._add_plans(2)[0]), plans.PUB_BOUND, None),
    ("mldbl2", lambda: (pairing.DBL2, r_pairing.DBL2), plans.F12_BOUND, plans.F12_BOUND),
]


@pytest.mark.parametrize("name,get,bound,out_bound", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_execute_plan_raw_parity(name, get, bound, out_bound, monkeypatch):
    """Plain version == reference execute_plan (interpret), raw limbs, on
    random canonical inputs plus one row at the input bound's maxima."""
    plan, rplan = get()
    rows = 3
    a = _canon_rand((rows, plan.n_a, 25))
    b = _canon_rand((rows, plan.n_b, 25))
    a[0, :] = edge_limbs(bound.limb, bound.value_p * P - 1, bound.top)
    b[0, :] = edge_limbs(bound.limb, bound.value_p * P - 1, bound.top)
    seen = _spy_reference(monkeypatch)
    want = np.asarray(
        r_pk.execute_plan(
            rplan, jnp.asarray(a), jnp.asarray(b), _rb(bound), _rb(bound), name, _rb(out_bound)
        )
    )
    got = fm.execute_plan(
        plan, convert.to_torch(a, "cpu"), convert.to_torch(b, "cpu"), bound, bound, name,
        out_bound,
    )
    assert (convert.to_numpy(got) == want).all()
    (pre, out_key, post), = seen
    sched = fm.prepare_plan(plan, plan.n_a, bound, bound, name, out_bound).sched
    assert (sched.pre_ops, sched.post_ops) == (pre, post)
    R, mpos, mneg, oconst, n_pass, _ = r_pk._OUT_TABLE[out_key]
    assert (sched.R, sched.n_pass) == (R, n_pass)
    assert (sched.mpos == mpos.astype(np.int64)).all()
    assert (sched.mneg == mneg.astype(np.int64)).all()
    assert (sched.oconst == oconst.astype(np.int64)).all()


def _decode(sched):
    """The kernel's int32/int64 tables decoded back into dense matrices:
    (A lincomb, A constants, B lincomb, B constants, constant pool, output
    map or None, output digit constants or None)."""
    ints, o = sched.ints, sched.offs

    def dense(off, n_rows, n_cols):
        m = np.zeros((n_rows, n_cols), dtype=np.int64)
        for r in range(n_rows):
            for k in range(int(ints[off + r]), int(ints[off + r + 1]), 2):
                m[r, ints[k]] += int(ints[k + 1])
        return m

    n_lc = sched.L * 25
    Ma = dense(o["off_la"], sched.L, sched.n_a)
    Mb = dense(o["off_lb"], sched.L, sched.n_b + len(sched.pool))
    ca = sched.i64[:n_lc].reshape(sched.L, 25)
    cb = sched.i64[n_lc : 2 * n_lc].reshape(sched.L, 25)
    pool = sched.i64[2 * n_lc :].reshape(-1, 25)
    Mout = oconst = None
    if sched.has_out:
        Mout = dense(o["off_out"], sched.R, sched.L + sched.n_pass)
        n_oc = sched.R * sched.w_mid
        oconst = ints[o["off_oconst"] : o["off_oconst"] + n_oc].astype(np.int64)
        oconst = oconst.reshape(sched.R, sched.w_mid)
    return Ma, ca, Mb, cb, pool, Mout, oconst


def _kernel_emulation(sched, a, b):
    """What the kernel computes from its encoded tables, in int64 torch:
    each lane operand sum_j c_j x_j + its constants, the digit conv and
    pre-schedule, each output row sum_j c_j plane_j + its digit constants,
    the post-schedule. (plain_plan builds the same from the schedule's own
    tables instead.)"""
    Ma, ca, Mb, cb, pool, Mout, oconst = (
        None if m is None else torch.from_numpy(m) for m in _decode(sched)
    )
    b = torch.cat([b, pool.expand((b.shape[0],) + pool.shape)], dim=1)
    A = (Ma[None, :, :, None] * a[:, None]).sum(dim=2) + ca
    B = (Mb[None, :, :, None] * b[:, None]).sum(dim=2) + cb
    f8 = torch.from_numpy(fm._FOLD8_NP)
    t = fm._conv_digits(fq.to_digits(A), fq.to_digits(B))
    t = fm._replay_plain(t, sched.pre_ops, f8)
    if sched.has_out:
        if sched.n_pass:
            pd = fq.to_digits(a)
            pd = torch.cat([pd, pd.new_zeros(pd.shape[:-1] + (t.shape[-1] - 51,))], dim=-1)
            t = torch.cat([t, pd], dim=-2)
        t = (Mout[None, :, :, None] * t[:, None]).sum(dim=2) + oconst
        t = fm._replay_plain(t, sched.post_ops, f8)
    t = torch.cat([t, t.new_zeros(t.shape[:-1] + (50 - t.shape[-1],))], dim=-1)
    return t[..., 0::2] + (t[..., 1::2] << 8)


@pytest.mark.parametrize("name,get,bound,out_bound", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plain_plan_equals_composition(name, get, bound, out_bound):
    """The plan kernel's plain version is the lanes-in composition
    (plans.apply_tables and the constant pool in torch, then plain_fused),
    and it equals what the kernel computes from its ENCODED tables (decoded
    and applied here in torch): raw limbs, random inputs plus a row at the
    input bound's maxima. (execute_plan, which runs plain_plan on the CPU,
    is held to the reference's interpret-mode kernel by
    test_execute_plan_raw_parity.)"""
    plan, _ = get()
    sched = fm.prepare_plan(plan, plan.n_a, bound, bound, name, out_bound).sched
    a = _canon_rand((4, plan.n_a, 25))
    b = _canon_rand((4, plan.n_b, 25))
    a[0, :] = edge_limbs(bound.limb, bound.value_p * P - 1, bound.top)
    b[0, :] = edge_limbs(bound.limb, bound.value_p * P - 1, bound.top)
    a, b = convert.to_torch(a, "cpu"), convert.to_torch(b, "cpu")
    A = plans.apply_tables(sched.lin_a, a)
    B = plans.apply_tables(sched.lin_b, plans.append_const_pool(plan, b))
    want = fm.plain_fused(sched, A, B, a if sched.n_pass else None)
    got = fm.plain_plan(sched, a, b)
    assert torch.equal(got, want)
    assert torch.equal(_kernel_emulation(sched, a, b), got)


@pytest.mark.parametrize(
    "name,get,bound,out_bound",
    PLAN_CASES + [("K1", None, None, None), ("K2", None, None, None)],
    ids=[c[0] for c in PLAN_CASES] + ["K1", "K2"],
)
def test_kernel_tables_round_trip(name, get, bound, out_bound):
    """The int32/int64 tables the kernel reads decode back to the schedule's
    lincomb matrices (m_pos - m_neg), borrow constants, constant pool,
    output map (mpos - mneg) and digit borrow constants; the ops replay the
    schedule; every cluster size fits the shared-memory limit."""
    if get is None:
        sched = fm.mul_schedule(name == "K2")
        plan = None
    else:
        plan, _ = get()
        sched = fm.prepare_plan(plan, plan.n_a, bound, bound, name, out_bound).sched
    Ma, ca, Mb, cb, pool, Mout, oconst = _decode(sched)
    assert (Ma == sched.lin_a[0] - sched.lin_a[1]).all() and (ca == sched.lin_a[2]).all()
    assert (Mb == sched.lin_b[0] - sched.lin_b[1]).all() and (cb == sched.lin_b[2]).all()
    assert [fq.limbs_to_int(r) for r in pool] == (
        [c % P for c in plan.consts] if plan is not None else []
    )
    if sched.has_out:
        assert (Mout == sched.mpos - sched.mneg).all()
        assert (oconst == sched.oconst).all()
    ops = sched.ints[: len(sched.pre_ops) + len(sched.post_ops)].tolist()
    assert ops == fm._encode(sched.pre_ops) + fm._encode(sched.post_ops)
    assert sched.wmax <= fm._W_MAX
    for C in (1, 2, 4, 8):
        assert sched.smem_bytes(C) <= fm.SMEM_LIMIT and 32 <= sched.threads(C) <= 256


def test_execute_plan_broadcast_and_views():
    """Broadcast batch dims and strided views reach the plan kernel's
    wrapper as [rows, n, 25] views (no lincomb in torch): the result equals
    the same plan on explicitly expanded contiguous operands."""
    a = convert.to_torch(_canon_rand((1, 12, 25)), "cpu")
    b = convert.to_torch(_canon_rand((3, 2, 12, 25)), "cpu")
    got = fm.execute_plan(plans.MUL12, a, b, plans.PUB_BOUND, plans.PUB_BOUND, "fq12_mul")
    want = fm.execute_plan(
        plans.MUL12, a.expand(3, 2, 12, 25).contiguous(), b, plans.PUB_BOUND, plans.PUB_BOUND,
        "fq12_mul",
    )
    assert got.shape == (3, 2, 12, 25) and torch.equal(got, want)
    wide = convert.to_torch(_canon_rand((4, 8, 25)), "cpu")
    x, y = wide[:, 0:2], wide[:, 4:6]  # element-axis slices: strided rows
    got = fm.execute_plan(plans.MUL2, x, y, plans.PUB_BOUND, plans.PUB_BOUND, "fq2_mul")
    want = fm.execute_plan(
        plans.MUL2, x.contiguous(), y.contiguous(), plans.PUB_BOUND, plans.PUB_BOUND, "fq2_mul"
    )
    assert torch.equal(got, want)
    assert fm._rows(x, (4,), 2).data_ptr() == x.data_ptr()


def test_cluster_size_rule():
    """Rows x lanes against the 132 SMs, at least 4 lanes per CTA: rows 1
    spread a 54-lane MUL12 over 8 CTAs and an 18-lane CYC_SQR over 4; 64 rows
    of 18 lanes take 2; rows that fill the card, and plans of fewer than 8
    lanes, take 1."""
    assert fm.cluster_size(1, 54) == 8 and fm.cluster_size(1, 18) == 4
    assert fm.cluster_size(64, 18) == 2 and fm.cluster_size(65, 10) == 2
    assert fm.cluster_size(1, 6) == 1 and fm.cluster_size(1, 3) == 1
    assert fm.cluster_size(128, 54) == 1 and fm.cluster_size(1, 1) == 1


def test_ctypes_mirrors_match_the_cuda_structs():
    """The ctypes descriptors have the C layout of csrc/fused_mul.cu's
    PlanDesc (2 pointers, 17 ints, padded to 8 bytes: 88) and ChainArgs
    (2 PlanDesc, 2 pointers, 8 ints: 224); the library checks the same
    sizes when it loads."""
    import ctypes

    assert ctypes.sizeof(fm._PlanDesc) == 88
    assert ctypes.sizeof(fm._ChainArgs) == 224


# --------------------------------------------------------------------------------------
# Every plan signature the verify path runs: schedules equal the reference's
# --------------------------------------------------------------------------------------


def _reference_plan(plan):
    """The reference plan object that a port plan was copied from."""
    for mod, rmod in ((plans, r_plans), (pairing, r_pairing)):
        for k, v in vars(mod).items():
            if v is plan and isinstance(getattr(rmod, k, None), r_plans.Plan):
                return getattr(rmod, k)
    for k in (1, 2):
        for i in (0, 1):
            if curve._ADD_PLANS.get(k, (None, None))[i] is plan:
                return r_curve._add_plans(k)[i]
            if curve._DBL_PLANS.get(k, (None, None))[i] is plan:
                return r_curve._dbl_plans(k)[i]
    for k, v in tower._MUL2_MANY.items():
        if v is plan:
            return r_tower._mul2_many_plan(k)
    raise KeyError("plan has no reference counterpart")


def _path_signatures():
    """Run the port's whole verify path once on the CPU (tiny fixture) and
    return every execute_plan signature it prepared."""
    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc

    sks = [11, 12, 13]
    pks = [cs.sk_to_pk(s) for s in sks]
    cache = pubkey_cache.device_pubkeys_from_limbs(
        np.stack([fq.int_to_limbs(p[0]) for p in pks]),
        np.stack([fq.int_to_limbs(p[1]) for p in pks]),
        device="cpu",
    )
    msg = b"\x42" * 32
    sig = cs.sign(sks[0] + sks[1], msg)
    assert backend.verify_indexed_sets_device(
        cache, [([0, 1], msg, oc.g2_compress(sig))], device="cpu"
    )
    return list(fm._PLAN_CACHE.values())


def test_every_path_schedule_equals_reference(monkeypatch):
    """For each plan signature on the verify path (its bounds, out bound and
    pass-through width), the kernel schedule, output map and input lincomb
    tables equal what the reference derives for the same signature."""
    preps = _path_signatures()
    assert len(preps) >= 20
    seen = []
    monkeypatch.setattr(
        r_pk, "_run_fused",
        lambda A, B, pre, key, post, Ain=None: seen.append((tuple(pre), key, tuple(post)))
        or jnp.zeros((A.shape[0], r_pk._OUT_TABLE[key][0], 50), jnp.float32),
    )
    for prep in preps:
        key = next(k for k, v in fm._PLAN_CACHE.items() if v is prep)
        _, n_a, ba, bb, name, ob = key
        rplan = _reference_plan(prep.plan)
        mk = lambda t: None if t is None else r_plans._Bound(*t)  # noqa: E731
        a = jnp.zeros((1, n_a, 25), jnp.uint64)
        b = jnp.zeros((1, rplan.n_b, 25), jnp.uint64)
        seen.clear()
        r_pk.execute_plan(rplan, a, b, mk(ba), mk(bb), name, mk(ob))
        (pre, out_key, post), = seen
        s = prep.sched
        assert (s.pre_ops, s.post_ops) == (pre, post), name
        R, mpos, mneg, oconst, n_pass, _ = r_pk._OUT_TABLE[out_key]
        assert (s.R, s.n_pass) == (R, n_pass), name
        assert (s.mpos == mpos).all() and (s.mneg == mneg).all(), name
        assert (s.oconst == oconst).all(), name
        # input lincomb tables: the reference's matrices and borrow constants
        for rows, n_in, bound, tables in (
            (rplan.a_rows, n_a, mk(ba), prep.lin_a),
            (rplan.b_rows, rplan.n_b + len(rplan.consts), mk(bb), prep.lin_b),
        ):
            consts, _ = r_plans._lincomb_bounds(rows, lambda _i, b=bound: b, name)
            m_pos, m_neg = r_plans._lincomb_matrices(rows, n_in)
            assert (tables[0] == m_pos).all() and (tables[1] == m_neg).all(), name
            assert (tables[2] == consts).all(), name


# --------------------------------------------------------------------------------------
# Copies pinned to the reference
# --------------------------------------------------------------------------------------


def _lc_rows(rows):
    return [sorted(lc.d.items()) for lc in rows]


@pytest.mark.parametrize(
    "port,ref",
    [
        (lambda: plans.MUL2, lambda: r_plans.MUL2),
        (lambda: plans.MUL6, lambda: r_plans.MUL6),
        (lambda: plans.MUL12, lambda: r_plans.MUL12),
        (lambda: plans.SQR2, lambda: r_plans.SQR2),
        (lambda: plans.SQR12, lambda: r_plans.SQR12),
        (lambda: plans.CYC_SQR, lambda: r_plans.CYC_SQR),
        (lambda: plans.FROB12, lambda: r_plans.FROB12),
        (lambda: pairing.MUL_BY_014, lambda: r_pairing.MUL_BY_014),
        (lambda: pairing.MUL_BY_01245, lambda: r_pairing.MUL_BY_01245),
        (lambda: pairing.SP_SP, lambda: r_pairing.SP_SP),
        (lambda: pairing.SCALE_LINE, lambda: r_pairing.SCALE_LINE),
        (lambda: pairing.DBL1, lambda: r_pairing.DBL1),
        (lambda: pairing.DBL2, lambda: r_pairing.DBL2),
        (lambda: curve._add_plans(1)[0], lambda: r_curve._add_plans(1)[0]),
        (lambda: curve._add_plans(2)[1], lambda: r_curve._add_plans(2)[1]),
        (lambda: curve._dbl_plans(2)[0], lambda: r_curve._dbl_plans(2)[0]),
        (lambda: curve._dbl_plans(1)[1], lambda: r_curve._dbl_plans(1)[1]),
        (lambda: tower._mul2_many_plan(6), lambda: r_tower._mul2_many_plan(6)),
    ],
)
def test_plan_builders_equal_reference(port, ref):
    p, r = port(), ref()
    assert (p.n_a, p.n_b, p.consts) == (r.n_a, r.n_b, r.consts)
    assert _lc_rows(p.a_rows) == _lc_rows(r.a_rows)
    assert _lc_rows(p.b_rows) == _lc_rows(r.b_rows)
    assert _lc_rows(p.out_rows) == _lc_rows(r.out_rows)


@pytest.mark.parametrize(
    "scalars,signed",
    [
        ((P - 2,), False),
        (((P + 1) // 4,), False),
        ((tower._SQRT_E0, tower._SQRT_E1), False),
        ((of.BLS_X,), True),
        ((-of.BLS_X,), True),
        ((12345, 0, 7), True),
    ],
)
def test_chain_schedules_equal_reference(scalars, signed):
    s = chain_plans.compile_chains(scalars, signed=signed)
    r = r_chain.compile_chains(scalars, signed=signed)
    assert (s.segments, s.n_chains, s.table_max, s.signed, s.negate) == (
        r.segments, r.n_chains, r.table_max, r.signed, r.negate
    )
    assert chain_plans.wnaf_digits(abs(scalars[0]), 5) == r_chain.wnaf_digits(abs(scalars[0]), 5)
    assert curve.fixed_schedule(-of.BLS_X) == r_curve.fixed_schedule(-r_of.BLS_X)


def test_constants_equal_reference():
    """Copied tables: fold rows, borrow constants, sqrt roots of unity and
    correction constants, and the bound constants."""
    assert (fm._FOLD8_NP == r_pk._FOLD8_NP.astype(np.int64)).all()
    assert (fq._FOLD_NP == r_fq._FOLD_NP.astype(np.int64)).all()
    assert (fq.SUBPUB == np.asarray(r_fq.SUBPUB).astype(np.int64)).all()
    for cover in ((1 << 17) - 1, 2), ((1 << 18) - 1, 6), (4 * ((1 << 17) - 1), 8):
        assert (plans._subc(*cover)[0] == r_plans._subc(*cover)[0].astype(np.int64)).all()
        assert plans._subc(*cover)[1] == r_plans._subc(*cover)[1]
    assert (fm._dsubc_wide(104, 5000) == r_pk._dsubc_wide(104, 5000).astype(np.int64)).all()
    assert (tower._ROOTS8 == np.asarray(r_tower._ROOTS8).astype(np.int64)).all()
    assert (tower._SQRT_CF == np.asarray(r_tower._SQRT_CF).astype(np.int64)).all()
    for nm in ("PUB_BOUND", "CHAIN_BOUND", "F12_BOUND", "CANON_BOUND"):
        a, b = getattr(plans, nm), getattr(r_plans, nm)
        assert (a.value_p, a.limb, a.top) == (b.value_p, b.limb, b.top)


def test_oracle_copy_equals_reference():
    """The port's oracle copy computes what the reference oracle computes."""
    assert (of.P, of.R, of.BLS_X) == (r_of.P, r_of.R, r_of.BLS_X)
    msg = b"oracle copy"
    dst = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
    assert oh.expand_message_xmd(msg, dst, 96) == r_oh.expand_message_xmd(msg, dst, 96)
    u = oh.hash_to_field_fq2(msg, dst, 2)
    ru = r_oh.hash_to_field_fq2(msg, dst, 2)
    assert [(x.c0, x.c1) for x in u] == [(x.c0, x.c1) for x in ru]
    a = of.Fq12(
        of.Fq6(of.Fq2(3, 4), of.Fq2(5, 6), of.Fq2(7, 8)),
        of.Fq6(of.Fq2(9, 10), of.Fq2(11, 12), of.Fq2(13, 14)),
    )
    ra = r_of.Fq12(
        r_of.Fq6(r_of.Fq2(3, 4), r_of.Fq2(5, 6), r_of.Fq2(7, 8)),
        r_of.Fq6(r_of.Fq2(9, 10), r_of.Fq2(11, 12), r_of.Fq2(13, 14)),
    )
    x, y = a.frobenius(1) * a.inv(), ra.frobenius(1) * ra.inv()
    assert repr(x) == repr(y)


def _signatures_of_some_plans():
    """Run a few tower and curve ops on the CPU (several plans, two bound
    signatures for some names) and return their prepare_plan arguments."""
    gen = torch.Generator().manual_seed(31)
    el = lambda n: torch.randint(0, 1 << 16, (2, n, 25), generator=gen) & (  # noqa: E731
        torch.tensor([0xFFFF] * 23 + [0x0FFF, 0])
    )
    a2, b2, a12, b12 = el(2), el(2), el(12), el(12)
    tower.fq2_mul(a2, b2)
    tower.fq2_mul(a2, b2, in_bound=plans.CANON_BOUND)
    tower.fq2_sqr(a2)
    tower.fq12_mul(a12, b12)
    tower.fq12_sqr(a12)
    curve.point_add(1, el(3), el(3))
    out = []
    for key, prep in fm._PLAN_CACHE.items():
        _, n_a, ba, bb, name, ob = key
        mk = lambda t: None if t is None else plans._Bound(*t)  # noqa: E731
        out.append((prep.plan, n_a, mk(ba), mk(bb), name, mk(ob)))
    return out


def test_plan_cache_and_counts_are_thread_safe():
    """Eight threads preparing the same plan signatures at once (switch
    interval shortened) get the labels one thread gets, one prepared plan
    per signature, and counters that lose no update."""
    import sys
    import threading

    saved_cache, saved_sched = dict(fm._PLAN_CACHE), dict(fm.SCHEDULES)
    old_switch = sys.getswitchinterval()
    try:
        fm._PLAN_CACHE.clear()
        sigs = _signatures_of_some_plans()
        assert len(sigs) >= 6
        names = [s[4] for s in sigs]

        def labels():
            return {k: p.sched.label for k, p in fm._PLAN_CACHE.items()}

        fm._PLAN_CACHE.clear()
        for label in [lb for lb in fm.SCHEDULES if lb.split("#")[0] in names]:
            del fm.SCHEDULES[label]
        one_thread = [fm.prepare_plan(*s) for s in sigs]
        want = labels()
        assert len(set(want.values())) == len(sigs)

        fm._PLAN_CACHE.clear()
        for label in want.values():
            del fm.SCHEDULES[label]
        sys.setswitchinterval(1e-6)
        n_threads, reps = 8, 400
        start = threading.Barrier(n_threads)
        got = [None] * n_threads
        fm.reset_counts()
        sched = one_thread[0].sched
        x = torch.zeros((1, sched.n_a, 25), dtype=torch.int64)
        y = torch.zeros((1, sched.n_b, 25), dtype=torch.int64)

        def work(t):
            start.wait(timeout=30)
            got[t] = [fm.prepare_plan(*s) for s in sigs]
            for _ in range(reps):
                fm._count("K3", "thread_test", 1)
            for _ in range(3):
                fm.run_fused(got[t][0].sched, x, y)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert labels() == want
        assert all(all(p is q for p, q in zip(g, got[0])) for g in got)
        assert len({lb for lb in fm.SCHEDULES if lb.split("#")[0] in names}) == len(sigs)
        assert fm.launches_by["K3"] == fm.launches == n_threads * reps
        assert fm.launch_log[("K3", "thread_test", 1)] == n_threads * reps
        assert fm.plain_calls == n_threads * 3
    finally:
        sys.setswitchinterval(old_switch)
        fm.reset_counts()
        fm._PLAN_CACHE.clear()
        fm._PLAN_CACHE.update(saved_cache)
        fm.SCHEDULES.clear()
        fm.SCHEDULES.update(saved_sched)
