"""Field and tower ops of the port against the reference (canonical values).

The same inputs, made from a seed, go through the reference JAX function
(the ``digits`` conv backend, which computes the same values as the Pallas
arm without interpret-mode cost) and through the port's counterpart on the
CPU (the fused kernel's plain version). Every comparison is exact equality of
canonical residues.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.ops.bls import fq as r_fq, tower as r_tower

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops.bls import fq, plans, tower
from lighthouse_tpu_torch.oracle import fields as of

P = of.P
rng = random.Random(0xF1E1D)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tests run at small shapes: one intra-op thread keeps torch
    from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def digits_backend():
    old = r_fq._CONV_IMPL
    r_fq._CONV_IMPL = "digits"
    yield
    r_fq._CONV_IMPL = old


def _ref(fn, *args):
    """Run a reference function (fresh jit) on numpy uint64 inputs."""
    out = jax.jit(lambda *a: fn(*a))(*[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def _port(fn, *args):
    return fn(*[convert.to_torch(a, "cpu") for a in args])


def _canon_np(x):
    """uint64 limbs (any lazy value) -> canonical ints, flattened."""
    x = np.asarray(x).reshape(-1, 25)
    return [fq.limbs_to_int(r) % P for r in x]


def _limbs(vals, shape=None):
    a = np.array([fq.int_to_limbs(v % P) for v in vals], dtype=np.uint64)
    return a if shape is None else a.reshape(shape + (25,))


def test_canonical_lazy_budget_inputs():
    """canonical() of lazy inputs (limbs < 2^22, value < 1200p) equals the
    reference's, limb for limb (the canonical residue is unique)."""
    nprng = np.random.default_rng(5)
    raw = nprng.integers(0, 1 << 22, size=(12, 25), dtype=np.uint64)
    raw[:, 23] &= 0xFFFF
    raw[:, 24] &= 0x3F
    raw[0] = 0
    raw[1, :] = 0
    raw[1, :24] = [int(v) for v in fq.int_to_limbs(P)[:24]]  # exactly p
    want = _ref(r_fq.canonical, raw)
    got = convert.to_numpy(_port(fq.canonical, raw))
    assert (got == want).all()
    assert [fq.limbs_to_int(r) for r in got] == [fq.limbs_to_int(r) % P for r in raw]


def test_inv_and_sqrt_candidate():
    xs = [rng.randrange(P) for _ in range(4)] + [0, 1, P - 1]
    a = _limbs(xs)
    got = _port(fq.inv, a)
    assert _canon_np(convert.to_numpy(got)) == _canon_np(_ref(r_fq.inv, a))
    assert fq.to_ints(got) == [pow(x, P - 2, P) for x in xs]  # inv(0) = 0
    got = _port(fq.sqrt_candidate, a)
    assert _canon_np(convert.to_numpy(got)) == _canon_np(_ref(r_fq.sqrt_candidate, a))


def test_sgn0_and_lex_gt_half():
    xs = [rng.randrange(P) for _ in range(4)] + [0, 1, P - 1, (P - 1) // 2, (P + 1) // 2]
    a = _limbs(xs)
    assert (convert.to_numpy(_port(fq.sgn0, a)) == _ref(r_fq.sgn0, a)).all()
    assert (_port(fq.lex_gt_half, a).numpy() == _ref(r_fq.lex_gt_half, a)).all()


def test_fq2_sqrt_ratio():
    """sqrt_ratio on residues, non-residues and zero: the flag and the root
    equal the reference's."""
    us = [of.Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(3)] + [of.Fq2(0, 0)]
    vs = [of.Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(3)] + [of.Fq2(5, 7)]
    u = _limbs([c for x in us for c in (x.c0, x.c1)], (4, 2))
    v = _limbs([c for x in vs for c in (x.c0, x.c1)], (4, 2))
    rq, ry = _ref(r_tower.fq2_sqrt_ratio, u, v)
    gq, gy = _port(tower.fq2_sqrt_ratio, u, v)
    assert (gq.numpy() == rq).all()
    assert _canon_np(convert.to_numpy(gy)) == _canon_np(ry)
    assert not rq.all() and rq.any()  # both branches exercised


def _rfq12():
    def f2():
        return of.Fq2(rng.randrange(P), rng.randrange(P))

    return of.Fq12(of.Fq6(f2(), f2(), f2()), of.Fq6(f2(), f2(), f2()))


def _fq12_np(xs):
    return np.stack([convert.to_numpy(tower.fq12_from_oracle(x, "cpu")) for x in xs])


FQ12_OPS = [
    ("mul", lambda a, b: tower.fq12_mul(a, b), lambda a, b: r_tower.fq12_mul(a, b)),
    ("sqr", lambda a, b: tower.fq12_sqr(a), lambda a, b: r_tower.fq12_sqr(a)),
    ("frobenius1", lambda a, b: tower.fq12_frobenius1(a), lambda a, b: r_tower.fq12_frobenius1(a)),
    ("conj", lambda a, b: tower.fq12_conj(a), lambda a, b: r_tower.fq12_conj(a)),
    ("inv", lambda a, b: tower.fq12_inv(a), lambda a, b: r_tower.fq12_inv(a)),
    (
        "mul_lazy",
        lambda a, b: tower.fq12_mul(tower.fq12_mul_lazy(a, b), a),
        lambda a, b: r_tower.fq12_mul(r_tower.fq12_mul_lazy(a, b), a),
    ),
]


@pytest.mark.parametrize("name,port,ref", FQ12_OPS, ids=[o[0] for o in FQ12_OPS])
def test_fq12_ops(name, port, ref):
    xs, ys = [_rfq12() for _ in range(2)], [_rfq12() for _ in range(2)]
    a, b = _fq12_np(xs), _fq12_np(ys)
    got = _port(port, a, b)
    assert _canon_np(convert.to_numpy(got)) == _canon_np(_ref(ref, a, b))


def test_fq12_cyclotomic_and_is_one():
    """Cyclotomic squaring (plain and lazy) on cyclotomic-subgroup members;
    fq12_is_one on one, on a cyclotomic member and on a random element."""
    gs = []
    for _ in range(2):
        a = _rfq12()
        g = a.conjugate() * a.inv()
        gs.append(g.frobenius(2) * g)
    g = _fq12_np(gs)
    got = _port(tower.fq12_cyclotomic_sqr, g)
    assert _canon_np(convert.to_numpy(got)) == _canon_np(_ref(r_tower.fq12_cyclotomic_sqr, g))
    assert tower.fq12_to_oracle(got[0]) == gs[0].cyclotomic_square()
    got = _port(lambda x: tower.fq12_cyclotomic_sqr(tower.fq12_cyclotomic_sqr_lazy(x)), g)
    want = _ref(lambda x: r_tower.fq12_cyclotomic_sqr(r_tower.fq12_cyclotomic_sqr_lazy(x)), g)
    assert _canon_np(convert.to_numpy(got)) == _canon_np(want)
    ones = np.stack([_fq12_np([of.Fq12.ONE])[0], g[0], _fq12_np([_rfq12()])[0]])
    assert (_port(tower.fq12_is_one, ones).numpy() == _ref(r_tower.fq12_is_one, ones)).all()
    assert _port(tower.fq12_is_one, ones).tolist() == [True, False, False]


def test_bound_failure_raises():
    """A bound obligation that fails raises instead of wrapping silently."""
    with pytest.raises(fq.BoundError):
        fq._cert("demo", 1 << 63, (1 << 63) - 1)
    with pytest.raises(fq.BoundError):
        plans.lincomb_tables([plans.LC({0: 1})], 1, plans._Bound(2000, 1, 1), "over")


def test_reduce_walk_stays_below_int64():
    """Every reduce_limbs schedule the path uses proves its folds below 2^63
    (the port's cap), recorded through the certification sink."""
    rows = []

    class Sink:
        def record(self, kind, proven, limit, note="", ok=True):
            rows.append((kind, proven, limit, ok))

    fq._reduce_plan.cache_clear()
    fq._CERT_SINK = Sink()
    try:
        x = fq.from_ints([rng.randrange(P) for _ in range(2)], "cpu")
        fq.canonical(x)
        fq.inv(x)
    finally:
        fq._CERT_SINK = None
    kinds = {r[0] for r in rows}
    assert {"fold384_acc_nowrap", "reduce_value", "reduce_limb"} <= kinds
    assert all(ok for *_, ok in rows)
    assert all(limit <= (1 << 63) - 1 for k, _, limit, _ in rows if k.endswith("nowrap"))
