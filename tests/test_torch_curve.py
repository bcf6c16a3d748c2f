"""Curve ops of the port against the reference and the oracle.

G1/G2 complete add/double, the fused RLC + subgroup-chain ladder
``scale_u64_with_fixed`` with 64-bit scalars at and above 2^63 (negative as
int64 — the port reads windows by mask), masked aggregation, affine
conversion and G2 decompression, compared as canonical values against the
reference JAX functions (``digits`` conv backend) and the oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.ops.bls import curve as r_curve, fq as r_fq, g2 as r_g2

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.bls import backend
from lighthouse_tpu_torch.ops.bls import curve, fq, g1, g2
from lighthouse_tpu_torch.oracle import curves as oc
from lighthouse_tpu_torch.oracle.fields import BLS_X, P, Fq2

nprng = np.random.default_rng(0xC0DE)


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
    out = jax.jit(lambda *a: fn(*a))(*[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def _canon(x):
    x = np.asarray(x).reshape(-1, 25)
    return [fq.limbs_to_int(r) % P for r in x]


def _g1_points(n):
    return [oc.g1_mul(oc.g1_generator(), int(nprng.integers(1, 1 << 62))) for _ in range(n)]


def _g2_points(n):
    return [oc.g2_mul(oc.g2_generator(), int(nprng.integers(1, 1 << 62))) for _ in range(n)]


def _np(pts, k):
    mod = g1 if k == 1 else g2
    return convert.to_numpy(mod.from_oracle_batch(pts, "cpu"))


def _affine_eq(k, proj, ref_proj):
    """Projective points equal as affine points (port tensor vs reference
    numpy array), through the port's to_affine on both."""
    a = curve.to_affine(k, proj)
    b = curve.to_affine(k, convert.to_torch(ref_proj, "cpu"))
    return all(_canon(convert.to_numpy(x)) == _canon(convert.to_numpy(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("k", [1, 2])
def test_add_dbl(k):
    pts = _g1_points(3) if k == 1 else _g2_points(3)
    qs = _g1_points(3) if k == 1 else _g2_points(3)
    qs[2] = pts[2]  # doubling through the complete add
    p, q = _np(pts, k), _np(qs, k)
    add = curve.point_add(k, convert.to_torch(p, "cpu"), convert.to_torch(q, "cpu"))
    dbl = curve.point_dbl(k, convert.to_torch(p, "cpu"))
    assert _affine_eq(k, add, _ref(lambda x, y: r_curve.point_add(k, x, y), p, q))
    assert _affine_eq(k, dbl, _ref(lambda x: r_curve.point_dbl(k, x), p))
    mod = g1 if k == 1 else g2
    add_o = oc.g1_add if k == 1 else oc.g2_add
    for i in range(3):
        assert mod.to_oracle(add[i]) == add_o(pts[i], qs[i])
        assert mod.to_oracle(dbl[i]) == add_o(pts[i], pts[i])


def test_scale_u64_with_fixed_high_scalars():
    """[r]Q and [|x|]Q from one ladder, with r >= 2^63 (negative as int64),
    r = 2^64 - 1 and r = 1: equal to the reference (uint64 scalars) and to
    the oracle."""
    pts = _g2_points(3)
    p = _np(pts, 2)
    scalars = np.array([(1 << 64) - 1, (1 << 63) + 12345, 1], dtype=np.uint64)
    got = curve.scale_u64_with_fixed(
        2, convert.to_torch(p, "cpu"), backend.scalars_to_torch(scalars, "cpu"), (-BLS_X,)
    )
    want = _ref(lambda x, s: r_curve.scale_u64_with_fixed(2, x, s, (-BLS_X,)), p, scalars)
    assert _affine_eq(2, got.reshape(-1, 6, 25), want.reshape(-1, 6, 25))
    for i in range(3):
        assert g2.to_oracle(got[0, i]) == oc.g2_mul(pts[i], int(scalars[i]))
        assert g2.to_oracle(got[1, i]) == oc.g2_mul(pts[i], -BLS_X)


def test_g1_scale_u64_high_scalar():
    pts = _g1_points(2)
    scalars = np.array([(1 << 63) | 0xDEADBEEF, 7], dtype=np.uint64)
    got = g1.scale_u64(g1.from_oracle_batch(pts, "cpu"), backend.scalars_to_torch(scalars, "cpu"))
    for i in range(2):
        assert g1.to_oracle(got[i]) == oc.g1_mul(pts[i], int(scalars[i]))


def test_masked_point_sum_and_to_affine():
    """Masked halving-tree sums (an odd count, a fully masked column) and
    affine conversion (infinity -> (0, 0)), against the reference."""
    pts = _g1_points(6)
    p = _np(pts, 1).reshape(3, 2, 3, 25)
    mask = np.array([[True, False], [True, False], [False, False]])
    got = curve.point_sum(1, convert.to_torch(p, "cpu"), convert.to_torch(mask, "cpu"))
    want = _ref(lambda x, m: r_curve.point_sum(1, x, m), p, mask)
    assert _affine_eq(1, got, want)
    assert g1.to_oracle(got[0]) == oc.g1_add(pts[0], pts[2])
    assert g1.to_oracle(got[1]) is None
    ax, ay = g1.to_affine(got)
    rx, ry = _ref(lambda x: r_curve.to_affine(1, x), want)
    assert _canon(convert.to_numpy(ax)) == _canon(rx)
    assert _canon(convert.to_numpy(ay)) == _canon(ry)
    assert _canon(convert.to_numpy(ax[1])) == [0]


def _x_limbs(xs):
    return np.array(
        [[fq.int_to_limbs(x.c0), fq.int_to_limbs(x.c1)] for x in xs], dtype=np.uint64
    )


def test_g2_decompress():
    """Valid encodings of both signs, an x with no y (non-residue) and the
    zero x of an infinity encoding: (point, ok) equal the reference's."""
    pts = _g2_points(2)
    xs = [pts[0][0], pts[1][0]]
    bad = Fq2(1, 0)
    while (bad.square() * bad + oc.B2).sqrt() is not None:
        bad = bad + Fq2(1, 0)
    xs += [bad, Fq2(0, 0)]
    flags = []
    for pt in pts:
        enc = oc.g2_compress(pt)
        flags.append((enc[0] >> 5) & 1)
    flags += [0, 0]
    x = _x_limbs(xs)
    s = np.array(flags, dtype=np.uint64)
    gp, gok = g2.decompress(convert.to_torch(x, "cpu"), convert.to_torch(s, "cpu"))
    rp, rok = _ref(lambda a, f: r_g2.decompress(a, f), x, s)
    assert (gok.numpy() == rok).all()
    assert gok.tolist() == [True, True, False, (Fq2(4, 4)).sqrt() is not None]
    for i in range(2):
        assert g2.to_oracle(gp[i]) == pts[i]
    ok_rows = [i for i in range(4) if rok[i]]
    assert _affine_eq(2, gp[ok_rows], rp[ok_rows])


def test_constants_need_a_device_and_batch_conversions_match():
    """``tower.one`` and ``curve.inf_point`` take no default device (a
    forgotten one must not become the CPU); the one-upload
    ``from_oracle_batch`` equals stacking ``from_oracle``, infinity
    included, and the reference's conversion."""
    from lighthouse_tpu.ops.bls import g1 as r_g1

    from lighthouse_tpu_torch.ops.bls import tower

    with pytest.raises(TypeError):
        tower.one(2)
    with pytest.raises(TypeError):
        curve.inf_point(1)
    assert tower.one(2, (3,), "cpu").shape == (3, 2, 25)
    assert curve.inf_point(2, (), "cpu").shape == (6, 25)
    p1 = [oc.g1_mul(oc.g1_generator(), k) for k in (3, 1 << 200)] + [None]
    p2 = [oc.g2_mul(oc.g2_generator(), k) for k in (5, 1 << 199)] + [None]
    for mod, pts in ((g1, p1), (g2, p2)):
        got = mod.from_oracle_batch(pts, "cpu")
        assert torch.equal(got, torch.stack([mod.from_oracle(p, "cpu") for p in pts]))
    assert (convert.to_numpy(g1.from_oracle_batch(p1, "cpu")) == np.asarray(r_g1.from_oracle_batch(p1))).all()
