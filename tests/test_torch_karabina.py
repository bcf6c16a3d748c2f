"""Karabina compressed cyclotomic squaring in the port, against the reference.

``lighthouse_tpu_torch.ops.bls.tower`` carries the reference's Karabina arm
(``lighthouse_tpu/ops/bls/tower.py:480-660``): ``KARABINA_SQR`` (a 14-lane
plan, 8 rows to 8), compress / decompress, and ``a^|x|`` through 63
compressed squarings, which the port runs as six chain-kernel launches (one
per run between set bits of |x|). Held here on the CPU through the
kernels' plain versions, with exact equality:

* the plan equals the reference's, lincomb for lincomb;
* compress, one compressed squaring (public and lazy bounds) and
  decompression give the reference's raw limbs (its Pallas kernel in
  interpret mode) on random cyclotomic elements and on one;
* the compressed |x| power gives the reference's raw limbs, and equals the
  port's direct arm and the oracle canonically;
* ``final_exponentiation(compressed=True)`` equals ``compressed=False``;
* a verify batch (valid and poisoned) gives the same verdicts with the
  switch on and off;
* the switch is an argument of ``bls.set_backend``: no environment
  variable turns it on.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.ops.bls import fq as r_fq, tower as r_tower

from lighthouse_tpu_torch import bls, convert
from lighthouse_tpu_torch.bls import backend, pubkey_cache
from lighthouse_tpu_torch.ops.bls import fused_mul as fm, pairing, tower
from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc, fields as of
from lighthouse_tpu_torch.oracle.pairing import final_exponentiation as oracle_final_exp

P = of.P
rng = random.Random(0x4A8B)
SKS = [(0xCAFE << 24) + 131 * i for i in range(4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def pallas_backend():
    """The reference's multiplies through its Pallas kernel (interpret mode
    on the CPU): the arm whose raw limbs the port's kernels reproduce."""
    old = r_fq._CONV_IMPL
    r_fq._CONV_IMPL = "pallas"
    yield
    r_fq._CONV_IMPL = old


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


@pytest.fixture(scope="module")
def elements():
    """Two random cyclotomic elements and one, as [3, 12, 25]."""
    gs = _cyclotomic(2) + [of.Fq12.ONE]
    return gs, torch.stack([tower.fq12_from_oracle(x, "cpu") for x in gs])


def _ref(fn, x):
    return np.asarray(jax.jit(fn)(jnp.asarray(convert.to_numpy(x))))


def _lcs(rows):
    return [dict(sorted(lc.d.items())) for lc in rows]


def test_karabina_plan_equals_reference():
    """The port's plan copies the reference's: same inputs, lanes and
    output lincombs (14 lanes, 8 rows to 8)."""
    mine, ref = tower.KARABINA_SQR, r_tower.KARABINA_SQR
    assert (mine.n_a, mine.n_b) == (ref.n_a, ref.n_b) == (8, 8)
    assert len(mine.a_rows) == len(ref.a_rows) == 14
    for side in ("a_rows", "b_rows", "out_rows"):
        assert _lcs(getattr(mine, side)) == _lcs(getattr(ref, side)), side
    assert len(mine.out_rows) == 8


@pytest.mark.parametrize("op", ["compress", "sqr", "sqr_lazy", "decompress"])
def test_karabina_ops_equal_reference_raw_limbs(elements, op):
    """Raw limbs equal on two random cyclotomic elements and on one."""
    _, g = elements
    c = tower.fq12_compress(g)
    mine, ref_fn, arg = {
        "compress": (c, r_tower.fq12_compress, g),
        "sqr": (tower.fq12_compressed_sqr(c), r_tower.fq12_compressed_sqr, c),
        "sqr_lazy": (tower.fq12_compressed_sqr_lazy(c), r_tower.fq12_compressed_sqr_lazy, c),
        "decompress": (tower.fq12_decompress(c), r_tower.fq12_decompress, c),
    }[op]
    assert (convert.to_numpy(mine) == _ref(ref_fn, arg)).all()
    if op == "decompress":
        assert torch.equal(tower.t_canon(mine), tower.t_canon(g))


def test_compressed_exp_equals_reference_and_direct_arm(elements):
    """a^|x| through Karabina: the reference's raw limbs; the port's direct
    (chain-program) arm and the oracle canonically."""
    gs, g = elements
    got = tower._cyc_exp_abs_x_compressed(g)
    assert torch.equal(got, tower.fq12_cyclotomic_exp_abs_x(g, compressed=True))
    assert (convert.to_numpy(got) == _ref(r_tower._cyc_exp_abs_x_compressed, g)).all()
    direct = tower.fq12_cyclotomic_exp_abs_x(g)
    assert torch.equal(tower.t_canon(got), tower.t_canon(direct))
    for i, x in enumerate(gs):
        assert tower.fq12_to_oracle(got[i]) == x.pow(-of.BLS_X)


def test_karabina_runs_are_chain_programs_of_the_step_loop(elements):
    """Each run's chain program equals the step loop of lazy compressed
    squarings it encodes, raw limbs; the runs cover the 63 squarings."""
    _, g = elements
    c = tower.fq12_compress(g)
    prev = 0
    for e in tower._ABS_X_BITS:
        prog = tower._karabina_run_program(e - prev)
        assert prog.n_mults == e - prev and prog.n_el == 8
        want = c
        for _ in range(e - prev):
            want = tower.fq12_compressed_sqr_lazy(want)
        c = fm.run_chain(prog, c[None])[0]
        assert torch.equal(c, want)
        prev = e
    assert prev == 63 and tower._ABS_X_BITS == r_tower._ABS_X_BITS


def test_final_exponentiation_compressed_equals_direct():
    """Both arms of the final exponentiation agree canonically, and with the
    oracle's, on a random (non-cyclotomic) element."""
    x = _rfq12()
    f = tower.fq12_from_oracle(x, "cpu")[None]
    direct = pairing.final_exponentiation(f)
    kar = pairing.final_exponentiation(f, compressed=True)
    assert torch.equal(tower.t_canon(direct), tower.t_canon(kar))
    assert tower.fq12_to_oracle(kar[0]) == oracle_final_exp(x)


@pytest.fixture(scope="module")
def cache_and_items():
    pks = [cs.sk_to_pk(s) for s in SKS]
    raw = np.array(
        [list(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")) for p in pks],
        dtype=np.uint8,
    )
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device="cpu")

    def one_set(indices, msg, signed=None):
        sk = sum(SKS[i] for i in indices) % of.R
        return (indices, msg, oc.g2_compress(cs.sign(sk, signed or msg)))

    valid = [one_set([0, 1], b"\x11" * 32), one_set([2, 3], b"\x22" * 32)]
    poisoned = [valid[0], one_set([2, 3], b"\x22" * 32, signed=b"\x23" * 32)]
    return cache, valid, poisoned


@pytest.mark.parametrize("karabina", [False, True], ids=["direct", "karabina"])
def test_verify_batch_verdicts_with_the_switch(cache_and_items, karabina):
    """The device backend's verdicts (plain versions on the CPU) hold with
    the switch on and off: the valid batch True, the poisoned one False."""
    cache, valid, poisoned = cache_and_items
    saved = (bls.get_backend(), bls.get_device(), bls.get_karabina())
    bls.set_backend("device", device="cpu", karabina=karabina)
    try:
        assert bls.get_karabina() is karabina
        assert backend.verify_indexed_sets_device(cache, valid, device="cpu") is True
        assert backend.verify_indexed_sets_device(cache, poisoned, device="cpu") is False
    finally:
        bls.set_backend(saved[0], device=saved[1], karabina=saved[2])


def test_switch_is_an_argument_not_an_environment_variable(monkeypatch, elements):
    """LIGHTHOUSE_PAIRING_KARABINA=1 in the environment turns nothing on:
    ``set_backend`` leaves the switch off, and the |x| power takes the
    direct arm unless asked. A call without ``karabina=`` keeps the switch
    as an earlier call set it."""
    _, g = elements
    monkeypatch.setenv("LIGHTHOUSE_PAIRING_KARABINA", "1")
    saved = (bls.get_backend(), bls.get_device(), bls.get_karabina())
    try:
        bls.set_backend("device", device="cpu", karabina=False)
        bls.set_backend("device", device="cpu")
        assert bls.get_karabina() is False
        calls = []
        monkeypatch.setattr(tower, "_cyc_exp_abs_x_compressed",
                            lambda a: calls.append(a) or a)
        tower.fq12_cyclotomic_exp_abs_x(g[:1])
        assert calls == []
        tower.fq12_cyclotomic_exp_abs_x(g[:1], compressed=True)
        assert len(calls) == 1
        bls.set_backend("device", device="cpu", karabina=True)
        assert bls.get_karabina() is True
        bls.set_backend("native")
        assert bls.get_karabina() is True
        bls.set_backend("device", device="cpu", karabina=False)
        assert bls.get_karabina() is False
    finally:
        bls.set_backend(saved[0], device=saved[1], karabina=saved[2])
