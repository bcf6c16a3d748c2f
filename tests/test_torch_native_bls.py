"""The port's native C++ BLS backend against the reference's and the oracle.

``lighthouse_tpu_torch/native`` is the port's copy of ``lighthouse_tpu/native``:
the same ``bls12_381.cpp`` built with g++ into ``lighthouse_tpu_torch/_build/``,
the same ctypes surface (``load_bls``, ``NativeBls``). Every wire-format output
is byte-equal to the reference build's and to the port's pure-Python oracle;
verdicts agree on valid, tampered, infinity and non-subgroup inputs, on
aggregate and batch verification and on the raw (pre-decompressed) key path.
The ``bls`` seam selects it as ``set_backend("native")``.
"""

import hashlib
import os

import pytest

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu.native.build import NativeBls as RNative
from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.native import NativeBls as PNative
from lighthouse_tpu_torch.native import build as pbuild
from lighthouse_tpu_torch.oracle import ciphersuite as cs
from lighthouse_tpu_torch.oracle import curves as oc

MSG = b"\x42" * 32
PORT_ROOT = os.path.dirname(os.path.abspath(native.__file__))


@pytest.fixture(scope="module")
def nbs():
    return PNative(), RNative()


@pytest.fixture
def native_backend():
    saved = bls.get_backend(), bls.get_device()
    bls.set_backend("native")
    yield
    bls.set_backend(saved[0], device=saved[1])


def test_build_lives_in_the_port(nbs):
    path = pbuild.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(os.path.dirname(PORT_ROOT), "_build", "native")
    assert os.path.realpath(path).startswith(os.path.dirname(PORT_ROOT) + os.sep)
    with open(os.path.join(PORT_ROOT, "bls12_381.cpp"), "rb") as f:
        port_src = f.read()
    ref_src_path = os.path.join(os.path.dirname(lighthouse_tpu.__file__), "native", "bls12_381.cpp")
    with open(ref_src_path, "rb") as f:
        ref_src = f.read()
    # the same code: only the header comments differ
    strip = lambda src: [ln for ln in src.splitlines() if not ln.lstrip().startswith(b"//")]
    assert strip(port_src) == strip(ref_src)


@pytest.mark.parametrize("sk", [1, 12345, 0xFFFF_FFFF_FFFF, cs.keygen_from_ikm(b"\x07" * 32)])
def test_sk_to_pk_equal_bytes(nbs, sk):
    p, r = nbs
    raw = sk.to_bytes(32, "big")
    assert p.sk_to_pk(raw) == r.sk_to_pk(raw) == oc.g1_compress(cs.sk_to_pk(sk))


@pytest.mark.parametrize("msg", [b"", b"abc", MSG])
def test_hash_to_g2_equal_bytes(nbs, msg):
    p, r = nbs
    assert p.hash_to_g2(msg) == r.hash_to_g2(msg) == oc.g2_compress(cs.hash_to_g2(msg))


def test_sign_equal_bytes(nbs):
    p, r = nbs
    sk = 987654321
    raw = sk.to_bytes(32, "big")
    assert p.sign(raw, MSG) == r.sign(raw, MSG) == oc.g2_compress(cs.sign(sk, MSG))


def test_verify_roundtrip_and_tamper(nbs):
    for nb in nbs:
        sk = (777).to_bytes(32, "big")
        pk = nb.sk_to_pk(sk)
        sig = nb.sign(sk, MSG)
        assert nb.pk_validate(pk) and nb.sig_validate(sig)
        assert nb.verify(pk, MSG, sig)
        assert not nb.verify(pk, b"\x43" * 32, sig)
        bad = bytearray(sig)
        bad[-1] ^= 1
        try:
            assert not nb.verify(pk, MSG, bytes(bad))
        except ValueError:
            pass


def test_infinity_rejection(nbs):
    inf_pk, inf_sig = bytes([0xC0]) + bytes(47), bytes([0xC0]) + bytes(95)
    for nb in nbs:
        assert not nb.pk_validate(inf_pk)
        assert not nb.sig_validate(inf_sig)
        assert not nb.verify(nb.sk_to_pk((9).to_bytes(32, "big")), MSG, inf_sig)


def test_non_subgroup_rejection(nbs):
    from lighthouse_tpu_torch.oracle.fields import Fq2

    found = None
    for x0 in range(2, 40):
        x = Fq2(x0, 1)
        y = (x.square() * x + Fq2(4, 4)).sqrt()
        if y is not None and not oc.g2_in_subgroup((x, y)):
            found = (x, y)
            break
    assert found is not None
    enc = oc.g2_compress(found)
    assert [nb.sig_validate(enc) for nb in nbs] == [False, False]


def test_fast_aggregate_verify(nbs):
    p, r = nbs
    sks = [(i + 1).to_bytes(32, "big") for i in range(5)]
    pks = [p.sk_to_pk(k) for k in sks]
    agg = p.aggregate_signatures([p.sign(k, MSG) for k in sks])
    assert agg == r.aggregate_signatures([r.sign(k, MSG) for k in sks])
    assert p.aggregate_pubkeys(pks) == r.aggregate_pubkeys(pks)
    for nb in nbs:
        assert nb.fast_aggregate_verify(pks, MSG, agg)
        assert not nb.fast_aggregate_verify(pks, b"\x01" * 32, agg)
        assert not nb.fast_aggregate_verify(pks[:-1], MSG, agg)


def _example_sets(nb, n_sets=4, keys=3):
    sets, msgs, sigs = [], [], []
    for i in range(n_sets):
        m = bytes([i]) * 32
        ks = [(7 * i + j + 1).to_bytes(32, "big") for j in range(keys)]
        sets.append([nb.sk_to_pk(k) for k in ks])
        msgs.append(m)
        sigs.append(nb.aggregate_signatures([nb.sign(k, m) for k in ks]))
    scal = [0x9E3779B97F4A7C15 * (i + 1) & (2**64 - 1) for i in range(n_sets)]
    return sets, msgs, sigs, scal


def test_verify_signature_sets(nbs):
    p, r = nbs
    sets, msgs, sigs, scal = _example_sets(p)
    bad = list(sigs)
    bad[2] = sigs[1]
    for nb in nbs:
        assert nb.verify_signature_sets(sets, msgs, sigs, scal)
        assert not nb.verify_signature_sets(sets, msgs, bad, scal)
        assert not nb.verify_signature_sets([], [], [], [])


def test_verify_signature_sets_raw_cache_path(nbs):
    p, r = nbs
    sets, msgs, sigs, scal = _example_sets(p)
    raw_sets = [[p.pk_decompress(pk) for pk in s] for s in sets]
    assert raw_sets == [[r.pk_decompress(pk) for pk in s] for s in sets]
    bad = list(msgs)
    bad[0] = b"\xff" * 32
    for nb in nbs:
        assert nb.verify_signature_sets_raw(raw_sets, msgs, sigs, scal)
        assert not nb.verify_signature_sets_raw(raw_sets, bad, sigs, scal)


def test_seam_selects_native(native_backend):
    """``bls.set_backend("native")``: sign, verify, fast_aggregate_verify and
    verify_signature_sets run in C++, with the oracle's bytes and verdicts."""
    assert bls.get_backend() == "native"
    sks = [bls.SecretKey.from_bytes((i + 3).to_bytes(32, "big")) for i in range(3)]
    msgs = [hashlib.sha256(b"seam-%d" % i).digest() for i in range(3)]
    sigs = [sk.sign(m) for sk, m in zip(sks, msgs)]
    assert [s.serialize() for s in sigs] == [
        oc.g2_compress(cs.sign(sk.scalar, m)) for sk, m in zip(sks, msgs)]
    assert sigs[0].verify(sks[0].public_key(), msgs[0])
    assert not sigs[0].verify(sks[1].public_key(), msgs[0])
    agg = bls.AggregateSignature.aggregate([sk.sign(msgs[0]) for sk in sks])
    pks = [sk.public_key() for sk in sks]
    assert agg.fast_aggregate_verify(msgs[0], pks)
    assert not agg.fast_aggregate_verify(msgs[1], pks)
    sets = [bls.SignatureSet.single_pubkey(s, sk.public_key(), m)
            for s, sk, m in zip(sigs, sks, msgs)]
    assert bls.verify_signature_sets(sets) is True
    poisoned = list(sets)
    poisoned[1] = bls.SignatureSet.single_pubkey(sigs[2], sks[1].public_key(), msgs[1])
    assert bls.verify_signature_sets(poisoned) is False
    assert bls.verify_signature_sets([]) is False
    short = [bls.SignatureSet.single_pubkey(sigs[0], sks[0].public_key(), b"short")]
    assert bls.verify_signature_sets(short) is False  # not a 32-byte root: a False verdict
    assert bls.warmup() is True


def test_seam_rejects_unknown_backends():
    for name in ("tpu", "auto", ""):
        with pytest.raises(ValueError):
            bls.set_backend(name)
