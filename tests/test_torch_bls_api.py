"""The port's ``bls`` API against the reference's, on the same inputs.

``lighthouse_tpu_torch.bls`` is the port of ``lighthouse_tpu.bls``: the
wrapper types, the byte codecs and ``verify_signature_sets`` with its
``"device"`` arm (``aggregate_stage`` +
``verify_signature_sets_device_h2c``, run here on the CPU with
``device="cpu"``) and its ``"oracle"`` arm. Held here:

* ``serialize`` / ``from_bytes`` give the reference's bytes, or raise
  ``BlsError`` with the reference's message, on random keys (numpy seed)
  and on edge cases: infinity, wrong length, bad flag bits, x >= p, x off
  the curve, a point outside the subgroup;
* ``keygen``, ``sign``, ``verify``, ``fast_aggregate_verify`` and
  ``aggregate_verify`` agree with the reference;
* the vectorised codecs (``parse_g1_bytes``, ``encode_g1_bytes``,
  ``encode_g2_bytes``) equal the reference's;
* ``verify_signature_sets(device="cpu")`` gives the reference oracle's
  verdict on a valid batch, a poisoned one, an empty list, a set with no
  keys, an infinity signature and 3 sets (padded to 4); ``warmup`` is True;
  the backend switch takes ``"device"`` and ``"oracle"`` only.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.bls import serde as r_serde

from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.bls import serde
from lighthouse_tpu_torch.oracle import curves as oc
from lighthouse_tpu_torch.oracle.fields import P, Fq2, fq_sqrt

rng = np.random.default_rng(0xB15)
SKS = [int(rng.integers(1, 1 << 62)) * 977 + 13 for _ in range(6)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The device arm runs at small shapes on the CPU: one intra-op thread
    keeps torch from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def device_backend():
    """Each test starts on the default backends of both packages."""
    old_port, old_ref = bls.get_backend(), r_bls.get_backend()
    bls.set_backend("device")
    r_bls.set_backend("oracle")
    yield
    bls.set_backend(old_port)
    r_bls.set_backend(old_ref)


def _sk(mod, i):
    return mod.SecretKey.from_bytes(SKS[i].to_bytes(32, "big"))


def _outcome(fn, data):
    """(serialized bytes, None) or (None, error message)."""
    try:
        return fn(data).serialize(), None
    except (bls.BlsError, r_bls.BlsError) as e:
        return None, (type(e).__name__, str(e))


def _off_subgroup_g1() -> bytes:
    x = 5
    while fq_sqrt((x ** 3 + 4) % P) is None:
        x += 1
    pt = (x, fq_sqrt((x ** 3 + 4) % P))
    assert oc.g1_is_on_curve(pt) and not oc.g1_in_subgroup(pt)
    return oc.g1_compress(pt)


def _off_subgroup_g2() -> bytes:
    c0 = 3
    while True:
        x = Fq2(c0, 1)
        y = (x.square() * x + Fq2(4, 4)).sqrt()
        if y is not None:
            break
        c0 += 1
    assert oc.g2_is_on_curve((x, y)) and not oc.g2_in_subgroup((x, y))
    return oc.g2_compress((x, y))


def _off_curve(n_bytes: int) -> bytes:
    x = 5
    while fq_sqrt((x ** 3 + 4) % P) is not None:
        x += 1
    if n_bytes == 48:
        b = bytearray(x.to_bytes(48, "big"))
    else:
        x2 = Fq2(x, 0)
        while (x2.square() * x2 + Fq2(4, 4)).sqrt() is not None:
            x2 = Fq2(x2.c0 + 1, 0)
        b = bytearray(bytes(48) + x2.c0.to_bytes(48, "big"))
    b[0] |= 0x80
    return bytes(b)


def _pubkey_inputs():
    good = [_sk(bls, i).public_key().serialize() for i in range(4)]
    return good + [
        bls.INFINITY_PUBLIC_KEY,
        good[0][:47],                                   # wrong length
        good[0] + b"\x00",
        bytes([good[0][0] & 0x7F]) + good[0][1:],       # compression bit cleared
        bytes([0xE0]) + bytes(47),                      # infinity with the sign bit
        bytes([0xC0]) + bytes(46) + b"\x01",            # infinity with x != 0
        bytes([0x80 | 0x1F]) + b"\xff" * 47,            # x >= p
        _off_curve(48),
        _off_subgroup_g1(),
    ]


def _signature_inputs():
    good = [_sk(bls, i).sign(bytes([i]) * 32).serialize() for i in range(3)]
    return good + [
        bls.INFINITY_SIGNATURE,
        good[0][:95],
        bytes([good[0][0] & 0x7F]) + good[0][1:],
        bytes([0xE0]) + bytes(95),
        bytes([0xC0]) + bytes(94) + b"\x01",
        bytes([0x80 | 0x1F]) + b"\xff" * 95,
        _off_curve(96),
        _off_subgroup_g2(),
    ]


def test_pubkey_bytes_and_errors_equal_reference():
    for data in _pubkey_inputs():
        assert _outcome(bls.PublicKey.from_bytes, data) == _outcome(
            r_bls.PublicKey.from_bytes, data
        ), data.hex()
    for i in range(4):
        assert _sk(bls, i).public_key().serialize() == _sk(r_bls, i).public_key().serialize()
        assert _sk(bls, i).public_key().point == _sk(r_bls, i).public_key().point


def test_signature_bytes_and_errors_equal_reference():
    for mod_port, mod_ref in (
        (bls.Signature, r_bls.Signature),
        (bls.AggregateSignature, r_bls.AggregateSignature),
    ):
        for data in _signature_inputs():
            assert _outcome(mod_port.from_bytes, data) == _outcome(
                mod_ref.from_bytes, data
            ), data.hex()


def test_secret_key_bytes_and_errors_equal_reference():
    from lighthouse_tpu_torch.oracle.fields import R

    cases = [SKS[0].to_bytes(32, "big"), bytes(32), R.to_bytes(32, "big"), b"\x01" * 31]
    for data in cases:
        assert _outcome(bls.SecretKey.from_bytes, data) == _outcome(
            r_bls.SecretKey.from_bytes, data
        )
    ikm = rng.bytes(32)
    assert bls.SecretKey.keygen(ikm).scalar == r_bls.SecretKey.keygen(ikm).scalar
    assert bls.SecretKey.keygen(ikm, b"info").scalar == r_bls.SecretKey.keygen(ikm, b"info").scalar
    with pytest.raises(ValueError):
        bls.SecretKey.keygen(b"short")


def test_sign_and_single_verifies_equal_reference():
    msg, other = rng.bytes(32), rng.bytes(32)
    sks_p = [_sk(bls, i) for i in range(3)]
    sks_r = [_sk(r_bls, i) for i in range(3)]
    sigs_p = [s.sign(msg) for s in sks_p]
    sigs_r = [s.sign(msg) for s in sks_r]
    assert [s.serialize() for s in sigs_p] == [s.serialize() for s in sigs_r]
    pks_p = [s.public_key() for s in sks_p]
    pks_r = [s.public_key() for s in sks_r]
    for m in (msg, other):
        assert sigs_p[0].verify(pks_p[0], m) == sigs_r[0].verify(pks_r[0], m) == (m == msg)
    agg_p, agg_r = bls.AggregateSignature.aggregate(sigs_p), r_bls.AggregateSignature.aggregate(sigs_r)
    assert agg_p.serialize() == agg_r.serialize()
    assert agg_p.add_assign(sigs_p[0]).serialize() == agg_r.add_assign(sigs_r[0]).serialize()
    for keys in (pks_p, pks_p[:2], []):
        keys_r = pks_r[: len(keys)]
        assert agg_p.fast_aggregate_verify(msg, keys) == agg_r.fast_aggregate_verify(msg, keys_r)
    assert agg_p.fast_aggregate_verify(msg, pks_p) is True
    msgs = [rng.bytes(32) for _ in range(3)]
    distinct_p = bls.AggregateSignature.aggregate([s.sign(m) for s, m in zip(sks_p, msgs)])
    distinct_r = r_bls.AggregateSignature.aggregate([s.sign(m) for s, m in zip(sks_r, msgs)])
    for ms in (msgs, msgs[::-1], msgs[:2]):
        assert distinct_p.aggregate_verify(ms, pks_p) == distinct_r.aggregate_verify(ms, pks_r)
    assert distinct_p.aggregate_verify(msgs, pks_p) is True
    assert bls.AggregateSignature.infinity().serialize() == bls.INFINITY_SIGNATURE
    # a non-subgroup signature parses, then fails verification in both
    off = _off_subgroup_g2()
    assert bls.Signature.from_bytes(off).verify(pks_p[0], msg) is False
    assert r_bls.Signature.from_bytes(off).verify(pks_r[0], msg) is False


def test_codecs_equal_reference():
    pk_bytes = [d for d in _pubkey_inputs() if len(d) == 48]
    data = np.frombuffer(b"".join(pk_bytes), np.uint8).reshape(-1, 48)
    got, want = serde.parse_g1_bytes(data), r_serde.parse_g1_bytes(data)
    for k in ("x", "s_flag", "is_inf", "wf_ok"):
        assert (np.asarray(got[k]) == np.asarray(want[k]).astype(got[k].dtype)).all(), k
    assert got["x"].dtype == np.int64
    x = got["x"]
    sign, is_inf = got["s_flag"], got["is_inf"]
    ok = got["wf_ok"]
    enc = serde.encode_g1_bytes(x[ok], sign[ok], is_inf[ok])
    assert (enc == r_serde.encode_g1_bytes(x[ok].astype(np.uint64), sign[ok], is_inf[ok])).all()
    assert (enc == data[ok]).all()  # canonical encodings round-trip
    sg_bytes = [d for d in _signature_inputs() if len(d) == 96]
    data2 = np.frombuffer(b"".join(sg_bytes), np.uint8).reshape(-1, 96)
    got2 = serde.parse_g2_bytes(data2)
    ok2 = got2["wf_ok"]
    args = (got2["x_c0"][ok2], got2["x_c1"][ok2], got2["s_flag"][ok2], got2["is_inf"][ok2])
    enc2 = serde.encode_g2_bytes(*args)
    assert (enc2 == r_serde.encode_g2_bytes(
        args[0].astype(np.uint64), args[1].astype(np.uint64), args[2], args[3]
    )).all()
    assert (enc2 == data2[ok2]).all()


# -- verify_signature_sets ---------------------------------------------------------


def _sets(mod, n=4, keys=(2, 1, 3, 1), poison=None, infinity=None, no_keys=None):
    """Signature sets over the same keys and messages in ``mod``'s types."""
    out = []
    k0 = 0
    for s in range(n):
        k = keys[s]
        sks = [_sk(mod, (k0 + j) % len(SKS)) for j in range(k)]
        k0 += k
        msg = bytes([0x40 + s]) * 32
        signed = b"\x99" * 32 if s == poison else msg
        sig = mod.AggregateSignature.aggregate([sk.sign(signed) for sk in sks])
        if s == infinity:
            sig = mod.AggregateSignature.infinity()
        pks = [] if s == no_keys else [sk.public_key() for sk in sks]
        out.append(mod.SignatureSet.multiple_pubkeys(sig, pks, msg))
    return out


CASES = [
    ("valid", {}, True),
    ("poisoned", {"poison": 2}, False),
    ("empty_list", {"n": 0}, False),
    ("no_keys", {"no_keys": 1}, False),
    ("infinity_sig", {"infinity": 0}, False),
    ("three_sets_padded", {"n": 3}, True),
]


@pytest.mark.parametrize("name,kw,expect", CASES, ids=[c[0] for c in CASES])
def test_verify_signature_sets_equals_reference_oracle(name, kw, expect):
    want = r_bls.verify_signature_sets_oracle(_sets(r_bls, **kw))
    got = bls.verify_signature_sets(_sets(bls, **kw), device="cpu")
    assert got == want == expect
    assert bls.verify_signature_sets_oracle(_sets(bls, **kw)) == want


def test_device_arm_with_injected_scalars():
    """The device arm's halves: with injected RLC scalars (two >= 2^63) a
    valid batch verifies and a poisoned one does not; a wrong scalar count
    raises; a set that cannot verify stops the host half."""
    prepared = bls.prepare_sets(_sets(bls, n=3), device="cpu")
    scalars = np.array([(1 << 64) - 5, 7, 1 << 63, 3], dtype=np.uint64)
    assert bls.verify_prepared_sets(prepared, scalars=scalars) is True
    with pytest.raises(ValueError, match="scalars must have shape"):
        bls.verify_prepared_sets(prepared, scalars=scalars[:3])
    bad = bls.prepare_sets(_sets(bls, n=3, poison=0), device="cpu")
    assert bls.verify_prepared_sets(bad, scalars=scalars) is False
    assert bls.prepare_sets(_sets(bls, n=3, infinity=1), device="cpu") is None


def test_prepared_pubkeys_aggregate_as_per_set_tensors():
    """The host-padded pubkey array and mask of ``prepare_sets`` (keys 2, 1,
    3, 1 -> k_pad 4) aggregate to the same points as the per-set tensors
    padded on the device by ``aggregate_pubkeys_device``."""
    from lighthouse_tpu_torch.bls import backend
    from lighthouse_tpu_torch.ops.bls import fq, g1

    sets = _sets(bls)
    pks, mask, *_ = bls.prepare_sets(sets, device="cpu")
    assert tuple(pks.shape) == (4, 4, 3, fq.NLIMBS)
    assert mask.sum(dim=1).tolist() == [2, 1, 3, 1]
    per_set = [g1.from_oracle_batch([pk.point for pk in s.signing_keys], "cpu") for s in sets]
    got = backend.aggregate_stage(pks, mask)
    want = backend.aggregate_pubkeys_device(per_set)
    assert [g1.to_oracle(p) for p in got] == [g1.to_oracle(p) for p in want]


def test_backend_switch_and_warmup():
    with pytest.raises(ValueError):
        bls.set_backend("tpu")
    with pytest.raises(ValueError):
        bls.set_backend("native")
    bls.set_backend("oracle")
    assert bls.get_backend() == "oracle"
    assert bls.verify_signature_sets(_sets(bls, poison=1)) is False
    assert bls.warmup() is True
    bls.set_backend("device")
    assert bls.get_backend() == "device"
    assert bls.warmup(n_sets=1, device="cpu") is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bls.verify_signature_sets(_sets(bls, n=1))
