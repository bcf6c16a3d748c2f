"""The port's KZG host layers against the reference's.

``lighthouse_tpu_torch.kzg`` is the port's copy of ``lighthouse_tpu.kzg``:
the trusted setup (its own byte-for-byte copy of ``setup_mainnet.bin``), the
Fr helpers, the MSM seam (host Pippenger and the device ``scale_bits``
ladder, here on ``device="cpu"``: the kernels' plain versions) and ``Kzg``
(commitments, proofs, single and batch verify). One small insecure setup is
built once with the reference's ``insecure_setup`` and carried across with
``convert.trusted_setup_from_ref``; both packages then run on the same
points. Exact equality of bytes, points and verdicts everywhere.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.kzg import fr as r_fr
from lighthouse_tpu.kzg import setup as r_setup
from lighthouse_tpu.kzg.kzg import Kzg as RKzg
from lighthouse_tpu.kzg.msm import pippenger as r_pippenger
from lighthouse_tpu.ops.bls_oracle import curves as r_oc
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.kzg import KzgError as PKzgError
from lighthouse_tpu_torch.kzg import fr as p_fr
from lighthouse_tpu_torch.kzg import msm as p_msm
from lighthouse_tpu_torch.kzg import setup as p_setup
from lighthouse_tpu_torch.kzg.kzg import Kzg as PKzg

N = 64
R = p_fr.BLS_MODULUS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = r_bls.get_backend(), p_bls.get_backend(), p_bls.get_device()
    r_bls.set_backend("oracle")
    p_bls.set_backend("oracle")
    yield
    r_bls.set_backend(saved[0])
    p_bls.set_backend(saved[1], device=saved[2])


@pytest.fixture(scope="module")
def setups():
    ref = r_setup.insecure_setup(N)
    return ref, convert.trusted_setup_from_ref(ref)


@pytest.fixture(scope="module")
def kzgs(setups):
    return RKzg(setups[0]), PKzg(setups[1])


def _blob(rng, n=N):
    return b"".join(r_fr.bls_field_to_bytes(int(rng.integers(0, 2**62)) * 3 + 1) for _ in range(n))


def _g2_ints(p):
    return None if p is None else (p[0].c0, p[0].c1, p[1].c0, p[1].c1)


# -- the trusted setup ---------------------------------------------------------------


def test_setup_copy_is_byte_equal_and_loads_the_same_points():
    with open(r_setup._BIN, "rb") as a, open(p_setup._BIN, "rb") as b:
        ref_bytes, port_bytes = a.read(), b.read()
    assert len(port_bytes) == 798_928 and port_bytes == ref_bytes
    assert p_setup._BIN != r_setup._BIN  # the port reads its own copy
    ref, port = r_setup.load(), p_setup.load()
    assert port.field_elements_per_blob == ref.field_elements_per_blob == 4096
    assert port.g1_lagrange_brp == ref.g1_lagrange_brp
    assert port.g1_monomial == ref.g1_monomial
    assert [_g2_ints(p) for p in port.g2_monomial] == [_g2_ints(p) for p in ref.g2_monomial]
    assert len(port.g2_monomial) == 65


def test_insecure_setup_and_convert_agree(setups):
    ref, conv = setups
    own = p_setup.insecure_setup(8, n_g2=3)
    small = r_setup.insecure_setup(8, n_g2=3)
    assert own.g1_lagrange_brp == small.g1_lagrange_brp
    assert own.g1_monomial == small.g1_monomial
    assert [_g2_ints(p) for p in own.g2_monomial] == [_g2_ints(p) for p in small.g2_monomial]
    assert conv.g1_lagrange_brp == ref.g1_lagrange_brp and conv.g1_monomial == ref.g1_monomial
    assert [_g2_ints(p) for p in conv.g2_monomial] == [_g2_ints(p) for p in ref.g2_monomial]
    # rows of ints (numpy included) carry across too
    rows = np.array([[p[0], p[1]] for p in ref.g1_monomial[:3]], dtype=object)
    g2_rows = [list(_g2_ints(p)) for p in ref.g2_monomial]
    alt = convert.trusted_setup_from_ref(type("S", (), {
        "g1_lagrange_brp": rows, "g1_monomial": rows, "g2_monomial": g2_rows})())
    assert alt.g1_monomial == ref.g1_monomial[:3]
    assert [_g2_ints(p) for p in alt.g2_monomial] == [_g2_ints(p) for p in conv.g2_monomial]


# -- fr.py -----------------------------------------------------------------------------


def test_fr_helpers_equal_the_reference():
    rng = np.random.default_rng(1)
    vals = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(8)]
    for v in vals:
        b = p_fr.bls_field_to_bytes(v)
        assert b == r_fr.bls_field_to_bytes(v)
        assert p_fr.bytes_to_bls_field(b) == r_fr.bytes_to_bls_field(b) == v
    for bad in (R.to_bytes(32, "big"), b"\x01" * 31):
        with pytest.raises(ValueError):
            p_fr.bytes_to_bls_field(bad)
        with pytest.raises(ValueError):
            r_fr.bytes_to_bls_field(bad)
    assert p_fr.hash_to_bls_field(b"abc") == r_fr.hash_to_bls_field(b"abc")
    assert p_fr.bit_reversal_permutation(list(range(16))) == r_fr.bit_reversal_permutation(
        list(range(16)))
    for order in (4, 16, 64):
        assert p_fr.compute_roots_of_unity(order) == r_fr.compute_roots_of_unity(order)
    assert p_fr.batch_inverse(vals[1:]) == r_fr.batch_inverse(vals[1:])
    with pytest.raises(ZeroDivisionError):
        p_fr.batch_inverse([3, 0])
    roots = p_fr.compute_roots_of_unity(16)
    poly = vals[:11] + [5] * 5
    for z in (roots[3], 12345, R - 2):
        assert (p_fr.evaluate_polynomial_in_evaluation_form(poly, z, roots)
                == r_fr.evaluate_polynomial_in_evaluation_form(poly, z, roots))


# -- the MSM seam ----------------------------------------------------------------------


def test_pippenger_equals_the_reference(setups):
    ref, port = setups
    rng = np.random.default_rng(2)
    scalars = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(N - 3)]
    want = r_pippenger(ref.g1_lagrange_brp, scalars)
    assert p_msm.pippenger(port.g1_lagrange_brp, scalars) == want
    assert p_msm.msm(port.g1_lagrange_brp, scalars) == want  # the "oracle" bls backend
    assert p_msm.msm(port.g1_lagrange_brp, scalars, backend="host") == want
    with_inf = [None] + list(port.g1_monomial[:7])
    assert p_msm.pippenger(with_inf, scalars[:8]) == r_pippenger(
        [None] + list(ref.g1_monomial[:7]), scalars[:8])


def test_device_msm_on_the_cpu_equals_pippenger(setups):
    """The device arm (one scale_bits ladder over the resident setup, then
    the halving tree) on the bls seam's device, here "cpu", at 16 lanes:
    equal to the reference's Pippenger; the resident setup is keyed by
    content and device."""
    ref, port = setups
    rng = np.random.default_rng(3)
    scalars = [R - 1, 0] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(14)]
    pts = port.g1_monomial[:16]
    p_bls.set_backend("oracle", device="cpu")
    try:
        got = p_msm.msm(pts, scalars, backend="device")
        assert got == r_pippenger(ref.g1_monomial[:16], scalars)
        before = len(p_msm._device_setups)
        assert p_msm.msm(list(pts), [0] * 16, backend="device") is None  # infinity
        assert len(p_msm._device_setups) == before  # a fresh list of the same points: no upload
        with pytest.raises(ValueError, match="unknown msm backend"):
            p_msm.msm(pts, scalars, backend="gpu-maybe")
    finally:
        p_bls.set_backend("oracle")
    if not torch.cuda.is_available():
        # with no device named the arm runs on CUDA, and raises without it
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            p_msm.msm(pts, scalars, backend="device")


def test_scalar_bits_msb_first():
    vals = [0, 1, R - 1, 2**254 + 3]
    bits = p_msm.scalar_bits(vals)
    assert bits.shape == (255, 4) and bits.dtype == np.int64
    for j, v in enumerate(vals):
        assert int("".join(str(int(b)) for b in bits[:, j]), 2) == v % R


# -- Kzg -------------------------------------------------------------------------------


def test_commitments_and_proofs_equal_the_reference(kzgs):
    rk, pk = kzgs
    rng = np.random.default_rng(4)
    blobs = [_blob(rng) for _ in range(2)]
    for blob in blobs:
        c = pk.blob_to_kzg_commitment(blob)
        assert c == rk.blob_to_kzg_commitment(blob)
        assert pk.compute_blob_kzg_proof(blob, c) == rk.compute_blob_kzg_proof(blob, c)
        for z in (r_fr.bls_field_to_bytes(777), r_fr.bls_field_to_bytes(rk.roots[5])):
            assert pk.compute_kzg_proof(blob, z) == rk.compute_kzg_proof(blob, z)
    # f(x) = c commits to [c]G1; f(w_i) = w_i commits to [tau]G1
    assert pk.blob_to_kzg_commitment(r_fr.bls_field_to_bytes(99) * N) == r_oc.g1_compress(
        r_oc.g1_mul(r_oc.g1_generator(), 99))
    ident = b"".join(r_fr.bls_field_to_bytes(w) for w in pk.roots)
    assert pk.blob_to_kzg_commitment(ident) == r_oc.g1_compress(rk.setup.g1_monomial[1])


def test_single_and_batch_verify_equal_the_reference(kzgs):
    rk, pk = kzgs
    rng = np.random.default_rng(5)
    blobs = [_blob(rng) for _ in range(3)]
    comms = [pk.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [pk.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, comms)]
    z = r_fr.bls_field_to_bytes(4242)
    proof, y = pk.compute_kzg_proof(blobs[0], z)
    cases = [
        ("point", lambda k: k.verify_kzg_proof(comms[0], z, y, proof), True),
        ("point wrong y", lambda k: k.verify_kzg_proof(
            comms[0], z, r_fr.bls_field_to_bytes(int.from_bytes(y, "big") + 1), proof), False),
        ("blob", lambda k: k.verify_blob_kzg_proof(blobs[1], comms[1], proofs[1]), True),
        ("blob wrong proof", lambda k: k.verify_blob_kzg_proof(blobs[1], comms[1], proofs[2]), False),
        ("batch", lambda k: k.verify_blob_kzg_proof_batch(blobs, comms, proofs), True),
        ("batch swapped", lambda k: k.verify_blob_kzg_proof_batch(
            blobs, comms, [proofs[0], proofs[2], proofs[1]]), False),
        ("batch empty", lambda k: k.verify_blob_kzg_proof_batch([], [], []), True),
    ]
    for name, fn, want in cases:
        assert fn(pk) is want and fn(rk) is want, name


def test_malformed_inputs_raise_like_the_reference(kzgs):
    rk, pk = kzgs
    blob = _blob(np.random.default_rng(6))
    c = pk.blob_to_kzg_commitment(blob)
    bad_blob = blob[:-32] + R.to_bytes(32, "big")
    for fn in (
        lambda k: k.blob_to_kzg_commitment(blob[:-1]),
        lambda k: k.blob_to_kzg_commitment(bad_blob),
        lambda k: k.verify_blob_kzg_proof(blob, c[:47], c),
        lambda k: k.verify_blob_kzg_proof(blob, b"\x00" * 48, c),
        lambda k: k.verify_blob_kzg_proof_batch([blob], [c, c], [c]),
    ):
        with pytest.raises(PKzgError):
            fn(pk)
        with pytest.raises(Exception) as e:
            fn(rk)
        assert type(e.value).__name__ == "KzgError"
