"""Backend-pluggable BLS12-381 seam: the port of ``lighthouse_tpu/bls/__init__.py``.

Everything above this package is backend-blind: it sees ``PublicKey`` /
``Signature`` / ``AggregateSignature`` / ``SecretKey`` / ``SignatureSet``
and the free function ``verify_signature_sets``, as Lighthouse's
``crypto/bls`` seam (``define_mod!``, ``crypto/bls/src/lib.rs:87-142``)
presents them. Backends:

* ``"device"`` (the default; the reference's ``"tpu"``): batched
  random-linear-combination verification on the GPU through
  ``bls.backend`` (``aggregate_stage`` and
  ``verify_signature_sets_device_h2c``);
* ``"oracle"``: the pure-Python ciphersuite (``oracle/ciphersuite.py``),
  trusted and device-free.

Single-signature operations (``verify``, ``fast_aggregate_verify``,
``aggregate_verify``, ``sign``) run on the oracle under both backends, as
the reference's device backend does: a device round trip pays off only in
batches. Wire formats match the reference: 48-byte compressed G1 pubkeys,
96-byte compressed G2 signatures, 32-byte secret keys.

``verify_signature_sets`` and ``warmup`` take ``device=`` (default CUDA,
raising without it; the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..oracle import ciphersuite as _cs
from ..oracle import curves as _oc
from ..oracle.fields import R as CURVE_ORDER

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32

INFINITY_PUBLIC_KEY = b"\xc0" + b"\x00" * 47
INFINITY_SIGNATURE = b"\xc0" + b"\x00" * 95

_BACKEND = "device"


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in ("device", "oracle"):
        raise ValueError(f"unknown bls backend {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


class BlsError(Exception):
    """Deserialization / validation failure (Lighthouse: bls::Error)."""


@dataclass(frozen=True)
class PublicKey:
    """Validated G1 public key (decompressed, subgroup-checked on parse —
    key_validate semantics, blst.rs:75)."""

    point: tuple  # oracle affine G1 point

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        if len(data) != PUBLIC_KEY_BYTES_LEN:
            raise BlsError(f"invalid pubkey length {len(data)}")
        try:
            pt = _oc.g1_decompress(data)
        except ValueError as e:
            raise BlsError(str(e)) from None
        if pt is None or not _oc.g1_in_subgroup(pt):
            raise BlsError("pubkey not a valid subgroup point")
        return cls(pt)

    def serialize(self) -> bytes:
        return _oc.g1_compress(self.point)

    def __hash__(self):
        return hash(self.point)


@dataclass(frozen=True)
class Signature:
    """G2 signature. Parsed lazily-strict: bytes must decode to an on-curve
    point (or infinity); the subgroup check happens at verification time,
    matching the reference's deserialize-then-groupcheck split."""

    point: object  # oracle affine G2 point or None (infinity)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        if len(data) != SIGNATURE_BYTES_LEN:
            raise BlsError(f"invalid signature length {len(data)}")
        try:
            pt = _oc.g2_decompress(data)
        except ValueError as e:
            raise BlsError(str(e)) from None
        return cls(pt)

    def serialize(self) -> bytes:
        return _oc.g2_compress(self.point)

    def verify(self, pubkey: PublicKey, message: bytes) -> bool:
        return _cs.verify(pubkey.point, message, self.point)


@dataclass(frozen=True)
class AggregateSignature:
    point: object

    @classmethod
    def infinity(cls) -> "AggregateSignature":
        return cls(None)

    @classmethod
    def aggregate(cls, sigs) -> "AggregateSignature":
        acc = None
        for s in sigs:
            acc = _oc.g2_add(acc, s.point)
        return cls(acc)

    def add_assign(self, sig: Signature) -> "AggregateSignature":
        return AggregateSignature(_oc.g2_add(self.point, sig.point))

    def serialize(self) -> bytes:
        return _oc.g2_compress(self.point)

    @classmethod
    def from_bytes(cls, data: bytes) -> "AggregateSignature":
        return cls(Signature.from_bytes(data).point)

    def fast_aggregate_verify(self, message: bytes, pubkeys) -> bool:
        return _cs.fast_aggregate_verify([pk.point for pk in pubkeys], message, self.point)

    def aggregate_verify(self, messages, pubkeys) -> bool:
        return _cs.aggregate_verify([pk.point for pk in pubkeys], messages, self.point)


@dataclass(frozen=True)
class SecretKey:
    scalar: int

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise BlsError(f"invalid secret key length {len(data)}")
        sk = int.from_bytes(data, "big")
        if sk == 0 or sk >= CURVE_ORDER:
            raise BlsError("secret key out of range")
        return cls(sk)

    @classmethod
    def keygen(cls, ikm: bytes, key_info: bytes = b"") -> "SecretKey":
        return cls(_cs.keygen_from_ikm(ikm, key_info))

    def serialize(self) -> bytes:
        return self.scalar.to_bytes(32, "big")

    def public_key(self) -> PublicKey:
        return PublicKey(_cs.sk_to_pk(self.scalar))

    def sign(self, message: bytes) -> Signature:
        return Signature(_cs.sign(self.scalar, message))


@dataclass
class SignatureSet:
    """One batch-verification task (generic_signature_set.rs:61-72)."""

    signature: object       # Signature | AggregateSignature
    signing_keys: list      # list[PublicKey]
    message: bytes          # 32-byte signing root

    @classmethod
    def single_pubkey(cls, signature, signing_key, message) -> "SignatureSet":
        return cls(signature, [signing_key], message)

    @classmethod
    def multiple_pubkeys(cls, signature, signing_keys, message) -> "SignatureSet":
        return cls(signature, signing_keys, message)


def _verify_sets_oracle(sets) -> bool:
    return _cs.verify_signature_sets(
        [
            _cs.SignatureSet(s.signature.point, [pk.point for pk in s.signing_keys], s.message)
            for s in sets
        ]
    )


def prepare_sets(sets, device=None):
    """The device arm's host half: pubkey and signature points -> limb
    tensors on ``device``, SHA-256 hash_to_field, padding to bucket(n) by
    broadcast (reference :236-249). The pubkeys are laid out on the host as
    the padded [n, bucket(max k), 3, 25] array the aggregation takes, with
    masked infinity points past each set's keys, and uploaded once with
    their mask. Returns (pubkeys, mask, sig, u0, u1, n), or None when a set
    cannot verify (infinity signature, no keys) or there are no sets."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..ops.bls import fq, g1, g2, h2c
    from .backend import bucket

    dev = resolve_device(device)
    sets = list(sets)
    n = len(sets)
    if n == 0:
        return None
    for s in sets:
        if s.signature.point is None or not s.signing_keys:
            return None
    n_pad = bucket(n)
    ks = np.array([len(s.signing_keys) for s in sets])
    k_pad = bucket(int(ks.max()))
    pts = []
    for s, k in zip(sets, ks):
        pts += [pk.point for pk in s.signing_keys] + [None] * (k_pad - k)
    pks = g1.oracle_limbs(pts).reshape(n, k_pad, 3, fq.NLIMBS)
    mask = np.arange(k_pad) < ks[:, None]
    sig = g2.from_oracle_batch([s.signature.point for s in sets], dev)
    u0, u1 = h2c.hash_to_field_batch([s.message for s in sets], _cs.DST, dev)
    if n_pad > n:  # pad by broadcast, not by hashing dummy messages
        sig, u0, u1 = (
            torch.cat([a, a[:1].expand((n_pad - n,) + a.shape[1:])]) for a in (sig, u0, u1)
        )
    return torch.from_numpy(pks).to(dev), torch.from_numpy(mask).to(dev), sig, u0, u1, n


def verify_prepared_sets(prepared, *, scalars=None) -> bool:
    """The device arm's device half on ``prepare_sets``' output: per-set
    pubkey aggregation (``aggregate_stage``), padding of the aggregates by
    broadcast, then ``verify_signature_sets_device_h2c``. ``scalars``
    ([bucket(n)] uint64) injects the RLC scalars (tests); None draws them."""
    import torch

    from .backend import aggregate_stage, verify_signature_sets_device_h2c

    if prepared is None:
        return False
    pks, mask, sig, u0, u1, n = prepared
    pk_agg = aggregate_stage(pks, mask)
    n_pad = sig.shape[0]
    if n_pad > n:
        pk_agg = torch.cat([pk_agg, pk_agg[:1].expand((n_pad - n,) + pk_agg.shape[1:])])
    return verify_signature_sets_device_h2c(pk_agg, sig, u0, u1, n, scalars=scalars)


def verify_signature_sets(sets, *, device=None) -> bool:
    """Random-linear-combination batch verification over the active backend.
    ``device`` (default CUDA) is where the device backend runs."""
    sets = list(sets)
    if _BACKEND == "oracle":
        return _verify_sets_oracle(sets)
    return verify_prepared_sets(prepare_sets(sets, device))


def verify_signature_sets_oracle(sets) -> bool:
    """Batch verification pinned to the pure-Python oracle regardless of the
    active backend: the degradation ladder's CPU rung of last resort
    (resilience.supervisor): always available, trusted, device-free."""
    return _verify_sets_oracle(list(sets))


def warmup(n_sets: int = 2, *, device=None) -> bool:
    """Build and load the active backend's kernels before serving.

    On the device backend the first batch builds the CUDA library (nvcc)
    and derives every plan schedule at that batch's row counts; serving
    paths run this at startup so no request pays for it. Returns the
    verification verdict (True on a healthy backend)."""
    import hashlib

    sk = SecretKey.from_bytes((7).to_bytes(32, "big"))
    pk = sk.public_key()
    # messages are 32-byte signing roots, the only shape the pipeline verifies
    msgs = [hashlib.sha256(b"lighthouse-tpu-warmup-%02d" % i).digest() for i in range(n_sets)]
    sets = [SignatureSet.single_pubkey(sk.sign(m), pk, m) for m in msgs]
    ok = verify_signature_sets(sets[:1], device=device)
    if n_sets > 1:
        ok = verify_signature_sets(sets, device=device) and ok
    return ok
