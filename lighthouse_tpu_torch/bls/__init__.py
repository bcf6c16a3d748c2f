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
  trusted and device-free;
* ``"native"``: the C++ CPU backend (``native/``, built with g++ at first
  use), selected by name. It is never a rung a device failure falls to.

Single-signature operations (``verify``, ``fast_aggregate_verify``,
``aggregate_verify``, ``sign``) run on the oracle under the device and
oracle backends, as the reference's device backend does (a device round
trip pays off only in batches); under ``"native"`` ``verify``,
``fast_aggregate_verify`` and ``sign`` run in C++. Wire formats match the reference: 48-byte compressed G1 pubkeys,
96-byte compressed G2 signatures, 32-byte secret keys.

``verify_signature_sets`` and ``warmup`` take ``device=``; a call that names
none runs on the device given to ``set_backend`` (default CUDA, raising
without it). ``set_backend(mesh_devices=)`` spreads the device backend's
batches over a serving mesh (``bls/mesh.py``, ``bls/sharded.py``). Callers that cannot pass one, such as block processing, follow
``set_backend``: the CPU tests pass ``device="cpu"`` to either.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..oracle import ciphersuite as _cs
from ..oracle import curves as _oc
from ..oracle.fields import R as CURVE_ORDER

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32

INFINITY_PUBLIC_KEY = b"\xc0" + b"\x00" * 47
INFINITY_SIGNATURE = b"\xc0" + b"\x00" * 95
# decompressed, subgroup-checked pubkeys (and decompressed signatures) kept by
# their bytes: an oracle parse is a square root (and a subgroup check) in
# Python, and block processing re-reads the same sync committee every block
PUBKEY_PARSE_CACHE = 8192

_BACKEND = "device"
_DEVICE = None  # None: CUDA (device.resolve_device)
_KARABINA = False
_MESH = None  # None: the single-device path; else a list of torch devices


def set_backend(name: str, *, device=None, karabina: bool | None = None,
                mesh_devices=None) -> None:
    """Select the backend; ``device`` is where ``"device"`` runs when a call
    names none (the counterpart of the reference's JAX default device);
    ``karabina`` puts the device backend's final exponentiations on
    Karabina squaring (the reference's LIGHTHOUSE_PAIRING_KARABINA=1, off
    until a call turns it on, as there); None keeps the switch as it is.
    ``mesh_devices`` (the reference's LIGHTHOUSE_MESH_DEVICES) is the
    serving mesh of the device backend, an explicit device list floored to
    a power of two (``bls.mesh.mesh_devices``): an empty list or one entry
    turns the mesh off, and the path stays the single-device one; None
    keeps the mesh as it is, as for ``karabina`` (off until a call sets
    it)."""
    global _BACKEND, _DEVICE, _KARABINA, _MESH
    if name not in ("device", "oracle", "native"):
        raise ValueError(f"unknown bls backend {name!r}")
    if mesh_devices is not None:
        from .mesh import mesh_devices as _mesh_of

        _MESH = _mesh_of(mesh_devices)
    _BACKEND = name
    _DEVICE = device
    if karabina is not None:
        _KARABINA = bool(karabina)


def get_backend() -> str:
    return _BACKEND


def get_device():
    return _DEVICE


def get_mesh():
    """The device backend's serving mesh (a list of ``torch.device``s), or
    None when the mesh is off."""
    return None if _MESH is None else list(_MESH)


def get_karabina() -> bool:
    return _KARABINA


def _native():
    from ..native import NativeBls

    return NativeBls()


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
        return _parse_pubkey(bytes(data))

    def serialize(self) -> bytes:
        return _oc.g1_compress(self.point)

    def __hash__(self):
        return hash(self.point)


@functools.lru_cache(maxsize=PUBKEY_PARSE_CACHE)
def _parse_pubkey(data: bytes) -> PublicKey:
    """Parse and validate 48 bytes (a failure raises and is not kept)."""
    try:
        pt = _oc.g1_decompress(data)
    except ValueError as e:
        raise BlsError(str(e)) from None
    if pt is None or not _oc.g1_in_subgroup(pt):
        raise BlsError("pubkey not a valid subgroup point")
    return PublicKey(pt)


@functools.lru_cache(maxsize=PUBKEY_PARSE_CACHE)
def g2_point(data: bytes):
    """``oracle.curves.g2_decompress`` kept by its bytes (a ValueError is
    raised and not kept): every node of a process, its pools and its
    verifies parse the same gossip signature."""
    return _oc.g2_decompress(data)


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
            return cls(g2_point(bytes(data)))
        except ValueError as e:
            raise BlsError(str(e)) from None

    def serialize(self) -> bytes:
        return _oc.g2_compress(self.point)

    def verify(self, pubkey: PublicKey, message: bytes) -> bool:
        if _BACKEND == "native":
            return _native().verify(pubkey.serialize(), message, _oc.g2_compress(self.point))
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
        if _BACKEND == "native":
            return _native().fast_aggregate_verify(
                [pk.serialize() for pk in pubkeys], message, _oc.g2_compress(self.point)
            )
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
        if _BACKEND == "native":
            return Signature.from_bytes(_native().sign(self.serialize(), message))
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


def _verify_sets_native(sets) -> bool:
    import secrets

    from .backend import RAND_BITS

    try:
        return _native().verify_signature_sets(
            [[pk.serialize() for pk in s.signing_keys] for s in sets],
            [s.message for s in sets],
            [s.signature.serialize() for s in sets],
            [secrets.randbits(RAND_BITS) or 1 for _ in sets],
        )
    except ValueError:  # malformed input (a non-32-byte message): a False verdict
        return False


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


def verify_prepared_sets(prepared, *, scalars=None, mesh=None) -> bool:
    """The device arm's device half on ``prepare_sets``' output: per-set
    pubkey aggregation (``aggregate_stage``), padding of the aggregates by
    broadcast, then ``verify_signature_sets_device_h2c``, or, over a
    ``mesh`` (a device list), ``sharded.verify_signature_sets_sharded_h2c``
    (reference :249-259). ``scalars`` (one uint64 per padded row) injects
    the RLC scalars (tests); None draws them."""
    import torch

    from .backend import aggregate_stage, verify_signature_sets_device_h2c

    if prepared is None:
        return False
    pks, mask, sig, u0, u1, n = prepared
    pk_agg = aggregate_stage(pks, mask)
    n_pad = sig.shape[0]
    if n_pad > n:
        pk_agg = torch.cat([pk_agg, pk_agg[:1].expand((n_pad - n,) + pk_agg.shape[1:])])
    if mesh is not None:
        from .sharded import verify_signature_sets_sharded_h2c

        return verify_signature_sets_sharded_h2c(pk_agg, sig, u0, u1, n, mesh, scalars=scalars)
    return verify_signature_sets_device_h2c(pk_agg, sig, u0, u1, n, scalars=scalars)


def verify_signature_sets(sets, *, device=None) -> bool:
    """Random-linear-combination batch verification over the active backend.
    ``device`` (default: ``set_backend``'s, else CUDA) is where the device
    backend runs."""
    sets = list(sets)
    if _BACKEND == "oracle":
        return _verify_sets_oracle(sets)
    if _BACKEND == "native":
        return _verify_sets_native(sets)
    prepared = prepare_sets(sets, _DEVICE if device is None else device)
    return verify_prepared_sets(prepared, mesh=_MESH)


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
