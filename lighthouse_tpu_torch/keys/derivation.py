"""EIP-2333 hierarchical BLS key derivation: the port's copy of
``lighthouse_tpu/keys/derivation.py``.

Lighthouse's ``crypto/eth2_key_derivation`` (``DerivedKey``): the
lamport-from-parent tree with hkdf_mod_r at each node, plus EIP-2334 path
parsing (m/12381/3600/i/0/0 style paths).
"""

from __future__ import annotations

import hashlib
import hmac

from ..oracle.fields import R as CURVE_ORDER

_SALT = b"BLS-SIG-KEYGEN-SALT-"


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    salt = _SALT
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % CURVE_ORDER
    return sk


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes) -> list[bytes]:
    prk = _hkdf_extract(salt, ikm)
    okm = _hkdf_expand(prk, b"", 255 * 32)
    return [okm[i * 32 : (i + 1) * 32] for i in range(255)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport_0 = _ikm_to_lamport_sk(ikm, salt)
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport_1 = _ikm_to_lamport_sk(not_ikm, salt)
    combined = b"".join(
        hashlib.sha256(chunk).digest() for chunk in lamport_0 + lamport_1
    )
    return hashlib.sha256(combined).digest()


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("seed must be >= 32 bytes (EIP-2333)")
    return hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    return hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def path_to_nodes(path: str) -> list[int]:
    """EIP-2334 path 'm/12381/3600/0/0/0' -> node indices."""
    parts = path.strip().split("/")
    if parts[0] != "m":
        raise ValueError("path must start with m")
    nodes = []
    for p in parts[1:]:
        if not p.isdigit():
            raise ValueError(f"invalid path node {p!r}")
        n = int(p)
        if n >= 2**32:
            raise ValueError("node out of range")
        nodes.append(n)
    return nodes


def derive_sk_from_path(seed: bytes, path: str) -> int:
    sk = derive_master_sk(seed)
    for node in path_to_nodes(path):
        sk = derive_child_sk(sk, node)
    return sk
