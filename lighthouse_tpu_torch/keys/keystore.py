"""EIP-2335 keystores (scrypt/pbkdf2 + AES-128-CTR + sha256 checksum): the
port's copy of ``lighthouse_tpu/keys/keystore.py``.

Lighthouse's ``crypto/eth2_keystore`` (``Keystore::{encrypt, decrypt}``).
JSON layout, KDF parameters, and password normalization (NFKD,
control-char stripping) match the EIP so keystores interchange with the
reference and other clients.
"""

from __future__ import annotations

import hashlib
import json
import os
import unicodedata
import uuid

try:  # gated: interop-key flows (vc --interop-validators) need no AES at all
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - environment-dependent
    Cipher = algorithms = modes = None
    _HAVE_CRYPTOGRAPHY = False

from ..oracle import ciphersuite as _cs
from ..oracle import curves as _oc


class KeystoreError(Exception):
    pass


def normalize_password(password: str) -> bytes:
    """EIP-2335: NFKD normalize, strip C0/C1/DEL control codes."""
    norm = unicodedata.normalize("NFKD", password)
    stripped = "".join(
        c for c in norm
        if not (ord(c) < 0x20 or 0x7F <= ord(c) <= 0x9F)
    )
    return stripped.encode("utf-8")


def _aes128ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    if not _HAVE_CRYPTOGRAPHY:
        raise KeystoreError(
            "EIP-2335 keystore encryption needs the 'cryptography' package"
        )
    c = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return c.update(data) + c.finalize()


class Keystore:
    def __init__(self, obj: dict):
        self.obj = obj

    # -- construction -----------------------------------------------------------

    @classmethod
    def encrypt(
        cls,
        secret: bytes,
        password: str,
        path: str = "",
        kdf: str = "scrypt",
        pubkey: str | None = None,
        description: str = "",
    ) -> "Keystore":
        if len(secret) != 32:
            raise KeystoreError("secret must be 32 bytes")
        pw = normalize_password(password)
        salt = os.urandom(32)
        iv = os.urandom(16)
        if kdf == "scrypt":
            dk = hashlib.scrypt(pw, salt=salt, n=262144, r=8, p=1, dklen=32,
                                maxmem=512 * 1024 * 1024)
            kdf_module = {
                "function": "scrypt",
                "params": {"dklen": 32, "n": 262144, "p": 1, "r": 8,
                           "salt": salt.hex()},
                "message": "",
            }
        elif kdf == "pbkdf2":
            dk = hashlib.pbkdf2_hmac("sha256", pw, salt, 262144, dklen=32)
            kdf_module = {
                "function": "pbkdf2",
                "params": {"dklen": 32, "c": 262144, "prf": "hmac-sha256",
                           "salt": salt.hex()},
                "message": "",
            }
        else:
            raise KeystoreError(f"unsupported kdf {kdf}")
        cipher_message = _aes128ctr(dk[:16], iv, secret)
        checksum = hashlib.sha256(dk[16:32] + cipher_message).digest()
        if pubkey is None:
            sk = int.from_bytes(secret, "big")
            pubkey = _oc.g1_compress(_cs.sk_to_pk(sk)).hex()
        obj = {
            "crypto": {
                "kdf": kdf_module,
                "checksum": {
                    "function": "sha256", "params": {},
                    "message": checksum.hex(),
                },
                "cipher": {
                    "function": "aes-128-ctr",
                    "params": {"iv": iv.hex()},
                    "message": cipher_message.hex(),
                },
            },
            "description": description,
            "pubkey": pubkey,
            "path": path,
            "uuid": str(uuid.uuid4()),
            "version": 4,
        }
        return cls(obj)

    def decrypt(self, password: str) -> bytes:
        crypto = self.obj["crypto"]
        pw = normalize_password(password)
        kdf = crypto["kdf"]
        params = kdf["params"]
        salt = bytes.fromhex(params["salt"])
        if kdf["function"] == "scrypt":
            dk = hashlib.scrypt(
                pw, salt=salt, n=params["n"], r=params["r"], p=params["p"],
                dklen=params["dklen"], maxmem=512 * 1024 * 1024,
            )
        elif kdf["function"] == "pbkdf2":
            if params.get("prf", "hmac-sha256") != "hmac-sha256":
                raise KeystoreError("unsupported prf")
            dk = hashlib.pbkdf2_hmac(
                "sha256", pw, salt, params["c"], dklen=params["dklen"]
            )
        else:
            raise KeystoreError(f"unsupported kdf {kdf['function']}")
        cipher_message = bytes.fromhex(crypto["cipher"]["message"])
        checksum = hashlib.sha256(dk[16:32] + cipher_message).digest()
        if checksum.hex() != crypto["checksum"]["message"]:
            raise KeystoreError("invalid password (checksum mismatch)")
        if crypto["cipher"]["function"] != "aes-128-ctr":
            raise KeystoreError("unsupported cipher")
        iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
        return _aes128ctr(dk[:16], iv, cipher_message)

    # -- (de)serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(self.obj)

    @classmethod
    def from_json(cls, data: str) -> "Keystore":
        obj = json.loads(data)
        if obj.get("version") != 4:
            raise KeystoreError("unsupported keystore version")
        return cls(obj)

    @property
    def pubkey(self) -> str:
        return self.obj["pubkey"]

    @property
    def path(self) -> str:
        return self.obj.get("path", "")

    @property
    def uuid(self) -> str:
        return self.obj["uuid"]
