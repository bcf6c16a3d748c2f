"""Engine-API JWT authentication (HS256).

The port's copy of ``lighthouse_tpu/execution_layer/auth.py`` (Lighthouse's
``execution_layer/src/engine_api/auth.rs``): the CL and EL share a
32-byte hex secret (the ``jwtsecret`` file); every engine-API HTTP request
carries ``Authorization: Bearer <jwt>`` where the JWT is HS256-signed with
an ``iat`` claim within +-60s of the EL's clock.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time

JWT_WINDOW_SECS = 60  # iat drift the server accepts (auth.rs parity)


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: bytes) -> bytes:
    return base64.urlsafe_b64decode(data + b"=" * (-len(data) % 4))


class JwtKey:
    """The shared 32-byte engine-API secret."""

    def __init__(self, secret: bytes):
        if len(secret) != 32:
            raise ValueError("jwt secret must be exactly 32 bytes")
        self.secret = secret

    @classmethod
    def from_hex(cls, text: str) -> "JwtKey":
        text = text.strip()
        if text.startswith("0x"):
            text = text[2:]
        return cls(bytes.fromhex(text))

    @classmethod
    def from_file(cls, path: str) -> "JwtKey":
        with open(path) as f:
            return cls.from_hex(f.read())

    @classmethod
    def generate(cls, path: str | None = None) -> "JwtKey":
        key = cls(os.urandom(32))
        if path is not None:
            with open(path, "w") as f:
                f.write("0x" + key.secret.hex())
        return key

    def generate_token(self, iat: int | None = None) -> str:
        """Fresh HS256 JWT with an ``iat`` claim (auth.rs generate_token)."""
        header = _b64url(json.dumps({"typ": "JWT", "alg": "HS256"}).encode())
        claims = _b64url(
            json.dumps({"iat": int(iat if iat is not None else time.time())}).encode()
        )
        signing_input = header + b"." + claims
        sig = hmac.new(self.secret, signing_input, hashlib.sha256).digest()
        return (signing_input + b"." + _b64url(sig)).decode()

    def validate_token(self, token: str, now: int | None = None) -> bool:
        """Server-side check: signature + iat window. Constant-time compare."""
        try:
            header_b, claims_b, sig_b = token.encode().split(b".")
            expected = hmac.new(
                self.secret, header_b + b"." + claims_b, hashlib.sha256
            ).digest()
            if not hmac.compare_digest(expected, _b64url_decode(sig_b)):
                return False
            header = json.loads(_b64url_decode(header_b))
            if header.get("alg") != "HS256":
                return False
            claims = json.loads(_b64url_decode(claims_b))
            iat = int(claims["iat"])
        except (ValueError, KeyError):
            return False
        now = int(now if now is not None else time.time())
        return abs(now - iat) <= JWT_WINDOW_SECS
