"""EIP-2386 hierarchical wallets over EIP-2335 keystores and EIP-2333 paths:
the port's copy of ``lighthouse_tpu/keys/wallet.py``.

Lighthouse's ``crypto/eth2_wallet`` (``Wallet``): an encrypted seed plus a
``nextaccount`` counter; validator keys derive at m/12381/3600/{i}/0/0
(voting) and .../0 (withdrawal).
"""

from __future__ import annotations

import json
import os
import uuid as _uuid

from .derivation import derive_sk_from_path
from .keystore import Keystore, KeystoreError


class Wallet:
    def __init__(self, obj: dict):
        self.obj = obj

    @classmethod
    def create(
        cls, name: str, password: str, seed: bytes | None = None,
        kdf: str = "pbkdf2",
    ) -> "Wallet":
        seed = seed if seed is not None else os.urandom(32)
        ks = Keystore.encrypt(seed, password, kdf=kdf, pubkey="")
        obj = {
            "crypto": ks.obj["crypto"],
            "name": name,
            "nextaccount": 0,
            "type": "hierarchical deterministic",
            "uuid": str(_uuid.uuid4()),
            "version": 1,
        }
        return cls(obj)

    def decrypt_seed(self, password: str) -> bytes:
        ks = Keystore({"crypto": self.obj["crypto"], "version": 4,
                       "pubkey": "", "uuid": self.obj["uuid"]})
        return ks.decrypt(password)

    def next_validator(
        self, wallet_password: str, voting_password: str,
        withdrawal_password: str | None = None,
    ):
        """Derive the next validator's keystores; bumps nextaccount."""
        seed = self.decrypt_seed(wallet_password)
        i = self.obj["nextaccount"]
        voting_path = f"m/12381/3600/{i}/0/0"
        withdrawal_path = f"m/12381/3600/{i}/0"
        voting_sk = derive_sk_from_path(seed, voting_path)
        withdrawal_sk = derive_sk_from_path(seed, withdrawal_path)
        voting = Keystore.encrypt(
            voting_sk.to_bytes(32, "big"), voting_password,
            path=voting_path, kdf="pbkdf2",
        )
        withdrawal = Keystore.encrypt(
            withdrawal_sk.to_bytes(32, "big"),
            withdrawal_password or voting_password,
            path=withdrawal_path, kdf="pbkdf2",
        )
        self.obj["nextaccount"] = i + 1
        return voting, withdrawal

    def to_json(self) -> str:
        return json.dumps(self.obj)

    @classmethod
    def from_json(cls, data: str) -> "Wallet":
        obj = json.loads(data)
        if obj.get("version") != 1:
            raise KeystoreError("unsupported wallet version")
        return cls(obj)

    @property
    def name(self) -> str:
        return self.obj["name"]

    @property
    def nextaccount(self) -> int:
        return self.obj["nextaccount"]
