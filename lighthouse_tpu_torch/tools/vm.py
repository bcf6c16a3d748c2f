"""The validator manager (Lighthouse's ``validator_manager/``): the port's copy
of the validator-manager part of ``lighthouse_tpu/tools.py``.

  * ``vm_create``: derive EIP-2333 keys from a seed and write EIP-2335
    keystores (``keystore-{i}.json``);
  * ``vm_import``: POST a keystore directory to a running validator client's
    keymanager API;
  * ``vm_list``: the keystores that keymanager holds.

Reached through ``python -m lighthouse_tpu_torch validator-manager``
(alias ``vm``) ``create|import|list``.
"""

from __future__ import annotations

import json
import os
import urllib.request


def vm_create(output_dir: str, count: int, password: str, seed_hex: str | None,
              first_index: int = 0) -> list[str]:
    """Bulk-create EIP-2335 keystores (validator_manager create)."""
    from ..keys.derivation import derive_sk_from_path
    from ..keys.keystore import Keystore

    os.makedirs(output_dir, exist_ok=True)
    seed = bytes.fromhex(seed_hex) if seed_hex else os.urandom(32)
    written = []
    for i in range(first_index, first_index + count):
        path = f"m/12381/3600/{i}/0/0"
        sk = derive_sk_from_path(seed, path)
        ks = Keystore.encrypt(sk.to_bytes(32, "big"), password, path=path)
        name = f"keystore-{i}.json"
        with open(os.path.join(output_dir, name), "w") as fh:
            fh.write(ks.to_json())
        written.append(name)
    return written


def vm_import(keystores_dir: str, password: str, vc_url: str) -> list[dict]:
    """Import a keystore directory into a running VC through the keymanager
    API (validator_manager import)."""
    keystores, passwords = [], []
    for name in sorted(os.listdir(keystores_dir)):
        if not (name.startswith("keystore") and name.endswith(".json")):
            continue
        with open(os.path.join(keystores_dir, name)) as fh:
            keystores.append(fh.read())
        passwords.append(password)
    body = json.dumps(
        {"keystores": keystores, "passwords": passwords}
    ).encode()
    req = urllib.request.Request(
        vc_url.rstrip("/") + "/eth/v1/keystores", data=body, method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read().decode())["data"]


def vm_list(vc_url: str) -> list[dict]:
    with urllib.request.urlopen(
        vc_url.rstrip("/") + "/eth/v1/keystores", timeout=30
    ) as resp:
        return json.loads(resp.read().decode())["data"]
