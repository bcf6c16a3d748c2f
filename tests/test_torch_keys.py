"""The port's key stack against the reference's.

``lighthouse_tpu_torch.keys`` is the port's copy of ``lighthouse_tpu/keys/``:
EIP-2333 derivation (the EIP's test case 0, and both packages equal on
seeded seeds and paths), EIP-2335 keystores (the EIP's pbkdf2 vector; one
scrypt and one pbkdf2 keystore written by each package and decrypted by the
other; password normalization) and EIP-2386 wallets (``next_validator``
equal to the reference's on one seed, and each package's wallet opened by
the other).
"""

import json
import unicodedata

import numpy as np
import pytest
import torch

from lighthouse_tpu import keys as rk
from lighthouse_tpu.keys import keystore as rks
from lighthouse_tpu.ops.bls_oracle import ciphersuite as r_cs
from lighthouse_tpu.ops.bls_oracle import curves as r_oc
from lighthouse_tpu.ops.bls_oracle.fields import R
from lighthouse_tpu_torch import keys as pk
from lighthouse_tpu_torch.keys import keystore as pks

SEED = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eip2333_vector():
    seed = bytes.fromhex(
        "c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708e5349553"
        "1f09a6987599d18264c1e1c92f2cf141630c7a3c4ab7c81b2f001698e7463b04"
    )
    master = pk.derive_master_sk(seed)
    assert master == 6083874454709270928345386274498605044986640685124978867557563392430687146096
    assert pk.derive_child_sk(master, 0) == (
        20397789859736650942317412262472558107875392172444076792671091975210932703118)


def test_derivation_equals_the_reference_on_seeded_seeds_and_paths():
    rng = np.random.default_rng(SEED)
    for _ in range(3):
        seed = rng.bytes(int(rng.integers(32, 65)))
        i, j = (int(x) for x in rng.integers(0, 2**32, 2))
        for path in (f"m/12381/3600/{i % 64}/0/0", f"m/12381/3600/{i}/{j}", "m/12381/60/0/0"):
            assert pk.path_to_nodes(path) == rk.path_to_nodes(path)
            assert pk.derive_sk_from_path(seed, path) == rk.derive_sk_from_path(seed, path)
        assert pk.derive_master_sk(seed) == rk.derive_master_sk(seed)
    for bad in ("x/12381", "m/12381/a", f"m/{2**32}", "m/-1"):
        with pytest.raises(ValueError):
            pk.path_to_nodes(bad)
        with pytest.raises(ValueError):
            rk.path_to_nodes(bad)
    with pytest.raises(ValueError):
        pk.derive_master_sk(b"\x01" * 31)


EIP2335_PBKDF2 = {
    "crypto": {
        "kdf": {
            "function": "pbkdf2",
            "params": {
                "dklen": 32, "c": 262144, "prf": "hmac-sha256",
                "salt": "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3",
            },
            "message": "",
        },
        "checksum": {
            "function": "sha256", "params": {},
            "message": "8a9f5d9912ed7e75ea794bc5a89bca5f193721d30868ade6f73043c6ea6febf1",
        },
        "cipher": {
            "function": "aes-128-ctr",
            "params": {"iv": "264daa3f303d7259501c93d997d84fe6"},
            "message": "cee03fde2af33149775b7223e7845e4fb2c8ae1792e5f99fe9ecf474cc8c16ad",
        },
    },
    "description": "This is a test keystore that uses PBKDF2 to secure the secret.",
    "pubkey": "9612d7a727c9d0a22e185a1c768478dfe919cada9266988cb32359c11f2b7b27f4ae4040902382ae2910c15e2b420d07",
    "path": "m/12381/60/0/0",
    "uuid": "64625def-3331-4eea-ab6f-782f3ed16a83",
    "version": 4,
}
# the EIP's password: fraktur "testpassword" and the KEY emoji
EIP2335_PASSWORD = ("\U0001D531\U0001D522\U0001D530\U0001D531\U0001D52D\U0001D51E"
                    "\U0001D530\U0001D530\U0001D534\U0001D52C\U0001D52F\U0001D521\U0001F511")


def test_eip2335_pbkdf2_vector():
    assert unicodedata.normalize("NFKD", EIP2335_PASSWORD) == "testpassword\U0001F511"
    ks = pk.Keystore.from_json(json.dumps(EIP2335_PBKDF2))
    assert (ks.pubkey, ks.path, ks.uuid) == (EIP2335_PBKDF2["pubkey"], "m/12381/60/0/0",
                                             EIP2335_PBKDF2["uuid"])
    assert ks.decrypt(EIP2335_PASSWORD).hex() == (
        "000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")
    with pytest.raises(pk.KeystoreError):
        ks.decrypt("testpassword")
    with pytest.raises(pk.KeystoreError):
        pk.Keystore.from_json(json.dumps({**EIP2335_PBKDF2, "version": 3}))


def test_normalize_password_equals_the_reference():
    for pw in ("", "p@ssw0rd", EIP2335_PASSWORD, "a\x00b\x1fc\x7fd\x9fe\xa0f", "é́",
               "ﬁ ligature", "tab\there"):
        assert pks.normalize_password(pw) == rks.normalize_password(pw)


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_keystore_written_by_one_package_decrypts_in_the_other(kdf, writer):
    rng = np.random.default_rng([SEED, kdf == "scrypt", writer == "port"])
    sk = int.from_bytes(rng.bytes(32), "big") % R
    secret = sk.to_bytes(32, "big")
    password = "pass \U0001D531 \x07" + rng.bytes(4).hex()
    src, dst = (pk, rk) if writer == "port" else (rk, pk)
    ks = src.Keystore.encrypt(secret, password, path="m/12381/3600/3/0/0", kdf=kdf,
                              description="seeded")
    other = dst.Keystore.from_json(ks.to_json())
    assert other.decrypt(password) == secret
    assert (other.pubkey, other.path, other.uuid) == (ks.pubkey, ks.path, ks.uuid)
    if kdf == "pbkdf2":  # a wrong password fails the checksum (an scrypt costs ~1 s)
        with pytest.raises(dst.KeystoreError):
            other.decrypt(password + "x")
    # the pubkey field is the secret's, as the reference's oracle computes it
    assert ks.pubkey == r_oc.g1_compress(r_cs.sk_to_pk(sk)).hex()
    layout = json.loads(ks.to_json())
    assert sorted(layout) == sorted(EIP2335_PBKDF2) and layout["version"] == 4
    assert layout["crypto"]["kdf"]["function"] == kdf
    assert sorted(layout["crypto"]["kdf"]["params"]) == sorted(
        {"scrypt": ["dklen", "n", "p", "r", "salt"],
         "pbkdf2": ["dklen", "c", "prf", "salt"]}[kdf])


def test_wallet_next_validator_equals_the_reference():
    seed = np.random.default_rng(SEED).bytes(32)
    pw, wallets = "wallet pw", {}
    for name, mod in (("port", pk), ("reference", rk)):
        w = mod.Wallet.create("w", pw, seed=seed)
        v0, wd0 = w.next_validator(pw, "voting pw", "withdrawal pw")
        assert w.nextaccount == 1 and w.name == "w"
        wallets[name] = (w, v0, wd0)
    (pw_, pv, pwd), (rw, rv, rwd) = wallets["port"], wallets["reference"]
    assert (pv.path, pwd.path) == (rv.path, rwd.path) == ("m/12381/3600/0/0/0", "m/12381/3600/0/0")
    assert (pv.pubkey, pwd.pubkey) == (rv.pubkey, rwd.pubkey)
    assert pv.decrypt("voting pw") == rv.decrypt("voting pw") == rk.derive_sk_from_path(
        seed, "m/12381/3600/0/0/0").to_bytes(32, "big")
    assert pwd.decrypt("withdrawal pw") == rwd.decrypt("withdrawal pw")
    # each package opens the other's wallet and derives on from it
    back = rk.Wallet.from_json(pw_.to_json())
    assert back.nextaccount == 1 and back.decrypt_seed(pw) == seed
    fwd = pk.Wallet.from_json(rw.to_json())
    assert fwd.decrypt_seed(pw) == seed
    v1, _ = fwd.next_validator(pw, "v")
    assert fwd.nextaccount == 2 and v1.path == "m/12381/3600/1/0/0"
    assert int.from_bytes(v1.decrypt("v"), "big") == rk.derive_sk_from_path(seed, v1.path)
    with pytest.raises(pk.KeystoreError):
        pk.Wallet.from_json(json.dumps({**pw_.obj, "version": 2}))
