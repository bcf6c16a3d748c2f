"""The port's serving mesh (``bls/mesh.py``) and sharded verify
(``bls/sharded.py``) on a CPU mesh ``[cpu] * n``.

The host stage equals the reference's ``stage_indexed_shards`` array for
array; the sharded verdicts, combined and per shard, equal the port's
single-device verify and the oracle on a ragged valid batch, a poisoned set
(which condemns only its shard), an empty shard (False alone) and 3-set
aggregate groups. The kernels run their plain versions here (CPU tensors),
each shard a whole plain-version check, so the file runs three sharded
verifies and one single-device verify; the card runs them in
``chip_smoke.py`` phase 23.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.bls import tpu_backend as r_backend

from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.bls import backend, mesh, pubkey_cache, sharded
from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc
from lighthouse_tpu_torch.oracle.fields import R

SKS = [(0x3E5 << 40) + 7919 * i for i in range(12)]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache():
    pks = [cs.sk_to_pk(s) for s in SKS]
    raw = np.array(
        [list(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")) for p in pks], dtype=np.uint8)
    return pubkey_cache.device_pubkeys_from_raw(raw, device="cpu")


def _set(indices, msg, signed_msg=None):
    sk = sum(SKS[i] for i in indices) % R
    sig = cs.sign(sk, signed_msg if signed_msg is not None else msg)
    return (list(indices), msg, oc.g2_compress(sig))


def _msg(i: int) -> bytes:
    return bytes([i]) * 32


@pytest.fixture(scope="module")
def sets():
    """A ragged batch (1, 2 and 3 keys), a poisoned set (signed over another
    message) and an aggregate's group of three sets."""
    return {
        "ragged": [_set([0, 1], _msg(1)), _set([2], _msg(2)), _set([3, 4, 5], _msg(3))],
        "poisoned": _set([6], _msg(6), signed_msg=_msg(66)),
        "group": [_set([7], _msg(7)), _set([8], _msg(8)), _set([9, 10, 11], _msg(9))],
    }


def _oracle(items) -> bool:
    pts = [cs.sk_to_pk(s) for s in SKS]
    return cs.verify_signature_sets([
        cs.SignatureSet(oc.g2_decompress(sb), [pts[i] for i in ix], m) for ix, m, sb in items
    ])


def test_mesh_is_an_explicit_device_list(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_MESH_DEVICES", "8")  # read by nothing in the port
    assert mesh.mesh_devices(None) is None and mesh.mesh_devices([]) is None
    assert mesh.mesh_devices(["cpu"]) is None
    assert mesh.mesh_devices(["cpu"] * 3) == [CPU] * 2
    assert mesh.mesh_devices(["cpu"] * 7) == [CPU] * 4
    assert mesh.mesh_devices(["cuda:0", "cuda:1"]) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert [mesh.pow2_floor(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 2, 4, 8, 8]
    assert mesh.parse_mesh_devices("cuda:0, cuda:1") == ["cuda:0", "cuda:1"]
    assert mesh.parse_mesh_devices("") is None and mesh.parse_mesh_devices(None) is None
    prev = (bls.get_backend(), bls.get_device(), bls.get_mesh())
    try:
        bls.set_backend("device", device="cpu", mesh_devices=[])
        assert bls.get_mesh() is None
        bls.set_backend("device", device="cpu", mesh_devices=["cpu"] * 4)
        assert bls.get_mesh() == [CPU] * 4
    finally:
        bls.set_backend(prev[0], device=prev[1], mesh_devices=prev[2] or [])


def test_cache_replicated_once_per_distinct_device(cache):
    reps = mesh.replicate(cache, [CPU] * 4)
    assert all(r is cache for r in reps)
    mb = mesh.make_mesh_backend(lambda: cache, [CPU] * 4)
    assert all(c is cache for c in mb.caches((0, 1, 2, 3)))
    mb.probe(3)


def test_stage_matches_reference(sets):
    """Shard 0 ragged, shard 1 the poisoned set, shard 2 empty, shard 3 the
    group, at cap 4 with the same scalars: every array equals the
    reference's (its scalar draw replaced by the injected ones)."""
    shard_items = [sets["ragged"], [sets["poisoned"]], [], sets["group"]]
    scalars = np.arange(1, 17, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    got = sharded.stage_indexed_shards(shard_items, 4, scalars=scalars)
    want = r_backend.stage_indexed_shards(shard_items, 4)
    assert (got["n_pad"], got["k_pad"]) == (want["n_pad"], want["k_pad"]) == (16, 4)
    for k in ("idx", "mask", "u0", "u1", "x_c0", "x_c1", "s_flag", "sig_wf", "valid"):
        assert np.array_equal(np.asarray(got[k]).astype(np.int64),
                              np.asarray(want[k]).astype(np.int64)), k
    assert np.array_equal(got["scalars"], scalars)
    with pytest.raises(ValueError):
        sharded.stage_indexed_shards([sets["ragged"]], 2)


@pytest.mark.parametrize("n_dev,case", [(4, "ragged"), (2, "poisoned")])
def test_combined_verdict_equals_single_device_and_oracle(cache, sets, n_dev, case):
    """One combined verdict over the mesh (partials added and multiplied
    across shards, one final exponentiation) against the single-device
    verify and the oracle: the ragged batch on four shards, and the same
    batch with the poisoned set in it on two."""
    items = list(sets["ragged"]) + ([sets["poisoned"]] if case == "poisoned" else [])
    want = _oracle(items)
    assert want is (case == "ragged")
    assert sharded.verify_indexed_sets_sharded(cache, items, [CPU] * n_dev) is want
    if case == "poisoned":  # the valid batch's single-device verdict is pinned in test_torch_verify
        assert backend.verify_indexed_sets_device(cache, items, device="cpu") is want


def test_per_shard_verdicts_condemn_only_their_shard(cache, sets):
    """Four shards through the MeshBackend the chain builds, staged first
    (the firehose's prep-thread half) then dispatched: the 3-set group, the
    poisoned set and two empty shards. Only the group's shard is True, as
    the oracle judges each shard: the poisoned set and the empty shards
    condemn no other shard."""
    shard_items = [sets["group"], [sets["poisoned"]], [], []]
    mb = mesh.make_mesh_backend(lambda: cache, [CPU] * 4)
    staged = mb.stage(shard_items, (0, 1, 2, 3), 4)
    assert (staged["cap"], [sh["real"] for sh in staged["shards"]]) == (4, [True, True, False, False])
    got = mb.dispatch(None, (0, 1, 2, 3), staged=staged)
    assert got == [True, False, False, False]
    assert got == [bool(sh) and _oracle(sh) for sh in shard_items]
