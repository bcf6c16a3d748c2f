"""The sharded verify's shard-local bodies against the reference's.

``sharded.local_prep_partials`` and ``sharded.local_pair_verdict`` are held
to ``tpu_backend._local_prep_partials`` and ``_local_pair_verdict``, jitted
and called without ``shard_map``, at one shard's shape (cap 4, k 2, an
8-key registry) with the same injected scalars: the scaled affine keys, the
signature partial sum and the set check equal canonically, and the verdicts
are equal, on a valid shard and on one with a poisoned set. The reference's
pairing program compiles once for both cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.beacon_chain.pubkey_cache import device_pubkeys_from_raw as r_cache_from_raw
from lighthouse_tpu.bls import tpu_backend as r_backend

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.bls import backend, pubkey_cache, sharded
from lighthouse_tpu_torch.ops.bls import fq
from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc
from lighthouse_tpu_torch.oracle.fields import P, R

SKS = [(0x5EED << 20) + 977 * i for i in range(8)]
SCALARS = np.array([(1 << 64) - 3, 0x1234_5678_9ABC_DEF1, 1 << 63, 5], dtype=np.uint64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def caches():
    pks = [cs.sk_to_pk(s) for s in SKS]
    raw = np.array(
        [list(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")) for p in pks], dtype=np.uint8)
    return r_cache_from_raw(raw), pubkey_cache.device_pubkeys_from_raw(raw, device="cpu")


@pytest.fixture(scope="module")
def ref_fns():
    return jax.jit(r_backend._local_prep_partials), jax.jit(r_backend._local_pair_verdict)


def _set(indices, msg, signed_msg=None):
    sk = sum(SKS[i] for i in indices) % R
    sig = cs.sign(sk, signed_msg if signed_msg is not None else msg)
    return (indices, msg, oc.g2_compress(sig))


def _canon(x):
    return [fq.limbs_to_int(r) % P for r in np.asarray(x).reshape(-1, 25)]


SHARDS = {
    "valid": [_set([0, 1], b"\x01" * 32), _set([2], b"\x02" * 32), _set([3, 4], b"\x03" * 32)],
    "poisoned": [_set([0, 1], b"\x01" * 32), _set([5], b"\x05" * 32, b"\x55" * 32),
                 _set([6, 7], b"\x06" * 32)],
}
KEYS = ("idx", "mask", "x_c0", "x_c1", "s_flag", "sig_wf", "scalars", "valid")


@pytest.mark.parametrize("case", sorted(SHARDS))
def test_shard_local_bodies_match_reference(caches, ref_fns, case):
    r_cache, p_cache = caches
    r_prep, r_pair = ref_fns
    st = sharded.stage_indexed_shards([SHARDS[case]], 4, k_pad=2, scalars=SCALARS)
    assert (st["n_pad"], st["k_pad"]) == (4, 2)
    t = {k: torch.from_numpy(np.ascontiguousarray(st[k])) for k in KEYS if k != "scalars"}
    t["scalars"] = torch.from_numpy(SCALARS.view(np.int64).copy())
    got = sharded.local_prep_partials(p_cache, *(t[k] for k in KEYS))
    rst = dict(r_backend.stage_indexed_shards([SHARDS[case]], 4, k_pad=2), scalars=SCALARS)
    want = r_prep(r_cache, *(jnp.asarray(rst[k]) for k in KEYS))
    for name, g, w in zip(("pkx", "pky", "sig_part"), got[:3], want[:3]):
        assert _canon(convert.to_numpy(g)) == _canon(w), name
    assert bool(got[3][0]) == bool(want[3][0]) is True

    # the message points: the port's h2c stage (pinned to the reference's in
    # tests/test_torch_verify.py), canonical, feed both pairing epilogues
    mx, my = backend.h2c_stage(torch.from_numpy(st["u0"]), torch.from_numpy(st["u1"]))
    mx, my = fq.canonical(mx), fq.canonical(my)
    ok = sharded.local_pair_verdict(got[0], got[1], mx, my, got[2][0], got[3][0], t["valid"])
    r_ok = r_pair(want[0], want[1], jnp.asarray(convert.to_numpy(mx)),
                  jnp.asarray(convert.to_numpy(my)), want[2][0], want[3][0],
                  jnp.asarray(rst["valid"]))
    assert bool(ok) == bool(r_ok) == (case == "valid")
