"""The whole slice: batched signature-set verification, port vs reference.

A small fixture (8 validators, up to 4 sets of 1-3 keys, signatures from the
oracle) goes through the reference ``tpu_backend`` and the port's
``bls.backend`` on the CPU. Every case pads to n_pad = 4, k_pad = 4, so the
reference compiles its three stages once for the whole file.

* With injected RLC scalars (including ones >= 2^63) the stage outputs —
  message points, pkx/pky/sax/say, set_ok, the verdict — equal the
  reference's as canonical values.
* ``verify_indexed_sets_device`` gives the reference's verdict on a valid
  batch, a poisoned signature, a malformed flag byte, an infinity signature,
  an empty index list and 3 sets (padded to 4).
* The aggregation and prologue stages (the entry of
  ``bls.verify_signature_sets``) equal the reference's
  ``_aggregate_kernel(4)`` and ``_prologue_stage(4)`` under injected
  scalars.
* The port (its ``bls``, ``firehose``, ``resilience``, ``utils`` and
  ``beacon_processor`` packages too) imports neither jax nor
  lighthouse_tpu, and its default device (CUDA) raises where CUDA is
  absent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu.beacon_chain.pubkey_cache import device_pubkeys_from_raw as r_cache_from_raw
from lighthouse_tpu.bls import serde as r_serde, tpu_backend as r_backend
from lighthouse_tpu.ops.bls import h2c as r_h2c
from lighthouse_tpu.ops.bls_oracle.ciphersuite import DST as R_DST

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.bls import backend, pubkey_cache
from lighthouse_tpu_torch.ops.bls import fq
from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc
from lighthouse_tpu_torch.oracle.fields import P, R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKS = [(0x5EED << 20) + 977 * i for i in range(8)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tests run at small shapes: one intra-op thread keeps torch
    from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def registry():
    pks = [cs.sk_to_pk(s) for s in SKS]
    raw = np.array(
        [list(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")) for p in pks],
        dtype=np.uint8,
    )
    ref_cache = r_cache_from_raw(raw)
    port_cache = pubkey_cache.device_pubkeys_from_raw(raw, device="cpu")
    return raw, ref_cache, port_cache


def _set(indices, msg, signed_msg=None):
    sk = sum(SKS[i] for i in indices) % R
    sig = cs.sign(sk, signed_msg if signed_msg is not None else msg)
    return (indices, msg, oc.g2_compress(sig))


@pytest.fixture(scope="module")
def batch():
    return [
        _set([0, 1], b"\x01" * 32),
        _set([2], b"\x02" * 32),
        _set([3, 4, 5], b"\x03" * 32),
        _set([6, 7], b"\x04" * 32),
    ]


def _ref_inputs(items, scalars):
    """The reference's host half of verify_indexed_sets_device
    (tpu_backend.py:322-371), with the scalars injected."""
    n = len(items)
    n_pad = r_backend.bucket(n)
    k_pad = r_backend.bucket(max(len(ix) for ix, _, _ in items))
    idx = np.zeros((n_pad, k_pad), dtype=np.int32)
    mask = np.zeros((n_pad, k_pad), dtype=bool)
    sig_bytes = np.zeros((n_pad, 96), dtype=np.uint8)
    msgs = []
    for i, (indices, msg, sb) in enumerate(items):
        if indices:
            idx[i, : len(indices)] = indices
            mask[i, : len(indices)] = True
        msgs.append(msg)
        sig_bytes[i] = np.frombuffer(sb, dtype=np.uint8)
    parsed = r_serde.parse_g2_bytes(sig_bytes)
    sig_wf = parsed["wf_ok"] & ~parsed["is_inf"]
    u0, u1 = r_h2c.hash_to_field_batch(msgs, R_DST)
    if n_pad > n:
        u0 = jnp.concatenate([u0, jnp.broadcast_to(u0[:1], (n_pad - n,) + u0.shape[1:])])
        u1 = jnp.concatenate([u1, jnp.broadcast_to(u1[:1], (n_pad - n,) + u1.shape[1:])])
    valid = np.arange(n_pad) < n
    return n_pad, k_pad, dict(
        u0=u0, u1=u1, idx=jnp.asarray(idx), mask=jnp.asarray(mask),
        sxc0=jnp.asarray(parsed["x_c0"]), sxc1=jnp.asarray(parsed["x_c1"]),
        s_flag=jnp.asarray(parsed["s_flag"]), sig_wf=jnp.asarray(sig_wf),
        scalars=jnp.asarray(scalars), valid=jnp.asarray(valid),
    )


def _canon(x):
    x = np.asarray(x).reshape(-1, 25)
    return [fq.limbs_to_int(r) % P for r in x]


def test_pubkey_cache_matches_reference(registry):
    raw, ref_cache, port_cache = registry
    assert (convert.to_numpy(port_cache) == np.asarray(ref_cache)).all()
    assert (convert.to_numpy(convert.to_torch(ref_cache, "cpu")) == np.asarray(ref_cache)).all()


def test_stage_outputs_match_reference(registry, batch):
    """Stages with the same injected scalars (two of them >= 2^63): every
    output equals the reference's canonically."""
    _, ref_cache, port_cache = registry
    scalars = np.array([(1 << 64) - 3, 0x1234_5678_9ABC_DEF1, 1 << 63, 5], dtype=np.uint64)
    n_pad, k_pad, ri = _ref_inputs(batch, scalars)
    assert (n_pad, k_pad) == (4, 4)
    rmx, rmy = r_backend._h2c_stage(n_pad)(ri["u0"], ri["u1"])
    rpre = r_backend._prep_stage(n_pad, k_pad)(
        ref_cache, ri["idx"], ri["mask"], ri["sxc0"], ri["sxc1"], ri["s_flag"],
        ri["sig_wf"], ri["scalars"], ri["valid"],
    )
    rok = r_backend._pair_stage(n_pad)(*rpre[:4], rmx, rmy, rpre[4], ri["valid"])

    b = backend.prepare_batch(batch, scalars, "cpu")
    for key in ("u0", "u1", "idx", "mask", "sxc0", "sxc1", "s_flag", "sig_wf", "valid"):
        assert (b[key].numpy() == np.asarray(ri[key])).all(), key
    mx, my = backend.h2c_stage(b["u0"], b["u1"])
    pre = backend.prep_stage(
        port_cache, b["idx"], b["mask"], b["sxc0"], b["sxc1"], b["s_flag"],
        b["sig_wf"], b["scalars"], b["valid"],
    )
    ok = backend.pair_stage(*pre[:4], mx, my, pre[4], b["valid"])
    assert _canon(convert.to_numpy(mx)) == _canon(rmx)
    assert _canon(convert.to_numpy(my)) == _canon(rmy)
    for name, got, want in zip(("pkx", "pky", "sax", "say"), pre[:4], rpre[:4]):
        assert _canon(convert.to_numpy(got)) == _canon(want), name
    assert (pre[4].numpy() == np.asarray(rpre[4])).all()
    assert bool(ok) == bool(rok) is True


def _off_subgroup_sig():
    from lighthouse_tpu_torch.oracle.fields import Fq2

    c0 = 3
    while (y := (Fq2(c0, 1).square() * Fq2(c0, 1) + Fq2(4, 4)).sqrt()) is None:
        c0 += 1
    assert not oc.g2_in_subgroup((Fq2(c0, 1), y))
    return (Fq2(c0, 1), y)


def test_aggregation_and_prologue_stages_match_reference():
    """The entry of ``bls.verify_signature_sets``: per-set pubkey
    aggregation (``aggregate_pubkeys_device``) and the prologue stage with
    injected scalars (one below 2^63, two above), against the reference's
    ``_aggregate_kernel(4)`` and ``_prologue_stage(4)``: equal canonical
    outputs. Set 1's signature lies outside the subgroup, so set_ok is
    False there in both. The h2c entry's verdict equals the reference's."""
    from lighthouse_tpu.ops.bls import g1 as r_g1, g2 as r_g2

    from lighthouse_tpu_torch.ops.bls import g1, g2, h2c

    key_sets = [[0, 1], [2], [3, 4, 5]]
    msgs = [bytes([0x50 + i]) * 32 for i in range(3)]
    sigs = [cs.sign(sum(SKS[i] for i in ks) % R, m) for ks, m in zip(key_sets, msgs)]
    sigs[1] = _off_subgroup_sig()
    pts = [[cs.sk_to_pk(SKS[i]) for i in ks] for ks in key_sets]
    scalars = np.array([0x0123_4567_89AB_CDEF, (1 << 64) - 7, 1 << 63, 9], dtype=np.uint64)
    valid = np.arange(4) < 3

    def pad(a, n=4):
        return np.concatenate([a, np.broadcast_to(a[:1], (n - a.shape[0],) + a.shape[1:])])

    r_agg = r_backend.aggregate_pubkeys_device([r_g1.from_oracle_batch(p) for p in pts])
    r_sig = r_g2.from_oracle_batch(sigs)
    r_agg4, r_sig4 = jnp.asarray(pad(np.asarray(r_agg))), jnp.asarray(pad(np.asarray(r_sig)))
    rpro = r_backend._prologue_stage(4)(
        r_agg4, r_sig4, jnp.asarray(scalars), jnp.asarray(valid)
    )

    agg = backend.aggregate_pubkeys_device([g1.from_oracle_batch(p, "cpu") for p in pts])
    sig = g2.from_oracle_batch(sigs, "cpu")
    agg4 = torch.cat([agg, agg[:1].expand(1, 3, 25)])
    sig4 = torch.cat([sig, sig[:1].expand(1, 6, 25)])
    pro = backend.prologue_stage(
        agg4, sig4, backend.scalars_to_torch(scalars, "cpu"), torch.from_numpy(valid)
    )
    assert _canon(convert.to_numpy(agg)) == _canon(r_agg)
    assert (convert.to_numpy(sig) == np.asarray(r_sig)).all()
    for name, got, want in zip(("pkx", "pky", "sax", "say"), pro[:4], rpro[:4]):
        assert _canon(convert.to_numpy(got)) == _canon(want), name
    assert pro[4].tolist() == np.asarray(rpro[4]).tolist() == [True, False, True, True]

    u0, u1 = h2c.hash_to_field_batch(msgs + msgs[:1], cs.DST, "cpu")
    ru0, ru1 = r_h2c.hash_to_field_batch(msgs + msgs[:1], R_DST)
    want = bool(r_backend._verify_kernel_h2c(4)(
        r_agg4, r_sig4, ru0, ru1, jnp.asarray(scalars), jnp.asarray(valid)
    ))
    got = backend.verify_signature_sets_device_h2c(agg4, sig4, u0, u1, 3, scalars=scalars)
    assert got == want is False
    sig4[1] = g2.from_oracle(cs.sign(SKS[2], msgs[1]), "cpu")
    assert backend.verify_signature_sets_device_h2c(agg4, sig4, u0, u1, 3, scalars=scalars)


def _poisoned(batch):
    out = list(batch)
    out[1] = _set([2], b"\x02" * 32, signed_msg=b"\x99" * 32)
    return out


def _malformed(batch):
    out = list(batch)
    ix, msg, sb = out[2]
    out[2] = (ix, msg, bytes([sb[0] & 0x7F]) + sb[1:])  # compression bit cleared
    return out


def _infinity(batch):
    out = list(batch)
    ix, msg, _ = out[0]
    out[0] = (ix, msg, bytes([0xC0]) + bytes(95))
    return out


def _empty(batch):
    out = list(batch)
    _, msg, sb = out[3]
    out[3] = ([], msg, sb)
    return out


CASES = [
    ("valid", lambda b: b, True),
    ("poisoned", _poisoned, False),
    ("malformed_flag", _malformed, False),
    ("infinity_sig", _infinity, False),
    ("empty_indices", _empty, False),
    ("three_sets_padded", lambda b: b[:3], True),
]


@pytest.mark.parametrize("name,make,expect", CASES, ids=[c[0] for c in CASES])
def test_verdicts_match_reference(registry, batch, name, make, expect):
    _, ref_cache, port_cache = registry
    items = make(batch)
    assert r_backend.bucket(len(items)) == 4
    want = r_backend.verify_indexed_sets_device(ref_cache, items)
    got = backend.verify_indexed_sets_device(port_cache, items, device="cpu")
    assert got == want == expect


def test_empty_batch_is_false(registry):
    _, _, port_cache = registry
    assert backend.verify_indexed_sets_device(port_cache, [], device="cpu") is False


def test_port_imports_neither_jax_nor_reference(registry, batch):
    """A fresh interpreter imports the port (its KZG stack and PeerDAS
    modules, loadshed, the network, the light client, the slasher, recovery,
    fork revert, both persistence modules, the client, the CLI and its parser,
    the Beacon API server and client, the metrics server, eth1, the
    execution layer's HTTP stack, the native backend, discovery, the test
    harness, the conformance runner, the database tools, keys, the validator
    client, the validator manager and watch included), verifies on the CPU (and through the native backend, its ENR verified),
    runs one numpy epoch boundary, serves a status from a node on the chain
    (its light-client server cache in place), sweeps the slasher's span
    store on the CPU, round-trips a fork-choice snapshot, loads the port's
    own trusted setup, derives a key, records a proposal in a slashing
    database, parses a ``vc``, opens a watch database, and has loaded no jax
    and nothing of lighthouse_tpu."""
    raw, _, _ = registry
    ix, msg, sb = batch[1]
    code = f"""
import sys
import numpy as np
from lighthouse_tpu_torch.bls import backend, pubkey_cache
import lighthouse_tpu_torch.bls, lighthouse_tpu_torch.firehose, lighthouse_tpu_torch.resilience
import lighthouse_tpu_torch.utils.metrics, lighthouse_tpu_torch.beacon_processor
import lighthouse_tpu_torch.ssz, lighthouse_tpu_torch.types, lighthouse_tpu_torch.ops.shuffle
import lighthouse_tpu_torch.epoch_engine.engine, lighthouse_tpu_torch.convert
import lighthouse_tpu_torch.fork_choice, lighthouse_tpu_torch.store, lighthouse_tpu_torch.op_pool
import lighthouse_tpu_torch.firehose.attester_cache, lighthouse_tpu_torch.execution_layer
import lighthouse_tpu_torch.utils.logging, lighthouse_tpu_torch.resilience.crashpoints
import lighthouse_tpu_torch.kzg, lighthouse_tpu_torch.kzg.engine, lighthouse_tpu_torch.ops.kzg
import lighthouse_tpu_torch.beacon_chain.data_columns, lighthouse_tpu_torch.beacon_chain.peerdas
import lighthouse_tpu_torch.loadshed, lighthouse_tpu_torch.network
import lighthouse_tpu_torch.network.gossipsub, lighthouse_tpu_torch.network.boot_node
import lighthouse_tpu_torch.light_client, lighthouse_tpu_torch.light_client.engine
import lighthouse_tpu_torch.ops.lc, lighthouse_tpu_torch.ops.lc.verify
import lighthouse_tpu_torch.slasher, lighthouse_tpu_torch.slasher.engine
import lighthouse_tpu_torch.slasher.kernels, lighthouse_tpu_torch.slasher.arrays
import lighthouse_tpu_torch.beacon_chain.recovery, lighthouse_tpu_torch.beacon_chain.fork_revert
import lighthouse_tpu_torch.fork_choice.persistence, lighthouse_tpu_torch.op_pool.persistence
import lighthouse_tpu_torch.client, lighthouse_tpu_torch.cli, lighthouse_tpu_torch.http_api
import lighthouse_tpu_torch.http_metrics, lighthouse_tpu_torch.api_client, lighthouse_tpu_torch.eth1
import lighthouse_tpu_torch.execution_layer.auth, lighthouse_tpu_torch.execution_layer.http
import lighthouse_tpu_torch.execution_layer.mock, lighthouse_tpu_torch.execution_layer.json_server
import lighthouse_tpu_torch.beacon_chain.validator_monitor, lighthouse_tpu_torch.utils.system_health
import lighthouse_tpu_torch.native, lighthouse_tpu_torch.network.discovery
import lighthouse_tpu_torch.testing, lighthouse_tpu_torch.conformance
import lighthouse_tpu_torch.conformance.generate, lighthouse_tpu_torch.tools.db
import lighthouse_tpu_torch.keys, lighthouse_tpu_torch.validator_client, lighthouse_tpu_torch.watch
import lighthouse_tpu_torch.validator_client.runner, lighthouse_tpu_torch.tools.vm
from lighthouse_tpu_torch.network import BeaconNodeService, LoopbackTransport
from lighthouse_tpu_torch import epoch_engine, state_transition
from lighthouse_tpu_torch.beacon_chain import BeaconChain
from lighthouse_tpu_torch.beacon_processor import BeaconProcessor
from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state
from lighthouse_tpu_torch.types.spec import minimal_spec
raw = np.frombuffer(bytes.fromhex({raw.tobytes().hex()!r}), np.uint8).reshape(8, 96)
cache = pubkey_cache.device_pubkeys_from_raw(raw, device="cpu")
ok = backend.verify_indexed_sets_device(
    cache, [({ix!r}, bytes.fromhex({msg.hex()!r}), bytes.fromhex({sb.hex()!r}))], device="cpu")
epoch_engine.set_backend("numpy")
spec = minimal_spec(altair_fork_epoch=0)
state = interop_genesis_state(spec, 16)
state_transition.process_slots(spec, state, spec.preset.SLOTS_PER_EPOCH + 1)
ok = ok and state.slot == spec.preset.SLOTS_PER_EPOCH + 1
lighthouse_tpu_torch.bls.set_backend("oracle")
chain = BeaconChain(spec, state)
ok = ok and chain.head.slot == state.slot and len(chain.pubkey_cache) == 16
lc = lighthouse_tpu_torch.light_client
ok = ok and isinstance(chain.light_client_cache, lc.LightClientServerCache)
ok = ok and lc.engine.LcEngine(spec, "cpu").committee_size == spec.preset.SYNC_COMMITTEE_SIZE
node = BeaconNodeService("a", spec, state, LoopbackTransport(), device="cpu")
ok = ok and node.local_status().head_slot == state.slot
BeaconProcessor(synchronous=True).shutdown()
sl = lighthouse_tpu_torch.slasher.make_slasher(None, chain.ns,
    lighthouse_tpu_torch.slasher.SlasherConfig(history_length=64), backend="device", device="cpu")
res = sl.span.apply(np.array([3]), np.array([4]), np.array([5]), np.array([1], np.uint32), 6)
ok = ok and not res["min_flag"][0] and sl.span.mode == "device"
blob = lighthouse_tpu_torch.fork_choice.persistence.serialize_fork_choice(chain.fork_choice)
ok = ok and len(lighthouse_tpu_torch.fork_choice.persistence.restore_fork_choice(
    spec, blob).proto.nodes) == 1
setup = lighthouse_tpu_torch.kzg.load_trusted_setup()
args = lighthouse_tpu_torch.cli.build_parser().parse_args(
    ["bn", "--device", "cpu", "--boot-enrs", "ab"])
ok = ok and args.device == "cpu" and args.command == "bn" and args.boot_enrs == "ab"
lighthouse_tpu_torch.bls.set_backend("native")
sk = lighthouse_tpu_torch.bls.SecretKey.from_bytes((5).to_bytes(32, "big"))
m = bytes(32)
ok = ok and lighthouse_tpu_torch.bls.verify_signature_sets(
    [lighthouse_tpu_torch.bls.SignatureSet.single_pubkey(sk.sign(m), sk.public_key(), m)])
disc = lighthouse_tpu_torch.network.discovery.DiscoveryService(fork_digest=bytes(4))
ok = ok and disc.enr.verify()
disc.stop()
ok = ok and lighthouse_tpu_torch.conformance.default_vector_root().endswith("vectors")
ok = ok and setup.field_elements_per_blob == 4096 and len(setup.g2_monomial) == 65
ok = ok and 0 < lighthouse_tpu_torch.keys.derive_sk_from_path(bytes(32), "m/12381/3600/0/0/0")
sdb = lighthouse_tpu_torch.validator_client.SlashingDatabase()
sdb.register_validator(bytes(48))
ok = ok and sdb.check_and_insert_block_proposal(bytes(48), 1, bytes(32)) == "valid"
vc_args = lighthouse_tpu_torch.cli.build_parser().parse_args(["vc", "--interop-validators", "2"])
ok = ok and vc_args.interop_validators == 2 and not hasattr(vc_args, "device")
ok = ok and lighthouse_tpu_torch.watch.WatchDB().slot_bounds() is None
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "lighthouse_tpu" or m.startswith("lighthouse_tpu.")]
print(ok, bad)
assert ok is True and not bad, bad
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "True []"


def test_default_device_is_cuda_and_raises_without_it(registry, batch):
    from lighthouse_tpu_torch.device import resolve_device

    _, _, port_cache = registry
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend.verify_indexed_sets_device(port_cache, batch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pubkey_cache.device_pubkeys_from_raw(np.zeros((1, 96), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.to_torch(np.zeros(3, np.uint64))
