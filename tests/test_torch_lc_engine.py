"""The port's batched light-client engine against the reference's pieces.

Sessions are optimistic updates signed by the reference ``StateHarness``'s
keys (minimal preset, C = 32) against two distinct committees — the
state's current sync committee and the same keys in reverse order — so that
one dispatch gathers two committee-cache rows; they cross to the port as
SSZ bytes. Held equal:

* the three stages (``ops/lc/verify``: ``lc_h2c``, ``lc_prep``,
  ``lc_pair``) against the reference's under ``jax.jit`` at n_pad 4 with
  the same injected scalars (two of them >= 2^63), on a batch with one
  tampered signature: the marshalled inputs, the committee cache, the
  canonical affine limbs, ``set_ok`` and the verdict;
* the port's ``compile_probe`` dict against the reference's counts at the
  same shape (the reference's trace-time ``PROBE`` deltas over the jitted
  stages: what its ``compile_probe`` sums over its composed graph);
* per-session verdicts of ``verify_update_batch`` on ``device="cpu"`` (the
  kernels' plain versions) against the host loop, on an honest batch and on
  a batch with a tampered signature, a tampered header and a malformed
  signature encoding, with the bisection's calls those of the reference's
  algorithm;
* the ``lc_device`` ladder: on the CPU it demotes to ``cpu_oracle`` with the
  verdicts intact; on any other device (the meta device stands in for a
  card) it fails closed and never runs the host loop; the default backend
  (CUDA) raises without CUDA.

Exact equality everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401  (enables x64)
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.light_client import engine as r_engine
from lighthouse_tpu.light_client import verify as r_verify
from lighthouse_tpu.light_client.types import light_client_types as r_lct
from lighthouse_tpu.ops.bls_oracle.fields import R as CURVE_ORDER
from lighthouse_tpu.ops.lc import verify as r_lcv
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.containers import BeaconBlockHeader as RHeader
from lighthouse_tpu.types.containers import for_preset as r_for_preset
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert, resilience
from lighthouse_tpu_torch.light_client import engine
from lighthouse_tpu_torch.light_client.types import light_client_types as p_lct
from lighthouse_tpu_torch.ops.bls import fq
from lighthouse_tpu_torch.ops.lc import verify as p_lcv
from lighthouse_tpu_torch.oracle.fields import P
from lighthouse_tpu_torch.resilience.inject import injector
from lighthouse_tpu_torch.resilience.supervisor import SupervisorConfig
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

RSPEC, PSPEC = r_minimal(altair_fork_epoch=0), p_minimal(altair_fork_epoch=0)
SCALARS = np.array([(1 << 64) - 3, 0x1234_5678_9ABC_DEF1, 1 << 63, 5], dtype=np.uint64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), p_bls.get_backend(), p_bls.get_device(),
             engine.get_lc_backend(), engine.get_lc_device())
    r_bls.set_backend("native")
    p_bls.set_backend("oracle")
    yield
    r_bls.set_backend(saved[0])
    p_bls.set_backend(saved[1], device=saved[2])
    engine.set_lc_backend(saved[3], device=saved[4])


def _sign_session(h, committee, seed: int, slot: int):
    """One optimistic update at ``slot`` signed by ~75% of ``committee``
    (the reference's ``fabricate_lc_sessions``, for any committee)."""
    spec, state = h.spec, h.state
    t = r_lct("minimal")
    ns = r_for_preset("minimal")
    rng = np.random.default_rng(seed)
    c = len(committee.pubkeys)
    bits = rng.random(c) < 0.75
    bits[0] = True
    update = t.LightClientOptimisticUpdate(
        attested_header=t.LightClientHeader(beacon=RHeader(
            slot=slot, proposer_index=slot % 16, parent_root=rng.bytes(32),
            state_root=rng.bytes(32), body_root=rng.bytes(32))),
        sync_aggregate=ns.SyncAggregate(sync_committee_bits=bits,
                                        sync_committee_signature=b"\x00" * 96),
        signature_slot=slot + 1)
    root = r_verify.sync_signing_root(spec, update, bytes(state.genesis_validators_root))
    pk_to_idx = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    sk = sum(h.sks[pk_to_idx[bytes(committee.pubkeys[j])]] for j in range(c) if bits[j]) % CURVE_ORDER
    update.sync_aggregate.sync_committee_signature = h._nb.sign(sk.to_bytes(32, "big"), root)
    return update, committee


def _tampered(session, mode):
    update, committee = session
    u = type(update).decode(update.serialize())
    if mode == "signature":  # one bit of x flipped
        raw = bytearray(bytes(u.sync_aggregate.sync_committee_signature))
        raw[50] ^= 0x01
        u.sync_aggregate.sync_committee_signature = bytes(raw)
    elif mode == "header":  # the signature no longer covers the header
        u.attested_header.beacon.state_root = b"\xfe" * 32
    elif mode == "malformed":  # compression bit cleared
        raw = bytes(u.sync_aggregate.sync_committee_signature)
        u.sync_aggregate.sync_committee_signature = bytes([raw[0] & 0x7F]) + raw[1:]
    return u, committee


class Env:
    def __init__(self):
        self.h = StateHarness(RSPEC, 16)
        self.gvr = bytes(self.h.state.genesis_validators_root)
        ca = self.h.state.current_sync_committee
        cb = type(ca).decode(ca.serialize())
        cb.pubkeys = list(reversed([bytes(pk) for pk in ca.pubkeys]))
        assert type(ca).hash_tree_root(ca) != type(cb).hash_tree_root(cb)
        self.honest = [_sign_session(self.h, (ca, cb)[i % 2], 100 + i, 3 + i) for i in range(4)]
        self.mixed = [_tampered(self.honest[0], "signature"), self.honest[1],
                      _tampered(self.honest[2], "header"), _tampered(self.honest[3], "malformed")]

    @staticmethod
    def port(sessions):
        t = p_lct("minimal")
        sc = p_for_preset("minimal").SyncCommittee
        return [(t.LightClientOptimisticUpdate.decode(u.serialize()), sc.decode(c.serialize()))
                for u, c in sessions]


@pytest.fixture(scope="module")
def env():
    return Env()


def _canon(x):
    x = np.asarray(x).reshape(-1, 25)
    return [fq.limbs_to_int(r) % P for r in x]


@pytest.fixture(scope="module")
def stages(env):
    """Both packages' stages on the same batch (sessions 0-3 of the mixed
    set, the signature-tampered one first; two cache rows) and scalars."""
    sessions = [_tampered(env.honest[0], "signature")] + env.honest[1:]
    r_eng = r_engine.LcEngine(RSPEC)
    rargs = list(r_eng._marshal(sessions, env.gvr, 4))
    rargs[8] = jnp.asarray(SCALARS)
    rcache = r_eng._cache_arr()
    before = dict(r_lcv.PROBE)
    rmx, rmy = jax.jit(r_lcv.lc_h2c)(rargs[2], rargs[3])
    rpre = jax.jit(r_lcv.lc_prep)(rcache, rargs[0], rargs[1], *rargs[4:])
    rok = jax.jit(r_lcv.lc_pair)(*rpre[:4], rmx, rmy, rpre[4], rargs[9])
    rprobe = {k: r_lcv.PROBE[k] - before[k] for k in before}

    p_eng = engine.LcEngine(PSPEC, "cpu")
    b = p_eng.marshal(env.port(sessions), env.gvr, 4, SCALARS)
    pcache = p_eng.cache_arr()
    before = dict(p_lcv.PROBE)
    pmx, pmy = p_lcv.lc_h2c(b["u0"], b["u1"])
    ppre = p_lcv.lc_prep(pcache, b["pidx"], b["bits"], b["sxc0"], b["sxc1"], b["s_flag"],
                         b["sig_wf"], b["scalars"], b["valid"])
    pok = p_lcv.lc_pair(*ppre[:4], pmx, pmy, ppre[4], b["valid"])
    pprobe = {k: p_lcv.PROBE[k] - before[k] for k in before}
    return {
        "ref": dict(args=rargs, cache=rcache, mx=rmx, my=rmy, pre=rpre, ok=rok, probe=rprobe),
        "port": dict(b=b, cache=pcache, mx=pmx, my=pmy, pre=ppre, ok=pok, probe=pprobe, eng=p_eng),
    }


# -- the stages against the reference's ------------------------------------------------


def test_marshalled_inputs_and_cache_equal(stages):
    r, p = stages["ref"], stages["port"]
    names = ["pidx", "bits", "u0", "u1", "sxc0", "sxc1", "s_flag", "sig_wf", "scalars", "valid"]
    for i, key in enumerate(names):
        got = p["b"][key].numpy()
        want = np.asarray(r["args"][i])
        if key == "scalars":  # the same 64-bit patterns, int64 on the port
            got = got.view(np.uint64)
        assert got.tolist() == want.tolist(), key
    assert p["b"]["pidx"].tolist() == [0, 1, 0, 1]  # two committees, one dispatch
    assert (convert.to_numpy(p["cache"]) == np.asarray(r["cache"])).all()
    assert p["eng"].cache_bytes() == np.asarray(r["cache"]).nbytes


def test_h2c_stage_equal(stages):
    r, p = stages["ref"], stages["port"]
    assert _canon(convert.to_numpy(p["mx"])) == _canon(r["mx"])
    assert _canon(convert.to_numpy(p["my"])) == _canon(r["my"])


def test_prep_stage_equal(stages):
    r, p = stages["ref"], stages["port"]
    for name, got, want in zip(("pkx", "pky", "sax", "say"), p["pre"][:4], r["pre"][:4]):
        assert _canon(convert.to_numpy(got)) == _canon(want), name
    assert p["pre"][4].tolist() == np.asarray(r["pre"][4]).tolist()
    assert p["pre"][4].tolist()[1:] == [True, True, True] and not p["pre"][4].tolist()[0]


def test_pair_stage_verdict_equal(stages):
    assert bool(stages["port"]["ok"]) == bool(stages["ref"]["ok"]) is False


def test_compile_probe_equals_reference(env, stages):
    """One pairing check of B+1 pairs and one masked aggregation sum per
    batch: the port's run-time counts (its stage run above and its
    ``compile_probe``) equal the reference's trace-time counts."""
    rprobe = stages["ref"]["probe"]
    want = {
        "batch": 4, "committee_size": 32,
        "pairing_checks_per_batch_trace": rprobe["pairing_checks"],
        "pairs_per_check": rprobe["pairs"] // max(1, rprobe["pairing_checks"]),
        "agg_sums_per_batch_trace": rprobe["agg_sums"],
    }
    assert stages["port"]["probe"] == rprobe == {"pairing_checks": 1, "pairs": 5, "agg_sums": 1}
    got = engine.LcEngine(PSPEC, "cpu").compile_probe(3)
    assert got.pop("conv_impl") == "plain"
    assert got == want


# -- verdicts, bisection -----------------------------------------------------------------


def _host(sessions, gvr):
    engine.set_lc_backend("host")
    return engine.verify_update_batch(PSPEC, sessions, gvr)


@pytest.mark.parametrize("case", ["honest", "mixed"])
def test_verdicts_equal_host_loop(env, monkeypatch, case):
    sessions = env.port(getattr(env, case))
    want = _host(sessions, env.gvr)
    ref_want = [r_verify.verify_light_client_update(RSPEC, u, c, env.gvr) for u, c in getattr(env, case)]
    engine.set_lc_backend("device", device="cpu")
    eng = engine.get_engine(PSPEC)
    calls = []
    real = eng.verify_batch

    def recording(ss, gvr, **kw):
        calls.append(len(ss))
        return real(ss, gvr, **kw)

    monkeypatch.setattr(eng, "verify_batch", recording)
    got = engine.verify_update_batch(PSPEC, sessions, env.gvr)
    assert got == want == ref_want
    if case == "honest":
        assert got == [True] * 4 and calls == [4]
    else:
        # the reference's bisection over [bad, ok, bad, bad]
        assert got == [False, True, False, False]
        assert calls == [4, 2, 1, 1, 2, 1, 1]


# -- the lc_device ladder and the backend seam -------------------------------------------


@pytest.fixture
def lc_sup():
    sup = resilience.lc_supervisor()
    saved = sup.config
    sup.config = SupervisorConfig(deadline_s=600.0, max_retries=1, backoff_base_s=0.001,
                                  backoff_max_s=0.005, promote_after=1, probe_every=1,
                                  probation_s=60.0)
    sup.reset()
    yield sup
    injector.clear()
    sup.config = saved
    sup.reset()


def test_ladder_demotes_to_cpu_oracle_on_the_cpu(env, lc_sup):
    sessions = env.port(env.mixed)
    want = _host(sessions, env.gvr)
    engine.set_lc_backend("device", device="cpu")
    injector.install("stage=lc.batch_verify;mode=raise;every=1|"
                     "stage=lc.batch_verify/device_reduced;mode=raise;every=1")
    assert engine.verify_update_batch(PSPEC, sessions, env.gvr) == want
    snap = lc_sup.snapshot()
    assert snap["faults"] >= 2 and snap["demotions"] >= 1 and snap["exhausted"] == 0, snap


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_device_ladder_fails_closed_off_the_cpu(env, lc_sup, monkeypatch, where):
    """An engine whose device verify faults on every call: on the CPU the
    ladder's cpu_oracle rung (the host loop) answers; on any other device (a
    card; the meta device stands in for one here) the ladder ends at
    device_reduced and every session comes back unverified, the host loop
    never called."""
    sessions = env.port(env.honest)
    engine.set_lc_backend("device", device=where)
    eng = engine.get_engine(PSPEC)
    assert eng.device.type == where
    calls = []

    def faulting(ss, gvr, **kw):
        calls.append(("device", len(ss)))
        raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")

    def host(spec, u, c, gvr, fin=False, real=engine.verify_light_client_update):
        calls.append(("host", 1))
        return real(spec, u, c, gvr, fin)

    monkeypatch.setattr(eng, "verify_batch", faulting)
    monkeypatch.setattr(engine, "verify_light_client_update", host)
    got = engine.verify_update_batch(PSPEC, sessions, env.gvr)
    assert calls[:2] == [("device", 4), ("device", 2)]
    if where == "cpu":
        assert got == [True] * 4 and calls[2:] == [("host", 1)] * 4
    else:
        assert got == [False] * 4 and len(calls) == 2
        assert lc_sup.snapshot()["exhausted"] == 1


def test_backend_seam(env):
    sessions = env.port(env.honest[:1])
    with pytest.raises(ValueError, match="unknown lc backend"):
        engine.set_lc_backend("auto")
    engine.set_lc_backend("host")
    assert not engine.device_backend_active()
    assert engine.verify_update_batch(PSPEC, [], env.gvr) == []
    engine.set_lc_backend("device")
    assert engine.device_backend_active() and engine.get_lc_device() is None
    if not torch.cuda.is_available():
        # the default device is CUDA: without it the entry point raises
        # before any supervised region, never dropping to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.verify_update_batch(PSPEC, sessions, env.gvr)
