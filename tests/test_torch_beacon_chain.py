"""The port's beacon chain against the reference's.

``lighthouse_tpu_torch.beacon_chain`` is the port's copy of
``lighthouse_tpu.beacon_chain`` (the chain, its pubkey cache, the early
attester cache and the availability gate) over the port's fork choice,
store, pools, state transition and ``bls``. Both chains import the same
harness blocks (the reference's ``StateHarness``, signed with its native
backend; blocks and states cross as SSZ bytes) and must agree on head roots,
post-states, checkpoints, fork-choice weights, store keys and bytes, and on
every verdict of the gossip batch paths, the firehose and the beacon
processor. The reference chain runs its ``native`` backend, the port's
``"oracle"``, and the port's ``"device"`` arm on ``device="cpu"`` (the
kernels' plain versions) for one block import and one attestation batch.
The per-epoch memo of the port's ``beacon_state_util`` is held equal to the
reference's uncached functions across a block with an exit and a slashing,
an epoch and a fork boundary. Exact equality everywhere.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import state_transition as r_st
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.beacon_chain import BlockError as RBlockError
from lighthouse_tpu.beacon_chain.pubkey_cache import ValidatorPubkeyCache as RCache
from lighthouse_tpu.beacon_processor import BeaconProcessor as RProcessor
from lighthouse_tpu.beacon_processor import Work as RWork
from lighthouse_tpu.beacon_processor import WorkType as RWorkType
from lighthouse_tpu.op_pool import OperationPool as RPool
from lighthouse_tpu.ops.bls_oracle.fields import P
from lighthouse_tpu.ssz import uint64 as r_u64
from lighthouse_tpu.store.kv import DBColumn as r_store_col
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu.types.helpers import compute_signing_root, get_domain
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import state_transition as p_st
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain import BlockError as PBlockError
from lighthouse_tpu_torch.beacon_chain import ValidatorPubkeyCache as PCache
from lighthouse_tpu_torch.beacon_chain.pubkey_cache import compress_affine as p_compress
from lighthouse_tpu_torch.beacon_processor import BeaconProcessor as PProcessor
from lighthouse_tpu_torch.beacon_processor import Work as PWork
from lighthouse_tpu_torch.beacon_processor import WorkType as PWorkType
from lighthouse_tpu_torch.types import containers as p_containers
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

N = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(), p_bls.get_device(),
             p_epoch.get_backend(), p_epoch.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("oracle")
    p_epoch.set_backend("numpy")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])


class Pair:
    """A reference chain and a port chain on the same anchor, with one
    harness producing the blocks and one slot for both clocks."""

    def __init__(self, n=N, **spec_kw):
        self.rspec, self.pspec = r_minimal(**spec_kw), p_minimal(**spec_kw)
        self.h = StateHarness(self.rspec, n)
        self.ns = p_for_preset("minimal")
        self.rclock, self.pclock = RClock(0), PClock(0)
        self.r = RChain(self.rspec, self.h.state.copy(), slot_clock=self.rclock)
        self.p = PChain(self.pspec, self.port(self.h.state), slot_clock=self.pclock)

    def port(self, obj):
        """A reference state, signed block or gossip container as the port's."""
        if hasattr(obj, "validators"):
            return convert.state_from_ssz(self.pspec, obj.fork_name, obj.serialize())
        if hasattr(obj, "message") and hasattr(obj.message, "body"):
            fork = self.rspec.fork_name_at_slot(int(obj.message.slot))
            return convert.block_from_ssz(self.pspec, fork, obj.serialize())
        name = type(obj).__name__
        cls = getattr(self.ns, name, None) or getattr(p_containers, name)
        return cls.decode(obj.serialize())

    def set_slot(self, slot):
        self.rclock.set_slot(slot)
        self.pclock.set_slot(slot)

    def extend(self, slots, attest=True):
        """Produce, apply and import one block per slot into both chains."""
        roots = []
        for slot in slots:
            self.set_slot(slot)
            atts = []
            if attest and slot > 1:
                prev = self.h.state
                atts = self.h.attestations_for_slot(prev, int(prev.slot), self.h.head_root(prev))
            b = self.h.produce_block(slot, attestations=atts)
            self.h.apply_block(b)
            roots.append((self.r.process_block(b), self.p.process_block(self.port(b))))
        return roots


def _weights(chain):
    return [(n.root, n.parent, int(n.weight), n.best_child, n.best_descendant)
            for n in chain.fork_choice.proto.nodes]


def _assert_same_chain(pair):
    r, p = pair.r, pair.p
    assert p.head.root == r.head.root
    assert p.head.slot == r.head.slot
    assert p.head.state.serialize() == r.head.state.serialize()
    assert p.fork_choice.store.justified_checkpoint == r.fork_choice.store.justified_checkpoint
    assert p.fork_choice.store.finalized_checkpoint == r.fork_choice.store.finalized_checkpoint
    assert _weights(p) == _weights(r)
    # the reference's light-client server cache also writes updates; the
    # port has none yet (its chain's light_client_cache is None)
    lc = r_store_col.LightClientUpdate.value + b"/"
    assert sorted(p.store.hot._data.items()) == sorted(
        kv for kv in r.store.hot._data.items() if not kv[0].startswith(lc))
    assert sorted(p.store.cold._data.items()) == sorted(r.store.cold._data.items())
    assert sorted(p._states) == sorted(r._states)


def test_block_ssz_round_trip():
    pair = Pair(altair_fork_epoch=0)
    pair.set_slot(1)
    b = pair.h.produce_block(1)
    pb = pair.port(b)
    assert convert.block_to_ssz(pb) == b.serialize()
    assert type(b).decode(convert.block_to_ssz(pb)).serialize() == b.serialize()
    assert type(pb.message).hash_tree_root(pb.message) == type(b.message).hash_tree_root(b.message)


def test_import_through_finality_equal():
    """Four and a half epochs of attested blocks: heads, post-states,
    checkpoints, fork-choice weights, hot and cold stores agree after every
    block, finality advances and the migrator freezes the same states."""
    pair = Pair()
    spe = pair.rspec.preset.SLOTS_PER_EPOCH
    for slot in range(1, 4 * spe + 5):
        (rr, pr), = pair.extend([slot])
        assert pr == rr
        assert pair.p.state_by_root(pr).serialize() == pair.r.state_by_root(rr).serialize()
        if slot % 3 == 0 or slot > 4 * spe:
            _assert_same_chain(pair)
    assert int(pair.p.fork_choice.store.finalized_checkpoint[0]) >= 2
    assert pair.p.migrator.last_finalized_slot == pair.r.migrator.last_finalized_slot > 0


def test_electra_import_equal():
    forks = ("altair", "bellatrix", "capella", "deneb", "electra")
    pair = Pair(**{f"{f}_fork_epoch": 0 for f in forks})
    pair.extend(range(1, 6))
    _assert_same_chain(pair)


def test_invalid_signature_and_future_block_rejected():
    pair = Pair()
    pair.set_slot(1)
    b = pair.h.produce_block(1)
    bad = type(b)(message=b.message, signature=b"\xab" + bytes(95))
    with pytest.raises((RBlockError, r_bls.BlsError)):
        pair.r.process_block(bad)
    with pytest.raises((PBlockError, p_bls.BlsError)):
        pair.p.process_block(pair.port(bad))
    resigned = pair.h.produce_block(1)
    wrong = type(b)(message=resigned.message, signature=pair.h._sign(3, b"\x01" * 32))
    with pytest.raises(RBlockError):
        pair.r.process_block(wrong)
    with pytest.raises(PBlockError):
        pair.p.process_block(pair.port(wrong))
    future = pair.h.produce_block(2)
    with pytest.raises(RBlockError, match="future"):
        pair.r.process_block(future)
    with pytest.raises(PBlockError, match="future"):
        pair.p.process_block(pair.port(future))
    _assert_same_chain(pair)
    assert pair.p.head.root == pair.p.genesis_block_root


def _verdicts(results):
    """(kind, indexed attestation bytes or error text) per result."""
    return [("err", str(v)) if isinstance(v, Exception) else ("ok", v.serialize())
            for _, v in results]


def _gossip(pair):
    """Two imported blocks, then both slots' single-bit attestations, one
    poisoned (another member's signature), and one for an unknown block."""
    roots = pair.extend([1, 2])
    pair.set_slot(3)
    atts = [a for slot, (root, _) in zip((1, 2), roots)
            for a in pair.h.unaggregated_attestations_for_slot(pair.h.state, slot, root)]
    atts[1] = type(atts[1])(aggregation_bits=atts[1].aggregation_bits, data=atts[1].data,
                            signature=atts[0].signature)
    stray = atts[0].data.copy()
    stray.beacon_block_root = b"\x42" * 32
    atts.append(type(atts[0])(aggregation_bits=atts[0].aggregation_bits, data=stray,
                              signature=atts[0].signature))
    return atts


def test_unaggregated_batch_verdicts_equal():
    pair = Pair()
    atts = _gossip(pair)
    rv = _verdicts(pair.r.verify_unaggregated_attestations(atts))
    pv = _verdicts(pair.p.verify_unaggregated_attestations([pair.port(a) for a in atts]))
    assert pv == rv
    assert [k for k, _ in pv].count("err") == 2
    assert _weights(pair.p) == _weights(pair.r)
    assert len(pair.p.fork_choice.queued_attestations) == len(pair.r.fork_choice.queued_attestations)
    data = atts[0].data
    assert (pair.p.naive_aggregation_pool.get(pair.port(data)).serialize()
            == pair.r.naive_aggregation_pool.get(data).serialize())


def test_aggregated_batch_verdicts_equal():
    """Valid aggregates, one carrying a selection proof over another slot
    and one whose envelope signature is over another message."""
    pair = Pair()
    roots = pair.extend([1, 2])
    pair.set_slot(3)
    saps = [s for _ in range(2) for slot, (root, _) in zip((1, 2), roots)
            for s in pair.h.signed_aggregate_and_proofs(pair.h.state, slot, root)]
    m = saps[2].message.copy()
    dom = get_domain(pair.rspec, pair.h.state, pair.rspec.DOMAIN_SELECTION_PROOF, epoch=0)
    m.selection_proof = pair.h._sign(int(m.aggregator_index), r_con.SigningData(
        object_root=r_u64.hash_tree_root(5), domain=dom).tree_root())
    env = get_domain(pair.rspec, pair.h.state, pair.rspec.DOMAIN_AGGREGATE_AND_PROOF, epoch=0)
    saps[2] = type(saps[2])(message=m, signature=pair.h._sign(int(m.aggregator_index),
                                                               compute_signing_root(m, env)))
    saps[3] = type(saps[3])(message=saps[3].message,
                            signature=pair.h._sign(int(saps[3].message.aggregator_index), b"\x07" * 32))
    rv = _verdicts(pair.r.verify_aggregated_attestations(saps))
    pv = _verdicts(pair.p.verify_aggregated_attestations([pair.port(s) for s in saps]))
    assert pv == rv
    assert [k for k, _ in pv] == ["ok", "ok", "err", "err"]
    assert _weights(pair.p) == _weights(pair.r)


def test_fork_resolution_by_votes_equal():
    """Two blocks at slot 1; a committee's attestation for the one that is
    not the head makes it the head on both chains."""
    pair = Pair()
    h, spec = pair.h, pair.rspec
    pair.set_slot(1)
    b1 = h.produce_block(1)
    msg2 = b1.message.copy()
    msg2.body = msg2.body.copy()
    msg2.body.graffiti = b"\x01" * 32
    st = StateHarness(spec, N).state.copy()
    r_st.process_slots(spec, st, 1)
    trial = st.copy()
    r_st.per_block_processing(spec, trial, type(b1)(message=msg2, signature=b"\x00" * 96),
                              strategy=r_st.BlockSignatureStrategy.NO_VERIFICATION,
                              verify_block_root=False)
    msg2.state_root = trial.tree_root()
    domain = get_domain(spec, st, spec.DOMAIN_BEACON_PROPOSER, epoch=0)
    b2 = type(b1)(message=msg2, signature=h._sign(int(msg2.proposer_index),
                                                   compute_signing_root(msg2, domain)))
    roots = []
    for chain, conv in ((pair.r, lambda x: x), (pair.p, pair.port)):
        roots.append((chain.process_block(conv(b1)),
                      chain.process_block(conv(b2), is_first_block_in_slot=False)))
    assert roots[0] == roots[1] and roots[0][0] != roots[0][1]
    assert pair.p.head.root == pair.r.head.root
    r1, r2 = roots[0]
    target = r2 if pair.r.head.root == r1 else r1
    pair.set_slot(2)
    st_t = pair.r._states[target]
    committee = r_st.get_beacon_committee(spec, st_t, 1, 0)
    data = r_con.AttestationData(slot=1, index=0, beacon_block_root=target,
                                 source=st_t.current_justified_checkpoint,
                                 target=r_con.Checkpoint(epoch=0, root=pair.r.genesis_block_root))
    root = compute_signing_root(data, get_domain(spec, st_t, spec.DOMAIN_BEACON_ATTESTER, epoch=0))
    agg_sk = sum(h.sks[int(v)] for v in committee)
    from lighthouse_tpu.ops.bls_oracle.fields import R as ORDER

    att = h.ns.Attestation(aggregation_bits=np.ones(committee.size, dtype=bool), data=data,
                           signature=h._nb.sign((agg_sk % ORDER).to_bytes(32, "big"), root))
    rv = _verdicts(pair.r.verify_unaggregated_attestations([att]))
    pv = _verdicts(pair.p.verify_unaggregated_attestations([pair.port(att)]))
    assert pv == rv and rv[0][0] == "ok"
    pair.set_slot(3)
    assert pair.r.recompute_head() == target
    assert pair.p.recompute_head() == target
    assert _weights(pair.p) == _weights(pair.r)


def test_early_attester_cache_hits_and_misses_equal():
    pair = Pair()
    pair.extend([1, 2], attest=False)
    spec, pspec = pair.rspec, pair.pspec
    asks = [(s, 0, pair.r.head.root) for s in range(2, spec.preset.SLOTS_PER_EPOCH)]
    asks += [(2, 0, b"\x11" * 32), (1, 0, pair.r.head.root),
             (spec.preset.SLOTS_PER_EPOCH, 0, pair.r.head.root)]
    for slot, index, head in asks:
        r = pair.r.early_attester_cache.try_attestation_data(spec, slot, index, head)
        p = pair.p.early_attester_cache.try_attestation_data(pspec, slot, index, head)
        assert (p is None) == (r is None)
        if r is not None:
            assert p.serialize() == r.serialize()
    assert pair.p.early_attester_cache.stats() == pair.r.early_attester_cache.stats()
    pair.p.early_attester_cache.evict()
    pair.r.early_attester_cache.evict()
    assert pair.p.early_attester_cache.stats() == pair.r.early_attester_cache.stats()


def test_firehose_drain_equal():
    pair = Pair()
    atts = _gossip(pair)
    out = []
    for chain, conv in ((pair.r, lambda x: x), (pair.p, pair.port)):
        engine = chain.create_firehose(synchronous=True)
        verdicts = {}
        for i, a in enumerate(atts):
            engine.submit(conv(a), callback=lambda p, ok, m, i=i: verdicts.__setitem__(i, ok))
        engine.drain()
        st = engine.stats()
        out.append(([verdicts.get(i) for i in range(len(atts))], st.verified, st.rejected,
                    st.dropped))
    assert out[1] == out[0]
    assert out[0][0].count(True) == len(atts) - 2


def test_beacon_processor_batch_equal():
    pair = Pair()
    atts = _gossip(pair)
    out = []
    for proc_cls, work_cls, wt, chain, conv in (
            (RProcessor, RWork, RWorkType, pair.r, lambda x: x),
            (PProcessor, PWork, PWorkType, pair.p, pair.port)):
        proc = proc_cls(synchronous=False)
        proc.shutdown()
        results = []
        for a in atts:
            proc.submit(work_cls(wt.GossipAttestation, conv(a),
                                 process_batch=lambda xs, c=chain: results.extend(
                                     c.verify_unaggregated_attestations(xs))))
        proc.run_until_idle()
        out.append((proc.batches_formed, proc.processed[wt.GossipAttestation],
                    [(a.serialize(), k, v) for (a, _), (k, v) in zip(results, _verdicts(results))]))
    assert out[1] == out[0]
    assert out[0][0] == 1 and out[0][1] == len(atts)


def test_device_arm_on_cpu():
    """The port's "device" backend on the CPU: one block import (its bulk
    batch through ``bls.verify_signature_sets``) and one gossip batch
    through ``verify_indexed_sets_device`` against the chain's resident
    pubkey tensor, the same results as the reference chain."""
    pair = Pair()
    pair.set_slot(1)
    b = pair.h.produce_block(1)
    pair.h.apply_block(b)
    p_bls.set_backend("device", device="cpu")
    assert pair.r.process_block(b) == pair.p.process_block(pair.port(b))
    _assert_same_chain(pair)
    pair.set_slot(2)
    atts = pair.h.unaggregated_attestations_for_slot(pair.h.state, 1, pair.r.head.root)
    rv = _verdicts(pair.r.verify_unaggregated_attestations(atts))
    pv = _verdicts(pair.p.verify_unaggregated_attestations([pair.port(a) for a in atts]))
    assert pv == rv and all(k == "ok" for k, _ in pv)
    arr = pair.p.pubkey_cache.device_array()
    assert arr.device.type == "cpu" and tuple(arr.shape) == (N, 3, 25)


@pytest.mark.parametrize("cache_device", ["cpu", "meta"])
def test_device_ladder_fails_closed_off_the_cpu(monkeypatch, cache_device):
    """A device verify that faults on every call: with the pubkey cache on
    the CPU the ladder's cpu_oracle rung answers; with the cache anywhere
    else (a card; the meta device stands in for one here) the ladder ends at
    device_reduced and the batch fails closed, the oracle never called."""
    from lighthouse_tpu_torch import resilience
    from lighthouse_tpu_torch.bls import backend as tb

    pair = Pair()
    pair.extend([1], attest=False)
    pair.set_slot(2)
    atts = pair.h.unaggregated_attestations_for_slot(pair.h.state, 1, pair.r.head.root)
    items = [pair.p._attester_item_fast(pair.p._indexed_attestation_fast(pair.port(a)))
             for a in atts]
    p_bls.set_backend("device", device="cpu")
    cache = torch.zeros((N, 3, 25), dtype=torch.int64, device=cache_device)
    monkeypatch.setattr(pair.p.pubkey_cache, "device_array", lambda: cache)
    calls = []

    def faulting(arr, its, device=None):
        calls.append(("device", len(its)))
        raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")

    def oracle(sets, real=p_bls.verify_signature_sets_oracle):
        calls.append(("oracle", len(sets)))
        return real(sets)

    monkeypatch.setattr(tb, "verify_indexed_sets_device", faulting)
    monkeypatch.setattr(p_bls, "verify_signature_sets_oracle", oracle)
    resilience.reset_all()
    try:
        ok = pair.p._batch_verify_items(items)
    finally:
        resilience.reset_all()
    n, half = len(items), (len(items) + 1) // 2
    assert n > 1 and calls[:2] == [("device", n), ("device", half)]
    if cache_device == "cpu":
        assert ok and calls[2:] == [("oracle", n)]
    else:
        assert not ok and len(calls) == 2


def _raw_points(cache, n):
    return np.array([list(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big"))
                     for p in (cache.get_point(i) for i in range(n))], dtype=np.uint8)


def test_pubkey_cache_device_array_and_seed():
    spec = r_minimal()
    state = StateHarness(spec, N).state
    pstate = convert.state_from_ssz(p_minimal(), "phase0", state.serialize())
    ref = RCache()
    ref.import_new_pubkeys(state)
    per_key = PCache(device="cpu")
    per_key.import_new_pubkeys(pstate)
    want = np.asarray(ref.device_array())
    assert np.array_equal(convert.to_numpy(per_key.device_array()), want)
    raw = _raw_points(per_key, N)
    seeded = PCache.from_affine(pstate, raw[:10], device="cpu")  # the rest imported
    assert len(seeded) == N
    assert np.array_equal(convert.to_numpy(seeded.device_array()), want)
    assert np.array_equal(convert.to_numpy(seeded.device_gather([3, 0, 15])), want[[3, 0, 15]])
    for i in range(N):
        assert seeded.get(i) == per_key.get(i)
        assert seeded.get_point(i) == ref.get_point(i)
        pk = bytes(state.validators[i].pubkey)
        assert seeded.get_index(pk) == per_key.get_index(pk) == ref.get_index(pk) == i
    assert seeded.get(N) is None and seeded.get_index(b"\x00" * 48) is None
    bad = raw.copy()
    bad[5, 95] ^= 1  # y's sign flips: x still matches, the compressed key does not
    bad[5, 48:] = raw[6, 48:]
    with pytest.raises(ValueError, match="seeded pubkey 5"):
        PCache.from_affine(pstate, bad, device="cpu")
    # y off the curve in the same sign class: the compressed key still matches
    ys = [int.from_bytes(raw[i, 48:].tobytes(), "big") for i in range(N)]
    for i, y in ((5, ys[5] ^ 2), next((i, y + P) for i, y in enumerate(ys) if y > (P - 1) // 2)):
        bad = raw.copy()
        bad[i, 48:] = np.frombuffer(y.to_bytes(48, "big"), np.uint8)
        assert np.array_equal(p_compress(bad), p_compress(raw))
        with pytest.raises(ValueError, match=f"seeded pubkey {i} is not on the curve"):
            PCache.from_affine(pstate, bad, device="cpu")
    chain = PChain(p_minimal(), pstate, pubkey_cache=seeded)
    assert chain.pubkey_cache is seeded and len(seeded) == N


def _memo_values(st_mod, spec, state):
    e = st_mod.get_current_epoch(spec, state)
    return ([st_mod.get_active_validator_indices(state, x).tolist() for x in (e, e + 1)],
            st_mod.get_total_active_balance(spec, state),
            [st_mod.get_committee_count_per_slot(spec, state, x) for x in (e, e + 1)])


def test_per_epoch_memo_equal_to_uncached_reference():
    """A block carrying a voluntary exit and a proposer slashing (through
    the chain's own ``produce_block_on_state`` and the reference's pool),
    then an epoch boundary that enters altair: at each point the port's
    memoised values (filled before the change) equal the reference's
    uncached functions on the same state."""
    kw = dict(altair_fork_epoch=1, shard_committee_period=0)
    pair = Pair(n=32, **kw)
    rspec, pspec, h = pair.rspec, pair.pspec, pair.h
    pstate = pair.port(h.state)
    r_st.process_slots(rspec, h.state, 1)
    p_st.process_slots(pspec, pstate, 1)
    before = _memo_values(p_st, pspec, pstate)
    pool = RPool(rspec, h.ns.Attestation)
    exit_msg = r_con.VoluntaryExit(epoch=0, validator_index=5)
    dom = get_domain(rspec, h.state, rspec.DOMAIN_VOLUNTARY_EXIT, epoch=0)
    pool.insert_voluntary_exit(r_con.SignedVoluntaryExit(
        message=exit_msg, signature=h._sign(5, compute_signing_root(exit_msg, dom))))
    dom = get_domain(rspec, h.state, rspec.DOMAIN_BEACON_PROPOSER, epoch=0)
    headers = []
    for body_root in (b"\x01" * 32, b"\x02" * 32):
        hdr = r_con.BeaconBlockHeader(slot=1, proposer_index=7, parent_root=b"\x00" * 32,
                                      state_root=b"\x00" * 32, body_root=body_root)
        headers.append(r_con.SignedBeaconBlockHeader(
            message=hdr, signature=h._sign(7, compute_signing_root(hdr, dom))))
    pool.insert_proposer_slashing(r_con.ProposerSlashing(signed_header_1=headers[0],
                                                         signed_header_2=headers[1]))
    proposer = r_st.get_beacon_proposer_index(rspec, h.state)
    block, _ = pair.r.produce_block_on_state(h.state, 1, h.randao_reveal(h.state, proposer, 0),
                                             op_pool=pool)
    assert len(block.body.voluntary_exits) == 1 and len(block.body.proposer_slashings) == 1
    signed = h.ns.block_types["phase0"](message=block, signature=h._sign(
        proposer, compute_signing_root(block, dom)))
    pair.set_slot(1)
    r_root = pair.r.process_block(signed)
    assert pair.p.process_block(pair.port(signed)) == r_root
    post = pair.p.state_by_root(r_root)
    assert int(post.validators[5].exit_epoch) < 2**64 - 1 and post.validators[7].slashed
    p_st.per_block_processing(pspec, pstate, pair.port(signed),
                              strategy=p_st.BlockSignatureStrategy.NO_VERIFICATION)
    fresh = r_con.for_preset("minimal").state_types["phase0"].decode(pstate.serialize())
    assert _memo_values(p_st, pspec, pstate) == _memo_values(r_st, rspec, fresh) == before
    copy = pstate.copy()
    assert copy._committee_caches == pstate._committee_caches
    assert copy._committee_caches is not pstate._committee_caches
    spe = pspec.preset.SLOTS_PER_EPOCH
    p_st.process_slots(pspec, pstate, spe + 1)  # the boundary upgrades to altair
    assert pstate.fork_name == "altair" and int(copy.slot) == 1
    assert copy._committee_caches  # the copy's memo survives the original's invalidation
    fresh = r_con.for_preset("minimal").state_types["altair"].decode(pstate.serialize())
    assert _memo_values(p_st, pspec, pstate) == _memo_values(r_st, rspec, fresh)
    assert _memo_values(p_st, pspec, copy) == before
