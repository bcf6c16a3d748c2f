"""The port's operation pools against the reference's.

``lighthouse_tpu_torch.op_pool`` is the port's copy of ``lighthouse_tpu.op_pool``
(greedy max-cover, the attestation pool's packing, the naive per-data
aggregation pool, the sync-contribution pool and the reward cache). The same
inputs must give the same selections and the same bytes in both packages:
packed attestations, merged split aggregates, naive aggregates and sync
aggregates. Attestations and states cross as SSZ bytes from the reference's
``StateHarness`` (signed with its native backend). Host code only; exact
equality.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import op_pool as r_pool
from lighthouse_tpu.op_pool.reward_cache import RewardCache as RRewardCache
from lighthouse_tpu.op_pool.sync_aggregation import SyncContributionPool as RSyncPool
from lighthouse_tpu.ops.bls_oracle import curves as r_oc
from lighthouse_tpu.state_transition import get_beacon_committee, process_slots
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.helpers import compute_signing_root, get_domain
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import op_pool as p_pool
from lighthouse_tpu_torch.op_pool.reward_cache import RewardCache as PRewardCache
from lighthouse_tpu_torch.op_pool.sync_aggregation import SyncContributionPool as PSyncPool
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

N = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _native():
    saved = r_bls.get_backend()
    r_bls.set_backend("native")
    yield
    r_bls.set_backend(saved)


@pytest.fixture(scope="module", params=["phase0", "altair"])
def harness(request):
    """A harness one block in, that block's committee-complete attestations,
    and the packing state (slot 2) in both packages."""
    kw = {} if request.param == "phase0" else {"altair_fork_epoch": 0}
    spec = r_minimal(**kw)
    h = StateHarness(spec, N)
    b1 = h.produce_block(1)
    h.apply_block(b1)
    atts = h.attestations_for_slot(h.state, 1, h.head_root(h.state))
    state = h.state.copy()
    process_slots(spec, state, 2)
    pspec = p_minimal(**kw)
    p_state = convert.state_from_ssz(pspec, request.param, state.serialize())
    return request.param, spec, pspec, h, atts, state, p_state


def _to_port(obj, pspec, name="Attestation"):
    return getattr(p_for_preset(pspec.preset.name), name).decode(obj.serialize())


def _singles(h, spec, att, members):
    """One single-bit attestation per committee position in ``members``,
    signed by that member (the native backend)."""
    committee = get_beacon_committee(spec, h.state, int(att.data.slot), int(att.data.index))
    domain = get_domain(spec, h.state, spec.DOMAIN_BEACON_ATTESTER, epoch=int(att.data.target.epoch))
    root = compute_signing_root(att.data, domain)
    out = []
    for j in members:
        bits = np.zeros(committee.size, dtype=bool)
        bits[j] = True
        out.append(h.ns.Attestation(aggregation_bits=bits, data=att.data,
                                    signature=h._sign(int(committee[j]), root)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maximum_cover_equal(seed):
    rng = np.random.default_rng(seed)
    n = 40
    w = rng.integers(1, 50, n).astype(np.uint64)
    cands = [(rng.random(n) < 0.2, w, f"c{i}") for i in range(25)]
    cands.append((np.zeros(n, dtype=bool), w, "empty"))
    for limit in (0, 1, 3, 8, 30):
        got = p_pool.maximum_cover(cands, limit)
        assert got == r_pool.maximum_cover(cands, limit)
    assert "empty" not in p_pool.maximum_cover(cands, 30)


def test_pool_packing_equal(harness):
    _, spec, pspec, h, atts, state, p_state = harness
    rp = r_pool.OperationPool(spec, h.ns.Attestation)
    pp = p_pool.OperationPool(pspec, p_for_preset("minimal").Attestation)
    for a in atts:
        rp.insert_attestation(a)
        pp.insert_attestation(_to_port(a, pspec))
    assert pp.num_attestations() == rp.num_attestations() == len(atts)
    r_packed = rp.get_attestations(state)
    p_packed = pp.get_attestations(p_state)
    assert [a.serialize() for a in p_packed] == [a.serialize() for a in r_packed]
    assert len(p_packed) == len(atts)


def test_split_attestation_aggregate_equal(harness):
    """Two disjoint half-committee aggregates merge into one variant; a
    subset adds nothing; the packed aggregate is the same bytes."""
    _, spec, pspec, h, atts, state, p_state = harness
    a = atts[0]
    n = np.asarray(a.aggregation_bits).size
    singles = _singles(h, spec, a, range(n))
    halves = []
    for part in (singles[: n // 2], singles[n // 2:]):
        bits = np.any([np.asarray(s.aggregation_bits) for s in part], axis=0)
        sig = None
        for s in part:
            sig = r_oc.g2_add(sig, r_oc.g2_decompress(bytes(s.signature)))
        halves.append(h.ns.Attestation(aggregation_bits=bits, data=a.data,
                                       signature=r_oc.g2_compress(sig)))
    rp = r_pool.OperationPool(spec, h.ns.Attestation)
    pp = p_pool.OperationPool(pspec, p_for_preset("minimal").Attestation)
    for x in halves + [singles[0]]:
        rp.insert_attestation(x)
        pp.insert_attestation(_to_port(x, pspec))
    assert pp.num_attestations() == rp.num_attestations() == 1
    r_packed, p_packed = rp.get_attestations(state), pp.get_attestations(p_state)
    assert [x.serialize() for x in p_packed] == [x.serialize() for x in r_packed]
    assert np.asarray(p_packed[0].aggregation_bits).all()
    assert bytes(p_packed[0].signature) == bytes(a.signature)


def test_naive_aggregation_equal(harness):
    _, spec, pspec, h, atts, _, _ = harness
    a = atts[-1]
    n = np.asarray(a.aggregation_bits).size
    singles = _singles(h, spec, a, range(n))
    rp = r_pool.NaiveAggregationPool(h.ns.Attestation)
    pp = p_pool.NaiveAggregationPool(p_for_preset("minimal").Attestation)
    verdicts = []
    for s in singles + singles[:1]:
        verdicts.append((rp.insert(s), pp.insert(_to_port(s, pspec))))
    assert all(r == p for r, p in verdicts)
    assert verdicts[-1] == (False, False)  # the duplicate bit
    got = pp.get(_to_port(a, pspec).data)
    assert got.serialize() == rp.get(a.data).serialize()
    assert bytes(got.signature) == bytes(a.signature)
    root = type(a.data).hash_tree_root(a.data)
    assert pp.get_by_root(root).serialize() == rp.get_by_root(root).serialize()
    rp.prune(10)
    pp.prune(10)
    assert pp.get(_to_port(a, pspec).data) is None and rp.get(a.data) is None


def test_sync_contribution_pool_equal():
    spec = r_minimal(altair_fork_epoch=0)
    h = StateHarness(spec, N)
    size = spec.preset.SYNC_COMMITTEE_SIZE
    rp, pp = RSyncPool(size), PSyncPool(size)
    root = b"\x33" * 32
    sigs = [h._sign(i, bytes([i]) * 32) for i in range(8)]
    for i, positions in enumerate(([0], [1, 5], [2], [1], [9, 10])):
        rp.insert_message(3, root, positions, sigs[i])
        pp.insert_message(3, root, positions, sigs[i])
    ns, pns = h.ns, p_for_preset("minimal")
    sub = size // 4
    for k, sub_index in enumerate((2, 3)):
        bits = np.zeros(sub, dtype=bool)
        bits[k::3] = True
        c = ns.SyncCommitteeContribution(slot=3, beacon_block_root=root,
                                         subcommittee_index=sub_index,
                                         aggregation_bits=bits, signature=sigs[5 + k])
        rp.insert_contribution(c)
        pp.insert_contribution(pns.SyncCommitteeContribution.decode(c.serialize()))
    for slot, r in ((3, root), (4, root), (3, b"\x00" * 32)):
        assert (pp.get_sync_aggregate(pns, slot, r).serialize()
                == rp.get_sync_aggregate(ns, slot, r).serialize())
    rp.prune(6)
    pp.prune(6)
    assert pp.get_sync_aggregate(pns, 3, root).serialize() == rp.get_sync_aggregate(ns, 3, root).serialize()


def test_reward_cache_equal(harness):
    _, spec, pspec, _, _, state, p_state = harness
    rc, pc = RRewardCache(), PRewardCache()
    rc.update(spec, state)
    pc.update(pspec, p_state)
    n = len(state.validators)
    for epoch in range(0, 3):
        assert np.array_equal(pc.weights_for_epoch(epoch, n), rc.weights_for_epoch(epoch, n))
