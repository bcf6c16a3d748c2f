"""The port's persistence, restart-from-disk recovery and fork revert against
the reference's.

``lighthouse_tpu_torch.{fork_choice,op_pool}.persistence``,
``beacon_chain.recovery`` and ``beacon_chain.fork_revert`` are the port's
copies of the reference's modules; the port's chain persists fork choice at
its import barrier on a durable store. A reference node and a port node on
the same anchor import the same harness blocks (the reference's
``StateHarness``, signed with its native backend; the port verifies on its
``"oracle"`` backend) into ``HotColdDB``s over ``LevelStore``s under
``tmp_path``, take the same gossip attestations into their pools, are
dropped and reopened, and must agree exactly: snapshot bytes (each restores
the other's), the recovered head, fork-choice nodes and weights, finalized
checkpoint, pool and recovery report; the outcome of a kill at each crash
point; the revert of a bad subtree; and a slasher that convicts a
post-restart double vote from a pre-restart vote.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.beacon_chain.fork_revert import revert_to_fork_boundary as r_revert
from lighthouse_tpu.beacon_chain.recovery import recover_node_state as r_recover
from lighthouse_tpu.fork_choice import persistence as r_fcp
from lighthouse_tpu.op_pool import OperationPool as RPool
from lighthouse_tpu.op_pool import persistence as r_pp
from lighthouse_tpu.resilience import InjectedCrash as RCrash
from lighthouse_tpu.resilience import injector as r_injector
from lighthouse_tpu.slasher import SlasherConfig as RSlasherConfig
from lighthouse_tpu.slasher import SlasherService as RSlasherService
from lighthouse_tpu.slasher import make_slasher as r_make_slasher
from lighthouse_tpu.store.hot_cold import HotColdDB as RDB
from lighthouse_tpu.store.kv import LevelStore as RLevel
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import slasher as p_slasher
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain.fork_revert import revert_to_fork_boundary as p_revert
from lighthouse_tpu_torch.beacon_chain.recovery import recover_node_state as p_recover
from lighthouse_tpu_torch.beacon_chain.recovery import snapshot_recovery_totals
from lighthouse_tpu_torch.fork_choice import persistence as p_fcp
from lighthouse_tpu_torch.op_pool import OperationPool as PPool
from lighthouse_tpu_torch.op_pool import persistence as p_pp
from lighthouse_tpu_torch.resilience.crashpoints import InjectedCrash as PCrash
from lighthouse_tpu_torch.resilience import injector as p_injector
from lighthouse_tpu_torch.slasher import SlasherConfig as PSlasherConfig
from lighthouse_tpu_torch.slasher import SlasherService as PSlasherService
from lighthouse_tpu_torch.slasher import make_slasher as p_make_slasher
from lighthouse_tpu_torch.store import HotColdDB as PDB
from lighthouse_tpu_torch.store.kv import LevelStore as PLevel
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.metrics import REGISTRY as P_REGISTRY
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

N = 16
PHASE0 = dict(altair_fork_epoch=2**64 - 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(),
             p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device(),
             p_slasher.get_backend(), p_slasher.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("oracle")
    p_epoch.set_backend("numpy")
    p_slasher.set_backend("device", device="cpu")
    r_injector.clear()
    p_injector.clear()
    yield
    r_injector.clear()
    p_injector.clear()
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    p_slasher.set_backend(saved[6], device=saved[7])


class Nodes:
    """A reference node and a port node on one anchor, each a chain and an
    op pool over a ``HotColdDB`` of two ``LevelStore``s under ``root`` (or
    ``MemoryStore``s when ``root`` is None); one harness produces the
    blocks and gossip for both."""

    def __init__(self, root=None):
        self.rspec, self.pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
        self.h = StateHarness(self.rspec, N)
        self.anchor = self.h.state.copy()
        self.root = root
        self.rclock, self.pclock = RClock(0), PClock(0)
        self.ns = p_con.for_preset("minimal")
        self.r = RChain(self.rspec, self.anchor.copy(), store=self._store("r"),
                        slot_clock=self.rclock)
        self.p = PChain(self.pspec, self.port(self.anchor), store=self._store("p"),
                        slot_clock=self.pclock)
        self.rpool = RPool(self.rspec, self.r.ns.Attestation)
        self.ppool = PPool(self.pspec, self.p.ns.Attestation)

    def _store(self, who):
        if self.root is None:
            return RDB() if who == "r" else PDB()
        level, db = (RLevel, RDB) if who == "r" else (PLevel, PDB)
        d = self.root / who
        return db(hot=level(str(d / "chain.db"), owner=who),
                  cold=level(str(d / "freezer.db"), owner=who))

    def port(self, obj):
        """A reference state, signed block or container as the port's."""
        if hasattr(obj, "validators"):
            return convert.state_from_ssz(self.pspec, obj.fork_name, obj.serialize())
        if hasattr(obj, "message") and hasattr(obj.message, "body"):
            fork = self.rspec.fork_name_at_slot(int(obj.message.slot))
            return convert.block_from_ssz(self.pspec, fork, obj.serialize())
        name = type(obj).__name__
        cls = getattr(self.ns, name, None) or getattr(p_con, name)
        return cls.decode(obj.serialize())

    def set_slot(self, slot):
        self.rclock.set_slot(slot)
        self.pclock.set_slot(slot)

    def block(self, slot):
        b = self.h.produce_block(slot)
        self.h.apply_block(b)
        return b

    def extend(self, slots, gossip=True):
        """One block a slot into both chains (each import persists fork
        choice on a durable store), then the slot's unaggregated attestations
        through both gossip batch paths and into both pools. Returns the
        block roots."""
        roots = []
        for slot in slots:
            self.set_slot(slot)
            b = self.block(slot)
            root = self.r.process_block(b)
            assert self.p.process_block(self.port(b)) == root
            roots.append(root)
            if gossip:
                atts = self.h.unaggregated_attestations_for_slot(self.h.state, slot, root)
                rv = self.r.verify_unaggregated_attestations(atts)
                pv = self.p.verify_unaggregated_attestations([self.port(a) for a in atts])
                assert [isinstance(x, Exception) for _, x in pv] == [
                    isinstance(x, Exception) for _, x in rv]
                for a in atts:
                    self.rpool.insert_attestation(a)
                    self.ppool.insert_attestation(self.port(a))
        return roots

    def persist_pools(self):
        r_pp.persist(self.r.store, self.rpool)
        p_pp.persist(self.p.store, self.ppool)

    def recover(self):
        """Drop both nodes (their stores' files closed), reopen the stores and
        recover: (reference (chain, pool, report), port's)."""
        for chain in (self.r, self.p):
            for kv in (chain.store.hot, chain.store.cold):
                try:
                    kv.close()  # release the dead node's file handles
                except Exception:  # noqa: BLE001 — torn or closed already
                    pass
        self.r = self.p = None
        r = r_recover(self.rspec, self.anchor.copy(), self._store("r"), slot_clock=self.rclock)
        p = p_recover(self.pspec, self.port(self.anchor), self._store("p"), slot_clock=self.pclock)
        self.r, self.rpool = r[0], r[1]
        self.p, self.ppool = p[0], p[1]
        return r, p


def _nodes_view(chain):
    fc = chain.fork_choice
    return ([(n.root, n.parent, int(n.weight), n.best_child, n.best_descendant,
              n.justified_epoch, n.finalized_epoch) for n in fc.proto.nodes],
            fc.store.justified_checkpoint, fc.store.finalized_checkpoint)


def _same_recovery(r, p):
    (rc, rpool, rrep), (pc, ppool, prep) = r, p
    assert pc.head.root == rc.head.root and pc.head.slot == rc.head.slot
    assert _nodes_view(pc) == _nodes_view(rc)
    np.testing.assert_array_equal(pc.fork_choice.proto._vote_next, rc.fork_choice.proto._vote_next)
    assert p_pp.serialize_pool(ppool) == r_pp.serialize_pool(rpool)
    assert set(pc._blocks) == set(rc._blocks) and set(pc._states) == set(rc._states)
    want = {k: v for k, v in rrep.items() if k != "recovery_s"}
    assert {k: v for k, v in prep.items() if k != "recovery_s"} == want


# =============================================================================
# snapshots: the reference's bytes, restored across packages
# =============================================================================


def test_snapshots_equal_the_reference_and_restore_across():
    nodes = Nodes()
    nodes.extend(range(1, 6))
    s = nodes.h.state
    # an attester slashing beside the attestations (the pool's other list)
    def vote(root):
        return nodes.r.ns.IndexedAttestation(
            attesting_indices=[1], signature=b"\x00" * 96, data=r_con.AttestationData(
                slot=8, index=0, beacon_block_root=root,
                source=r_con.Checkpoint(epoch=0, root=b"\x02" * 32),
                target=r_con.Checkpoint(epoch=1, root=b"\x03" * 32)))

    sl = nodes.r.ns.AttesterSlashing(attestation_1=vote(b"\x01" * 32),
                                     attestation_2=vote(b"\x04" * 32))
    nodes.rpool.insert_attester_slashing(sl)
    nodes.ppool.insert_attester_slashing(nodes.port(sl))

    r_blob, p_blob = r_fcp.serialize_fork_choice(nodes.r.fork_choice), \
        p_fcp.serialize_fork_choice(nodes.p.fork_choice)
    assert p_blob == r_blob
    from_r = p_fcp.restore_fork_choice(nodes.pspec, r_blob)
    from_p = r_fcp.restore_fork_choice(nodes.rspec, p_blob)
    assert p_fcp.serialize_fork_choice(from_r) == r_fcp.serialize_fork_choice(from_p) == r_blob
    assert from_r.get_head(6) == from_p.get_head(6) == nodes.r.fork_choice.get_head(6)

    r_pool_blob, p_pool_blob = r_pp.serialize_pool(nodes.rpool), p_pp.serialize_pool(nodes.ppool)
    assert p_pool_blob == r_pool_blob and nodes.ppool.num_attestations() > 0
    p2, r2 = PPool(nodes.pspec, nodes.p.ns.Attestation), RPool(nodes.rspec, nodes.r.ns.Attestation)
    n = nodes.ppool.num_attestations()
    assert p_pp.restore_pool(p2, nodes.p.ns, r_pool_blob) == r_pp.restore_pool(
        r2, nodes.r.ns, p_pool_blob) > 0
    assert p2.num_attestations() == r2.num_attestations() == n
    assert p_pp.serialize_pool(p2) == r_pp.serialize_pool(r2) == r_pool_blob
    packed = [type(a).encode(a) for a in r2.get_attestations(s)]
    assert [type(a).encode(a) for a in p2.get_attestations(nodes.port(s))] == packed


# =============================================================================
# restart from disk
# =============================================================================


def test_recover_node_state_equals_the_reference(tmp_path):
    """Both nodes import blocks over LevelStores (fork choice persisted at
    every import), persist their pools, are dropped and reopened:
    ``recover_node_state`` gives the reference's head, fork choice, pool,
    rehydrated blocks and states and report; both keep importing."""
    nodes = Nodes(tmp_path)
    assert nodes.p._durable
    before = snapshot_recovery_totals()["recoveries"]
    nodes.extend(range(1, 6))
    head, view = nodes.p.head.root, _nodes_view(nodes.p)
    nodes.persist_pools()
    r, p = nodes.recover()
    _same_recovery(r, p)
    assert p[2]["fork_choice_restored"] and p[2]["fc_nodes"] == 6 and p[2]["pool_restored"] > 0
    assert p[2]["replayed_records"] > 0 and p[2]["truncated_bytes"] == 0
    assert p[0].head.root == head and _nodes_view(p[0]) == view
    assert snapshot_recovery_totals()["recoveries"] == before + 1
    assert "resilience_recoveries_total" in P_REGISTRY.render()
    nodes.extend([6, 7])
    assert nodes.p.head.root == nodes.r.head.root and nodes.p.head.slot == 7


def test_recover_with_a_seeded_pubkey_cache(tmp_path):
    """The port's one difference: ``pubkey_cache=`` reaches the chain, so a
    restart can seed its keys from stored affine points."""
    from lighthouse_tpu_torch.beacon_chain import ValidatorPubkeyCache
    from lighthouse_tpu_torch.oracle import curves as oc

    nodes = Nodes(tmp_path)
    nodes.extend([1], gossip=False)
    for chain in (nodes.r, nodes.p):
        for kv in (chain.store.hot, chain.store.cold):
            kv.close()
    state = nodes.port(nodes.anchor)
    raw = np.zeros((N, 96), dtype=np.uint8)
    for i, v in enumerate(state.validators):
        x, y = oc.g1_decompress(bytes(v.pubkey))
        raw[i] = np.frombuffer(x.to_bytes(48, "big") + y.to_bytes(48, "big"), np.uint8)
    cache = ValidatorPubkeyCache.from_affine(state, raw, device="cpu")
    chain, _, report = p_recover(nodes.pspec, state, nodes._store("p"), slot_clock=nodes.pclock,
                                 pubkey_cache=cache)
    assert chain.pubkey_cache is cache and report["head_slot"] == 1


def test_fresh_and_foreign_snapshots_boot_from_the_anchor(tmp_path):
    """Recovery degrades, never refuses: empty stores, a corrupt snapshot
    and one foreign to the anchor each give a fresh anchor boot, on both
    packages alike."""
    r = r_recover(r_minimal(**PHASE0), StateHarness(r_minimal(**PHASE0), 8).state.copy(), RDB())
    nodes = Nodes(tmp_path)
    p = p_recover(nodes.pspec, nodes.port(StateHarness(nodes.rspec, 8).state), PDB())
    for rep in (r[2], p[2]):
        assert not rep["fork_choice_restored"] and rep["pool_restored"] == 0
        assert rep["head_slot"] == 0 and rep["replayed_records"] == 0
    for blob in (b"{not json", r_fcp.serialize_fork_choice(r[0].fork_choice)):
        rs, ps = RDB(), PDB()
        rs.put_meta(r_fcp.META_KEY, blob)
        ps.put_meta(p_fcp.META_KEY, blob)
        rr = r_recover(nodes.rspec, nodes.anchor.copy(), rs)
        pp = p_recover(nodes.pspec, nodes.port(nodes.anchor), ps)
        assert not pp[2]["fork_choice_restored"] and pp[0].head.slot == 0
        assert pp[0].head.root == rr[0].head.root and not rr[2]["fork_choice_restored"]


@pytest.mark.parametrize("plan, tear", [
    ("stage=persist.fork_choice;mode=kill;at=3", False),
    ("stage=persist.op_pool;mode=kill;at=2", False),
    ("stage=store.commit;mode=kill;at=7", False),
    ("stage=store.commit;mode=tear;at=9", True),
])
def test_crash_points_give_the_reference_outcome(tmp_path, plan, tear):
    """A kill (or a torn frame) at a persistence barrier while both nodes
    import blocks and persist their pools after each: the same barrier fires
    on both, the reopened stores truncate exactly the torn tail (none after a
    kill) and recovery lands on the same head, at worst one block back."""
    nodes = Nodes(tmp_path)
    nodes.extend([1], gossip=False)
    r_injector.install(plan)
    p_injector.install(plan)
    died = {}
    for slot in range(2, 6):
        nodes.set_slot(slot)
        b = nodes.block(slot)
        for who, chain, pool, pp, crash, blk in (
                ("r", nodes.r, nodes.rpool, r_pp, RCrash, b),
                ("p", nodes.p, nodes.ppool, p_pp, PCrash, nodes.port(b))):
            if who in died:
                continue
            try:
                chain.process_block(blk)
                pp.persist(chain.store, pool)
            except crash:
                died[who] = slot
        if died:
            break
    r_injector.clear()
    p_injector.clear()
    assert died.get("p") == died.get("r") and "p" in died, died
    r, p = nodes.recover()
    _same_recovery(r, p)
    rep = p[2]
    assert (rep["truncated_bytes"] > 0) == tear
    assert rep["head_slot"] >= died["p"] - 1  # at worst one block back


def test_slasher_checkpoint_crash_point_keeps_the_last_checkpoint():
    """A kill at ``persist.slasher`` leaves the previous checkpoint: both
    packages restore the same records, and the pre-crash vote convicts."""
    from lighthouse_tpu.store.kv import MemoryStore as RMem

    from lighthouse_tpu_torch.store.kv import MemoryStore as PMem

    cfg = dict(validator_chunk_size=16, history_length=64)
    rs, ps = RMem(), PMem()
    rsl = r_make_slasher(rs, r_con.for_preset("minimal"), RSlasherConfig(**cfg), backend="numpy")
    psl = p_make_slasher(ps, p_con.for_preset("minimal"), PSlasherConfig(**cfg))

    def vote(pkg, v, root):
        con = r_con if pkg == "r" else p_con
        return con.for_preset("minimal").IndexedAttestation(
            attesting_indices=[v], data=con.AttestationData(
                slot=32, index=0, beacon_block_root=root,
                source=con.Checkpoint(epoch=2, root=b"\x01" * 32),
                target=con.Checkpoint(epoch=4, root=b"\x02" * 32)),
            signature=b"\x00" * 96)

    for sl, pkg in ((rsl, "r"), (psl, "p")):
        sl.accept_attestation(vote(pkg, 5, b"\x11" * 32))
        sl.process_queued(4)
        assert sl.persist()
        sl.accept_attestation(vote(pkg, 6, b"\x11" * 32))
        sl.process_queued(4)
    r_injector.install("stage=persist.slasher;mode=kill;at=1")
    p_injector.install("stage=persist.slasher;mode=kill;at=1")
    with pytest.raises(RCrash):
        rsl.persist()
    with pytest.raises(PCrash):
        psl.persist()
    r_injector.clear()
    p_injector.clear()
    rsl = r_make_slasher(rs, r_con.for_preset("minimal"), RSlasherConfig(**cfg), backend="numpy")
    psl = p_make_slasher(ps, p_con.for_preset("minimal"), PSlasherConfig(**cfg))
    assert len(psl._atts) == len(rsl._atts) == 1 and psl.span.mode == "device"
    for sl, pkg in ((rsl, "r"), (psl, "p")):
        sl.accept_attestation(vote(pkg, 5, b"\x99" * 32))
        assert sl.process_queued(5)["double_vote_slashings"] == 1
    keys = [sorted(type(s).hash_tree_root(s) for s in sl.get_attester_slashings())
            for sl in (rsl, psl)]
    assert keys[0] == keys[1] != []


def test_equivocator_convicted_across_restart(tmp_path):
    """tests/test_crash_recovery.py's restart gap, on the port's node: a
    slasher service on the chain's observers checkpoints into the hot store
    every tick; the node is dropped and recovered from disk with a slasher
    from ``make_slasher(store.hot)``, and a validator's vote after the
    restart that conflicts with its vote from before is convicted into the
    recovered pool — the same slashing as the reference node's."""
    nodes = Nodes(tmp_path)
    cfg = dict(validator_chunk_size=16, history_length=64)
    svcs = {}
    for who, chain, pool, make, svc_cls, scfg in (
            ("r", nodes.r, nodes.rpool, r_make_slasher, RSlasherService, RSlasherConfig),
            ("p", nodes.p, nodes.ppool, p_make_slasher, PSlasherService, PSlasherConfig)):
        kw = {"backend": "numpy"} if who == "r" else {}
        svc = svc_cls(chain, make(chain.store.hot, chain.ns, scfg(**cfg), **kw), pool)
        chain.attestation_observers.append(svc.attestation_observed)
        chain.block_observers.append(svc.block_observed)
        svcs[who] = svc
    nodes.extend(range(1, 4))
    for svc in svcs.values():
        svc.tick(current_epoch=0)
    voters = sorted(svcs["p"].slasher._records.get(0, {}))
    assert voters and voters == sorted(svcs["r"].slasher._records.get(0, {}))
    r, p = nodes.recover()
    _same_recovery(r, p)
    found = []
    for who, (chain, pool, _), make, svc_cls, scfg, con in (
            ("r", r, r_make_slasher, RSlasherService, RSlasherConfig, r_con),
            ("p", p, p_make_slasher, PSlasherService, PSlasherConfig, p_con)):
        kw = {"backend": "numpy"} if who == "r" else {}
        svc = svc_cls(chain, make(chain.store.hot, chain.ns, scfg(**cfg), **kw), pool)
        assert voters[0] in svc.slasher._records.get(0, {}), "no pre-crash record"
        evil = chain.ns.IndexedAttestation(
            attesting_indices=[voters[0]], data=con.AttestationData(
                slot=1, index=0, beacon_block_root=b"\xee" * 32,
                source=con.Checkpoint(epoch=0, root=b"\x00" * 32),
                target=con.Checkpoint(epoch=0, root=b"\xee" * 32)),
            signature=b"\x00" * 96)
        svc.attestation_observed(evil)
        svc.tick(current_epoch=0)
        if who == "p":
            assert svc.slasher.span.mode == "device"
        found.append(sorted(type(s).hash_tree_root(s) for s in pool._attester_slashings))
    assert found[0] == found[1] and len(found[1]) == 1


# =============================================================================
# fork revert
# =============================================================================


def test_revert_drops_the_bad_subtree_as_the_reference():
    """tests/test_fork_revert.py's scenario on both chains: reverting the
    slot-4 block drops 4-5 everywhere, the head falls to 3, and a
    replacement slot-4 block imports and becomes head; reverting the first
    block falls back to the anchor."""
    nodes = Nodes()
    roots = dict(zip(range(1, 6), nodes.extend(range(1, 6), gossip=False)))
    assert p_revert(nodes.p, roots[4]) == r_revert(nodes.r, roots[4]) == roots[3]
    assert nodes.p.head.slot == 3 and _nodes_view(nodes.p) == _nodes_view(nodes.r)
    for s in (4, 5):
        assert roots[s] not in nodes.p._blocks and roots[s] not in nodes.p.fork_choice.proto.indices
    h2 = StateHarness(nodes.rspec, N)
    for slot in range(1, 4):
        h2.apply_block(h2.produce_block(slot))
    nodes.set_slot(4)
    b4 = h2.produce_block(4)
    assert nodes.p.process_block(nodes.port(b4)) == nodes.r.process_block(b4) == nodes.p.head.root
    assert p_revert(nodes.p, roots[1]) == r_revert(nodes.r, roots[1]) == nodes.p.genesis_block_root
    assert len(nodes.p.fork_choice.proto.nodes) == 1
