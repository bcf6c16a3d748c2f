"""The port's socket stack: boot node, gossipsub mesh, and range sync over
TCP against reference nodes.

``lighthouse_tpu_torch.network.{socket_transport,gossipsub,boot_node}`` are
the port's copies of the reference's. The wire is shared: a port node and a
reference node on 127.0.0.1 exchange HELLO, Status and BlocksByRange frames
through one connection, and each range-syncs a 12-slot chain (the
reference's ``StateHarness``, phase0, no attestations) from the other, to
the same head. The boot nodes answer each other's clients. The gossipsub
mesh keeps its degree in bounds, prunes above ``d_hi``, and draws its
choices from the transport's own seeded ``random.Random``: the peers it
grafts are the ones the reference grafts under ``random.seed`` with the
same seed. Exact equality everywhere.
"""

import random
import socket
import time

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.network import BeaconNodeService as RService
from lighthouse_tpu.network import BootNode as RBootNode
from lighthouse_tpu.network import GossipsubParams as RParams
from lighthouse_tpu.network import GossipsubTransport as RGossipsub
from lighthouse_tpu.network import SocketTransport as RSocket
from lighthouse_tpu.network.boot_node import client_announce as r_announce
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain.pubkey_cache import ValidatorPubkeyCache as PCache
from lighthouse_tpu_torch.network import BeaconNodeService as PService
from lighthouse_tpu_torch.network import BootNode as PBootNode
from lighthouse_tpu_torch.network import GossipsubParams as PParams
from lighthouse_tpu_torch.network import GossipsubTransport as PGossipsub
from lighthouse_tpu_torch.network import SocketTransport as PSocket
from lighthouse_tpu_torch.network import Topic as PTopic
from lighthouse_tpu_torch.network.boot_node import client_announce as p_announce
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

PHASE0 = dict(altair_fork_epoch=2**64 - 1)
SLOTS = 12
TOPIC = PTopic.BEACON_ATTESTATION


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
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


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


# -- boot node ----------------------------------------------------------------------------


def _wake_reference_boot(boot):
    """Set the reference boot node's stop flag and send its serve loop one
    datagram, without waiting for the reply (a loaded host may answer late):
    the loop returns after that datagram and ``boot.stop()`` joins it."""
    boot._stop.set()
    host, port = boot.local_addr.rsplit(":", 1)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.sendto(b"ANNOUNCE 127.0.0.1:1", (host, int(port)))



def test_boot_nodes_answer_each_others_clients():
    for Boot, announce in ((PBootNode, r_announce), (RBootNode, p_announce)):
        boot = Boot().start()
        if Boot is RBootNode:  # wake the reference's serve loop for its stop
            wake = _wake_reference_boot
        else:
            wake = (lambda b: None)
        try:
            assert announce(boot.local_addr, "127.0.0.1:9001") == []
            assert announce(boot.local_addr, "127.0.0.1:9002") == ["127.0.0.1:9001"]
            assert set(announce(boot.local_addr, "127.0.0.1:9003")) == {
                "127.0.0.1:9001", "127.0.0.1:9002"}
            assert boot.known_peers() == ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"]
        finally:
            wake(boot)
            boot.stop()


# -- gossipsub mesh -------------------------------------------------------------------------


class _Quiet:
    def on_gossip(self, *a):
        pass

    def on_rpc(self, *a):
        raise AssertionError("no rpc expected")


def _star(Transport, Params, n_leaves, params, **hub_kw):
    """A hub dialling ``n_leaves`` leaves one at a time, each connection's
    HELLO and SUBSCRIBE landed before the next dial, so the hub's peer order
    is the dial order."""
    spec = (p_minimal if Transport is PGossipsub else r_minimal)()
    def make(**kw):
        return Transport(spec, params=Params(**params), run_heartbeat=False, topics=[TOPIC], **kw)

    hub = make(**hub_kw)
    leaves = [make() for _ in range(n_leaves)]
    for t in [hub, *leaves]:
        t.register(t.local_addr, _Quiet())
    for i, leaf in enumerate(leaves):
        assert hub.dial(leaf.local_addr)
        rec = hub.peer_manager._peers
        assert _wait(lambda: leaf.local_addr in rec and rec[leaf.local_addr].connections == 2)
        assert _wait(lambda: len(hub._topic_peers(TOPIC)) == i + 1)
        assert _wait(lambda: len(leaf._topic_peers(TOPIC)) == 1)
    return hub, leaves


def _stop(*ts):
    """Stop transports of either package; a reference listener is shut down
    first, which wakes its accept loop at once (its ``stop`` only closes it)."""
    for t in ts:
        try:
            t._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        t.stop()


def test_seeded_mesh_grafts_the_peers_the_reference_grafts():
    params = dict(d=3, d_lo=2, d_hi=4, d_lazy=2)
    picks = {}
    for seed in (1, 4):
        hub, leaves = _star(PGossipsub, PParams, 6, params, rng=random.Random(seed))
        try:
            hub.heartbeat()
            order = [t.local_addr for t in leaves]
            port = sorted(order.index(a) for a in hub.mesh_peers(TOPIC))
        finally:
            _stop(hub, *leaves)
        hub, leaves = _star(RGossipsub, RParams, 6, params)
        try:
            random.seed(seed)
            hub.heartbeat()
            order = [t.local_addr for t in leaves]
            ref = sorted(order.index(a) for a in hub.mesh_peers(TOPIC))
        finally:
            _stop(hub, *leaves)
        assert port == ref and len(port) == 3
        picks[seed] = port
    assert picks[1] != picks[4]  # the draw is the transport's, not a fixed order


def test_mesh_degree_in_bounds_and_pruned_above_d_hi():
    """The hub grafts all six leaves (its degree then 6), its bounds drop to
    d = 2, d_hi = 3, and its next heartbeat prunes the mesh back to d; the
    pruned leaves drop the hub from their meshes, the kept ones hold it, and
    a mesh in bounds is left as it is."""
    hub, leaves = _star(PGossipsub, PParams, 6, dict(d=6, d_lo=5, d_hi=12),
                        rng=random.Random(3))
    try:
        for leaf in leaves:
            leaf.params.d, leaf.params.d_lo, leaf.params.d_hi = 2, 1, 3
        hub.heartbeat()
        assert len(hub.mesh_peers(TOPIC)) == 6
        assert _wait(lambda: all(leaf.mesh_peers(TOPIC) == [hub.local_addr] for leaf in leaves))
        hub.params.d, hub.params.d_lo, hub.params.d_hi = 2, 1, 3
        hub.heartbeat()
        kept = hub.mesh_peers(TOPIC)
        assert len(kept) == 2
        pruned = [leaf for leaf in leaves if leaf.local_addr not in kept]
        assert _wait(lambda: all(leaf.mesh_peers(TOPIC) == [] for leaf in pruned))
        assert all(leaf.mesh_peers(TOPIC) == [hub.local_addr] for leaf in leaves
                   if leaf.local_addr in kept)
        hub.heartbeat()
        assert hub.mesh_peers(TOPIC) == kept
    finally:
        _stop(hub, *leaves)


# -- range sync across the packages ----------------------------------------------------------


@pytest.fixture(scope="module")
def chains():
    """A 12-slot chain in both packages (the port's imported as one segment
    on the oracle backend), and the genesis state in both packages' types."""
    rspec, pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
    h = StateHarness(rspec, 16)
    genesis = h.state.copy()
    blocks = []
    for slot in range(1, SLOTS + 1):
        b = h.produce_block(slot)
        h.apply_block(b)
        blocks.append(b)
    rfull = RChain(rspec, genesis.copy(), slot_clock=RClock(SLOTS))
    rfull.process_chain_segment(blocks)
    pgen = convert.state_from_ssz(pspec, "phase0", genesis.serialize())
    pfull = PChain(pspec, pgen.copy(), slot_clock=PClock(SLOTS), pubkey_cache=PCache("cpu"))
    pfull.process_chain_segment([convert.block_from_ssz(pspec, "phase0", b.serialize())
                                 for b in blocks])
    assert pfull.head.root == rfull.head.root
    return {"ref": (rspec, genesis, rfull), "port": (pspec, pgen, pfull)}


def _node(pkg, chains, name_chain):
    spec, genesis, full = chains[pkg]
    Socket, Service, Clock = ((PSocket, PService, PClock) if pkg == "port"
                              else (RSocket, RService, RClock))
    kw = {"device": "cpu"} if pkg == "port" else {}
    t = Socket(spec)
    if name_chain == "full":
        svc = Service(t.local_addr, spec, None, t, slot_clock=Clock(SLOTS), chain=full, **kw)
    else:
        svc = Service(t.local_addr, spec, genesis.copy(), t, slot_clock=Clock(SLOTS), **kw)
    return t, svc


@pytest.mark.parametrize("late_pkg,full_pkg", [("port", "ref"), ("ref", "port")])
def test_range_sync_over_sockets_across_packages(chains, late_pkg, full_pkg):
    full_t, full = _node(full_pkg, chains, "full")
    late_t, late = _node(late_pkg, chains, "late")
    try:
        assert late_t.dial(full_t.local_addr)
        assert _wait(lambda: full_t.local_addr in late_t.peers())
        late.connect(full_t.local_addr)  # status -> range sync on the sync worker
        want = full.chain.head.root
        assert _wait(lambda: late.chain.head.root == want, timeout=60.0)
        assert late.sync.wait_idle(60.0)
        assert late.chain.head.slot == SLOTS
        assert late.chain.head.state.serialize() == full.chain.head.state.serialize()
        assert late.sync.peer_failures == {}
        served = late.blocks_by_range(1, SLOTS)
        assert [b.message.tree_root() for b in served] == [
            b.message.tree_root() for b in full.blocks_by_range(1, SLOTS)]
    finally:
        for t in (late_t, full_t):
            try:
                t._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        late.stop()
        full.stop()


# -- gossip after a one-block range sync (the chip script's socket step, small) ---------------

GOSSIP_VALIDATORS = 512  # minimal phase0: 64 attesters a slot
N_GOSSIP = 64


@pytest.fixture(scope="module")
def one_block():
    """Genesis at 512 validators and one harness block, with the head slot's
    64 single-bit attestations, in both packages' types."""
    from lighthouse_tpu_torch.types.containers import for_preset

    rspec, pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
    h = StateHarness(rspec, GOSSIP_VALIDATORS)
    genesis = h.state.copy()
    block = h.produce_block(1)
    h.apply_block(block)
    atts = h.unaggregated_attestations_for_slot(h.state, 1, h.head_root(h.state))
    assert len(atts) == N_GOSSIP
    pns = for_preset(pspec.preset.name)
    return {
        "ref": (rspec, genesis, [block], atts),
        "port": (pspec, convert.state_from_ssz(pspec, "phase0", genesis.serialize()),
                 [convert.block_from_ssz(pspec, "phase0", block.serialize())],
                 [pns.Attestation.decode(a.serialize()) for a in atts]),
    }


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_range_synced_node_queues_socket_gossip(one_block, pkg):
    """Node B range-syncs node A's one block over a gossipsub socket pair,
    then A publishes the head slot's 64 attestations: all 64 reach B's
    held processor well inside the chip script's 60 s wait, in both
    packages, and verify when it is released."""
    from lighthouse_tpu.beacon_processor import WorkType as RWork
    from lighthouse_tpu_torch.beacon_processor import WorkType as PWork

    spec, genesis, blocks, atts = one_block[pkg]
    Gossip, Service, Clock, Work = ((PGossipsub, PService, PClock, PWork) if pkg == "port"
                                    else (RGossipsub, RService, RClock, RWork))
    kw = {"device": "cpu"} if pkg == "port" else {}
    saved = p_bls.get_backend(), p_bls.get_device()
    p_bls.set_backend("native")
    rng = ({"rng": random.Random(1)}, {"rng": random.Random(2)}) if pkg == "port" else ({}, {})
    ta, tb = Gossip(spec, **rng[0]), Gossip(spec, **rng[1])
    a = Service(ta.local_addr, spec, genesis.copy(), ta, slot_clock=Clock(1), **kw)
    b = Service(tb.local_addr, spec, genesis.copy(), tb, slot_clock=Clock(1), **kw)
    try:
        a.chain.process_chain_segment(blocks)
        assert tb.dial(ta.local_addr)
        assert _wait(lambda: ta.local_addr in tb.peers() and tb.local_addr in ta.peers())
        b.connect(ta.local_addr)  # status -> range sync of the one block
        assert _wait(lambda: b.chain.head.root == a.chain.head.root, timeout=60.0)
        assert b.sync.wait_idle(60.0)
        assert _wait(lambda: ta._topic_peers(TOPIC))
        b.processor.synchronous = False  # held: gossip queues, nothing drains it
        t0 = time.monotonic()
        for att in atts:
            a.publish_attestation(att)
        queued = _wait(lambda: b.processor.queue_len(Work.GossipAttestation) == N_GOSSIP, 60.0)
        took = time.monotonic() - t0
        assert queued, (pkg, b.processor.queue_len(Work.GossipAttestation), took)
        assert took < 10.0, took
        b.processor.synchronous = True
        b.processor.run_until_idle()
        assert b.processor.queue_len(Work.GossipAttestation) == 0
        assert not any(b.processor.dropped.values()) and not any(b.processor.expired.values())
    finally:
        _stop(ta, tb)
        b.stop()
        a.stop()
        p_bls.set_backend(*saved[:1], device=saved[1])
