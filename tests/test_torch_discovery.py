"""The port's ENR discovery against the reference's.

``lighthouse_tpu_torch.network.discovery`` is the port's copy of the
reference's discv5-style service: signed ENRs (identity scheme "bls", signed
with the port's oracle, verified with its native backend), the XOR routing
table, stateless WHOAREYOU cookies and the iterative lookup. ENR bytes are
equal across packages and each package verifies the other's records; a port
node and a reference node meet through one boot record; ``SocketTransport``
dials what a lookup finds and a ban removes the record; a client built with
``boot_enrs`` finds its peers through discovery alone, and a block published
to one node of such a pair reaches the other's head over gossip, in both
packages. Unlike the reference, the port's service loads the native backend
when it is built and refuses to start without it.
"""

import json
import socket
import struct
import time
import urllib.request

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.client import ClientBuilder as RBuilder
from lighthouse_tpu.client import ClientConfig as RConfig
from lighthouse_tpu.network import discovery as rdisc
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.helpers import compute_fork_digest
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import slasher as p_slasher
from lighthouse_tpu_torch.client import ClientBuilder as PBuilder
from lighthouse_tpu_torch.client import ClientConfig as PConfig
from lighthouse_tpu_torch.kzg import engine as p_kzg
from lighthouse_tpu_torch.native import build as pbuild
from lighthouse_tpu_torch.network import discovery as pdisc
from lighthouse_tpu_torch.network.peer_manager import BAN_THRESHOLD
from lighthouse_tpu_torch.network.socket_transport import SocketTransport as PSocket
from lighthouse_tpu_torch.oracle import ciphersuite as cs
from lighthouse_tpu_torch.oracle import curves as oc
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

PHASE0 = dict(altair_fork_epoch=2**64 - 1)
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
             p_epoch.get_backend(), p_epoch.get_device(), p_kzg.get_kzg_backend(),
             p_kzg.get_kzg_device(), p_slasher.get_backend(), p_slasher.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("native")
    p_epoch.set_backend("numpy")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    p_kzg.set_kzg_backend(saved[6], device=saved[7])
    p_slasher.set_backend(saved[8], device=saved[9])


def _wait_for(cond, timeout=8.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _stop(*services):
    for s in services:
        s.stop()


# -- ENRs and the routing table -------------------------------------------------------------


def test_enr_bytes_equal_and_cross_verified():
    sk = cs.keygen_from_ikm(b"\x05" * 32)
    pk = oc.g1_compress(cs.sk_to_pk(sk))
    fields = (3, b"\x01\x02\x03\x04", "127.0.0.1", 9000, 9001, pk)
    p, r = pdisc.ENR(*fields).sign(sk), rdisc.ENR(*fields).sign(sk)
    assert p.encode() == r.encode()
    assert p.node_id == r.node_id and p.tcp_addr == r.tcp_addr and p.udp_addr == r.udp_addr
    # each package verifies the other's record; tampering breaks both
    rp, off = rdisc.ENR.decode(p.encode())
    pr, _ = pdisc.ENR.decode(r.encode())
    assert off == len(p.encode()) and rp.verify() and pr.verify()
    raw = bytearray(p.encode())
    raw[11] ^= 0xFF  # inside the fork digest
    assert not pdisc.ENR.decode(bytes(raw))[0].verify()
    assert not rdisc.ENR.decode(bytes(raw))[0].verify()
    # live services: a port node's own record verifies on the reference
    d = pdisc.DiscoveryService(fork_digest=b"\x01\x02\x03\x04", tcp_port=9100)
    try:
        assert rdisc.ENR.decode(d.enr.encode())[0].verify()
        assert d.enr.seq == 1 and d.enr.tcp == 9100
        d.update_tcp_port(9200)
        assert d.enr.seq == 2 and rdisc.ENR.decode(d.enr.encode())[0].verify()
    finally:
        d.stop()


def test_malformed_record_is_a_false_verdict():
    sk = cs.keygen_from_ikm(b"\x06" * 32)
    enr = pdisc.ENR(1, b"\x00" * 4, "127.0.0.1", 1, 2, oc.g1_compress(cs.sk_to_pk(sk))).sign(sk)
    assert pdisc._verify_payload(enr.pubkey[:47], enr._content(), enr.sig) is False
    assert pdisc._verify_payload(enr.pubkey, enr._content(), enr.sig[:95]) is False
    assert pdisc._verify_payload(b"\xc0" + bytes(47), enr._content(), enr.sig) is False
    garbage = pdisc.ENR(1, b"\x00" * 4, "127.0.0.1", 1, 2, b"\xaa" * 48, b"\xbb" * 96)
    assert garbage.verify() is False
    with pytest.raises(ValueError):
        pdisc.ENR.decode(enr.encode()[:-1])


def test_routing_table_buckets_equal_the_reference():
    local = b"\x00" * 32
    tables = pdisc.RoutingTable(local), rdisc.RoutingTable(local)
    keys = [bytes([0xA0 + i]) * 48 for i in range(20)]
    for t, mod in zip(tables, (pdisc, rdisc)):
        for i, k in enumerate(keys):
            assert t.admit(mod.ENR(1, b"\x00" * 4, "127.0.0.1", i + 1, i + 1, k))
    p, r = tables
    assert len(p) == len(r) == 20
    for d in range(250, 257):
        assert [e.pubkey for e in p.at_distance(d)] == [e.pubkey for e in r.at_distance(d)]
    target = pdisc.ENR(1, b"\x00" * 4, "x", 0, 0, keys[7]).node_id
    assert [e.pubkey for e in p.closest(target, 5)] == [e.pubkey for e in r.closest(target, 5)]
    assert p.closest(target, 1)[0].pubkey == keys[7]
    assert pdisc.log_distance(local, target) == rdisc.log_distance(local, target)
    p.remove(target)
    r.remove(target)
    assert len(p) == len(r) == 19
    assert [e.pubkey for e in p.all_records()] == [e.pubkey for e in r.all_records()]


# -- the wire's gates --------------------------------------------------------------------------


def test_spoofed_findnode_challenged_before_signature_work(monkeypatch):
    """A FINDNODE without a valid source-address cookie gets a WHOAREYOU no
    larger than the request and costs the port's server no signature work;
    echoing the cookie then yields NODES."""
    fork = b"\x0d\x0d\x0d\x0d"
    srv = pdisc.DiscoveryService(fork_digest=fork).start()
    peer = rdisc.DiscoveryService(fork_digest=fork).start()  # a reference node's record
    atk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    atk.bind(("127.0.0.1", 0))
    atk.settimeout(4.0)
    try:
        peer.bootstrap(rdisc.ENR.decode(srv.enr.encode())[0])
        assert _wait_for(lambda: len(srv.table) == 1)
        peer.stop()
        time.sleep(0.2)
        verifies = []
        orig = pdisc.ENR.verify
        monkeypatch.setattr(pdisc.ENR, "verify", lambda self: verifies.append(1) or orig(self))
        d = pdisc.log_distance(srv.enr.node_id, peer.enr.node_id)
        inner = bytes([1]) + struct.pack(">H", d)
        pkt = peer.enr.encode() + bytes([pdisc._FINDNODE]) + bytes([0]) + inner
        atk.sendto(pkt, srv.enr.udp_addr)
        data, _ = atk.recvfrom(65535)
        _, off = pdisc.ENR.decode(data)
        assert data[off] == pdisc._WHOAREYOU
        cookie = data[off + 1:]
        assert len(cookie) == pdisc._COOKIE_LEN
        assert len(data) <= len(pkt) + pdisc._COOKIE_LEN
        assert verifies == []
        atk.sendto(peer.enr.encode() + bytes([pdisc._FINDNODE, pdisc._COOKIE_LEN]) + cookie + inner,
                   srv.enr.udp_addr)
        data, _ = atk.recvfrom(65535)
        _, off = pdisc.ENR.decode(data)
        assert data[off] == pdisc._NODES
        assert verifies
    finally:
        atk.close()
        _stop(srv, peer)


def test_unsolicited_nodes_dropped_before_signature_work(monkeypatch):
    fork = b"\x0d\x0d\x0d\x0d"
    srv = pdisc.DiscoveryService(fork_digest=fork).start()
    peer = pdisc.DiscoveryService(fork_digest=fork)  # never started: just a record
    atk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    atk.bind(("127.0.0.1", 0))
    try:
        verifies = []
        orig = pdisc.ENR.verify
        monkeypatch.setattr(pdisc.ENR, "verify", lambda self: verifies.append(1) or orig(self))
        body = struct.pack(">H", 1) + peer.enr.encode()
        atk.sendto(peer.enr.encode() + bytes([pdisc._NODES]) + body, srv.enr.udp_addr)
        assert not _wait_for(lambda: len(srv.table) > 0, timeout=1.0)
        assert verifies == []
    finally:
        atk.close()
        _stop(srv, peer)


# -- lookups across packages -------------------------------------------------------------------


@pytest.mark.parametrize("boot_pkg", ["port", "ref"])
def test_transitive_discovery_across_packages(boot_pkg):
    """A reference node C and a port node B know only a boot node's record
    (of either package); B's lookup finds C."""
    fork = b"\x09\x09\x09\x09"
    Boot = pdisc.DiscoveryService if boot_pkg == "port" else rdisc.DiscoveryService
    boot = Boot(fork_digest=fork).start()
    c = rdisc.DiscoveryService(fork_digest=fork, tcp_port=9302).start()
    b = pdisc.DiscoveryService(fork_digest=fork, tcp_port=9301).start()
    try:
        c.bootstrap(rdisc.ENR.decode(boot.enr.encode())[0])
        assert _wait_for(lambda: len(boot.table) == 1)
        b.bootstrap(pdisc.ENR.decode(boot.enr.encode())[0])
        assert _wait_for(lambda: len(b.table) >= 1)

        def found_c():
            b.lookup(timeout=1.0)
            return c.enr.node_id in {e.node_id for e in b.table.all_records()}

        assert _wait_for(found_c, timeout=12.0, step=0.2)
        assert "127.0.0.1:9302" in b.known_tcp_addrs()
    finally:
        _stop(boot, b, c)


class _NullService:
    def on_gossip(self, *a):
        pass

    def on_rpc(self, method, payload, from_peer):
        from lighthouse_tpu_torch.network.transport import Status

        if method == "status":
            return Status(b"\x00" * 4, b"\x00" * 32, 0, b"\x00" * 32, 0)
        return []

    def local_status(self):
        return None


def test_socket_transport_discovers_and_bans():
    """``SocketTransport(discovery=...)`` signs its TCP port into the record,
    ``discover_enr`` dials what a lookup finds, and a ban drops the peer,
    removes its record from the table and keeps it out."""
    spec = p_minimal()
    fork = b"\x07\x07\x07\x07"
    d_a = pdisc.DiscoveryService(fork_digest=fork).start()
    d_b = pdisc.DiscoveryService(fork_digest=fork).start()
    a = PSocket(spec, rpc_timeout=2.0, discovery=d_a)
    bt = PSocket(spec, rpc_timeout=2.0, discovery=d_b)
    for t in (a, bt):
        t.register(t.local_addr, _NullService())
    try:
        assert d_a.enr.tcp_addr == a.local_addr and d_a.enr.seq == 2
        assert d_a.peer_manager is a.peer_manager
        d_a.bootstrap(d_b.enr)
        assert _wait_for(lambda: len(d_a.table) == 1)
        assert a.discover_enr() == [bt.local_addr]
        assert _wait_for(lambda: bt.local_addr in a.peers())
        a.report_peer(bt.local_addr, BAN_THRESHOLD)
        assert _wait_for(lambda: bt.local_addr not in a.peers())
        assert a.peer_manager.is_banned(addr=bt.local_addr)
        assert bt.local_addr not in d_a.known_tcp_addrs()
        assert not a.dial(bt.local_addr)
        assert bt.local_addr not in a.discover_enr(dial=False)
        assert bt.local_addr not in a.peers()
    finally:
        _stop(a, bt)
    assert d_a._stopped and d_b._stopped  # a transport stops its discovery endpoint


def test_discovery_refuses_to_start_without_native(monkeypatch):
    """The deliberate divergence: no oracle fallback for per-packet verifies."""
    def broken():
        raise OSError("no g++")

    monkeypatch.setattr(pbuild, "_lib", None)
    monkeypatch.setattr(pbuild, "load_bls", broken)
    monkeypatch.setattr("lighthouse_tpu_torch.native.build.load_bls", broken)
    with pytest.raises(OSError, match="no g\\+\\+"):
        pdisc.DiscoveryService(fork_digest=b"\x00" * 4)


# -- clients on boot ENRs: discovery alone, then block gossip ----------------------------------


def _post_block(url, signed, fork):
    req = urllib.request.Request(
        url + "/eth/v1/beacon/blocks", data=signed.serialize(), method="POST",
        headers={"Content-Type": "application/octet-stream", "Eth-Consensus-Version": fork})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_enr_nodes_peer_and_gossip_a_published_block(pkg):
    """Two clients given only an ENR boot node's record find each other
    (node 2's startup lookup, node 1's next), peer, and a block published to
    node 1 over HTTP reaches node 2's head over gossip — the reference's pair
    and the port's (``device="cpu"``, the native bls backend) alike."""
    rspec = r_minimal(**PHASE0)
    h = StateHarness(rspec, N, genesis_time=0)
    digest = compute_fork_digest(bytes(h.state.fork.current_version),
                                 bytes(h.state.genesis_validators_root))
    block = h.produce_block(1)
    if pkg == "port":
        from lighthouse_tpu_torch import convert

        spec, Builder, Config, Disc = p_minimal(**PHASE0), PBuilder, PConfig, pdisc
        block = convert.block_from_ssz(spec, "phase0", block.serialize())
        kw = {"device": "cpu"}
    else:
        spec, Builder, Config, Disc, kw = rspec, RBuilder, RConfig, rdisc, {}
    boot = Disc.DiscoveryService(fork_digest=digest).start()
    cfg = dict(interop_validators=N, genesis_time=0, use_system_clock=False, http_port=0,
               listen_port=0, boot_enrs=boot.enr.encode().hex(), **kw)
    nodes = []
    try:
        for _ in range(2):
            nodes.append(Builder(spec, Config(**cfg)).build().start())
        c1, c2 = nodes
        t1, t2 = (c.network_service.transport for c in nodes)
        assert t1.local_addr in t2.peers()  # node 2's startup lookup found node 1
        t1.discover_enr()
        assert c2.network_service.transport.discovery.enr.node_id in {
            e.node_id for e in t1.discovery.table.all_records()}
        assert _wait_for(lambda: t2.local_addr in t1.peers())
        assert _wait_for(lambda: t1._topic_peers("beacon_block") and t2._topic_peers("beacon_block"))
        for c in nodes:
            c.chain.slot_clock.set_slot(1)
        assert _post_block(c1.http_server.url, block, "phase0") == 200
        root = block.message.tree_root()
        assert c1.chain.head.root == root
        assert _wait_for(lambda: c2.chain.head.root == root, timeout=30.0)
        with urllib.request.urlopen(c2.http_server.url + "/eth/v1/beacon/headers/head") as r:
            assert json.loads(r.read())["data"]["root"] == "0x" + root.hex()
    finally:
        for c in nodes:
            c.stop()
            disc = c.network_service.transport.discovery
            disc.stop()  # the reference's transport leaves it running
        boot.stop()
