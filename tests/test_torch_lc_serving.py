"""The port's light-client serving tier against the reference's.

A reference chain and a port chain (``BeaconChain``, each with its
``LightClientServerCache`` on the block-observer seam) import the same
harness blocks — the reference's ``StateHarness`` on an altair minimal spec,
every block carrying a full sync aggregate, attested through finality;
blocks and states cross as SSZ bytes. Held equal, byte for byte: the latest
optimistic and finality updates, bootstraps of held roots, the
``updates_by_range`` payloads and the update archives' KV rows. The served
updates verify through the port's ``verify_update_batch`` on
``device="cpu"``. The four Req/Resp methods' requests and responses (empty
ones included) encode to the same bytes in both codecs and each decodes the
other's; a port node serves a reference node over the loopback, each message
crossing as wire bytes, and the other way round. The reference verifies on
its native bls backend, the port on its oracle. Exact equality everywhere.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import network as r_net
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.light_client.verify import verify_bootstrap as r_verify_bootstrap
from lighthouse_tpu.network.codec import MessageCodec as RCodec
from lighthouse_tpu.store.kv import DBColumn as RCol
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import network as p_net
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain import ValidatorPubkeyCache as PCache
from lighthouse_tpu_torch.light_client import engine
from lighthouse_tpu_torch.light_client.verify import verify_bootstrap
from lighthouse_tpu_torch.network.codec import MessageCodec as PCodec
from lighthouse_tpu_torch.store.kv import DBColumn as PCol
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

ALTAIR = dict(altair_fork_epoch=0)
METHODS = ["light_client_bootstrap", "light_client_updates_by_range",
           "light_client_optimistic_update", "light_client_finality_update"]


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
             p_epoch.get_backend(), p_epoch.get_device(), engine.get_lc_backend(),
             engine.get_lc_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("oracle")
    p_epoch.set_backend("numpy")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    engine.set_lc_backend(saved[6], device=saved[7])


class Chains:
    """Both chains after four and a half epochs of attested altair blocks."""

    def __init__(self):
        self.rspec, self.pspec = r_minimal(**ALTAIR), p_minimal(**ALTAIR)
        h = StateHarness(self.rspec, 16)
        self.gvr = bytes(h.state.genesis_validators_root)
        self.rclock, self.pclock = RClock(0), PClock(0)
        self.r = RChain(self.rspec, h.state.copy(), slot_clock=self.rclock)
        self.p = PChain(self.pspec, convert.state_from_ssz(self.pspec, "altair", h.state.serialize()),
                        slot_clock=self.pclock, pubkey_cache=PCache("cpu"))
        spe = self.rspec.preset.SLOTS_PER_EPOCH
        self.roots = []
        for slot in range(1, 4 * spe + 5):
            self.rclock.set_slot(slot)
            self.pclock.set_slot(slot)
            atts = []
            if slot > 1:
                atts = h.attestations_for_slot(h.state, int(h.state.slot), h.head_root(h.state))
            b = h.produce_block(slot, attestations=atts)
            h.apply_block(b)
            root = self.r.process_block(b)
            assert self.p.process_block(convert.block_from_ssz(self.pspec, "altair", b.serialize())) == root
            self.roots.append(root)
        assert int(self.p.fork_choice.store.finalized_checkpoint[0]) >= 2


@pytest.fixture(scope="module")
def chains():
    return Chains()


def _ser(x):
    return None if x is None else x.serialize()


# -- the server caches -------------------------------------------------------------------


def test_latest_updates_byte_equal(chains):
    rc, pc = chains.r.light_client_cache, chains.p.light_client_cache
    assert rc.latest_optimistic is not None and rc.latest_finality is not None
    assert _ser(pc.latest_optimistic) == _ser(rc.latest_optimistic)
    assert _ser(pc.latest_finality) == _ser(rc.latest_finality)
    assert int(pc.latest_optimistic.signature_slot) == int(chains.p.head.slot)


def _bootstrap_roots(chains):
    fin = bytes(chains.r.fork_choice.store.finalized_checkpoint[1])
    return {"genesis": chains.r.genesis_block_root, "first": chains.roots[0],
            "finalized": fin, "head": chains.roots[-1], "unknown": b"\x42" * 32}


@pytest.mark.parametrize("which", ["genesis", "first", "finalized", "head", "unknown"])
def test_bootstrap_byte_equal(chains, which):
    root = _bootstrap_roots(chains)[which]
    want = chains.r.light_client_cache.bootstrap(root)
    got = chains.p.light_client_cache.bootstrap(root)
    assert _ser(got) == _ser(want)
    if which == "unknown":
        assert got is None
    else:
        assert verify_bootstrap(chains.pspec, got, root) is r_verify_bootstrap(chains.rspec, want, root) is True


@pytest.mark.parametrize("start,count", [(0, 1), (0, 4), (1, 2)])
def test_updates_by_range_byte_equal(chains, start, count):
    want = chains.r.light_client_cache.updates_by_range(start, count)
    got = chains.p.light_client_cache.updates_by_range(start, count)
    assert [u.serialize() for u in got] == [u.serialize() for u in want]
    assert len(got) == (1 if start == 0 else 0)


def test_update_archive_rows_byte_equal(chains):
    rows = sorted(chains.p.store.hot.iter_column(PCol.LightClientUpdate))
    assert rows == sorted(chains.r.store.hot.iter_column(RCol.LightClientUpdate))
    assert len(rows) == 1


def test_served_updates_verify_on_the_port_engine(chains):
    """The chain's own latest updates against the committee its genesis
    bootstrap carries, in one batch through the device engine's plain
    versions: the optimistic update, the finality update (finality
    required) and the archived period update."""
    pc = chains.p.light_client_cache
    committee = pc.bootstrap(chains.p.genesis_block_root).current_sync_committee
    engine.set_lc_backend("device", device="cpu")
    sessions = [(pc.latest_optimistic, committee), (pc.latest_finality, committee),
                (pc.updates_by_range(0, 1)[0], committee)]
    assert engine.verify_update_batch(chains.pspec, sessions, chains.gvr, finality_required=False) == [True] * 3
    engine.set_lc_backend("host")
    assert engine.verify_update_batch(chains.pspec, sessions[1:2], chains.gvr, finality_required=True) == [True]


# -- the four Req/Resp methods on the wire -------------------------------------------------


REQUESTS = {
    "light_client_bootstrap": bytes(range(32)),
    "light_client_updates_by_range": (3, 7),
    "light_client_optimistic_update": None,
    "light_client_finality_update": None,
}


@pytest.mark.parametrize("method", METHODS)
def test_request_bytes_equal_and_cross_decode(chains, method):
    rc, pc = RCodec(chains.rspec), PCodec(chains.pspec)
    payload = REQUESTS[method]
    rb, pb = rc.encode_request(method, payload), pc.encode_request(method, payload)
    assert pb == rb
    assert pc.decode_request(method, rb) == rc.decode_request(method, pb) == payload


def _responses(chains, side):
    c = (chains.r if side == "ref" else chains.p).light_client_cache
    return {
        "light_client_bootstrap": c.bootstrap(chains.roots[0]),
        "light_client_updates_by_range": c.updates_by_range(0, 4),
        "light_client_optimistic_update": c.latest_optimistic,
        "light_client_finality_update": c.latest_finality,
    }


@pytest.mark.parametrize("empty", [False, True], ids=["held", "empty"])
@pytest.mark.parametrize("method", METHODS)
def test_response_bytes_equal_and_cross_decode(chains, method, empty):
    rc, pc = RCodec(chains.rspec), PCodec(chains.pspec)
    if empty:  # a node holding nothing answers empty
        rp = pp = [] if method == "light_client_updates_by_range" else None
    else:
        rp, pp = _responses(chains, "ref")[method], _responses(chains, "port")[method]
    rb, pb = rc.encode_response(method, rp), pc.encode_response(method, pp)
    assert pb == rb
    rd, pd = rc.decode_response(method, pb), pc.decode_response(method, rb)
    if isinstance(rp, list):
        assert [u.serialize() for u in pd] == [u.serialize() for u in rd] == [u.serialize() for u in rp]
    else:
        assert _ser(pd) == _ser(rd) == _ser(rp)
        assert (pd is None) == empty


class WireBridge:
    """A peer on one package's bus that is a node of the other package:
    each request crosses as the requester's wire bytes, each response as the
    server's."""

    def __init__(self, server, server_codec, client_codec):
        self.server, self.sc, self.cc = server, server_codec, client_codec

    def on_rpc(self, method, payload, from_peer):
        req = self.sc.decode_request(method, self.cc.encode_request(method, payload))
        res = self.server.on_rpc(method, req, from_peer)
        return self.cc.decode_response(method, self.sc.encode_response(method, res))

    def on_gossip(self, *a):
        pass


@pytest.mark.parametrize("direction", ["port_serves_ref", "ref_serves_port"])
@pytest.mark.parametrize("method", METHODS)
def test_served_across_packages_over_the_loopback(chains, method, direction):
    rbus, pbus = r_net.LoopbackTransport(), p_net.LoopbackTransport()
    rnode = r_net.BeaconNodeService("R", chains.rspec, None, rbus, chain=chains.r)
    pnode = p_net.BeaconNodeService("P", chains.pspec, None, pbus, chain=chains.p, device="cpu")
    rc, pc = RCodec(chains.rspec), PCodec(chains.pspec)
    payload = {"light_client_bootstrap": chains.roots[0],
               "light_client_updates_by_range": (0, 4)}.get(method)
    try:
        if direction == "port_serves_ref":
            rbus.register("P", WireBridge(pnode, pc, rc))
            got = rbus.request("R", "P", method, payload)
            want = pbus.request("P", "P", method, payload)  # the port's own answer
        else:
            pbus.register("R", WireBridge(rnode, rc, pc))
            got = pbus.request("P", "R", method, payload)
            want = rbus.request("R", "R", method, payload)
    finally:
        rnode.stop()
        pnode.stop()
    if isinstance(want, list):
        assert [u.serialize() for u in got] == [u.serialize() for u in want] and len(got) == 1
    else:
        assert want is not None and got.serialize() == want.serialize()
