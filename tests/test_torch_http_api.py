"""The port's Beacon API server and client against the reference's.

``lighthouse_tpu_torch.http_api`` and ``api_client`` are the port's copies
of the reference's modules. A reference server over a reference chain and a
port server over a port chain, on one minimal interop genesis and the same
harness blocks (the reference's ``StateHarness``, signed with its native
backend; the port verifies on its ``"oracle"`` backend), must answer every
GET route of the table with equal JSON (the version, identity and peer ids
by form only); each package's ``BeaconNodeHttpClient`` must read the other's
server as its own; a batch of attestations with one poisoned must give both
the same 400 failure list and the same pools; an SSZ block publish moves
both heads to the same root; the SSE ``head`` event arrives; and while the
load monitor reads saturated, P1 routes get 503 with ``Retry-After`` and P0
routes do not.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.api_client import BeaconNodeHttpClient as RClient
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.http_api import BeaconApiServer as RServer
from lighthouse_tpu.loadshed import AdmissionLevel as RLevel
from lighthouse_tpu.loadshed import LoadMonitor as RMonitor
from lighthouse_tpu.op_pool import OperationPool as RPool
from lighthouse_tpu.op_pool import persistence as r_pp
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch.api_client import ApiClientError
from lighthouse_tpu_torch.api_client import BeaconNodeHttpClient as PClient
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.http_api import BeaconApiServer as PServer
from lighthouse_tpu_torch.loadshed import AdmissionLevel as PLevel
from lighthouse_tpu_torch.loadshed import LoadMonitor as PMonitor
from lighthouse_tpu_torch.op_pool import OperationPool as PPool
from lighthouse_tpu_torch.op_pool import persistence as p_pp
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

N = 16
PHASE0 = dict(altair_fork_epoch=2**64 - 1)
BLOCKS = 3  # harness blocks both chains import before the servers start


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(),
             p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device())
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
    """A reference chain and a port chain on one anchor, each with an op pool
    and a Beacon API server; one harness makes the blocks and gossip."""

    def __init__(self):
        self.rspec, self.pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
        self.h = StateHarness(self.rspec, N)
        anchor = self.h.state.copy()
        self.rclock, self.pclock = RClock(0), PClock(0)
        self.ns = p_con.for_preset("minimal")
        self.r = RChain(self.rspec, anchor.copy(), slot_clock=self.rclock)
        self.p = PChain(self.pspec, self.port(anchor), slot_clock=self.pclock)
        self.rpool = RPool(self.rspec, self.r.ns.Attestation)
        self.ppool = PPool(self.pspec, self.p.ns.Attestation)
        for slot in range(1, BLOCKS + 1):
            root = self.import_block(slot)
            if slot < BLOCKS:  # the last slot's votes are posted by a test
                for a in self.h.unaggregated_attestations_for_slot(self.h.state, slot, root):
                    assert not isinstance(self.r.verify_unaggregated_attestations([a])[0][1],
                                          Exception)
                    assert not isinstance(
                        self.p.verify_unaggregated_attestations([self.port(a)])[0][1], Exception)
                    self.rpool.insert_attestation(a)
                    self.ppool.insert_attestation(self.port(a))
        self.rs = RServer(self.r, op_pool=self.rpool).start()
        self.ps = PServer(self.p, op_pool=self.ppool).start()

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

    def import_block(self, slot):
        self.set_slot(slot)
        b = self.h.produce_block(slot)
        self.h.apply_block(b)
        root = self.r.process_block(b)
        assert self.p.process_block(self.port(b)) == root
        return root

    def stop(self):
        self.rs.stop()
        self.ps.stop()


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.stop()


def _call(url, method="GET", body=None, headers=None):
    """(status, parsed JSON or None, response headers)."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw = r.read()
            return r.status, json.loads(raw) if raw else None, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None, dict(e.headers)


def _routes(pair):
    """(method, path, body) for every route of the table but the writes,
    the SSE stream and the light-client routes (404 before altair, below)."""
    h = pair.h
    head = pair.r.head
    slot = int(head.slot)
    reveal = "0x" + h.randao_reveal(h.state, 0, 0).hex()
    pk0 = "0x" + bytes(head.state.validators[3].pubkey).hex()
    out = [("GET", "/eth/v1/beacon/genesis", None)]
    for sid in ("head", "finalized", "justified"):
        out += [("GET", f"/eth/v1/beacon/states/{sid}/{r}", None)
                for r in ("fork", "finality_checkpoints", "validators", "validator_balances",
                          "committees", "randao")]
    out += [
        ("GET", "/eth/v1/beacon/states/head/validators?id=1,2," + pk0 + ",99", None),
        ("GET", "/eth/v1/beacon/states/head/validators/5", None),
        ("GET", "/eth/v1/beacon/states/head/validators/" + pk0, None),
        ("GET", "/eth/v1/beacon/states/head/validators/99", None),
        ("GET", "/eth/v1/beacon/states/head/validator_balances?id=0,7", None),
        ("GET", "/eth/v1/beacon/states/head/committees?epoch=1", None),
        ("GET", "/eth/v1/beacon/states/head/committees?slot=2&index=0", None),
        ("GET", "/eth/v1/beacon/states/head/committees?epoch=5", None),
        ("GET", "/eth/v1/beacon/states/head/randao?epoch=0", None),
        ("GET", "/eth/v1/beacon/states/bogus/fork", None),
        ("GET", "/eth/v1/beacon/blob_sidecars/head", None),
        ("GET", "/eth/v1/node/syncing", None),
        ("GET", "/eth/v1/node/health", None),
        ("GET", "/eth/v1/config/spec", None),
        ("GET", "/eth/v1/config/fork_schedule", None),
        ("GET", "/eth/v1/config/deposit_contract", None),
        ("GET", "/eth/v1/validator/duties/proposer/0", None),
        ("GET", "/eth/v1/validator/duties/proposer/1", None),
        ("POST", "/eth/v1/validator/duties/attester/0", [str(i) for i in range(N)]),
        ("POST", "/eth/v1/validator/duties/attester/1", ["1", "9"]),
        ("POST", "/eth/v1/validator/duties/sync/0", ["0", "1"]),
        ("POST", "/eth/v1/validator/liveness/0", ["0", "1", "2", "3"]),
        ("GET", f"/eth/v1/validator/attestation_data?slot={slot}&committee_index=0", None),
        ("GET", f"/eth/v1/validator/attestation_data?slot={slot + 1}&committee_index=0", None),
        ("GET", f"/eth/v2/validator/blocks/{slot + 1}?randao_reveal={reveal}", None),
        ("GET", f"/eth/v1/validator/blinded_blocks/{slot + 1}?randao_reveal={reveal}", None),
        ("GET", "/eth/v1/beacon/pool/attester_slashings", None),
        ("GET", "/eth/v1/beacon/pool/proposer_slashings", None),
        ("GET", "/eth/v1/beacon/pool/voluntary_exits", None),
        ("GET", "/eth/v1/beacon/pool/bls_to_execution_changes", None),
        ("GET", "/eth/v2/debug/beacon/states/head", None),
        ("GET", "/eth/v2/debug/beacon/states/finalized", None),
        ("GET", "/eth/v1/beacon/light_client/optimistic_update", None),
        ("GET", "/eth/v1/beacon/light_client/finality_update", None),
        ("GET", "/eth/v1/beacon/light_client/updates?start_period=0&count=1", None),
        ("GET", "/eth/v1/beacon/light_client/bootstrap/0x" + head.root.hex(), None),
        ("GET", "/eth/v1/no/such/route", None),
    ]
    for bid in ("head", "genesis", "finalized", "1", "2", "7", "0x" + head.root.hex(),
                "0x" + "ab" * 32):
        out += [("GET", f"/eth/v1/beacon/headers/{bid}", None),
                ("GET", f"/eth/v1/beacon/blocks/{bid}/root", None),
                ("GET", f"/eth/v2/beacon/blocks/{bid}", None)]
    return out


def test_every_get_route_answers_as_the_reference(pair):
    routes = _routes(pair)
    assert len(routes) > 60
    for method, path, body in routes:
        rc, rj, _ = _call(pair.rs.url + path, method, body)
        pc, pj, _ = _call(pair.ps.url + path, method, body)
        assert (pc, pj) == (rc, rj), path
    # by form only: the package's name, and no network service behind either
    rc, rj, _ = _call(pair.rs.url + "/eth/v1/node/version")
    pc, pj, _ = _call(pair.ps.url + "/eth/v1/node/version")
    assert rc == pc == 200 and rj["data"]["version"].startswith("lighthouse_tpu/")
    assert pj["data"]["version"] == "lighthouse_tpu_torch/" + lighthouse_tpu.__version__
    for path in ("/eth/v1/node/identity", "/eth/v1/node/peers"):
        rc, rj, _ = _call(pair.rs.url + path)
        pc, pj, _ = _call(pair.ps.url + path)
        assert rc == pc == 200
        assert json.dumps(pj, sort_keys=True) == json.dumps(rj, sort_keys=True)


def _client_view(client, pair):
    slot = int(pair.r.head.slot)
    g = client.get_genesis()
    return [
        (g.genesis_time, g.genesis_validators_root, g.genesis_fork_version),
        client.get_fork(), client.get_finality_checkpoints(),
        client.get_validator_indices(), client.get_syncing(),
        [vars(d) for d in client.get_proposer_duties(0)],
        [vars(d) for d in client.get_attester_duties(0, list(range(N)))],
        client.get_attestation_data(slot, 0), client.get_head_header(),
        client.get_validator_liveness(0, [0, 1, 2]), client.get_sync_duties(0, [0]),
        client.get_block_ssz("head"), client.get_block_ssz(1), client.get_state_ssz("head"),
        client.get_state_ssz("finalized"),
        client.produce_block(slot + 1, pair.h.randao_reveal(pair.h.state, 0, 0)),
    ]


def test_clients_read_each_others_servers(pair):
    want = _client_view(RClient(pair.rs.url), pair)
    assert want[8]["slot"] == BLOCKS
    for client in (PClient(pair.rs.url), RClient(pair.ps.url), PClient(pair.ps.url)):
        assert _client_view(client, pair) == want
    with pytest.raises(ApiClientError) as e:
        PClient(pair.ps.url).get_block_ssz("0x" + "ab" * 32)
    assert e.value.code == 404


def test_poisoned_attestation_post_fails_as_the_reference(pair):
    """The last block's votes, one signed by the wrong member: both servers
    answer 400 with the same failure list, and pool the same valid votes."""
    slot = BLOCKS
    atts = pair.h.unaggregated_attestations_for_slot(pair.h.state, slot, pair.r.head.root)
    assert len(atts) >= 2
    bad = atts[1].copy()
    bad.signature = atts[0].signature
    body = [{"data": "0x" + a.serialize().hex()} for a in [atts[0], bad, *atts[2:]]]
    rc, rj, _ = _call(pair.rs.url + "/eth/v1/beacon/pool/attestations", "POST", body)
    pc, pj, _ = _call(pair.ps.url + "/eth/v1/beacon/pool/attestations", "POST", body)
    assert rc == pc == 400 and pj == rj
    assert [f["index"] for f in json.loads(pj["message"])] == [1]
    assert p_pp.serialize_pool(pair.ppool) == r_pp.serialize_pool(pair.rpool)
    # the naive pool's aggregate for that data, served equal
    root = "0x" + atts[0].data.tree_root().hex()
    path = "/eth/v1/validator/aggregate_attestation?attestation_data_root=" + root
    rc, rj, _ = _call(pair.rs.url + path)
    pc, pj, _ = _call(pair.ps.url + path)
    assert rc == pc == 200 and pj == rj


def test_ssz_block_publish_moves_both_heads_and_fires_the_head_event(pair):
    events, ready = [], threading.Event()

    def listen():
        with urllib.request.urlopen(pair.ps.url + "/eth/v1/events?topics=head", timeout=30) as r:
            ready.set()
            for line in r:
                text = line.decode().strip()
                # SSE comments (the server's ": keepalive" after a second
                # without an event) and blank separators carry no event
                if not text or text.startswith(":"):
                    continue
                events.append(text)
                if line.startswith(b"data:"):
                    return

    th = threading.Thread(target=listen, daemon=True)
    th.start()
    assert ready.wait(30)
    slot = BLOCKS + 1
    pair.set_slot(slot)
    b = pair.h.produce_block(slot)
    pair.h.apply_block(b)
    headers = {"Content-Type": "application/octet-stream", "Eth-Consensus-Version": "phase0"}
    for server in (pair.rs, pair.ps):
        code, js, _ = _call(server.url + "/eth/v1/beacon/blocks", "POST", b.serialize(), headers)
        assert (code, js) == (200, {"data": {}})
    root = b.message.tree_root()
    assert pair.p.head.root == pair.r.head.root == root
    th.join(30)
    assert events[0] == "event: head"
    assert json.loads(events[1][len("data:"):])["block"] == "0x" + root.hex()
    # a block that does not verify: the same 400 on both
    b2 = pair.h.produce_block(slot + 1)
    b2.signature = b.signature
    body = {"version": "phase0", "data": "0x" + b2.serialize().hex()}
    pair.set_slot(slot + 1)
    rc, rj, _ = _call(pair.rs.url + "/eth/v1/beacon/blocks", "POST", body)
    pc, pj, _ = _call(pair.ps.url + "/eth/v1/beacon/blocks", "POST", body)
    assert rc == pc == 400 and pair.p.head.root == root


@pytest.mark.parametrize("path,shed", [
    ("/eth/v1/beacon/states/head/validators?id=1", True),
    ("/eth/v1/beacon/genesis", True),
    ("/eth/v1/validator/duties/proposer/0", False),
    ("/eth/v1/node/syncing", False),
])
def test_saturated_node_sheds_p1_routes_only(pair, path, shed):
    got = []
    for server_cls, chain, monitor_cls, level in ((RServer, pair.r, RMonitor, RLevel),
                                                  (PServer, pair.p, PMonitor, PLevel)):
        mon = monitor_cls()
        mon.force_level(level.SATURATED)
        server = server_cls(chain, load_monitor=mon).start()
        try:
            code, js, hdrs = _call(server.url + path)
        finally:
            server.stop()
        got.append((code, js if shed else None, hdrs.get("Retry-After")))
    assert got[1] == got[0]
    assert (got[1][0] == 503) is shed and (got[1][2] is not None) is shed
