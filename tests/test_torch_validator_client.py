"""The port's validator client against the reference's.

``lighthouse_tpu_torch.validator_client`` is the port's copy of
``lighthouse_tpu/validator_client/``. Both packages' slashing databases give
the same verdicts over one seeded script of proposals and votes, export
byte-equal EIP-3076 interchange files and import each other's; both
``ValidatorStore`` s sign every duty with the same bytes; fallback scoring,
doppelganger decisions, the keymanager's CRUD and the Web3Signer mock
behave as the reference's, across packages. Then the HTTP loop of
``tests/test_http_api_vc.py`` (16 interop keys, minimal preset, altair from
genesis, the ``native`` backend on both sides): a reference VC against a
reference node and a port VC against a port node propose, attest,
aggregate and sign sync messages for slots 1-4, every published SSZ body
byte-equal; at slot 5 each VC serves the other package's node. The port's
duties service asks only for its own keys' indices (``id=``, in chunks),
and gets the mapping the whole-registry GET gives.
"""

import json
import sqlite3
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import validator_client as rvc
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.http_api import BeaconApiServer as RServer
from lighthouse_tpu.keys import Keystore as RKeystore
from lighthouse_tpu.op_pool import OperationPool as RPool
from lighthouse_tpu.state_transition.genesis import interop_secret_keys
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu.validator_client import doppelganger as r_dg
from lighthouse_tpu.validator_client import runner as r_runner
from lighthouse_tpu.validator_client import services as r_services
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import validator_client as pvc
from lighthouse_tpu_torch.api_client import client as p_client
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.http_api import BeaconApiServer as PServer
from lighthouse_tpu_torch.op_pool import OperationPool as PPool
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock
from lighthouse_tpu_torch.validator_client import doppelganger as p_dg
from lighthouse_tpu_torch.validator_client import runner as p_runner
from lighthouse_tpu_torch.validator_client import services as p_services

N = 16
ALTAIR = dict(altair_fork_epoch=0)
LOOP_SLOTS = 4
SEED = 21


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
    p_bls.set_backend("native")
    p_epoch.set_backend("numpy")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])


def _sks(mod, n):
    return [mod.SecretKey.from_bytes(x.to_bytes(32, "big")) for x in interop_secret_keys(n)]


# -- slashing protection ------------------------------------------------------


def _script(rng, n_ops: int):
    """Seeded proposals and votes over three keys: repeats, doubles,
    surrounds and stale entries all occur."""
    ops = []
    for _ in range(n_ops):
        v = bytes([int(rng.integers(3)) + 1]) * 48
        root = bytes([int(rng.integers(3))]) * 32
        if rng.random() < 0.4:
            ops.append(("block", v, int(rng.integers(0, 12)), root))
        else:
            s = int(rng.integers(0, 8))
            ops.append(("att", v, s, s + int(rng.integers(-1, 5)), root))
    return ops


def _apply(db, op, not_safe):
    try:
        if op[0] == "block":
            return db.check_and_insert_block_proposal(op[1], op[2], op[3])
        return db.check_and_insert_attestation(op[1], op[2], op[3], op[4])
    except not_safe:
        return "not_safe"


def test_slashing_verdicts_and_interchange_equal_the_reference():
    rng = np.random.default_rng(SEED)
    rdb, pdb = rvc.SlashingDatabase(), pvc.SlashingDatabase()
    for v in (1, 2, 3):
        assert rdb.register_validator(bytes([v]) * 48) == pdb.register_validator(bytes([v]) * 48)
    verdicts = []
    for op in _script(rng, 300):
        got = _apply(pdb, op, pvc.NotSafe)
        assert got == _apply(rdb, op, rvc.NotSafe), op
        verdicts.append(got)
    assert {"valid", "same_data", "not_safe"} <= set(verdicts)
    with pytest.raises(pvc.NotSafe):
        pdb.check_and_insert_block_proposal(b"\x09" * 48, 1, b"\x00" * 32)  # unregistered
    gvr = rng.bytes(32)
    p_ex, r_ex = pdb.export_interchange(gvr), rdb.export_interchange(gvr)
    assert json.dumps(p_ex).encode() == json.dumps(r_ex).encode()
    assert p_ex["metadata"]["interchange_format_version"] == "5"
    # each package imports the other's file and refuses the same conflicts
    r2, p2 = rvc.SlashingDatabase(), pvc.SlashingDatabase()
    assert r2.import_interchange(p_ex) == p2.import_interchange(r_ex) > 0
    assert json.dumps(r2.export_interchange(gvr)) == json.dumps(p_ex)
    for op in _script(rng, 60):
        assert _apply(p2, op, pvc.NotSafe) == _apply(r2, op, rvc.NotSafe), op
    # pruning below finality keeps each validator's maximum entry
    assert pdb.prune(1, 4) == rdb.prune(1, 4)
    assert json.dumps(pdb.export_interchange(gvr)) == json.dumps(rdb.export_interchange(gvr))


def test_slashing_database_persists_on_disk(tmp_path):
    path = str(tmp_path / "slashing.sqlite")
    db = pvc.SlashingDatabase(path)
    pk = b"\x05" * 48
    db.register_validator(pk)
    assert db.check_and_insert_attestation(pk, 2, 3, b"\x01" * 32) == "valid"
    db._conn.close()
    # the reference opens the port's file and holds the same history
    rdb = rvc.SlashingDatabase(path)
    with pytest.raises(rvc.NotSafe):
        rdb.check_and_insert_attestation(pk, 1, 4, b"\x02" * 32)
    assert sqlite3.connect(path).execute("SELECT COUNT(*) FROM signed_attestations").fetchone() == (1,)


# -- the validator store ----------------------------------------------------------


def test_validator_store_signatures_equal_the_reference():
    rspec, pspec = r_minimal(**ALTAIR), p_minimal(**ALTAIR)
    rns, pns = r_con.for_preset("minimal"), p_con.for_preset("minimal")
    rng = np.random.default_rng(SEED)
    fork = dict(previous_version=b"\x00\x00\x00\x01", current_version=b"\x01\x00\x00\x01", epoch=1)
    gvr = rng.bytes(32)
    r_info = r_services.ForkInfo(fork=r_con.Fork(**fork), genesis_validators_root=gvr)
    p_info = p_services.ForkInfo(fork=p_con.Fork(**fork), genesis_validators_root=gvr)
    rs, ps = rvc.ValidatorStore(rspec), pvc.ValidatorStore(pspec)
    pk = rs.add_validator_sk(_sks(r_bls, 1)[0])
    assert ps.add_validator_sk(_sks(p_bls, 1)[0]) == pk and ps.voting_pubkeys() == [pk]

    def port(obj, ns=pns):
        cls = getattr(ns, type(obj).__name__, None) or getattr(p_con, type(obj).__name__)
        return cls.decode(obj.serialize())

    data = r_con.AttestationData(slot=13, index=0, beacon_block_root=rng.bytes(32),
                                 source=r_con.Checkpoint(epoch=0, root=rng.bytes(32)),
                                 target=r_con.Checkpoint(epoch=1, root=rng.bytes(32)))
    block = dict(rns.block_types["altair"].FIELDS)["message"](
        slot=13, proposer_index=0, parent_root=rng.bytes(32), state_root=rng.bytes(32))
    agg = rns.AggregateAndProof(aggregator_index=0, aggregate=rns.Attestation(
        aggregation_bits=np.ones(2, dtype=bool), data=data, signature=b"\xc0" + b"\x00" * 95),
        selection_proof=b"\xc0" + b"\x00" * 95)
    exit_ = r_con.VoluntaryExit(epoch=1, validator_index=0)
    root = rng.bytes(32)
    pairs = [
        (rs.sign_block(pk, block, r_info), ps.sign_block(pk, port(block), p_info)),
        (rs.sign_attestation(pk, data, r_info), ps.sign_attestation(pk, port(data), p_info)),
        (rs.sign_randao(pk, 1, r_info), ps.sign_randao(pk, 1, p_info)),
        (rs.sign_selection_proof(pk, 13, r_info), ps.sign_selection_proof(pk, 13, p_info)),
        (rs.sign_aggregate_and_proof(pk, agg, r_info),
         ps.sign_aggregate_and_proof(pk, port(agg), p_info)),
        (rs.sign_sync_committee_message(pk, 13, root, r_info),
         ps.sign_sync_committee_message(pk, 13, root, p_info)),
        (rs.sign_voluntary_exit(pk, exit_, r_info), ps.sign_voluntary_exit(pk, port(exit_), p_info)),
    ]
    for r_sig, p_sig in pairs:
        assert p_sig.serialize() == r_sig.serialize()
    # the same data again is allowed; another root at the same target is not
    assert ps.sign_attestation(pk, port(data), p_info).serialize() == pairs[1][0].serialize()
    other = p_con.AttestationData.decode(data.serialize())
    other.beacon_block_root = b"\x07" * 32
    with pytest.raises(pvc.NotSafe):
        ps.sign_attestation(pk, other, p_info)
    other_block = port(block)
    other_block.state_root = b"\x07" * 32
    with pytest.raises(pvc.NotSafe):
        ps.sign_block(pk, other_block, p_info)
    # a second store on the same database refuses the double vote too
    twin = pvc.ValidatorStore(pspec, slashing_db=ps.slashing_db)
    twin.add_validator_sk(_sks(p_bls, 1)[0])
    with pytest.raises(pvc.NotSafe):
        twin.sign_attestation(pk, other, p_info)
    ps.doppelganger_suspect.add(pk)
    with pytest.raises(pvc.NotSafe):
        ps.sign_randao(pk, 2, p_info)
    assert ps.remove_validator(pk) and not ps.remove_validator(pk)
    with pytest.raises(pvc.NotSafe):
        ps.sign_randao(pk, 2, p_info)


# -- doppelganger -------------------------------------------------------------------


class _Liveness:
    def __init__(self, live):
        self.live, self.calls = live, []

    def get_validator_liveness(self, epoch, indices):
        self.calls.append((epoch, tuple(indices)))
        return [{"index": str(i), "is_live": i in self.live.get(epoch, ())} for i in indices]


@pytest.mark.parametrize("detection_epochs", [1, 2, 3])
def test_doppelganger_decisions_equal_the_reference(detection_epochs):
    keys = [bytes([i]) * 48 for i in range(6)]
    index = {pk: i for i, pk in enumerate(keys[:5])}  # key 5 is not yet on chain
    live = {4: {1}, 5: {3}, 7: {2}}
    seen = {}
    for name, mod in (("port", p_dg), ("reference", r_dg)):
        store = SimpleNamespace(validators=dict.fromkeys(keys), doppelganger_suspect=set())
        client = _Liveness(live)
        svc = mod.DoppelgangerService(store, client, detection_epochs=detection_epochs)
        trace = [svc.register_all(4)]
        for epoch in (0, 4, 5, 6, 8, 9):  # a suspended process skips epoch 7's check
            svc.check(epoch, index)
            trace.append((sorted(store.doppelganger_suspect), sorted(svc.detected())))
        seen[name] = (trace, client.calls)
    assert seen["port"] == seen["reference"]
    assert keys[1] in seen["port"][0][-1][1]


# -- fallback, keymanager, web3signer ---------------------------------------------------


class Nodes:
    """A reference node and a port node on one minimal altair interop genesis
    (16 keys), each behind its package's Beacon API server."""

    def __init__(self):
        self.rspec, self.pspec = r_minimal(**ALTAIR), p_minimal(**ALTAIR)
        anchor = StateHarness(self.rspec, N).state
        self.rclock, self.pclock = RClock(0), PClock(0)
        self.r = RChain(self.rspec, anchor.copy(), slot_clock=self.rclock)
        self.p = PChain(self.pspec, convert.state_from_ssz(self.pspec, anchor.fork_name,
                                                           anchor.serialize()),
                        slot_clock=self.pclock)
        self.rpool = RPool(self.rspec, self.r.ns.Attestation)
        self.ppool = PPool(self.pspec, self.p.ns.Attestation)
        self.rs = RServer(self.r, op_pool=self.rpool).start()
        self.ps = PServer(self.p, op_pool=self.ppool).start()

    def set_slot(self, slot):
        self.rclock.set_slot(slot)
        self.pclock.set_slot(slot)

    def stop(self):
        self.rs.stop()
        self.ps.stop()


@pytest.fixture(scope="module")
def nodes():
    n = Nodes()
    yield n
    n.stop()


def test_fallback_scores_and_routes_equal_the_reference(nodes):
    dead = "http://127.0.0.1:1"
    for url in (nodes.ps.url, nodes.rs.url):
        seen = {}
        for name, mod in (("port", pvc), ("reference", rvc)):
            fb = mod.BeaconNodeFallback([dead, url])
            g = fb.get_genesis()
            trace = [g.genesis_time, bytes(g.genesis_validators_root),
                     [int(c.health) for c in fb.candidates]]
            fb.update_all_candidates()
            trace += [fb.num_available(), [int(c.health) for c in fb.candidates]]
            fb.pin_genesis(bytes(g.genesis_validators_root))
            fb.update_all_candidates()
            trace.append(fb.num_available())
            fb.pin_genesis(b"\xaa" * 32)
            fb.update_all_candidates()
            trace += [fb.num_available(), fb.candidates[1].last_error]
            with pytest.raises(AttributeError):
                fb.no_such_route()
            seen[name] = trace
        assert seen["port"] == seen["reference"]
        assert seen["port"][2] == [int(pvc.Health.Offline), int(pvc.Health.Syncing)]
        assert seen["port"][3:6] == [1, [2, 0], 1]
    with pytest.raises(pvc.AllErrored):
        pvc.BeaconNodeFallback([dead]).get_genesis()
    with pytest.raises(ValueError):
        pvc.BeaconNodeFallback([])


def _km_script(url, keystores, remote_pk):
    def req(method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(url + path, data=data, method=method,
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=30) as resp:
            return json.loads(resp.read().decode())

    pks = ["0x" + ks.pubkey for ks in keystores]
    out = [req("GET", "/eth/v1/keystores")]
    out.append(req("POST", "/eth/v1/keystores", {
        "keystores": [ks.to_json() for ks in keystores] + ["{not json"],
        "passwords": ["pw"] * len(keystores) + ["pw"]}))
    out.append(sorted(req("GET", "/eth/v1/keystores")["data"], key=lambda d: d["validating_pubkey"]))
    out.append(req("POST", "/eth/v1/remotekeys", {"remote_keys": [
        {"pubkey": remote_pk, "url": "http://127.0.0.1:9"}]}))
    out.append(req("GET", "/eth/v1/remotekeys"))
    out.append(req("DELETE", "/eth/v1/keystores", {"pubkeys": [pks[0], remote_pk]}))
    out.append(req("DELETE", "/eth/v1/remotekeys", {"pubkeys": [remote_pk, pks[1]]}))
    out.append(req("GET", "/eth/v1/keystores"))
    try:
        req("GET", "/eth/v1/nothing")
    except urllib.error.HTTPError as e:
        out.append(e.code)
    return out


def test_keymanager_crud_equals_the_reference():
    sks = _sks(r_bls, 3)
    # pbkdf2 keystores written by the reference package (an scrypt costs ~1 s)
    keystores = [RKeystore.encrypt(sk.serialize(), "pw", path=f"m/12381/3600/{i}/0/0", kdf="pbkdf2")
                 for i, sk in enumerate(sks[:2])]
    remote = "0x" + sks[2].public_key().serialize().hex()
    seen = {}
    for name, mod, spec in (("port", pvc, p_minimal()), ("reference", rvc, r_minimal())):
        store = mod.ValidatorStore(spec)
        km = mod.KeymanagerServer(store).start()
        try:
            seen[name] = _km_script(km.url, keystores, remote)
        finally:
            km.stop()
    assert seen["port"] == seen["reference"]
    out = seen["port"]
    assert [s["status"] for s in out[1]["data"]] == ["imported", "imported", "error"]
    assert [s["status"] for s in out[5]["data"]] == ["deleted", "not_found"]
    assert out[5]["slashing_protection"]["metadata"]["interchange_format_version"] == "5"
    assert [s["status"] for s in out[6]["data"]] == ["deleted", "not_found"]
    assert out[-1] == 404


def test_web3signer_across_packages(nodes):
    sks = _sks(p_bls, 4)
    root = np.random.default_rng(SEED).bytes(32)
    want = [sk.sign(root).serialize() for sk in sks]
    for signer_mod, method_mod in ((pvc, pvc), (pvc, rvc), (rvc, pvc)):
        signer = signer_mod.MockWeb3Signer(_sks(signer_mod.web3signer.bls, 4)).start()
        try:
            got = [method_mod.Web3SignerMethod(sk.public_key().serialize(), signer.url)
                   .sign(root).serialize() for sk in sks]
            assert got == want
            with pytest.raises(method_mod.web3signer.Web3SignerError):
                method_mod.Web3SignerMethod(b"\x01" * 48, signer.url).sign(root)
        finally:
            signer.stop()
    # a VC takes every key the signer serves; slashing protection stays local
    signer = pvc.MockWeb3Signer(sks).start()
    try:
        vc = p_runner.ProductionValidatorClient(nodes.pspec, nodes.ps.url)
        assert vc.load_web3signer(signer.url) == 4
        vc.connect()
        info = vc.ctx.fork_info()
        data = p_con.AttestationData(slot=1, index=0, beacon_block_root=b"\x11" * 32,
                                     source=p_con.Checkpoint(epoch=0, root=b"\x00" * 32),
                                     target=p_con.Checkpoint(epoch=0, root=b"\x22" * 32))
        pk = sks[0].public_key().serialize()
        sig = vc.store.sign_attestation(pk, data, info)
        rs = rvc.ValidatorStore(r_minimal(**ALTAIR))
        rs.add_validator_sk(_sks(r_bls, 1)[0])
        r_info = r_services.ForkInfo(fork=r_con.Fork.decode(info.fork.serialize()),
                                     genesis_validators_root=info.genesis_validators_root)
        assert sig.serialize() == rs.sign_attestation(
            pk, r_con.AttestationData.decode(data.serialize()), r_info).serialize()
        data.beacon_block_root = b"\x12" * 32
        with pytest.raises(pvc.NotSafe):
            vc.store.sign_attestation(pk, data, info)
    finally:
        signer.stop()
    with pytest.raises(RuntimeError):
        p_runner.ProductionValidatorClient(nodes.pspec, nodes.ps.url).load_web3signer(
            "http://127.0.0.1:1")


# -- the HTTP loop ---------------------------------------------------------------------


def _recording(vc, sink):
    """Record every POST the VC's client makes: (path, body)."""
    client = vc.client.candidates[0].client
    real = client._post

    def post(path, body):
        sink.append((path, json.dumps(body)))
        return real(path, body)

    client._post = post


@pytest.fixture(scope="module")
def loop(nodes):
    """Slots 1-4: the reference VC against the reference node, the port VC
    against the port node."""
    vcs, posts, stats = {}, {"port": [], "reference": []}, {"port": [], "reference": []}
    for name, mod, url, spec in (("port", p_runner, nodes.ps.url, nodes.pspec),
                                 ("reference", r_runner, nodes.rs.url, nodes.rspec)):
        vc = mod.ProductionValidatorClient(spec, url)
        vc.load_interop_keys(N)
        vc.connect()
        _recording(vc, posts[name])
        vcs[name] = vc
    for slot in range(1, LOOP_SLOTS + 1):
        nodes.set_slot(slot)
        for name in ("reference", "port"):
            stats[name].append(vcs[name].run_slot(slot))
    return vcs, posts, stats


def test_vc_loop_publishes_the_reference_bytes(nodes, loop):
    vcs, posts, stats = loop
    assert stats["port"] == stats["reference"]
    for s in stats["port"]:
        assert s["proposed"] is True and s["attested"] == 2
        assert s["aggregated"] >= 1 and s["sync_signed"] == 16
    assert posts["port"] == posts["reference"]
    paths = {p for p, _ in posts["port"]}
    assert paths == {"/eth/v1/beacon/blocks", "/eth/v1/beacon/pool/attestations",
                     "/eth/v1/validator/aggregate_and_proofs",
                     "/eth/v1/beacon/pool/sync_committees", "/eth/v1/validator/duties/sync/0",
                     "/eth/v1/validator/duties/attester/0", "/eth/v1/validator/duties/attester/1"}
    assert nodes.p.head.root == nodes.r.head.root and nodes.p.head.slot == LOOP_SLOTS
    included = sum(len(sb.message.body.attestations) for sb in nodes.p._blocks.values())
    assert included > 0
    assert json.dumps(vcs["port"].store.slashing_db.export_interchange(b"\x00" * 32)) == json.dumps(
        vcs["reference"].store.slashing_db.export_interchange(b"\x00" * 32))


def test_each_vc_serves_the_other_package_node(nodes, loop):
    vcs, _, _ = loop
    slot = LOOP_SLOTS + 1
    nodes.set_slot(slot)
    port_on_ref = p_runner.ProductionValidatorClient(nodes.pspec, nodes.rs.url)
    ref_on_port = r_runner.ProductionValidatorClient(nodes.rspec, nodes.ps.url)
    posts = {"port": [], "reference": []}
    for name, vc, old in (("port", port_on_ref, vcs["port"]),
                          ("reference", ref_on_port, vcs["reference"])):
        vc.store = old.store  # the keys and their slashing history move with the operator
        vc.connect()
        _recording(vc, posts[name])
    s_port = port_on_ref.run_slot(slot)
    s_ref = ref_on_port.run_slot(slot)
    assert s_port == s_ref and s_port["proposed"] is True and s_port["attested"] == 2
    assert posts["port"] == posts["reference"]
    assert nodes.p.head.root == nodes.r.head.root and nodes.r.head.slot == slot
    # the port's block at this slot is the one its own VC would have refused to re-sign
    duty = port_on_ref.duties.proposers_at(slot, slot // nodes.pspec.preset.SLOTS_PER_EPOCH)[0]
    fake = p_con.BeaconBlockHeader(slot=slot, proposer_index=duty.validator_index)
    with pytest.raises(pvc.NotSafe):
        port_on_ref.store.sign_block(duty.pubkey, fake, port_on_ref.ctx.fork_info())


def test_duties_resolve_only_their_keys_as_the_whole_registry_get(nodes, monkeypatch):
    monkeypatch.setattr(p_client, "ID_CHUNK", 3)
    for url in (nodes.ps.url, nodes.rs.url):
        client = p_client.BeaconNodeHttpClient(url)
        full = client.get_validator_indices()
        store = pvc.ValidatorStore(nodes.pspec)
        for sk in _sks(p_bls, N)[3:11]:
            store.add_validator_sk(sk)
        store.validators[b"\xaa" * 48] = store.validators[next(iter(store.validators))]
        duties = p_services.DutiesService(client, store)
        got = duties.validator_indices()
        assert got == {pk: i for pk, i in full.items() if pk in store.validators}
        assert sorted(got.values()) == list(range(3, 11)) and len(full) == N
        assert client.get_validator_indices([]) == {}
