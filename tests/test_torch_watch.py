"""The port's watch service against the reference's.

``lighthouse_tpu_torch.watch`` is the port's copy of ``lighthouse_tpu/watch/``.
A reference node and a port node import the same harness blocks (minimal,
altair from genesis, slot 3 skipped, each block carrying the previous
slot's attestations); each package's ``WatchService`` follows each node
over its Beacon API into a ``WatchDB``, and every row equals the
reference's over the reference node; the ``WatchServer`` s answer every
route alike, and the highest slot's root is the node's head.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import watch as rw
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.http_api import BeaconApiServer as RServer
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import watch as pw
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.http_api import BeaconApiServer as PServer
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

N = 16
ALTAIR = dict(altair_fork_epoch=0)
SLOTS = (1, 2, 4, 5, 6)  # slot 3 is skipped


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


@pytest.fixture(scope="module")
def nodes():
    rspec, pspec = r_minimal(**ALTAIR), p_minimal(**ALTAIR)
    h = StateHarness(rspec, N)
    anchor = h.state.copy()
    rclock, pclock = RClock(0), PClock(0)
    r = RChain(rspec, anchor.copy(), slot_clock=rclock)
    p = PChain(pspec, convert.state_from_ssz(pspec, anchor.fork_name, anchor.serialize()),
               slot_clock=pclock)
    atts = []
    for slot in SLOTS:
        rclock.set_slot(slot)
        pclock.set_slot(slot)
        b = h.produce_block(slot, attestations=atts)
        h.apply_block(b)
        root = r.process_block(b)
        assert p.process_block(convert.block_from_ssz(pspec, "altair", b.serialize())) == root
        atts = h.attestations_for_slot(h.state, slot, root)
    rs, ps = RServer(r).start(), PServer(p).start()
    yield {"r": r, "p": p, "rs": rs, "ps": ps, "rspec": rspec, "pspec": pspec}
    rs.stop()
    ps.stop()


def _rows(db):
    lo, hi = db.slot_bounds()
    return [(db.canonical_slot(s), db.block(s)) for s in range(lo, hi + 1)]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


ROUTES = ("/v1/slots/lowest", "/v1/slots/highest", "/v1/slots/3", "/v1/slots/4", "/v1/slots/99",
          "/v1/blocks/2", "/v1/blocks/3", "/v1/validators/{p}/blocks", "/v1/participation?lo=1&hi=6",
          "/v1/participation?lo=4", "/v1/nothing")


def test_watch_rows_and_routes_equal_the_reference(nodes):
    ref_db = rw.WatchDB()
    ref = rw.WatchService(ref_db, nodes["rs"].url, nodes["rspec"])
    assert ref.update() == len(range(1, SLOTS[-1] + 1))
    ports = {}
    for name, url in (("port node", nodes["ps"].url), ("reference node", nodes["rs"].url)):
        db = pw.WatchDB()
        svc = pw.WatchService(db, url, nodes["pspec"])
        assert svc.update() == SLOTS[-1] and svc.update() == 0
        assert _rows(db) == _rows(ref_db), name
        ports[name] = db
    db = ports["port node"]
    assert db.slot_bounds() == (1, SLOTS[-1])
    assert db.canonical_slot(3)["skipped"] and not db.canonical_slot(4)["skipped"]
    assert db.canonical_slot(3)["root"] == db.canonical_slot(2)["root"]
    assert db.canonical_slot(SLOTS[-1])["root"] == "0x" + nodes["p"].head.root.hex()
    assert sum(db.participation(1, SLOTS[-1])[k] for k in ("attestations",)) > 0
    assert db.participation(1, SLOTS[-1])["blocks"] == len(SLOTS)
    proposer = db.block(4)["proposer_index"]
    assert 4 in db.blocks_by_proposer(proposer)
    servers = {"port": pw.WatchServer(db).start(), "reference": rw.WatchServer(ref_db).start()}
    try:
        answers = {name: [_get(s.url + r.format(p=proposer)) for r in ROUTES]
                   for name, s in servers.items()}
    finally:
        for s in servers.values():
            s.stop()
    assert answers["port"] == answers["reference"]
    assert answers["port"][1] == (200, {"data": db.canonical_slot(SLOTS[-1])})
    assert [code for code, _ in answers["port"]] == [200, 200, 200, 200, 404, 200, 404, 200, 200,
                                                      200, 404]
    db.close()


def test_watch_on_an_empty_database_answers_404():
    db = pw.WatchDB()
    assert db.slot_bounds() is None and db.block(1) is None and db.canonical_slot(1) is None
    server = pw.WatchServer(db).start()
    try:
        assert _get(server.url + "/v1/slots/highest")[0] == 404
        assert _get(server.url + "/v1/participation")[1] == {
            "data": {"blocks": 0, "attestations": 0, "attesting_votes": 0}}
    finally:
        server.stop()
