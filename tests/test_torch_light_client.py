"""The port's light client (types, proofs, verify, update store) against the
reference's.

``lighthouse_tpu_torch.light_client`` is the port's copy of
``lighthouse_tpu.light_client``. Inputs come from the reference's
``StateHarness`` on the minimal preset (an altair chain of two blocks, the
second's sync aggregate attesting the first, and an electra genesis) and
cross to the port as SSZ bytes. Held equal: the spec generalized indices of
every fork, ``field_branch`` bytes, ``verify_bootstrap``,
``sync_signing_root``, ``precheck_update`` and
``verify_light_client_update`` on valid and tampered inputs, the spec
``is_better_update`` order on the reference's ranking cases, and the update
store's consider / range / persist / restore / corrupt-row behaviour with
its KV rows byte-equal. The reference verifies on its native bls backend,
the port on its oracle. Exact equality everywhere.
"""

import struct

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.light_client import proofs as r_proofs
from lighthouse_tpu.light_client import update_store as r_us
from lighthouse_tpu.light_client import verify as r_verify
from lighthouse_tpu.light_client.types import light_client_types as r_lct
from lighthouse_tpu.store.kv import DBColumn as RCol
from lighthouse_tpu.store.kv import MemoryStore as RMem
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.containers import BeaconBlockHeader as RHeader
from lighthouse_tpu.types.containers import for_preset as r_for_preset
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.light_client import proofs, update_store, verify
from lighthouse_tpu_torch.light_client.types import light_client_types as p_lct
from lighthouse_tpu_torch.store.kv import DBColumn as PCol
from lighthouse_tpu_torch.store.kv import MemoryStore as PMem
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

FORKS = ["altair", "bellatrix", "capella", "deneb", "electra"]
ALTAIR = dict(altair_fork_epoch=0)
ELECTRA = {f"{f}_fork_epoch": 0 for f in FORKS}
RSPEC, PSPEC = r_minimal(**ALTAIR), p_minimal(**ALTAIR)
C = int(RSPEC.preset.SYNC_COMMITTEE_SIZE)
PATHS = [["current_sync_committee"], ["next_sync_committee"], ["finalized_checkpoint", "root"]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), p_bls.get_backend(), p_bls.get_device())
    r_bls.set_backend("native")
    p_bls.set_backend("oracle")
    yield
    r_bls.set_backend(saved[0])
    p_bls.set_backend(saved[1], device=saved[2])


def _port(obj, fork="altair"):
    """A reference light-client container (or state) as the port's."""
    if hasattr(obj, "validators"):
        return convert.state_from_ssz(PSPEC, obj.fork_name, obj.serialize())
    return getattr(p_lct("minimal", fork), type(obj).__name__).decode(obj.serialize())


def _header(signed_block):
    blk = signed_block.message
    return RHeader(slot=int(blk.slot), proposer_index=int(blk.proposer_index),
                   parent_root=bytes(blk.parent_root), state_root=bytes(blk.state_root),
                   body_root=type(blk.body).hash_tree_root(blk.body))


class Env:
    """Block 1 (the attested block) and its post-state; block 2, whose
    sync aggregate signs block 1's root; the updates a server builds from
    them; an electra genesis state."""

    def __init__(self):
        h = StateHarness(RSPEC, 16)
        self.gvr = bytes(h.state.genesis_validators_root)
        b1 = h.produce_block(1)
        h.apply_block(b1)
        self.state1 = h.state.copy()
        self.root1 = b1.message.tree_root()
        b2 = h.produce_block(2)
        h.apply_block(b2)
        t = r_lct("minimal", "altair")
        att = t.LightClientHeader(beacon=_header(b1))
        agg = b2.message.body.sync_aggregate
        self.committee = self.state1.current_sync_committee
        self.bootstrap = t.LightClientBootstrap(
            header=att, current_sync_committee=self.committee,
            current_sync_committee_branch=r_proofs.field_branch(self.state1, ["current_sync_committee"]))
        self.optimistic = t.LightClientOptimisticUpdate(attested_header=att, sync_aggregate=agg,
                                                        signature_slot=2)
        zero = t.LightClientHeader(beacon=RHeader())
        self.full = t.LightClientUpdate(
            attested_header=att, next_sync_committee=self.state1.next_sync_committee,
            next_sync_committee_branch=r_proofs.field_branch(self.state1, ["next_sync_committee"]),
            finalized_header=zero, finality_branch=[b"\x00" * 32] * len(t.LightClientUpdate().finality_branch),
            sync_aggregate=agg, signature_slot=2)
        # a finality proof: a state finalizing block 1, its root in the
        # attested header (the signature no longer matches: prechecks only)
        fstate = self.state1.copy()
        fstate.finalized_checkpoint.root = self.root1
        fhdr = _header(b1)
        fhdr.state_root = fstate.tree_root()
        self.finality = t.LightClientFinalityUpdate(
            attested_header=t.LightClientHeader(beacon=fhdr), finalized_header=att,
            finality_branch=r_proofs.field_branch(fstate, ["finalized_checkpoint", "root"]),
            sync_aggregate=agg, signature_slot=2)
        self.electra = StateHarness(r_minimal(**ELECTRA), 16).state


@pytest.fixture(scope="module")
def env():
    return Env()


# -- generalized indices and branches ------------------------------------------------


@pytest.mark.parametrize("fork", FORKS)
def test_generalized_indices_equal(fork):
    rst, pst = r_for_preset("minimal").state_types[fork], p_for_preset("minimal").state_types[fork]
    want = [r_proofs.leaf_gindex(rst, p) for p in PATHS]
    assert [proofs.leaf_gindex(pst, p) for p in PATHS] == want
    if fork == "electra":  # 37 fields: one level deeper
        assert want == [86, 87, 169]
    else:
        assert want == [54, 55, 105]
    depth = r_proofs.next_pow2(len(rst.FIELDS)).bit_length() - 1
    from lighthouse_tpu_torch.light_client.types import state_tree_depth

    assert state_tree_depth(pst) == depth == (6 if fork == "electra" else 5)


@pytest.mark.parametrize("which", ["altair", "electra"])
@pytest.mark.parametrize("path", PATHS, ids=["current", "next", "finality"])
def test_field_branch_bytes_equal(env, which, path):
    rstate = env.state1 if which == "altair" else env.electra
    pstate = _port(rstate)
    want = r_proofs.field_branch(rstate, path)
    assert proofs.field_branch(pstate, path) == want
    memo = {}
    proofs.field_branch(pstate, ["next_sync_committee"], memo)
    assert proofs.field_branch(pstate, path, memo) == want  # the shared field roots


# -- verification --------------------------------------------------------------------


def test_sync_signing_root_equal(env):
    want = r_verify.sync_signing_root(RSPEC, env.optimistic, env.gvr)
    assert verify.sync_signing_root(PSPEC, _port(env.optimistic), env.gvr) == want
    assert verify.sync_signing_root(PSPEC, _port(env.full), env.gvr) == want


def _bootstrap_cases(env):
    t = r_lct("minimal", "altair")
    flipped = t.LightClientBootstrap.decode(env.bootstrap.serialize())
    br = list(flipped.current_sync_committee_branch)
    br[2] = bytes([br[2][0] ^ 1]) + br[2][1:]
    flipped.current_sync_committee_branch = br
    return {"valid": (env.bootstrap, env.root1), "wrong_root": (env.bootstrap, b"\x07" * 32),
            "flipped_branch": (flipped, env.root1)}


@pytest.mark.parametrize("case", ["valid", "wrong_root", "flipped_branch"])
def test_verify_bootstrap_equal(env, case):
    boot, root = _bootstrap_cases(env)[case]
    want = r_verify.verify_bootstrap(RSPEC, boot, root)
    assert verify.verify_bootstrap(PSPEC, _port(boot), root) == want == (case == "valid")


def _update_cases(env):
    t = r_lct("minimal", "altair")

    def copy(u):
        return type(u).decode(u.serialize())

    low = copy(env.optimistic)
    low.sync_aggregate.sync_committee_bits = np.zeros(C, dtype=bool)
    bad_next = copy(env.full)
    br = list(bad_next.next_sync_committee_branch)
    br[0] = b"\x01" * 32
    bad_next.next_sync_committee_branch = br
    bad_fin = copy(env.finality)
    fb = list(bad_fin.finality_branch)
    fb[-1] = b"\x02" * 32
    bad_fin.finality_branch = fb
    header = copy(env.optimistic)
    header.attested_header.beacon.proposer_index = int(header.attested_header.beacon.proposer_index) + 1
    sig = copy(env.optimistic)
    raw = bytearray(bytes(sig.sync_aggregate.sync_committee_signature))
    raw[50] ^= 1
    sig.sync_aggregate.sync_committee_signature = bytes(raw)
    assert isinstance(env.full, t.LightClientUpdate)
    return {
        # name: (update, finality_required)
        "optimistic": (env.optimistic, False),
        "optimistic_finality_required": (env.optimistic, True),
        "full_empty_finality": (env.full, False),
        "full_finality_required": (env.full, True),
        "finality": (env.finality, True),
        "no_participants": (low, False),
        "bad_next_branch": (bad_next, False),
        "bad_finality_branch": (bad_fin, True),
        "tampered_header": (header, False),
        "tampered_signature": (sig, False),
    }


UPDATE_CASES = ["optimistic", "optimistic_finality_required", "full_empty_finality",
                "full_finality_required", "finality", "no_participants", "bad_next_branch",
                "bad_finality_branch", "tampered_header", "tampered_signature"]


@pytest.mark.parametrize("case", UPDATE_CASES)
def test_precheck_update_equal(env, case):
    u, fin = _update_cases(env)[case]
    want = r_verify.precheck_update(RSPEC, u, fin)
    assert verify.precheck_update(PSPEC, _port(u), fin) == want
    assert want == (case in ("optimistic", "full_empty_finality", "finality",
                             "tampered_header", "tampered_signature"))


@pytest.mark.parametrize("case", ["optimistic", "full_empty_finality", "finality",
                                  "tampered_header", "tampered_signature"])
def test_verify_light_client_update_equal(env, case):
    """The signature too: the port on its oracle bls, the reference on its
    native backend. Only the untampered updates over block 1 verify (the
    finality update's header carries another state root)."""
    u, fin = _update_cases(env)[case]
    want = r_verify.verify_light_client_update(RSPEC, u, env.committee, env.gvr, fin)
    pc = p_for_preset("minimal").SyncCommittee.decode(env.committee.serialize())
    assert verify.verify_light_client_update(PSPEC, _port(u), pc, env.gvr, fin) == want
    assert want == (case in ("optimistic", "full_empty_finality"))


# -- the spec is_better_update order (the reference's ranking cases) ----------------------


RLC = r_lct("minimal")
SLOTS_PER_PERIOD = RSPEC.preset.SLOTS_PER_EPOCH * RSPEC.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD


def mk_update(active, att_slot=0, sig_slot=1, committee=False, fin_slot=None):
    """A reference update carrying exactly the fields the ranking reads."""
    u = RLC.LightClientUpdate(signature_slot=sig_slot)
    u.attested_header.beacon.slot = att_slot
    bits = np.zeros(C, dtype=bool)
    bits[:active] = True
    u.sync_aggregate.sync_committee_bits = bits
    if committee:
        u.next_sync_committee_branch = [b"\x11" * 32] * len(u.next_sync_committee_branch)
    if fin_slot is not None:
        u.finality_branch = [b"\x22" * 32] * len(u.finality_branch)
        u.finalized_header.beacon.slot = fin_slot
    return u


_ATT = SLOTS_PER_PERIOD + 6
RANKING = {
    "supermajority": (mk_update(22), mk_update(21)),
    "participation_below_line": (mk_update(10), mk_update(5)),
    "relevant_committee": (mk_update(25, 1, 2, committee=True), mk_update(25, 1, 2)),
    "straddling_committee": (
        mk_update(25, SLOTS_PER_PERIOD - 1, SLOTS_PER_PERIOD, committee=True),
        mk_update(25, 1, 2, committee=True)),
    "finality": (mk_update(25, 1, 2, committee=True, fin_slot=0), mk_update(25, 1, 2, committee=True)),
    "committee_finality": (
        mk_update(25, _ATT, _ATT + 1, committee=True, fin_slot=SLOTS_PER_PERIOD + 1),
        mk_update(25, _ATT, _ATT + 1, committee=True, fin_slot=3)),
    "more_participation": (mk_update(25, 5, 6, committee=True), mk_update(24, 5, 6, committee=True)),
    "older_attested": (mk_update(25, 4, 6, committee=True), mk_update(25, 5, 6, committee=True)),
    "older_signature": (mk_update(25, 5, 6, committee=True), mk_update(25, 5, 7, committee=True)),
}


@pytest.mark.parametrize("case", sorted(RANKING))
def test_is_better_update_equal(case):
    a, b = RANKING[case]
    for new, old in ((a, b), (b, a)):
        want = r_us.is_better_update(RSPEC, new, old)
        assert update_store.is_better_update(PSPEC, _port(new), _port(old)) == want
    assert r_us.is_better_update(RSPEC, a, b) != (case == "straddling_committee")


# -- the period archive ------------------------------------------------------------------


def _rows(kv, col):
    return sorted(kv.iter_column(col))


def test_update_store_consider_and_range_equal():
    rs, ps = r_us.LightClientUpdateStore(RSPEC), update_store.LightClientUpdateStore(PSPEC)
    att = 2 * SLOTS_PER_PERIOD + 1  # period 2: period 1 stays empty
    seq = [mk_update(10, 1, 2), mk_update(5, 1, 2), mk_update(25, 3, 4), mk_update(25, att, att + 1)]
    got = [(rs.consider(u), ps.consider(_port(u))) for u in seq]
    assert [g for g, _ in got] == [w for _, w in got] == [True, False, True, True]
    assert ps.known_periods() == rs.known_periods() == [0, 2]
    for start, count in ((0, 4), (1, 2), (5, 3)):
        assert [u.serialize() for u in ps.get_updates(start, count)] == [
            u.serialize() for u in rs.get_updates(start, count)]
    assert update_store.sync_committee_period(PSPEC, att) == r_us.sync_committee_period(RSPEC, att) == 2


def test_update_store_persist_restore_equal():
    rkv, pkv = RMem(), PMem()
    rs, ps = r_us.LightClientUpdateStore(RSPEC, rkv), update_store.LightClientUpdateStore(PSPEC, pkv)
    for u in (mk_update(25, 3, 4, committee=True), mk_update(10, 3, 4),
              mk_update(22, SLOTS_PER_PERIOD + 2, SLOTS_PER_PERIOD + 3, fin_slot=1)):
        assert ps.consider(_port(u)) == rs.consider(u)
    rows = _rows(pkv, PCol.LightClientUpdate)
    assert rows == _rows(rkv, RCol.LightClientUpdate)
    assert [k for k, _ in rows] == [struct.pack(">Q", 0), struct.pack(">Q", 1)]
    # each package restores the other's rows
    back = update_store.LightClientUpdateStore(PSPEC, pkv)
    cross = RMem()
    for k, v in rows:
        cross.put(RCol.LightClientUpdate, k, v)
    rback = r_us.LightClientUpdateStore(RSPEC, cross)
    assert back.known_periods() == rback.known_periods() == [0, 1]
    assert [back.best(p).serialize() for p in (0, 1)] == [rback.best(p).serialize() for p in (0, 1)]
    # a pruned period reads through to its row, in both
    assert back.prune_hot(1) == rback.prune_hot(1) == 1
    assert [u.serialize() for u in back.get_updates(0, 2)] == [
        u.serialize() for u in rback.get_updates(0, 2)]


def test_update_store_skips_corrupt_rows_equal():
    rkv, pkv = RMem(), PMem()
    r_us.LightClientUpdateStore(RSPEC, rkv).consider(mk_update(25, 3, 4))
    update_store.LightClientUpdateStore(PSPEC, pkv).consider(_port(mk_update(25, 3, 4)))
    for kv, col in ((rkv, RCol.LightClientUpdate), (pkv, PCol.LightClientUpdate)):
        kv.put(col, struct.pack(">Q", 7), b"\x01junk")
        kv.put(col, b"short", b"\x01")
    assert _rows(pkv, PCol.LightClientUpdate) == _rows(rkv, RCol.LightClientUpdate)
    pr = update_store.LightClientUpdateStore(PSPEC, pkv)
    rr = r_us.LightClientUpdateStore(RSPEC, rkv)
    assert pr.known_periods() == rr.known_periods() == [0]
    assert pr.best(7) is None and rr.best(7) is None
