"""The port's network stack against the reference's, over the loopback bus.

``lighthouse_tpu_torch.network`` is the port's copy of
``lighthouse_tpu.network`` (transport, router, sync, node service) over the
port's chain. Each scenario runs twice, once on reference nodes (the native
bls backend) and once on port nodes (``device="cpu"``, the ``"oracle"`` bls
backend; the column path on the port's device KZG engine over the kernels'
plain versions), with the same harness blocks (the reference's
``StateHarness``; blocks and states cross as SSZ bytes), and the outcomes
must be equal: heads, head states byte for byte, served history, peer
demotions and verdicts. Exact equality everywhere.

Scenarios: range sync from genesis; a checkpoint node's forward sync and
backfill; tampered history rejected; a parent lookup from a gossip block; a
peer lying about its head demoted; a peer serving a bad segment demoted and
the batch rotated; PeerDAS column coupling (a range-synced blob block
parked on availability, its columns fetched by root and verified).
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import network as r_net
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.beacon_chain import BlockError as RBlockError
from lighthouse_tpu.beacon_chain import data_columns as r_dc
from lighthouse_tpu.kzg import engine as r_kzg_engine
from lighthouse_tpu.kzg.cells import CellContext as RCellContext
from lighthouse_tpu.kzg.fr import bls_field_to_bytes
from lighthouse_tpu.kzg.kzg import Kzg as RKzg
from lighthouse_tpu.kzg.setup import insecure_setup
from lighthouse_tpu.network.transport import Status as RStatus
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.containers import for_preset as r_for_preset
from lighthouse_tpu.types.helpers import compute_fork_digest as r_digest
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import network as p_net
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain import BlockError as PBlockError
from lighthouse_tpu_torch.beacon_chain.pubkey_cache import ValidatorPubkeyCache as PCache
from lighthouse_tpu_torch.kzg import engine as p_kzg_engine
from lighthouse_tpu_torch.kzg.cells import CellContext as PCellContext
from lighthouse_tpu_torch.kzg.kzg import Kzg as PKzg
from lighthouse_tpu_torch.network import sync as p_sync
from lighthouse_tpu_torch.network.transport import Status as PStatus
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.helpers import compute_fork_digest as p_digest
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

PHASE0 = dict(altair_fork_epoch=2**64 - 1)
DENEB = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
             deneb_fork_epoch=0)
SLOTS = 12
ANCHOR = 8  # the checkpoint nodes boot from the state after block 8


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
             p_epoch.get_backend(), p_epoch.get_device(), r_kzg_engine.get_kzg_backend(),
             p_kzg_engine.get_kzg_backend(), p_kzg_engine.get_kzg_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("oracle")
    p_epoch.set_backend("numpy")
    r_kzg_engine.set_kzg_backend("host")
    p_kzg_engine.set_kzg_backend("device", device="cpu")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    r_kzg_engine.set_kzg_backend(saved[6])
    p_kzg_engine.set_kzg_backend(saved[7], device=saved[8])


class Side:
    """One package's view of the scenario: its node service, bus, status
    type, clock, the harness blocks and states in its own types, and a full
    node's chain holding every block (built once, served to every test)."""

    def __init__(self, pkg, spec, genesis, blocks, anchor, **svc_kw):
        self.pkg, self.spec, self.blocks, self.svc_kw = pkg, spec, blocks, svc_kw
        ref = pkg == "ref"
        self.net = r_net if ref else p_net
        self.Status, self.digest = (RStatus, r_digest) if ref else (PStatus, p_digest)
        self.Clock = RClock if ref else PClock
        self.BlockError = RBlockError if ref else PBlockError
        self.genesis, self.anchor = genesis, anchor
        chain_kw = {} if ref else {"pubkey_cache": PCache("cpu")}
        self.full = (RChain if ref else PChain)(spec, genesis.copy(), slot_clock=self.Clock(SLOTS),
                                                **chain_kw)
        self.full.process_chain_segment(list(blocks))

    def node(self, name, bus, state=None, chain=None):
        return self.net.BeaconNodeService(name, self.spec, None if chain else state.copy(), bus,
                                          slot_clock=self.Clock(SLOTS), chain=chain, **self.svc_kw)

    def full_node(self, bus, name="full"):
        return self.node(name, bus, chain=self.full)

    def status(self, head_slot, head_root=b"\xfe" * 32, finalized_epoch=0):
        st = self.full.head.state
        return self.Status(
            fork_digest=self.digest(bytes(st.fork.current_version), bytes(st.genesis_validators_root)),
            finalized_root=b"\x00" * 32, finalized_epoch=finalized_epoch,
            head_root=head_root, head_slot=head_slot)


@pytest.fixture(scope="module")
def sides():
    rspec, pspec = r_minimal(**PHASE0), p_minimal(**PHASE0)
    h = StateHarness(rspec, 16)
    genesis = h.state.copy()
    rblocks = []
    for slot in range(1, SLOTS + 1):
        b = h.produce_block(slot)
        h.apply_block(b)
        rblocks.append(b)
    ref = Side("ref", rspec, genesis, rblocks, None)
    ref.anchor = ref.full.state_by_root(rblocks[ANCHOR - 1].message.tree_root()).copy()
    pblocks = [convert.block_from_ssz(pspec, "phase0", b.serialize()) for b in rblocks]
    port = Side("port", pspec, convert.state_from_ssz(pspec, "phase0", genesis.serialize()),
                pblocks, convert.state_from_ssz(pspec, "phase0", ref.anchor.serialize()),
                device="cpu")
    assert port.full.head.root == ref.full.head.root
    return ref, port


def _outcome(late, full=None):
    c = late.chain
    out = {
        "head": (c.head.root, int(c.head.slot)),
        "state": c.head.state.serialize(),
        "oldest": c.oldest_block_slot,
        "failures": dict(late.sync.peer_failures),
    }
    if full is not None:
        out["equal_to_full"] = c.head.root == full.chain.head.root
    return out


def _both(sides, scenario):
    ref, port = sides
    want = scenario(ref)
    got = scenario(port)
    assert got == want
    return got


class Liar:
    """A peer advertising a head it never serves."""

    def __init__(self, status, blocks=()):
        self.status, self.blocks = status, list(blocks)

    def on_rpc(self, method, payload, from_peer):
        if method == "status":
            return self.status
        if method == "blocks_by_range":
            start, count = payload
            return [b for b in self.blocks if start <= int(b.message.slot) < start + count]
        if method == "blocks_by_root":
            return []
        raise ValueError(method)

    def on_gossip(self, *a):
        pass


def _swapped(blocks, other):
    """``blocks`` with each proposer signature replaced by ``other``'s: a
    valid point signed by another proposer over another block."""
    out = [b.copy() for b in blocks]
    for b in out:
        b.signature = bytes(other.signature)
    return out


# -- range sync and backfill ---------------------------------------------------------


def test_range_sync_equal(sides):
    def scenario(s):
        bus = s.net.LoopbackTransport()
        full = s.full_node(bus)
        late = s.node("late", bus, s.genesis)
        late.connect("full")
        served = [int(b.message.slot) for b in late.blocks_by_range(1, SLOTS)]
        return {**_outcome(late, full), "served": served}

    got = _both(sides, scenario)
    assert got["equal_to_full"] and got["served"] == list(range(1, SLOTS + 1))
    assert got["failures"] == {}


def test_checkpoint_node_syncs_forward_and_backfills_equal(sides):
    def scenario(s):
        bus = s.net.LoopbackTransport()
        full = s.full_node(bus)
        late = s.node("late", bus, s.anchor)
        before = (late.chain.oldest_block_slot, late.chain.backfill_complete)
        late.connect("full")  # status -> range sync forward, backfill backward
        served = [int(b.message.slot) for b in late.blocks_by_range(1, SLOTS)]
        return {**_outcome(late, full), "before": before, "served": served,
                "complete": late.chain.backfill_complete}

    got = _both(sides, scenario)
    assert got["before"] == (ANCHOR, False) and got["complete"] and got["oldest"] == 1
    assert got["equal_to_full"] and got["served"] == list(range(1, SLOTS + 1))


def test_tampered_history_rejected_equal(sides):
    def scenario(s):
        chain = s.node("late", s.net.LoopbackTransport(), s.anchor).chain
        errors = []
        for segment in (_swapped(s.blocks[4:7], s.blocks[3]), [b.copy() for b in s.blocks[0:3]]):
            with pytest.raises(s.BlockError) as e:
                chain.import_historical_blocks(segment)
            errors.append(("signatures" in str(e.value), "link" in str(e.value)))
        oldest = chain.oldest_block_slot
        n = chain.import_historical_blocks(s.blocks[4:7])
        return {"errors": errors, "oldest_after_bad": oldest, "imported": n,
                "oldest": chain.oldest_block_slot}

    got = _both(sides, scenario)
    assert got == {"errors": [(True, False), (False, True)], "oldest_after_bad": ANCHOR,
                   "imported": 3, "oldest": 5}


# -- lookups and misbehaving peers -------------------------------------------------------


def test_parent_lookup_equal(sides):
    """A gossip block whose parents the node lacks: the parent chain is walked
    by root from the sender and imported oldest first."""
    def scenario(s):
        bus = s.net.LoopbackTransport()
        full = s.full_node(bus)
        late = s.node("late", bus, s.anchor)
        late.sync.backfill_enabled = False
        late.router.on_gossip("beacon_block", s.blocks[-1], "full")
        return _outcome(late, full)

    got = _both(sides, scenario)
    assert got["equal_to_full"] and got["head"][1] == SLOTS and got["failures"] == {}


def test_lying_peer_demoted_equal(sides):
    def scenario(s):
        bus = s.net.LoopbackTransport()
        full = s.full_node(bus)
        late = s.node("late", bus, s.anchor)
        late.sync.backfill_enabled = False
        liar = s.status(10_000, finalized_epoch=99)
        bus.register("liar", Liar(liar))
        late.sync.on_peer_status("liar", liar)
        demoted = dict(late.sync.peer_failures)
        late.connect("full")
        return {**_outcome(late, full), "demoted": demoted}

    got = _both(sides, scenario)
    assert got["demoted"]["liar"] >= 1 and got["equal_to_full"]


def test_bad_segment_rotates_to_honest_peer_equal(sides):
    def scenario(s):
        bus = s.net.LoopbackTransport()
        full = s.full_node(bus)
        late = s.node("late", bus, s.anchor)
        late.sync.backfill_enabled = False
        corrupt = s.status(SLOTS, head_root=full.chain.head.root)
        bus.register("corrupt", Liar(corrupt, _swapped(s.blocks, s.blocks[0])))
        late.sync.on_peer_status("corrupt", corrupt)
        demoted = dict(late.sync.peer_failures)
        late.connect("full")
        return {**_outcome(late, full), "demoted": demoted}

    got = _both(sides, scenario)
    assert got["demoted"] == {"corrupt": 1} and got["equal_to_full"]
    assert got["failures"]["corrupt"] <= p_sync.PEER_FAILURE_LIMIT


# -- PeerDAS: column downloads coupled to block downloads ------------------------------


class ColumnGeo:
    """An insecure setup at N = 32 with 8 cells, one blob-carrying block at
    slot 1 in both packages' types, and its 8 column sidecars (built by the
    reference and carried across as SSZ bytes)."""

    def __init__(self):
        n, cells = 32, 8
        rkzg = RKzg(insecure_setup(n, n_g2=2 * n // cells + 1))
        self.rctx = RCellContext(rkzg, cells_per_ext_blob=cells)
        self.pctx = PCellContext(PKzg(convert.trusted_setup_from_ref(rkzg.setup)),
                                 cells_per_ext_blob=cells, msm_backend="host")
        self.rspec, self.pspec = r_minimal(**DENEB), p_minimal(**DENEB)
        rns, pns = r_for_preset("minimal"), p_for_preset("minimal")
        self.h = StateHarness(self.rspec, 16)
        self.genesis = self.h.state.copy()
        rng = np.random.default_rng(21)
        blobs = [b"".join(bls_field_to_bytes(int(rng.integers(1, 2**62))) for _ in range(n))]
        self.rblock, _ = self.h.produce_block_with_blobs(1, blobs, rkzg)
        self.pblock = convert.block_from_ssz(self.pspec, "deneb", self.rblock.serialize())
        self.rcols = r_dc.make_data_column_sidecars(rns, self.rblock, blobs, self.rctx)
        self.pcols = [pns.DataColumnSidecar.decode(rns.DataColumnSidecar.encode(sc))
                      for sc in self.rcols]


@pytest.fixture(scope="module")
def geo():
    return ColumnGeo()


def test_column_coupling_equal(geo):
    """The proposer's node takes the blob block by gossip, parks it, and
    imports it once its custody column arrives by gossip (it keeps every
    column it verifies); a late node range-syncs the block, finds it pending
    on availability, fetches its custody column by root from the serving
    peer, verifies it (on the port: the device KZG engine on the CPU) and
    imports."""
    def scenario(pkg):
        ref = pkg == "ref"
        net, spec = (r_net, geo.rspec) if ref else (p_net, geo.pspec)
        Clock = RClock if ref else PClock
        ctx, block, cols = ((geo.rctx, geo.rblock, geo.rcols) if ref
                            else (geo.pctx, geo.pblock, geo.pcols))
        genesis = (geo.genesis if ref
                   else convert.state_from_ssz(spec, "deneb", geo.genesis.serialize()))
        kw = {} if ref else {"device": "cpu"}
        bus = net.LoopbackTransport()
        a = net.BeaconNodeService("a", spec, genesis.copy(), bus, slot_clock=Clock(1), **kw)
        b = net.BeaconNodeService("b", spec, genesis.copy(), bus, slot_clock=Clock(1), **kw)
        sa = a.chain.enable_peerdas(ctx, b"\x0a" * 32, custody_count=1, samples_per_slot=0)
        sb = b.chain.enable_peerdas(ctx, b"\x0b" * 32, custody_count=1, samples_per_slot=0)
        root = block.message.tree_root()
        gossiped = sorted(set(sa.required_columns(root)) | set(sb.required_columns(root)))
        a.router.on_gossip("beacon_block", block, "nobody")
        parked = a.chain.head.slot
        if not ref:
            p_kzg_engine.set_kzg_backend("host")
        for c in gossiped:
            a.router.on_gossip("data_column_sidecar", cols[c], "nobody")
        if not ref:
            p_kzg_engine.set_kzg_backend("device", device="cpu")
        b.connect("a")
        return {"parked": parked, "a_head": a.chain.head.root, "b": _outcome(b, a),
                "need": sb.required_columns(root), "gossiped": gossiped,
                "held": sorted(b.chain.data_columns_for(root)),
                "a_held": sorted(a.chain.data_columns_for(root))}

    want, got = scenario("ref"), scenario("port")
    assert got == want
    root = geo.rblock.message.tree_root()
    assert got["parked"] == 0 and got["a_head"] == root and got["a_held"] == got["gossiped"]
    assert got["b"]["equal_to_full"] and got["b"]["failures"] == {}
    assert got["held"] == got["need"] and len(got["need"]) == 1


# -- the device seam -----------------------------------------------------------------------


def test_node_device_defaults_to_cuda_and_raises_without_it(sides, monkeypatch):
    """``BeaconNodeService`` without ``device=`` resolves CUDA: on a box
    without a card it raises instead of falling to the CPU; a prebuilt
    chain whose pubkey cache lives elsewhere is refused."""
    _, port = sides
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_net.BeaconNodeService("x", port.spec, port.genesis.copy(), p_net.LoopbackTransport())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_net.BeaconNodeService("x", port.spec, None, p_net.LoopbackTransport(), chain=port.full)
    chain = PChain(port.spec, port.genesis.copy(), pubkey_cache=PCache("meta"))
    with pytest.raises(ValueError, match="pubkey cache is on meta"):
        p_net.BeaconNodeService("x", port.spec, None, p_net.LoopbackTransport(), chain=chain,
                                device="cpu")
    node = p_net.BeaconNodeService("x", port.spec, port.genesis.copy(), p_net.LoopbackTransport(),
                                   device="cpu")
    assert node.chain.pubkey_cache.device == torch.device("cpu")
