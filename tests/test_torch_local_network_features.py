"""The port's simulator with its optional duties, against the reference.

Both packages' ``LocalNetwork`` on their ``native`` bls backends (the
port's nodes on ``device="cpu"``, its epoch sweep on the CPU; both KZG
engines on their host arms, the per-cell loop), from the same interop keys.
Exact equality:

* sync-committee duties (``sync_committee=True``, 2 x 16, altair from
  genesis, as ``tests/test_lc_serving.py:340`` builds it): every head
  block, its sync aggregate included, byte for byte after every slot; the
  light-client server caches' latest optimistic and finality updates and
  their period archive byte for byte; the same for the port's network
  with ``batch_gossip=True``, where each node's own sync messages join the
  batch its peers' form;
* PeerDAS at deneb from genesis (``tests/test_peerdas.py:58-70``'s
  network, N = 32, 8 cells): each node's custody and required columns,
  the columns held, the blocks pending and the heads, for a blob block
  whose columns spread and one whose columns are withheld;
* sockets mode (2 x 16, phase0, as ``tests/test_socket_network.py:146``
  runs it over TCP gossip and a UDP boot node): both networks finalize,
  with equal head roots.
"""

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.kzg import engine as r_kzg_engine
from lighthouse_tpu.kzg.cells import CellContext as RCellContext
from lighthouse_tpu.kzg.fr import bls_field_to_bytes
from lighthouse_tpu.kzg.kzg import Kzg as RKzg
from lighthouse_tpu.kzg.setup import insecure_setup
from lighthouse_tpu.testing.local_network import LocalNetwork as RNet
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch.kzg import engine as p_kzg_engine
from lighthouse_tpu_torch.kzg.cells import CellContext as PCellContext
from lighthouse_tpu_torch.kzg.kzg import Kzg as PKzg
from lighthouse_tpu_torch.testing.local_network import LocalNetwork as PNet
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

N = 32  # field elements a blob (test_peerdas.py's geometry)
CELLS = 8
PORT = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(),
             p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device(),
             r_kzg_engine.get_kzg_backend(), p_kzg_engine.get_kzg_backend(),
             p_kzg_engine.get_kzg_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("native")
    p_epoch.set_backend("device", device="cpu")
    r_kzg_engine.set_kzg_backend("host")
    p_kzg_engine.set_kzg_backend("host")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    r_kzg_engine.set_kzg_backend(saved[6])
    p_kzg_engine.set_kzg_backend(saved[7], device=saved[8])


def _head_blocks(net):
    return [bytes(n.chain.store.get_block(n.chain.head.root) or b"") for n in net.nodes]


def _ser(x):
    return None if x is None else bytes(x.serialize())


# -- sync-committee duties ---------------------------------------------------------


def _sync_net(pkg_net, minimal, kw):
    return pkg_net(minimal(altair_fork_epoch=0), 2, 16, sync_committee=True, **kw)


def _lc_view(net):
    out = []
    for n in net.nodes:
        cache = n.chain.light_client_cache
        out.append((_ser(cache.latest_optimistic), _ser(cache.latest_finality),
                    [_ser(u) for u in cache.updates_by_range(0, 4)]))
    return out


def test_sync_committee_duties_equal_reference():
    """Into the second epoch: every slot's head blocks equal, with real
    sync aggregates; the light-client caches (latest updates, the period
    archive) equal at the end. The port's batched network (the mode the
    card runs) equals the reference's too."""
    ref = _sync_net(RNet, r_minimal, {})
    port = _sync_net(PNet, p_minimal, PORT)
    batched = _sync_net(PNet, p_minimal, {**PORT, "batch_gossip": True})
    spe = ref.spec.preset.SLOTS_PER_EPOCH
    participation = []
    for slot in range(1, spe + 3):
        ref.run_slot(slot)
        port.run_slot(slot)
        batched.run_slot(slot)
        blocks = _head_blocks(port)
        assert blocks == _head_blocks(ref), f"slot {slot}"
        assert _head_blocks(batched) == blocks, f"slot {slot}, batched"
        head = port.nodes[0].chain.head
        agg = port.nodes[0].chain.ns.block_types["altair"].decode(blocks[0]).message.body.sync_aggregate
        participation.append(int(np.asarray(agg.sync_committee_bits, dtype=bool).sum()))
        assert head.slot == slot
    assert port.heads_agree() and ref.heads_agree() and batched.heads_agree()
    # from slot 2 on every block carries the previous slot's sync messages
    assert min(participation[1:]) > 0, participation
    view = _lc_view(port)
    assert view == _lc_view(ref) == _lc_view(batched)
    assert view[0][0] is not None and len(view[0][2]) >= 1


# -- PeerDAS -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cell_contexts():
    rkzg = RKzg(insecure_setup(N, n_g2=2 * N // CELLS + 1))
    rctx = RCellContext(rkzg, cells_per_ext_blob=CELLS)
    pctx = PCellContext(PKzg(convert.trusted_setup_from_ref(rkzg.setup)),
                        cells_per_ext_blob=CELLS)
    return rctx, pctx


def _blob(rng):
    return b"".join(bls_field_to_bytes(int(rng.integers(1, 2**62))) for _ in range(N))


def _deneb(minimal):
    return minimal(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                   deneb_fork_epoch=0)


def _peerdas_run(net, ctx):
    """Slot 1: a blob block whose columns spread; slot 2: one whose columns
    are all withheld (the withholding attack). Per slot: the heads,
    every node's custody, required and held columns of the proposal, and
    the blocks pending availability."""
    net.enable_peerdas(ctx, custody_count=2, samples_per_slot=2)
    rng = np.random.default_rng(13)
    net.schedule_blobs(1, [_blob(rng)])
    net.schedule_blobs(2, [_blob(rng)], withhold=set(range(CELLS)))
    out = []
    for slot in (1, 2):
        net.run_slot(slot)
        roots = set()
        for n in net.nodes:
            roots |= set(n.chain.da_checker._pending)
        view = []
        for n in net.nodes:
            pd = n.chain.peerdas
            per_root = {
                bytes(r): (pd.required_columns(r), sorted(n.chain.data_columns_for(r)),
                           pd.is_available(r))
                for r in sorted(roots | {n.chain.head.root})
            }
            view.append((list(pd.custody), per_root))
        out.append((net.head_slots(), [bytes(n.chain.head.root) for n in net.nodes],
                    sorted(bytes(r) for r in roots), view))
    return out


def test_peerdas_columns_and_availability_equal_reference(cell_contexts):
    rctx, pctx = cell_contexts
    want = _peerdas_run(RNet(_deneb(r_minimal), n_nodes=2, n_validators=16), rctx)
    got = _peerdas_run(PNet(_deneb(p_minimal), n_nodes=2, n_validators=16, **PORT), pctx)
    (heads1, _, pending1, view1), (heads2, _, pending2, _) = got
    assert heads1 == [1, 1] and pending1 == []  # the spread block imported everywhere
    assert all(len(cols) == CELLS for _, per_root in view1[:1]
               for req, cols, ok in per_root.values())
    assert heads2 == [1, 1] and len(pending2) == 1  # the withheld one never available
    assert got == want


# -- sockets -----------------------------------------------------------------------


def _socket_run(pkg_net, minimal, kw):
    spec = minimal(altair_fork_epoch=2**64 - 1)
    net = pkg_net(spec, n_nodes=2, n_validators=16, transport="sockets", **kw)
    try:
        peers = [len(n.transport.peers()) for n in net.nodes]
        net.run_until(4 * spec.preset.SLOTS_PER_EPOCH)
        return dict(peers=peers, agree=net.heads_agree(), fins=net.finalized_epochs(),
                    slots=net.head_slots(), roots=[bytes(n.chain.head.root) for n in net.nodes])
    finally:
        net.stop()


def test_sockets_mode_finalizes_with_the_reference_heads():
    want = _socket_run(RNet, r_minimal, {})
    got = _socket_run(PNet, p_minimal, PORT)
    assert got["peers"] == [1, 1] and got["agree"], got
    assert all(f >= 2 for f in got["fins"]), got["fins"]
    assert got == want
