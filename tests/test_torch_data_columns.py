"""The port's PeerDAS columns and sampling against the reference's.

``lighthouse_tpu_torch.beacon_chain.data_columns`` and ``peerdas`` are the
port's copies of the reference's, over the port's ``kzg``. At the
reference's test geometries (N = 64 with 16 cells; N = 32 with 8 cells, one
insecure setup each, built with the reference's ``insecure_setup`` and
carried across with ``convert``): column sidecars byte-equal to the
reference's ``make_data_column_sidecars``, and chip_smoke's partial builder
equal to them on chosen columns; every ``verify_data_column_sidecar``
failure mode giving the reference's outcome (the port's host loop, and its
device engine on ``device="cpu"`` for the cases that reach KZG); recovery
from half the cells; the custody and sample sets; and the port's chain with
column sampling taking a blob-carrying block from pending to imported, equal
to the reference chain on the same block.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.beacon_chain import BeaconChain as RChain
from lighthouse_tpu.beacon_chain import data_columns as r_dc
from lighthouse_tpu.beacon_chain.chain import BlockPendingAvailability as RPending
from lighthouse_tpu.kzg import engine as r_engine
from lighthouse_tpu.kzg.cells import CellContext as RCellContext
from lighthouse_tpu.kzg.fr import bls_field_to_bytes
from lighthouse_tpu.kzg.kzg import Kzg as RKzg
from lighthouse_tpu.kzg.setup import insecure_setup
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.containers import for_preset as r_for_preset
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu.utils.slot_clock import ManualSlotClock as RClock
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch.beacon_chain import BeaconChain as PChain
from lighthouse_tpu_torch.beacon_chain import data_columns as p_dc
from lighthouse_tpu_torch.beacon_chain.chain import BlockPendingAvailability as PPending
from lighthouse_tpu_torch.kzg import KzgError as PKzgError
from lighthouse_tpu_torch.kzg import engine as p_engine
from lighthouse_tpu_torch.kzg.cells import CellContext as PCellContext
from lighthouse_tpu_torch.kzg.kzg import Kzg as PKzg
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock as PClock

FORKS = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
             deneb_fork_epoch=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    """Module scope: the geometry fixtures build blocks and proofs under
    these (the reference's default bls backend would compile its device
    MSM)."""
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


@pytest.fixture(autouse=True)
def _kzg_backends():
    """Each test starts on both packages' host loops."""
    saved = r_engine.get_kzg_backend(), p_engine.get_kzg_backend(), p_engine.get_kzg_device()
    r_engine.set_kzg_backend("host")
    p_engine.set_kzg_backend("host")
    yield
    r_engine.set_kzg_backend(saved[0])
    p_engine.set_kzg_backend(saved[1], device=saved[2])


class Geo:
    """One test geometry: the reference's and the port's cell contexts on
    one insecure setup, a harness, one signed blob-carrying block at slot 1
    in both packages' types, and its column sidecars from both builders."""

    def __init__(self, n, cells, n_blobs, seed):
        k = 2 * n // cells
        rkzg = RKzg(insecure_setup(n, n_g2=k + 1))
        self.rctx = RCellContext(rkzg, cells_per_ext_blob=cells)
        self.pctx = PCellContext(PKzg(convert.trusted_setup_from_ref(rkzg.setup)),
                                 cells_per_ext_blob=cells, msm_backend="host")
        self.rspec, self.pspec = r_minimal(**FORKS), p_minimal(**FORKS)
        self.rns, self.pns = r_for_preset("minimal"), p_for_preset("minimal")
        self.h = StateHarness(self.rspec, 16)
        rng = np.random.default_rng(seed)
        self.blobs = [
            b"".join(bls_field_to_bytes(int(rng.integers(1, 2**62))) for _ in range(n))
            for _ in range(n_blobs)
        ]
        self.rblock, _ = self.h.produce_block_with_blobs(1, self.blobs, rkzg)
        self.pblock = convert.block_from_ssz(self.pspec, "deneb", self.rblock.serialize())
        self.rcols = r_dc.make_data_column_sidecars(self.rns, self.rblock, self.blobs, self.rctx)
        self.pcols = p_dc.make_data_column_sidecars(self.pns, self.pblock, self.blobs, self.pctx)

    def port_chain(self):
        return PChain(self.pspec, convert.state_from_ssz(self.pspec, "deneb", self.h.state.serialize()),
                      slot_clock=PClock(1))

    def ref_chain(self):
        return RChain(self.rspec, self.h.state.copy(), slot_clock=RClock(1))


@pytest.fixture(scope="module")
def g64():
    return Geo(64, 16, 2, seed=5)


@pytest.fixture(scope="module")
def g32():
    return Geo(32, 8, 1, seed=7)


def _enc(ns, sc):
    return ns.DataColumnSidecar.encode(sc)


# -- construction ------------------------------------------------------------------


@pytest.mark.parametrize("geo", ["g64", "g32"])
def test_sidecars_byte_equal_the_reference(request, geo):
    g = request.getfixturevalue(geo)
    assert len(g.pcols) == len(g.rcols) == g.pctx.cells
    for pc, rc in zip(g.pcols, g.rcols):
        assert _enc(g.pns, pc) == g.rns.DataColumnSidecar.encode(rc)
        assert pc.tree_root() == rc.tree_root()
    with pytest.raises(p_dc.DataColumnError, match="blob count"):
        p_dc.make_data_column_sidecars(g.pns, g.pblock, g.blobs + g.blobs[:1], g.pctx)


def test_chip_smoke_partial_builder_equals_the_full_one(g64):
    """chip_smoke builds only the columns a node needs (its cell proofs
    only for those): the same sidecars as the full builder."""
    cols = [0, 5, 11, 15]
    rows = chip_smoke._cell_rows(g64.pctx, g64.blobs)
    ms = []
    proofs = chip_smoke._cell_proofs(g64.pctx, rows, cols, ms=ms)
    assert len(proofs) == len(ms) == len(cols) * len(g64.blobs)
    part = chip_smoke._column_sidecars(g64.pns, g64.pblock, rows, proofs, cols)
    assert sorted(part) == cols
    for c in cols:
        assert _enc(g64.pns, part[c]) == _enc(g64.pns, g64.pcols[c])


# -- verification ------------------------------------------------------------------


def _failure_cases(g, enc_r, enc_p):
    """(name, mutate) pairs applied to a decoded sidecar of either package."""
    other = (g.rcols[5], g.pcols[5])

    def wrong_index(sc, pkg):
        sc.index = g.pctx.cells

    def index_mismatch(sc, pkg):
        sc.index = 3

    def extra_commitment(sc, pkg):
        sc.kzg_commitments = list(sc.kzg_commitments) + [bytes(sc.kzg_commitments[0])]

    def empty(sc, pkg):
        sc.column, sc.kzg_commitments, sc.kzg_proofs = [], [], []

    def pad_bytes(sc, pkg):
        cell = bytearray(bytes(sc.column[0]))
        cell[g.pctx.bytes_per_cell + 5] = 1
        sc.column[0] = bytes(cell)

    def inclusion(sc, pkg):
        sc.kzg_commitments_inclusion_proof[1] = b"\xff" * 32

    def cell_bit(sc, pkg):
        cell = bytearray(bytes(sc.column[0]))
        cell[0] ^= 1
        sc.column[0] = bytes(cell)

    def foreign_proof(sc, pkg):
        sc.kzg_proofs[0] = bytes(other[pkg].kzg_proofs[0])

    return [("honest", lambda sc, pkg: None), ("wrong index", wrong_index),
            ("index mismatch", index_mismatch), ("extra commitment", extra_commitment),
            ("empty", empty), ("pad bytes", pad_bytes), ("inclusion", inclusion),
            ("cell bit", cell_bit), ("foreign proof", foreign_proof)]


def _outcome(verify, ns, enc, mutate, pkg):
    sc = ns.DataColumnSidecar.decode(enc)
    mutate(sc, pkg)
    try:
        verify(sc)
    except Exception as e:  # noqa: BLE001 — the outcome is the error's type and text
        return type(e).__name__, str(e)
    return "ok", ""


@pytest.mark.parametrize("backend", ["host", "device-cpu"])
def test_verify_failure_modes_give_the_reference_outcome(g32, backend):
    g = g32
    enc_r, enc_p = _enc(g.rns, g.rcols[2]), _enc(g.pns, g.pcols[2])
    kzg_cases = {"honest", "index mismatch", "cell bit", "foreign proof"}
    if backend == "device-cpu":
        p_engine.set_kzg_backend("device", device="cpu")
    for name, mutate in _failure_cases(g, enc_r, enc_p):
        if backend == "device-cpu" and name not in kzg_cases - {"cell bit"}:
            continue  # the device engine sees only what reaches KZG
        want = _outcome(lambda sc: r_dc.verify_data_column_sidecar(g.rns, sc, g.rctx),
                        g.rns, enc_r, mutate, 0)
        got = _outcome(lambda sc: p_dc.verify_data_column_sidecar(g.pns, sc, g.pctx),
                       g.pns, enc_p, mutate, 1)
        assert got == want, name
        assert (want[0] == "ok") == (name == "honest"), name


def test_non_canonical_cell_rejects_the_column(g32):
    """A column whose first cell holds a field element >= r: the port
    rejects it as a failed proof batch (the reference's parser ValueError
    escapes ``verify_data_column_sidecar`` instead)."""
    from lighthouse_tpu_torch.oracle.fields import R

    g = g32
    sc = g.pns.DataColumnSidecar.decode(_enc(g.pns, g.pcols[2]))
    cell = bytes(sc.column[0])
    sc.column[0] = R.to_bytes(32, "big") + cell[32:]
    rsc = g.rns.DataColumnSidecar.decode(_enc(g.pns, sc))
    with pytest.raises(ValueError, match="non-canonical"):
        r_dc.verify_data_column_sidecar(g.rns, rsc, g.rctx)
    with pytest.raises(p_dc.DataColumnError, match="batch failed"):
        p_dc.verify_data_column_sidecar(g.pns, sc, g.pctx)


def test_recovery_from_half_the_cells(g64):
    ctx, rctx = g64.pctx, g64.rctx
    cells, proofs = ctx.compute_cells_and_kzg_proofs(g64.blobs[0])
    rng = np.random.default_rng(4)
    keep = sorted(rng.choice(ctx.cells, size=ctx.cells // 2, replace=False).tolist())
    got = ctx.recover_cells_and_kzg_proofs(keep, [cells[i] for i in keep])
    assert got == (cells, proofs)
    assert got == rctx.recover_cells_and_kzg_proofs(keep, [cells[i] for i in keep])
    with pytest.raises(PKzgError, match="half"):
        ctx.recover_cells_and_kzg_proofs(keep[:-1], [cells[i] for i in keep[:-1]])
    more = sorted(rng.choice(ctx.cells, size=ctx.cells // 2 + 2, replace=False).tolist())
    bad = [bytearray(cells[i]) for i in more]
    bad[0][3] ^= 1
    with pytest.raises(PKzgError):
        ctx.recover_cells_and_kzg_proofs(more, [bytes(b) for b in bad])


# -- custody and sampling -------------------------------------------------------------


def test_custody_and_sample_columns_equal_the_reference(g64):
    for seed in range(6):
        node = bytes([seed]) * 32
        for count, n_cols in ((4, 128), (2, 16), (128, 128), (200, 16)):
            assert p_dc.custody_columns(node, count, n_cols) == r_dc.custody_columns(node, count, n_cols)
    r_chain, p_chain = g64.ref_chain(), g64.port_chain()
    for node in (b"\x01" * 32, b"\x09" * 32):
        rs = r_chain.enable_peerdas(g64.rctx, node)
        ps = p_chain.enable_peerdas(g64.pctx, node)
        assert ps.custody == rs.custody and ps.n_columns == rs.n_columns == 16
        for root in (b"\x07" * 32, bytes(range(32))):
            assert ps.sample_columns(root) == rs.sample_columns(root)
            assert ps.required_columns(root) == rs.required_columns(root)


# -- the chain: pending -> columns -> available -> imported -----------------------------


def test_chain_imports_a_blob_block_by_column_sampling(g32):
    """The port's chain (columns verified by the device engine on the CPU)
    and the reference's (its host loop) take the same block from pending to
    imported; heads, stored post-states and column caches agree."""
    g = g32
    node = b"\x05" * 32
    r, p = g.ref_chain(), g.port_chain()
    rs = r.enable_peerdas(g.rctx, node, custody_count=1, samples_per_slot=1)
    ps = p.enable_peerdas(g.pctx, node, custody_count=1, samples_per_slot=1)
    head0 = p.head.root
    with pytest.raises(RPending):
        r.process_block(g.rblock)
    with pytest.raises(PPending) as e:
        p.process_block(g.pblock)
    root = e.value.block_root
    assert root == g.rblock.message.tree_root() and p.head.root == head0 == r.head.root
    need = ps.required_columns(root)
    assert need == rs.required_columns(root) and 1 <= len(need) <= 2
    p_engine.set_kzg_backend("device", device="cpu")
    for i, col in enumerate(need):
        rsc = g.rns.DataColumnSidecar.decode(_enc(g.rns, g.rcols[col]))
        psc = g.pns.DataColumnSidecar.decode(_enc(g.pns, g.pcols[col]))
        r_dc.verify_data_column_sidecar(g.rns, rsc, g.rctx)
        p_dc.verify_data_column_sidecar(g.pns, psc, g.pctx)
        assert p.put_data_column(psc) == r.put_data_column(rsc) == root
        rs.on_verified_column(root, col)
        ps.on_verified_column(root, col)
        last = i == len(need) - 1
        assert ps.is_available(root) is rs.is_available(root) is last
        rres, pres = r.da_checker.notify_columns(root), p.da_checker.notify_columns(root)
        if not last:
            assert rres is None and pres is None
    assert sorted(p.data_columns_for(root)) == sorted(r.data_columns_for(root)) == need
    assert pres is not None and pres[1] == [] and rres[1] == []
    with r.lock:
        r._process_block_locked(rres[0], rres[0].message, root, True, check_availability=False)
    with p.lock:
        p._process_block_locked(pres[0], pres[0].message, root, True, check_availability=False)
    assert p.head.root == r.head.root == root
    assert p.head.state.serialize() == r.head.state.serialize()
    sr = bytes(g.pblock.message.state_root)
    assert p.store.get_state(sr) is not None
    assert p.state_by_root(root).tree_root() == sr
    assert p.da_checker.notify_columns(root) is None  # imported: never resurrected
