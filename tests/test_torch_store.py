"""The port's store against the reference's.

``lighthouse_tpu_torch.store`` is the port's copy of ``lighthouse_tpu.store``
(column KV stores, hierarchical state diffs, the hot/cold DB, the schema
guard and the finalization migrator). The same puts must give the same keys
and bytes in both packages, in memory and on disk; diffs must be the same
bytes and rebuild the target state; the cold hierarchy and the migrator must
leave equal stores. States cross as SSZ bytes from the reference's
``StateHarness``. Host code only; exact equality.
"""

import os

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import store as r_store
from lighthouse_tpu.store import hdiff as r_hdiff
from lighthouse_tpu.store import metadata as r_meta
from lighthouse_tpu.store.migrate import BackgroundMigrator as RMigrator
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import store as p_store
from lighthouse_tpu_torch.store import hdiff as p_hdiff
from lighthouse_tpu_torch.store import metadata as p_meta
from lighthouse_tpu_torch.store.migrate import BackgroundMigrator as PMigrator
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

N = 16
EXPONENTS = (1, 3, 5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def history():
    """Harness states at slots 0..12 (altair from genesis), as both
    packages' typed states."""
    saved = r_bls.get_backend()
    r_bls.set_backend("native")
    try:
        spec = r_minimal(altair_fork_epoch=0)
        h = StateHarness(spec, N)
        r_states = [h.state.copy()]
        for _ in range(12):
            h.extend_chain(1)
            r_states.append(h.state.copy())
    finally:
        r_bls.set_backend(saved)
    pspec = p_minimal(altair_fork_epoch=0)
    p_states = [convert.state_from_ssz(pspec, "altair", s.serialize()) for s in r_states]
    return spec, pspec, r_states, p_states


def _dump(kv):
    """Every (key, value) of a MemoryStore, sorted."""
    return sorted(kv._data.items())


def _db(pkg):
    return pkg.HotColdDB(config=pkg.StoreConfig(
        hierarchy=(r_hdiff if pkg is r_store else p_hdiff).HierarchyConfig(exponents=EXPONENTS)))


def test_storage_strategy_layers_equal():
    rcfg = r_hdiff.HierarchyConfig(exponents=EXPONENTS)
    pcfg = p_hdiff.HierarchyConfig(exponents=EXPONENTS)
    assert rcfg.moduli == pcfg.moduli
    for slot in range(0, 97):
        r = r_hdiff.storage_strategy(rcfg, slot)
        p = p_hdiff.storage_strategy(pcfg, slot)
        assert type(r).__name__ == type(p).__name__ and vars(r) == vars(p), slot
    with pytest.raises(ValueError):
        p_hdiff.HierarchyConfig(exponents=(5, 5))


@pytest.mark.parametrize("span", [(0, 12), (4, 8), (8, 12)])
def test_hdiff_bytes_and_roundtrip_equal(history, span):
    _, _, r_states, p_states = history
    a, b = span
    r_diff = r_hdiff.HDiff.compute(r_hdiff.HDiffBuffer.from_state(r_states[a]),
                                   r_hdiff.HDiffBuffer.from_state(r_states[b]))
    p_base = p_hdiff.HDiffBuffer.from_state(p_states[a])
    p_diff = p_hdiff.HDiff.compute(p_base, p_hdiff.HDiffBuffer.from_state(p_states[b]))
    assert p_diff.blob == r_diff.blob
    rebuilt = p_hdiff.HDiff(r_diff.blob).apply(p_base).into_state(type(p_states[b]))
    assert rebuilt.serialize() == r_states[b].serialize()
    assert rebuilt.tree_root() == r_states[b].tree_root()


def test_atomic_block_import_same_keys_and_bytes(history):
    _, _, r_states, _ = history
    dbs = [_db(r_store), _db(p_store)]
    for i, st in enumerate(r_states[1:4], start=1):
        args = (bytes([i]) * 32, b"block-%d" % i, st.tree_root(), st.serialize(), int(st.slot))
        for db in dbs:
            db.atomic_block_import(*args, extra_meta={b"head": bytes([i]) * 32})
    for db in dbs:
        db.put_blob_sidecars(b"\x07" * 32, [b"sc0", b"sc1"])
        db.delete_block(b"\x02" * 32)
    assert _dump(dbs[1].hot) == _dump(dbs[0].hot)
    assert dbs[1].get_blob_sidecars(b"\x07" * 32) == dbs[0].get_blob_sidecars(b"\x07" * 32)
    assert dbs[1].state_slot(r_states[3].tree_root()) == 3


def test_level_store_writes_the_same_log(tmp_path):
    """The disk store: the same ops give the same file, byte for byte, and
    reopen (replay) to the same contents."""
    paths = {}
    for name, pkg in (("ref", r_store), ("port", p_store)):
        path = str(tmp_path / name / "hot.log")
        kv = pkg.LevelStore(path)
        col = pkg.DBColumn
        kv.put(col.BeaconBlock, b"a" * 32, b"x" * 100)
        kv.do_atomically([("put", col.BeaconState, b"s" * 32, b"y" * 50),
                          ("put", col.Metadata, b"m", b"z"),
                          ("delete", col.BeaconBlock, b"a" * 32)])
        kv.compact()
        kv.put(col.Metadata, b"n", b"w" * 7)
        kv.close()
        paths[name] = path
        again = pkg.LevelStore(path)
        assert again.get(col.BeaconState, b"s" * 32) == b"y" * 50
        assert again.get(col.BeaconBlock, b"a" * 32) is None
        again.close()
    with open(paths["ref"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    assert os.path.getsize(paths["port"]) > 0


def test_cold_hierarchy_equal(history):
    _, pspec, r_states, p_states = history
    rdb, pdb = _db(r_store), _db(p_store)
    rns = r_states[0].__class__
    pns = p_for_preset("minimal")
    rdb.state_cls_for_slot = lambda slot: rns
    pdb.state_cls_for_slot = lambda slot: pns.state_types[pspec.fork_name_at_slot(slot)]
    for r, p in zip(r_states, p_states):
        rdb.store_cold_state(r, r.tree_root(), b"\x01" * 32)
        pdb.store_cold_state(p, p.tree_root(), b"\x01" * 32)
    assert _dump(pdb.cold) == _dump(rdb.cold)
    assert vars(pdb.split) == vars(rdb.split)
    for r in r_states:
        slot = int(r.slot)
        got = pdb.get_cold_state(slot)
        if got is None:
            assert pdb.replay_anchor(slot) == rdb.replay_anchor(slot) < slot
        else:
            assert got.tree_root() == r.tree_root()
        assert pdb.cold_slot_for_root(r.tree_root()) == slot


def test_schema_guard_equal():
    for pkg, meta in ((r_store, r_meta), (p_store, p_meta)):
        db = _db(pkg)
        with pytest.raises(RuntimeError):
            meta.check_config_consistency(db, (2, 4, 6))
        meta.check_config_consistency(db, EXPONENTS)


class _Chain:
    """The maps ``BackgroundMigrator.process_finalization`` reads."""

    def __init__(self, states, fork_at):
        self.genesis_block_root = b"\x00" * 32
        self._states, self._blocks = {self.genesis_block_root: states[0]}, {}
        parent = self.genesis_block_root
        for i, st in enumerate(states[1:], start=1):
            root = bytes([i]) * 32
            self._states[root] = st
            self._blocks[root] = _Signed(parent)
            if i != fork_at:  # one abandoned fork block off the canonical chain
                parent = root


class _Signed:
    def __init__(self, parent):
        self.message = type("M", (), {"parent_root": parent})()


def test_migrate_freeze_and_prune_equal(history):
    _, pspec, r_states, p_states = history
    out = []
    for pkg, migrator, states in ((r_store, RMigrator, r_states), (p_store, PMigrator, p_states)):
        db = _db(pkg)
        for i, st in enumerate(states[1:], start=1):
            db.atomic_block_import(bytes([i]) * 32, b"b%d" % i, st.tree_root(),
                                   st.serialize(), int(st.slot))
        chain = _Chain(states, fork_at=5)
        m = migrator(db)
        stats = m.process_finalization(chain, bytes([9]) * 32, 8)
        again = m.process_finalization(chain, bytes([9]) * 32, 8)
        out.append((stats, again, _dump(db.hot), _dump(db.cold), sorted(chain._states),
                    sorted(chain._blocks), m.last_finalized_slot))
    assert out[1] == out[0]
    assert out[0][0]["frozen"] > 0 and out[0][0]["pruned"] == 1
    assert np.all([k in out[0][4] for k in (b"\x00" * 32, bytes([9]) * 32)])
