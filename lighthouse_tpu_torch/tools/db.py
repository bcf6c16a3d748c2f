"""Operator tooling: the database manager and the ``lcli`` dev utilities,
the port's copy of ``lighthouse_tpu/tools.py`` (all but its validator
manager, which waits for the port's ``keys/``).

Lighthouse's tool binaries:

  * ``database_manager`` (``database_manager/``): inspect column sizes,
    report the schema version, migrate, compact.
  * ``lcli`` (``lcli/``): skip-slots (state advance), transition-blocks
    (replay blocks onto a pre-state), pretty-ssz (decode a container).

Both are reachable through ``python -m lighthouse_tpu_torch database-manager``
(alias ``dm``) and ``... lcli``. The state transition's epoch boundaries run
on the epoch backend the caller selected (``epoch_engine.set_backend``).
"""

from __future__ import annotations

import os

from ..store.kv import DBColumn, LevelStore
from ..types.containers import for_preset


# -- database manager --------------------------------------------------------


def db_inspect(datadir: str) -> dict:
    """Per-column key/byte counts for both stores (database_manager inspect)."""
    out = {}
    for name in ("chain.db", "freezer.db"):
        path = os.path.join(datadir, name)
        if not os.path.exists(path):
            continue
        store = LevelStore(path)
        cols = {}
        for col in DBColumn:
            n = size = 0
            for k, v in store.iter_column(col):
                n += 1
                size += len(v)
            if n:
                cols[col.name] = {"keys": n, "bytes": size}
        store.close()
        out[name] = cols
    return out


def _open_hot_cold(datadir: str):
    from ..store.hot_cold import HotColdDB, StoreConfig

    return HotColdDB(
        hot=LevelStore(os.path.join(datadir, "chain.db")),
        cold=LevelStore(os.path.join(datadir, "freezer.db")),
        config=StoreConfig(),
    )


def _read_version(store) -> int:
    """Stamped version, or the version apply_schema_migrations would infer
    for an unstamped store (v1 when cold data exists — metadata.py:57-64)."""
    from ..store.metadata import CURRENT_SCHEMA_VERSION

    raw = store.cold.get(DBColumn.Metadata, b"schema_version")
    if raw:
        return int.from_bytes(raw, "little")
    has_v1_data = any(True for _ in store.cold.iter_column(DBColumn.ColdState))
    return 1 if has_v1_data else CURRENT_SCHEMA_VERSION


def db_version(datadir: str) -> dict:
    """Schema version stamp (store/metadata.rs)."""
    from ..store.metadata import CURRENT_SCHEMA_VERSION

    store = _open_hot_cold(datadir)
    try:
        return {
            "schema_version": _read_version(store),
            "current": CURRENT_SCHEMA_VERSION,
        }
    finally:
        store.hot.close()
        store.cold.close()


def db_migrate(datadir: str) -> dict:
    """Apply pending schema migrations in place (database_manager migrate)."""
    from ..store.metadata import apply_schema_migrations

    store = _open_hot_cold(datadir)
    try:
        before = _read_version(store)
        apply_schema_migrations(store)
        return {"from": before, "to": _read_version(store)}
    finally:
        store.hot.close()
        store.cold.close()


def db_compact(datadir: str) -> dict:
    for name in ("chain.db", "freezer.db"):
        path = os.path.join(datadir, name)
        if os.path.exists(path):
            s = LevelStore(path)
            s.compact()
            s.close()
    return {"compacted": True}


# -- lcli utilities ----------------------------------------------------------


def skip_slots(spec, state_ssz: bytes, slots: int) -> bytes:
    """Advance a state ``slots`` empty slots (lcli skip-slots)."""
    from ..state_transition import process_slots

    ns = for_preset(spec.preset.name)
    state, fork = _decode_state(spec, ns, state_ssz)
    process_slots(spec, state, int(state.slot) + slots)
    fork_out = spec.fork_name_at_slot(int(state.slot))
    return ns.state_types[fork_out].encode(state)


def transition_blocks(spec, state_ssz: bytes, blocks_ssz: list[bytes]) -> bytes:
    """Replay signed blocks onto a pre-state (lcli transition-blocks, via
    the BlockReplayer)."""
    from ..state_transition.block_replayer import BlockReplayer

    ns = for_preset(spec.preset.name)
    state, _ = _decode_state(spec, ns, state_ssz)
    blocks = [_decode_block(spec, ns, b) for b in blocks_ssz]
    replayer = BlockReplayer(spec, state)
    replayer.apply_blocks(blocks)
    fork_out = spec.fork_name_at_slot(int(replayer.state.slot))
    return ns.state_types[fork_out].encode(replayer.state)


def pretty_ssz(spec, type_name: str, data: bytes) -> dict:
    """Decode an SSZ container to plain JSON-able python (lcli pretty-ssz)."""
    ns = for_preset(spec.preset.name)
    cls = getattr(ns, type_name, None)
    if cls is None:
        from ..types import containers as _c

        cls = getattr(_c, type_name)
    obj = cls.decode(data)
    return _to_jsonable(obj)


def _decode_state(spec, ns, raw: bytes):
    # fork variants have different SSZ layouts: newest-first trial decode
    last_err = None
    for fork in reversed(list(ns.state_types)):
        try:
            return ns.state_types[fork].decode(raw), fork
        except Exception as e:  # noqa: BLE001 — try the next fork
            last_err = e
    raise ValueError(f"undecodable state: {last_err}")


def _decode_block(spec, ns, raw: bytes):
    last_err = None
    for fork in reversed(list(ns.block_types)):
        try:
            return ns.block_types[fork].decode(raw)
        except Exception as e:  # noqa: BLE001 — try the next fork
            last_err = e
    raise ValueError(f"undecodable block: {last_err}")


def _to_jsonable(obj):
    import numpy as np

    if isinstance(obj, (bytes, bytearray)):
        return "0x" + bytes(obj).hex()
    if isinstance(obj, (bool, int, str)) or obj is None:
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.ndarray):
        return [_to_jsonable(x) for x in obj.tolist()]
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    fields = getattr(type(obj), "FIELDS", None)
    if fields is not None:
        return {name: _to_jsonable(getattr(obj, name)) for name, _ in fields}
    return str(obj)
