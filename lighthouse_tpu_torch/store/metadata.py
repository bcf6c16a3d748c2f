"""On-disk schema metadata + migrations (ref store/src/metadata.rs,
beacon_chain/src/schema_change.rs).

The store records its schema version and hierarchy config under Metadata
keys; opening a database written by a different schema runs the registered
migrations in order (or fails loudly if a step is missing) — never silent
reinterpretation of old bytes.

The port's copy of ``lighthouse_tpu/store/metadata.py``.
"""

from __future__ import annotations

import json

from .kv import DBColumn

CURRENT_SCHEMA_VERSION = 2
_VERSION_KEY = b"schema_version"
_CONFIG_KEY = b"store_config"

# version -> migration fn(store) upgrading version -> version+1
MIGRATIONS: dict[int, callable] = {}


def migration(from_version: int):
    def deco(fn):
        MIGRATIONS[from_version] = fn
        return fn

    return deco


@migration(1)
def _v1_to_v2(store) -> None:
    """v1 keyed cold states by state_root with ad-hoc zlib compression; v2
    keys the freezer by slot with hierarchical diffs. v1 entries cannot be
    re-layered without replaying the chain, so they are DELETED — the v2
    freezer refills from finalization. Loud in-place removal beats silent
    misreads of root-keyed bytes through slot-keyed accessors."""
    ops = []
    for col in (DBColumn.ColdState, DBColumn.ColdStateDiff):
        for key, _ in list(store.cold.iter_column(col)):
            if len(key) == 32:  # v1 root key (v2 keys are 8-byte slots)
                ops.append(("delete", col, key))
    for key, _ in list(store.cold.iter_column(DBColumn.BeaconStateSummary)):
        ops.append(("delete", DBColumn.BeaconStateSummary, key))
    if ops:
        # one atomic batch: a crash mid-migration must never leave a
        # half-deleted v1 freezer behind a v2 version stamp
        store.cold.do_atomically(ops)


def apply_schema_migrations(store) -> None:
    """Version lives in the COLD db next to the data it versions, so
    replacing the hot DB (routine for a hot/cold split) can't skip
    migrations. A vintage freezer with data but no version stamp is v1."""

    def put_version(v: int) -> None:
        store.cold.put(
            DBColumn.Metadata, _VERSION_KEY, v.to_bytes(8, "little")
        )

    raw = store.cold.get(DBColumn.Metadata, _VERSION_KEY)
    if raw is None:
        has_v1_data = any(
            True for _ in store.cold.iter_column(DBColumn.ColdState)
        )
        version = 1 if has_v1_data else CURRENT_SCHEMA_VERSION
        if not has_v1_data:
            put_version(CURRENT_SCHEMA_VERSION)
            return
    else:
        version = int.from_bytes(raw, "little")
    while version < CURRENT_SCHEMA_VERSION:
        fn = MIGRATIONS.get(version)
        if fn is None:
            raise RuntimeError(
                f"no migration from store schema v{version}; "
                f"current is v{CURRENT_SCHEMA_VERSION}"
            )
        fn(store)
        version += 1
        put_version(version)


def check_config_consistency(store, hierarchy_exponents: tuple) -> None:
    """The diff hierarchy is immutable once data is written. It lives in
    the FREEZER's metadata (the reference keeps it in the cold DB's
    on-disk config) so reopening just the cold history still validates."""
    raw = store.cold.get(DBColumn.Metadata, _CONFIG_KEY)
    if raw is None:
        store.cold.put(
            DBColumn.Metadata,
            _CONFIG_KEY,
            json.dumps({"exponents": list(hierarchy_exponents)}).encode(),
        )
        return
    stored = tuple(json.loads(raw.decode())["exponents"])
    if stored != tuple(hierarchy_exponents):
        raise RuntimeError(
            f"store hierarchy exponents {stored} != configured "
            f"{tuple(hierarchy_exponents)}"
        )
