"""Hot/cold split database (hot_cold_store.rs:51-81).

Hot DB: recent states + all blocks since the split. Cold DB: finalized
history as a hierarchical-diff freezer (hdiff.py): full snapshots at the
coarsest layer cadence, sectioned diffs between, block-replay for slots
below the finest layer. Cold entries are keyed by SLOT; a root<->slot
summary map serves by-root lookups.

The port's copy of ``lighthouse_tpu/store/hot_cold.py``.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass, field

from .hdiff import (
    DiffFrom,
    HDiff,
    HDiffBuffer,
    HierarchyConfig,
    ReplayFrom,
    Snapshot,
    storage_strategy,
)
from .kv import DBColumn, KeyValueStore, MemoryStore


@dataclass
class StoreConfig:
    compression_level: int = 1
    hierarchy: HierarchyConfig = field(default_factory=HierarchyConfig)
    buffer_cache_size: int = 4


@dataclass
class Split:
    """Hot/cold boundary (finalization watermark)."""

    slot: int = 0
    state_root: bytes = b"\x00" * 32


class HotColdDB:
    """Stores SSZ-encoded blocks/states; callers own (de)serialization of
    typed containers — the chain layer passes classes per fork."""

    def __init__(
        self,
        hot: KeyValueStore | None = None,
        cold: KeyValueStore | None = None,
        config: StoreConfig | None = None,
    ):
        self.hot = hot or MemoryStore()
        self.cold = cold or MemoryStore()
        self.config = config or StoreConfig()
        self.split = Split()
        self._buffer_cache: OrderedDict[int, HDiffBuffer] = OrderedDict()
        from .metadata import apply_schema_migrations, check_config_consistency

        apply_schema_migrations(self)
        check_config_consistency(self, self.config.hierarchy.exponents)

    # -- atomic batches ----------------------------------------------------------

    def do_atomically(self, ops: list, db: str = "hot") -> None:
        """One all-or-nothing batch against the hot (default) or cold KV
        store (kv.KeyValueStore.do_atomically contract). The multi-key
        sequences of block import and the finalization migration go through
        here so a crash mid-sequence can never be observed after replay."""
        (self.hot if db == "hot" else self.cold).do_atomically(ops)

    def atomic_block_import(
        self,
        block_root: bytes,
        signed_block_ssz: bytes,
        state_root: bytes,
        state_ssz: bytes,
        slot: int,
        extra_meta: dict | None = None,
    ) -> None:
        """The block-import barrier: block + post-state + slot summary
        (+ any metadata riders) committed as ONE hot frame."""
        ops = [
            ("put", DBColumn.BeaconBlock, block_root, signed_block_ssz),
            ("put", DBColumn.BeaconState, state_root, state_ssz),
            (
                "put",
                DBColumn.BeaconStateSummary,
                state_root,
                int(slot).to_bytes(8, "little"),
            ),
        ]
        for key, value in (extra_meta or {}).items():
            ops.append(("put", DBColumn.Metadata, key, value))
        self.hot.do_atomically(ops)

    # -- blocks -----------------------------------------------------------------

    def put_block(self, block_root: bytes, signed_block_ssz: bytes) -> None:
        self.hot.put(DBColumn.BeaconBlock, block_root, signed_block_ssz)

    def get_block(self, block_root: bytes) -> bytes | None:
        return self.hot.get(DBColumn.BeaconBlock, block_root)

    def block_exists(self, block_root: bytes) -> bool:
        return self.hot.exists(DBColumn.BeaconBlock, block_root)

    def delete_block(self, block_root: bytes) -> None:
        self.hot.delete(DBColumn.BeaconBlock, block_root)

    # -- blob sidecars (the separate blobs DB of the reference store) -----------

    def put_blob_sidecars(self, block_root: bytes, sidecar_ssz: list) -> None:
        """Length-prefixed concatenation of the block's sidecar encodings
        (hot_cold_store.rs put_blobs; blobs live beside blocks, pruned by the
        same finalization migrator)."""
        out = b"".join(
            len(s).to_bytes(4, "little") + s for s in sidecar_ssz
        )
        self.hot.put(DBColumn.BeaconBlobs, block_root, out)

    def get_blob_sidecars(self, block_root: bytes) -> list | None:
        raw = self.hot.get(DBColumn.BeaconBlobs, block_root)
        if raw is None:
            return None
        out, off = [], 0
        while off < len(raw):
            n = int.from_bytes(raw[off : off + 4], "little")
            off += 4
            out.append(raw[off : off + n])
            off += n
        return out

    def delete_blob_sidecars(self, block_root: bytes) -> None:
        self.hot.delete(DBColumn.BeaconBlobs, block_root)

    # -- hot states -------------------------------------------------------------

    def put_state(self, state_root: bytes, state_ssz: bytes, slot: int) -> None:
        # state bytes + slot summary are one logical record: commit them as
        # one frame so a crash can't leave a state without its summary
        self.hot.do_atomically(
            [
                ("put", DBColumn.BeaconState, state_root, state_ssz),
                (
                    "put",
                    DBColumn.BeaconStateSummary,
                    state_root,
                    slot.to_bytes(8, "little"),
                ),
            ]
        )

    def get_state(self, state_root: bytes) -> bytes | None:
        s = self.hot.get(DBColumn.BeaconState, state_root)
        if s is not None:
            return s
        return self.load_cold_state(state_root)

    def state_slot(self, state_root: bytes) -> int | None:
        b = self.hot.get(DBColumn.BeaconStateSummary, state_root)
        return int.from_bytes(b, "little") if b else None

    def delete_state(self, state_root: bytes) -> None:
        self.hot.do_atomically(
            [
                ("delete", DBColumn.BeaconState, state_root),
                ("delete", DBColumn.BeaconStateSummary, state_root),
            ]
        )

    # -- cold states (freezer, hierarchical diffs) --------------------------------

    @staticmethod
    def _slot_key(slot: int) -> bytes:
        return slot.to_bytes(8, "big")

    def store_cold_state(self, state, state_root: bytes, block_root: bytes) -> None:
        """Freeze a finalized state per its layer strategy: snapshot /
        diff-vs-parent-layer / summary-only (replayed on read). Also records
        slot<->root maps and the canonical slot->block_root chain the
        replayer walks (hot_cold_store.rs store_cold_state*)."""
        slot = int(state.slot)
        strategy = storage_strategy(self.config.hierarchy, slot)
        if isinstance(strategy, ReplayFrom) and not self._has_cold_state(
            strategy.slot
        ) and not self._has_cold_state(self.replay_anchor(slot)):
            # the replay layer has no reachable anchor below (skipped-slot
            # hole): store a diff at the finest layer instead of losing it
            strategy = DiffFrom(slot - slot % self.config.hierarchy.moduli[0])
        # collect the freeze as ONE cold frame: state bytes (or diff) + both
        # summary directions commit together — a crash mid-freeze can never
        # leave a summary pointing at state bytes that were never written
        ops = []
        if isinstance(strategy, Snapshot):
            ssz = type(state).encode(state)
            ops.append(
                (
                    "put",
                    DBColumn.ColdState,
                    self._slot_key(slot),
                    zlib.compress(ssz, self.config.compression_level),
                )
            )
        elif isinstance(strategy, DiffFrom):
            base = self._cold_buffer(strategy.slot)
            if base is None:
                # parent layer missing (pre-genesis-anchor history): snapshot
                ssz = type(state).encode(state)
                ops.append(
                    (
                        "put",
                        DBColumn.ColdState,
                        self._slot_key(slot),
                        zlib.compress(ssz, self.config.compression_level),
                    )
                )
            else:
                target = HDiffBuffer.from_state(state)
                diff = HDiff.compute(base, target)
                ops.append(
                    (
                        "put",
                        DBColumn.ColdStateDiff,
                        self._slot_key(slot),
                        diff.blob,
                    )
                )
        # ReplayFrom: state bytes not stored; the summary alone suffices
        ops.append(
            (
                "put",
                DBColumn.BeaconStateSummary,
                self._slot_key(slot),
                state_root + block_root,
            )
        )
        ops.append(
            ("put", DBColumn.BeaconStateSummary, state_root, self._slot_key(slot))
        )
        self.cold.do_atomically(ops)
        if slot > self.split.slot:
            self.split = Split(slot=slot, state_root=state_root)

    def _cold_buffer(self, slot: int) -> HDiffBuffer | None:
        """Reconstruct the HDiffBuffer at a stored layer slot (snapshot +
        diff chain), with a small LRU for repeated freezes."""
        cached = self._buffer_cache.get(slot)
        if cached is not None:
            self._buffer_cache.move_to_end(slot)
            return cached
        strategy = storage_strategy(self.config.hierarchy, slot)
        blob = self.cold.get(DBColumn.ColdState, self._slot_key(slot))
        if blob is not None:
            state_cls = self._state_cls_at(slot)
            if state_cls is None:
                return None
            buf = HDiffBuffer.from_state(
                state_cls.decode(zlib.decompress(blob))
            )
        elif isinstance(strategy, DiffFrom):
            diff_blob = self.cold.get(
                DBColumn.ColdStateDiff, self._slot_key(slot)
            )
            base = self._cold_buffer(strategy.slot)
            if diff_blob is None or base is None:
                return None
            buf = HDiff(diff_blob).apply(base)
        else:
            return None
        self._buffer_cache[slot] = buf
        while len(self._buffer_cache) > self.config.buffer_cache_size:
            self._buffer_cache.popitem(last=False)
        return buf

    # fork-aware decoding hook: the chain sets this to map slot -> state class
    state_cls_for_slot = None

    def _state_cls_at(self, slot: int):
        if self.state_cls_for_slot is None:
            return None
        return self.state_cls_for_slot(slot)

    def get_cold_state(self, slot: int):
        """Typed state at a stored cold slot, or None (slots on a replay
        layer return None — use replay_anchor + block replay)."""
        buf = self._cold_buffer(slot)
        if buf is None:
            return None
        cls = self._state_cls_at(slot)
        return buf.into_state(cls) if cls else None

    def replay_anchor(self, slot: int) -> int:
        """Closest slot at or below ``slot`` with actually-stored state
        bytes. The nominal layer slot can be a hole when it was skipped
        (no block, so no post-state was ever frozen there) — walk down
        until a stored snapshot/diff exists."""
        s = storage_strategy(self.config.hierarchy, slot)
        anchor = s.slot if isinstance(s, ReplayFrom) else slot
        while anchor > 0 and not self._has_cold_state(anchor):
            anchor -= 1
        return anchor

    def _has_cold_state(self, slot: int) -> bool:
        key = self._slot_key(slot)
        return (
            self.cold.exists(DBColumn.ColdState, key)
            or self.cold.exists(DBColumn.ColdStateDiff, key)
        )

    def cold_slot_for_root(self, state_root: bytes) -> int | None:
        raw = self.cold.get(DBColumn.BeaconStateSummary, state_root)
        return int.from_bytes(raw, "big") if raw else None

    def cold_summary_at_slot(self, slot: int):
        """(state_root, block_root) recorded when the slot froze."""
        raw = self.cold.get(DBColumn.BeaconStateSummary, self._slot_key(slot))
        if raw is None or len(raw) != 64:
            return None
        return raw[:32], raw[32:]

    def load_cold_state(self, state_root: bytes) -> bytes | None:
        """By-root cold lookup returning SSZ bytes (compat shim)."""
        slot = self.cold_slot_for_root(state_root)
        if slot is None:
            return None
        state = self.get_cold_state(slot)
        return type(state).encode(state) if state is not None else None

    # -- metadata ----------------------------------------------------------------

    def put_meta(self, key: bytes, value: bytes) -> None:
        self.hot.put(DBColumn.Metadata, key, value)

    def get_meta(self, key: bytes) -> bytes | None:
        return self.hot.get(DBColumn.Metadata, key)
