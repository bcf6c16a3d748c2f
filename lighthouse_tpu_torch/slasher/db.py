"""Slasher persistence over the column KV store (ref slasher/src/database.rs):
the port's copy of ``lighthouse_tpu/slasher/db.py``; its rows are byte for
byte the reference's.

The reference runs LMDB/MDBX/redb environments with seven tables
(database.rs, database/interface.rs); here the same record families live as
columns of the framework's ``KeyValueStore`` (store/kv.py), so the slasher
shares the node's storage engine instead of carrying its own.

Layout:
  SlasherTargets          v_chunk u32    -> stored_epoch u64 + zlib(min_d) + zlib(max_d)
  SlasherAttesterRecords  v u32, target u32 -> data_root 32B + att_id u64
  SlasherIndexedAtts      att_id u64     -> IndexedAttestation SSZ
  SlasherAttIdByHash      att htr 32B    -> att_id u64
  SlasherProposals        slot u64, proposer u64 -> SignedBeaconBlockHeader SSZ
  SlasherMeta             b"next_id"     -> u64

Target tiles are compressed whole-row (distances are overwhelmingly the
neutral element, so zlib gets the same ~wins the reference sees per 16-epoch
chunk, array.rs:169-192, without 256 tiny KV round-trips per row).
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

from ..store.kv import DBColumn, KeyValueStore
from .arrays import empty_row
from .config import SlasherConfig


class SlasherDB:
    def __init__(self, store: KeyValueStore, config: SlasherConfig, types):
        """``types`` is the preset namespace from ``containers.for_preset``
        (needs .IndexedAttestation); header type is preset-independent."""
        from ..types.containers import SignedBeaconBlockHeader

        self.store = store
        self.config = config
        self.types = types
        self._header_t = SignedBeaconBlockHeader
        self._lock = threading.RLock()
        # Write-back row cache: the reference's LMDB pages double as its
        # working memory; ours is host RAM, so rows stay
        # resident uncompressed and hit disk only on flush_rows().
        self._row_cache: dict[int, tuple] = {}
        self._dirty_rows: set[int] = set()

    # -- indexed attestations -------------------------------------------------

    def store_indexed_attestation(self, att, root: bytes | None = None) -> int:
        """Dedup by hash-tree-root; returns the attestation id
        (ref database.rs store_indexed_attestation). Pass ``root`` when the
        caller already hashed the attestation to avoid re-hashing."""
        t = type(att)
        if root is None:
            root = t.hash_tree_root(att)
        with self._lock:
            existing = self.store.get(DBColumn.SlasherAttIdByHash, root)
            if existing is not None:
                return struct.unpack("<Q", existing)[0]
            raw = self.store.get(DBColumn.SlasherMeta, b"next_id")
            att_id = struct.unpack("<Q", raw)[0] if raw else 1
            self.store.do_atomically(
                [
                    ("put", DBColumn.SlasherMeta, b"next_id",
                     struct.pack("<Q", att_id + 1)),
                    ("put", DBColumn.SlasherAttIdByHash, root,
                     struct.pack("<Q", att_id)),
                    ("put", DBColumn.SlasherIndexedAtts,
                     struct.pack(">Q", att_id), t.encode(att)),
                ]
            )
            return att_id

    def get_indexed_attestation(self, att_id: int):
        raw = self.store.get(
            DBColumn.SlasherIndexedAtts, struct.pack(">Q", att_id)
        )
        if raw is None:
            raise KeyError(f"slasher: missing indexed attestation {att_id}")
        return self.types.IndexedAttestation.decode(raw)

    # -- attester records (double-vote detection) -----------------------------

    @staticmethod
    def _record_key(validator_index: int, target_epoch: int) -> bytes:
        return struct.pack(">IQ", validator_index, target_epoch)

    def check_and_update_attester_record(
        self, validator_index: int, att, data_root: bytes, att_id: int
    ):
        """Returns None (not slashable) or the existing conflicting
        IndexedAttestation (double vote) — ref database.rs:585-640."""
        key = self._record_key(validator_index, int(att.data.target.epoch))
        with self._lock:
            raw = self.store.get(DBColumn.SlasherAttesterRecords, key)
            if raw is None:
                self.store.put(
                    DBColumn.SlasherAttesterRecords,
                    key,
                    data_root + struct.pack("<Q", att_id),
                )
                return None
        existing_root, existing_id = raw[:32], struct.unpack("<Q", raw[32:])[0]
        if existing_id == att_id or existing_root == data_root:
            return None
        return self.get_indexed_attestation(existing_id)

    def get_attestation_for_validator(self, validator_index: int, target_epoch: int):
        """Record lookup backing surround confirmation (ref array.rs:230-237)."""
        raw = self.store.get(
            DBColumn.SlasherAttesterRecords,
            self._record_key(validator_index, target_epoch),
        )
        if raw is None:
            raise KeyError(
                f"slasher: no record for validator {validator_index} "
                f"@ target {target_epoch}"
            )
        return self.get_indexed_attestation(struct.unpack("<Q", raw[32:])[0])

    # -- block proposals (proposer double votes) ------------------------------

    def check_or_insert_block_proposal(self, signed_header):
        """None if fresh/identical; existing SignedBeaconBlockHeader when the
        proposer signed a different block at the slot (ref database.rs:692-719)."""
        msg = signed_header.message
        key = struct.pack(">QQ", int(msg.slot), int(msg.proposer_index))
        with self._lock:
            raw = self.store.get(DBColumn.SlasherProposals, key)
            if raw is None:
                self.store.put(
                    DBColumn.SlasherProposals,
                    key,
                    self._header_t.encode(signed_header),
                )
                return None
        existing = self._header_t.decode(raw)
        if existing == signed_header:
            return None
        return existing

    # -- min/max target tiles -------------------------------------------------

    def load_row(self, validator_chunk_index: int):
        """(stored_epoch, min_d, max_d) for a validator-chunk row; fresh
        neutral tiles when the row has never been written."""
        with self._lock:
            cached = self._row_cache.get(validator_chunk_index)
            if cached is not None:
                return cached
        k, n = self.config.validator_chunk_size, self.config.history_length
        raw = self.store.get(
            DBColumn.SlasherTargets, struct.pack(">I", validator_chunk_index)
        )
        if raw is None:
            min_d, max_d = empty_row(k, n)
            row = (0, min_d, max_d)
        else:
            stored_epoch, min_len = struct.unpack_from("<QI", raw)
            off = 12
            min_d = np.frombuffer(
                zlib.decompress(raw[off : off + min_len]), dtype=np.uint16
            ).reshape(k, n).copy()
            max_d = np.frombuffer(
                zlib.decompress(raw[off + min_len :]), dtype=np.uint16
            ).reshape(k, n).copy()
            row = (stored_epoch, min_d, max_d)
        with self._lock:
            self._row_cache[validator_chunk_index] = row
        return row

    def store_row(self, validator_chunk_index: int, epoch: int, min_d, max_d):
        with self._lock:
            self._row_cache[validator_chunk_index] = (epoch, min_d, max_d)
            self._dirty_rows.add(validator_chunk_index)

    def flush_rows(self) -> int:
        """Persist dirty rows (the commit point of the reference's per-batch
        LMDB transaction, slasher.rs:98-107)."""
        with self._lock:
            dirty = [
                (rid, self._row_cache[rid]) for rid in sorted(self._dirty_rows)
            ]
        ops = []
        for rid, (epoch, min_d, max_d) in dirty:
            zmin = zlib.compress(np.ascontiguousarray(min_d).tobytes(), 1)
            zmax = zlib.compress(np.ascontiguousarray(max_d).tobytes(), 1)
            ops.append(
                (
                    "put",
                    DBColumn.SlasherTargets,
                    struct.pack(">I", rid),
                    struct.pack("<QI", epoch, len(zmin)) + zmin + zmax,
                )
            )
        if ops:
            self.store.do_atomically(ops)
        # only forget dirtiness once the write has succeeded — a failed
        # flush must stay retryable — and only for rows not re-dirtied
        # while the write ran unlocked (identity check against the snapshot)
        with self._lock:
            for rid, row in dirty:
                if self._row_cache.get(rid) is row:
                    self._dirty_rows.discard(rid)
        return len(ops)

    # -- pruning --------------------------------------------------------------

    def prune(self, current_epoch: int, slots_per_epoch: int) -> int:
        """Drop attester records / attestations / proposals older than the
        history window (ref database.rs prune)."""
        min_epoch = max(0, current_epoch - self.config.history_length + 1)
        dropped = 0
        live_ids = set()
        ops = []
        for key, raw in self.store.iter_column(DBColumn.SlasherAttesterRecords):
            _, target = struct.unpack(">IQ", key)
            if target < min_epoch:
                ops.append(("delete", DBColumn.SlasherAttesterRecords, key))
                dropped += 1
            else:
                live_ids.add(struct.unpack("<Q", raw[32:])[0])
        for key, raw in self.store.iter_column(DBColumn.SlasherAttIdByHash):
            att_id = struct.unpack("<Q", raw)[0]
            if att_id not in live_ids:
                ops.append(("delete", DBColumn.SlasherAttIdByHash, key))
                ops.append(
                    ("delete", DBColumn.SlasherIndexedAtts, struct.pack(">Q", att_id))
                )
        min_slot = min_epoch * slots_per_epoch
        for key, _ in self.store.iter_column(DBColumn.SlasherProposals):
            slot, _ = struct.unpack(">QQ", key)
            if slot < min_slot:
                ops.append(("delete", DBColumn.SlasherProposals, key))
                dropped += 1
        if ops:
            self.store.do_atomically(ops)
        return dropped
