"""Key-value store abstraction (store/src/lib.rs KeyValueStore trait).

Columns mirror the reference's ``DBColumn`` byte prefixes; ``MemoryStore`` is
the test/in-process backend (``memory_store.rs``), ``LevelStore`` a
file-backed write-ahead log with an in-memory index (standing in for LevelDB
until the C++ engine lands — same interface, durable AND crash-safe: every
commit is one checksummed frame, so a kill mid-write can only ever tear the
tail, and replay truncates the tear instead of resurrecting half a batch).

The port's copy of ``lighthouse_tpu/store/kv.py``.
"""

from __future__ import annotations

import enum
import os
import struct
import threading
import zlib


class DBColumn(enum.Enum):
    BeaconBlock = b"blk"
    BeaconState = b"ste"
    BeaconStateSummary = b"ssy"
    BeaconBlobs = b"blb"
    ForkChoice = b"frk"
    PubkeyCache = b"pkc"
    BeaconChain = b"bch"
    OpPool = b"opo"
    Eth1Cache = b"etc"
    HotDiff = b"hdf"
    ColdState = b"cst"
    ColdStateDiff = b"cdf"
    Metadata = b"met"
    LightClientUpdate = b"lcu"
    # slasher (slasher/src/database.rs database table names)
    SlasherTargets = b"stg"
    SlasherAttesterRecords = b"sar"
    SlasherIndexedAtts = b"sia"
    SlasherAttIdByHash = b"sih"
    SlasherProposals = b"spr"
    SlasherMeta = b"smt"


class KeyValueStore:
    def get(self, column: DBColumn, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, column: DBColumn, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, column: DBColumn, key: bytes) -> None:
        raise NotImplementedError

    def exists(self, column: DBColumn, key: bytes) -> bool:
        return self.get(column, key) is not None

    def iter_column(self, column: DBColumn):
        raise NotImplementedError

    def do_atomically(self, ops: list) -> None:
        """Apply a batch ALL-OR-NOTHING.

        ``ops``: list of ``("put", col, key, val)`` | ``("delete", col, key)``.

        Contract (every backend must honor it): either every op in the batch
        becomes visible or none does — to concurrent readers AND across a
        crash at any instant. Callers rely on this for multi-key sequences
        (block import, the finalization migration, slasher checkpoints):
        observing a partially-applied batch after a kill is a durability
        bug, not a degraded mode. Backends therefore stage + validate the
        whole batch BEFORE mutating anything, and commit it through one
        atomic step (one dict merge, one framed log append).
        """
        for key, value in _stage_ops(ops):
            # base implementation: per-op dispatch after full validation.
            # Crash-atomicity is the backend's job; backends with real
            # durability (LevelStore) override this with a single frame.
            col, raw = key
            if value is None:
                self.delete(col, raw)
            else:
                self.put(col, raw, value)

    def compact(self) -> None:
        pass

    def close(self) -> None:
        pass


def _stage_ops(ops: list) -> list:
    """Validate + normalize a ``do_atomically`` batch BEFORE any mutation.

    Returns ``[((column, key), value | None), ...]`` (None = delete). Any
    malformed op raises here, while the store is still untouched — a batch
    can never be half-applied because its tail failed to parse.
    """
    staged = []
    for op in ops:
        if not op or op[0] not in ("put", "delete"):
            raise ValueError(f"bad atomic op {op!r}")
        if op[0] == "put":
            _, col, key, val = op
            staged.append(((col, bytes(key)), bytes(val)))
        else:
            _, col, key = op
            staged.append(((col, bytes(key)), None))
    return staged


class MemoryStore(KeyValueStore):
    """Thread-safe dict store (memory_store.rs)."""

    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    @staticmethod
    def _k(column: DBColumn, key: bytes) -> bytes:
        return column.value + b"/" + key

    def get(self, column, key):
        with self._lock:
            return self._data.get(self._k(column, key))

    def put(self, column, key, value):
        with self._lock:
            self._data[self._k(column, key)] = bytes(value)

    def delete(self, column, key):
        with self._lock:
            self._data.pop(self._k(column, key), None)

    def iter_column(self, column):
        prefix = column.value + b"/"
        with self._lock:
            items = [
                (k[len(prefix):], v)
                for k, v in self._data.items()
                if k.startswith(prefix)
            ]
        return iter(sorted(items))

    def do_atomically(self, ops):
        # stage first (validation can raise), THEN mutate under the lock:
        # dict set/pop on staged bytes cannot fail, so the batch is applied
        # whole or not at all even when an op mid-list is malformed
        staged = _stage_ops(ops)
        with self._lock:
            for (col, key), value in staged:
                k = col.value + b"/" + key
                if value is None:
                    self._data.pop(k, None)
                else:
                    self._data[k] = value

    def __len__(self):
        return len(self._data)


# -- the write-ahead log ------------------------------------------------------

_FRAME_MAGIC = 0x4C57414C   # "LWAL"
_COMMIT_MAGIC = 0x434D4954  # "CMIT"
_FRAME_HDR = struct.Struct("<III")   # magic, n_records, payload_len
_REC_HDR = struct.Struct("<BIII")    # op, klen, vlen, crc32(op|key|val)
_COMMIT = struct.Struct("<II")       # commit magic, crc32(payload)


def _rec_crc(op: int, key: bytes, val: bytes) -> int:
    return zlib.crc32(val, zlib.crc32(key, zlib.crc32(bytes([op]))))


class LevelStore(KeyValueStore):
    """Durable append-log store: framed WAL commits + in-memory index.

    File format: a sequence of commit *frames*, each one atomic batch::

        [u32 magic][u32 n_records][u32 payload_len]
          payload: n_records x ([u8 op][u32 klen][u32 vlen][u32 rec_crc]
                                [key][value])
        [u32 commit_magic][u32 payload_crc]

    ``put``/``delete`` write a one-record frame; ``do_atomically`` writes the
    whole batch as ONE frame, so a crash at any byte either commits the batch
    or leaves a torn tail. Replay verifies the commit marker + per-record
    checksums and TRUNCATES the file at the first incomplete/corrupt frame
    (the torn tail a kill mid-write leaves) — a multi-key sequence can never
    be observed half-applied after a restart. A pre-WAL (unframed) log is
    detected on open and rewritten in place through compaction.

    Compaction writes the survivor set to ``<path>.compact`` as one frame and
    ``os.replace``s it over the log; a leftover ``.compact`` from a crash in
    that window is deleted on reopen, never replayed. ``fsync=True`` adds an
    fsync per commit (the real-node configuration; the test/simulation tier
    keeps it off — the crash harness tears writes at the API layer, not with
    power loss). ``recovery_stats`` reports what replay saw; the restart
    harness folds it into the recovery metrics. Plays the role of
    ``leveldb_store.rs`` until the native engine arrives.
    """

    _PUT, _DEL = 1, 2

    #: append-only logs need a growth bound: once the file exceeds the floor
    #: and live values are under the fraction, a commit triggers compaction
    #: (the periodic full-checkpoint writers — slasher planes every tick —
    #: otherwise grow the log by a dead frame per slot, forever)
    AUTO_COMPACT_MIN_BYTES = 4 * 1024 * 1024
    AUTO_COMPACT_LIVE_FRAC = 0.25

    def __init__(
        self,
        path: str,
        fsync: bool = False,
        owner: str | None = None,
        auto_compact: bool = True,
    ):
        self.path = path
        self.fsync = fsync
        self.owner = owner  # crash-point attribution (testing harness)
        self.auto_compact = auto_compact
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._index: dict[bytes, tuple[int, int]] = {}  # key -> (offset, vlen)
        self._live_bytes = 0  # sum of live value lengths (compaction trigger)
        self._lock = threading.RLock()
        self.recovery_stats = {
            "replayed_frames": 0,
            "replayed_records": 0,
            "truncated_bytes": 0,
            "stale_compact_removed": 0,
            "legacy_upgraded": False,
        }
        tmp = path + ".compact"
        if os.path.exists(tmp):
            # a crash inside compact() left a partial (or complete but
            # unadopted) rewrite: the log itself is still the truth — the
            # tmp file is IGNORED and removed, never replayed
            os.unlink(tmp)
            self.recovery_stats["stale_compact_removed"] = 1
        self._fh = open(path, "a+b")
        self._replay()

    # -- replay ------------------------------------------------------------

    def _replay(self):
        self._fh.seek(0)
        data = self._fh.read()
        # < 4 bytes can be neither a frame header nor a legacy record:
        # it is a torn tail (a kill mid-first-append), handled below
        if len(data) >= 4 and struct.unpack_from("<I", data, 0)[0] != _FRAME_MAGIC:
            # pre-WAL log (the unframed [op][klen][vlen][key][val] stream):
            # replay with the legacy parser, then rewrite framed in place
            self._replay_legacy(data)
            self.recovery_stats["legacy_upgraded"] = True
            self.compact()
            return
        pos = 0
        while pos + _FRAME_HDR.size <= len(data):
            magic, n_records, plen = _FRAME_HDR.unpack_from(data, pos)
            end = pos + _FRAME_HDR.size + plen + _COMMIT.size
            if magic != _FRAME_MAGIC or end > len(data):
                break  # torn tail
            payload_off = pos + _FRAME_HDR.size
            payload = data[payload_off : payload_off + plen]
            cmagic, ccrc = _COMMIT.unpack_from(data, payload_off + plen)
            if cmagic != _COMMIT_MAGIC or ccrc != zlib.crc32(payload):
                break  # uncommitted / torn frame
            staged = self._parse_frame(payload, payload_off, n_records)
            if staged is None:
                break  # per-record corruption inside the frame
            for key, loc in staged:
                if loc is None:
                    self._index_del(key)
                else:
                    self._index_set(key, loc)
            self.recovery_stats["replayed_frames"] += 1
            self.recovery_stats["replayed_records"] += n_records
            pos = end
        if pos < len(data):
            # torn tail: drop it ON DISK too, so future appends never
            # interleave with garbage
            self.recovery_stats["truncated_bytes"] = len(data) - pos
            self._fh.truncate(pos)
            self._fh.flush()

    def _parse_frame(self, payload: bytes, payload_off: int, n_records: int):
        """[(key, (voff, vlen) | None)] for one frame, or None if any
        record fails its checksum."""
        staged, rpos = [], 0
        for _ in range(n_records):
            if rpos + _REC_HDR.size > len(payload):
                return None
            op, klen, vlen, crc = _REC_HDR.unpack_from(payload, rpos)
            rpos += _REC_HDR.size
            if rpos + klen + vlen > len(payload) or op not in (
                self._PUT, self._DEL
            ):
                return None
            key = payload[rpos : rpos + klen]
            val = payload[rpos + klen : rpos + klen + vlen]
            if crc != _rec_crc(op, key, val):
                return None
            voff = payload_off + rpos + klen
            rpos += klen + vlen
            staged.append(
                (key, (voff, vlen) if op == self._PUT else None)
            )
        return staged

    def _replay_legacy(self, data: bytes) -> None:
        """The seed's unframed record stream (discard-tail semantics)."""
        pos = 0
        while pos + 9 <= len(data):
            op, klen, vlen = struct.unpack_from("<BII", data, pos)
            pos += 9
            if pos + klen + vlen > len(data):
                break  # truncated tail: discard
            key = data[pos : pos + klen]
            pos += klen
            if op == self._PUT:
                self._index_set(key, (pos, vlen))
            else:
                self._index_del(key)
            pos += vlen

    # -- index bookkeeping -------------------------------------------------

    def _index_set(self, k: bytes, loc: tuple[int, int]) -> None:
        old = self._index.get(k)
        if old is not None:
            self._live_bytes -= old[1]
        self._index[k] = loc
        self._live_bytes += loc[1]

    def _index_del(self, k: bytes) -> None:
        old = self._index.pop(k, None)
        if old is not None:
            self._live_bytes -= old[1]

    # -- commit ------------------------------------------------------------

    @staticmethod
    def _maybe_crash(stage: str, owner, tear_capable: bool = True):
        """Crash-point hook (resilience/crashpoints.py): inert unless the
        LIGHTHOUSE_FAULT_INJECT grammar armed a kill/tear plan. The WAL
        owns its byte streams, so its barriers are tear-capable."""
        from ..resilience.crashpoints import maybe_crash

        return maybe_crash(stage, owner=owner, tear_capable=tear_capable)

    def _sync(self) -> None:
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def _commit_frame(self, staged: list) -> None:
        """Write one atomic frame for ``staged`` ([( (col,key), val|None )])
        and apply it to the index only once fully on disk. Caller holds the
        lock. The ``store.commit`` crash point fires here: ``kill`` dies
        before a single byte is written, ``tear`` persists a prefix of the
        frame (the torn tail replay must truncate) and then dies.
        """
        if not staged:
            return
        recs, keys = [], []
        for (col, key), value in staged:
            k = col.value + b"/" + key
            if value is None:
                op, val = self._DEL, b""
            else:
                op, val = self._PUT, value
            recs.append(
                _REC_HDR.pack(op, len(k), len(val), _rec_crc(op, k, val))
                + k + val
            )
            keys.append((k, val if value is not None else None))
        payload = b"".join(recs)
        frame = (
            _FRAME_HDR.pack(_FRAME_MAGIC, len(recs), len(payload))
            + payload
            + _COMMIT.pack(_COMMIT_MAGIC, zlib.crc32(payload))
        )
        action = self._maybe_crash("store.commit", self.owner)
        self._fh.seek(0, os.SEEK_END)
        start = self._fh.tell()
        if action == "tear":
            # simulate a kill mid-write: persist a deterministic prefix of
            # the frame, then die. Replay truncates exactly this tear.
            self._fh.write(frame[: max(1, len(frame) // 2)])
            self._sync()
            from ..resilience.crashpoints import raise_crash

            raise_crash("store.commit", self.owner, torn=True)
        self._fh.write(frame)
        self._sync()
        # index update AFTER the bytes are down (a failed write never
        # publishes a location)
        payload_off = start + _FRAME_HDR.size
        rpos = 0
        for k, val in keys:
            rpos += _REC_HDR.size + len(k)
            if val is None:
                self._index_del(k)
                rpos += 0
            else:
                self._index_set(k, (payload_off + rpos, len(val)))
                rpos += len(val)
        end = start + len(frame)
        if (
            self.auto_compact
            and end >= self.AUTO_COMPACT_MIN_BYTES
            and self._live_bytes < int(end * self.AUTO_COMPACT_LIVE_FRAC)
        ):
            # mostly-dead log (e.g. a full-checkpoint writer overwriting one
            # key per slot): fold it down so the file stays O(live set)
            self.compact()

    @staticmethod
    def _k(column: DBColumn, key: bytes) -> bytes:
        return column.value + b"/" + key

    def get(self, column, key):
        k = self._k(column, key)
        with self._lock:
            loc = self._index.get(k)
            if loc is None:
                return None
            off, vlen = loc
            self._fh.seek(off)
            return self._fh.read(vlen)

    def put(self, column, key, value):
        with self._lock:
            self._commit_frame([((column, bytes(key)), bytes(value))])

    def delete(self, column, key):
        with self._lock:
            if self._k(column, bytes(key)) in self._index:
                self._commit_frame([((column, bytes(key)), None)])

    def do_atomically(self, ops):
        staged = _stage_ops(ops)
        with self._lock:
            self._commit_frame(staged)

    def iter_column(self, column):
        prefix = column.value + b"/"
        with self._lock:
            keys = sorted(k for k in self._index if k.startswith(prefix))
            return iter([(k[len(prefix):], self.get(column, k[len(prefix):])) for k in keys])

    def compact(self):
        with self._lock:
            action = self._maybe_crash("store.compact", self.owner)
            tmp = self.path + ".compact"
            # stream record-by-record: the live set can be GBs of states,
            # so only one value is ever resident (the payload length and
            # commit CRC are computed without materializing the frame)
            items = sorted(self._index.items())
            payload_len = sum(
                _REC_HDR.size + len(k) + vlen for k, (_, vlen) in items
            )
            frame_len = _FRAME_HDR.size + payload_len + _COMMIT.size
            # tear = die after a deterministic PREFIX of the byte stream
            # (same cut as the frame-materializing implementation): the
            # half-written .compact must be discarded on reopen
            cut = max(1, frame_len // 2) if action == "tear" else None
            with open(tmp, "wb") as out:
                written = 0

                def emit(chunk: bytes) -> None:
                    nonlocal written
                    if cut is not None and written + len(chunk) >= cut:
                        out.write(chunk[: cut - written])
                        out.flush()
                        from ..resilience.crashpoints import raise_crash

                        raise_crash("store.compact", self.owner, torn=True)
                    out.write(chunk)
                    written += len(chunk)

                emit(_FRAME_HDR.pack(_FRAME_MAGIC, len(items), payload_len))
                crc = 0
                for k, (off, vlen) in items:
                    self._fh.seek(off)
                    v = self._fh.read(vlen)
                    rec = (
                        _REC_HDR.pack(
                            self._PUT, len(k), len(v),
                            _rec_crc(self._PUT, k, v),
                        )
                        + k + v
                    )
                    crc = zlib.crc32(rec, crc)
                    emit(rec)
                emit(_COMMIT.pack(_COMMIT_MAGIC, crc))
                out.flush()
                if self.fsync:
                    os.fsync(out.fileno())
            # the window the reopen path must survive: a kill here leaves a
            # COMPLETE .compact beside the (still authoritative) log
            # not a byte-stream barrier: a tear plan here degrades to kill
            # (the replace window is all-or-nothing by construction)
            self._maybe_crash(
                "store.compact.replace", self.owner, tear_capable=False
            )
            self._fh.close()
            os.replace(tmp, self.path)
            if self.fsync:
                dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            self._fh = open(self.path, "a+b")
            new_index, rpos = {}, _FRAME_HDR.size
            for k, (_, vlen) in items:
                rpos += _REC_HDR.size + len(k)
                new_index[k] = (rpos, vlen)
                rpos += vlen
            self._index = new_index
            self._live_bytes = sum(vlen for _, (_, vlen) in items)

    def close(self):
        self._fh.close()
