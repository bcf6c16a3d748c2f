"""Watch database: canonical slots + block metadata (ref watch/migrations) — the port's copy of
``lighthouse_tpu/watch/db.py``.

SQLite tables mirroring the reference's diesel schema: ``canonical_slots``
(every slot, skipped or not, with its canonical root) and ``beacon_blocks``
(per-block analytics columns the reference's block-rewards/packing updaters
fill)."""

from __future__ import annotations

import sqlite3
import threading


class WatchDB:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS canonical_slots (
                    slot INTEGER PRIMARY KEY,
                    root BLOB NOT NULL,
                    skipped INTEGER NOT NULL
                );
                CREATE TABLE IF NOT EXISTS beacon_blocks (
                    slot INTEGER PRIMARY KEY,
                    root BLOB NOT NULL,
                    parent_root BLOB NOT NULL,
                    proposer_index INTEGER NOT NULL,
                    graffiti TEXT NOT NULL,
                    attestation_count INTEGER NOT NULL,
                    deposit_count INTEGER NOT NULL,
                    exit_count INTEGER NOT NULL,
                    attesting_votes INTEGER NOT NULL
                );
                CREATE INDEX IF NOT EXISTS blocks_by_proposer
                    ON beacon_blocks(proposer_index);
                """
            )
            self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    # -- writes -------------------------------------------------------------

    def put_canonical_slot(self, slot: int, root: bytes, skipped: bool) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO canonical_slots VALUES (?, ?, ?)",
                (slot, root, int(skipped)),
            )
            self._conn.commit()

    def put_block(self, row: dict) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO beacon_blocks VALUES "
                "(:slot, :root, :parent_root, :proposer_index, :graffiti, "
                ":attestation_count, :deposit_count, :exit_count, "
                ":attesting_votes)",
                row,
            )
            self._conn.commit()

    # -- queries ------------------------------------------------------------

    def slot_bounds(self) -> tuple[int, int] | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT MIN(slot), MAX(slot) FROM canonical_slots"
            ).fetchone()
        return None if row[0] is None else (row[0], row[1])

    def canonical_slot(self, slot: int) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT slot, root, skipped FROM canonical_slots WHERE slot=?",
                (slot,),
            ).fetchone()
        if row is None:
            return None
        return {"slot": row[0], "root": "0x" + row[1].hex(), "skipped": bool(row[2])}

    def block(self, slot: int) -> dict | None:
        with self._lock:
            cur = self._conn.execute(
                "SELECT * FROM beacon_blocks WHERE slot=?", (slot,)
            )
            row = cur.fetchone()
            cols = [d[0] for d in cur.description]
        if row is None:
            return None
        out = dict(zip(cols, row))
        for k in ("root", "parent_root"):
            out[k] = "0x" + out[k].hex()
        return out

    def blocks_by_proposer(self, proposer_index: int) -> list[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT slot FROM beacon_blocks WHERE proposer_index=? "
                "ORDER BY slot",
                (proposer_index,),
            ).fetchall()
        return [r[0] for r in rows]

    def participation(self, lo: int, hi: int) -> dict:
        """Aggregate attestation votes over a slot range (block-packing
        analytics)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*), SUM(attestation_count), SUM(attesting_votes) "
                "FROM beacon_blocks WHERE slot BETWEEN ? AND ?",
                (lo, hi),
            ).fetchone()
        return {
            "blocks": row[0] or 0,
            "attestations": row[1] or 0,
            "attesting_votes": row[2] or 0,
        }
