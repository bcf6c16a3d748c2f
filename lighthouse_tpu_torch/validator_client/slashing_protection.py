"""Slashing protection: SQLite interlock on every signature (EIP-3076) — the port's copy of
``lighthouse_tpu/validator_client/slashing_protection.py``.

Lighthouse's ``validator_client/slashing_protection`` (3,561 LoC):
same schema shape (validators / signed_blocks / signed_attestations), the
minimal-slot/epoch pruning rules, double+surround vote rejection in both
directions, and the EIP-3076 interchange JSON for import/export between
clients.
"""

from __future__ import annotations

import sqlite3
import threading


class NotSafe(Exception):
    """Signing refused: would violate slashing conditions."""


class SafeKind:
    VALID = "valid"
    SAME_DATA = "same_data"  # exact re-sign of identical data: permitted


_SCHEMA = """
CREATE TABLE IF NOT EXISTS validators (
    id INTEGER PRIMARY KEY,
    public_key BLOB NOT NULL UNIQUE
);
CREATE TABLE IF NOT EXISTS signed_blocks (
    validator_id INTEGER NOT NULL REFERENCES validators(id),
    slot INTEGER NOT NULL,
    signing_root BLOB,
    UNIQUE (validator_id, slot)
);
CREATE TABLE IF NOT EXISTS signed_attestations (
    validator_id INTEGER NOT NULL REFERENCES validators(id),
    source_epoch INTEGER NOT NULL,
    target_epoch INTEGER NOT NULL,
    signing_root BLOB,
    UNIQUE (validator_id, target_epoch)
);
"""


class SlashingDatabase:
    INTERCHANGE_VERSION = "5"

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()

    # -- registration ------------------------------------------------------------

    def register_validator(self, pubkey: bytes) -> int:
        with self._lock:
            cur = self._conn.execute(
                "SELECT id FROM validators WHERE public_key = ?", (pubkey,)
            ).fetchone()
            if cur:
                return cur[0]
            c = self._conn.execute(
                "INSERT INTO validators (public_key) VALUES (?)", (pubkey,)
            )
            self._conn.commit()
            return c.lastrowid

    def _vid(self, pubkey: bytes) -> int:
        row = self._conn.execute(
            "SELECT id FROM validators WHERE public_key = ?", (pubkey,)
        ).fetchone()
        if row is None:
            raise NotSafe(f"unregistered validator {pubkey.hex()[:16]}")
        return row[0]

    # -- blocks -------------------------------------------------------------------

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ) -> str:
        with self._lock:
            vid = self._vid(pubkey)
            same = self._conn.execute(
                "SELECT signing_root FROM signed_blocks"
                " WHERE validator_id = ? AND slot = ?",
                (vid, slot),
            ).fetchone()
            if same is not None:
                if same[0] == signing_root:
                    return SafeKind.SAME_DATA
                raise NotSafe(f"double block proposal at slot {slot}")
            low = self._conn.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE validator_id = ?",
                (vid,),
            ).fetchone()[0]
            if low is not None and slot <= low:
                # EIP-3076: refuse anything at or below the highest signed slot
                raise NotSafe(f"slot {slot} <= max signed slot {low}")
            self._conn.execute(
                "INSERT INTO signed_blocks VALUES (?, ?, ?)",
                (vid, slot, signing_root),
            )
            self._conn.commit()
            return SafeKind.VALID

    # -- attestations ------------------------------------------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int,
        signing_root: bytes,
    ) -> str:
        if source_epoch > target_epoch:
            raise NotSafe("source epoch after target epoch")
        with self._lock:
            vid = self._vid(pubkey)
            same = self._conn.execute(
                "SELECT signing_root, source_epoch FROM signed_attestations"
                " WHERE validator_id = ? AND target_epoch = ?",
                (vid, target_epoch),
            ).fetchone()
            if same is not None:
                if same[0] == signing_root and same[1] == source_epoch:
                    return SafeKind.SAME_DATA
                raise NotSafe(f"double vote at target {target_epoch}")
            # surround checks (both directions)
            surrounding = self._conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ?"
                " AND source_epoch < ? AND target_epoch > ? LIMIT 1",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounding:
                raise NotSafe("attestation surrounded by prior vote")
            surrounded = self._conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ?"
                " AND source_epoch > ? AND target_epoch < ? LIMIT 1",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if surrounded:
                raise NotSafe("attestation surrounds a prior vote")
            # EIP-3076 minimums
            max_src, max_tgt = self._conn.execute(
                "SELECT MAX(source_epoch), MAX(target_epoch)"
                " FROM signed_attestations WHERE validator_id = ?",
                (vid,),
            ).fetchone()
            if max_src is not None and source_epoch < max_src:
                raise NotSafe(f"source {source_epoch} < min source {max_src}")
            if max_tgt is not None and target_epoch <= max_tgt:
                raise NotSafe(f"target {target_epoch} <= min target {max_tgt}")
            self._conn.execute(
                "INSERT INTO signed_attestations VALUES (?, ?, ?, ?)",
                (vid, source_epoch, target_epoch, signing_root),
            )
            self._conn.commit()
            return SafeKind.VALID

    # -- interchange (EIP-3076) ----------------------------------------------------

    def prune(self, finalized_epoch: int, slots_per_epoch: int = 32) -> dict:
        """Drop history that can no longer protect anything
        (``slashing_database.rs`` prune_all_signed_{blocks,attestations}):
        finalized data is immutable, so entries strictly below the
        finalized boundary are dead weight — EXCEPT each validator's
        maximum entry, which is the lower bound future signings are
        checked against and must survive."""
        finalized_slot = finalized_epoch * slots_per_epoch
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                """DELETE FROM signed_blocks WHERE slot < ? AND slot < (
                     SELECT MAX(slot) FROM signed_blocks b2
                     WHERE b2.validator_id = signed_blocks.validator_id)""",
                (finalized_slot,),
            )
            blocks = cur.rowcount
            cur.execute(
                """DELETE FROM signed_attestations
                   WHERE target_epoch < ? AND target_epoch < (
                     SELECT MAX(target_epoch) FROM signed_attestations a2
                     WHERE a2.validator_id
                           = signed_attestations.validator_id)""",
                (finalized_epoch,),
            )
            atts = cur.rowcount
            self._conn.commit()
        return {"blocks_pruned": blocks, "attestations_pruned": atts}

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        with self._lock:
            data = []
            for vid, pk in self._conn.execute(
                "SELECT id, public_key FROM validators"
            ):
                blocks = [
                    {"slot": str(s), "signing_root": "0x" + (r or b"").hex()}
                    for s, r in self._conn.execute(
                        "SELECT slot, signing_root FROM signed_blocks"
                        " WHERE validator_id = ?", (vid,),
                    )
                ]
                atts = [
                    {
                        "source_epoch": str(se),
                        "target_epoch": str(te),
                        "signing_root": "0x" + (r or b"").hex(),
                    }
                    for se, te, r in self._conn.execute(
                        "SELECT source_epoch, target_epoch, signing_root"
                        " FROM signed_attestations WHERE validator_id = ?",
                        (vid,),
                    )
                ]
                data.append(
                    {
                        "pubkey": "0x" + pk.hex(),
                        "signed_blocks": blocks,
                        "signed_attestations": atts,
                    }
                )
            return {
                "metadata": {
                    "interchange_format_version": self.INTERCHANGE_VERSION,
                    "genesis_validators_root": "0x"
                    + genesis_validators_root.hex(),
                },
                "data": data,
            }

    def import_interchange(self, obj: dict) -> int:
        n = 0
        with self._lock:
            for entry in obj.get("data", []):
                pk = bytes.fromhex(entry["pubkey"].removeprefix("0x"))
                vid = self.register_validator(pk)
                for b in entry.get("signed_blocks", []):
                    self._conn.execute(
                        "INSERT OR IGNORE INTO signed_blocks VALUES (?, ?, ?)",
                        (
                            vid,
                            int(b["slot"]),
                            bytes.fromhex(
                                b.get("signing_root", "0x").removeprefix("0x")
                            ),
                        ),
                    )
                    n += 1
                for a in entry.get("signed_attestations", []):
                    self._conn.execute(
                        "INSERT OR IGNORE INTO signed_attestations"
                        " VALUES (?, ?, ?, ?)",
                        (
                            vid,
                            int(a["source_epoch"]),
                            int(a["target_epoch"]),
                            bytes.fromhex(
                                a.get("signing_root", "0x").removeprefix("0x")
                            ),
                        ),
                    )
                    n += 1
            self._conn.commit()
        return n
