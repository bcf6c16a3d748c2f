"""Peer manager: connection registry, score ledger, and ban lifecycle.

The twin of the reference's ``peer_manager/mod.rs:1-2471`` + peerdb: a
durable per-peer record that outlives the TCP connection, so a peer that
earns a ban stays out across reconnect attempts (the transport's in-object
scores died with the socket, which let an abuser reconnect with a clean
slate). Scores use the same shape as the transport's gossip scoring; bans
expire after BAN_DURATION (the reference's temporary ban semantics) and the
record's score is reset on unban, mirroring peerdb's score decay floor.

States: disconnected -> connected -> {disconnected | banned(expiry)}.
"""

from __future__ import annotations

import threading
import time

from ..utils.logging import get_logger

log = get_logger("peer_manager")

BAN_THRESHOLD = -100.0
BAN_DURATION = 900.0   # seconds (reference: temp ban, then forgiven)
SCORE_FLOOR = -1000.0
SCORE_CEIL = 100.0
SCORE_DECAY = 0.9


class _PeerRecord:
    __slots__ = ("addr", "node_id", "score", "state", "ban_until",
                 "connections", "disconnections")

    def __init__(self, addr: str):
        self.addr = addr
        self.node_id: bytes | None = None
        self.score = 0.0
        self.state = "disconnected"
        self.ban_until = 0.0
        self.connections = 0
        self.disconnections = 0


class PeerManager:
    """Address-keyed peer DB (node-id aliases recorded when known)."""

    def __init__(self, clock=time.monotonic):
        self._peers: dict[str, _PeerRecord] = {}
        self._banned_ids: dict[bytes, float] = {}
        self._lock = threading.Lock()
        self._clock = clock

    def _rec(self, addr: str) -> _PeerRecord:
        rec = self._peers.get(addr)
        if rec is None:
            rec = self._peers[addr] = _PeerRecord(addr)
        return rec

    # -- connection lifecycle ---------------------------------------------

    def on_connect(self, addr: str, node_id: bytes | None = None) -> bool:
        """Record a connection; False if the peer is banned (caller must
        refuse/close — reconnect suppression)."""
        with self._lock:
            if self._is_banned_locked(addr, node_id):
                return False
            rec = self._rec(addr)
            rec.state = "connected"
            rec.connections += 1
            if node_id is not None:
                rec.node_id = node_id
            return True

    def on_disconnect(self, addr: str) -> None:
        with self._lock:
            rec = self._peers.get(addr)
            if rec is not None and rec.state == "connected":
                rec.state = "disconnected"
                rec.disconnections += 1

    # -- scoring / bans ----------------------------------------------------

    def report(self, addr: str, delta: float) -> float:
        """Adjust a peer's durable score; crossing BAN_THRESHOLD bans it.
        Returns the new score."""
        with self._lock:
            rec = self._rec(addr)
            rec.score = max(SCORE_FLOOR, min(SCORE_CEIL, rec.score + delta))
            if rec.score <= BAN_THRESHOLD and rec.state != "banned":
                self._ban_locked(rec)
            return rec.score

    def ban(self, addr: str, duration: float = BAN_DURATION) -> None:
        with self._lock:
            rec = self._rec(addr)
            self._ban_locked(rec, duration)

    def _ban_locked(self, rec: _PeerRecord, duration: float = BAN_DURATION):
        rec.state = "banned"
        rec.ban_until = self._clock() + duration
        if rec.node_id is not None:
            self._banned_ids[rec.node_id] = rec.ban_until
        log.warn("Peer banned", addr=rec.addr,
                 until_s=round(duration, 1), score=round(rec.score, 1))

    def is_banned(self, addr: str | None = None,
                  node_id: bytes | None = None) -> bool:
        with self._lock:
            return self._is_banned_locked(addr, node_id)

    def _is_banned_locked(self, addr, node_id) -> bool:
        now = self._clock()
        if addr is not None:
            rec = self._peers.get(addr)
            if rec is not None and rec.state == "banned":
                if rec.ban_until > now:
                    return True
                # ban expired: forgive (score reset to the threshold's
                # recovery point so one more offence re-bans quickly)
                rec.state = "disconnected"
                rec.score = BAN_THRESHOLD / 2
        if node_id is not None:
            until = self._banned_ids.get(node_id)
            if until is not None:
                if until > now:
                    return True
                del self._banned_ids[node_id]
        return False

    def decay_scores(self) -> None:
        with self._lock:
            for rec in self._peers.values():
                rec.score *= SCORE_DECAY

    # -- introspection -----------------------------------------------------

    def score(self, addr: str) -> float:
        with self._lock:
            rec = self._peers.get(addr)
            return rec.score if rec else 0.0

    def state(self, addr: str) -> str:
        with self._lock:
            rec = self._peers.get(addr)
            return rec.state if rec else "unknown"

    def connected(self) -> list[str]:
        with self._lock:
            return [a for a, r in self._peers.items()
                    if r.state == "connected"]

    def summary(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for r in self._peers.values():
                states[r.state] = states.get(r.state, 0) + 1
            return states
