"""Transport seam + the in-process loopback implementation.

Gossip topics mirror the gossipsub topic family
(``lighthouse_network/src/types/topics.rs``); req/resp mirrors the Req/Resp
protocols (``lighthouse_network/src/rpc/protocol.rs``: Status, BlocksByRange,
BlocksByRoot). The loopback bus delivers synchronously and deterministically —
the shape ``testing/simulator`` relies on for multi-node tests without
sockets.
"""

from __future__ import annotations

from dataclasses import dataclass


class Topic:
    BEACON_BLOCK = "beacon_block"
    BEACON_ATTESTATION = "beacon_attestation"  # subnet topics collapse to one
    AGGREGATE_AND_PROOF = "beacon_aggregate_and_proof"
    VOLUNTARY_EXIT = "voluntary_exit"
    PROPOSER_SLASHING = "proposer_slashing"
    ATTESTER_SLASHING = "attester_slashing"
    SYNC_COMMITTEE_MESSAGE = "sync_committee"  # subnet topics collapse to one
    SYNC_CONTRIBUTION = "sync_committee_contribution_and_proof"
    DATA_COLUMN_SIDECAR = "data_column_sidecar"  # PeerDAS (subnets collapse)


@dataclass
class Status:
    """Req/resp Status handshake payload (rpc STATUS message)."""

    fork_digest: bytes
    finalized_root: bytes
    finalized_epoch: int
    head_root: bytes
    head_slot: int


class Transport:
    """What a node needs from the wire: publish/subscribe + peer RPC."""

    def publish(self, from_peer: str, topic: str, message) -> None:
        raise NotImplementedError

    def request(self, from_peer: str, to_peer: str, method: str, payload):
        raise NotImplementedError

    def peers(self, exclude: str | None = None) -> list[str]:
        raise NotImplementedError


class LoopbackTransport(Transport):
    """All nodes in one process; delivery is an immediate method call.

    Fault injection: ``partition(a, b)`` drops traffic between two peers
    (both gossip and RPC) until ``heal()``; ``set_gossip_loss(rate, seed)``
    drops each gossip delivery with a SEEDED probability — deterministic
    given the seed and the (synchronous) publish order, so a chaos run
    replays exactly; ``unregister`` simulates a node crash (the chaos
    harness re-``register``s on restart).
    """

    def __init__(self):
        self._handlers: dict[str, object] = {}  # peer_id -> service
        self._partitions: set[frozenset] = set()
        self._loss_rate = 0.0
        self._loss_rng = None
        self.gossip_delivered = 0
        self.gossip_dropped = 0  # seeded-loss drops only (not partitions)
        # chaos-harness hook: called with an InjectedCrash raised by a
        # RECIPIENT during delivery. A kill -9 of one subscriber must not
        # unwind the publisher's fan-out — the hook crashes that node and
        # delivery continues to the remaining peers.
        self.on_injected_crash = None

    def register(self, peer_id: str, service) -> None:
        if peer_id in self._handlers:
            raise ValueError(f"duplicate peer id {peer_id}")
        self._handlers[peer_id] = service

    def unregister(self, peer_id: str) -> None:
        """Crash ``peer_id``: all delivery to/from it stops until a new
        service registers under the same id."""
        self._handlers.pop(peer_id, None)

    def partition(self, a: str, b: str) -> None:
        self._partitions.add(frozenset((a, b)))

    def heal(self) -> None:
        self._partitions.clear()

    def set_gossip_loss(self, rate: float, seed: int = 0) -> None:
        """Drop each (recipient, message) gossip delivery with probability
        ``rate``, decided by a dedicated seeded RNG. ``rate=0`` disables."""
        import random as _random

        self._loss_rate = float(rate)
        self._loss_rng = _random.Random(seed) if rate > 0 else None

    def _blocked(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self._partitions

    def publish(self, from_peer: str, topic: str, message) -> None:
        for pid, svc in list(self._handlers.items()):
            if pid == from_peer or self._blocked(pid, from_peer):
                continue
            if self._loss_rng is not None and (
                self._loss_rng.random() < self._loss_rate
            ):
                self.gossip_dropped += 1
                continue
            self.gossip_delivered += 1
            if self.on_injected_crash is None:
                svc.on_gossip(topic, message, from_peer)
                continue
            from ..resilience.crashpoints import InjectedCrash

            try:
                svc.on_gossip(topic, message, from_peer)
            except InjectedCrash as e:
                # the recipient died at one of its persistence barriers;
                # the publisher and every other peer keep going
                self.on_injected_crash(e)

    def request(self, from_peer: str, to_peer: str, method: str, payload):
        if self._blocked(from_peer, to_peer):
            raise ConnectionError(f"partitioned: {from_peer} <-> {to_peer}")
        svc = self._handlers.get(to_peer)
        if svc is None:
            raise ConnectionError(f"unknown peer {to_peer}")
        return svc.on_rpc(method, payload, from_peer)

    def peers(self, exclude: str | None = None) -> list[str]:
        return [p for p in self._handlers if p != exclude]
