"""Gossipsub v1.1 mesh over the socket transport.

The twin of the reference's vendored gossipsub fork
(``lighthouse_network/gossipsub/src/behaviour.rs``, ``peer_score.rs``,
``mcache.rs``): instead of flooding every message to every peer, each node
maintains a per-topic **mesh** of degree ~D full-message peers (GRAFT/PRUNE
with backoff), announces recent message ids to a few non-mesh peers each
heartbeat (IHAVE) which can fetch bodies on demand (IWANT), and scores peers
per topic (time-in-mesh, first deliveries, mesh delivery deficit, invalid
messages, behaviour penalty) so misbehaving peers are pruned and eventually
graylisted. Per-node message load is O(D), not O(peers).

Wire format: one new frame kind CONTROL (5) carrying a sequence of control
entries, multiplexed on the same length-prefixed TCP streams as GOSSIP/RPC:

    u8 op | fields
    op 1 SUBSCRIBE   : u8 topic_len | topic
    op 2 UNSUBSCRIBE : u8 topic_len | topic
    op 3 GRAFT       : u8 topic_len | topic
    op 4 PRUNE       : u8 topic_len | topic | u16 backoff_secs
    op 5 IHAVE       : u8 topic_len | topic | u16 n | n * 20B msg ids
    op 6 IWANT       : u16 n | n * 20B msg ids

Validation precedes forwarding (gossipsub v1.1): a message the local service
rejects is never propagated, and the sender takes an invalid-message penalty
(behaviour.rs ``report_message_validation_result``).

Each transport draws its mesh choices (fanout top-up, GRAFT candidates,
IHAVE targets) from its own ``random.Random``, passed by the caller, so a
seeded mesh replays; none is drawn from the process-global ``random``.
"""

from __future__ import annotations

import random
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import hashlib

from ..utils.logging import get_logger
from .codec import WireError
from .socket_transport import (
    SocketTransport,
    _GOSSIP,
    _Peer,
)

log = get_logger("gossipsub")

_CONTROL = 5

_SUB, _UNSUB, _GRAFT, _PRUNE, _IHAVE, _IWANT = range(1, 7)


@dataclass
class GossipsubParams:
    """Mesh + scoring knobs (gossipsub v1.1 defaults, behaviour.rs config)."""

    d: int = 6            # target mesh degree
    d_lo: int = 4         # graft below this
    d_hi: int = 12        # prune above this
    d_lazy: int = 6       # IHAVE targets per heartbeat
    heartbeat_interval: float = 1.0
    mcache_len: int = 5       # history windows kept for IWANT
    mcache_gossip: int = 3    # windows advertised in IHAVE
    fanout_ttl: float = 60.0
    prune_backoff: float = 60.0
    max_ihave_ids: int = 5000     # ids per IHAVE message
    max_iwant_ids: int = 512      # ids requested per peer per heartbeat
    max_iwant_served: int = 512   # bodies served per peer per heartbeat
    max_peer_topics: int = 256    # per-peer subscription/score table bound

    # -- scoring (peer_score.rs at its load-bearing core) ------------------
    decay: float = 0.9                 # per-heartbeat counter decay
    time_in_mesh_quantum: float = 1.0  # seconds per P1 point
    time_in_mesh_cap: float = 300.0
    w_time_in_mesh: float = 0.01           # P1 weight
    first_delivery_cap: float = 100.0
    w_first_delivery: float = 1.0          # P2 weight
    mesh_delivery_threshold: float = 2.0   # P3: expected deliveries/heartbeat
    mesh_delivery_activation: float = 3.0  # seconds in mesh before P3 applies
    w_mesh_delivery_deficit: float = -1.0  # P3 weight (x deficit^2)
    w_invalid: float = -10.0               # P4 weight (x invalid^2)
    w_behaviour: float = -5.0              # behaviour penalty weight (x n^2)

    gossip_threshold: float = -10.0    # below: no IHAVE/IWANT exchange
    publish_threshold: float = -50.0   # below: not a publish/fanout target
    graylist_threshold: float = -80.0  # below: ignore entirely + disconnect


@dataclass
class _TopicScore:
    time_in_mesh: float = 0.0        # seconds (while in OUR mesh)
    graft_time: float = 0.0          # 0 = not in mesh
    first_deliveries: float = 0.0
    mesh_deliveries: float = 0.0
    invalid: float = 0.0


@dataclass
class _PeerState:
    topics: set = field(default_factory=set)        # their subscriptions
    scores: dict = field(default_factory=dict)      # topic -> _TopicScore
    behaviour_penalty: float = 0.0
    iwant_budget: int = 0                           # ids requested this round
    iwant_served: int = 0                           # bodies sent this round

    def topic(self, t: str, cap: int = 256) -> _TopicScore:
        """Per-topic score row, bounded: attacker-chosen topic strings can't
        grow the table (or score()'s iteration cost) without limit — beyond
        the cap, counters go to a throwaway row."""
        ts = self.scores.get(t)
        if ts is None:
            if len(self.scores) >= cap:
                return _TopicScore()
            ts = self.scores[t] = _TopicScore()
        return ts


class GossipsubTransport(SocketTransport):
    """SocketTransport with a gossipsub mesh replacing flood forwarding."""

    def __init__(self, spec, host: str = "127.0.0.1", port: int = 0,
                 rpc_timeout: float = 10.0,
                 params: GossipsubParams | None = None,
                 topics: list[str] | None = None,
                 run_heartbeat: bool = True,
                 peer_manager=None, discovery=None,
                 self_limit: bool = True,
                 rng: random.Random | None = None):
        self.params = params or GossipsubParams()
        self.rng = rng if rng is not None else random.Random()
        self._gs_lock = threading.RLock()
        self._subs: set[str] = set()
        self._mesh: dict[str, set[_Peer]] = {}
        self._fanout: dict[str, set[_Peer]] = {}
        self._fanout_last: dict[str, float] = {}
        self._backoff: dict[tuple[str, str], float] = {}  # (topic,addr)->until
        # decaying per-topic delivery rate: P3 mesh-delivery deficits only
        # apply on topics that actually carry traffic (an idle subnet must
        # not bleed honest mesh peers)
        self._topic_activity: dict[str, float] = {}
        # message cache: id -> (topic, wire body); windows of ids per heartbeat
        self._mcache: dict[bytes, tuple[str, bytes]] = {}
        self._mcache_windows: deque[list[bytes]] = deque([[]])
        self.gossip_rx = 0      # gossip frames received (incl. duplicates)
        self.iwant_served = 0
        self.ihave_sent = 0
        self._hb_stop = threading.Event()
        if topics is None:
            from .transport import Topic

            topics = [
                v for k, v in vars(Topic).items() if not k.startswith("_")
            ]
        self._subs.update(topics)
        # honest-node default: self-limit our own Req/Resp against the
        # peer's quotas so a full node never trips a remote rate limiter
        super().__init__(spec, host=host, port=port, rpc_timeout=rpc_timeout,
                         peer_manager=peer_manager, discovery=discovery,
                         self_limit=self_limit)
        self._hb_thread = None
        if run_heartbeat:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"gs-heartbeat-{self.local_addr}",
            )
            self._hb_thread.start()

    # -- scoring -----------------------------------------------------------

    def _ps(self, peer: _Peer) -> _PeerState:
        st = getattr(peer, "gs", None)
        if st is None:
            st = peer.gs = _PeerState()
        return st

    def _tscore(self, peer: _Peer, topic: str) -> _TopicScore:
        # _gs_lock guards the scores table: reader threads insert rows while
        # the heartbeat thread iterates them in score()
        with self._gs_lock:
            return self._ps(peer).topic(topic, self.params.max_peer_topics)

    def score(self, peer: _Peer) -> float:
        """Combined peer score: per-topic terms + behaviour + frame-level."""
        p = self.params
        st = self._ps(peer)
        total = peer.score  # wire-level events from the base transport
        now = time.monotonic()
        with self._gs_lock:
            score_rows = list(st.scores.items())
        for t, ts in score_rows:
            tim = ts.time_in_mesh
            if ts.graft_time:
                tim += now - ts.graft_time
            total += p.w_time_in_mesh * min(
                tim / p.time_in_mesh_quantum, p.time_in_mesh_cap
            )
            total += p.w_first_delivery * min(
                ts.first_deliveries, p.first_delivery_cap
            )
            if (
                ts.graft_time
                and now - ts.graft_time > p.mesh_delivery_activation
                and self._topic_activity.get(t, 0.0)
                >= p.mesh_delivery_threshold
            ):
                deficit = p.mesh_delivery_threshold - ts.mesh_deliveries
                if deficit > 0:
                    total += p.w_mesh_delivery_deficit * deficit * deficit
            total += p.w_invalid * ts.invalid * ts.invalid
        total += p.w_behaviour * st.behaviour_penalty * st.behaviour_penalty
        return total

    def peer_scores(self) -> dict[str, float]:
        with self._lock:
            peers = list(self._peers.items())
        return {a: round(self.score(p), 2) for a, p in peers}

    # -- subscriptions -----------------------------------------------------

    def subscribe(self, topic: str) -> None:
        with self._gs_lock:
            self._subs.add(topic)
        self._send_control_all([(_SUB, topic)])

    def unsubscribe(self, topic: str) -> None:
        now = time.monotonic()
        with self._gs_lock:
            self._subs.discard(topic)
            mesh = self._mesh.pop(topic, set())
        for peer in mesh:
            ts = self._tscore(peer, topic)
            if ts.graft_time:
                ts.time_in_mesh += now - ts.graft_time
                ts.graft_time = 0.0
            self._send_control(peer, [(_PRUNE, topic)])
        self._send_control_all([(_UNSUB, topic)])

    def mesh_peers(self, topic: str) -> list[str]:
        with self._gs_lock:
            return sorted(p.addr for p in self._mesh.get(topic, set()))

    # -- publish -----------------------------------------------------------

    def publish(self, from_peer: str, topic: str, message) -> None:
        msg_id, body = self._gossip_body(topic, message)
        self._mark_seen(msg_id)
        self.published += 1
        self._mcache_put(msg_id, topic, body)
        for peer in self._publish_targets(topic):
            self._safe_send(peer, _GOSSIP, body)

    def _publish_targets(self, topic: str) -> list[_Peer]:
        p = self.params
        with self._gs_lock:
            if topic in self._subs:
                mesh = self._mesh.setdefault(topic, set())
                targets = {pr for pr in mesh if pr.alive}
                if len(targets) < p.d:
                    # mesh still forming: top up from topic peers (flood-
                    # publish at its smallest — our own messages must go out)
                    now = time.monotonic()
                    for pr in self._topic_peers(topic):
                        if len(targets) >= p.d:
                            break
                        if (
                            pr not in targets
                            and self.score(pr) >= p.publish_threshold
                            and self._backoff.get((topic, pr.addr), 0) <= now
                        ):
                            targets.add(pr)
                return list(targets)
            # not subscribed: fanout (behaviour.rs fanout handling)
            fan = self._fanout.setdefault(topic, set())
            fan = {pr for pr in fan if pr.alive}
            while len(fan) < p.d:
                extra = [
                    pr for pr in self._topic_peers(topic)
                    if pr not in fan and self.score(pr) >= p.publish_threshold
                ]
                if not extra:
                    break
                fan.add(self.rng.choice(extra))
            self._fanout[topic] = fan
            self._fanout_last[topic] = time.monotonic()
            return list(fan)

    def _topic_peers(self, topic: str) -> list[_Peer]:
        with self._lock:
            peers = list(self._peers.values())
        return [
            p for p in peers if p.alive and topic in self._ps(p).topics
        ]

    # -- frame handling ----------------------------------------------------

    def _add_peer(self, sock, addr: str) -> _Peer:
        peer = super()._add_peer(sock, addr)
        with self._gs_lock:
            subs = sorted(self._subs)
        if subs:
            self._send_control(peer, [(_SUB, t) for t in subs])
        return peer

    def _drop_peer(self, peer: _Peer, why: str) -> None:
        with self._gs_lock:
            for mesh in self._mesh.values():
                mesh.discard(peer)
            for fan in self._fanout.values():
                fan.discard(peer)
        super()._drop_peer(peer, why)

    def _handle_frame(self, peer: _Peer, kind: int, body: bytes) -> None:
        if kind == _GOSSIP:
            self._handle_gossip(peer, body)
        elif kind == _CONTROL:
            self._handle_control(peer, body)
        else:
            super()._handle_frame(peer, kind, body)

    def _handle_gossip(self, peer: _Peer, body: bytes) -> None:
        p = self.params
        self.gossip_rx += 1
        if self.score(peer) < p.graylist_threshold:
            self._drop_peer(peer, "graylisted")
            return
        tn = body[0]
        topic = body[1 : 1 + tn].decode()
        msg_id = body[1 + tn : 21 + tn]
        payload = body[21 + tn :]
        st = self._ps(peer)
        ts = self._tscore(peer, topic)
        if not self._mark_seen(msg_id):
            # duplicate: counts toward the sender's mesh-delivery credit
            with self._gs_lock:
                if peer in self._mesh.get(topic, set()):
                    ts.mesh_deliveries += 1.0
            return
        ts.first_deliveries += 1.0
        ts.mesh_deliveries += 1.0
        with self._gs_lock:
            self._topic_activity[topic] = (
                self._topic_activity.get(topic, 0.0) + 1.0
            )
        self._mcache_put(msg_id, topic, body)
        # validate BEFORE forwarding (v1.1); invalid -> P4 penalty, no forward
        if self._service is not None:
            try:
                message = self.codec.decode_gossip(topic, payload)
                self._service.on_gossip(topic, message, peer.addr)
            except Exception:
                ts.invalid += 1.0
                # rejected messages must not be re-advertised (IHAVE) or
                # served (IWANT); they stay in _seen so they aren't reprocessed
                with self._gs_lock:
                    self._mcache.pop(msg_id, None)
                raise
        self.delivered += 1
        with self._gs_lock:
            targets = [
                pr for pr in self._mesh.get(topic, set())
                if pr is not peer and pr.alive
            ]
        for pr in targets:
            self._safe_send(pr, _GOSSIP, body)

    def _handle_control(self, peer: _Peer, body: bytes) -> None:
        p = self.params
        st = self._ps(peer)
        off = 0
        iwant_ids: list[bytes] = []
        out: list[tuple] = []
        while off < len(body):
            op = body[off]
            off += 1
            if op in (_SUB, _UNSUB, _GRAFT, _PRUNE, _IHAVE):
                if off >= len(body):
                    raise WireError("truncated control topic")
                tn = body[off]
                topic = body[off + 1 : off + 1 + tn].decode()
                if len(topic.encode()) != tn:
                    raise WireError("truncated control topic")
                off += 1 + tn
            if op == _SUB:
                if len(st.topics) < p.max_peer_topics:
                    st.topics.add(topic)
            elif op == _UNSUB:
                st.topics.discard(topic)
                with self._gs_lock:
                    self._mesh.get(topic, set()).discard(peer)
            elif op == _GRAFT:
                out.extend(self._on_graft(peer, topic))
            elif op == _PRUNE:
                (backoff,) = struct.unpack(">H", body[off : off + 2])
                off += 2
                with self._gs_lock:
                    self._mesh.get(topic, set()).discard(peer)
                    self._backoff[(topic, peer.addr)] = (
                        time.monotonic() + min(backoff, 3600)
                    )
                ts = self._tscore(peer, topic)
                if ts.graft_time:
                    ts.time_in_mesh += time.monotonic() - ts.graft_time
                    ts.graft_time = 0.0
            elif op == _IHAVE:
                (n,) = struct.unpack(">H", body[off : off + 2])
                off += 2
                ids = [body[off + 20 * i : off + 20 * (i + 1)] for i in range(n)]
                off += 20 * n
                if self.score(peer) >= p.gossip_threshold:
                    with self._lock:
                        want = [i for i in ids if i not in self._seen]
                    budget = max(0, p.max_iwant_ids - st.iwant_budget)
                    want = want[:budget]
                    st.iwant_budget += len(want)
                    iwant_ids.extend(want)
            elif op == _IWANT:
                (n,) = struct.unpack(">H", body[off : off + 2])
                off += 2
                ids = [body[off + 20 * i : off + 20 * (i + 1)] for i in range(n)]
                off += 20 * n
                if self.score(peer) >= p.gossip_threshold:
                    # bounded + deduped per heartbeat round: IWANT must not
                    # be a 20-bytes-in / full-body-out amplifier
                    served = getattr(peer, "gs_served_ids", None)
                    if served is None:
                        served = peer.gs_served_ids = set()
                    for mid in ids:
                        if st.iwant_served >= p.max_iwant_served:
                            break
                        if mid in served:
                            continue
                        with self._gs_lock:
                            entry = self._mcache.get(mid)
                        if entry is not None:
                            served.add(mid)
                            st.iwant_served += 1
                            self._safe_send(peer, _GOSSIP, entry[1])
                            self.iwant_served += 1
            else:
                raise WireError(f"unknown control op {op}")
        if iwant_ids:
            out.append((_IWANT, iwant_ids))
        if out:
            self._send_control(peer, out)

    def _on_graft(self, peer: _Peer, topic: str) -> list[tuple]:
        """GRAFT received: accept into our mesh or PRUNE back
        (behaviour.rs handle_graft)."""
        p = self.params
        st = self._ps(peer)
        now = time.monotonic()
        with self._gs_lock:
            if topic not in self._subs:
                return [(_PRUNE, topic)]
            if self._backoff.get((topic, peer.addr), 0) > now:
                # grafting while backed off is a protocol violation
                st.behaviour_penalty += 1.0
                return [(_PRUNE, topic)]
            if self.score(peer) < 0:
                return [(_PRUNE, topic)]
            mesh = self._mesh.setdefault(topic, set())
            if peer not in mesh and len(mesh) >= p.d_hi:
                return [(_PRUNE, topic)]
            mesh.add(peer)
        ts = self._tscore(peer, topic)
        if not ts.graft_time:
            ts.graft_time = now
        return []

    # -- control send helpers ----------------------------------------------

    def _encode_control(self, entries: list[tuple]) -> bytes:
        parts = []
        for entry in entries:
            op = entry[0]
            if op in (_SUB, _UNSUB, _GRAFT):
                tb = entry[1].encode()
                parts.append(bytes([op, len(tb)]) + tb)
            elif op == _PRUNE:
                tb = entry[1].encode()
                backoff = int(entry[2]) if len(entry) > 2 else int(
                    self.params.prune_backoff
                )
                parts.append(
                    bytes([op, len(tb)]) + tb + struct.pack(">H", backoff)
                )
            elif op == _IHAVE:
                tb = entry[1].encode()
                ids = entry[2][: self.params.max_ihave_ids]
                parts.append(
                    bytes([op, len(tb)]) + tb
                    + struct.pack(">H", len(ids)) + b"".join(ids)
                )
            elif op == _IWANT:
                ids = entry[1]
                parts.append(
                    bytes([op]) + struct.pack(">H", len(ids)) + b"".join(ids)
                )
        return b"".join(parts)

    def _send_control(self, peer: _Peer, entries: list[tuple]) -> None:
        if entries:
            self._safe_send(peer, _CONTROL, self._encode_control(entries))

    def _send_control_all(self, entries: list[tuple]) -> None:
        with self._lock:
            peers = list(self._peers.values())
        for peer in peers:
            self._send_control(peer, entries)

    def _safe_send(self, peer: _Peer, kind: int, body: bytes) -> None:
        try:
            peer.send_frame(kind, body)
        except OSError:
            self._drop_peer(peer, "send failed")

    # -- message cache -----------------------------------------------------

    def _mcache_put(self, msg_id: bytes, topic: str, body: bytes) -> None:
        with self._gs_lock:
            if msg_id not in self._mcache:
                self._mcache[msg_id] = (topic, body)
                self._mcache_windows[-1].append(msg_id)

    def _mcache_shift(self) -> None:
        with self._gs_lock:
            self._mcache_windows.append([])
            while len(self._mcache_windows) > self.params.mcache_len:
                for mid in self._mcache_windows.popleft():
                    self._mcache.pop(mid, None)

    def _mcache_gossip_ids(self, topic: str) -> list[bytes]:
        with self._gs_lock:
            windows = list(self._mcache_windows)[-self.params.mcache_gossip :]
            return [
                mid
                for w in windows
                for mid in w
                if self._mcache.get(mid, (None,))[0] == topic
            ]

    # -- heartbeat ---------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.params.heartbeat_interval):
            try:
                self.heartbeat()
            except Exception as e:  # noqa: BLE001 — keep the mesh alive
                log.warn("Heartbeat failed", error=str(e))

    def heartbeat(self) -> None:
        """One mesh-maintenance round (behaviour.rs ``heartbeat``)."""
        p = self.params
        now = time.monotonic()
        self.decay_scores()
        with self._lock:
            peers = list(self._peers.values())
        # counter decay + iwant budget refill + graylist enforcement
        for peer in peers:
            st = self._ps(peer)
            st.behaviour_penalty *= p.decay
            st.iwant_budget = 0
            st.iwant_served = 0
            if getattr(peer, "gs_served_ids", None):
                peer.gs_served_ids.clear()
            for ts in st.scores.values():
                ts.first_deliveries *= p.decay
                ts.mesh_deliveries *= p.decay
                ts.invalid *= p.decay
            if self.score(peer) < p.graylist_threshold:
                self._drop_peer(peer, "graylisted (score)")
        with self._gs_lock:
            self._backoff = {
                k: v for k, v in self._backoff.items() if v > now
            }
            self._topic_activity = {
                t: v * p.decay
                for t, v in self._topic_activity.items()
                if v * p.decay > 0.01
            }
            subs = sorted(self._subs)
        to_send: dict[_Peer, list[tuple]] = {}
        for topic in subs:
            self._maintain_mesh(topic, now, to_send)
            self._emit_gossip(topic, to_send)
        # fanout expiry + degree top-up
        with self._gs_lock:
            for topic in list(self._fanout):
                if now - self._fanout_last.get(topic, 0) > p.fanout_ttl:
                    del self._fanout[topic]
                    self._fanout_last.pop(topic, None)
                else:
                    self._fanout[topic] = {
                        pr for pr in self._fanout[topic] if pr.alive
                    }
        for peer, entries in to_send.items():
            self._send_control(peer, entries)
        self._mcache_shift()

    def _maintain_mesh(
        self, topic: str, now: float, to_send: dict
    ) -> None:
        p = self.params
        with self._gs_lock:
            mesh = self._mesh.setdefault(topic, set())
            # evict dead + negative-score peers
            for peer in list(mesh):
                if not peer.alive or self.score(peer) < 0:
                    mesh.discard(peer)
                    self._backoff[(topic, peer.addr)] = (
                        now + p.prune_backoff
                    )
                    if peer.alive:
                        to_send.setdefault(peer, []).append((_PRUNE, topic))
                    ts = self._tscore(peer, topic)
                    if ts.graft_time:
                        ts.time_in_mesh += now - ts.graft_time
                        ts.graft_time = 0.0
            if len(mesh) < p.d_lo:
                candidates = [
                    pr for pr in self._topic_peers(topic)
                    if pr not in mesh
                    and self.score(pr) >= 0
                    and self._backoff.get((topic, pr.addr), 0) <= now
                ]
                self.rng.shuffle(candidates)
                for pr in candidates[: p.d - len(mesh)]:
                    mesh.add(pr)
                    ts = self._tscore(pr, topic)
                    if not ts.graft_time:
                        ts.graft_time = now
                    to_send.setdefault(pr, []).append((_GRAFT, topic))
            elif len(mesh) > p.d_hi:
                # keep the best-scoring D, prune the rest (v1.1 keeps score)
                ranked = sorted(mesh, key=self.score, reverse=True)
                for pr in ranked[p.d :]:
                    mesh.discard(pr)
                    self._backoff[(topic, pr.addr)] = now + p.prune_backoff
                    to_send.setdefault(pr, []).append((_PRUNE, topic))
                    ts = self._tscore(pr, topic)
                    if ts.graft_time:
                        ts.time_in_mesh += now - ts.graft_time
                        ts.graft_time = 0.0

    def _emit_gossip(self, topic: str, to_send: dict) -> None:
        p = self.params
        ids = self._mcache_gossip_ids(topic)
        if not ids:
            return
        with self._gs_lock:
            mesh = self._mesh.get(topic, set())
        targets = [
            pr for pr in self._topic_peers(topic)
            if pr not in mesh and self.score(pr) >= p.gossip_threshold
        ]
        self.rng.shuffle(targets)
        for pr in targets[: p.d_lazy]:
            to_send.setdefault(pr, []).append(
                (_IHAVE, topic, ids[: p.max_ihave_ids])
            )
            # heartbeat thread and the publish path both bump this counter
            with self._gs_lock:
                self.ihave_sent += 1

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None and self._hb_thread.is_alive():
            self._hb_thread.join(timeout=5.0)
        super().stop()
