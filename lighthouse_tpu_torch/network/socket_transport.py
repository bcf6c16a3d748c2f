"""Real-socket transport: TCP gossip mesh + Req/Resp, UDP discovery.

The internet-facing twin of the reference's libp2p stack
(``lighthouse_network/src/service/mod.rs``): a TCP listener per node carries
both the gossip mesh and Req/Resp streams; peers are found via the UDP boot
node (``boot_node/``, the discv5 seam). Gossip propagation is flood-with-dedup:
every message carries a 20-byte id (hash of topic+payload, the gossipsub
message-id function); peers forward each id at most once, so messages reach
the whole connected component without a routing table. Malformed frames
disconnect the peer (the peer-scoring hook).

Frame layout (length-prefixed, one TCP stream per peer pair):

    u32 len | u8 kind | body
    kind 0 GOSSIP : u8 topic_len | topic | 20B msg_id | payload
    kind 1 REQ    : u64 req_id | u8 method_len | method | payload
    kind 2 RESP   : u64 req_id | payload
    kind 3 ERROR  : u64 req_id | utf-8 message
    kind 4 HELLO  : u8 addr_len | addr      (peer's canonical listen address)

The frames, codec and scoring are the reference package's, byte for byte,
so a port node and a ``lighthouse_tpu`` node talk over one connection.
Peers are found through a UDP boot node or, with ``discovery=`` (a
``network.discovery.DiscoveryService``), through ENR lookups.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading
import time
from collections import OrderedDict

from ..loadshed.adaptive import RttEstimator, SelfLimiter
from ..loadshed.priorities import method_priority, should_shed_method
from ..utils.logging import get_logger
from ..utils.metrics import RPC_EXPIRED, RPC_RTT, SHED_REQUESTS
from .codec import MessageCodec, WireError
from .transport import Transport


def _shutdown_close(sock: socket.socket) -> None:
    """shutdown(SHUT_RDWR) before close: on Linux, close() alone does NOT
    tear down a connection whose fd another thread is blocked in recv() on —
    the in-flight syscall pins the open file description, no FIN is sent,
    and BOTH sides' read loops hang forever (the peer never learns the
    connection died). shutdown() interrupts the blocked recv immediately."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass

log = get_logger("socket_transport")

_GOSSIP, _REQ, _RESP, _ERROR, _HELLO = range(5)
_MAX_FRAME = 1 << 28
_SEEN_CAP = 4096  # gossipsub duplicate-cache size


# Peer-score weights (the gossipsub peer_score.rs shape at its smallest):
# negative events push a peer toward the ban threshold; useful deliveries
# claw back slowly. Scores decay toward zero so old sins expire.
SCORE_MALFORMED = -50.0     # undecodable frame / codec error
SCORE_HANDLER_ERROR = -10.0  # message that made the service raise
SCORE_DUPLICATE = -0.5       # redundant gossip (mesh noise)
SCORE_DELIVERY = 1.0         # first delivery of a message
SCORE_RATE_LIMITED = -20.0   # request refused by the rate limiter
SCORE_BAN_THRESHOLD = -100.0
SCORE_DECAY = 0.9            # per decay interval


class _Peer:
    def __init__(self, sock: socket.socket, addr: str):
        self.sock = sock
        self.addr = addr  # canonical "host:port" listen address
        self.send_lock = threading.Lock()
        self.alive = True
        self.score = 0.0
        # monotonic stamp of the recv() that completed the frame currently
        # being handled: the server-side Req/Resp deadline runs from it
        self.frame_recv_t = time.monotonic()

    def adjust_score(self, delta: float) -> float:
        self.score = max(-1000.0, min(100.0, self.score + delta))
        return self.score

    def send_frame(self, kind: int, body: bytes) -> None:
        frame = struct.pack(">IB", len(body) + 1, kind) + body
        with self.send_lock:
            # the send lock exists precisely to serialize whole frames onto
            # the socket; it guards nothing else and nothing is acquired
            # under it, so holding it across the write cannot deadlock
            self.sock.sendall(frame)  # lint: allow(blocking-under-lock)


class SocketTransport(Transport):
    """One node's network endpoint. Satisfies the Transport seam the
    BeaconNodeService/Router/SyncManager stack is written against, so the
    same node code runs over loopback (tests) or real sockets."""

    def __init__(self, spec, host: str = "127.0.0.1", port: int = 0,
                 rpc_timeout: float = 10.0, peer_manager=None, discovery=None,
                 self_limit: bool = False):
        from .peer_manager import PeerManager

        self.codec = MessageCodec(spec)
        # rpc_timeout is the CEILING: per-peer adaptive timeouts (EWMA RTT +
        # variance, RFC 6298 shape) take over once round-trips are observed
        self.rpc_timeout = rpc_timeout
        self._rtt: dict[str, RttEstimator] = {}
        self._rtt_lock = threading.Lock()
        # server-side Req/Resp deadline: a request that waited in the read
        # pipeline longer than any well-behaved client waits is answered
        # with an error instead of doing the (now pointless) work
        self.server_deadline_s = rpc_timeout
        # optional loadshed.LoadMonitor: when attached, lowest-priority
        # Req/Resp methods are shed first under BUSY/SATURATED
        self.load_monitor = None
        # client-side self-limiting (honest-node mode): pace our own
        # requests under the peer's published quotas so we never trip a
        # remote rate limiter and never take its -20 score penalty
        self.self_limiter = SelfLimiter() if self_limit else None
        self._service = None
        # durable peer records + ban lifecycle (peer_manager/mod.rs parity):
        # scores and bans survive the TCP connection, so reconnects by a
        # banned peer are refused until the ban expires
        self.peer_manager = peer_manager or PeerManager()
        self.discovery = discovery
        # per-(peer, method) token buckets (rpc/rate_limiter.rs): refused
        # requests get an RPC error + a score penalty; sustained flooding
        # crosses the ban threshold and drops the peer
        from .rate_limiter import RateLimiter

        self.rate_limiter = RateLimiter()
        self._peers: dict[str, _Peer] = {}  # canonical addr -> peer
        self._lock = threading.Lock()
        self._seen: OrderedDict[bytes, None] = OrderedDict()
        self.published = 0  # gossip messages originated here
        self.delivered = 0  # gossip messages fully processed here
        self._req_id = 0
        self._pending: dict[int, tuple[threading.Event, list]] = {}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.local_addr = f"{host}:{self._listener.getsockname()[1]}"
        if self.discovery is not None:
            self.discovery.peer_manager = self.peer_manager
            self.discovery.update_tcp_port(self._listener.getsockname()[1])
        self._stopped = False
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"net-accept-{self.local_addr}",
        )
        self._accept_thread.start()

    # -- Transport seam ----------------------------------------------------

    def register(self, peer_id: str, service) -> None:
        self._service = service

    def peers(self, exclude: str | None = None) -> list[str]:
        with self._lock:
            return [a for a in self._peers if a != exclude]

    def peer_scores(self) -> dict[str, float]:
        with self._lock:
            return {a: round(p.score, 2) for a, p in self._peers.items()}

    def decay_scores(self) -> None:
        """Periodic score decay toward zero (peer_score.rs decay interval)."""
        with self._lock:
            for p in self._peers.values():
                p.score *= SCORE_DECAY
        self.peer_manager.decay_scores()
        # ride the same periodic tick to bound the rate-limiter bucket map
        self.rate_limiter.maybe_prune()

    def report_peer(self, addr: str, delta: float) -> None:
        """Application-level score report (sync demotions etc. — the
        reference's PeerAction reporting into the peer manager)."""
        with self._lock:
            peer = self._peers.get(addr)
        if peer is not None and self._score(peer, delta):
            self._drop_peer(peer, "banned (reported)")

    def _score(self, peer: _Peer, delta: float) -> bool:
        """Adjust both the connection-local score and the durable peer-DB
        record; True when the peer has crossed the ban threshold."""
        peer.adjust_score(delta)
        self.peer_manager.report(peer.addr, delta)
        return self.peer_manager.is_banned(addr=peer.addr)

    def _gossip_body(self, topic: str, message) -> tuple[bytes, bytes]:
        """Encode a gossip message into (msg_id, wire body). The single
        definition of message identity: sha256(topic || payload)[:20]."""
        payload = self.codec.encode_gossip(topic, message)
        msg_id = hashlib.sha256(topic.encode() + payload).digest()[:20]
        tb = topic.encode()
        return msg_id, bytes([len(tb)]) + tb + msg_id + payload

    def publish(self, from_peer: str, topic: str, message) -> None:
        msg_id, body = self._gossip_body(topic, message)
        self._mark_seen(msg_id)
        self.published += 1
        self._flood(body, except_addr=None)

    def peer_timeout(self, addr: str) -> float:
        """Current request timeout for ``addr``: adaptive (EWMA RTT +
        variance) once samples exist, the ``rpc_timeout`` ceiling before."""
        with self._rtt_lock:
            est = self._rtt.get(addr)
            if est is None or not est.samples:
                return self.rpc_timeout
            return est.timeout()

    def _rtt_for_locked(self, addr: str) -> RttEstimator:
        est = self._rtt.get(addr)
        if est is None:
            est = self._rtt[addr] = RttEstimator(
                max_timeout=self.rpc_timeout
            )
        return est

    def _self_limit(self, to_peer: str, method: str, payload) -> None:
        """Honest-client pacing: wait out our own shadow of the peer's
        quota instead of tripping its limiter (and its score penalty)."""
        if self.self_limiter is None:
            return
        from .rate_limiter import request_cost

        cost = request_cost(method, payload)
        wait = self.self_limiter.throttle(to_peer, method, cost)
        if wait <= 0:
            return
        if wait > self.rpc_timeout:
            raise ConnectionError(
                f"self-limited: {method} to {to_peer} needs {wait:.1f}s "
                "of quota refill"
            )
        time.sleep(wait)
        # tokens have refilled; spend them (a second refusal only happens
        # under concurrent senders — treat it as paced enough and proceed)
        self.self_limiter.throttle(to_peer, method, cost)

    def request(self, from_peer: str, to_peer: str, method: str, payload):
        peer = self._peers.get(to_peer)
        if peer is None or not peer.alive:
            raise ConnectionError(f"not connected to {to_peer}")
        self._self_limit(to_peer, method, payload)
        with self._lock:
            self._req_id += 1
            rid = self._req_id
            ev, box = threading.Event(), []
            self._pending[rid] = (ev, box)
        body = (
            struct.pack(">Q", rid)
            + bytes([len(method)])
            + method.encode()
            + self.codec.encode_request(method, payload)
        )
        timeout = self.peer_timeout(to_peer)
        t0 = time.monotonic()
        try:
            peer.send_frame(_REQ, body)
            if not ev.wait(timeout):
                with self._rtt_lock:
                    self._rtt_for_locked(to_peer).on_timeout()
                raise ConnectionError(
                    f"rpc {method} to {to_peer} timed out after {timeout:.2f}s"
                )
        finally:
            with self._lock:
                self._pending.pop(rid, None)
        # any completed round trip (including an ERROR reply) is an RTT
        # sample for the adaptive timeout
        rtt = time.monotonic() - t0
        with self._rtt_lock:
            self._rtt_for_locked(to_peer).observe(rtt)
        RPC_RTT.observe(rtt)
        kind, data = box[0]
        if kind == _ERROR:
            raise ConnectionError(data.decode(errors="replace"))
        return self.codec.decode_response(method, data)

    # -- dialing / discovery ----------------------------------------------

    def dial(self, addr: str) -> bool:
        """Connect to ``host:port``; HELLO exchanges canonical addresses.
        Banned peers are refused (reconnect suppression)."""
        if addr == self.local_addr or addr in self._peers:
            return False
        if self.peer_manager.is_banned(addr=addr):
            return False
        host, port = addr.rsplit(":", 1)
        try:
            s = socket.create_connection((host, int(port)), timeout=5)
            # the connect timeout must not linger: a timed-out socket raises
            # on recv after 5 IDLE seconds, silently killing quiet peers
            s.settimeout(None)
        except OSError as e:
            log.warn("Dial failed", addr=addr, error=str(e))
            return False
        self._add_peer(s, addr)
        return True

    def discover(self, boot_addr: str, dial: bool = True) -> list[str]:
        """Announce to the UDP boot node and dial the peers it returns."""
        from .boot_node import client_announce

        found = client_announce(boot_addr, self.local_addr)
        if dial:
            for addr in found:
                self.dial(addr)
        return found

    def discover_enr(self, dial: bool = True) -> list[str]:
        """Run an iterative discv5-style lookup on the attached
        DiscoveryService and dial the discovered TCP listeners (banned
        peers filtered by dial())."""
        if self.discovery is None:
            return []
        self.discovery.lookup()
        found = [a for a in self.discovery.known_tcp_addrs() if a != self.local_addr]
        if dial:
            for addr in found:
                self.dial(addr)
        return found

    def stop(self) -> None:
        self._stopped = True
        # shutdown wakes the accept loop at once (close alone leaves it
        # blocked in accept until its join times out)
        _shutdown_close(self._listener)
        with self._lock:
            peers = list(self._peers.values())
            self._peers.clear()
            readers = list(self._threads)
            self._threads.clear()
        for p in peers:
            _shutdown_close(p.sock)
        # closing the listener/sockets unblocks both loops; the joins are
        # bounded so a half-closed socket can never wedge shutdown
        self._accept_thread.join(timeout=2.0)
        for th in readers:
            th.join(timeout=2.0)
        if self.discovery is not None:
            # the attached discovery endpoint ends with its transport
            self.discovery.stop()

    # -- internals ---------------------------------------------------------

    def _add_peer(self, sock: socket.socket, addr: str) -> _Peer:
        peer = _Peer(sock, addr)
        self.peer_manager.on_connect(addr)
        with self._lock:
            old = self._peers.get(addr)
            self._peers[addr] = peer
        if old is not None:
            _shutdown_close(old.sock)
        peer.send_frame(
            _HELLO, bytes([len(self.local_addr)]) + self.local_addr.encode()
        )
        th = threading.Thread(
            target=self._read_loop, args=(peer,), daemon=True,
            name=f"net-read-{addr}",
        )
        th.start()
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
        return peer

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, (h, p) = self._listener.accept()
            except OSError:
                return
            # canonical addr arrives in the peer's HELLO; key by socket addr
            # meanwhile so duplicate dials don't race
            self._add_peer(sock, f"{h}:{p}")

    def _drop_peer(self, peer: _Peer, why: str) -> None:
        peer.alive = False
        with self._lock:
            if self._peers.get(peer.addr) is peer:
                del self._peers[peer.addr]
        self.peer_manager.on_disconnect(peer.addr)
        _shutdown_close(peer.sock)
        if why != "closed":
            log.warn("Peer dropped", addr=peer.addr, reason=why)
        if self.discovery is not None and why.startswith("banned"):
            # a banned peer's record leaves the routing table too, so
            # lookups stop advertising it while the ban lasts
            for enr in self.discovery.table.all_records():
                if enr.tcp_addr == peer.addr:
                    self.discovery.table.remove(enr.node_id)

    def _mark_seen(self, msg_id: bytes) -> bool:
        """True if the id is new (and records it)."""
        with self._lock:
            if msg_id in self._seen:
                return False
            self._seen[msg_id] = None
            while len(self._seen) > _SEEN_CAP:
                self._seen.popitem(last=False)
            return True

    def _flood(self, gossip_body: bytes, except_addr: str | None) -> None:
        with self._lock:
            targets = [
                p for a, p in self._peers.items() if a != except_addr
            ]
        for p in targets:
            try:
                p.send_frame(_GOSSIP, gossip_body)
            except OSError:
                self._drop_peer(p, "send failed")

    def _read_loop(self, peer: _Peer) -> None:
        buf = b""
        sock = peer.sock
        while peer.alive:
            try:
                chunk = sock.recv(1 << 16)
            except OSError:
                chunk = b""
            if not chunk:
                self._drop_peer(peer, "closed")
                return
            buf += chunk
            peer.frame_recv_t = time.monotonic()
            while len(buf) >= 4:
                (n,) = struct.unpack(">I", buf[:4])
                if n > _MAX_FRAME or n < 1:
                    self._drop_peer(peer, "bad frame length")
                    return
                if len(buf) < 4 + n:
                    break
                kind, body = buf[4], buf[5 : 4 + n]
                buf = buf[4 + n :]
                try:
                    self._handle_frame(peer, kind, body)
                except WireError as e:
                    if self._score(peer, SCORE_MALFORMED):
                        self._drop_peer(peer, f"banned (codec: {e})")
                        return
                    log.warn("Malformed frame", addr=peer.addr, error=str(e),
                             score=round(peer.score, 1))
                except Exception as e:  # noqa: BLE001 — protocol boundary
                    if self._score(peer, SCORE_HANDLER_ERROR):
                        self._drop_peer(peer, f"banned (handler: {e})")
                        return
                    log.warn("Peer message failed", addr=peer.addr,
                             error=str(e), score=round(peer.score, 1))

    def _handle_frame(self, peer: _Peer, kind: int, body: bytes) -> None:
        if kind == _HELLO:
            n = body[0]
            canonical = body[1 : 1 + n].decode()
            stale = None
            with self._lock:
                if self._peers.get(peer.addr) is peer:
                    del self._peers[peer.addr]
                peer.addr = canonical
                existing = self._peers.get(canonical)
                if existing is not None and existing is not peer:
                    # simultaneous dial: keep exactly one connection per pair,
                    # deterministically (smaller address keeps its outbound)
                    keep_new = self.local_addr < canonical
                    stale = existing if keep_new else peer
                    self._peers[canonical] = peer if keep_new else existing
                else:
                    self._peers[canonical] = peer
            if stale is not None:
                stale.alive = False
                _shutdown_close(stale.sock)
            # reconnect suppression: a banned peer announcing its canonical
            # address through a fresh inbound connection is cut here
            if self.peer_manager.is_banned(addr=canonical):
                self._drop_peer(peer, "banned (reconnect refused)")
                return
            self.peer_manager.on_connect(canonical)
        elif kind == _GOSSIP:
            tn = body[0]
            topic = body[1 : 1 + tn].decode()
            msg_id = body[1 + tn : 21 + tn]
            payload = body[21 + tn :]
            if not self._mark_seen(msg_id):
                peer.adjust_score(SCORE_DUPLICATE)
                return
            peer.adjust_score(SCORE_DELIVERY)
            # forward FIRST (gossip latency), then process locally
            self._flood(body, except_addr=peer.addr)
            if self._service is not None:
                message = self.codec.decode_gossip(topic, payload)
                self._service.on_gossip(topic, message, peer.addr)
            self.delivered += 1
        elif kind == _REQ:
            from .rate_limiter import request_cost

            (rid,) = struct.unpack(">Q", body[:8])
            mn = body[8]
            method = body[9 : 9 + mn].decode()
            payload = self.codec.decode_request(method, body[9 + mn :])
            cost = request_cost(method, payload)
            # serve-loop prune keeps the per-(peer, method) bucket map
            # bounded over long peer churn (time-gated, usually a no-op)
            self.rate_limiter.maybe_prune()
            if not self.rate_limiter.allow(peer.addr, method, cost):
                peer.send_frame(
                    _ERROR, struct.pack(">Q", rid) + b"rate limited"
                )
                if self._score(peer, SCORE_RATE_LIMITED):
                    self._drop_peer(peer, "banned (rpc flood)")
                return
            # admission-level shedding: lowest-priority methods are refused
            # first when the node is BUSY/SATURATED. No score penalty — the
            # peer did nothing wrong; OUR load is the problem.
            lvl = (self.load_monitor.level()
                   if self.load_monitor is not None else None)
            if lvl is not None and should_shed_method(method, lvl):
                SHED_REQUESTS.inc(
                    surface="req_resp",
                    priority=str(method_priority(method)),
                )
                peer.send_frame(
                    _ERROR,
                    struct.pack(">Q", rid) + b"overloaded: retry later",
                )
                return
            # server-side deadline: a request that waited in the read
            # pipeline past the client's timeout gets an error, not work —
            # the response would be discarded anyway
            if (time.monotonic() - peer.frame_recv_t
                    > self.server_deadline_s):
                RPC_EXPIRED.inc(method=method)
                peer.send_frame(
                    _ERROR, struct.pack(">Q", rid) + b"expired"
                )
                return
            try:
                out = self._service.on_rpc(method, payload, peer.addr)
                resp = self.codec.encode_response(method, out)
                peer.send_frame(_RESP, struct.pack(">Q", rid) + resp)
            except Exception as e:  # noqa: BLE001 — report to the requester
                peer.send_frame(
                    _ERROR, struct.pack(">Q", rid) + str(e).encode()
                )
        elif kind in (_RESP, _ERROR):
            (rid,) = struct.unpack(">Q", body[:8])
            with self._lock:
                entry = self._pending.get(rid)
            if entry is not None:
                ev, box = entry
                box.append((kind, body[8:]))
                ev.set()
        else:
            raise WireError(f"unknown frame kind {kind}")
