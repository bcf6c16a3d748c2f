"""discv5-style node discovery: signed ENRs, XOR routing table, iterative
FINDNODE lookup over UDP — the port's copy of ``lighthouse_tpu/network/discovery.py``.

Lighthouse's discovery stack (``lighthouse_network/src/discovery/mod.rs:1-1338``,
``discovery/enr.rs:1-399``) in the reference's form; the wire bytes are the
reference's, so port and reference nodes share one routing table:

* **ENR** — a signed, sequenced node record carrying (node_id, fork_digest,
  ip, tcp/udp ports). Lighthouse signs with secp256k1 ("v4" identity
  scheme); this stack signs with BLS12-381 (the curve the framework already
  implements end to end) — identity scheme ``"bls"``; records are
  self-certifying: any packet carries the sender's ENR and receivers verify
  the signature before admitting it to the table.
* **Routing table** — Kademlia buckets by XOR log-distance over the 32-byte
  node id, k=16 per bucket, LRU within a bucket (discv5 table semantics).
* **Wire protocol** (UDP datagrams):
      kind 1 PING      : empty                      (liveness + ENR exchange)
      kind 2 PONG      : empty
      kind 3 FINDNODE  : u8 cookie_len | cookie | u8 n | u16 log-distances
      kind 4 NODES     : u16 count | ENR*           (response)
      kind 5 WHOAREYOU : 16-byte cookie             (source-address challenge)
  every packet = u16 enr_len | sender ENR | u8 kind | body — contact alone
  teaches a verified record.
* **Stateless source-address validation** (discv5 WHOAREYOU): a FINDNODE
  whose cookie does not validate is answered with a tiny fixed-size
  WHOAREYOU challenge — BEFORE any ENR signature verification — carrying
  an HMAC cookie bound to (source ip, port, time window) under a local
  secret; no per-peer state is kept. The requester retries with the cookie
  echoed. A spoofed-source FINDNODE therefore costs the server one HMAC and
  a reply no larger than the request (no ~10x NODES amplification toward
  the victim, no attacker-triggered BLS signature verification), and the
  cookie only ever reaches the true owner of the source address. NODES
  responses are ingested solicited-only (a forged NODES from a node we
  asked nothing of is dropped before any signature work). Unsolicited
  PING/PONG stay one bounded ENR verify per datagram — the
  eviction-liveness protocol needs them — until the real discv5 session
  handshake lands behind the transport seam (ROADMAP).
* **Iterative lookup** — query the α closest known nodes for the target's
  distance, admit returned records, repeat while strictly closer nodes
  appear (bounded rounds). This is how a node bootstrapped from ONE boot
  node transitively discovers the rest of the network.

Fork-digest filtering mirrors Lighthouse's `eth2` ENR field: lookups and
table admission drop records whose fork digest differs from ours.

Signatures: a record is signed with the port's pure-Python ``oracle`` and
verified with the native C++ backend (``native/``). Unlike the reference,
which falls back to the oracle on any exception, a ``DiscoveryService``
loads the native backend when it is built and raises if it cannot: a
per-packet oracle verify (~1 s) would stall the serve loop. A malformed
record or signature is a False verdict, never an exception.
"""

from __future__ import annotations

import secrets
import socket
import struct
import threading
import time

from ..utils.logging import get_logger

log = get_logger("discovery")

K_BUCKET = 16          # discv5 bucket size
ALPHA = 3              # lookup concurrency
MAX_LOOKUP_ROUNDS = 8
_PING, _PONG, _FINDNODE, _NODES, _WHOAREYOU = 1, 2, 3, 4, 5
_MAX_NODES_PER_RESPONSE = 16
_COOKIE_LEN = 16       # WHOAREYOU cookie bytes (truncated HMAC-SHA256)
_COOKIE_WINDOW_S = 60  # cookie validity window (current + previous accepted)
_COOKIE_CACHE_MAX = 1024  # client-side cached cookies (expired pruned first)
# Liveness-checked eviction (discv5 pending-node semantics): before a full
# bucket evicts its oldest record, the service PINGs it and only replaces it
# if no packet arrives within this window. Unconditional LRU eviction lets
# an attacker flush honest long-lived peers with a stream of fresh ENRs
# (eclipse pressure); a live oldest node always survives.
LIVENESS_TIMEOUT_S = 1.0
_SERVE_TICK_S = 0.25   # serve-loop wakeup for pending-eviction expiry


def _native():
    """The native backend (built at first use); raises if it cannot load."""
    from ..native import NativeBls

    return NativeBls()


def _sign_payload(sk_scalar: int, content: bytes) -> bytes:
    import hashlib

    from ..oracle import ciphersuite as cs
    from ..oracle import curves as oc

    return oc.g2_compress(cs.sign(sk_scalar, hashlib.sha256(content).digest()))


def _verify_payload(pubkey: bytes, content: bytes, sig: bytes) -> bool:
    """The record signature's verdict through the native backend, whatever
    backend the chain runs: it runs per received packet on the discovery
    thread. Bytes of the wrong length are a False verdict; a backend that
    cannot load raises."""
    import hashlib

    msg = hashlib.sha256(content).digest()
    try:
        return bool(_native().verify(pubkey, msg, sig))
    except ValueError:
        return False


class ENR:
    """Ethereum Node Record, identity scheme "bls": content = (seq,
    fork_digest, ip, tcp, udp, pubkey); node_id = sha256(pubkey)."""

    __slots__ = ("seq", "fork_digest", "ip", "tcp", "udp", "pubkey", "sig")

    def __init__(self, seq, fork_digest, ip, tcp, udp, pubkey, sig=b""):
        self.seq = seq
        self.fork_digest = fork_digest
        self.ip = ip
        self.tcp = tcp
        self.udp = udp
        self.pubkey = pubkey
        self.sig = sig

    @property
    def node_id(self) -> bytes:
        import hashlib

        return hashlib.sha256(self.pubkey).digest()

    @property
    def tcp_addr(self) -> str:
        return f"{self.ip}:{self.tcp}"

    @property
    def udp_addr(self) -> tuple:
        return (self.ip, self.udp)

    def _content(self) -> bytes:
        ip_b = self.ip.encode()
        return (
            struct.pack(">Q4sB", self.seq, self.fork_digest, len(ip_b))
            + ip_b
            + struct.pack(">HH", self.tcp, self.udp)
            + self.pubkey
        )

    def encode(self) -> bytes:
        body = self._content() + self.sig
        return struct.pack(">H", len(body)) + body

    @classmethod
    def decode(cls, data: bytes, off: int = 0):
        """Returns (enr, next_offset); raises ValueError on malformed data."""
        if len(data) < off + 2:
            raise ValueError("short ENR length")
        (n,) = struct.unpack_from(">H", data, off)
        body = data[off + 2 : off + 2 + n]
        if len(body) != n:
            raise ValueError("short ENR body")
        seq, fork_digest, ip_len = struct.unpack_from(">Q4sB", body, 0)
        p = 13
        ip = body[p : p + ip_len].decode()
        p += ip_len
        tcp, udp = struct.unpack_from(">HH", body, p)
        p += 4
        pubkey = body[p : p + 48]
        sig = body[p + 48 :]
        if len(pubkey) != 48 or len(sig) != 96:
            raise ValueError("bad ENR key/sig lengths")
        return cls(seq, fork_digest, ip, tcp, udp, pubkey, sig), off + 2 + n

    def sign(self, sk_scalar: int) -> "ENR":
        self.sig = _sign_payload(sk_scalar, self._content())
        return self

    def verify(self) -> bool:
        return _verify_payload(self.pubkey, self._content(), self.sig)


def log_distance(a: bytes, b: bytes) -> int:
    """discv5 log2-distance: bit length of a XOR b (0 when equal)."""
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return x.bit_length()


class RoutingTable:
    """256 XOR-distance buckets of K_BUCKET records each, LRU per bucket."""

    def __init__(self, local_id: bytes):
        self.local_id = local_id
        self._buckets: dict[int, list[ENR]] = {}
        self._lock = threading.Lock()

    def admit(self, enr: ENR, on_full=None) -> bool:
        """Admit/refresh a record. On a full bucket: with ``on_full`` set
        (the service's liveness path) the candidate is handed to
        ``on_full(oldest, candidate)`` and NOT admitted yet — the caller
        pings the oldest and either keeps it (drop candidate) or calls
        ``replace``; without it, legacy LRU eviction applies (direct table
        users/tests). ``on_full`` runs under the table lock and must not
        call back into the table."""
        nid = enr.node_id
        if nid == self.local_id:
            return False
        d = log_distance(self.local_id, nid)
        with self._lock:
            bucket = self._buckets.setdefault(d, [])
            for i, existing in enumerate(bucket):
                if existing.node_id == nid:
                    if enr.seq >= existing.seq:
                        bucket.pop(i)
                        bucket.append(enr)
                    return True
            if len(bucket) >= K_BUCKET:
                if on_full is not None:
                    on_full(bucket[0], enr)
                    return False
                bucket.pop(0)  # LRU eviction (head is oldest)
            bucket.append(enr)
            return True

    def touch(self, node_id: bytes) -> None:
        """Refresh a record to most-recently-seen (liveness proof)."""
        d = log_distance(self.local_id, node_id)
        with self._lock:
            bucket = self._buckets.get(d, [])
            for i, e in enumerate(bucket):
                if e.node_id == node_id:
                    bucket.append(bucket.pop(i))
                    return

    def replace(self, old_id: bytes, new_enr: ENR) -> bool:
        """Swap a liveness-check failure for the pending candidate (same
        bucket by construction; a vanished oldest still admits the new)."""
        d = log_distance(self.local_id, old_id)
        with self._lock:
            bucket = self._buckets.get(d, [])
            self._buckets[d] = [e for e in bucket if e.node_id != old_id]
        return self.admit(new_enr)

    def remove(self, node_id: bytes) -> None:
        d = log_distance(self.local_id, node_id)
        with self._lock:
            bucket = self._buckets.get(d, [])
            self._buckets[d] = [e for e in bucket if e.node_id != node_id]

    def at_distance(self, d: int) -> list[ENR]:
        with self._lock:
            return list(self._buckets.get(d, []))

    def closest(self, target: bytes, n: int) -> list[ENR]:
        with self._lock:
            allr = [e for b in self._buckets.values() for e in b]
        return sorted(
            allr,
            key=lambda e: int.from_bytes(e.node_id, "big")
            ^ int.from_bytes(target, "big"),
        )[:n]

    def all_records(self) -> list[ENR]:
        with self._lock:
            return [e for b in self._buckets.values() for e in b]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets.values())


class DiscoveryService:
    """One node's discovery endpoint: local signed ENR + routing table +
    UDP server answering PING/FINDNODE, with iterative lookup client."""

    def __init__(
        self,
        fork_digest: bytes = b"\x00\x00\x00\x00",
        ip: str = "127.0.0.1",
        tcp_port: int = 0,
        udp_port: int = 0,
        sk_scalar: int | None = None,
        peer_manager=None,
    ):
        from ..oracle import ciphersuite as cs
        from ..oracle import curves as oc
        from ..oracle.fields import R

        # every admitted record is verified natively: load it now, loudly
        _native()
        self.sk = sk_scalar or (
            int.from_bytes(secrets.token_bytes(31), "big") % R or 1
        )

        self.pubkey = oc.g1_compress(cs.sk_to_pk(self.sk))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((ip, udp_port))
        self.enr = ENR(
            1, fork_digest, ip, tcp_port, self._sock.getsockname()[1],
            self.pubkey,
        ).sign(self.sk)
        self.table = RoutingTable(self.enr.node_id)
        self.peer_manager = peer_manager
        self._stopped = False
        self._thread: threading.Thread | None = None
        # pending liveness-checked evictions: bucket distance -> (oldest
        # node_id, candidate ENR, deadline). One pending slot per bucket
        # (discv5); candidates arriving while a check is in flight drop.
        self._pending_evictions: dict[int, tuple[bytes, ENR, float]] = {}
        self._pending_lock = threading.Lock()
        # per-request FINDNODE response tracking: responder node_id ->
        # events set by the serve loop when that peer's NODES response
        # lands (a list — concurrent lookups may query the same peer, and
        # one response settles every waiter). Replaces the old table-size
        # polling, which burned the full timeout whenever a response taught
        # nothing new (already-known records).
        self._pending_requests: dict[bytes, list[threading.Event]] = {}
        # addr -> outstanding FINDNODE count: lives for the WHOLE request
        # (unlike _findnode_inflight, which the WHOAREYOU retry consumes) —
        # the serve loop's NODES gate requires the SOURCE ADDRESS to match
        # an outstanding request, not just the forgeable node_id
        self._pending_addrs: dict[tuple, int] = {}
        self._requests_lock = threading.Lock()
        # stateless WHOAREYOU source-address validation: cookies we hand out
        # are HMAC(secret, src_addr || time window) — no per-peer state; the
        # client side caches the cookie each server gave us and remembers
        # the in-flight FINDNODE body per destination so a WHOAREYOU
        # challenge can be answered with one retry.
        self._cookie_secret = secrets.token_bytes(16)
        # addr -> (cookie, expiry): bounded — entries expire with the server
        # window and the insert path prunes, so walking the whole DHT
        # keyspace over a long uptime cannot grow this without limit
        self._cookies: dict[tuple, tuple[bytes, float]] = {}
        self._findnode_inflight: dict[tuple, bytes] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DiscoveryService":
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name=f"discovery-{self.enr.udp_addr[1]}",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def update_tcp_port(self, port: int) -> None:
        """Re-sign the local ENR with the final TCP listen port (the
        transport binds after discovery starts); bumps seq. The serve
        thread answers FINDNODE from self.enr concurrently, so the
        read-bump-resign sequence must be atomic under the pending lock."""
        with self._pending_lock:
            self.enr = ENR(
                self.enr.seq + 1, self.enr.fork_digest, self.enr.ip, port,
                self.enr.udp_addr[1], self.pubkey,
            ).sign(self.sk)

    # -- record admission --------------------------------------------------

    def _admit(self, enr: ENR) -> bool:
        """Verify + filter a remote record: signature, fork digest, and the
        peer-manager's ban list all gate table admission. Full buckets go
        through the liveness-checked eviction path instead of blind LRU."""
        if enr.node_id == self.enr.node_id:
            return False
        if enr.fork_digest != self.enr.fork_digest:
            return False
        if not enr.verify():
            return False
        if self.peer_manager is not None and self.peer_manager.is_banned(
            node_id=enr.node_id, addr=enr.tcp_addr
        ):
            return False
        return self.table.admit(enr, on_full=self._on_bucket_full)

    # -- liveness-checked eviction ----------------------------------------

    def _on_bucket_full(self, oldest: ENR, candidate: ENR) -> None:
        """Called (under the table lock — no table calls here) when a
        verified candidate hits a full bucket: ping the bucket's oldest
        record and park the candidate. Any packet from the oldest before
        the deadline cancels the eviction; expiry replaces it."""
        d = log_distance(self.enr.node_id, oldest.node_id)
        with self._pending_lock:
            if d in self._pending_evictions:
                return  # one pending check per bucket; extra candidates drop
            self._pending_evictions[d] = (
                oldest.node_id, candidate, time.monotonic() + LIVENESS_TIMEOUT_S,
            )
        self._send(oldest.udp_addr, _PING, b"")

    def _note_liveness(self, node_id: bytes) -> None:
        """A packet from ``node_id`` proves liveness: cancel any pending
        eviction of it (candidate drops) and refresh its LRU position."""
        d = log_distance(self.enr.node_id, node_id)
        cancelled = False
        with self._pending_lock:
            pend = self._pending_evictions.get(d)
            if pend is not None and pend[0] == node_id:
                del self._pending_evictions[d]
                cancelled = True
        if cancelled:
            self.table.touch(node_id)
            log.debug(
                "bucket eviction cancelled: oldest is alive",
                node_id=node_id.hex()[:16],
            )

    def _expire_pending_evictions(self) -> None:
        now = time.monotonic()
        expired = []
        with self._pending_lock:
            for d, (old_id, cand, deadline) in list(
                self._pending_evictions.items()
            ):
                if now >= deadline:
                    expired.append((old_id, cand))
                    del self._pending_evictions[d]
        for old_id, cand in expired:
            self.table.replace(old_id, cand)
            log.debug(
                "evicted unresponsive bucket head",
                evicted=old_id.hex()[:16], admitted=cand.node_id.hex()[:16],
            )

    # -- stateless source-address cookies ----------------------------------

    def _cookie_for(self, src: tuple, window_offset: int = 0) -> bytes:
        """The cookie THIS node hands to (and later expects back from) a
        source address, for the current (or offset) time window. Stateless:
        derived from the local secret, so validation needs no per-peer
        bookkeeping and a restart only invalidates outstanding handshakes."""
        import hashlib
        import hmac

        w = int(time.time() / _COOKIE_WINDOW_S) + window_offset
        msg = f"{src[0]}:{src[1]}:{w}".encode()
        return hmac.new(self._cookie_secret, msg, hashlib.sha256).digest()[
            :_COOKIE_LEN
        ]

    def _cookie_ok(self, cookie: bytes, src: tuple) -> bool:
        import hmac

        if len(cookie) != _COOKIE_LEN:
            return False
        return any(
            hmac.compare_digest(cookie, self._cookie_for(src, -i))
            for i in (0, 1)
        )

    # -- client side -------------------------------------------------------

    def bootstrap(self, boot_enr: ENR) -> bool:
        """Admit a trusted boot record and ping it (teaches it our ENR).
        A rejected boot record is LOUD: a node bootstrapped from nothing has
        no other way into the network, and a silently-dropped boot ENR
        (bad signature, fork mismatch, banned) looks identical to an empty
        network from the outside."""
        admitted = self._admit(boot_enr)
        if not admitted:
            reason = "duplicate-or-pending"
            if boot_enr.fork_digest != self.enr.fork_digest:
                reason = "fork digest mismatch"
            elif not boot_enr.verify():
                reason = "invalid ENR signature"
            elif self.peer_manager is not None and self.peer_manager.is_banned(
                node_id=boot_enr.node_id, addr=boot_enr.tcp_addr
            ):
                reason = "banned"
            log.warning(
                "boot ENR rejected",
                reason=reason,
                node_id=boot_enr.node_id.hex()[:16],
                addr=boot_enr.tcp_addr,
            )
        self._send(boot_enr.udp_addr, _PING, b"")
        return admitted

    def lookup(self, target: bytes | None = None, timeout: float = 2.0) -> list[ENR]:
        """Iterative FINDNODE toward ``target`` (random by default — the
        discv5 random-walk that fills the table). Returns the records known
        afterwards, closest first."""
        target = target or secrets.token_bytes(32)
        queried: set[bytes] = set()
        for _ in range(MAX_LOOKUP_ROUNDS):
            candidates = [
                e for e in self.table.closest(target, ALPHA * 2)
                if e.node_id not in queried
            ][:ALPHA]
            if not candidates:
                break
            before = len(self.table)
            for enr in candidates:
                queried.add(enr.node_id)
                d = log_distance(enr.node_id, target)
                dists = sorted({max(d, 1), min(max(d, 1) + 1, 256),
                                max(d - 1, 1)})
                self._find_node(enr, dists, timeout)
            if len(self.table) == before:
                break
        return self.table.closest(target, K_BUCKET)

    def _find_node(self, enr: ENR, distances: list[int], timeout: float) -> bool:
        """Send FINDNODE and wait for THIS peer's NODES response (per-request
        tracking — the serve loop signals the event when the response
        arrives, whether or not it taught any new record). Returns True when
        the peer answered within the timeout."""
        inner = bytes([len(distances)]) + b"".join(
            struct.pack(">H", d) for d in distances
        )
        cached = self._cookies.get(enr.udp_addr)
        cookie = cached[0] if cached and cached[1] > time.time() else b""
        ev = threading.Event()
        with self._requests_lock:
            self._pending_requests.setdefault(enr.node_id, []).append(ev)
            # remember the request body so a WHOAREYOU challenge can be
            # answered by resending with the fresh cookie (last writer wins
            # for concurrent requests to one peer — both retries carry a
            # valid body, the answers settle every waiter)
            self._findnode_inflight[enr.udp_addr] = inner
            self._pending_addrs[enr.udp_addr] = (
                self._pending_addrs.get(enr.udp_addr, 0) + 1
            )
        try:
            self._send(
                enr.udp_addr, _FINDNODE, bytes([len(cookie)]) + cookie + inner
            )
            return ev.wait(timeout)
        finally:
            with self._requests_lock:
                # compare-and-pop: only clear our OWN body — a concurrent
                # request to the same peer may have overwritten the slot, and
                # its WHOAREYOU retry still needs it
                if self._findnode_inflight.get(enr.udp_addr) is inner:
                    del self._findnode_inflight[enr.udp_addr]
                n_out = self._pending_addrs.get(enr.udp_addr, 0) - 1
                if n_out > 0:
                    self._pending_addrs[enr.udp_addr] = n_out
                else:
                    self._pending_addrs.pop(enr.udp_addr, None)
                evs = self._pending_requests.get(enr.node_id)
                if evs is not None:
                    # remove only THIS call's event — a concurrent request
                    # to the same peer must keep its own waiter registered
                    try:
                        evs.remove(ev)
                    except ValueError:
                        pass
                    if not evs:
                        del self._pending_requests[enr.node_id]

    # -- wire --------------------------------------------------------------

    def _send(self, udp_addr: tuple, kind: int, body: bytes) -> None:
        pkt = self.enr.encode() + bytes([kind]) + body
        try:
            self._sock.sendto(pkt, udp_addr)
        except OSError:
            pass

    def _serve(self) -> None:
        # bounded recv so pending-eviction deadlines fire even on an idle
        # socket (the liveness check must conclude without inbound traffic)
        self._sock.settimeout(_SERVE_TICK_S)
        while not self._stopped:
            try:
                data, src = self._sock.recvfrom(65535)
            except socket.timeout:
                self._expire_pending_evictions()
                continue
            except OSError:
                return
            self._expire_pending_evictions()
            try:
                sender, off = ENR.decode(data)
                kind = data[off]
                body = data[off + 1 :]
            except (ValueError, IndexError):
                continue
            if kind == _FINDNODE:
                # stateless WHOAREYOU gate BEFORE any ENR signature work: a
                # FINDNODE without a valid source-address cookie costs this
                # node one HMAC and a reply no larger than the request —
                # never a BLS verification, never a NODES payload. A spoofed
                # source address never sees the cookie, so it can neither
                # force signature verifies nor aim amplified responses.
                if not body:
                    continue
                ck_len = body[0]
                if len(body) < 1 + ck_len:
                    continue
                cookie, rest = body[1 : 1 + ck_len], body[1 + ck_len :]
                if not self._cookie_ok(cookie, src):
                    self._send(src, _WHOAREYOU, self._cookie_for(src))
                    continue
                self._note_liveness(sender.node_id)
                self._admit(sender)
                self._answer_findnode(src, rest)
                continue
            if kind == _WHOAREYOU:
                self._on_whoareyou(src, body)
                continue
            if kind == _NODES:
                # solicited-only: a NODES packet is dropped BEFORE any ENR
                # signature work unless BOTH its self-reported node_id has a
                # FINDNODE outstanding AND it arrives from an address we
                # sent one to — the node_id alone is attacker-chosen (a
                # public boot node's id is in its published ENR), so an
                # id-only gate still buys up to 1 + _MAX_NODES_PER_RESPONSE
                # BLS verifications per spoofed datagram and falsely
                # settles the waiters
                with self._requests_lock:
                    evs = list(self._pending_requests.get(sender.node_id, ()))
                    addr_ok = src in self._pending_addrs
                if not evs or not addr_ok:
                    continue
            self._note_liveness(sender.node_id)
            self._admit(sender)
            if kind == _PING:
                # residual unauthenticated surface (documented): one ENR
                # verify + a tiny PONG per datagram, no amplification. The
                # eviction-liveness protocol needs unsolicited PING/PONG;
                # per-packet cost stays one bounded verify until the real
                # discv5 session handshake lands with the transport seam.
                self._send(src, _PONG, b"")
            elif kind == _NODES:
                self._ingest_nodes(body)
                # settle every outstanding FINDNODE to this responder only
                # after ingest, so the waiters observe the admitted records
                for ev in evs:
                    ev.set()
            # PONG: the ENR admission above is the whole effect

    def _on_whoareyou(self, src: tuple, body: bytes) -> None:
        """A WHOAREYOU challenge for an in-flight FINDNODE: cache the cookie
        for the challenger's address and retry the request ONCE — the
        in-flight body is consumed here, so N challenges (spoofed or real)
        to one outstanding request yield one resend and one cache write.
        Challenges from addresses we have nothing outstanding to are
        dropped. Residual surface: an attacker who spoofs the peer's
        address WHILE we have a request to it in flight can burn that
        request's single retry and leave a garbage cookie, costing one
        extra WHOAREYOU round trip on the next request — bounded by our
        own request rate, never amplified."""
        if len(body) != _COOKIE_LEN:
            return
        with self._requests_lock:
            inner = self._findnode_inflight.pop(src, None)
        if inner is None:
            return
        now = time.time()
        if len(self._cookies) >= _COOKIE_CACHE_MAX:
            self._cookies = {
                a: ce for a, ce in self._cookies.items() if ce[1] > now
            }
            while len(self._cookies) >= _COOKIE_CACHE_MAX:
                self._cookies.pop(next(iter(self._cookies)))
        self._cookies[src] = (bytes(body), now + _COOKIE_WINDOW_S)
        self._send(
            src, _FINDNODE, bytes([_COOKIE_LEN]) + bytes(body) + inner
        )

    def _answer_findnode(self, src: tuple, body: bytes) -> None:
        try:
            n = body[0]
            dists = [
                struct.unpack_from(">H", body, 1 + 2 * i)[0] for i in range(n)
            ]
        except (IndexError, struct.error):
            return
        out: list[ENR] = []
        for d in dists:
            out.extend(self.table.at_distance(d))
        if len(out) < _MAX_NODES_PER_RESPONSE:
            # sparse-table padding: strict discv5 answers only the exact
            # distances, which leaves bootstrap-size meshes (a boot node and
            # a handful of peers) unable to find each other; pad with the
            # table's other records (dense tables behave like discv5 — the
            # exact-distance records fill the response first)
            seen = {e.node_id for e in out}
            for e in self.table.all_records():
                if len(out) >= _MAX_NODES_PER_RESPONSE:
                    break
                if e.node_id not in seen:
                    out.append(e)
        out = out[:_MAX_NODES_PER_RESPONSE]
        payload = struct.pack(">H", len(out)) + b"".join(
            e.encode() for e in out
        )
        self._send(src, _NODES, payload)

    def _ingest_nodes(self, body: bytes) -> None:
        try:
            (count,) = struct.unpack_from(">H", body, 0)
            off = 2
            for _ in range(min(count, _MAX_NODES_PER_RESPONSE)):
                enr, off = ENR.decode(body, off)
                self._admit(enr)
        except ValueError:
            return

    # -- transport integration --------------------------------------------

    def known_tcp_addrs(self) -> list[str]:
        """TCP addresses of every verified record (the dial candidates)."""
        return [
            e.tcp_addr for e in self.table.all_records() if e.tcp > 0
        ]
