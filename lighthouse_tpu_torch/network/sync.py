"""SyncManager: range sync, backfill sync, and single-block lookups with
peer rotation and failure handling.

Twin of ``network/src/sync/manager.rs`` (peer status intake, sync-state
machine), ``range_sync/{chain,batch}.rs`` (per-epoch batches via
BlocksByRange with per-batch retry against rotated peers and demotion of
peers serving bad segments), ``backfill_sync/mod.rs`` (checkpoint-synced
nodes download history BACKWARDS to genesis, batch-verifying signatures and
anchoring each segment to the oldest known block), and ``block_lookups/``
(gossip blocks with unknown parents trigger a bounded parent-chain walk via
BlocksByRoot before import).

Sync work runs on a dedicated worker thread — a stalled or lying peer slows
one round, never the gossip/RPC callers (the reference's sync manager is its
own task for the same reason). Peers whose segments fail verification are
demoted and eventually ignored; a peer advertising a bogus high head gets
demoted when its promised blocks never verify, unsticking the target
selection.

On the port every segment's signatures go to the card in one batch
(``BeaconChain.process_chain_segment`` through ``bls.verify_signature_sets``),
every backfilled segment's proposer signatures in one indexed batch against
the resident pubkey cache (``import_historical_blocks``), and coupled column
fetches through ``verify_data_column_sidecar``'s device engine.
"""

from __future__ import annotations

import threading
import time

from ..loadshed.adaptive import BackoffPolicy
from ..utils.logging import get_logger
from .transport import Status

log = get_logger("sync")

EPOCHS_PER_BATCH = 2        # range_sync/batch.rs EPOCHS_PER_BATCH
MAX_BATCH_RETRIES = 3       # distinct peers tried per batch (batch.rs MAX_BATCH_DOWNLOAD_ATTEMPTS)
PEER_FAILURE_LIMIT = 3      # demotions before a peer is ignored entirely
MAX_LOOKUP_DEPTH = 32       # parent-chain hops (block_lookups PARENT_DEPTH_TOLERANCE)
SCORE_BAD_SEGMENT = -20.0   # transport score hit for an unverifiable segment


class SyncManager:
    def __init__(self, service, threaded: bool = True, backoff=None):
        self.svc = service
        self.peer_status: dict[str, Status] = {}
        self.peer_failures: dict[str, int] = {}
        # jittered exponential backoff + per-peer cooldown for the retry
        # loops: a failing peer is not immediately re-asked, and repeated
        # failures grow its cooldown (loadshed.adaptive.BackoffPolicy)
        self.backoff = backoff if backoff is not None else BackoffPolicy()
        self.backfill_enabled = True
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stopped = False
        self._threaded = threaded
        self._thread = None
        self._lookup_threads: list[threading.Thread] = []
        if threaded:
            self._thread = threading.Thread(
                target=self._worker, daemon=True,
                name=f"sync-{getattr(service, 'node_id', '?')}",
            )
            self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        with self._lock:
            lookups = list(self._lookup_threads)
        for th in lookups:
            th.join(timeout=2.0)

    # -- peer intake -------------------------------------------------------

    def on_peer_status(self, peer: str, status: Status) -> None:
        with self._lock:
            self.peer_status[peer] = status
        self.maybe_sync()

    def _demote(self, peer: str, why: str) -> None:
        """A peer served a bad/unverifiable segment or lied about its head:
        count the strike, score it on the transport, forget its status once
        it crosses the limit (sync/manager.rs peer-action reporting)."""
        with self._lock:
            n = self.peer_failures.get(peer, 0) + 1
            self.peer_failures[peer] = n
            if n >= PEER_FAILURE_LIMIT:
                self.peer_status.pop(peer, None)
        log.warn("Sync peer demoted", peer=peer, reason=why, strikes=n)
        report = getattr(self.svc.transport, "report_peer", None)
        if report is not None:
            report(peer, SCORE_BAD_SEGMENT)

    def _usable_peers(self) -> list[str]:
        """Peers ahead of us, best head first, failure-limited peers last."""
        ours = self.svc.chain.head.slot
        with self._lock:
            peers = [
                (st.head_slot, -self.peer_failures.get(p, 0), p)
                for p, st in self.peer_status.items()
                if st.head_slot > ours
                and self.peer_failures.get(p, 0) < PEER_FAILURE_LIMIT
            ]
        peers.sort(reverse=True)
        return [p for _, _, p in peers]

    def _serving_peers(self) -> list[str]:
        """Any non-demoted peer (backfill serves from peers at ANY head)."""
        with self._lock:
            return [
                p for p in self.peer_status
                if self.peer_failures.get(p, 0) < PEER_FAILURE_LIMIT
            ]

    def best_peer(self):
        peers = self._usable_peers()
        return peers[0] if peers else None

    # -- the worker --------------------------------------------------------

    def maybe_sync(self) -> None:
        if self._threaded:
            self._idle.clear()
            self._wake.set()
        else:
            self._sync_round()
            if self.backfill_enabled:
                self._backfill_round()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the worker has drained its queue (tests/drivers)."""
        if not self._threaded:
            return True
        return self._idle.wait(timeout)

    def _worker(self) -> None:
        while not self._stopped:
            self._wake.wait()
            self._wake.clear()
            if self._stopped:
                return
            try:
                self._sync_round()
                if self.backfill_enabled:
                    self._backfill_round()
            except Exception as e:  # noqa: BLE001 — sync must survive anything
                log.warn("Sync round failed", error=str(e))
            if not self._wake.is_set():
                self._idle.set()

    # -- range sync (forwards) ---------------------------------------------

    def _sync_round(self) -> None:
        """Catch up to the best advertised head, batch by batch, rotating
        peers per batch and demoting peers that serve unverifiable segments
        (range_sync/chain.rs). A target peer whose promised head never
        materializes is demoted, so a liar cannot wedge sync."""
        chain = self.svc.chain
        spec = chain.spec
        batch_slots = EPOCHS_PER_BATCH * spec.preset.SLOTS_PER_EPOCH
        while True:
            peers = self._usable_peers()
            if not peers:
                return
            target_peer = peers[0]
            with self._lock:
                target = self.peer_status[target_peer].head_slot
            # fork-tolerant start: local finalized epoch (range_sync/chain.rs)
            # — but never below the checkpoint anchor, whose earlier history
            # is the backfill's job, not forward sync's
            start = max(
                spec.start_slot(
                    int(chain.head.state.finalized_checkpoint.epoch)
                ),
                getattr(chain, "oldest_block_slot", 0),
            ) + 1
            head_before = chain.head.slot
            failed = False
            while start <= target:
                got = self._download_batch(start, batch_slots)
                if got is None:
                    failed = True
                    break
                start += batch_slots
            if chain.head.slot >= target:
                return  # caught up to this target
            if failed:
                return  # no peer could serve; try again on next status
            # progress means the HEAD advanced — downloads that import as
            # no-ops must not count, or a lying/unusable target loops the
            # sync forever. Demote and re-select.
            if chain.head.slot <= head_before:
                self._demote(target_peer, "advertised head never materialized")
                continue

    def _download_batch(self, start: int, count: int):
        """One BlocksByRange batch tried against up to MAX_BATCH_RETRIES
        peers. Returns imported block count, or None if no peer served.

        Rotation is backoff-aware: peers inside their failure cooldown are
        skipped, and consecutive failed attempts within this batch sleep a
        growing jittered delay instead of hammering the next peer."""
        tried = 0
        for peer in self._usable_peers():
            if tried >= MAX_BATCH_RETRIES:
                break
            if not self.backoff.ready(peer):
                continue
            if tried:
                time.sleep(self.backoff.attempt_delay(tried))
            tried += 1
            try:
                blocks = self.svc.transport.request(
                    self.svc.node_id, peer, "blocks_by_range", (start, count)
                )
            except ConnectionError as e:
                self.backoff.record_failure(peer)
                self._demote(peer, f"blocks_by_range failed: {e}")
                continue
            self.backoff.record_success(peer)
            if not blocks:
                return 0
            if self._import_segment(blocks, peer, "bad segment"):
                return len(blocks)
        return None

    def _import_segment(self, blocks, peer: str, label: str) -> bool:
        """Import a downloaded segment, coupling PeerDAS column downloads
        to the block download (block_sidecar_coupling.rs): a block parked
        on column availability pulls its missing custody/sample columns
        from the serving peer by root and the import retries. A peer that
        cannot close the gap rotates WITHOUT a strike — pending
        availability is a property of the data, not peer misbehavior; only
        segments that fail verification demote.

        Direct call, NOT processor.submit: the synchronous processor
        drains every queue, so a failure raised here could belong to a
        concurrent submitter's work and the demotion would hit the wrong
        peer."""
        from ..beacon_chain.chain import BlockPendingAvailability

        fetch = getattr(self.svc, "_fetch_missing_columns", None)
        pending_seen: set[bytes] = set()
        while True:
            try:
                self.svc.process_chain_segment_strict(blocks)
                return True
            except BlockPendingAvailability as e:
                root = bytes(e.block_root)
                if fetch is None or root in pending_seen:
                    return False  # this peer can't close the gap: rotate
                pending_seen.add(root)
                fetch(root, peer)
            except Exception as e:  # noqa: BLE001 — bad segment
                self._demote(peer, f"{label}: {e}")
                return False

    # -- backfill sync (backwards) -----------------------------------------

    def _backfill_round(self) -> None:
        """Checkpoint-synced nodes: download history backwards from the
        oldest known block to genesis (backfill_sync/mod.rs +
        historical_blocks.rs). Batches anchor by hash-chain linkage + one
        batched signature verification; bad segments demote the peer and
        rotate."""
        chain = self.svc.chain
        if not hasattr(chain, "backfill_complete") or chain.backfill_complete:
            return
        if getattr(chain, "anchor_block_missing", False):
            # the checkpoint anchor block itself first (root-pinned fetch)
            block = self._lookup_by_root(chain.genesis_block_root)
            if block is None:
                return
            chain.import_anchor_block(block)
        spec = chain.spec
        batch_slots = EPOCHS_PER_BATCH * spec.preset.SLOTS_PER_EPOCH
        while not chain.backfill_complete:
            oldest = chain.oldest_block_slot
            # the window's upper edge slides DOWN without demotion when the
            # linking parent sits below it (a skip-slot gap wider than one
            # batch is honest chain shape, not peer misbehavior)
            hi = oldest
            imported = False
            while not imported and hi > 1:
                start = max(1, hi - batch_slots)
                count = hi - start
                got_any = False
                ready = [
                    p for p in self._serving_peers()
                    if self.backoff.ready(p)
                ]
                for peer in ready[:MAX_BATCH_RETRIES]:
                    try:
                        blocks = self.svc.transport.request(
                            self.svc.node_id, peer, "blocks_by_range",
                            (start, count),
                        )
                    except ConnectionError as e:
                        self.backoff.record_failure(peer)
                        self._demote(peer, f"backfill download failed: {e}")
                        continue
                    self.backoff.record_success(peer)
                    blocks = [
                        b for b in blocks if int(b.message.slot) < oldest
                    ]
                    if not blocks:
                        continue
                    got_any = True
                    try:
                        n = chain.import_historical_blocks(blocks)
                        log.info(
                            "Backfilled", blocks=n,
                            oldest_slot=chain.oldest_block_slot,
                        )
                        imported = True
                        break
                    except Exception as e:  # noqa: BLE001 — bad segment
                        if start > 1 and "link" in str(e):
                            # parent below the window: widen, don't punish
                            break
                        self._demote(peer, f"bad backfill segment: {e}")
                if imported:
                    break
                if start == 1:
                    if not got_any:
                        return  # nothing below our oldest block: done
                    return  # full-range segment unusable; retry next wake
                hi = start
            if not imported:
                return  # retry on next wake

    # -- single-block lookups ----------------------------------------------

    def on_unknown_parent(self, signed_block, from_peer: str) -> None:
        """A gossip block whose parent we don't know: walk the parent chain
        backwards via BlocksByRoot (bounded), then import the recovered
        segment oldest-first (sync/block_lookups/ parent lookups).

        Lookups dedup by block root — N mesh peers regossiping the same
        orphan (or a peer fabricating orphans) must not fan out N thread/RPC
        walks for one chain (block_lookups' by-root dedup)."""
        root = signed_block.message.tree_root()
        with self._lock:
            inflight = getattr(self, "_inflight_lookups", None)
            if inflight is None:
                inflight = self._inflight_lookups = set()
            if root in inflight or len(inflight) >= 32:
                return
            inflight.add(root)
        if self._threaded:
            th = threading.Thread(
                target=self._parent_lookup_tracked,
                args=(root, signed_block, from_peer),
                daemon=True, name="sync-lookup",
            )
            th.start()
            with self._lock:
                self._lookup_threads[:] = [
                    t for t in self._lookup_threads if t.is_alive()
                ]
                self._lookup_threads.append(th)
        else:
            self._parent_lookup_tracked(root, signed_block, from_peer)

    def _parent_lookup_tracked(self, root, signed_block, from_peer) -> None:
        try:
            self._parent_lookup(signed_block, from_peer)
        finally:
            with self._lock:
                self._inflight_lookups.discard(root)

    def _parent_lookup(self, signed_block, from_peer: str) -> None:
        chain = self.svc.chain
        segment = [signed_block]
        for _ in range(MAX_LOOKUP_DEPTH):
            parent_root = bytes(segment[0].message.parent_root)
            if parent_root in chain._seen_blocks:
                break
            block = self._lookup_by_root(parent_root, prefer=from_peer)
            if block is None:
                log.warn(
                    "Parent lookup failed", root=parent_root.hex()[:16],
                )
                return
            segment.insert(0, block)
        else:
            log.warn("Parent chain deeper than lookup tolerance")
            return
        self._import_segment(segment, from_peer, "unviable lookup segment")

    def _lookup_by_root(self, root: bytes, prefer: str | None = None):
        """BlocksByRoot from the preferring peer first, then rotation. The
        sender goes first even before its status handshake lands — it is
        the one peer guaranteed to hold the block it just gossiped."""
        # cooldown-aware rotation — but the preferring peer always goes
        # first regardless (it just gossiped the block; it has it)
        peers = [
            p for p in self._serving_peers()
            if p == prefer or self.backoff.ready(p)
        ]
        if prefer is not None:
            if prefer in peers:
                peers.remove(prefer)
            peers.insert(0, prefer)
        for peer in peers[: MAX_BATCH_RETRIES + 1]:
            try:
                blocks = self.svc.transport.request(
                    self.svc.node_id, peer, "blocks_by_root", [root]
                )
            except ConnectionError:
                self.backoff.record_failure(peer)
                continue
            self.backoff.record_success(peer)
            for b in blocks:
                if b.message.tree_root() == root:
                    return b
        return None
