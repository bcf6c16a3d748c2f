"""The BeaconChain orchestrator.

Twin of ``beacon_node/beacon_chain/src/beacon_chain.rs``:
``process_block`` (:3289) with the typestate pipeline collapsed into explicit
stages (gossip checks → batched signature verification → state transition →
``import_block`` (:3717) store writes + fork-choice update), attestation
verification with the batch path (``attestation_verification/batch.rs``),
head tracking (``canonical_head.rs:474``), and block production
(``produce_block_with_verification``, :4553).

The port's copy of ``lighthouse_tpu/beacon_chain/chain.py``, whole, over the
port's own modules. Its signature batches go to the port's ``bls``: under the
``"device"`` backend through ``bls.backend.verify_indexed_sets_device``
against the pubkey cache's resident tensor, inside the ``bls_device``
supervisor's ladder (device_full -> device_reduced, failing closed; a
cpu_oracle rung follows only for a cache on the CPU); under ``"oracle"``
through the generic ``SignatureSet`` arm. Epoch boundaries inside
``process_slots`` run in the port's ``epoch_engine``. PeerDAS column
sampling (``enable_peerdas``) decides availability from columns verified by
``beacon_chain.data_columns`` through the port's ``kzg`` engine. On a
durable store (a WAL ``LevelStore``) every import persists fork choice
(``fork_choice.persistence``); ``recovery.recover_node_state`` restarts a
node from it. The mesh planner is None (the mesh is off until
multi-GPU serving, ROADMAP Queue 1 item 6).
The light-client server cache (``light_client.LightClientServerCache``)
rides the block-observer seam and persists its update archive in the hot
store.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import bls
from ..fork_choice import ForkChoice
from ..fork_choice.proto_array import ExecutionStatus
from ..state_transition import (
    BlockSignatureStrategy,
    get_beacon_proposer_index,
    get_current_epoch,
    get_indexed_attestation,
    per_block_processing,
    process_slots,
)
from ..state_transition.per_block import BlockProcessingError, ConsensusContext
from ..store import HotColdDB
from ..types.containers import for_preset
from ..types.spec import ChainSpec
from ..utils.logging import get_logger
from ..utils.metrics import (
    ATTESTATION_BATCH_SETUP_TIMES,
    ATTESTATION_BATCH_VERIFY_TIMES,
    BLOCK_PROCESSING_TIMES,
    FORK_CHOICE_GET_HEAD_TIMES,
)
from ..utils.slot_clock import ManualSlotClock, SlotClock
from .pubkey_cache import ValidatorPubkeyCache

log = get_logger("beacon_chain")


class BlockError(Exception):
    pass


class BlockPendingAvailability(BlockError):
    """Deneb block parked until its blob sidecars arrive
    (AvailabilityProcessingStatus::MissingComponents)."""

    def __init__(self, block_root: bytes):
        super().__init__(f"pending blob availability: {block_root.hex()[:16]}")
        self.block_root = block_root


class AttestationError(Exception):
    pass


@dataclass
class ChainHead:
    root: bytes
    slot: int
    state: object


class BeaconChain:
    def __init__(
        self,
        spec: ChainSpec,
        genesis_state,
        store: HotColdDB | None = None,
        slot_clock: SlotClock | None = None,
        execution_layer=None,
        kzg=None,
        pubkey_cache: ValidatorPubkeyCache | None = None,
    ):
        """``pubkey_cache``: a cache already holding the anchor's keys (say
        ``ValidatorPubkeyCache.from_affine``, a restart's stored points) in
        place of decompressing every key of ``genesis_state`` here."""
        self.spec = spec
        self.ns = for_preset(spec.preset.name)
        self.store = store or HotColdDB()
        # fork choice persists on EVERY import only when the hot store is
        # durable (a WAL store with replay): persisting per-import into a
        # MemoryStore buys nothing — it dies with the process — and the
        # serialize cost is real on import-heavy paths. Shutdown persist
        # (Client.stop) stays unconditional.
        self._durable = hasattr(self.store.hot, "recovery_stats")
        self.slot_clock = slot_clock or ManualSlotClock(0)
        self.execution_layer = execution_layer
        self.eth1_service = None  # optional deposit/eth1-data bridge (eth1/)
        from ..op_pool.sync_aggregation import SyncContributionPool

        self.sync_contribution_pool = SyncContributionPool(
            spec.preset.SYNC_COMMITTEE_SIZE
        )
        from ..op_pool.naive_aggregation import NaiveAggregationPool

        self.naive_aggregation_pool = NaiveAggregationPool(self.ns.Attestation)
        from .data_availability import DataAvailabilityChecker

        self.da_checker = DataAvailabilityChecker(
            spec, kzg=kzg, is_known=lambda root: root in self._seen_blocks
        )
        # PeerDAS: the column cache is created HERE — not lazily
        # by the network service — so every mutation happens under
        # ``self.lock`` via ``put_data_column`` and the cache is pruned with
        # the availability horizon instead of growing without bound.
        self.data_column_cache: dict[bytes, dict[int, object]] = {}
        self.cell_context = None  # CellContext when column sampling enabled
        self.peerdas = None       # PeerDasSampler when enabled
        self.pubkey_cache = (
            ValidatorPubkeyCache() if pubkey_cache is None else pubkey_cache
        )
        self.pubkey_cache.import_new_pubkeys(genesis_state)
        # attester/shuffling cache tier (firehose/attester_cache.py): gossip
        # committee resolution without cloning or slot-advancing full states
        from ..firehose.attester_cache import AttesterCacheTier

        self.attester_cache = AttesterCacheTier(
            spec,
            genesis_validators_root=bytes(genesis_state.genesis_validators_root),
            ancestor_at_slot=self._known_ancestor_at_slot,
            state_fallback=self._state_for_committee,
        )
        # firehose hot path prunes the naive pool at most once per slot
        self._naive_pool_pruned_slot = -1
        # early-attester cache (early_attester_cache.rs): attestation data
        # for the current head served without a state read; primed on every
        # head update under the chain lock
        from .early_attester_cache import EarlyAttesterCache

        self.early_attester_cache = EarlyAttesterCache()
        # sharded serving tier (firehose/sharding.py over bls/mesh.py):
        # resolved lazily on the first batch verify — None when
        # LIGHTHOUSE_MESH_DEVICES leaves the mesh off (the single-device
        # path, bit-identical to the pre-mesh engine). Creation is guarded
        # by its own small lock (gossip + HTTP threads race the first
        # verify); dispatches never hold it
        import threading as _threading

        self._mesh_planner_state = "unset"
        self._mesh_planner_lock = _threading.Lock()

        # genesis anchor: the canonical block root needs the header's
        # state_root filled (it is zero until the next process_slot)
        hdr = genesis_state.latest_block_header.copy()
        if bytes(hdr.state_root) == b"\x00" * 32:
            hdr.state_root = genesis_state.tree_root()
        genesis_root = hdr.tree_root()
        self.genesis_state = genesis_state
        self.genesis_block_root = genesis_root
        # anchor checkpoint: epoch 0 at genesis, the state's epoch when
        # booting from a checkpoint-sync state (get_forkchoice_store)
        jc = (spec.compute_epoch_at_slot(int(genesis_state.slot)), genesis_root)
        self.fork_choice = ForkChoice.from_anchor(
            spec,
            genesis_root,
            genesis_state.slot,
            jc,
            jc,
            np.asarray(genesis_state.balances, dtype=np.uint64),
        )
        # Serializes chain mutation across whatever threads drive this chain
        # (HTTP handlers, network router, simulator loops). The reference
        # reaches the same guarantee through canonical_head's documented
        # lock ordering (canonical_head.rs module docs).
        import threading

        self.lock = threading.RLock()
        from ..store.migrate import BackgroundMigrator

        self.migrator = BackgroundMigrator(self.store)
        self.store.state_cls_for_slot = lambda slot: self.ns.state_types[
            spec.fork_name_at_slot(slot)
        ]
        self._states: dict[bytes, object] = {genesis_root: genesis_state}
        self._blocks: dict[bytes, object] = {}
        # bounded FIFO of store-decoded frozen blocks (get_signed_block)
        self._cold_block_cache: dict[bytes, object] = {}
        self._COLD_BLOCK_CACHE_MAX = 512
        self.head = ChainHead(
            root=genesis_root, slot=genesis_state.slot, state=genesis_state
        )
        # Device epoch engine (epoch_engine): when the
        # backend seam selects the device path, bind the anchor state's
        # registry mirror up front so the chain's first epoch boundary is a
        # journal-delta sync, not a full Python-object gather. process_slots
        # reaches the engine through the process_epoch seam on every
        # subsequent boundary.
        from .. import epoch_engine

        self.epoch_engine = epoch_engine
        if epoch_engine.device_backend_active():
            try:
                epoch_engine.prepare_state(genesis_state)
            except Exception as e:  # noqa: BLE001 — engine warm-up best-effort
                log.warning("epoch engine warm-up failed", error=str(e))
        self._seen_blocks: set[bytes] = {genesis_root}
        # backfill anchor (historical_blocks.rs): the oldest canonical block
        # we hold; checkpoint-synced chains fill backwards from here
        self._oldest_block_slot = int(genesis_state.slot)
        self._oldest_block_parent = bytes(hdr.parent_root)
        # Ingest seams for auxiliary services (the reference's slasher
        # service subscribes to gossip/import events, service.rs): called
        # with (signed_block) after import / (indexed_attestation) after
        # successful gossip verification. Observer errors never fail the
        # hot path.
        self.block_observers: list = []
        self.attestation_observers: list = []
        # SSE event bus (beacon_chain/src/events.rs): subscribers are
        # per-connection queues; emission never blocks the hot path
        self.event_subscribers: list = []  # list[(topics, queue.Queue)]
        self._event_lock = threading.Lock()
        # Liveness tracking for doppelganger protection (the reference's
        # ObservedAttesters / ObservedBlockProducers caches feeding
        # /eth/v1/validator/liveness): epoch -> validator indices seen
        # attesting or proposing. Pruned to the last few epochs.
        self._observed_attesters: dict[int, set[int]] = {}
        self._observed_proposers: dict[int, set[int]] = {}
        # light-client server: bootstraps + latest optimistic/finality
        # updates from imported sync aggregates (light_client_server_cache.rs)
        from ..light_client import LightClientServerCache

        self.light_client_cache = LightClientServerCache(self)

    def _record_liveness(self, table: dict, epoch: int, indices) -> None:
        s = table.setdefault(epoch, set())
        s.update(int(i) for i in indices)
        for old in [e for e in table if e < epoch - 4]:
            del table[old]

    def validator_liveness(self, epoch: int, indices) -> list[bool]:
        """Was each validator index observed attesting or proposing in
        ``epoch``? (http_api liveness endpoint, consumed by the VC's
        doppelganger service.)"""
        seen = self._observed_attesters.get(epoch, set()) | (
            self._observed_proposers.get(epoch, set())
        )
        return [int(i) in seen for i in indices]

    def subscribe_events(self, topics) -> "object":
        import queue as _q

        q = _q.Queue(maxsize=256)
        with self._event_lock:
            self.event_subscribers.append((set(topics), q))
        return q

    def unsubscribe_events(self, q) -> None:
        with self._event_lock:
            self.event_subscribers = [
                (t, qq) for (t, qq) in self.event_subscribers if qq is not q
            ]

    def _emit_event(self, topic: str, payload_fn) -> None:
        """``payload_fn`` is called lazily — zero cost with no subscriber."""
        with self._event_lock:
            targets = [
                q for topics, q in self.event_subscribers if topic in topics
            ]
        if not targets:
            return
        payload = payload_fn()
        for q in targets:
            try:
                q.put_nowait((topic, payload))
            except Exception:
                pass  # slow consumer: drop (events are best-effort)

    def _notify_block_observers(self, signed_block) -> None:
        blk = signed_block.message
        self._record_liveness(
            self._observed_proposers,
            self.spec.compute_epoch_at_slot(int(blk.slot)),
            [int(blk.proposer_index)],
        )
        for obs in self.block_observers:
            try:
                obs(signed_block)
            except Exception:
                pass
        self._emit_event(
            "block",
            lambda: {
                "slot": str(int(blk.slot)),
                "block": "0x" + type(blk).hash_tree_root(blk).hex(),
            },
        )

    def _notify_attestation_observers(self, indexed) -> None:
        self._record_liveness(
            self._observed_attesters,
            int(indexed.data.target.epoch),
            indexed.attesting_indices,
        )
        for obs in self.attestation_observers:
            try:
                obs(indexed)
            except Exception:
                pass

    # -- time --------------------------------------------------------------------

    def current_slot(self) -> int:
        return self.slot_clock.now() or 0

    def state_by_root(self, block_root: bytes):
        """Post-state of an imported block, or None (public accessor for the
        API layer; insulates callers from the chain's state-cache layout).
        Falls back to the store for states migrated out of memory."""
        state = self._states.get(block_root)
        if state is not None:
            return state
        if block_root == self.genesis_block_root:
            return self.genesis_state
        return self._load_state_from_store(block_root)

    def _load_state_from_store(self, block_root: bytes):
        """Reload a frozen/persisted state by block root (hot bytes, else
        the cold hierarchy; replay-layer slots reconstruct the nearest
        stored anchor and replay stored canonical blocks)."""
        signed = self.get_signed_block(block_root)
        if signed is None:
            return None
        state_root = bytes(signed.message.state_root)
        from ..store.kv import DBColumn

        ssz = self.store.hot.get(DBColumn.BeaconState, state_root)
        if ssz is not None:
            cls = self.ns.state_types[
                self.spec.fork_name_at_slot(int(signed.message.slot))
            ]
            try:
                return cls.decode(ssz)
            except Exception:
                return None
        # cold path: typed reconstruction directly (no bytes round-trip),
        # else nearest stored anchor + canonical block replay
        slot = self.store.cold_slot_for_root(state_root)
        if slot is None:
            return None
        state = self.store.get_cold_state(slot)
        if state is not None:
            return state
        anchor = self.store.replay_anchor(slot)
        base = self.store.get_cold_state(anchor)
        if base is None:
            return None
        from ..state_transition.block_replayer import BlockReplayer

        blocks = []
        for s in range(anchor + 1, slot + 1):
            summary = self.store.cold_summary_at_slot(s)
            if summary is None:
                continue
            raw_b = self.store.get_block(summary[1])
            if raw_b is None:
                continue
            fork = self.spec.fork_name_at_slot(s)
            blocks.append(self.ns.block_types[fork].decode(raw_b))
        return (
            BlockReplayer(self.spec, base).apply_blocks(blocks, slot).state
        )

    # -- block import pipeline -----------------------------------------------------

    def get_state_for_block(self, parent_root: bytes, slot: int):
        parent_state = self._states.get(parent_root)
        if parent_state is None and parent_root in self._seen_blocks:
            # restart path: a known block whose state lives only in the
            # store (e.g. the restored head) — load and re-cache it
            try:
                parent_state = self.state_by_root(parent_root)
                if parent_state is not None:
                    self._states[parent_root] = parent_state
            except Exception:  # noqa: BLE001 — treated as unknown below
                parent_state = None
        if parent_state is None:
            raise BlockError(f"unknown parent {parent_root.hex()[:16]}")
        state = parent_state.copy()
        if state.slot < slot:
            process_slots(self.spec, state, slot)
        return state

    def process_block(self, signed_block, is_first_block_in_slot: bool = True) -> bytes:
        """Full import: signature batch verify + state transition + store +
        fork choice. Returns the block root."""
        block = signed_block.message
        block_root = type(block).hash_tree_root(block)
        with self.lock, BLOCK_PROCESSING_TIMES.time():
            root = self._process_block_locked(
                signed_block, block, block_root, is_first_block_in_slot
            )
        log.debug(
            "Block imported", slot=int(block.slot), root=block_root.hex()[:16]
        )
        return root

    def _process_block_locked(
        self,
        signed_block,
        block,
        block_root,
        is_first_block_in_slot,
        check_availability: bool = True,
    ) -> bytes:
        if block_root in self._seen_blocks:
            return block_root
        if block.slot > self.current_slot():
            raise BlockError("block from the future")
        if check_availability and self.da_checker._required(signed_block):
            res = self.da_checker.put_block(block_root, signed_block)
            if res is None:
                raise BlockPendingAvailability(block_root)

        state = self.get_state_for_block(bytes(block.parent_root), block.slot)
        ctxt = ConsensusContext()
        ctxt.get_pubkey_index = self.pubkey_cache.get_index
        try:
            ctxt = per_block_processing(
                self.spec,
                state,
                signed_block,
                strategy=BlockSignatureStrategy.VERIFY_BULK,
                ctxt=ctxt,
                get_pubkey=self.pubkey_cache.get,
            )
        except (BlockProcessingError, bls.BlsError) as e:
            raise BlockError(str(e)) from None
        execution_status = self._notify_execution_layer(signed_block)
        self._import_block(
            signed_block, block_root, state, ctxt,
            is_first_block_in_slot=is_first_block_in_slot,
            execution_status=execution_status,
        )
        self._notify_block_observers(signed_block)
        return block_root

    def process_gossip_blob(self, sidecar) -> bytes | None:
        """Verify a gossiped BlobSidecar and, if it completes a parked
        block's blob set, import that block. Returns the imported block
        root, or None while components are still missing
        (process_gossip_blob -> process_availability in the reference)."""
        from ..state_transition.signature_sets import _header_signature_ok
        from ..types.containers import BeaconBlockHeader

        ns = self.ns
        self.da_checker.verify_blob_sidecar(ns, sidecar)
        hdr = sidecar.signed_block_header
        proposer_pk = self.pubkey_cache.get(int(hdr.message.proposer_index))
        if proposer_pk is None or not _header_signature_ok(
            self.spec, self.head.state, hdr, proposer_pk
        ):
            from .data_availability import BlobError

            raise BlobError("invalid blob header signature")
        res = self.da_checker.put_blob(sidecar)
        if res is None:
            return None
        blk, blobs = res
        root = BeaconBlockHeader.hash_tree_root(hdr.message)
        with self.lock:
            imported = self._process_block_locked(
                blk, blk.message, root, True, check_availability=False
            )
        # persist the sidecars beside the block (the reference's blobs DB) —
        # serves /eth/v1/beacon/blob_sidecars and BlobsByRoot RPC
        if imported is not None and blobs:
            self.store.put_blob_sidecars(
                root, [type(sc).encode(sc) for sc in blobs]
            )
        return imported

    # -- PeerDAS columns ----------------------------------------------------

    def enable_peerdas(self, cell_ctx, node_id: bytes,
                       custody_count: int | None = None,
                       samples_per_slot: int | None = None):
        """Turn on column sampling: availability for blob-carrying blocks is
        then decided by the sampler's custody + sampled column set instead
        of per-blob sidecar arrival (see ``peerdas.PeerDasSampler``)."""
        from .peerdas import PeerDasSampler

        kwargs = {}
        if custody_count is not None:
            kwargs["custody_count"] = custody_count
        if samples_per_slot is not None:
            kwargs["samples_per_slot"] = samples_per_slot
        self.cell_context = cell_ctx
        self.peerdas = PeerDasSampler(self, cell_ctx, node_id, **kwargs)
        self.da_checker.set_column_gate(self.peerdas.is_available)
        return self.peerdas

    def put_data_column(self, sidecar) -> bytes:
        """Retain a VERIFIED column sidecar, keyed by block root. All
        mutation happens under the chain lock; the cache is LRU-bounded to
        the availability checker's pending window and entries at or below
        the finalized horizon are dropped."""
        root = sidecar.signed_block_header.message.tree_root()
        with self.lock:
            cache = self.data_column_cache
            cols = cache.pop(root, None) or {}
            cols[int(sidecar.index)] = sidecar
            cache[root] = cols
            fin_slot = self.spec.start_slot(
                int(self.fork_choice.store.finalized_checkpoint[0])
            )
            for r in [
                r for r, cs in cache.items()
                if r != root and cs and all(
                    int(s.signed_block_header.message.slot) <= fin_slot
                    for s in cs.values()
                )
            ]:
                del cache[r]
            while len(cache) > self.da_checker.MAX_PENDING:
                cache.pop(next(iter(cache)))
        return root

    def data_columns_for(self, block_root: bytes) -> dict:
        """Snapshot of the held columns for one block (index -> sidecar)."""
        with self.lock:
            return dict(self.data_column_cache.get(block_root, {}))

    def _notify_execution_layer(self, signed_block):
        """engine_newPayload for merge-era blocks; maps the EL verdict onto
        fork choice's optimistic-sync statuses (block_verification.rs
        ExecutionPendingBlock -> payload_verification_status)."""
        from ..state_transition.per_block import payload_is_default

        payload = getattr(signed_block.message.body, "execution_payload", None)
        if payload is None or payload_is_default(payload):
            # pre-merge block (or pre-bellatrix fork): nothing to verify
            return ExecutionStatus.IRRELEVANT
        if self.execution_layer is None:
            return ExecutionStatus.OPTIMISTIC
        from ..execution_layer import PayloadStatus

        st = self.execution_layer.notify_new_payload(payload)
        if st.status == PayloadStatus.VALID:
            return ExecutionStatus.VALID
        if st.status in (PayloadStatus.SYNCING, PayloadStatus.ACCEPTED):
            return ExecutionStatus.OPTIMISTIC
        raise BlockError(f"execution payload invalid: {st.validation_error}")

    def process_chain_segment(self, blocks, blobs_by_root=None) -> list:
        """Batch-verify ALL signatures of a segment in one bls call, then
        apply blocks with NoVerification (signature_verify_chain_segment,
        block_verification.rs:590-636).

        ``blobs_by_root``: {block_root: [BlobSidecar]} for deneb segments —
        range sync couples blob downloads with block downloads (the
        reference's block_sidecar_coupling.rs); a block whose commitments
        have no matching verified sidecars here fails availability."""
        roots = []
        if not blocks:
            return roots
        with self.lock:
            return self._process_chain_segment_locked(
                blocks, roots, blobs_by_root or {}
            )

    @property
    def oldest_block_slot(self) -> int:
        """Slot of the oldest canonical block held (backfill progress)."""
        return self._oldest_block_slot

    @property
    def backfill_complete(self) -> bool:
        return (
            self._oldest_block_slot <= 1
            or self._oldest_block_parent == b"\x00" * 32
        )

    @property
    def anchor_block_missing(self) -> bool:
        """Checkpoint boot holds the anchor's header (inside the state) but
        not the anchor block itself; it must be fetched by root before the
        chain can serve a gap-free history."""
        return (
            self.genesis_block_root not in self._blocks
            and self._oldest_block_slot > 0
        )

    def get_signed_block(self, block_root: bytes):
        """Decoded SignedBeaconBlock by root: the in-memory hot map first,
        else the persistent store. The finalization migration drops the
        decoded copies of frozen canonical blocks from ``_blocks`` (bounding
        memory), which used to truncate ``blocks_by_range`` serving at the
        finalized horizon — a from-genesis peer could then NEVER range-sync
        past our finalized epoch (every served segment started with an
        unknown parent). Req/Resp serving must read through to the store.

        Store-decoded blocks are kept in a small bounded FIFO cache: a
        range-sync serving a long history walks the same frozen parents
        once per BlocksByRange request, and re-decoding them per request
        would make segment serving quadratic in chain length. The cache is
        separate from ``_blocks`` so the finalization migration's memory
        bound still holds."""
        sb = self._blocks.get(block_root)
        if sb is not None:
            return sb
        sb = self._cold_block_cache.get(block_root)
        if sb is not None:
            return sb
        raw = self.store.get_block(block_root)
        if raw is None:
            return None
        for fork in reversed(list(self.ns.block_types)):
            try:
                sb = self.ns.block_types[fork].decode(raw)
            except Exception:  # noqa: BLE001 — wrong fork schema: keep trying
                continue
            while len(self._cold_block_cache) >= self._COLD_BLOCK_CACHE_MAX:
                self._cold_block_cache.pop(
                    next(iter(self._cold_block_cache))
                )
            self._cold_block_cache[block_root] = sb
            return sb
        return None

    def import_anchor_block(self, signed_block) -> None:
        """Accept the checkpoint anchor block itself. No signature check
        needed: its root is pinned by the trusted checkpoint state
        (checkpoint-sync block fetch, client/src/builder.rs)."""
        with self.lock:
            root = signed_block.message.tree_root()
            if root != self.genesis_block_root:
                raise BlockError("anchor block root mismatch")
            self._blocks[root] = signed_block
            self._seen_blocks.add(root)
            self.store.put_block(root, type(signed_block).encode(signed_block))

    def import_historical_blocks(self, blocks) -> int:
        """Backwards history fill below the anchor
        (``beacon_chain/src/historical_blocks.rs``): ``blocks`` are
        consecutive ascending-slot signed blocks whose LAST element must be
        the parent of our oldest known block. Linkage is checked as a
        parent-root hash chain and all proposer signatures are verified in
        ONE batch against the pubkey cache; no state transition is run —
        finality already covers these slots. Valid blocks become servable
        history and move the backfill anchor down."""
        if not blocks:
            return 0
        from ..types.helpers import compute_domain, compute_signing_root

        with self.lock:
            roots = [sb.message.tree_root() for sb in blocks]
            if roots[-1] != self._oldest_block_parent:
                raise BlockError(
                    "backfill segment does not link to the oldest known block"
                )
            for i in range(len(blocks) - 1):
                if bytes(blocks[i + 1].message.parent_root) != roots[i]:
                    raise BlockError("backfill segment is not a hash chain")
            state = self.head.state
            gvr = bytes(state.genesis_validators_root)
            items = []
            for sb in blocks:
                epoch = self.spec.compute_epoch_at_slot(int(sb.message.slot))
                # the full fork schedule, not state.fork: backfill spans
                # arbitrarily many forks below the anchor
                domain = compute_domain(
                    self.spec.DOMAIN_BEACON_PROPOSER,
                    self.spec.fork_version_at_epoch(epoch),
                    gvr,
                )
                items.append(
                    (
                        [int(sb.message.proposer_index)],
                        compute_signing_root(sb.message, domain),
                        bytes(sb.signature),
                    )
                )
            if not self._batch_verify_items(items):
                raise BlockError("backfill segment signatures invalid")
            # the segment was validated as a unit; persist it as ONE atomic
            # frame so a crash mid-backfill never leaves a gappy history
            from ..store.kv import DBColumn

            self.store.do_atomically(
                [
                    ("put", DBColumn.BeaconBlock, root, type(sb).encode(sb))
                    for sb, root in zip(blocks, roots)
                ]
            )
            for sb, root in zip(blocks, roots):
                self._blocks[root] = sb
                self._seen_blocks.add(root)
            self._oldest_block_slot = int(blocks[0].message.slot)
            self._oldest_block_parent = bytes(blocks[0].message.parent_root)
            return len(blocks)

    def _check_segment_availability(self, sb, block_root, blobs_by_root):
        """Deneb: segment blocks with commitments need their sidecars
        verified (KZG batch + inclusion proofs) before import. With PeerDAS
        enabled the gate is the column sampler instead: the block passes
        once every custody + sampled column has been verified — the sync
        manager couples the column fetch to the block download and retries
        (block_sidecar_coupling.rs), so pending availability here is a
        retriable condition, not a bad segment."""
        required = self.da_checker._required(sb)
        if required == 0:
            return
        if self.cell_context is not None and self.peerdas is not None:
            if self.peerdas.is_available(block_root):
                return
            raise BlockPendingAvailability(block_root)
        from .data_availability import BlobError

        sidecars = blobs_by_root.get(block_root)
        if sidecars is None or len(sidecars) < required:
            raise BlockPendingAvailability(block_root)
        self.da_checker.verify_blob_sidecar_batch(self.ns, sidecars)
        comms = sb.message.body.blob_kzg_commitments
        by_index = {int(sc.index): sc for sc in sidecars}
        for i in range(required):
            sc = by_index.get(i)
            if sc is None or bytes(sc.kzg_commitment) != bytes(comms[i]):
                raise BlobError(f"segment blob {i} missing or mismatched")

    # the looped write below is each block's blob sidecars AFTER that
    # block's atomic import: one single-key put per block, independent per
    # block (a crash between two blocks' sidecar writes tears nothing; a
    # missing sidecar set re-arrives via sync)
    # lint: allow(torn-write)
    def _process_chain_segment_locked(self, blocks, roots, blobs_by_root) -> list:
        from ..state_transition.per_block import BlockSignatureVerifier

        # deneb availability first: fail the segment before any expensive work
        for sb in blocks:
            block_root = type(sb.message).hash_tree_root(sb.message)
            self._check_segment_availability(sb, block_root, blobs_by_root)

        # thread ONE state through the segment: collect each block's signature
        # sets against its pre-state, apply the transition unverified, and
        # only import after the whole segment's batch verifies
        first = blocks[0].message
        state = self.get_state_for_block(bytes(first.parent_root), first.slot)
        all_sets = []
        prepared = []
        try:
            for sb in blocks:
                block = sb.message
                if state.slot < block.slot:
                    process_slots(self.spec, state, block.slot)
                v = BlockSignatureVerifier(self.spec, state, self.pubkey_cache.get)
                ctxt = ConsensusContext()
                ctxt.get_pubkey_index = self.pubkey_cache.get_index
                v.include_all_signatures(sb, ctxt)
                all_sets.extend(v.sets)
                per_block_processing(
                    self.spec, state, sb,
                    strategy=BlockSignatureStrategy.NO_VERIFICATION,
                    ctxt=ctxt,
                )
                prepared.append((sb, state.copy(), ctxt))
        except (BlockProcessingError, bls.BlsError) as e:
            raise BlockError(str(e)) from None
        if not bls.verify_signature_sets(all_sets):
            raise BlockError("chain segment signature verification failed")
        for sb, post_state, ctxt in prepared:
            block = sb.message
            root = type(block).hash_tree_root(block)
            self._import_block(
                sb, root, post_state, ctxt,
                execution_status=self._notify_execution_layer(sb),
            )
            # range-synced blocks carry slashing evidence too (the slasher
            # subscription must see every import path, not just gossip)
            self._notify_block_observers(sb)
            sidecars = blobs_by_root.get(root)
            if sidecars:
                self.store.put_blob_sidecars(
                    root, [type(sc).encode(sc) for sc in sidecars]
                )
            roots.append(root)
        return roots

    def _justified_balances(self, justified_root: bytes, fallback_state):
        """Effective balances of validators active at the justified epoch,
        zero otherwise (BeaconForkChoiceStore/JustifiedBalances parity).
        The active set is the state's per-epoch memo, not a registry scan."""
        from ..state_transition import get_active_validator_indices

        state = self._states.get(justified_root, fallback_state)
        epoch = get_current_epoch(self.spec, state)
        n = len(state.validators)
        effective = np.fromiter(
            (v.effective_balance for v in state.validators), np.uint64, n
        )
        out = np.zeros(n, dtype=np.uint64)
        active = get_active_validator_indices(state, epoch).astype(np.int64)
        out[active] = effective[active]
        return out

    def _import_block(
        self, signed_block, block_root, state, ctxt,
        is_first_block_in_slot: bool = True,
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
    ) -> None:
        block = signed_block.message
        self.pubkey_cache.import_new_pubkeys(state)
        # the block-import persistence barrier: block + post-state + slot
        # summary as ONE atomic frame (a kill mid-import can never leave a
        # block whose post-state is missing, or vice versa)
        # both import paths ran per_block_processing with verify_block_root,
        # which held the post-state root equal to the block's: no second hash
        self.store.atomic_block_import(
            block_root,
            type(signed_block).encode(signed_block),
            bytes(block.state_root),
            type(state).encode(state),
            int(state.slot),
        )
        self._states[block_root] = state
        self._blocks[block_root] = signed_block
        self._seen_blocks.add(block_root)

        self.fork_choice.on_block(
            self.current_slot(),
            block,
            block_root,
            state,
            justified_balances=self._justified_balances(
                bytes(state.current_justified_checkpoint.root), state
            ),
            execution_status=execution_status,
            is_first_block_in_slot=is_first_block_in_slot,
        )
        # apply the block's attestations to fork choice (import_block does)
        for indexed in ctxt.indexed_attestations.values():
            try:
                self.fork_choice.on_attestation(
                    self.current_slot(), indexed, is_from_block=True
                )
            except Exception:
                pass
        self.recompute_head()
        # fork-choice persistence barrier (persisted_fork_choice.rs runs on
        # every import too): a crash after this point restarts at THIS head;
        # a crash between the block batch and here restarts one block back
        # and re-imports it from gossip/sync — never from genesis
        if self._durable:
            self.persist_fork_choice()

    def persist_fork_choice(self) -> None:
        """Snapshot fork choice into the store's metadata bucket (the
        restart-from-disk anchor). Runs under the chain lock on the import
        path; also the shutdown path's persistence hook."""
        from ..fork_choice import persistence as fc_persist

        fc_persist.persist(self.store, self.fork_choice)

    # -- attestations ---------------------------------------------------------------

    def _known_ancestor_at_slot(self, root: bytes, slot: int) -> bytes | None:
        """Fork-choice ancestor walk for the attester-cache decision key;
        None for blocks fork choice does not know (cache unusable)."""
        if root not in self.fork_choice.proto.indices:
            return None
        return self.fork_choice._ancestor_at_slot(root, slot)

    def _state_for_committee(self, block_root: bytes, slot: int):
        """Shuffling-cache miss path: a state of the attestation's chain
        advanced to its slot (the pre-cache full-state behavior)."""
        state = self._states.get(bytes(block_root))
        if state is None:
            return None
        if state.slot < slot:
            state = state.copy()
            process_slots(self.spec, state, slot)
        return state

    def _committee_and_indexed(self, att):
        """(committee, indexed attestation) with ONE committee lookup
        through the attester-cache tier — no state clone or slot advance on
        the hot path. Electra committee_bits attestations (multi-committee)
        take the full-state path."""
        if hasattr(att, "committee_bits"):
            state = self._attestation_state(att)
            from ..state_transition import get_beacon_committee

            committee = get_beacon_committee(
                self.spec, state, int(att.data.slot), int(att.data.index)
            )
            return committee, get_indexed_attestation(self.spec, state, att)
        committee = self.attester_cache.committee_for(att.data)
        if committee is None:
            raise AttestationError("unknown beacon block root")
        bits = np.asarray(att.aggregation_bits, dtype=bool)
        if bits.size != committee.size:
            raise AttestationError(
                "aggregation bits length != committee size"
            )
        indexed = self.ns.IndexedAttestation(
            attesting_indices=sorted(int(i) for i in committee[bits]),
            data=att.data,
            signature=att.signature,
        )
        return committee, indexed

    def _indexed_attestation_fast(self, att):
        return self._committee_and_indexed(att)[1]

    def _attester_item_fast(self, indexed):
        """(indices, signing root, signature bytes) from the cache tier's
        state-free domain (schedule fork version + genesis validators root
        — identical to get_domain for any on-schedule state)."""
        return (
            [int(i) for i in indexed.attesting_indices],
            self.attester_cache.signing_root(indexed.data),
            bytes(indexed.signature),
        )

    def _batch_verify_items(self, items) -> bool:
        """Verify (validator_indices, message, signature_bytes) triples as one
        RLC batch. On the device backend this is the fully-fused device path:
        cache gather + device h2c + device signature decompression, zero
        per-batch oracle-point conversion. Other backends go through the
        generic SignatureSet seam.

        Every backend call runs inside the ``bls_device`` fault domain
        (resilience.supervisor): watchdog deadline, bounded transient
        retries, and the degradation ladder full device shape -> halved
        batch shape (-> pure-Python oracle, for a pubkey cache on the CPU
        or a backend other than "device"). A batch whose every rung faults
        fails CLOSED (False -> bisection -> per-group rejection): work may
        be dropped and counted, but nothing is ever falsely verified."""
        if not items:
            return False
        from ..resilience import SupervisedFault

        with ATTESTATION_BATCH_VERIFY_TIMES.time():
            try:
                return self._batch_verify_items_inner(items)
            except SupervisedFault:
                return False  # every rung faulted (recorded): fail closed

    def _mesh_planner(self):
        """The sharded serving tier for this chain, or None when the mesh
        is off (``LIGHTHOUSE_MESH_DEVICES`` unset/1 — the single-device
        path stays bit-identical to the pre-mesh engine). Resolved once;
        the verifier itself holds no state, so it is shared by the batch
        paths and the firehose threads."""
        if self._mesh_planner_state == "unset":
            with self._mesh_planner_lock:
                if self._mesh_planner_state == "unset":
                    self._mesh_planner_state = self._build_mesh_planner()
        return self._mesh_planner_state

    def _build_mesh_planner(self):
        """None: the mesh is off, the only state the port has until the
        sharded serving tier comes with multi-GPU serving (ROADMAP Queue 1
        item 6)."""
        return None

    def _batch_verify_items_inner(self, items) -> bool:
        from ..resilience import bls_supervisor

        mesh = self._mesh_planner()
        if mesh is not None:
            # the mesh verifier carries its own fault-domain ladder —
            # wrapping it in the bls_device supervisor too would double-wrap
            return mesh.verify_items(items)
        sup = bls_supervisor()
        if bls.get_backend() == "device":
            from ..bls import backend as tb

            # the cache (and with it the device) is resolved before the
            # supervised region: a missing card raises instead of being
            # taken for a device fault and demoted to the oracle
            cache = self.pubkey_cache.device_array()

            def verify(its):
                return tb.verify_indexed_sets_device(cache, its, device=cache.device)

            def full():
                return verify(items)

            def reduced():
                # halved n-bucket: the OOM rung — everything still verifies,
                # in two smaller fixed-shape dispatches
                mid = (len(items) + 1) // 2
                if mid == len(items):
                    return verify(items)
                return verify(items[:mid]) and verify(items[mid:])

            rungs = [("device_full", full), ("device_reduced", reduced)]
            if cache.device.type == "cpu":
                # a card's fault is never handed to the CPU: with the cache
                # on a card the ladder ends at device_reduced and fails closed
                rungs.append(("cpu_oracle", lambda: self._verify_items_via_sets(
                    items, oracle=True
                )))
            return sup.run_ladder("bls.batch_verify", rungs)
        return sup.run_ladder(
            "bls.batch_verify",
            (
                ("primary", lambda: self._verify_items_via_sets(items)),
                ("cpu_oracle", lambda: self._verify_items_via_sets(
                    items, oracle=True
                )),
            ),
        )

    def _verify_items_via_sets(self, items, oracle: bool = False) -> bool:
        """The generic SignatureSet path for item triples; ``oracle=True``
        pins the pure-Python oracle (the ladder's device-free last rung)."""
        sets = []
        for indices, msg, sig_bytes in items:
            try:
                keys = [self.pubkey_cache.get(int(i)) for i in indices]
                if not keys or any(k is None for k in keys):
                    return False
                sets.append(
                    bls.SignatureSet.multiple_pubkeys(
                        bls.Signature.from_bytes(sig_bytes), keys, msg
                    )
                )
            except bls.BlsError:
                return False
        if oracle:
            return bls.verify_signature_sets_oracle(sets)
        return bls.verify_signature_sets(sets)

    def _attester_item(self, state, indexed):
        """(indices, signing root, signature bytes) for an indexed attestation."""
        from ..types.helpers import compute_signing_root, get_domain

        domain = get_domain(
            self.spec, state, self.spec.DOMAIN_BEACON_ATTESTER,
            epoch=indexed.data.target.epoch,
        )
        root = compute_signing_root(indexed.data, domain)
        return (
            [int(i) for i in indexed.attesting_indices],
            root,
            bytes(indexed.signature),
        )

    def verify_unaggregated_attestations(self, attestations) -> list:
        """Batch gossip verification: one signature set per attestation, one
        bls batch; a poisoned batch is isolated by bisection (split-and-retry,
        firehose/bisect.py) instead of n per-set re-verifies
        (batch_verify_unaggregated_attestations, batch.rs:133-211).
        Committee resolution rides the attester-cache tier — no state clone
        on the hot path. Returns list of (attestation, indexed | error)."""
        from ..firehose.bisect import bisect_verify

        prepared = []
        with ATTESTATION_BATCH_SETUP_TIMES.time():
            for att in attestations:
                try:
                    indexed = self._indexed_attestation_fast(att)
                    item = self._attester_item_fast(indexed)
                    prepared.append((att, indexed, item))
                except Exception as e:
                    prepared.append((att, AttestationError(str(e)), None))
        items = [p[2] for p in prepared if p[2] is not None]
        results = []
        if items and self._batch_verify_items(items):
            for att, indexed, _ in prepared:
                results.append((att, indexed))
        else:
            # poisoned batch: bisection isolates the bad set(s) in
            # O(bad * log n) batched calls with exact error fidelity
            verdicts = iter(
                bisect_verify(
                    [[item] for item in items],
                    self._batch_verify_items,
                    assume_failed=bool(items),
                )
            )
            for att, indexed, item in prepared:
                if item is None:
                    results.append((att, indexed))
                elif next(verdicts):
                    results.append((att, indexed))
                else:
                    results.append(
                        (att, AttestationError("invalid attestation signature"))
                    )
        with self.lock:
            for att, indexed in results:
                if not isinstance(indexed, Exception):
                    try:
                        self.fork_choice.on_attestation(
                            self.current_slot(), indexed
                        )
                    except Exception:
                        pass
                    self.naive_aggregation_pool.insert(att)
                    self._notify_attestation_observers(indexed)
            # prune under the same lock that serializes inserts — gossip
            # workers and HTTP threads call this path concurrently
            self.naive_aggregation_pool.prune(self.current_slot())
        return results

    def _prepare_aggregate(self, sap):
        """Signature-set group (selection proof, envelope, attester set) for
        one SignedAggregateAndProof via the attester-cache tier — raises
        AttestationError on any pre-crypto rejection."""
        from ..ssz import uint64 as ssz_u64
        from ..types.containers import SigningData
        from ..types.helpers import compute_signing_root

        agg = sap.message
        att = agg.aggregate
        committee, indexed = self._committee_and_indexed(att)
        aggor = int(agg.aggregator_index)
        if self.pubkey_cache.get(aggor) is None:
            raise AttestationError("unknown aggregator index")
        # spec is_aggregator: the selection proof must actually
        # select this validator for the committee (the signature
        # check alone lets ANY committee member aggregate)
        import hashlib as _hl

        if aggor not in [int(v) for v in committee]:
            raise AttestationError("aggregator not in committee")
        modulo = max(
            1,
            committee.size // self.spec.target_aggregators_per_committee,
        )
        digest = _hl.sha256(bytes(agg.selection_proof)).digest()
        if int.from_bytes(digest[0:8], "little") % modulo != 0:
            raise AttestationError("selection proof does not select")
        epoch = self.spec.compute_epoch_at_slot(att.data.slot)
        root_sel = SigningData(
            object_root=ssz_u64.hash_tree_root(att.data.slot),
            domain=self._domain_at(self.spec.DOMAIN_SELECTION_PROOF, epoch),
        ).tree_root()
        root_ap = compute_signing_root(
            agg, self._domain_at(self.spec.DOMAIN_AGGREGATE_AND_PROOF, epoch)
        )
        items = [
            ([aggor], root_sel, bytes(agg.selection_proof)),
            ([aggor], root_ap, bytes(sap.signature)),
            self._attester_item_fast(indexed),
        ]
        return indexed, items

    def _domain_at(self, domain_type: bytes, epoch: int) -> bytes:
        """State-free signing domain from the fork schedule + genesis
        validators root (equals get_domain for on-schedule states)."""
        from ..types.helpers import compute_domain

        return compute_domain(
            domain_type,
            self.spec.fork_version_at_epoch(int(epoch)),
            self.attester_cache.genesis_validators_root,
        )

    def verify_aggregated_attestations(self, signed_aggregates) -> list:
        """Gossip aggregate verification: THREE signature sets per
        SignedAggregateAndProof — selection proof, aggregate-and-proof
        envelope, and the indexed attestation — batched across aggregates;
        a poisoned batch bisects down to the bad aggregate group(s)
        (batch_verify_aggregated_attestations, batch.rs:28-113).
        Returns list of (signed_aggregate, indexed | error)."""
        from ..firehose.bisect import bisect_verify

        prepared = []
        for sap in signed_aggregates:
            try:
                indexed, items = self._prepare_aggregate(sap)
                prepared.append((sap, indexed, items))
            except Exception as e:
                prepared.append((sap, AttestationError(str(e)), None))
        groups = [its for _, _, its in prepared if its]
        all_items = [it for g in groups for it in g]
        results = []
        if all_items and self._batch_verify_items(all_items):
            for sap, indexed, _ in prepared:
                results.append((sap, indexed))
        else:
            verdicts = iter(
                bisect_verify(
                    groups, self._batch_verify_items,
                    assume_failed=bool(all_items),
                )
            )
            for sap, indexed, its in prepared:
                if its is None:
                    results.append((sap, indexed))
                elif next(verdicts):
                    results.append((sap, indexed))
                else:
                    results.append(
                        (sap, AttestationError("invalid aggregate signature"))
                    )
        with self.lock:
            for sap, indexed in results:
                if not isinstance(indexed, Exception):
                    try:
                        self.fork_choice.on_attestation(
                            self.current_slot(), indexed
                        )
                    except Exception:
                        pass
                    self._notify_attestation_observers(indexed)
        return results

    # -- firehose (streaming gossip verification) ---------------------------------

    def create_firehose(self, config=None, synchronous: bool = False):
        """Streaming verification engine for the gossip firehose: adaptive
        batching + double-buffered host/device pipeline + back-pressure,
        with the host stage wired to the attester-cache tier and the device
        stage to the batched BLS backend with bisection fallback
        (firehose/engine.py). Handles BOTH firehose-eligible payload kinds:
        unaggregated Attestations (one set) and SignedAggregateAndProofs
        (three sets); verdicts apply to fork choice / the naive pool
        exactly like the verify_* batch paths.

        Fault-domain note: the verify stage IS ``_batch_verify_items``,
        which already runs inside the ``bls_device`` supervisor (watchdog,
        retries, degradation ladder, failing closed) — the
        engine is deliberately built WITHOUT its own supervisor so device
        calls are never double-wrapped."""
        from ..firehose import FirehoseEngine

        def prepare(payloads):
            out = []
            for p in payloads:
                try:
                    if hasattr(p, "message"):  # SignedAggregateAndProof
                        indexed, items = self._prepare_aggregate(p)
                        out.append((items, indexed))
                    else:
                        indexed = self._indexed_attestation_fast(p)
                        out.append(
                            ([self._attester_item_fast(indexed)], indexed)
                        )
                except Exception as e:  # noqa: BLE001 — pre-crypto rejection
                    out.append(AttestationError(str(e)))
            return out

        engine = FirehoseEngine(
            prepare_fn=prepare,
            verify_items_fn=self._batch_verify_items,
            config=config,
            synchronous=synchronous,
            # sharded serving tier (None when the mesh is off): per-shard
            # sub-batches with prep-thread H2D staging, per-shard verdicts,
            # per-shard fault domains — aggregates stream through it as
            # atomic 3-set groups exactly like single-set attestations
            shard_planner=self._mesh_planner(),
        )
        engine.default_callback = self._apply_verified_attestation
        return engine

    def _apply_verified_attestation(self, payload, ok: bool, indexed) -> None:
        """Post-verdict application for firehose-verified gossip work (the
        tail of the verify_* batch paths). Unaggregated attestations also
        merge into the naive aggregation pool; the pool is pruned at most
        once per slot (not per item — the stream path is hot)."""
        if not ok or indexed is None:
            return
        with self.lock:
            try:
                self.fork_choice.on_attestation(self.current_slot(), indexed)
            except Exception:
                pass
            if not hasattr(payload, "message"):  # unaggregated Attestation
                self.naive_aggregation_pool.insert(payload)
            self._notify_attestation_observers(indexed)
            slot = self.current_slot()
            if slot != self._naive_pool_pruned_slot:
                self._naive_pool_pruned_slot = slot
                self.naive_aggregation_pool.prune(slot)

    # -- sync committee messages (sync_committee_verification.rs) ----------

    def _sync_signing_root(self, state, slot: int, beacon_block_root: bytes):
        from ..types.helpers import sync_committee_signing_root

        return sync_committee_signing_root(
            self.spec, state, slot, beacon_block_root
        )

    def sync_committee_positions(self, state, validator_index: int) -> list[int]:
        if not 0 <= int(validator_index) < len(state.validators):
            return []
        pk = bytes(state.validators[int(validator_index)].pubkey)
        return [
            i
            for i, cpk in enumerate(state.current_sync_committee.pubkeys)
            if bytes(cpk) == pk
        ]

    def verify_sync_committee_messages(self, messages) -> list:
        """Batch gossip verification of SyncCommitteeMessages; on success the
        message is merged into the sync contribution pool. Returns
        (message, committee_positions | error) pairs
        (verify_sync_committee_message_for_gossip + the naive pool insert)."""
        state = self.head.state
        prepared = []
        for msg in messages:
            try:
                positions = self.sync_committee_positions(
                    state, int(msg.validator_index)
                )
                if not positions:
                    raise AttestationError("not in current sync committee")
                root = self._sync_signing_root(
                    state, int(msg.slot), bytes(msg.beacon_block_root)
                )
                item = ([int(msg.validator_index)], root, bytes(msg.signature))
                prepared.append((msg, positions, item))
            except AttestationError as e:
                prepared.append((msg, e, None))
        items = [p[2] for p in prepared if p[2] is not None]
        results = []
        if items and self._batch_verify_items(items):
            for msg, positions, _ in prepared:
                results.append((msg, positions))
        else:
            for msg, positions, item in prepared:
                if item is None:
                    results.append((msg, positions))
                elif self._batch_verify_items([item]):
                    results.append((msg, positions))
                else:
                    results.append(
                        (msg, AttestationError("invalid sync signature"))
                    )
        for msg, verdict in results:
            if not isinstance(verdict, Exception):
                self.sync_contribution_pool.insert_message(
                    int(msg.slot), bytes(msg.beacon_block_root), verdict,
                    bytes(msg.signature),
                )
        return results

    def verify_sync_contributions(self, signed_contributions) -> list:
        """Gossip verification of SignedContributionAndProofs — THREE sets
        each (selection proof, contribution-and-proof envelope, and the
        subcommittee aggregate), batched with per-item fallback
        (sync_committee_verification.rs contribution path). Verified
        contributions merge into the sync contribution pool."""
        from ..types.helpers import compute_signing_root, get_domain

        state = self.head.state
        sub_size = self.spec.preset.SYNC_COMMITTEE_SIZE // 4
        prepared = []
        for sc in signed_contributions:
            try:
                cp = sc.message
                contribution = cp.contribution
                aggor = int(cp.aggregator_index)
                if self.pubkey_cache.get(aggor) is None:
                    raise AttestationError("unknown aggregator index")
                sub = int(contribution.subcommittee_index)
                if sub >= 4:
                    raise AttestationError("subcommittee index out of range")
                epoch = self.spec.compute_epoch_at_slot(int(contribution.slot))
                sel_data = self.ns.SyncAggregatorSelectionData(
                    slot=int(contribution.slot), subcommittee_index=sub
                )
                dom_sel = get_domain(
                    self.spec, state,
                    self.spec.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
                    epoch=epoch,
                )
                root_sel = compute_signing_root(sel_data, dom_sel)
                dom_cp = get_domain(
                    self.spec, state, self.spec.DOMAIN_CONTRIBUTION_AND_PROOF,
                    epoch=epoch,
                )
                root_cp = compute_signing_root(cp, dom_cp)
                # participants: committee seats in this subcommittee at the
                # set bits, resolved to validator indices via the pubkey cache
                bits = np.asarray(contribution.aggregation_bits, dtype=bool)
                indices = []
                for pos, bit in enumerate(bits):
                    if not bit:
                        continue
                    pk = bytes(
                        state.current_sync_committee.pubkeys[
                            sub * sub_size + pos
                        ]
                    )
                    idx = self.pubkey_cache.get_index(pk)
                    if idx is None:
                        raise AttestationError("unknown committee pubkey")
                    indices.append(idx)
                if not indices:
                    raise AttestationError("empty contribution")
                root_msg = self._sync_signing_root(
                    state, int(contribution.slot),
                    bytes(contribution.beacon_block_root),
                )
                items = [
                    ([aggor], root_sel, bytes(cp.selection_proof)),
                    ([aggor], root_cp, bytes(sc.signature)),
                    (indices, root_msg, bytes(contribution.signature)),
                ]
                prepared.append((sc, items))
            except AttestationError as e:
                prepared.append((sc, e))
        all_items = [it for _, its in prepared if not isinstance(its, Exception) for it in its]
        results = []
        if all_items and self._batch_verify_items(all_items):
            for sc, its in prepared:
                results.append(
                    (sc, its if isinstance(its, Exception) else True)
                )
        else:
            for sc, its in prepared:
                if isinstance(its, Exception):
                    results.append((sc, its))
                elif self._batch_verify_items(its):
                    results.append((sc, True))
                else:
                    results.append(
                        (sc, AttestationError("invalid contribution signature"))
                    )
        for sc, verdict in results:
            if not isinstance(verdict, Exception):
                self.sync_contribution_pool.insert_contribution(
                    sc.message.contribution
                )
        return results

    def _attestation_state(self, att):
        root = bytes(att.data.beacon_block_root)
        state = self._states.get(root)
        if state is None:
            raise AttestationError("unknown beacon block root")
        if state.slot < att.data.slot:
            state = state.copy()
            process_slots(self.spec, state, att.data.slot)
        return state

    # -- head ------------------------------------------------------------------------

    def recompute_head(self) -> bytes:
        with self.lock:
            return self._recompute_head_locked()

    def _recompute_head_locked(self) -> bytes:
        with FORK_CHOICE_GET_HEAD_TIMES.time():
            head_root = self.fork_choice.get_head(self.current_slot())
        self.sync_contribution_pool.prune(self.current_slot())
        self._maybe_migrate()
        if head_root != self.head.root:
            state = self._states.get(head_root)
            if state is None:
                # restart path: the restored fork choice can point at a head
                # whose state lives only in the store (persisted_fork_choice)
                try:
                    state = self.state_by_root(head_root)
                except Exception:  # noqa: BLE001 — keep the old head
                    state = None
            if state is not None:
                self.head = ChainHead(
                    root=head_root, slot=state.slot, state=state
                )
                try:
                    self.early_attester_cache.prime(self.spec, head_root, state)
                except Exception:  # noqa: BLE001 — cache priming best-effort
                    self.early_attester_cache.evict()
                self._emit_event(
                    "head",
                    lambda: {
                        "slot": str(int(state.slot)),
                        "block": "0x" + head_root.hex(),
                        # the head block commits to its post-state root —
                        # no re-merkleization under the chain lock
                        "state": "0x"
                        + bytes(
                            state.latest_block_header.state_root
                        ).hex(),
                    },
                )
        return self.head.root

    def _maybe_migrate(self) -> None:
        """Freeze + prune when finalization advances (migrate.rs trigger)."""
        fin_epoch, fin_root = self.fork_choice.store.finalized_checkpoint
        fin_slot = self.spec.start_slot(int(fin_epoch))
        if fin_slot > self.migrator.last_finalized_slot and fin_root in self._states:
            self.migrator.process_finalization(self, bytes(fin_root), fin_slot)
            self._emit_event(
                "finalized_checkpoint",
                lambda: {
                    "epoch": str(int(fin_epoch)),
                    "block": "0x" + bytes(fin_root).hex(),
                },
            )

    # -- production -------------------------------------------------------------------

    def _produce_payload(self, state, slot: int, fork: str):
        """engine_forkchoiceUpdated(attributes) -> engine_getPayload — the
        production half of the engine API (execution_layer get_payload flow).
        Returns None pre-merge (default payload stands in)."""
        from ..execution_layer.engine import PayloadAttributes
        from ..state_transition.per_block import (
            compute_timestamp_at_slot,
            is_merge_transition_complete,
            _expected_withdrawals_list,
        )
        from ..state_transition import get_randao_mix
        from ..types.spec import fork_at_least

        if not is_merge_transition_complete(state):
            return None  # pre-merge: the default payload is the right body
        head_hash = bytes(state.latest_execution_payload_header.block_hash)
        withdrawals = (
            _expected_withdrawals_list(self.spec, state)
            if fork_at_least(fork, "capella")
            else None
        )
        attrs = PayloadAttributes(
            timestamp=compute_timestamp_at_slot(self.spec, state, slot),
            prev_randao=get_randao_mix(
                self.spec, state, get_current_epoch(self.spec, state)
            ),
            suggested_fee_recipient=b"\x00" * 20,
            withdrawals=withdrawals,
            # deneb+: V3 attributes carry the parent beacon block root
            parent_beacon_block_root=(
                bytes(state.latest_block_header.tree_root())
                if fork_at_least(fork, "deneb")
                else None
            ),
        )
        # the engine wants an EXECUTION hash for finalizedBlockHash, not the
        # beacon checkpoint root (zeros when the finalized block is unknown
        # or pre-merge — the engine-API's defined "none" value)
        finalized = b"\x00" * 32
        fin_block = self._blocks.get(bytes(state.finalized_checkpoint.root))
        if fin_block is not None:
            fin_payload = getattr(
                fin_block.message.body, "execution_payload", None
            )
            if fin_payload is not None:
                finalized = bytes(fin_payload.block_hash)
        _status, payload_id = self.execution_layer.forkchoice_updated(
            head_hash, finalized, attrs
        )
        if payload_id is None:
            return None
        return self.execution_layer.get_payload(
            payload_id, self.ns.payload_types[fork]
        )

    def produce_block_on_state(self, state, slot, randao_reveal, attestations=None,
                               graffiti: bytes = b"\x00" * 32, op_pool=None):
        spec = self.spec
        state = state.copy()
        if state.slot < slot:
            process_slots(spec, state, slot)
        proposer = get_beacon_proposer_index(spec, state)
        parent_root = state.latest_block_header.tree_root()
        fork = spec.fork_name_at_epoch(get_current_epoch(spec, state))
        body_cls = self.ns.body_types[fork]
        block_cls = self.ns.block_types[fork]
        body_fields = {n for n, _ in body_cls.FIELDS}
        sync_aggregate = None
        if "sync_aggregate" in body_fields:
            # altair+: best pooled aggregate for the parent root at slot-1,
            # else the empty INFINITY aggregate (a zero default signature is
            # not a valid empty aggregate, blst INFINITY convention)
            sync_aggregate = self.sync_contribution_pool.get_sync_aggregate(
                self.ns, slot - 1, parent_root
            )
        eth1_data = state.eth1_data
        deposits = []
        if self.eth1_service is not None:
            eth1_data = self.eth1_service.eth1_data_vote(state)
            # deposits must match the eth1_data the block's own processing
            # ends up with: process_eth1_data may adopt OUR vote mid-block
            # when it reaches the period majority (eth1_chain.rs computes
            # against the post-vote data for exactly this reason)
            votes = list(state.eth1_data_votes) + [eth1_data]
            period = spec.preset.slots_per_eth1_voting_period
            adopted = (
                eth1_data
                if sum(1 for v in votes if v == eth1_data) * 2 > period
                else state.eth1_data
            )
            deposits = self.eth1_service.deposits_for_inclusion(
                state, eth1_data=adopted
            )
        body_kwargs = dict(
            randao_reveal=randao_reveal,
            eth1_data=eth1_data,
            graffiti=graffiti,
            attestations=attestations or [],
            deposits=deposits,
        )
        if sync_aggregate is not None:
            body_kwargs["sync_aggregate"] = sync_aggregate
        if (
            "execution_payload" in body_fields
            and self.execution_layer is not None
        ):
            payload = self._produce_payload(state, slot, fork)
            if payload is not None:
                body_kwargs["execution_payload"] = payload
        if op_pool is not None:
            # pooled slashing evidence + exits (+ capella credential
            # rotations) ride the block (get_slashings_and_exits,
            # operation_pool/src/lib.rs:388)
            proposer_sl, attester_sl, exits = op_pool.get_slashings_and_exits(
                state
            )
            body_kwargs["proposer_slashings"] = proposer_sl
            body_kwargs["attester_slashings"] = attester_sl
            body_kwargs["voluntary_exits"] = exits
            if "bls_to_execution_changes" in body_fields:
                body_kwargs["bls_to_execution_changes"] = (
                    op_pool.get_bls_to_execution_changes(state)
                )
        body = body_cls(**body_kwargs)
        inner_cls = dict(block_cls.FIELDS)["message"]
        block = inner_cls(
            slot=slot, proposer_index=proposer, parent_root=parent_root,
            state_root=b"\x00" * 32, body=body,
        )
        trial = state.copy()
        per_block_processing(
            spec, trial, block_cls(message=block, signature=b"\x00" * 96),
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            verify_block_root=False,
        )
        block.state_root = trial.tree_root()
        return block, trial
