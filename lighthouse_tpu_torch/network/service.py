"""BeaconNodeService: one in-process node (chain + processor + router + sync).

The glue the reference spreads across ``NetworkService::spawn``
(``network/src/service.rs``) and ``NetworkBeaconProcessor``
(``network_beacon_processor/mod.rs``): gossip handlers feed the chain through
the prioritized processor queues (batch closures included so attestation
batches hit the batched BLS path), RPC serves Status/BlocksByRange from the
chain, and unknown-parent blocks kick the sync manager.

On the port a node has a device (``device=``, resolved by
``device.resolve_device``: CUDA when none is given, raising without it). A
chain built here from a genesis or checkpoint state keeps its pubkey cache
there; a prebuilt chain must already live there. Every signature batch the
network feeds the chain (gossip, segments, backfill, sync-committee
messages) and every column verify then runs on that device.
"""

from __future__ import annotations

from ..beacon_chain.chain import BeaconChain, BlockError
from ..beacon_chain.pubkey_cache import ValidatorPubkeyCache
from ..beacon_processor.processor import BeaconProcessor, BeaconProcessorConfig
from ..device import resolve_device
from ..loadshed import LoadMonitor
from ..op_pool import OperationPool
from ..types.helpers import compute_fork_digest
from .router import Router
from .sync import SyncManager
from .transport import Status, Topic, Transport


def _same_device(a, b) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class BeaconNodeService:
    def __init__(
        self,
        node_id: str,
        spec,
        genesis_state=None,
        transport: Transport = None,
        slot_clock=None,
        execution_layer=None,
        chain: BeaconChain | None = None,
        op_pool: OperationPool | None = None,
        device=None,
    ):
        if transport is None:
            raise ValueError("BeaconNodeService requires a transport")
        if chain is None and genesis_state is None:
            raise ValueError("pass either a prebuilt chain or a genesis state")
        self.device = resolve_device(device)
        if chain is not None and not _same_device(
            chain.pubkey_cache.device, self.device
        ):
            raise ValueError(
                f"the chain's pubkey cache is on {chain.pubkey_cache.device}, "
                f"the node on {self.device}"
            )
        self.node_id = node_id
        self.transport = transport
        # a prebuilt chain (the ClientBuilder path) or a fresh one (tests)
        self.chain = chain or BeaconChain(
            spec, genesis_state, slot_clock=slot_clock,
            execution_layer=execution_layer,
            pubkey_cache=ValidatorPubkeyCache(self.device),
        )
        self.processor = BeaconProcessor(
            BeaconProcessorConfig(), synchronous=True
        )
        self.op_pool = op_pool or OperationPool(spec, self.chain.ns.Attestation)
        # overload-protection tier: one monitor folds processor queue
        # depths, drop rates, and resilience-ladder state into an
        # admission level shared by the HTTP API and Req/Resp surfaces
        from ..resilience import snapshot_all

        self.load_monitor = LoadMonitor()
        self.load_monitor.attach_processor(self.processor)
        self.load_monitor.attach_supervisors(snapshot_all)
        if getattr(transport, "load_monitor", "absent") is None:
            # socket transports expose the slot; the shared loopback
            # transport (many nodes, one object) must not be clobbered
            transport.load_monitor = self.load_monitor
        self.router = Router(self)
        # loopback runs sync inline (the deterministic simulator contract);
        # socket stacks get the dedicated sync worker thread
        from .transport import LoopbackTransport

        self.sync = SyncManager(
            self, threaded=not isinstance(transport, LoopbackTransport)
        )
        transport.register(node_id, self)

    def stop(self) -> None:
        """Shut down the sync worker before the transport so no sync round
        runs against closed sockets."""
        self.sync.stop()
        stop = getattr(self.transport, "stop", None)
        if stop is not None:
            stop()

    # -- transport-facing --------------------------------------------------

    def on_gossip(self, topic: str, message, from_peer: str) -> None:
        self.router.on_gossip(topic, message, from_peer)

    def on_rpc(self, method: str, payload, from_peer: str):
        return self.router.on_rpc(method, payload, from_peer)

    def local_status(self) -> Status:
        head = self.chain.head
        st = head.state
        return Status(
            fork_digest=compute_fork_digest(
                bytes(st.fork.current_version),
                bytes(st.genesis_validators_root),
            ),
            finalized_root=bytes(st.finalized_checkpoint.root),
            finalized_epoch=int(st.finalized_checkpoint.epoch),
            head_root=head.root,
            head_slot=head.slot,
        )

    def connect(self, peer: str) -> None:
        """Status handshake with a peer (network service dial path)."""
        theirs = self.transport.request(
            self.node_id, peer, "status", self.local_status()
        )
        self.sync.on_peer_status(peer, theirs)

    # -- gossip publication ------------------------------------------------

    def publish_block(self, signed_block) -> None:
        self.transport.publish(self.node_id, Topic.BEACON_BLOCK, signed_block)

    def publish_attestation(self, attestation) -> None:
        self.transport.publish(
            self.node_id, Topic.BEACON_ATTESTATION, attestation
        )

    def publish_aggregate(self, signed_aggregate) -> None:
        self.transport.publish(
            self.node_id, Topic.AGGREGATE_AND_PROOF, signed_aggregate
        )

    def publish_sync_message(self, message) -> None:
        self.transport.publish(
            self.node_id, Topic.SYNC_COMMITTEE_MESSAGE, message
        )

    def publish_contribution(self, signed_contribution) -> None:
        self.transport.publish(
            self.node_id, Topic.SYNC_CONTRIBUTION, signed_contribution
        )

    def publish_data_column(self, sidecar) -> None:
        self.transport.publish(
            self.node_id, Topic.DATA_COLUMN_SIDECAR, sidecar
        )

    # -- work handlers (network_beacon_processor/gossip_methods.rs) --------

    def process_gossip_block(self, item) -> None:
        from ..beacon_chain.chain import BlockPendingAvailability

        block, from_peer = item
        try:
            self.chain.process_block(block)
        except BlockPendingAvailability as e:
            # PeerDAS: the block is parked until its columns verify; pull
            # whatever custody/sample columns the proposer's side already
            # serves, then re-check availability
            self._fetch_missing_columns(e.block_root, from_peer)
        except BlockError as e:
            if "unknown parent" in str(e):
                # single-block parent lookup (sync/block_lookups/), falling
                # back to a status handshake -> range sync for deep gaps
                self.sync.on_unknown_parent(block, from_peer)
                try:
                    theirs = self.transport.request(
                        self.node_id, from_peer, "status", self.local_status()
                    )
                    self.sync.on_peer_status(from_peer, theirs)
                except ConnectionError:
                    pass
            # other invalid blocks are dropped (peer scoring would fire here)

    def process_gossip_attestation(self, att) -> None:
        self.process_gossip_attestation_batch([att])

    def process_gossip_attestation_batch(self, atts) -> None:
        results = self.chain.verify_unaggregated_attestations(atts)
        for att, verdict in results:
            if not isinstance(verdict, Exception):
                self.op_pool.insert_attestation(att)

    def process_gossip_aggregate(self, agg) -> None:
        self.process_gossip_aggregate_batch([agg])

    def process_gossip_aggregate_batch(self, aggs) -> None:
        results = self.chain.verify_aggregated_attestations(aggs)
        for sap, verdict in results:
            if not isinstance(verdict, Exception):
                self.op_pool.insert_attestation(sap.message.aggregate)

    def process_gossip_sync_message(self, msg) -> None:
        self.process_gossip_sync_message_batch([msg])

    def process_gossip_sync_message_batch(self, msgs) -> None:
        self.chain.verify_sync_committee_messages(msgs)

    def process_gossip_sync_contribution(self, sc) -> None:
        self.chain.verify_sync_contributions([sc])

    def process_gossip_data_column(self, sidecar) -> None:
        """PeerDAS column ingest: verify, retain under the chain lock
        (``chain.put_data_column`` — created in chain init, pruned with the
        availability horizon), record sampling progress, and import any
        block the new column completes
        (data_column_verification.rs gossip path)."""
        chain = self.chain
        ctx = chain.cell_context
        if ctx is None:
            return  # column sampling not enabled on this node
        from ..beacon_chain.data_columns import (
            DataColumnError,
            verify_data_column_sidecar,
        )

        try:
            verify_data_column_sidecar(chain.ns, sidecar, ctx)
        except DataColumnError:
            return  # invalid columns drop (peer scoring fires upstream)
        root = chain.put_data_column(sidecar)
        if chain.peerdas is None:
            return
        chain.peerdas.on_verified_column(root, int(sidecar.index))
        self._try_column_availability(root)

    def _try_column_availability(self, block_root: bytes) -> None:
        """Re-evaluate a block against the sampling gate; reconstruct from
        a >= 50% held column set when that's what closes the gap. Every
        column marked verified here went through
        ``verify_data_column_sidecar`` — reconstruction output included —
        so a corrupt recovery can never flip a block to available."""
        chain = self.chain
        sampler = chain.peerdas
        missing = sampler.missing_columns(block_root)
        if missing and sampler.can_reconstruct(block_root):
            from ..beacon_chain.data_columns import (
                DataColumnError,
                verify_data_column_sidecar,
            )
            from ..kzg.kzg import KzgError

            try:
                rebuilt = sampler.reconstruct(block_root)
            except KzgError:
                rebuilt = None  # inconsistent held data: stay unavailable
            if rebuilt is not None:
                for col in missing:
                    sc = rebuilt[col]
                    try:
                        verify_data_column_sidecar(
                            chain.ns, sc, chain.cell_context
                        )
                    except DataColumnError:
                        return  # recovery produced garbage: fail closed
                    chain.put_data_column(sc)
                    sampler.on_verified_column(block_root, col)
                    # re-seed the network with the recovered column (spec:
                    # reconstructing nodes republish)
                    self.publish_data_column(sc)
        res = chain.da_checker.notify_columns(block_root)
        if res is None:
            return
        blk, _ = res
        with chain.lock:
            try:
                chain._process_block_locked(
                    blk, blk.message, block_root, True,
                    check_availability=False,
                )
            except BlockError:
                pass  # e.g. unknown parent: range sync re-imports it later

    def _fetch_missing_columns(self, block_root: bytes, peer: str) -> None:
        """Pull this node's missing custody/sample columns from a peer over
        the DataColumnSidecarsByRoot Req/Resp, then retry availability."""
        chain = self.chain
        if chain.peerdas is None:
            return
        missing = chain.peerdas.missing_columns(block_root)
        if not missing:
            self._try_column_availability(block_root)
            return
        try:
            sidecars = self.transport.request(
                self.node_id, peer, "data_column_sidecars_by_root",
                [(bytes(block_root), c) for c in missing],
            )
        except (ConnectionError, ValueError):
            return  # peer gone / refused: gossip or sync will retry
        for sc in sidecars:
            self.process_gossip_data_column(sc)

    def process_gossip_exit(self, exit_msg) -> None:
        self.op_pool.insert_voluntary_exit(exit_msg)

    def process_gossip_proposer_slashing(self, slashing) -> None:
        self.op_pool.insert_proposer_slashing(slashing)

    def process_gossip_attester_slashing(self, slashing) -> None:
        self.op_pool.insert_attester_slashing(slashing)

    def process_chain_segment(self, blocks) -> None:
        try:
            self.chain.process_chain_segment(list(blocks))
        except BlockError:
            pass  # scored + retried against another peer in the full stack

    def process_chain_segment_strict(self, blocks) -> None:
        """Segment import that RAISES on failure so the sync manager can
        demote the serving peer and retry elsewhere (range_sync batch
        failure handling)."""
        self.chain.process_chain_segment(list(blocks))

    # -- rpc handlers ------------------------------------------------------

    def blocks_by_range(self, start_slot: int, count: int) -> list:
        """Canonical-chain blocks in [start_slot, start_slot+count)
        (rpc_methods.rs BlocksByRange). Reads through to the persistent
        store (``chain.get_signed_block``) so serving keeps working below
        the finalized horizon, where the in-memory map is pruned."""
        out = []
        root = self.chain.head.root
        while root is not None:
            sb = self.chain.get_signed_block(root)
            if sb is None:
                break
            s = int(sb.message.slot)
            if s < start_slot:
                break  # walking backwards: everything older is out of range
            if s < start_slot + count:
                out.append(sb)
            root = bytes(sb.message.parent_root)
        out.reverse()
        return out

    def blocks_by_root(self, roots) -> list:
        blocks = (self.chain.get_signed_block(r) for r in roots)
        return [sb for sb in blocks if sb is not None]

    def data_column_sidecars_by_root(self, identifiers) -> list:
        """DataColumnSidecarsByRoot: serve held columns for
        (block_root, column_index) pairs (rpc_methods.rs
        DataColumnsByRootRequest). Unknown identifiers are skipped —
        responses carry only what this node custodies."""
        out = []
        for root, idx in identifiers:
            sc = self.chain.data_columns_for(bytes(root)).get(int(idx))
            if sc is not None:
                out.append(sc)
        return out

    def data_column_sidecars_by_range(
        self, start_slot: int, count: int, columns=None
    ) -> list:
        """DataColumnSidecarsByRange: held columns for slots in
        [start_slot, start_slot + count), optionally filtered to a column
        subset; (slot, index)-ordered like the reference's response
        stream."""
        with self.chain.lock:
            snapshot = [
                sc
                for cols in self.chain.data_column_cache.values()
                for sc in cols.values()
            ]
        wanted = None if columns is None else {int(c) for c in columns}
        out = [
            sc
            for sc in snapshot
            if start_slot
            <= int(sc.signed_block_header.message.slot)
            < start_slot + count
            and (wanted is None or int(sc.index) in wanted)
        ]
        out.sort(
            key=lambda sc: (
                int(sc.signed_block_header.message.slot), int(sc.index)
            )
        )
        return out

    # -- light-client serving (rpc_methods.rs LightClient* protocols) -------

    def light_client_bootstrap(self, block_root: bytes):
        """LightClientBootstrap by trusted block root; None when the root's
        state is not held (the codec encodes an empty response)."""
        return self.chain.light_client_cache.bootstrap(bytes(block_root))

    def light_client_updates_by_range(
        self, start_period: int, count: int
    ) -> list:
        """Best full update per sync-committee period in
        [start_period, start_period + count)."""
        return self.chain.light_client_cache.updates_by_range(
            int(start_period), int(count)
        )

    def light_client_optimistic_update(self):
        return self.chain.light_client_cache.latest_optimistic

    def light_client_finality_update(self):
        return self.chain.light_client_cache.latest_finality
