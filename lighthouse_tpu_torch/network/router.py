"""Router: pubsub + RPC dispatch into the beacon processor.

Twin of ``network/src/router.rs:381-535`` (one arm per PubsubMessage variant)
plus the ``NetworkBeaconProcessor`` packaging
(``network_beacon_processor/mod.rs:88-116``): every gossip message becomes a
``Work`` item with ``process_individual`` AND ``process_batch`` closures so
the scheduler can form attestation/aggregate batches for the device backend
(``gossip_methods.rs:198,230``).

The four light-client Req/Resp methods raise ``WireError`` until the port has
the light-client server (ROADMAP Queue 1 item 2.4).
"""

from __future__ import annotations

import time

from ..beacon_processor.processor import Work, WorkType
from ..loadshed import DEFAULT_SLOT_SECONDS, deadline_for
from .codec import LIGHT_CLIENT_METHODS, light_client_unported
from .transport import Topic


class Router:
    def __init__(self, service):
        self.svc = service
        try:
            self._slot_seconds = float(
                service.chain.spec.preset.SECONDS_PER_SLOT
            )
        except AttributeError:
            self._slot_seconds = DEFAULT_SLOT_SECONDS

    def _stamp(self, work: Work) -> Work:
        """Deadline propagation starts at the wire: every gossip Work item
        carries its ingest time plus a per-type processing deadline, so
        stale work is dropped before it ever reaches BLS or the device."""
        now = time.monotonic()
        work.ingest_at = now
        work.deadline = deadline_for(
            work.work_type, now=now, slot_seconds=self._slot_seconds
        )
        return work

    # -- gossip ------------------------------------------------------------

    def on_gossip(self, topic: str, message, from_peer: str) -> None:
        svc = self.svc

        def submit(**kw) -> None:
            svc.processor.submit(self._stamp(Work(**kw)))

        if topic == Topic.BEACON_BLOCK:
            submit(
                work_type=WorkType.GossipBlock,
                item=(message, from_peer),
                process_individual=svc.process_gossip_block,
            )
        elif topic == Topic.BEACON_ATTESTATION:
            submit(
                work_type=WorkType.GossipAttestation,
                item=message,
                process_individual=svc.process_gossip_attestation,
                process_batch=svc.process_gossip_attestation_batch,
            )
        elif topic == Topic.AGGREGATE_AND_PROOF:
            submit(
                work_type=WorkType.GossipAggregate,
                item=message,
                process_individual=svc.process_gossip_aggregate,
                process_batch=svc.process_gossip_aggregate_batch,
            )
        elif topic == Topic.SYNC_COMMITTEE_MESSAGE:
            submit(
                work_type=WorkType.GossipSyncSignature,
                item=message,
                process_individual=svc.process_gossip_sync_message,
                process_batch=svc.process_gossip_sync_message_batch,
            )
        elif topic == Topic.SYNC_CONTRIBUTION:
            submit(
                work_type=WorkType.GossipSyncContribution,
                item=message,
                process_individual=svc.process_gossip_sync_contribution,
            )
        elif topic == Topic.DATA_COLUMN_SIDECAR:
            submit(
                work_type=WorkType.GossipBlock,  # block-class priority
                item=message,
                process_individual=svc.process_gossip_data_column,
            )
        elif topic == Topic.VOLUNTARY_EXIT:
            submit(
                work_type=WorkType.GossipVoluntaryExit,
                item=message,
                process_individual=svc.process_gossip_exit,
            )
        elif topic == Topic.PROPOSER_SLASHING:
            submit(
                work_type=WorkType.GossipProposerSlashing,
                item=message,
                process_individual=svc.process_gossip_proposer_slashing,
            )
        elif topic == Topic.ATTESTER_SLASHING:
            submit(
                work_type=WorkType.GossipAttesterSlashing,
                item=message,
                process_individual=svc.process_gossip_attester_slashing,
            )
        # unknown topics are dropped (gossipsub would penalize the peer)

    # -- req/resp ----------------------------------------------------------

    def on_rpc(self, method: str, payload, from_peer: str):
        if method == "status":
            self.svc.sync.on_peer_status(from_peer, payload)
            return self.svc.local_status()
        if method == "blocks_by_range":
            start_slot, count = payload
            return self.svc.blocks_by_range(start_slot, count)
        if method == "blocks_by_root":
            return self.svc.blocks_by_root(payload)
        if method == "data_column_sidecars_by_root":
            return self.svc.data_column_sidecars_by_root(payload)
        if method == "data_column_sidecars_by_range":
            start_slot, count, columns = payload
            return self.svc.data_column_sidecars_by_range(
                start_slot, count, columns
            )
        if method in LIGHT_CLIENT_METHODS:
            raise light_client_unported(method)
        raise ValueError(f"unknown rpc method {method!r}")
