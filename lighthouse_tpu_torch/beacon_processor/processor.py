"""The beacon processor's priority table: the port's copy of ``WorkType``
and ``_LIFO`` from ``lighthouse_tpu/beacon_processor/processor.py``.

Parity: Lighthouse ``beacon_node/beacon_processor/src/lib.rs`` — one
bounded queue per ``WorkType``, popped strictly by priority (lower value
first), attestation-family queues LIFO. The scheduler itself
(``BeaconProcessor``) is not ported; the firehose batcher reads this table.
"""

from __future__ import annotations

import enum


class WorkType(enum.Enum):
    # priority order: lower value = higher priority (lib.rs manager match order)
    ChainSegmentBackfill = 0
    GossipBlock = 1
    GossipBlobSidecar = 2
    RpcBlock = 3
    ChainSegment = 4
    GossipAggregate = 5
    GossipAttestation = 6
    UnknownBlockAggregate = 7
    UnknownBlockAttestation = 8
    GossipVoluntaryExit = 9
    GossipProposerSlashing = 10
    GossipAttesterSlashing = 11
    GossipSyncSignature = 12
    GossipSyncContribution = 13
    ApiRequestP0 = 14
    ApiRequestP1 = 15
    Status = 16
    BlocksByRangeRequest = 17
    BlocksByRootsRequest = 18
    LightClientUpdate = 19


# which queues are LIFO (freshest-first: attestations age out fast; lib.rs)
_LIFO = {
    WorkType.GossipAttestation,
    WorkType.GossipAggregate,
    WorkType.GossipSyncSignature,
}
