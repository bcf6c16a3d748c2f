"""Deadline propagation for ingest work.

Every unit of work entering the node — gossip attestation/aggregate/block,
Req/Resp request, HTTP request — is stamped with the monotonic time it left
the wire plus a deadline derived from its type. Queues drop expired work
BEFORE it reaches any BLS/device dispatch: a stale attestation past its
inclusion window or an RPC request whose client already gave up only wastes
device cycles that admitted work is waiting for (the reference expresses the
same idea as per-queue TTLs in ``beacon_processor/src/lib.rs``; here the
deadline rides the work item itself so every hop can check it).

All times are ``time.monotonic()`` — deadlines never cross processes.
"""

from __future__ import annotations

import time

# Per-work-type deadline budgets, in seconds from wire ingest, scaled by
# slot seconds where the protocol defines the useful lifetime:
#   - unaggregated attestations are useless once the aggregation cut-off for
#     their slot has passed (~1 slot of slack covers clock skew + late votes)
#   - aggregates ride the same window
#   - sync-committee messages are per-slot only
#   - blocks and RPC work stay useful much longer (sync, backfill)
# Values are expressed in SLOTS; ``budget_for`` multiplies by the spec's
# seconds-per-slot (default mainnet 12s).
_SLOT_BUDGETS = {
    "GossipAttestation": 1.0,
    "GossipAggregate": 1.0,
    "UnknownBlockAttestation": 2.0,
    "UnknownBlockAggregate": 2.0,
    "GossipSyncSignature": 1.0,
    "GossipSyncContribution": 1.0,
}

# Flat budgets in seconds for work whose lifetime is a client-side timeout,
# not a protocol window (Req/Resp servicing: the default client rpc_timeout
# is the longest any well-behaved requester will wait).
_FLAT_BUDGETS = {
    "Status": 10.0,
    "BlocksByRangeRequest": 10.0,
    "BlocksByRootsRequest": 10.0,
    "LightClientUpdate": 10.0,
    "ApiRequestP0": 10.0,
    "ApiRequestP1": 10.0,
}

DEFAULT_SLOT_SECONDS = 12.0


def budget_for(work_type, slot_seconds: float = DEFAULT_SLOT_SECONDS):
    """Deadline budget in seconds for ``work_type`` (None = no deadline).

    ``work_type`` may be a WorkType enum member or its name string.
    """
    name = getattr(work_type, "name", work_type)
    slots = _SLOT_BUDGETS.get(name)
    if slots is not None:
        return slots * float(slot_seconds)
    return _FLAT_BUDGETS.get(name)


def deadline_for(work_type, now: float | None = None,
                 slot_seconds: float = DEFAULT_SLOT_SECONDS):
    """Absolute monotonic deadline for ``work_type`` ingested at ``now``
    (None when the type carries no deadline)."""
    budget = budget_for(work_type, slot_seconds)
    if budget is None:
        return None
    return (time.monotonic() if now is None else now) + budget


def expired(deadline, now: float | None = None) -> bool:
    """True iff ``deadline`` (absolute monotonic, or None) has passed."""
    if deadline is None:
        return False
    return (time.monotonic() if now is None else now) > deadline
