"""Priority tables for admission control.

Two shedding surfaces gate on the LoadMonitor's admission level:

* **HTTP API**: P0 routes are the validator-duty critical path — dropping
  them costs the operator money (missed attestations/proposals), so they are
  ALWAYS admitted. Everything else is P1 and gets ``503 + Retry-After`` when
  the node is SATURATED (beacon_processor's ApiRequestP0/P1 split,
  ``beacon_node/beacon_processor/src/lib.rs:629-630``).

* **Req/Resp**: methods carry a priority class; under load the server sheds
  the lowest class first, so cheap control traffic (status/ping — what keeps
  the peer table honest) survives longest and bulk serving (by_range walks,
  light-client updates) goes first.
"""

from __future__ import annotations

# HTTP route names (http_api/server.py _ROUTES) on the validator-duty
# critical path. health/events/syncing ride along: monitoring and SSE duty
# feeds must stay reachable precisely when the node is struggling.
P0_ROUTES = frozenset({
    "proposer",
    "attester",
    "att_data",
    "produce_block",
    "produce_blinded",
    "publish_block",
    "publish_blinded",
    "publish_atts",
    "publish_aggregates",
    "aggregate_att",
    "sync_duties",
    "publish_sync",
    "publish_contributions",
    "liveness",
    "syncing",
    "health",
    "events",
})


def is_p0_route(name: str) -> bool:
    return name in P0_ROUTES


# Req/Resp method -> priority class. Lower = more critical; shedding starts
# from the HIGHEST class and works down as saturation deepens.
#   0  control / liveness        — never shed
#   1  targeted block fetches    — unblocks fork-choice; shed only last
#   2  bulk range serving        — a peer's sync can wait
#   3  light-client mass serving — pure service tier, first to go
METHOD_PRIORITY: dict[str, int] = {
    "status": 0,
    "goodbye": 0,
    "ping": 0,
    "metadata": 0,
    "blocks_by_root": 1,
    "blob_sidecars_by_root": 1,
    "data_column_sidecars_by_root": 1,
    "blocks_by_range": 2,
    "blob_sidecars_by_range": 2,
    "data_column_sidecars_by_range": 2,
    "light_client_bootstrap": 3,
    "light_client_updates_by_range": 3,
    "light_client_finality_update": 3,
    "light_client_optimistic_update": 3,
}
_DEFAULT_METHOD_PRIORITY = 2  # unlisted methods are treated as bulk


def method_priority(method: str) -> int:
    return METHOD_PRIORITY.get(method, _DEFAULT_METHOD_PRIORITY)


def shed_floor(level) -> int | None:
    """Lowest priority class still ADMITTED at ``level`` (methods with a
    class strictly above the floor are shed). None = shed nothing."""
    # imported lazily to keep priorities import-light
    from .monitor import AdmissionLevel

    if level == AdmissionLevel.SATURATED:
        return 1   # keep control + targeted fetches, shed all bulk
    if level == AdmissionLevel.BUSY:
        return 2   # shed only the light-client service tier
    return None


def should_shed_method(method: str, level) -> bool:
    floor = shed_floor(level)
    if floor is None:
        return False
    return method_priority(method) > floor
