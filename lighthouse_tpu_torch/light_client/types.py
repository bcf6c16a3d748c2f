"""LightClient SSZ containers (ref consensus/types/src/light_client_*.rs).

The port's copy of ``lighthouse_tpu/light_client/types.py``, over the port's
``ssz`` and ``types``. Altair-shape headers (beacon only); built per
(preset, fork) since branch vector lengths derive from the fork's state-tree
depth (electra's 37-field state deepens every proof by one level).
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

from ..ssz import Container, Vector, uint64
from ..ssz.merkle import next_pow2
from ..types.containers import BeaconBlockHeader, Root, for_preset


def state_tree_depth(state_cls) -> int:
    return (next_pow2(len(state_cls.FIELDS)) - 1).bit_length()


def light_client_types(preset_name: str, fork: str = "altair"):
    # normalize BEFORE the cache: ("minimal",) and ("minimal", "altair")
    # must yield the SAME classes or isinstance checks (the wire codec's
    # fork scan) silently fail across call sites
    return _light_client_types(preset_name, fork)


@lru_cache(maxsize=None)
def _light_client_types(preset_name: str, fork: str):
    ns = for_preset(preset_name)
    depth = state_tree_depth(ns.state_types[fork])
    finality_depth = depth + 1  # + the Checkpoint container level

    class LightClientHeader(Container):
        FIELDS = [("beacon", BeaconBlockHeader)]

    class LightClientBootstrap(Container):
        FIELDS = [
            ("header", LightClientHeader),
            ("current_sync_committee", ns.SyncCommittee),
            ("current_sync_committee_branch", Vector(Root, depth)),
        ]

    class LightClientUpdate(Container):
        FIELDS = [
            ("attested_header", LightClientHeader),
            ("next_sync_committee", ns.SyncCommittee),
            ("next_sync_committee_branch", Vector(Root, depth)),
            ("finalized_header", LightClientHeader),
            ("finality_branch", Vector(Root, finality_depth)),
            ("sync_aggregate", ns.SyncAggregate),
            ("signature_slot", uint64),
        ]

    class LightClientFinalityUpdate(Container):
        FIELDS = [
            ("attested_header", LightClientHeader),
            ("finalized_header", LightClientHeader),
            ("finality_branch", Vector(Root, finality_depth)),
            ("sync_aggregate", ns.SyncAggregate),
            ("signature_slot", uint64),
        ]

    class LightClientOptimisticUpdate(Container):
        FIELDS = [
            ("attested_header", LightClientHeader),
            ("sync_aggregate", ns.SyncAggregate),
            ("signature_slot", uint64),
        ]

    return SimpleNamespace(
        LightClientHeader=LightClientHeader,
        LightClientBootstrap=LightClientBootstrap,
        LightClientUpdate=LightClientUpdate,
        LightClientFinalityUpdate=LightClientFinalityUpdate,
        LightClientOptimisticUpdate=LightClientOptimisticUpdate,
    )
