"""Restart-from-disk recovery: rebuild a node's serving state from its
persistent store. The port's copy of ``lighthouse_tpu/beacon_chain/
recovery.py``.

One function — ``recover_node_state`` — is the whole boot-from-datadir
path (the client builder's and a restarted test node's):

1. open the stores (the WAL replay inside ``LevelStore.__init__`` has
   already truncated any torn tail and discarded any stale ``.compact``);
2. build the chain on its genesis anchor, then adopt the persisted
   fork-choice snapshot (head, attestation weight, finalized checkpoint)
   and rehydrate the unfinalized blocks it references from the store —
   the node restarts AT its last persisted head instead of range-syncing
   from genesis;
3. rehydrate the operation pool.

Every recovery emits a report (records replayed, torn bytes truncated,
fork-choice nodes restored, wall clock) onto the ``resilience_recovery_*``
metric families and into a module aggregate a measurement's integrity
stamp reads — a run that silently recovered mid-measurement is visible in
the record.

The port's one difference is the ``pubkey_cache=`` pass-through to the
chain (``BeaconChain(pubkey_cache=)``): a restart can seed its cache from
stored affine points (``ValidatorPubkeyCache.from_affine``) instead of
decompressing every key of a 2^20 anchor. Without it, the chain
decompresses them, as the reference's does.
"""

from __future__ import annotations

import threading
import time

from ..utils.logging import get_logger
from ..utils.metrics import (
    RESILIENCE_RECOVERIES,
    RESILIENCE_RECOVERY_REPLAYED,
    RESILIENCE_RECOVERY_TIMES,
    RESILIENCE_RECOVERY_TRUNCATED,
)

log = get_logger("beacon_chain.recovery")

_TOTALS_LOCK = threading.Lock()
_TOTALS = {
    "recoveries": 0,
    "replayed_records": 0,
    "truncated_bytes": 0,
    "stale_compact_removed": 0,
}


def snapshot_recovery_totals() -> dict:
    """Process-wide recovery aggregate (a measurement stamp's view)."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def _store_replay_stats(store) -> dict:
    """Sum the WAL replay stats over the hot + cold backends (MemoryStore
    backends contribute zeros — they have no replay)."""
    out = {
        "replayed_frames": 0,
        "replayed_records": 0,
        "truncated_bytes": 0,
        "stale_compact_removed": 0,
    }
    for kv in (store.hot, store.cold):
        stats = getattr(kv, "recovery_stats", None)
        if not stats:
            continue
        for k in out:
            out[k] += int(stats.get(k, 0))
    return out


def recover_node_state(
    spec,
    anchor_state,
    store,
    slot_clock=None,
    execution_layer=None,
    pubkey_cache=None,
):
    """Rebuild ``(chain, op_pool, report)`` from ``store``.

    ``pubkey_cache``: a cache already holding the anchor's keys, passed to
    the chain in place of decompressing them (None: the chain builds one).

    ``anchor_state`` is the same genesis/checkpoint anchor the node
    originally booted from (the interop genesis is deterministic, so the
    harness and the client both re-derive it). The persisted fork-choice
    snapshot is only adopted when it belongs to this anchor's chain; a
    missing/foreign/corrupt snapshot falls back to a fresh anchor boot —
    recovery degrades, it never refuses to start.
    """
    from .chain import BeaconChain
    from ..fork_choice import persistence as fc_persist
    from ..op_pool import OperationPool
    from ..op_pool import persistence as pool_persist

    t0 = time.perf_counter()
    chain = BeaconChain(
        spec,
        anchor_state,
        store=store,
        slot_clock=slot_clock,
        execution_layer=execution_layer,
        pubkey_cache=pubkey_cache,
    )
    report: dict = {"fork_choice_restored": False, "fc_nodes": 0,
                    "pool_restored": 0}
    report.update(_store_replay_stats(store))

    blob = store.get_meta(fc_persist.META_KEY)
    if blob:
        fresh_fc = chain.fork_choice
        try:
            restored = fc_persist.restore_fork_choice(spec, blob)
            if chain.genesis_block_root in restored.proto.indices:
                # rehydrate the unfinalized blocks the restored graph
                # references — imports, production and serving all key off
                # the chain's block/seen maps
                for node in restored.proto.nodes:
                    raw = store.get_block(node.root)
                    if raw is not None:
                        fork = spec.fork_name_at_slot(node.slot)
                        chain._blocks[node.root] = chain.ns.block_types[
                            fork
                        ].decode(raw)
                    chain._seen_blocks.add(node.root)
                # rehydrate their post-states too: the finalization
                # migrator iterates the in-memory state map, so a state
                # left only in the hot DB would never be frozen into the
                # cold hierarchy nor pruned when finality passes it (a
                # permanent per-crash leak + replay gap). HOT reads only —
                # a state already frozen to cold is already migrated, and
                # the cold fallback's block-replay reconstruction is far
                # too expensive to run per node on the recovery path
                from ..store.kv import DBColumn

                for node in restored.proto.nodes:
                    if (
                        node.root == chain.genesis_block_root
                        or node.root in chain._states
                    ):
                        continue
                    signed = chain._blocks.get(node.root)
                    if signed is None:
                        continue
                    ssz = store.hot.get(
                        DBColumn.BeaconState,
                        bytes(signed.message.state_root),
                    )
                    if ssz is None:
                        continue  # already frozen/pruned: nothing leaks
                    cls = chain.ns.state_types[
                        spec.fork_name_at_slot(int(signed.message.slot))
                    ]
                    try:
                        chain._states[node.root] = cls.decode(ssz)
                    except Exception:  # noqa: BLE001 — foreign bytes:
                        continue  # leave it to the on-demand loader
                chain.fork_choice = restored
                # finality is already migrated below this watermark: the
                # restarted migrator must not re-walk it from slot 0
                fin_epoch, _fin_root = restored.store.finalized_checkpoint
                chain.migrator.last_finalized_slot = spec.start_slot(
                    int(fin_epoch)
                )
                chain.recompute_head()
                report["fork_choice_restored"] = True
                report["fc_nodes"] = len(restored.proto.nodes)
            else:
                chain.fork_choice = fresh_fc
                log.warning(
                    "Fork choice snapshot is foreign to this anchor "
                    "(different genesis?); recovering as a fresh boot"
                )
        except Exception as e:  # noqa: BLE001 — stale/foreign snapshot
            chain.fork_choice = fresh_fc
            log.warning("Fork choice restore failed", error=str(e))
    # validators that activated since genesis live in the head state
    chain.pubkey_cache.import_new_pubkeys(chain.head.state)

    op_pool = OperationPool(spec, chain.ns.Attestation)
    blob = store.get_meta(pool_persist.META_KEY)
    if blob:
        try:
            report["pool_restored"] = pool_persist.restore_pool(
                op_pool, chain.ns, blob
            )
        except Exception as e:  # noqa: BLE001 — stale snapshot
            log.warning("Op pool restore failed", error=str(e))

    report["head_slot"] = int(chain.head.slot)
    report["head_root"] = bytes(chain.head.root)
    report["finalized_epoch"] = int(
        chain.fork_choice.store.finalized_checkpoint[0]
    )
    report["recovery_s"] = time.perf_counter() - t0

    RESILIENCE_RECOVERIES.inc()
    RESILIENCE_RECOVERY_REPLAYED.inc(report["replayed_records"])
    RESILIENCE_RECOVERY_TRUNCATED.inc(report["truncated_bytes"])
    RESILIENCE_RECOVERY_TIMES.observe(report["recovery_s"])
    with _TOTALS_LOCK:
        _TOTALS["recoveries"] += 1
        _TOTALS["replayed_records"] += report["replayed_records"]
        _TOTALS["truncated_bytes"] += report["truncated_bytes"]
        _TOTALS["stale_compact_removed"] += report["stale_compact_removed"]
    log.info(
        "Recovered from disk",
        head_slot=report["head_slot"],
        finalized_epoch=report["finalized_epoch"],
        replayed=report["replayed_records"],
        truncated_bytes=report["truncated_bytes"],
        fc_nodes=report["fc_nodes"],
        seconds=round(report["recovery_s"], 3),
    )
    return chain, op_pool, report
