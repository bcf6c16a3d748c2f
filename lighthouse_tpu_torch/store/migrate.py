"""Finalization migrator (ref store/src/migrate.rs + BackgroundMigrator).

On finalization advance: freeze the canonical finalized states into the
cold hierarchy, delete non-canonical (abandoned-fork) hot data, and release
the chain's in-memory state handles — the fix for unbounded `_states`
growth. The reference runs this on a background thread; here it runs
inline under the chain lock (the freeze itself is a handful of diffs).

Crash-safety: the migration is the canonical multi-key sequence
a kill used to tear. It now runs in two phases — (1) freeze every canonical
state into the cold store (each freeze is one atomic cold frame, and a
duplicate freeze on a re-run is byte-idempotent), then (2) prune ALL hot
data in one atomic hot batch. A crash between the phases leaves harmless
hot/cold duplicates that the next finalization pass re-prunes; a crash
inside either phase is absorbed by the store's frame atomicity. In-memory
maps are only updated after phase 2 commits.

The port's copy of ``lighthouse_tpu/store/migrate.py``.
"""

from __future__ import annotations

from .kv import DBColumn


class BackgroundMigrator:
    def __init__(self, store):
        self.store = store
        self.last_finalized_slot = 0

    def process_finalization(self, chain, finalized_root: bytes, finalized_slot: int) -> dict:
        """Migrate everything strictly below the finalized slot.

        ``chain`` supplies the in-memory block/state maps; canonicality is
        decided by walking parent links from the finalized block.
        """
        if finalized_slot <= self.last_finalized_slot:
            return {"frozen": 0, "pruned": 0}

        # canonical ancestor roots of the finalized block (incl. itself)
        canonical = set()
        root = finalized_root
        while root in chain._blocks:
            canonical.add(root)
            root = bytes(chain._blocks[root].message.parent_root)
        canonical.add(chain.genesis_block_root)

        from ..resilience.crashpoints import maybe_crash
        from ..utils.metrics import STORE_FREEZE_TIMES

        owner = getattr(self.store.hot, "owner", None)
        frozen_roots, pruned_roots, prune_ops = [], [], []
        for block_root in list(chain._states):
            if block_root == chain.genesis_block_root:
                continue  # the genesis anchor stays resident
            state = chain._states[block_root]
            slot = int(state.slot)
            if slot >= finalized_slot or block_root == finalized_root:
                continue
            state_root = state.tree_root()
            if block_root in canonical:
                # phase 1: freeze into the cold hierarchy (atomic per state)
                with STORE_FREEZE_TIMES.time():
                    self.store.store_cold_state(state, state_root, block_root)
                maybe_crash("migrate.finalization", owner=owner)
                prune_ops.append(("delete", DBColumn.BeaconState, state_root))
                prune_ops.append(
                    ("delete", DBColumn.BeaconStateSummary, state_root)
                )
                # the signed block stays in the store; the decoded in-memory
                # copy is dropped after the prune commits (bounds _blocks
                # alongside _states)
                frozen_roots.append(block_root)
            else:
                # abandoned fork: drop block + state entirely (migrate.rs
                # abandoned-forks pruning)
                if chain._blocks.get(block_root) is not None:
                    prune_ops.append(
                        ("delete", DBColumn.BeaconBlock, block_root)
                    )
                prune_ops.append(("delete", DBColumn.BeaconState, state_root))
                prune_ops.append(
                    ("delete", DBColumn.BeaconStateSummary, state_root)
                )
                pruned_roots.append(block_root)

        # phase 2: ONE atomic hot prune — a kill either leaves everything
        # (plus idempotent cold duplicates) or nothing
        if prune_ops:
            self.store.do_atomically(prune_ops)
        for block_root in frozen_roots:
            chain._blocks.pop(block_root, None)
            del chain._states[block_root]
        for block_root in pruned_roots:
            chain._blocks.pop(block_root, None)
            del chain._states[block_root]
        self.last_finalized_slot = finalized_slot
        from ..utils.logging import get_logger

        get_logger("store.migrate").info(
            "Finalization migration",
            finalized_slot=finalized_slot,
            frozen=len(frozen_roots),
            pruned=len(pruned_roots),
        )
        return {"frozen": len(frozen_roots), "pruned": len(pruned_roots)}
