"""Light-client server cache (ref light_client_server_cache.rs).

The port's copy of ``lighthouse_tpu/light_client/server_cache.py``. One
difference in cost, none in bytes: an import's finality and next-committee
branches come out of the same attested state, so its field roots are hashed
once per import (``proofs.field_branch``'s memo) instead of once per branch.

Subscribes to the chain's block-import seam. Each altair+ block's sync
aggregate attests the PARENT header; when participation meets
MIN_SYNC_COMMITTEE_PARTICIPANTS the cache refreshes its latest optimistic and
finality updates, produces a full ``LightClientUpdate`` (next sync committee
+ branch, finality proof when the attested state has one) into the
period-indexed ``LightClientUpdateStore``, and emits the standard
``light_client_optimistic_update`` / ``light_client_finality_update`` SSE
events. Bootstraps are computed on demand from a held state.

Every chain read goes through ``chain.get_signed_block`` /
``chain.state_by_root`` — the finalization migration prunes the in-memory
hot maps, and reading them directly silently dropped bootstraps and
finality updates below the finalized horizon (the same truncation class the
``blocks_by_range`` fix covered).
"""

from __future__ import annotations

import numpy as np

from ..types.containers import BeaconBlockHeader, for_preset
from .proofs import field_branch
from .types import light_client_types, state_tree_depth
from .update_store import LightClientUpdateStore


def _header_for(signed_block) -> BeaconBlockHeader:
    blk = signed_block.message
    return BeaconBlockHeader(
        slot=int(blk.slot),
        proposer_index=int(blk.proposer_index),
        parent_root=bytes(blk.parent_root),
        state_root=bytes(blk.state_root),
        body_root=type(blk.body).hash_tree_root(blk.body),
    )


def _participation(update_or_agg) -> int:
    agg = getattr(update_or_agg, "sync_aggregate", update_or_agg)
    return int(np.asarray(agg.sync_committee_bits, dtype=bool).sum())


class LightClientServerCache:
    def __init__(self, chain):
        self.chain = chain
        self.latest_optimistic = None
        self.latest_finality = None
        # period-indexed full-update archive; rides the chain's hot KV
        # store when one exists so the archive survives restarts
        kv = getattr(getattr(chain, "store", None), "hot", None)
        self.update_store = LightClientUpdateStore(chain.spec, kv)
        chain.block_observers.append(self.on_imported_block)

    def _types_at_slot(self, slot: int):
        """Branch depths follow the fork's state-tree depth."""
        fork = self.chain.spec.fork_name_at_slot(int(slot))
        return light_client_types(self.chain.spec.preset.name, fork)

    # -- ingest (block_observers seam) --------------------------------------

    def on_imported_block(self, signed_block) -> None:
        blk = signed_block.message
        agg = getattr(blk.body, "sync_aggregate", None)
        if agg is None:
            return
        bits = np.asarray(agg.sync_committee_bits, dtype=bool)
        if bits.sum() < self.chain.spec.preset.MIN_SYNC_COMMITTEE_PARTICIPANTS:
            return
        parent_root = bytes(blk.parent_root)
        attested_block = self.chain.get_signed_block(parent_root)
        attested_state = self.chain.state_by_root(parent_root)
        if attested_block is None or attested_state is None:
            return
        # recency guard (light_client_server_cache.rs is-latest check) with
        # the participation refinement: a late import of an OLDER block must
        # not regress the served updates, but a SAME-slot aggregate with
        # more participants is a strictly better proof and replaces it
        if self.latest_optimistic is not None:
            latest_slot = int(self.latest_optimistic.signature_slot)
            if int(blk.slot) < latest_slot or (
                int(blk.slot) == latest_slot
                and int(bits.sum()) <= _participation(self.latest_optimistic)
            ):
                return
        t = self._types_at_slot(int(attested_block.message.slot))
        attested_header = t.LightClientHeader(
            beacon=_header_for(attested_block)
        )
        self.latest_optimistic = t.LightClientOptimisticUpdate(
            attested_header=attested_header,
            sync_aggregate=agg,
            signature_slot=int(blk.slot),
        )
        self._emit("light_client_optimistic_update", self.latest_optimistic)

        # both branches below prove leaves of the attested state: hash its
        # fields once for the import
        memo: dict = {}
        fin_header, fin_branch = self._finality_proof(attested_state, t, memo)
        if fin_header is not None:
            self.latest_finality = t.LightClientFinalityUpdate(
                attested_header=attested_header,
                finalized_header=fin_header,
                finality_branch=fin_branch,
                sync_aggregate=agg,
                signature_slot=int(blk.slot),
            )
            self._emit("light_client_finality_update", self.latest_finality)

        self._consider_full_update(
            t, attested_header, attested_state, agg, int(blk.slot),
            fin_header, fin_branch, memo,
        )

    def _finality_proof(self, attested_state, t, memo=None):
        """(finalized LightClientHeader, branch) from the attested state,
        or (None, None) when it has no finalized ancestor we hold."""
        fin_root = bytes(attested_state.finalized_checkpoint.root)
        if fin_root == b"\x00" * 32:
            return None, None
        fin_block = self.chain.get_signed_block(fin_root)
        if fin_block is None:
            return None, None
        return (
            t.LightClientHeader(beacon=_header_for(fin_block)),
            field_branch(attested_state, ["finalized_checkpoint", "root"], memo),
        )

    def _consider_full_update(
        self, t, attested_header, attested_state, agg, signature_slot,
        fin_header, fin_branch, memo=None,
    ):
        """Full LightClientUpdate (the period-rollover product: next sync
        committee + REAL branch) ranked into the period archive. A missing
        finality proof becomes the spec's empty proof (zeroed header +
        zero branch), never a fabricated one."""
        if not hasattr(attested_state, "next_sync_committee"):
            return
        spec = self.chain.spec
        fork = spec.fork_name_at_slot(int(attested_header.beacon.slot))
        depth = state_tree_depth(for_preset(spec.preset.name).state_types[fork])
        if fin_header is None:
            fin_header = t.LightClientHeader(
                beacon=BeaconBlockHeader(
                    slot=0,
                    proposer_index=0,
                    parent_root=b"\x00" * 32,
                    state_root=b"\x00" * 32,
                    body_root=b"\x00" * 32,
                )
            )
            fin_branch = [b"\x00" * 32] * (depth + 1)
        update = t.LightClientUpdate(
            attested_header=attested_header,
            next_sync_committee=attested_state.next_sync_committee,
            next_sync_committee_branch=field_branch(
                attested_state, ["next_sync_committee"], memo
            ),
            finalized_header=fin_header,
            finality_branch=fin_branch,
            sync_aggregate=agg,
            signature_slot=signature_slot,
        )
        self.update_store.consider(update)

    def _emit(self, topic: str, update) -> None:
        emit = getattr(self.chain, "_emit_event", None)
        if emit is None:
            return
        emit(
            topic,
            lambda: {
                "signature_slot": str(int(update.signature_slot)),
                "attested_slot": str(int(update.attested_header.beacon.slot)),
                "data": "0x" + type(update).encode(update).hex(),
            },
        )

    # -- serving ------------------------------------------------------------

    def bootstrap(self, block_root: bytes):
        """LightClientBootstrap for a held block root (the trusted checkpoint
        a light client starts from). Reads through the persistent store so
        pre-finalization-horizon roots keep serving after the migration
        prunes the hot maps."""
        root = bytes(block_root)
        state = self.chain.state_by_root(root)
        if state is None or not hasattr(state, "current_sync_committee"):
            return None
        sb = self.chain.get_signed_block(root)
        if sb is not None:
            header = _header_for(sb)
        elif root == self.chain.genesis_block_root:
            # the anchor has no SignedBeaconBlock: its header is the state's
            # latest_block_header with the state root filled in
            header = state.latest_block_header.copy()
            if bytes(header.state_root) == b"\x00" * 32:
                header.state_root = state.tree_root()
        else:
            return None
        t = self._types_at_slot(int(header.slot))
        return t.LightClientBootstrap(
            header=t.LightClientHeader(beacon=header),
            current_sync_committee=state.current_sync_committee,
            current_sync_committee_branch=field_branch(
                state, ["current_sync_committee"]
            ),
        )

    def updates_by_range(self, start_period: int, count: int) -> list:
        """Best full update per period in the requested range (the
        ``/eth/v1/beacon/light_client/updates`` + UpdatesByRange payload)."""
        return self.update_store.get_updates(start_period, count)
