"""Sync-committee aggregation pool (naive_aggregation_pool's sync twin +
``OperationPool::get_sync_aggregate``, ref operation_pool/src/lib.rs:156 and
``beacon_chain/src/sync_committee_verification.rs`` aggregation shape).

Individual ``SyncCommitteeMessage``s and subnet ``SyncCommitteeContribution``s
are union-aggregated per (slot, beacon_block_root); block production asks for
the best ``SyncAggregate`` for the block's parent root at the previous slot.

The port's copy of ``lighthouse_tpu/op_pool/sync_aggregation.py``.
"""

from __future__ import annotations

import threading

import numpy as np

from .. import bls
from ..oracle import curves as oc

INFINITY_SIG = b"\xc0" + b"\x00" * 95


class SyncContributionPool:
    def __init__(self, sync_committee_size: int):
        self.size = sync_committee_size
        # (slot, root) -> [bits ndarray, agg_sig_point]
        self._entries: dict[tuple[int, bytes], list] = {}
        self._lock = threading.Lock()

    # -- ingest -------------------------------------------------------------

    def insert_message(self, slot: int, root: bytes, positions, signature: bytes) -> None:
        """One validator's signed sync message; ``positions`` are its indices
        in the CURRENT sync committee (a validator can hold several seats).
        Verification aggregates the committee pubkey once per SET BIT, so the
        signature joins the aggregate once per seat too."""
        bits = np.zeros(self.size, dtype=bool)
        for pos in positions:
            bits[int(pos)] = True
        point = bls.g2_point(bytes(signature))
        acc = point
        for _ in range(len(positions) - 1):
            acc = oc.g2_add(acc, point)
        self._merge(slot, bytes(root), bits, acc)

    def insert_contribution(self, contribution) -> None:
        """A subnet aggregate: bits cover one of the 4 subcommittees
        (sync_committee_verification.rs contribution path)."""
        sub = int(contribution.subcommittee_index)
        sub_size = self.size // 4
        bits = np.zeros(self.size, dtype=bool)
        sub_bits = np.asarray(contribution.aggregation_bits, dtype=bool)
        bits[sub * sub_size : (sub + 1) * sub_size] = sub_bits
        self._merge(
            int(contribution.slot),
            bytes(contribution.beacon_block_root),
            bits,
            bls.g2_point(bytes(contribution.signature)),
        )

    def _merge(self, slot: int, root: bytes, bits, sig_point) -> None:
        if not bits.any():
            return
        with self._lock:
            entry = self._entries.get((slot, root))
            if entry is None:
                self._entries[(slot, root)] = [bits, sig_point]
                return
            have, agg = entry
            overlap = have & bits
            if overlap.any():
                return  # naive aggregation: only disjoint unions combine
            entry[0] = have | bits
            entry[1] = oc.g2_add(agg, sig_point)

    # -- block production ----------------------------------------------------

    def get_sync_aggregate(self, ns, slot: int, beacon_block_root: bytes):
        """Best aggregate signed at ``slot`` over ``beacon_block_root`` (the
        parent of the block being built), or the empty infinity aggregate."""
        with self._lock:
            entry = self._entries.get((int(slot), bytes(beacon_block_root)))
            if entry is None:
                return ns.SyncAggregate(
                    sync_committee_bits=np.zeros(self.size, dtype=bool),
                    sync_committee_signature=INFINITY_SIG,
                )
            bits, agg = entry
            return ns.SyncAggregate(
                sync_committee_bits=bits.copy(),
                sync_committee_signature=oc.g2_compress(agg),
            )

    def prune(self, current_slot: int) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[0] < current_slot - 2]:
                del self._entries[key]
