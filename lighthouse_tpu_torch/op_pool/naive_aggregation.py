"""Naive aggregation pool: fold unaggregated gossip attestations into one
aggregate per AttestationData (naive_aggregation_pool.rs).

Signature aggregation is G2 point addition via the oracle backend (cheap);
overlapping-bit inserts are rejected exactly like the reference's
``Error::AlreadyKnown`` path is skipped.

The port's copy of ``lighthouse_tpu/op_pool/naive_aggregation.py``.
"""

from __future__ import annotations

import numpy as np

from .. import bls
from ..oracle import curves as oc


class NaiveAggregationPool:
    SLOTS_RETAINED = 3

    def __init__(self, attestation_cls):
        self.att_cls = attestation_cls
        # data_root -> (data, bits, sig_point)
        self._maps: dict[bytes, tuple] = {}
        self._by_slot: dict[int, set] = {}

    def insert(self, attestation) -> bool:
        """Insert an attestation (typically single-bit from gossip). Returns
        True if it added new aggregation bits."""
        data = attestation.data
        root = type(data).hash_tree_root(data)
        bits = np.asarray(attestation.aggregation_bits, dtype=bool)
        sig = bls.g2_point(bytes(attestation.signature))
        entry = self._maps.get(root)
        if entry is None:
            self._maps[root] = (data, bits.copy(), sig)
            self._by_slot.setdefault(int(data.slot), set()).add(root)
            return True
        _, have, agg = entry
        if (have & bits).any():
            return False  # overlapping signer(s): skip (already known)
        self._maps[root] = (data, have | bits, oc.g2_add(agg, sig))
        return True

    def get(self, data) -> "object | None":
        return self.get_by_root(type(data).hash_tree_root(data))

    def get_by_root(self, root: bytes) -> "object | None":
        entry = self._maps.get(bytes(root))
        if entry is None:
            return None
        d, bits, sig = entry
        return self.att_cls(
            aggregation_bits=bits.copy(), data=d, signature=oc.g2_compress(sig)
        )

    def iter_all(self):
        for d, bits, sig in self._maps.values():
            yield self.att_cls(
                aggregation_bits=bits.copy(), data=d,
                signature=oc.g2_compress(sig),
            )

    def prune(self, current_slot: int) -> None:
        cutoff = current_slot - self.SLOTS_RETAINED
        for slot in [s for s in self._by_slot if s < cutoff]:
            for root in self._by_slot.pop(slot):
                self._maps.pop(root, None)
