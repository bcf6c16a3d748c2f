"""Watch updater: follow the canonical chain through the Beacon API — the port's copy of
``lighthouse_tpu/watch/service.py``.

Lighthouse's ``watch/src/updater``: each ``update()`` walks from the last ingested
slot to the node's head, records canonical/skipped slots, and extracts
per-block analytics columns from the SSZ block bodies."""

from __future__ import annotations

import numpy as np

from ..api_client import BeaconNodeHttpClient
from ..types.containers import for_preset
from ..utils.logging import get_logger

log = get_logger("watch")


class WatchService:
    def __init__(self, db, beacon_url: str, spec):
        self.db = db
        self.client = BeaconNodeHttpClient(beacon_url)
        self.spec = spec
        self.ns = for_preset(spec.preset.name)

    def update(self) -> int:
        """Ingest up to the node's current head. Returns rows written."""
        from ..api_client import ApiClientError

        head = self.client.get_head_header()
        bounds = self.db.slot_bounds()
        start = 1 if bounds is None else bounds[1] + 1
        written = 0
        last_root = b"\x00" * 32  # pre-first-block skipped slots anchor here
        for slot in range(start, head["slot"] + 1):
            try:
                version, raw = self.client.get_block_ssz(slot)
            except ApiClientError as e:
                if e.code != 404:
                    raise  # transport/server errors must NOT look like skips
                self.db.put_canonical_slot(slot, last_root, skipped=True)
                written += 1
                continue
            sb = self.ns.block_types[version].decode(raw)
            blk = sb.message
            root = type(blk).hash_tree_root(blk)
            body = blk.body
            votes = sum(
                int(np.asarray(a.aggregation_bits).sum())
                for a in body.attestations
            )
            graffiti = bytes(body.graffiti).rstrip(b"\x00")
            self.db.put_canonical_slot(int(blk.slot), root, skipped=False)
            self.db.put_block(
                {
                    "slot": int(blk.slot),
                    "root": root,
                    "parent_root": bytes(blk.parent_root),
                    "proposer_index": int(blk.proposer_index),
                    "graffiti": graffiti.decode(errors="replace"),
                    "attestation_count": len(body.attestations),
                    "deposit_count": len(body.deposits),
                    "exit_count": len(body.voluntary_exits),
                    "attesting_votes": votes,
                }
            )
            last_root = root
            written += 1
        if written:
            log.info("Watch ingested", rows=written, head=head["slot"])
        return written
