"""Slasher orchestrator (ref slasher/src/slasher.rs): the port's copy of
``lighthouse_tpu/slasher/slasher.py``, its row update (``arrays.py``) on
the slasher seam's device.

Ingest queues -> validate/defer/drop -> dedup + persist records -> per-row
double-vote checks -> ONE batched row update per touched validator-chunk row
(arrays.py) -> host-side confirmation of flagged surrounds -> harvestable
slashings.

The reference walks each (attestation, validator) pair through sequential
chunk updates inside an LMDB transaction (slasher.rs:222-291); here every
touched row's full window is updated in one batched update, and
only the flag confirmations (rare) do per-item host work.
"""

from __future__ import annotations

import threading
from collections import defaultdict

from ..types.containers import AttestationData, ProposerSlashing
from .arrays import update_rows
from .config import SlasherConfig
from .db import SlasherDB


class Slasher:
    def __init__(self, store, types, config: SlasherConfig | None = None, *, device=None):
        """``device``: where the row update runs (None: the slasher seam's
        device, CUDA unless ``set_backend`` named another; raises without
        CUDA)."""
        from ..device import resolve_device
        from . import get_device

        self.config = config or SlasherConfig()
        self.config.validate()
        self.device = resolve_device(get_device() if device is None else device)
        self.db = SlasherDB(store, self.config, types)
        self.types = types
        self._att_queue: list = []
        self._block_queue: list = []
        self._attester_slashings: dict[bytes, object] = {}
        self._proposer_slashings: dict[bytes, object] = {}
        self._lock = threading.Lock()

    # -- ingest (ref slasher.rs:87-95) ---------------------------------------

    def accept_attestation(self, indexed_attestation) -> None:
        with self._lock:
            self._att_queue.append(indexed_attestation)

    def accept_block_header(self, signed_header) -> None:
        with self._lock:
            self._block_queue.append(signed_header)

    # -- harvest (ref slasher.rs:69-77) --------------------------------------

    def get_attester_slashings(self) -> list:
        with self._lock:
            out = list(self._attester_slashings.values())
            self._attester_slashings.clear()
        return out

    def get_proposer_slashings(self) -> list:
        with self._lock:
            out = list(self._proposer_slashings.values())
            self._proposer_slashings.clear()
        return out

    # -- processing -----------------------------------------------------------

    def process_queued(self, current_epoch: int) -> dict:
        """Apply all queued blocks + attestations; returns batch stats
        (ref slasher.rs:98-107)."""
        with self._lock:
            blocks, self._block_queue = self._block_queue, []
            atts, self._att_queue = self._att_queue, []

        n_prop = self._process_blocks(blocks)
        stats = self._process_attestations(atts, current_epoch)
        stats["blocks_processed"] = len(blocks)
        stats["proposer_slashings"] = n_prop
        self.db.flush_rows()
        return stats

    def _process_blocks(self, blocks) -> int:
        found = 0
        for header in blocks:
            existing = self.db.check_or_insert_block_proposal(header)
            if existing is not None:
                slashing = ProposerSlashing(
                    signed_header_1=existing, signed_header_2=header
                )
                key = ProposerSlashing.hash_tree_root(slashing)
                with self._lock:
                    self._proposer_slashings.setdefault(key, slashing)
                found += 1
        return found

    def _validate(self, atts, current_epoch: int):
        """Split into (keep, deferred, dropped) — ref slasher.rs:336-368.

        Note the drop window is keyed on SOURCE epoch, matching the
        reference (slasher.rs:350-352): the min/max arrays only cover
        ``history_length`` epochs, so an attestation whose source has left
        the window cannot be recorded — bounded memory is the design
        trade-off, not an oversight.
        """
        keep, defer, dropped = [], [], 0
        for att in atts:
            src = int(att.data.source.epoch)
            tgt = int(att.data.target.epoch)
            if src > tgt or src + self.config.history_length <= current_epoch:
                dropped += 1
            elif tgt > current_epoch:
                defer.append(att)
            else:
                keep.append(att)
        return keep, defer, dropped

    def _process_attestations(self, atts, current_epoch: int) -> dict:
        keep, deferred, dropped = self._validate(atts, current_epoch)
        with self._lock:
            self._att_queue.extend(deferred)

        # Dedup identical indexed attestations, persist, and assign ids.
        batch = []  # (att, data_root, att_id)
        seen = set()
        t = self.types.IndexedAttestation
        for att in keep:
            root = t.hash_tree_root(att)
            if root in seen:
                continue
            seen.add(root)
            att_id = self.db.store_indexed_attestation(att, root=root)
            data_root = AttestationData.hash_tree_root(att.data)
            batch.append((att, data_root, att_id))

        n_double = self._check_double_votes(batch)
        n_surround = self._update_arrays(batch, current_epoch)
        return {
            "attestations_processed": len(atts),
            "attestations_valid": len(keep),
            "attestations_deferred": len(deferred),
            "attestations_dropped": dropped,
            "double_vote_slashings": n_double,
            "surround_slashings": n_surround,
        }

    def _emit_attester_slashing(self, surrounder, other) -> None:
        """attestation_1 must be the surrounding/existing attestation for the
        slashing to validate on chain (ref lib.rs:52-92)."""
        from ..utils.logging import get_logger

        get_logger("slasher").info(
            "Found attester slashing",
            target=int(other.data.target.epoch),
        )
        t = self.types.AttesterSlashing
        slashing = t(attestation_1=surrounder, attestation_2=other)
        key = t.hash_tree_root(slashing)
        with self._lock:
            self._attester_slashings.setdefault(key, slashing)

    def _check_double_votes(self, batch) -> int:
        found = 0
        for att, data_root, att_id in batch:
            for v in att.attesting_indices:
                existing = self.db.check_and_update_attester_record(
                    int(v), att, data_root, att_id
                )
                if existing is not None:
                    # double vote: existing first (ref lib.rs:63-77)
                    self._emit_attester_slashing(existing, att)
                    found += 1
        return found

    def _update_arrays(self, batch, current_epoch: int) -> int:
        """Group (attestation, validator) pairs by validator-chunk row, run
        the batched row update, confirm flags host-side."""
        by_row: dict[int, list] = defaultdict(list)  # row -> [(v_off, att)]
        for att, _, _ in batch:
            for v in att.attesting_indices:
                v = int(v)
                by_row[self.config.validator_chunk_index(v)].append(
                    (self.config.validator_offset(v), v, att)
                )
        if not by_row:
            return 0

        row_ids = sorted(by_row)
        rows, pairs = [], []
        for rid in row_ids:
            rows.append(self.db.load_row(rid))
            pairs.append(
                [
                    (vo, int(a.data.source.epoch), int(a.data.target.epoch))
                    for vo, _, a in by_row[rid]
                ]
            )
        new_rows, results = update_rows(
            rows, pairs, current_epoch, self.config.history_length,
            device=self.device,
        )
        from ..utils.metrics import SLASHER_CHUNKS_UPDATED

        SLASHER_CHUNKS_UPDATED.inc(len(new_rows), array="minmax")

        found = 0
        for rid, (min_d, max_d), row_results in zip(row_ids, new_rows, results):
            self.db.store_row(rid, current_epoch, min_d, max_d)
            for (_, v, att), (min_f, min_t, max_f, max_t) in zip(
                by_row[rid], row_results
            ):
                found += self._confirm_surrounds(
                    v, att, min_f, min_t, max_f, max_t
                )
        return found

    def _confirm_surrounds(self, v, att, min_f, min_t, max_f, max_t) -> int:
        """Re-check a flagged pair against the fetched record; the flag alone
        can be a same-target double vote (ref array.rs:230-243 'Already
        DoubleVoted' branch), which the record path reports instead."""
        found = 0
        src = int(att.data.source.epoch)
        if min_f:
            try:
                existing = self.db.get_attestation_for_validator(v, min_t)
            except KeyError:
                existing = None
            if existing is not None and src < int(existing.data.source.epoch):
                self._emit_attester_slashing(att, existing)  # att surrounds
                found += 1
        if max_f:
            try:
                existing = self.db.get_attestation_for_validator(v, max_t)
            except KeyError:
                existing = None
            if existing is not None and int(existing.data.source.epoch) < src:
                self._emit_attester_slashing(existing, att)  # att surrounded
                found += 1
        return found

    def prune_database(self, current_epoch: int, slots_per_epoch: int) -> int:
        return self.db.prune(current_epoch, slots_per_epoch)
