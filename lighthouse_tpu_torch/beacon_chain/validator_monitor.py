"""Validator monitor: per-validator duty tracking on the beacon node.

The port's copy of ``lighthouse_tpu/beacon_chain/validator_monitor.py``
(Lighthouse's ``beacon_chain/src/validator_monitor.rs``): operators register
validator indices; the monitor taps the chain's attestation/block observer
seams, records per-epoch participation (attestations seen on gossip, head
correctness, blocks proposed), logs a per-epoch summary, and feeds the
Prometheus registry.
"""

from __future__ import annotations

from collections import defaultdict

from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

log = get_logger("validator_monitor")

MONITOR_ATTESTATIONS = REGISTRY.counter(
    "validator_monitor_attestations_total",
    "Gossip attestations seen from monitored validators",
)
MONITOR_BLOCKS = REGISTRY.counter(
    "validator_monitor_blocks_total",
    "Blocks proposed by monitored validators",
)


class ValidatorMonitor:
    def __init__(self, chain, indices=(), auto: bool = False):
        """``auto`` monitors every validator (validator_monitor.rs
        auto-register mode)."""
        self.chain = chain
        self.auto = auto
        self.indices: set[int] = {int(i) for i in indices}
        # epoch -> index -> {"attested": n, "head_correct": n, "blocks": n}
        self._epochs: dict[int, dict[int, dict]] = defaultdict(
            lambda: defaultdict(lambda: {"attested": 0, "head_correct": 0,
                                         "blocks": 0})
        )
        self._last_logged_epoch = -1
        chain.attestation_observers.append(self._on_attestation)
        chain.block_observers.append(self._on_block)

    def add_validator(self, index: int) -> None:
        self.indices.add(int(index))

    def _tracked(self, index: int) -> bool:
        return self.auto or int(index) in self.indices

    # -- observer taps ------------------------------------------------------

    def _on_attestation(self, indexed) -> None:
        epoch = int(indexed.data.target.epoch)
        head_ok = bytes(indexed.data.beacon_block_root) in self.chain._seen_blocks
        for i in indexed.attesting_indices:
            if not self._tracked(i):
                continue
            rec = self._epochs[epoch][int(i)]
            rec["attested"] += 1
            if head_ok:
                rec["head_correct"] += 1
            MONITOR_ATTESTATIONS.inc()
        self._maybe_log(epoch)

    def _on_block(self, signed_block) -> None:
        blk = signed_block.message
        epoch = self.chain.spec.compute_epoch_at_slot(int(blk.slot))
        proposer = int(blk.proposer_index)
        if self._tracked(proposer):
            self._epochs[epoch][proposer]["blocks"] += 1
            MONITOR_BLOCKS.inc()
        self._maybe_log(epoch)

    # -- reporting ----------------------------------------------------------

    def epoch_summary(self, epoch: int) -> dict:
        recs = self._epochs.get(epoch, {})
        return {
            "epoch": epoch,
            "validators": len(recs),
            "attestations": sum(r["attested"] for r in recs.values()),
            "head_correct": sum(r["head_correct"] for r in recs.values()),
            "blocks": sum(r["blocks"] for r in recs.values()),
        }

    def validator_record(self, epoch: int, index: int) -> dict | None:
        recs = self._epochs.get(epoch)
        if recs is None or int(index) not in recs:
            return None
        return dict(recs[int(index)])

    def _maybe_log(self, epoch: int) -> None:
        """One summary line per completed epoch (Lighthouse's
        per-epoch validator monitor logs)."""
        done = epoch - 1
        if done <= self._last_logged_epoch or done < 0:
            return
        if done in self._epochs:
            log.info("Validator monitor epoch summary",
                     **self.epoch_summary(done))
        self._last_logged_epoch = done
        for old in [e for e in self._epochs if e < done - 2]:
            del self._epochs[old]
