"""Per-validator attestation packing weights (reward_cache.rs).

The max-cover packer should optimize actual proposer reward, not attester
head-count: a validator whose TIMELY_TARGET flag is already set in the state
being packed earns the proposer nothing, and attesters earn proportionally
to effective balance. The cache computes, per epoch referenced by packable
attestations (previous/current), a weight column:

    weight[i] = effective_balance[i] / EFFECTIVE_BALANCE_INCREMENT
                if TIMELY_TARGET not yet set for i in that epoch, else 0

Recomputed only when the packing state changes (keyed by state root+slot),
mirroring the reference's invalidation-on-state-change contract
(``operation_pool/src/reward_cache.rs``).

The port's copy of ``lighthouse_tpu/op_pool/reward_cache.py``.
"""

from __future__ import annotations

import numpy as np

TIMELY_TARGET_FLAG_INDEX = 1  # participation flag bit (altair spec)


class RewardCache:
    def __init__(self):
        self._key = None
        self._weights: dict[int, np.ndarray] = {}  # epoch -> weight column

    def update(self, spec, state) -> None:
        key = (int(state.slot), bytes(state.latest_block_header.parent_root))
        if key == self._key:
            return
        self._key = key
        self._weights = {}
        eff = (
            np.asarray(
                [int(v.effective_balance) for v in state.validators],
                dtype=np.uint64,
            )
            // spec.effective_balance_increment
        )
        cur_epoch = spec.compute_epoch_at_slot(int(state.slot))
        target_bit = np.uint8(1 << TIMELY_TARGET_FLAG_INDEX)
        if hasattr(state, "current_epoch_participation"):
            cur = np.asarray(state.current_epoch_participation, dtype=np.uint8)
            prev = np.asarray(
                state.previous_epoch_participation, dtype=np.uint8
            )
            self._weights[cur_epoch] = np.where(
                cur & target_bit, np.uint64(0), eff
            )
            if cur_epoch > 0:
                self._weights[cur_epoch - 1] = np.where(
                    prev & target_bit, np.uint64(0), eff
                )
        else:
            # phase0: no participation flags on the state; weight by balance
            # alone (the reference's cache is altair+ for the same reason)
            self._weights[cur_epoch] = eff
            if cur_epoch > 0:
                self._weights[cur_epoch - 1] = eff

    def weights_for_epoch(self, epoch: int, n_validators: int) -> np.ndarray:
        w = self._weights.get(int(epoch))
        if w is None or w.shape[0] != n_validators:
            return np.ones(n_validators, dtype=np.uint64)
        return w
