"""The operation pool (operation_pool/src/lib.rs:48).

Attestations are stored split by checkpoint (epoch, source) and keyed by
``AttestationData`` root with their union-aggregated variants
(attestation_storage.rs); ``get_attestations`` (lib.rs:250) packs a block via
greedy max-cover over per-attestation reward scores; slashings and exits
dedupe by their slashable targets (lib.rs:388).

The port's copy of ``lighthouse_tpu/op_pool/pool.py``.
"""

from __future__ import annotations

import threading

import numpy as np

from .. import bls
from ..oracle import curves as oc
from ..state_transition.beacon_state_util import (
    get_attesting_indices, get_beacon_committee, get_current_epoch,
    get_previous_epoch,
)
from ..types.spec import ChainSpec
from .max_cover import maximum_cover


class OperationPool:
    def __init__(self, spec: ChainSpec, attestation_cls):
        self.spec = spec
        self.att_cls = attestation_cls
        # data_root -> (data, list[(bits, sig_point)])
        self._attestations: dict[bytes, tuple] = {}
        self._attester_slashings: list = []
        self._proposer_slashings: dict[int, object] = {}
        self._voluntary_exits: dict[int, object] = {}
        self._bls_changes: dict[int, object] = {}
        # The reference wraps each map in its own RwLock (lib.rs:48-60);
        # here one pool lock serializes inserts (HTTP publishers) against
        # packing reads (block production).
        self._lock = threading.RLock()
        from .reward_cache import RewardCache

        self.reward_cache = RewardCache()

    # -- attestations (insert_attestation, lib.rs:200) ---------------------------

    def insert_attestation(self, attestation) -> None:
        with self._lock:
            self._insert_attestation(attestation)

    def _insert_attestation(self, attestation) -> None:
        data = attestation.data
        root = type(data).hash_tree_root(data)
        bits = np.asarray(attestation.aggregation_bits, dtype=bool)
        sig = bls.g2_point(bytes(attestation.signature))
        entry = self._attestations.get(root)
        if entry is None:
            self._attestations[root] = (data, [(bits, sig)])
            return
        _, variants = entry
        for i, (have, agg) in enumerate(variants):
            if ((have | bits) == have).all():
                return  # subset of an existing aggregate: nothing new
            if not (have & bits).any():
                variants[i] = (have | bits, oc.g2_add(agg, sig))
                return
        variants.append((bits, sig))

    def num_attestations(self) -> int:
        with self._lock:
            return sum(len(v) for _, v in self._attestations.values())

    def get_attestations(self, state, ctxt_reward_fn=None) -> list:
        """Max-cover packed attestations valid for inclusion in a block built
        on ``state`` (lib.rs:250)."""
        spec = self.spec
        cur, prev = get_current_epoch(spec, state), get_previous_epoch(spec, state)
        candidates = []
        n_val = len(state.validators)
        self.reward_cache.update(spec, state)
        with self._lock:
            entries = [
                (data, [(b.copy(), s) for b, s in variants])
                for data, variants in self._attestations.values()
            ]
        for data, variants in entries:
            if data.target.epoch not in (cur, prev):
                continue
            if not (
                data.slot + spec.min_attestation_inclusion_delay
                <= state.slot
                <= data.slot + spec.preset.SLOTS_PER_EPOCH
            ):
                continue
            # source must match the state's justified checkpoint
            justified = (
                state.current_justified_checkpoint
                if data.target.epoch == cur
                else state.previous_justified_checkpoint
            )
            if data.source != justified:
                continue
            try:
                committee = get_beacon_committee(spec, state, data.slot, data.index)
            except Exception:
                continue
            for bits, sig in variants:
                if bits.size != committee.size:
                    continue
                mask = np.zeros(n_val, dtype=bool)
                mask[committee[bits].astype(np.int64)] = True
                weights = self.reward_cache.weights_for_epoch(
                    int(data.target.epoch), n_val
                )
                att = self.att_cls(
                    aggregation_bits=bits.copy(), data=data,
                    signature=oc.g2_compress(sig),
                )
                candidates.append((mask, weights, att))
        return maximum_cover(candidates, self.spec.preset.MAX_ATTESTATIONS)

    # -- slashings / exits -------------------------------------------------------

    def insert_proposer_slashing(self, slashing) -> None:
        idx = int(slashing.signed_header_1.message.proposer_index)
        with self._lock:
            self._proposer_slashings.setdefault(idx, slashing)

    def insert_attester_slashing(self, slashing) -> None:
        with self._lock:
            self._attester_slashings.append(slashing)

    def insert_voluntary_exit(self, exit_msg) -> None:
        idx = int(exit_msg.message.validator_index)
        with self._lock:
            self._voluntary_exits.setdefault(idx, exit_msg)

    def insert_bls_to_execution_change(self, signed_change) -> None:
        idx = int(signed_change.message.validator_index)
        with self._lock:
            self._bls_changes.setdefault(idx, signed_change)

    def get_bls_to_execution_changes(self, state) -> list:
        """Changes still applicable (validator still has a BLS credential),
        bounded by MAX_BLS_TO_EXECUTION_CHANGES
        (lib.rs get_bls_to_execution_changes)."""
        with self._lock:
            items = list(self._bls_changes.items())
        out = [
            c
            for i, c in items
            if i < len(state.validators)
            and bytes(state.validators[i].withdrawal_credentials)[:1] == b"\x00"
        ]
        limit = getattr(self.spec.preset, "MAX_BLS_TO_EXECUTION_CHANGES", 16)
        return out[:limit]

    def get_slashings_and_exits(self, state):
        from ..types.helpers import is_slashable_validator
        from ..types.spec import FAR_FUTURE_EPOCH

        epoch = get_current_epoch(self.spec, state)
        with self._lock:
            proposer_items = list(self._proposer_slashings.items())
            attester_slashings = list(self._attester_slashings)
            exit_items = list(self._voluntary_exits.items())
        proposer = [
            s
            for i, s in proposer_items
            if i < len(state.validators)
            and is_slashable_validator(state.validators[i], epoch)
        ][: self.spec.preset.MAX_PROPOSER_SLASHINGS]
        attester = []
        covered: set[int] = set()
        for sl in attester_slashings:
            common = set(int(i) for i in sl.attestation_1.attesting_indices) & set(
                int(i) for i in sl.attestation_2.attesting_indices
            )
            fresh = [
                i
                for i in common
                if i not in covered
                and i < len(state.validators)
                and is_slashable_validator(state.validators[i], epoch)
            ]
            if fresh:
                attester.append(sl)
                covered.update(fresh)
            if len(attester) >= self.spec.preset.MAX_ATTESTER_SLASHINGS:
                break
        exits = [
            e
            for i, e in exit_items
            if i < len(state.validators)
            and state.validators[i].exit_epoch == FAR_FUTURE_EPOCH
            and state.validators[i].activation_epoch != FAR_FUTURE_EPOCH
        ][: self.spec.preset.MAX_VOLUNTARY_EXITS]
        return proposer, attester, exits

    # -- maintenance -------------------------------------------------------------

    def prune(self, state) -> None:
        """Drop attestations/ops no longer includable (prune_all, lib.rs)."""
        cur = get_current_epoch(self.spec, state)
        with self._lock:
            self._prune_locked(state, cur)

    def _prune_locked(self, state, cur) -> None:
        self._attestations = {
            r: (d, v)
            for r, (d, v) in self._attestations.items()
            if d.target.epoch + 1 >= cur
        }
        self._voluntary_exits = {
            i: e
            for i, e in self._voluntary_exits.items()
            if i < len(state.validators)
            and state.validators[i].exit_epoch == 2**64 - 1
        }
