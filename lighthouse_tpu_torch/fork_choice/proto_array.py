"""Array-backed LMD-GHOST fork-choice graph.

Parity: ``consensus/proto_array/src/proto_array.rs`` and
``proto_array_fork_choice.rs:357``. Nodes live in an append-only array with
parent indices; weight propagation is a single reverse sweep applying score
deltas child→parent and recomputing best_child/best_descendant — O(n) per
call, no recursion. Votes (``VoteTracker``, ``:25``) are columnar numpy arrays
indexed by validator: the 1M-validator vote table is three uint64/int64
columns, and the per-epoch delta computation is a vectorized gather/scatter
(``fork_choice_test_definition`` semantics). The port's copy of
``lighthouse_tpu/fork_choice/proto_array.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class ExecutionStatus(enum.Enum):
    """Optimistic-sync payload status (proto_array/src/proto_array_fork_choice.rs)."""

    VALID = "valid"
    INVALID = "invalid"
    OPTIMISTIC = "optimistic"  # not yet verified by an EL
    IRRELEVANT = "irrelevant"  # pre-merge block


@dataclass
class ProtoNode:
    root: bytes
    parent: int | None
    justified_epoch: int
    finalized_epoch: int
    slot: int
    state_root: bytes = b""
    target_root: bytes = b""
    execution_block_hash: bytes | None = None
    execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT
    weight: int = 0
    best_child: int | None = None
    best_descendant: int | None = None
    unrealized_justified_epoch: int | None = None
    unrealized_finalized_epoch: int | None = None


class ProtoArrayError(Exception):
    pass


class ProtoArrayForkChoice:
    def __init__(
        self,
        finalized_root: bytes,
        finalized_slot: int,
        justified_epoch: int,
        finalized_epoch: int,
        justified_root: bytes | None = None,
    ):
        self.nodes: list[ProtoNode] = []
        self.indices: dict[bytes, int] = {}
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        self.justified_root = justified_root or finalized_root
        self.finalized_root = finalized_root
        self.proposer_boost_root: bytes = b"\x00" * 32
        # votes: columnar (current_root_idx+1, next_root_idx+1, next_epoch);
        # 0 means "no vote" — index offset by one for vectorized handling
        self._vote_cur = np.zeros(0, dtype=np.int64)
        self._vote_next = np.zeros(0, dtype=np.int64)
        self._vote_epoch = np.zeros(0, dtype=np.uint64)
        self._old_balances = np.zeros(0, dtype=np.int64)  # last-applied balances
        self._root_ids: dict[bytes, int] = {}
        self._id_roots: list[bytes] = [b"\x00" * 32]  # id 0 = null
        # memoized descends-from-finalized, invalidated on finalization
        self._fin_desc_key: bytes | None = None
        self._fin_desc: dict[int, bool] = {}
        self.on_block(
            slot=finalized_slot,
            root=finalized_root,
            parent_root=None,
            state_root=b"\x00" * 32,
            target_root=finalized_root,
            justified_epoch=justified_epoch,
            finalized_epoch=finalized_epoch,
            execution_status=ExecutionStatus.IRRELEVANT,
        )

    # -- roots <-> small ids for the vote table --------------------------------

    def _root_id(self, root: bytes) -> int:
        rid = self._root_ids.get(root)
        if rid is None:
            rid = len(self._id_roots)
            self._root_ids[root] = rid
            self._id_roots.append(root)
        return rid

    def _ensure_votes(self, n_validators: int) -> None:
        cur = self._vote_cur.shape[0]
        if n_validators > cur:
            grow = n_validators - cur
            self._vote_cur = np.concatenate([self._vote_cur, np.zeros(grow, np.int64)])
            self._vote_next = np.concatenate([self._vote_next, np.zeros(grow, np.int64)])
            self._vote_epoch = np.concatenate(
                [self._vote_epoch, np.zeros(grow, np.uint64)]
            )

    # -- block insertion (proto_array.rs on_block) ------------------------------

    def get_node(self, root: bytes):
        idx = self.indices.get(root)
        return self.nodes[idx] if idx is not None else None

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        state_root: bytes,
        target_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
        execution_block_hash: bytes | None = None,
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
        unrealized_justified_epoch: int | None = None,
        unrealized_finalized_epoch: int | None = None,
    ) -> None:
        if root in self.indices:
            return
        parent = self.indices.get(parent_root) if parent_root else None
        idx = len(self.nodes)
        self.nodes.append(
            ProtoNode(
                root=root,
                parent=parent,
                justified_epoch=justified_epoch,
                finalized_epoch=finalized_epoch,
                slot=slot,
                state_root=state_root,
                target_root=target_root,
                execution_block_hash=execution_block_hash,
                execution_status=execution_status,
                unrealized_justified_epoch=unrealized_justified_epoch,
                unrealized_finalized_epoch=unrealized_finalized_epoch,
            )
        )
        self.indices[root] = idx
        if parent is not None:
            self._maybe_update_best_child(parent, idx)

    # -- votes (proto_array_fork_choice.rs:432 process_attestation) -------------

    def process_attestation(
        self, validator_index: int, block_root: bytes, target_epoch: int
    ) -> None:
        self.process_attestations([validator_index], block_root, target_epoch)

    def process_attestations(self, validator_indices, block_root: bytes, target_epoch: int) -> None:
        """The vote rule for each of an attestation's validator indices
        (sorted and unique, as an indexed attestation's are), as one
        vectorised update: a vote moves to ``block_root`` when its target
        epoch is newer or the validator has not voted. The vote table grows
        once to the largest index, not at every new maximum (quadratic in a
        2^20 registry)."""
        idx = np.asarray(validator_indices, dtype=np.int64)
        if idx.size == 0:
            return
        self._ensure_votes(int(idx.max()) + 1)
        upd = idx[(np.uint64(target_epoch) > self._vote_epoch[idx])
                  | ((self._vote_cur[idx] == 0) & (self._vote_next[idx] == 0))]
        if upd.size:
            self._vote_next[upd] = self._root_id(block_root)
            self._vote_epoch[upd] = target_epoch

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        a = self.indices.get(ancestor_root)
        d = self.indices.get(descendant_root)
        if a is None or d is None:
            return False
        a_slot = self.nodes[a].slot
        while d is not None and self.nodes[d].slot > a_slot:
            d = self.nodes[d].parent
        return d == a

    # -- head (find_head + apply_score_changes) ---------------------------------

    def find_head(
        self,
        justified_epoch: int,
        justified_root: bytes,
        finalized_epoch: int,
        justified_state_balances: np.ndarray,
        proposer_boost_root: bytes = b"\x00" * 32,
        proposer_score_boost: int = 0,
        equivocating_indices=(),
        current_slot: int | None = None,
        slots_per_epoch: int = 32,
    ) -> bytes:
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        self.justified_root = justified_root
        if current_slot is not None:
            self._current_epoch = current_slot // slots_per_epoch
        deltas = self._compute_deltas(justified_state_balances, equivocating_indices)
        self._apply_score_changes(deltas, proposer_boost_root, proposer_score_boost,
                                  justified_state_balances, slots_per_epoch)
        ji = self.indices.get(justified_root)
        if ji is None:
            raise ProtoArrayError(f"unknown justified root {justified_root.hex()[:16]}")
        best = self.nodes[ji].best_descendant
        head = self.nodes[best if best is not None else ji]
        if not self._node_is_viable_for_head(head):
            raise ProtoArrayError("best node not viable for head")
        return head.root

    def _compute_deltas(self, balances: np.ndarray, equivocating) -> np.ndarray:
        """Vectorized vote-delta sweep (proto_array/src/proto_array_fork_choice.rs
        compute_deltas): -balance at old vote root, +balance at new."""
        n = self._vote_cur.shape[0]
        deltas = np.zeros(len(self.nodes), dtype=np.int64)
        if n == 0:
            return deltas
        # old balance is subtracted at the previous vote root, new balance
        # added at the new one (compute_deltas in the reference keeps the
        # previously-applied balances for exactly this)
        old_bal = np.zeros(n, dtype=np.int64)
        m_old = min(n, self._old_balances.shape[0])
        old_bal[:m_old] = self._old_balances[:m_old]
        new_bal = np.zeros(n, dtype=np.int64)
        m = min(n, balances.shape[0])
        new_bal[:m] = balances[:m].astype(np.int64)
        if len(equivocating):
            eq = np.asarray(list(equivocating), dtype=np.int64)
            eq = eq[eq < n]
            new_bal[eq] = 0
            # equivocators' vote is removed and never re-added
            self._vote_next[eq] = 0
        # map vote ids -> node indices (-1 if unknown/pruned)
        id_to_idx = np.full(len(self._id_roots), -1, dtype=np.int64)
        for rid, root in enumerate(self._id_roots[1:], start=1):
            idx = self.indices.get(root)
            if idx is not None:
                id_to_idx[rid] = idx
        cur_idx = id_to_idx[self._vote_cur]
        next_idx = id_to_idx[self._vote_next]
        np.add.at(deltas, cur_idx[cur_idx >= 0], -old_bal[cur_idx >= 0])
        np.add.at(deltas, next_idx[next_idx >= 0], new_bal[next_idx >= 0])
        self._vote_cur = self._vote_next.copy()
        self._old_balances = new_bal
        return deltas

    def _apply_score_changes(
        self, deltas, proposer_boost_root, proposer_score_boost, balances,
        slots_per_epoch: int = 32,
    ):
        # proposer boost: committee-weight fraction added to one node; the
        # previously-applied boost is always removed first (the reference
        # stores the applied amount for exact reversal)
        boost = np.zeros(len(self.nodes), dtype=np.int64)
        prev_bi = self.indices.get(self.proposer_boost_root)
        if prev_bi is not None and getattr(self, "_prev_boost_score", 0):
            boost[prev_bi] -= self._prev_boost_score
        self._prev_boost_score = 0
        if proposer_boost_root != b"\x00" * 32 and proposer_score_boost:
            bi = self.indices.get(proposer_boost_root)
            total = int(balances.sum())
            # committee weight = total / slots_per_epoch (spec get_proposer_score)
            score = total // slots_per_epoch * proposer_score_boost // 100
            if bi is not None:
                boost[bi] += score
                self._prev_boost_score = score
        self.proposer_boost_root = proposer_boost_root

        total_delta = deltas + boost
        # reverse sweep: apply delta, push to parent, update best child links
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            node.weight += int(total_delta[i])
            if node.parent is not None:
                total_delta[node.parent] += total_delta[i]
                self._maybe_update_best_child(node.parent, i)

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """Spec ``filter_block_tree`` viability (post-Capella fork choice,
        mirrored by the reference's ``node_is_viable_for_head``): the node's
        voting source must match the store's justified checkpoint OR be
        within the two-epoch grace window (``voting_source.epoch + 2 >=
        current_epoch`` — what lets descendants of a checkpoint-sync anchor
        whose own justification lags the invented anchor checkpoint become
        head), and the node must descend from the finalized checkpoint."""
        if node.execution_status == ExecutionStatus.INVALID:
            return False
        cj = node.unrealized_justified_epoch
        j = cj if cj is not None else node.justified_epoch
        ok_j = (
            self.justified_epoch == 0
            or j == self.justified_epoch
            or j + 2 >= getattr(self, "_current_epoch", 0)
        )
        ok_f = self.finalized_epoch == 0 or self._descends_from_finalized(
            node
        )
        return ok_j and ok_f

    def _descends_from_finalized(self, node: ProtoNode) -> bool:
        """Memoized finalized-ancestry: viability runs per node on the head
        hot path, so the parent walk amortizes to O(1) per node instead of
        O(depth) (is_finalized_checkpoint_or_descendant in the reference)."""
        if self._fin_desc_key != self.finalized_root:
            self._fin_desc_key = self.finalized_root
            self._fin_desc = {}
        fi = self.indices.get(self.finalized_root)
        if fi is None:
            return True  # anchor not in the graph: nothing to filter on
        memo = self._fin_desc
        fslot = self.nodes[fi].slot
        path = []
        i = self.indices.get(node.root)
        while True:
            if i is None or self.nodes[i].slot < fslot:
                res = False
                break
            if i == fi:
                res = True
                break
            cached = memo.get(i)
            if cached is not None:
                res = cached
                break
            path.append(i)
            i = self.nodes[i].parent
        for p in path:
            memo[p] = res
        return res

    def _maybe_update_best_child(self, parent_idx: int, child_idx: int) -> None:
        parent = self.nodes[parent_idx]
        child = self.nodes[child_idx]
        child_viable = self._node_leads_to_viable_head(child)
        if parent.best_child == child_idx:
            if not child_viable:
                parent.best_child = None
                parent.best_descendant = None
                # re-scan children for a viable alternative
                for j, n in enumerate(self.nodes):
                    if n.parent == parent_idx and j != child_idx:
                        self._maybe_update_best_child(parent_idx, j)
            else:
                parent.best_descendant = (
                    child.best_descendant
                    if child.best_descendant is not None
                    else child_idx
                )
            return
        if not child_viable:
            return
        best = parent.best_child
        take = False
        if best is None:
            take = True
        else:
            bnode = self.nodes[best]
            if not self._node_leads_to_viable_head(bnode):
                take = True
            elif child.weight > bnode.weight:
                take = True
            elif child.weight == bnode.weight and child.root > bnode.root:
                take = True
        if take:
            parent.best_child = child_idx
            parent.best_descendant = (
                child.best_descendant if child.best_descendant is not None else child_idx
            )

    # -- invalidation (optimistic sync) -----------------------------------------

    def process_execution_payload_validation(self, root: bytes) -> None:
        idx = self.indices.get(root)
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == ExecutionStatus.OPTIMISTIC:
                node.execution_status = ExecutionStatus.VALID
            idx = node.parent

    def process_execution_payload_invalidation(self, root: bytes) -> None:
        """Mark root and all its descendants INVALID
        (proto_array_fork_choice.rs:423)."""
        start = self.indices.get(root)
        if start is None:
            return
        bad = {start}
        self.nodes[start].execution_status = ExecutionStatus.INVALID
        for i in range(start + 1, len(self.nodes)):
            if self.nodes[i].parent in bad:
                bad.add(i)
                self.nodes[i].execution_status = ExecutionStatus.INVALID
        # force best-child recomputation from scratch on next find_head
        for n in self.nodes:
            if n.best_child in bad:
                n.best_child = None
                n.best_descendant = None

    # -- pruning ----------------------------------------------------------------

    def maybe_prune(self, finalized_root: bytes, prune_threshold: int = 256) -> None:
        fi = self.indices.get(finalized_root)
        if fi is None or fi < prune_threshold:
            return
        keep = self.nodes[fi:]
        offset = fi
        self.indices = {}
        for n in keep:
            n.parent = n.parent - offset if n.parent is not None and n.parent >= offset else None
            n.best_child = n.best_child - offset if n.best_child is not None and n.best_child >= offset else None
            n.best_descendant = (
                n.best_descendant - offset
                if n.best_descendant is not None and n.best_descendant >= offset
                else None
            )
        self.nodes = keep
        for i, n in enumerate(self.nodes):
            self.indices[n.root] = i
        self.finalized_root = finalized_root
        # node indices shifted: the index-keyed ancestry memo is stale
        self._fin_desc_key = None
        self._fin_desc = {}
