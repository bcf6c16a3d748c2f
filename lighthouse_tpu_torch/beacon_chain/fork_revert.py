"""Fork revert: recover from an unusable head (fork_revert.rs).

Twin of ``beacon_chain/src/fork_revert.rs`` ``revert_to_fork_boundary``
(the port's copy of ``lighthouse_tpu/beacon_chain/fork_revert.py``):
when the head chain turns out to be unusable — a corrupt head state, or an
execution payload the EL later declared invalid — the node must not die or
stay wedged on the bad branch. The recovery rebuilds fork choice from the
finalized checkpoint (the last point with an absolute guarantee) and
re-plays every known block that does NOT descend from the bad block, so
healthy competing branches keep their place and the bad subtree is erased
from block/state maps and fork-choice alike.
"""

from __future__ import annotations

import numpy as np

from ..fork_choice.fork_choice import ForkChoice
from ..fork_choice.proto_array import ExecutionStatus
from ..utils.logging import get_logger

log = get_logger("fork_revert")


def _descends_from(chain, root: bytes, ancestor: bytes, stop: bytes) -> bool:
    """Does ``root`` have ``ancestor`` on its parent path (walking at most
    to ``stop``)?"""
    seen = 0
    while root in chain._blocks and seen < 2**20:
        if root == ancestor:
            return True
        if root == stop:
            return False
        root = bytes(chain._blocks[root].message.parent_root)
        seen += 1
    return root == ancestor


def revert_to_fork_boundary(chain, bad_root: bytes) -> bytes:
    """Rebuild fork choice anchored at the finalized checkpoint, dropping
    the subtree rooted at ``bad_root``. Returns the new head root."""
    spec = chain.spec
    fin_epoch, fin_root = chain.fork_choice.store.finalized_checkpoint
    anchor_root = (
        fin_root
        if fin_root in chain._seen_blocks
        and (fin_root in chain._blocks or fin_root == chain.genesis_block_root)
        else chain.genesis_block_root
    )
    with chain.lock:
        anchor_state = chain.state_by_root(anchor_root)
        jc = (
            max(int(fin_epoch), spec.compute_epoch_at_slot(int(anchor_state.slot))),
            anchor_root,
        )
        fc = ForkChoice.from_anchor(
            spec,
            anchor_root,
            int(anchor_state.slot),
            jc,
            jc,
            np.asarray(anchor_state.balances, dtype=np.uint64),
        )
        # drop the bad subtree, then replay survivors in slot order
        doomed = {
            root
            for root in chain._blocks
            if _descends_from(chain, root, bad_root, anchor_root)
        }
        for root in doomed:
            chain._blocks.pop(root, None)
            chain._states.pop(root, None)
            chain._seen_blocks.discard(root)
        survivors = sorted(
            (
                (int(sb.message.slot), root, sb)
                for root, sb in chain._blocks.items()
                if root != anchor_root
                and _descends_from(chain, root, anchor_root, b"")
                and int(sb.message.slot) > int(anchor_state.slot)
            ),
        )
        current_slot = max(
            (s for s, _, _ in survivors), default=int(anchor_state.slot)
        )
        fc.update_time(current_slot)
        replayed = 0
        for slot, root, sb in survivors:
            state = chain._states.get(root)
            if state is None:
                try:
                    state = chain.state_by_root(root)
                except Exception:  # noqa: BLE001 — unloadable: drop it too
                    chain._blocks.pop(root, None)
                    chain._seen_blocks.discard(root)
                    continue
            try:
                fc.on_block(
                    current_slot,
                    sb.message,
                    root,
                    state,
                    justified_balances=chain._justified_balances(
                        bytes(state.current_justified_checkpoint.root), state
                    ),
                    execution_status=ExecutionStatus.OPTIMISTIC
                    if getattr(sb.message.body, "execution_payload", None)
                    is not None
                    else ExecutionStatus.IRRELEVANT,
                )
                replayed += 1
            except Exception as e:  # noqa: BLE001 — unviable after revert
                log.warn(
                    "Dropped block during revert",
                    root=root.hex()[:12], error=str(e),
                )
                chain._blocks.pop(root, None)
                chain._states.pop(root, None)
                chain._seen_blocks.discard(root)
        chain.fork_choice = fc
        new_head = chain.recompute_head()
    log.warn(
        "Chain reverted to fork boundary",
        anchor=anchor_root.hex()[:12],
        dropped=len(doomed),
        replayed=replayed,
        new_head=new_head.hex()[:12],
    )
    return new_head
