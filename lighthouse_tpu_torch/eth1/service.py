"""Eth1 service: follow the eth1 chain, vote on eth1_data, supply deposits.

The port's copy of ``lighthouse_tpu/eth1/service.py`` (Lighthouse's
``beacon_node/eth1/src/service.rs`` and the op-side of
``beacon_chain/src/eth1_chain.rs``): poll the provider for new blocks and
deposit logs, then answer two block-production questions —

  * ``eth1_data_vote(state)``: the spec ``get_eth1_vote`` — candidate blocks
    inside the voting-period follow-distance window, tallied against the
    state's current votes, falling back to the state's eth1_data.
  * ``deposits_for_inclusion(state)``: the next provable deposits the state
    expects (eth1_deposit_index .. eth1_data.deposit_count, capped at
    MAX_DEPOSITS) with proofs against the state's deposit root.
"""

from __future__ import annotations

from ..types.containers import Eth1Data
from ..utils.logging import get_logger
from .deposit_cache import DepositCache
from .provider import Eth1Provider

log = get_logger("eth1")


class Eth1Service:
    def __init__(self, spec, provider: Eth1Provider,
                 follow_distance: int = 16):
        self.spec = spec
        self.provider = provider
        self.follow_distance = follow_distance
        self.deposits = DepositCache()
        self._synced_to = -1
        self._count_cursor = 0  # deposits attributed to blocks so far
        # block_number -> (hash, timestamp, deposit_count at that block);
        # pruned to ~2x the voting window
        self._blocks: dict[int, tuple[bytes, int, int]] = {}

    # -- ingest -------------------------------------------------------------

    def update(self) -> int:
        """Pull new blocks + deposit logs (the periodic poll). Returns the
        number of new deposit logs ingested."""
        head = self.provider.latest_block_number()
        if head <= self._synced_to:
            return 0
        new_logs = self.provider.get_deposit_logs(self._synced_to + 1, head)
        for lg in new_logs:
            self.deposits.insert_log(lg)
        count = self._count_cursor
        for n in range(self._synced_to + 1, head + 1):
            blk = self.provider.get_block(n)
            while (
                count < len(self.deposits.logs)
                and self.deposits.logs[count].block_number <= n
            ):
                count += 1
            prev_count = self._blocks.get(n - 1, (None, None, 0))[2]
            self._blocks[n] = (blk.hash, blk.timestamp, max(count, prev_count))
        self._count_cursor = count
        self._synced_to = head
        # header cache pruning BY TIMESTAMP: the voting window reaches back
        # one voting period + 2x the follow distance from the period start,
        # which itself can lag the eth1 head — keep twice that horizon
        period_secs = (
            self.spec.preset.slots_per_eth1_voting_period
            * self.spec.preset.SECONDS_PER_SLOT
        )
        latest_ts = self._blocks[head][1]
        horizon = latest_ts - 2 * (period_secs + 2 * self.follow_distance * 14)
        for n in [k for k, (_, ts, _c) in self._blocks.items() if ts < horizon]:
            del self._blocks[n]
        if new_logs:
            log.info(
                "Eth1 deposits ingested",
                new=len(new_logs), total=len(self.deposits),
            )
        return len(new_logs)

    # -- block production answers ------------------------------------------

    def _voting_candidates(self, state) -> list[Eth1Data]:
        spec = self.spec
        period_start = _voting_period_start_time(spec, state)
        follow_secs = self.follow_distance * 14  # SECONDS_PER_ETH1_BLOCK
        in_window = [
            n
            for n, (_, ts, _c) in self._blocks.items()
            if period_start - 2 * follow_secs <= ts <= period_start - follow_secs
        ]
        out = []
        root_cache: dict[int, bytes] = {}  # counts repeat across blocks
        for n in sorted(in_window, reverse=True):
            h, _ts, count = self._blocks[n]
            if count < int(state.eth1_data.deposit_count):
                continue  # deposit count may never decrease
            if count not in root_cache:
                root_cache[count] = self.deposits.deposit_root(count)
            out.append(
                Eth1Data(
                    deposit_root=root_cache[count],
                    deposit_count=count,
                    block_hash=h,
                )
            )
        return out

    def eth1_data_vote(self, state) -> Eth1Data:
        """spec ``get_eth1_vote``: majority of in-period votes among valid
        candidates, else the most recent candidate, else the state's own."""
        candidates = self._voting_candidates(state)
        if not candidates:
            return state.eth1_data
        roots = {Eth1Data.hash_tree_root(c): c for c in candidates}
        tally: dict[bytes, int] = {}
        for vote in state.eth1_data_votes:
            r = Eth1Data.hash_tree_root(vote)
            if r in roots:
                tally[r] = tally.get(r, 0) + 1
        if tally:
            best = max(tally.items(), key=lambda kv: kv[1])[0]
            return roots[best]
        return candidates[0]

    def deposits_for_inclusion(self, state, eth1_data=None) -> list:
        """The exact deposits the state transition will demand. ``eth1_data``
        overrides the state's (callers pass the post-vote data). A cache that
        cannot prove owed deposits is an ERROR — silently returning fewer
        than expected would make the proposer build an invalid block
        (Eth1Chain::DepositsUnknown semantics)."""
        data = state.eth1_data if eth1_data is None else eth1_data
        start = int(state.eth1_deposit_index)
        count = int(data.deposit_count)
        end = min(count, start + self.spec.preset.MAX_DEPOSITS)
        if end <= start:
            return []
        if count > len(self.deposits):
            raise RuntimeError(
                f"deposit cache not synced: state expects {count} deposits, "
                f"cache has {len(self.deposits)}"
            )
        return self.deposits.get_deposits(start, end, count)


def _voting_period_start_time(spec, state) -> int:
    period_slots = (
        spec.preset.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.preset.SLOTS_PER_EPOCH
    )
    start_slot = int(state.slot) - int(state.slot) % period_slots
    return int(state.genesis_time) + start_slot * spec.preset.SECONDS_PER_SLOT
