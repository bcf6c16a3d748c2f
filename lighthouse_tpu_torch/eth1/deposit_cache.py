"""Deposit cache: the incremental deposit-contract merkle tree + proofs.

The port's copy of ``lighthouse_tpu/eth1/deposit_cache.py`` (Lighthouse's
``beacon_node/eth1/src/deposit_cache.rs``): ordered deposit logs, the
depth-32 sparse merkle tree the deposit contract maintains on chain, and
proof generation for block inclusion — each proof is the 32-branch plus the
little-endian count mix-in (depth 33), matching what
``process_deposit`` verifies (per_block.py / spec ``is_valid_merkle_branch``).
"""

from __future__ import annotations

from dataclasses import dataclass
from hashlib import sha256 as _sha

from ..types.containers import Deposit, DepositData

DEPOSIT_TREE_DEPTH = 32


def _h(a: bytes, b: bytes) -> bytes:
    return _sha(a + b).digest()


_ZERO_HASHES: list[bytes] = [b"\x00" * 32]
for _ in range(DEPOSIT_TREE_DEPTH):
    _ZERO_HASHES.append(_h(_ZERO_HASHES[-1], _ZERO_HASHES[-1]))


@dataclass
class DepositLog:
    """One DepositEvent from the contract (deposit_log.rs)."""

    data: DepositData
    block_number: int
    index: int


class DepositCache:
    def __init__(self):
        self.logs: list[DepositLog] = []
        self._leaves: list[bytes] = []

    def insert_log(self, log: DepositLog) -> None:
        if log.index != len(self.logs):
            raise ValueError(
                f"non-consecutive deposit index {log.index}, "
                f"expected {len(self.logs)}"
            )
        self.logs.append(log)
        self._leaves.append(DepositData.hash_tree_root(log.data))

    def __len__(self) -> int:
        return len(self.logs)

    # -- tree ---------------------------------------------------------------

    def _level_nodes(self, count: int) -> list[list[bytes]]:
        """All tree levels for the first ``count`` leaves (level 0 = leaves,
        zero-padded virtually)."""
        levels = [self._leaves[:count]]
        for d in range(DEPOSIT_TREE_DEPTH):
            prev = levels[-1]
            nxt = []
            for i in range(0, len(prev), 2):
                left = prev[i]
                right = prev[i + 1] if i + 1 < len(prev) else _ZERO_HASHES[d]
                nxt.append(_h(left, right))
            levels.append(nxt)
        return levels

    def deposit_root(self, count: int | None = None) -> bytes:
        """Contract ``get_deposit_root()``: tree root mixed with the count."""
        count = len(self.logs) if count is None else count
        levels = self._level_nodes(count)
        root = levels[-1][0] if levels[-1] else _ZERO_HASHES[DEPOSIT_TREE_DEPTH]
        return _h(root, count.to_bytes(32, "little"))

    def get_deposits(self, start: int, end: int, deposit_count: int) -> list[Deposit]:
        """Deposits [start, end) with proofs against the ``deposit_count``-leaf
        tree (what goes into a block; deposit_cache.rs get_deposits)."""
        if end > deposit_count or deposit_count > len(self.logs):
            raise ValueError("deposit range exceeds known logs")
        levels = self._level_nodes(deposit_count)
        out = []
        for i in range(start, end):
            branch = []
            idx = i
            for d in range(DEPOSIT_TREE_DEPTH):
                sib = idx ^ 1
                level = levels[d]
                branch.append(
                    level[sib] if sib < len(level) else _ZERO_HASHES[d]
                )
                idx >>= 1
            branch.append(deposit_count.to_bytes(32, "little"))
            out.append(Deposit(proof=branch, data=self.logs[i].data))
        return out
