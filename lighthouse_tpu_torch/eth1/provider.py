"""Eth1 provider seam + in-process mock chain.

The port's copy of ``lighthouse_tpu/eth1/provider.py`` (Lighthouse's HTTP
JSON-RPC eth1 client, ``eth1/src/http.rs``): the
service only needs block-by-number reads and deposit-log ranges, so that is
the whole seam. ``MockEth1Provider`` plays the role of anvil + the deposit
contract in tests (``testing/eth1_test_rig``): deposits submitted to it are
assigned contract indices and surfaced as logs, blocks tick with timestamps.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from hashlib import sha256

from ..types.containers import DepositData
from .deposit_cache import DepositLog


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    parent_hash: bytes
    timestamp: int


class Eth1Provider:
    """What the eth1 service needs from the execution chain."""

    def latest_block_number(self) -> int:
        raise NotImplementedError

    def get_block(self, number: int) -> Eth1Block:
        raise NotImplementedError

    def get_deposit_logs(self, from_block: int, to_block: int) -> list[DepositLog]:
        raise NotImplementedError


class MockEth1Provider(Eth1Provider):
    """Deterministic in-process eth1 chain + deposit contract."""

    def __init__(self, genesis_timestamp: int = 0, block_interval: int = 14):
        self.block_interval = block_interval
        self._lock = threading.Lock()
        self._blocks: list[Eth1Block] = [
            Eth1Block(
                number=0,
                hash=sha256(b"eth1-genesis").digest(),
                parent_hash=b"\x00" * 32,
                timestamp=genesis_timestamp,
            )
        ]
        self._logs: list[DepositLog] = []

    # -- chain control (the test's side) -----------------------------------

    def mine_block(self) -> Eth1Block:
        with self._lock:
            prev = self._blocks[-1]
            blk = Eth1Block(
                number=prev.number + 1,
                hash=sha256(b"eth1-block-%d" % (prev.number + 1)).digest(),
                parent_hash=prev.hash,
                timestamp=prev.timestamp + self.block_interval,
            )
            self._blocks.append(blk)
            return blk

    def submit_deposit(self, data: DepositData) -> DepositLog:
        """The deposit contract's ``DepositEvent`` (lands in the NEXT block)."""
        with self._lock:
            log = DepositLog(
                data=data,
                block_number=self._blocks[-1].number + 1,
                index=len(self._logs),
            )
            self._logs.append(log)
        self.mine_block()
        return log

    # -- provider seam ------------------------------------------------------

    def latest_block_number(self) -> int:
        with self._lock:
            return self._blocks[-1].number

    def get_block(self, number: int) -> Eth1Block:
        with self._lock:
            return self._blocks[number]

    def get_deposit_logs(self, from_block: int, to_block: int) -> list[DepositLog]:
        with self._lock:
            return [
                l for l in self._logs
                if from_block <= l.block_number <= to_block
            ]
