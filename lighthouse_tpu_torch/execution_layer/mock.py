"""Mock execution layer: deterministic in-process payload chain.

The port's copy of ``lighthouse_tpu/execution_layer/mock.py`` (Lighthouse's
``execution_layer/src/test_utils/{mock_execution_layer,
execution_block_generator}.rs``): builds execution payloads whose block hashes
are deterministic functions of their contents, tracks the valid-hash set, and
exposes the fault-injection toggles Lighthouse's hook system provides
(``test_utils/hook.rs``; ``all_payloads_valid``-style switches at
``test_utils.rs:524``): force SYNCING (optimistic import) or INVALID.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..state_transition.genesis import GENESIS_BLOCK_HASH  # noqa: F401
from .engine import (
    ExecutionEngine,
    PayloadAttributes,
    PayloadStatus,
    PayloadStatusV1,
)



def compute_block_hash(payload) -> bytes:
    """Deterministic 'execution block hash': hash of the header-identifying
    fields (the mock's stand-in for the EL's RLP header hash)."""
    h = hashlib.sha256()
    h.update(bytes(payload.parent_hash))
    h.update(bytes(payload.prev_randao))
    h.update(int(payload.block_number).to_bytes(8, "little"))
    h.update(int(payload.timestamp).to_bytes(8, "little"))
    h.update(int(payload.gas_limit).to_bytes(8, "little"))
    for tx in payload.transactions:
        h.update(hashlib.sha256(bytes(tx)).digest())
    for w in getattr(payload, "withdrawals", []):
        h.update(type(w).encode(w))
    return h.digest()


@dataclass
class ExecutionBlockGenerator:
    """Tracks the mock execution chain: known-valid block hashes and block
    numbers, and builds child payloads on request."""

    blocks: dict = field(
        default_factory=lambda: {GENESIS_BLOCK_HASH: 0}
    )  # hash -> number

    def produce_payload(
        self,
        payload_cls,
        parent_hash: bytes,
        timestamp: int,
        prev_randao: bytes,
        fee_recipient: bytes = b"\x00" * 20,
        withdrawals: list | None = None,
        transactions: list | None = None,
    ):
        if parent_hash not in self.blocks:
            raise ValueError(f"unknown parent execution block {parent_hash.hex()[:16]}")
        number = self.blocks[parent_hash] + 1
        payload = payload_cls(
            parent_hash=parent_hash,
            fee_recipient=fee_recipient,
            state_root=hashlib.sha256(b"el-state-%d" % number).digest(),
            receipts_root=hashlib.sha256(b"receipts-%d" % number).digest(),
            prev_randao=prev_randao,
            block_number=number,
            gas_limit=30_000_000,
            gas_used=21_000,
            timestamp=timestamp,
            base_fee_per_gas=7,
            transactions=transactions or [],
        )
        if withdrawals is not None and hasattr(payload, "withdrawals"):
            payload.withdrawals = withdrawals
        payload.block_hash = compute_block_hash(payload)
        self.blocks[payload.block_hash] = number
        return payload


class MockExecutionLayer(ExecutionEngine):
    """In-process engine with fault injection.

    ``all_payloads_valid`` (default) accepts any structurally-consistent
    payload; ``syncing`` answers SYNCING (drives the chain's optimistic-import
    path); ``invalid`` rejects everything (drives invalidation propagation).
    """

    def __init__(self):
        self.generator = ExecutionBlockGenerator()
        self.mode = "valid"  # valid | syncing | invalid
        self._payload_requests: dict[bytes, object] = {}
        self.head_hash = GENESIS_BLOCK_HASH
        self.finalized_hash = b"\x00" * 32

    # -- fault injection hooks (test_utils/hook.rs analog) -----------------

    def set_mode(self, mode: str) -> None:
        assert mode in ("valid", "syncing", "invalid")
        self.mode = mode

    # -- engine API --------------------------------------------------------

    def notify_new_payload(self, payload) -> PayloadStatusV1:
        if self.mode == "syncing":
            return PayloadStatusV1(PayloadStatus.SYNCING)
        if self.mode == "invalid":
            return PayloadStatusV1(
                PayloadStatus.INVALID, latest_valid_hash=self.head_hash,
                validation_error="mock: forced invalid",
            )
        if bytes(payload.block_hash) != compute_block_hash(payload):
            return PayloadStatusV1(
                PayloadStatus.INVALID_BLOCK_HASH,
                validation_error="block hash mismatch",
            )
        if bytes(payload.parent_hash) not in self.generator.blocks:
            return PayloadStatusV1(PayloadStatus.SYNCING)
        self.generator.blocks.setdefault(
            bytes(payload.block_hash), int(payload.block_number)
        )
        return PayloadStatusV1(
            PayloadStatus.VALID, latest_valid_hash=bytes(payload.block_hash)
        )

    def forkchoice_updated(
        self,
        head_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: PayloadAttributes | None = None,
    ) -> tuple[PayloadStatusV1, bytes | None]:
        if self.mode == "syncing":
            return PayloadStatusV1(PayloadStatus.SYNCING), None
        if self.mode == "invalid":
            return (
                PayloadStatusV1(
                    PayloadStatus.INVALID,
                    validation_error="mock: forced invalid",
                ),
                None,
            )
        if head_block_hash not in self.generator.blocks:
            return PayloadStatusV1(PayloadStatus.SYNCING), None
        self.head_hash = head_block_hash
        self.finalized_hash = finalized_block_hash
        payload_id = None
        if payload_attributes is not None:
            payload_id = hashlib.sha256(
                head_block_hash
                + int(payload_attributes.timestamp).to_bytes(8, "little")
                + payload_attributes.prev_randao
            ).digest()[:8]
            self._payload_requests[payload_id] = (
                head_block_hash,
                payload_attributes,
            )
        return (
            PayloadStatusV1(PayloadStatus.VALID, latest_valid_hash=head_block_hash),
            payload_id,
        )

    def get_payload(self, payload_id: bytes, payload_cls):
        head_hash, attrs = self._payload_requests.pop(payload_id)
        return self.generator.produce_payload(
            payload_cls,
            parent_hash=head_hash,
            timestamp=attrs.timestamp,
            prev_randao=attrs.prev_randao,
            fee_recipient=attrs.suggested_fee_recipient,
            withdrawals=attrs.withdrawals,
        )
