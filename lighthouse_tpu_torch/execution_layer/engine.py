"""Engine-API types and the ExecutionEngine interface.

Parity: ``execution_layer/src/engine_api/mod.rs`` (PayloadStatusV1 statuses,
forkchoiceUpdated/newPayload/getPayload shapes) reduced to the in-process
interface the chain consumes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class PayloadStatus(enum.Enum):
    """engine_newPayload / forkchoiceUpdated statuses (PayloadStatusV1)."""

    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"


@dataclass
class PayloadStatusV1:
    status: PayloadStatus
    latest_valid_hash: bytes | None = None
    validation_error: str | None = None


@dataclass
class PayloadAttributes:
    """forkchoiceUpdated payload-build request (PayloadAttributesV2/V3)."""

    timestamp: int
    prev_randao: bytes
    suggested_fee_recipient: bytes = b"\x00" * 20
    withdrawals: list | None = None  # capella+
    parent_beacon_block_root: bytes | None = None  # deneb+ (V3)


class ExecutionEngine:
    """What the beacon chain needs from an execution client."""

    def notify_new_payload(self, payload) -> PayloadStatusV1:
        raise NotImplementedError

    def forkchoice_updated(
        self,
        head_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: PayloadAttributes | None = None,
    ) -> tuple[PayloadStatusV1, bytes | None]:
        """Returns (status, payload_id or None)."""
        raise NotImplementedError

    def get_payload(self, payload_id: bytes, payload_cls):
        """payload_cls is the fork's ExecutionPayload container class."""
        raise NotImplementedError
