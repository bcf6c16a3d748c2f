"""Slasher configuration (ref slasher/src/config.rs): the port's copy of
``lighthouse_tpu/slasher/config.py``.

The reference tiles its epoch axis into C=16-wide chunks because its update
loops walk epoch-by-epoch with early exit and it wants to touch as little of
the on-disk array as possible (config.rs:9-11, array.rs:16-28).  The redesign
processes a validator-chunk row's FULL epoch window in one fused
kernel (see arrays.py), so the epoch-chunking degree of freedom disappears:
the unit of storage and compute is a whole ``[validator_chunk_size,
history_length]`` tile.  ``validator_chunk_size`` remains the row height and
``history_length`` the window width; both are validated like the reference
(config.rs:98-120).
"""

from __future__ import annotations

from dataclasses import dataclass

# ref slasher/src/array.rs:14 — distances are stored as u16 with this sentinel
MAX_DISTANCE = 0xFFFF

DEFAULT_VALIDATOR_CHUNK_SIZE = 256  # ref config.rs:10
DEFAULT_HISTORY_LENGTH = 4096  # ref config.rs:11
DEFAULT_UPDATE_PERIOD = 12  # seconds, ref config.rs:12
DEFAULT_SLOT_OFFSET = 10.5  # ref config.rs:13
MAX_HISTORY_LENGTH = 1 << 16  # ref config.rs:27


@dataclass(frozen=True)
class SlasherConfig:
    validator_chunk_size: int = DEFAULT_VALIDATOR_CHUNK_SIZE
    history_length: int = DEFAULT_HISTORY_LENGTH
    update_period: float = DEFAULT_UPDATE_PERIOD
    slot_offset: float = DEFAULT_SLOT_OFFSET
    broadcast: bool = False

    def validate(self) -> None:
        if self.validator_chunk_size <= 0 or self.history_length <= 0:
            raise ValueError("slasher config: zero-sized parameter")
        if self.history_length > MAX_HISTORY_LENGTH:
            raise ValueError(
                f"slasher history_length {self.history_length} exceeds "
                f"max {MAX_HISTORY_LENGTH}"
            )

    def validator_chunk_index(self, validator_index: int) -> int:
        return validator_index // self.validator_chunk_size

    def validator_offset(self, validator_index: int) -> int:
        return validator_index % self.validator_chunk_size

    def validator_indices_in_chunk(self, validator_chunk_index: int):
        base = validator_chunk_index * self.validator_chunk_size
        return range(base, base + self.validator_chunk_size)
