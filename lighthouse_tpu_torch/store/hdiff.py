"""Hierarchical state diffs for the freezer (ref store/src/hdiff.rs:33-40).

The reference splits each diff into per-field sections chosen by entropy
profile (hdiff.rs HDiff docs): balances as compressed u64 deltas,
inactivity scores likewise, validators as per-entry replacements,
historical roots/summaries as append-only tails, and the remaining state
bytes through xdelta3. Here the same sectioning is kept, with the generic
section as a vectorized XOR delta + zlib — SSZ states are structurally
stable so unchanged regions become zero runs that compress to almost
nothing, and the whole delta computes as one numpy op instead of a
byte-level match loop.

Layering (hdiff.rs HierarchyConfig): ascending ``exponents`` define diff
layers; the coarsest is the full-snapshot cadence. ``storage_strategy``
maps a slot to Snapshot / DiffFrom(parent slot) / ReplayFrom(closest
stored slot).

The port's copy of ``lighthouse_tpu/store/hdiff.py``.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

_MAGIC = b"HDF1"


@dataclass(frozen=True)
class HierarchyConfig:
    exponents: tuple = (5, 9, 11, 13, 16, 18, 21)  # ref StoreConfig default

    def __post_init__(self):
        if any(
            a >= b for a, b in zip(self.exponents, self.exponents[1:])
        ):
            raise ValueError("hierarchy exponents must be strictly ascending")

    @property
    def moduli(self) -> list[int]:
        """Descending: [snapshot cadence, ..., finest diff cadence]."""
        return [1 << e for e in reversed(self.exponents)]


@dataclass(frozen=True)
class Snapshot:
    pass


@dataclass(frozen=True)
class DiffFrom:
    slot: int


@dataclass(frozen=True)
class ReplayFrom:
    slot: int


def storage_strategy(config: HierarchyConfig, slot: int):
    """How the freezer stores ``slot`` (hdiff.rs HierarchyModuli)."""
    moduli = config.moduli
    if slot % moduli[0] == 0:
        return Snapshot()
    for coarser, m in zip(moduli, moduli[1:]):
        if slot % m == 0:
            return DiffFrom(slot - slot % coarser)
    return ReplayFrom(slot - slot % moduli[-1])


# -- section codecs ---------------------------------------------------------------


def _u64_delta(base: np.ndarray, target: np.ndarray) -> bytes:
    """Wrapping difference of the common prefix + appended tail, zlib'd —
    balances change every epoch but by small amounts, so deltas are
    leading-zero-heavy (hdiff.rs CompressedU64Diff rationale)."""
    n = min(base.size, target.size)
    if target.size < base.size:
        raise ValueError("u64 section shrank; deletions unsupported")
    delta = (target[:n] - base[:n]).astype(np.uint64)
    tail = target[n:]
    raw = struct.pack("<II", n, tail.size) + delta.tobytes() + tail.tobytes()
    return zlib.compress(raw, 3)


def _u64_apply(base: np.ndarray, blob: bytes) -> np.ndarray:
    raw = zlib.decompress(blob)
    n, n_tail = struct.unpack_from("<II", raw)
    delta = np.frombuffer(raw[8 : 8 + 8 * n], dtype=np.uint64)
    tail = np.frombuffer(raw[8 + 8 * n : 8 + 8 * (n + n_tail)], dtype=np.uint64)
    return np.concatenate([(base[:n] + delta).astype(np.uint64), tail])


def _bytes_xor(base: bytes, target: bytes) -> bytes:
    """Vectorized XOR delta over the common prefix + raw tail."""
    n = min(len(base), len(target))
    a = np.frombuffer(base[:n], dtype=np.uint8)
    b = np.frombuffer(target[:n], dtype=np.uint8)
    raw = (
        struct.pack("<II", n, len(target) - n)
        + (a ^ b).tobytes()
        + target[n:]
    )
    return zlib.compress(raw, 3)


def _bytes_xor_apply(base: bytes, blob: bytes) -> bytes:
    raw = zlib.decompress(blob)
    n, n_tail = struct.unpack_from("<II", raw)
    a = np.frombuffer(base[:n], dtype=np.uint8)
    d = np.frombuffer(raw[8 : 8 + n], dtype=np.uint8)
    return (a ^ d).tobytes() + raw[8 + n : 8 + n + n_tail]


def _validators_delta(base_enc: list[bytes], target_enc: list[bytes]) -> bytes:
    """Per-entry replacement list (hdiff.rs ValidatorsDiff): the Validator
    record rarely changes, so comparing entries directly beats generic
    binary diffing by ~10x on mainnet-size registries."""
    if len(target_enc) < len(base_enc):
        raise ValueError("validator registry shrank")
    out = bytearray()
    count = 0
    for i, t in enumerate(target_enc):
        if i >= len(base_enc) or base_enc[i] != t:
            out += struct.pack("<I", i) + t
            count += 1
    return zlib.compress(struct.pack("<II", count, len(target_enc)) + bytes(out), 3)


def _validators_apply(base_enc: list[bytes], blob: bytes, entry_len: int) -> list[bytes]:
    raw = zlib.decompress(blob)
    count, total = struct.unpack_from("<II", raw)
    out = list(base_enc) + [b""] * (total - len(base_enc))
    off = 8
    for _ in range(count):
        (i,) = struct.unpack_from("<I", raw, off)
        off += 4
        out[i] = raw[off : off + entry_len]
        off += entry_len
    return out[:total]


def _append_only(base: list[bytes], target: list[bytes]) -> bytes:
    if target[: len(base)] != base:
        raise ValueError("append-only section rewrote history")
    return b"".join(target[len(base) :])


# -- buffer + diff ---------------------------------------------------------------


class HDiffBuffer:
    """Sectioned working form of a state (hdiff.rs HDiffBuffer)."""

    def __init__(self, state_rest: bytes, balances, inactivity, validators,
                 hist_roots, hist_summaries):
        self.state_rest = state_rest
        self.balances = np.asarray(balances, dtype=np.uint64)
        self.inactivity = np.asarray(inactivity, dtype=np.uint64)
        self.validators = validators  # list of encoded entries
        self.hist_roots = hist_roots  # list of 32B roots
        self.hist_summaries = hist_summaries  # list of encoded entries

    @classmethod
    def from_state(cls, state) -> "HDiffBuffer":
        from ..types.containers import HistoricalSummary, Validator

        hollow = state.copy()
        balances = np.asarray(state.balances, dtype=np.uint64)
        inactivity = np.asarray(
            getattr(state, "inactivity_scores", []), dtype=np.uint64
        )
        validators = [Validator.encode(v) for v in state.validators]
        hist_roots = [bytes(r) for r in state.historical_roots]
        hist_summaries = [
            HistoricalSummary.encode(h)
            for h in getattr(state, "historical_summaries", [])
        ]
        hollow.balances = np.zeros(0, dtype=np.uint64)
        hollow.validators = []
        hollow.historical_roots = []
        if hasattr(hollow, "inactivity_scores"):
            hollow.inactivity_scores = np.zeros(0, dtype=np.uint64)
        if hasattr(hollow, "historical_summaries"):
            hollow.historical_summaries = []
        rest = type(state).encode(hollow)
        return cls(rest, balances, inactivity, validators, hist_roots,
                   hist_summaries)

    def into_state(self, state_cls):
        from ..types.containers import HistoricalSummary, Validator

        state = state_cls.decode(self.state_rest)
        state.balances = self.balances.copy()
        state.validators = [Validator.decode(v) for v in self.validators]
        state.historical_roots = list(self.hist_roots)
        if hasattr(state, "inactivity_scores"):
            state.inactivity_scores = self.inactivity.copy()
        if hasattr(state, "historical_summaries"):
            state.historical_summaries = [
                HistoricalSummary.decode(h) for h in self.hist_summaries
            ]
        return state


_VALIDATOR_LEN = 121  # fixed SSZ size of a Validator entry


class HDiff:
    """Serialized hierarchical diff between two HDiffBuffers."""

    def __init__(self, blob: bytes):
        self.blob = blob

    @classmethod
    def compute(cls, base: HDiffBuffer, target: HDiffBuffer) -> "HDiff":
        sections = [
            _bytes_xor(base.state_rest, target.state_rest),
            _u64_delta(base.balances, target.balances),
            _u64_delta(base.inactivity, target.inactivity),
            _validators_delta(base.validators, target.validators),
            zlib.compress(_append_only(base.hist_roots, target.hist_roots), 3),
            zlib.compress(
                _append_only(base.hist_summaries, target.hist_summaries), 3
            ),
        ]
        out = bytearray(_MAGIC)
        for s in sections:
            out += struct.pack("<I", len(s)) + s
        return cls(bytes(out))

    def apply(self, base: HDiffBuffer) -> HDiffBuffer:
        if self.blob[:4] != _MAGIC:
            raise ValueError("bad hdiff blob")
        off = 4
        sections = []
        for _ in range(6):
            (n,) = struct.unpack_from("<I", self.blob, off)
            off += 4
            sections.append(self.blob[off : off + n])
            off += n
        rest = _bytes_xor_apply(base.state_rest, sections[0])
        balances = _u64_apply(base.balances, sections[1])
        inactivity = _u64_apply(base.inactivity, sections[2])
        validators = _validators_apply(
            base.validators, sections[3], _VALIDATOR_LEN
        )
        roots_tail = zlib.decompress(sections[4])
        hist_roots = base.hist_roots + [
            roots_tail[i : i + 32] for i in range(0, len(roots_tail), 32)
        ]
        summ_tail = zlib.decompress(sections[5])
        _SUMMARY_LEN = 64
        hist_summaries = base.hist_summaries + [
            summ_tail[i : i + _SUMMARY_LEN]
            for i in range(0, len(summ_tail), _SUMMARY_LEN)
        ]
        return HDiffBuffer(
            rest, balances, inactivity, validators, hist_roots, hist_summaries
        )
