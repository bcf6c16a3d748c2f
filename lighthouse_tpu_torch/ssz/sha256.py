"""SHA-256 over rows of numpy bytes: the port's copy of ``lighthouse_tpu/ssz/sha256.py``.

``sha256_pairs`` hashes [n, 64]-byte blocks (two 32-byte tree nodes each)
into [n, 32] digests — the primitive behind merkleization (every interior
node of an SSZ hash tree is sha256(left || right)) — and ``sha256_short``
the fixed-length messages of the swap-or-not shuffle rounds. The reference
runs a numpy uint32 compression when a batch is large; here every row goes
through hashlib, whose compression runs in C, and the digests are the same.
Parity: the ``ethereum_hashing`` crate (Lighthouse's sha256).
"""

from __future__ import annotations

import hashlib

import numpy as np


def sha256_pairs(blocks: np.ndarray) -> np.ndarray:
    """SHA-256 of n 64-byte messages. blocks [n, 64] uint8 -> [n, 32] uint8."""
    return _hash_rows(np.ascontiguousarray(blocks, dtype=np.uint8), 64)


def sha256_short(msgs: np.ndarray, msg_len: int) -> np.ndarray:
    """SHA-256 of n messages of a fixed length <= 55 bytes (one padded
    block each). msgs [n, msg_len] uint8 -> [n, 32] uint8."""
    if msg_len > 55:
        raise ValueError("single-block messages only (<= 55 bytes)")
    return _hash_rows(np.ascontiguousarray(msgs, dtype=np.uint8), msg_len)


def _hash_rows(rows: np.ndarray, width: int) -> np.ndarray:
    n = rows.shape[0]
    buf = rows.tobytes()
    h = hashlib.sha256
    out = b"".join([h(buf[width * i : width * (i + 1)]).digest() for i in range(n)])
    return np.frombuffer(out, dtype=np.uint8).reshape(n, 32)


def sha256(data: bytes) -> bytes:
    """Single-shot arbitrary-length hash (host convenience; hashlib-backed)."""
    return hashlib.sha256(data).digest()
