"""Swap-or-not shuffle — vectorized full-list kernel.

The spec's committee shuffling. The reference ships both the per-index
``compute_shuffled_index`` (``consensus/swap_or_not_shuffle/src/
compute_shuffled_index.rs``) and the O(n)-per-round whole-list ``shuffle_list``
(``shuffle_list.rs``); validating a committee needs the *whole* shuffling, so
the list form is the hot one. Here each round is ~4 numpy array ops over all
indices at once: the round hash stream is precomputed as a [rounds, n_bytes]
matrix with vectorized SHA-256, and the swap decision is a boolean gather —
no per-index Python. ``shuffle_list(..., forwards=False)`` is the inverse
permutation (the direction Lighthouse uses for committee assignment).
"""

from __future__ import annotations

import numpy as np

from ..ssz.sha256 import sha256_short

SEED_SIZE = 32
ROUND_SIZE = 1
POSITION_WINDOW_SIZE = 4
PIVOT_VIEW_SIZE = SEED_SIZE + ROUND_SIZE
TOTAL_SIZE = SEED_SIZE + ROUND_SIZE + POSITION_WINDOW_SIZE


def _hash_batch(msgs: np.ndarray) -> np.ndarray:
    """[n, <=55]-byte messages -> [n, 32] real SHA-256 digests."""
    return sha256_short(msgs, msgs.shape[1])


def shuffle_list(
    indices: np.ndarray, seed: bytes, rounds: int, forwards: bool = True
) -> np.ndarray:
    """Permute ``indices`` (any int array of values < n applied positionally —
    the spec shuffles positions) with the swap-or-not network."""
    values = np.asarray(indices, dtype=np.uint64).copy()
    n = values.shape[0]
    if n <= 1 or rounds == 0:
        return values
    seed_arr = np.frombuffer(seed, dtype=np.uint8)
    assert seed_arr.shape[0] == SEED_SIZE

    round_order = range(rounds) if forwards else range(rounds - 1, -1, -1)
    # pivot hashes for every round in one batch
    pivot_msgs = np.zeros((rounds, PIVOT_VIEW_SIZE), dtype=np.uint8)
    pivot_msgs[:, :SEED_SIZE] = seed_arr
    pivot_msgs[:, SEED_SIZE] = np.arange(rounds, dtype=np.uint8)
    pivot_digests = _hash_batch(pivot_msgs)
    pivots = (
        pivot_digests[:, :8].copy().view("<u8").reshape(rounds) % np.uint64(n)
    )

    positions = np.arange(n, dtype=np.uint64)
    n_windows = (n + 255) // 256 + 1  # position windows possibly needed
    for r in round_order:
        pivot = int(pivots[r])
        # flip(i) = (pivot + n - i) % n
        flipped = (np.uint64(pivot) + np.uint64(n) - positions) % np.uint64(n)
        combined = np.maximum(positions, flipped)
        # source byte for position j comes from H(seed || r || (j >> 8))
        windows = np.unique(combined >> np.uint64(8))
        msgs = np.zeros((windows.shape[0], TOTAL_SIZE), dtype=np.uint8)
        msgs[:, :SEED_SIZE] = seed_arr
        msgs[:, SEED_SIZE] = r
        msgs[:, SEED_SIZE + 1 :] = (
            windows.astype("<u4").view(np.uint8).reshape(-1, 4)
        )
        digests = _hash_batch(msgs)  # [w, 32]
        win_index = np.searchsorted(windows, combined >> np.uint64(8))
        byte = digests[win_index, ((combined & np.uint64(0xFF)) >> np.uint64(3)).astype(np.int64)]
        bit = (byte >> (combined & np.uint64(7)).astype(np.uint8)) & 1
        values = np.where(bit == 1, values[flipped.astype(np.int64)], values)
        # positions themselves don't move; the *values* swap pairwise:
        # note flip is an involution pairing i <-> flip(i); where bit==1 both
        # ends take each other's value, which the gather above performs.
    return values


def compute_shuffled_index(index: int, n: int, seed: bytes, rounds: int) -> int:
    """Spec single-index forward shuffle (compute_shuffled_index.rs)."""
    assert index < n
    cur = index
    for r in range(rounds):
        pivot_msg = np.zeros((1, PIVOT_VIEW_SIZE), dtype=np.uint8)
        pivot_msg[0, :SEED_SIZE] = np.frombuffer(seed, dtype=np.uint8)
        pivot_msg[0, SEED_SIZE] = r
        pivot = int(_hash_batch(pivot_msg)[0, :8].view("<u8")[0]) % n
        flip = (pivot + n - cur) % n
        position = max(cur, flip)
        msg = np.zeros((1, TOTAL_SIZE), dtype=np.uint8)
        msg[0, :SEED_SIZE] = np.frombuffer(seed, dtype=np.uint8)
        msg[0, SEED_SIZE] = r
        msg[0, SEED_SIZE + 1 :] = np.frombuffer(
            (position >> 8).to_bytes(4, "little"), dtype=np.uint8
        )
        byte = int(_hash_batch(msg)[0, (position & 0xFF) >> 3])
        if (byte >> (position & 7)) & 1:
            cur = flip
    return cur
