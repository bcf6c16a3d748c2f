"""SSZ merkleization over vectorized SHA-256.

Chunks are [n, 32] uint8 rows; the tree reduction hashes all sibling pairs of
a level in one ``sha256_pairs`` call. Virtual zero-subtree padding (the
``ZERO_HASHES`` ladder) keeps a List[*, 2^40] with 5 elements costing 5 real
hashes per level, not 2^39. Parity: the ``tree_hash`` crate's merkleize_padded
(``consensus/tree_hash/src/merkle_hash.rs``).
"""

from __future__ import annotations

import numpy as np

from .sha256 import sha256_pairs

_MAX_DEPTH = 64

ZERO_HASHES = np.zeros((_MAX_DEPTH + 1, 32), dtype=np.uint8)
for _i in range(_MAX_DEPTH):
    ZERO_HASHES[_i + 1] = sha256_pairs(
        np.concatenate([ZERO_HASHES[_i], ZERO_HASHES[_i]])[None, :]
    )[0]


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize_chunks(chunks: np.ndarray, limit: int | None = None) -> bytes:
    """Merkle root of [n, 32] chunk rows, padded (virtually) to ``limit``
    leaves (or next_pow2(n) when limit is None)."""
    chunks = np.asarray(chunks, dtype=np.uint8).reshape(-1, 32)
    n = chunks.shape[0]
    if limit is not None and n > limit:
        raise ValueError(f"{n} chunks exceeds limit {limit}")
    leaves = limit if limit is not None else max(n, 1)
    depth = (next_pow2(leaves) - 1).bit_length()
    level = chunks
    for d in range(depth):
        m = level.shape[0]
        if m == 0:
            return bytes(ZERO_HASHES[depth])
        if m % 2:
            level = np.concatenate([level, ZERO_HASHES[d][None, :]], axis=0)
            m += 1
        level = sha256_pairs(level.reshape(m // 2, 64))
    if level.shape[0] == 0:
        return bytes(ZERO_HASHES[depth])
    return bytes(level[0])


def merkle_branch_from_chunks(
    chunks: np.ndarray, limit: int, index: int
) -> list[bytes]:
    """Sibling branch (bottom-up) for leaf ``index`` in the padded tree that
    ``merkleize_chunks(chunks, limit)`` roots — proof *generation*, the
    counterpart of ``is_valid_merkle_branch`` (ref merkle_proof's
    ``MerkleTree::generate_proof``; needed by BlobSidecar inclusion proofs
    and the light-client server)."""
    chunks = np.asarray(chunks, dtype=np.uint8).reshape(-1, 32)
    depth = (next_pow2(max(limit, 1)) - 1).bit_length()
    branch: list[bytes] = []
    level = chunks
    idx = index
    for d in range(depth):
        sib = idx ^ 1
        branch.append(
            bytes(level[sib]) if sib < level.shape[0] else bytes(ZERO_HASHES[d])
        )
        m = level.shape[0]
        if m % 2:
            level = np.concatenate([level, ZERO_HASHES[d][None, :]], axis=0)
            m += 1
        level = (
            sha256_pairs(level.reshape(m // 2, 64))
            if m
            else np.zeros((0, 32), np.uint8)
        )
        idx //= 2
    return branch


def fold_merkle_branch(leaf: bytes, branch: list[bytes], index: int) -> bytes:
    """Root implied by a leaf + sibling branch (direction bits from index)."""
    node = np.frombuffer(leaf, dtype=np.uint8)
    for i, sib in enumerate(branch):
        s = np.frombuffer(sib, dtype=np.uint8)
        pair = (
            np.concatenate([s, node])
            if (index >> i) & 1
            else np.concatenate([node, s])
        )
        node = sha256_pairs(pair[None, :])[0]
    return bytes(node)


def mix_in_length(root: bytes, length: int) -> bytes:
    block = np.zeros(64, dtype=np.uint8)
    block[:32] = np.frombuffer(root, dtype=np.uint8)
    block[32:40] = np.frombuffer(
        length.to_bytes(8, "little"), dtype=np.uint8
    )
    return bytes(sha256_pairs(block[None, :])[0])


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return mix_in_length(root, selector)
