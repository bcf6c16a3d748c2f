"""SSZ merkle-branch generation through nested container fields.

The port's copy of ``lighthouse_tpu/light_client/proofs.py``: the
proof-generation counterpart of ``is_valid_merkle_branch`` (the reference
grows this inside ``consensus/merkle_proof`` / ``tree_hash``): walk a field
path down a container, emit each level's sibling branch bottom-up, so the
concatenated branch proves the leaf against the outer container's root under
the standard generalized-index layout.

Hashing every field of a mainnet state is a full state root, dominated by the
registry's lists. ``field_branch`` takes an optional ``memo`` (a dict the
caller keeps for as long as the container is unchanged) so that several
branches out of one state — the server cache's finality and next-committee
proofs of one import — hash its fields once. The branch bytes are the same
with or without it.
"""

from __future__ import annotations

import numpy as np

from ..ssz.merkle import merkle_branch_from_chunks, next_pow2


def _field_roots(obj) -> np.ndarray:
    cls = type(obj)
    return np.stack(
        [
            np.frombuffer(t.hash_tree_root(getattr(obj, n)), dtype=np.uint8)
            for n, t in cls.FIELDS
        ]
    )


def field_branch(container, path: list[str], memo: dict | None = None) -> list[bytes]:
    """Bottom-up sibling branch proving ``path``'s leaf inside ``container``'s
    hash tree root. Total depth = sum of per-level container depths; the leaf
    gindex is the standard nested generalized index. ``memo`` (keyed by the
    containers' ids) reuses field roots across calls on the same unchanged
    container."""
    steps = []
    obj = container
    for name in path:
        cls = type(obj)
        names = [n for n, _ in cls.FIELDS]
        idx = names.index(name)
        steps.append((obj, idx))
        obj = getattr(obj, name)
    out: list[bytes] = []
    for obj_at, idx in reversed(steps):
        roots = None if memo is None else memo.get(id(obj_at))
        if roots is None:
            roots = _field_roots(obj_at)
            if memo is not None:
                memo[id(obj_at)] = roots
        limit = next_pow2(len(type(obj_at).FIELDS))
        out.extend(merkle_branch_from_chunks(roots, limit, idx))
    return out


def leaf_gindex(container_cls, path: list[str]) -> int:
    """Generalized index of ``path`` under ``container_cls`` (for spec
    cross-checks: altair current_sync_committee=54, next=55, finality
    root=105)."""
    g = 1
    cls = container_cls
    for name in path:
        names = [n for n, _ in cls.FIELDS]
        idx = names.index(name)
        depth = (next_pow2(len(names)) - 1).bit_length()
        g = (g << depth) + idx
        cls = dict(cls.FIELDS)[name]
    return g
