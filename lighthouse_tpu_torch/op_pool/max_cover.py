"""Greedy maximum-coverage selection (max_cover.rs, 225 LoC in the reference).

Classic (1 - 1/e)-approximation: repeatedly take the candidate with the
highest residual score, then strip its covered items from the rest. Items are
numpy bool masks so the strip step is vectorized.

The port's copy of ``lighthouse_tpu/op_pool/max_cover.py``.
"""

from __future__ import annotations

import numpy as np


def maximum_cover(candidates: list, limit: int) -> list:
    """candidates: list of (mask: np.ndarray[bool], weights: np.ndarray[u64],
    payload). Returns up to ``limit`` payloads maximizing covered weight.
    ``weights`` aligns with mask positions (per-item reward)."""
    live = [
        [mask.copy(), np.asarray(weights, dtype=np.uint64), payload]
        for mask, weights, payload in candidates
    ]
    chosen = []
    for _ in range(min(limit, len(live))):
        best_i, best_score = -1, 0
        for i, (mask, w, _) in enumerate(live):
            score = int(w[mask].sum())
            if score > best_score:
                best_i, best_score = i, score
        if best_i < 0:
            break
        mask, w, payload = live.pop(best_i)
        chosen.append((payload, mask))
        for other in live:
            other[0] &= ~mask
    return [p for p, _ in chosen]
