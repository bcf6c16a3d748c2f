"""Surround-vote min/max target arrays, row by row, as PyTorch.

The port of ``lighthouse_tpu/slasher/arrays.py`` (a jit over a stack of
rows there). Reference semantics (slasher/src/array.rs): for every validator
the slasher maintains, over a sliding window of ``history_length`` epochs,

  ``min_targets[v][e]`` = min target of v's attestations with source >  e
  ``max_targets[v][e]`` = max target of v's attestations with source <  e

A new attestation ``X`` surrounds an existing one iff ``X.target >
min_targets[v][X.source]`` and is surrounded iff ``X.target <
max_targets[v][X.source]`` (array.rs:219-244, 322-347).

The reference's walk loops are interval min/max updates whose intervals
always extend to a window edge: attestation ``(s, t)`` applies ``min`` over
cells ``[window_start, s-1]`` and ``max`` over ``[s+1, current_epoch]``. A
batch therefore collapses to a scatter-min of ``t`` at column ``s-1``
(resp. scatter-max at ``s+1``), one reverse (resp. forward) cumulative scan
along the epoch axis and an elementwise combine with the previous array.
Slashability checks read the post-update arrays, which is order-safe
because an attestation's own updates never touch the column its check reads.

Storage is a linear window, newest epoch in the last column, encoded as
``target - epoch`` distances in uint16 exactly like the reference
(array.rs:14,84-99); the row update computes in int32 on the caller's
device and returns the reference's uint16 tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import MAX_DISTANCE

_INT_INF = 2**31 - 1


def empty_row(validator_chunk_size: int, history_length: int):
    """Fresh (min_d, max_d) distance tiles with neutral elements.

    min neutral = MAX_DISTANCE (no attestation with source > e yet),
    max neutral = 0 (ref array.rs:211-213, 314-316).
    """
    k, n = validator_chunk_size, history_length
    return (
        np.full((k, n), MAX_DISTANCE, dtype=np.uint16),
        np.zeros((k, n), dtype=np.uint16),
    )


def _rows_update(min_d, max_d, delta, v_off, src, tgt, valid, cur, *, n):
    """Advance + batch-update + check for a stack of validator-chunk rows.

    min_d, max_d    : int32[R, K, N] distance tiles (linear window layout),
                      on the update's device
    delta           : int64[R]  window advance per row (cur - stored_epoch)
    v_off, src, tgt : int64[R, P] flattened (attestation x validator) pairs
    valid           : bool[R, P] padding mask
    cur             : the current epoch (last column's epoch)

    Returns (new_min_d, new_max_d, min_target, max_target, min_flag,
    max_flag): the new tiles as int32 distances in [0, MAX_DISTANCE], the
    per-pair post-update array reads (int32) used by the host to fetch the
    existing attestation on a flagged surround, and the flags.
    """
    dev = min_d.device
    r, k, _ = min_d.shape
    p = v_off.shape[1]
    i32 = torch.int32
    base = cur - (n - 1)
    j = torch.arange(n, device=dev)
    e = (base + j).to(i32)  # epoch of each column

    # -- 1. window advance: shift left by delta, neutral-fill the new columns
    # (roll by -delta, then every column j >= n - delta is fresh).
    dl = delta.view(r, 1, 1)
    shift = (j.view(1, 1, n) + dl) % n
    fresh = j.view(1, 1, n) >= n - dl
    idx = shift.expand(r, k, n)
    min_d = torch.where(fresh, MAX_DISTANCE, torch.gather(min_d, 2, idx))
    max_d = torch.where(fresh, 0, torch.gather(max_d, 2, idx))

    # -- 2. scatter + directional scan in the int32 target domain. Invalid /
    # out-of-window columns are dropped (the reference routes them to n).
    tgt32 = tgt.to(i32)
    rows = torch.arange(r, device=dev).view(r, 1).expand(r, p)

    def scatter(col, fill, reduce):
        z = torch.full((r * k * n,), fill, dtype=i32, device=dev)
        ok = valid & (col >= 0) & (col < n)
        flat = (rows[ok] * k + v_off[ok]) * n + col[ok]
        return z.scatter_reduce_(0, flat, tgt32[ok], reduce).view(r, k, n)

    # min_targets[e] aggregates attestations with source-1 >= e: suffix scan.
    suff_min = torch.cummin(scatter(src - 1 - base, _INT_INF, "amin").flip(2), 2).values.flip(2)
    # max_targets[e] aggregates attestations with source+1 <= e: prefix scan.
    pref_max = torch.cummax(scatter(src + 1 - base, -_INT_INF, "amax"), 2).values

    new_min_t = torch.minimum(min_d + e, suff_min)
    new_max_t = torch.maximum(max_d + e, pref_max)
    new_min_d = (new_min_t - e).clamp(0, MAX_DISTANCE)
    new_max_d = (new_max_t - e).clamp(0, MAX_DISTANCE)

    # -- 3. post-update reads at each pair's own source column.
    col_s = (src - base).clamp(0, n - 1)
    min_target = new_min_d[rows, v_off, col_s] + e[col_s]
    max_target = new_max_d[rows, v_off, col_s] + e[col_s]
    min_flag = valid & (tgt32 > min_target)
    max_flag = valid & (tgt32 < max_target)
    return new_min_d, new_max_d, min_target, max_target, min_flag, max_flag


def _bucket(x: int) -> int:
    b = 8
    while b < x:
        b *= 2
    return b


_ROW_GROUP = 8  # rows per update: bounds the int32 working set
#                 (R x K x N x 4B per array)


def update_rows(rows, pairs, current_epoch: int, history_length: int, *, device):
    """Host wrapper: stack the rows, run the update on ``device``, unstack.

    rows  : list of (stored_epoch, min_d u16[K,N], max_d u16[K,N])
    pairs : list of list of (validator_offset, source, target) per row
    Returns (new_rows, results) where new_rows is [(min_d, max_d)] (uint16)
    and results is per-row lists of (min_flag, min_target, max_flag,
    max_target) aligned with the input pairs.

    Updates are chunked to ``_ROW_GROUP`` rows, pairs padded to a power-of-
    two bucket, as the reference's launches are.
    """
    if not rows:
        return [], []
    if len(rows) > _ROW_GROUP:
        new_rows, results = [], []
        for off in range(0, len(rows), _ROW_GROUP):
            nr, res = update_rows(
                rows[off : off + _ROW_GROUP],
                pairs[off : off + _ROW_GROUP],
                current_epoch,
                history_length,
                device=device,
            )
            new_rows.extend(nr)
            results.extend(res)
        return new_rows, results
    r = len(rows)
    p = _bucket(max(1, max(len(ps) for ps in pairs)))
    min_d = np.stack([row[1] for row in rows]).astype(np.int32)
    max_d = np.stack([row[2] for row in rows]).astype(np.int32)
    delta = np.asarray([max(0, current_epoch - row[0]) for row in rows], dtype=np.int64)
    v_off = np.zeros((r, p), dtype=np.int64)
    src = np.zeros((r, p), dtype=np.int64)
    tgt = np.zeros((r, p), dtype=np.int64)
    valid = np.zeros((r, p), dtype=bool)
    for i, ps in enumerate(pairs):
        for q, (vo, s, t) in enumerate(ps):
            v_off[i, q], src[i, q], tgt[i, q], valid[i, q] = vo, s, t, True

    def put(a):
        return torch.from_numpy(a).to(device)

    out = _rows_update(
        put(min_d), put(max_d), put(delta), put(v_off), put(src), put(tgt), put(valid),
        int(current_epoch), n=history_length,
    )
    new_min, new_max, min_t, max_t, min_f, max_f = (o.cpu().numpy() for o in out)
    new_min, new_max = new_min.astype(np.uint16), new_max.astype(np.uint16)
    new_rows = [(new_min[i], new_max[i]) for i in range(r)]
    results = [
        [
            (bool(min_f[i, q]), int(min_t[i, q]), bool(max_f[i, q]), int(max_t[i, q]))
            for q in range(len(ps))
        ]
        for i, ps in enumerate(pairs)
    ]
    return new_rows, results
