"""The span sweep of the whole-registry slasher engine, as PyTorch.

The port of ``lighthouse_tpu/slasher/kernels.py:sweep_impl`` (an XLA jit
there, no Pallas kernel): one ``[n_validators, history_length]`` pair of
min/max distance planes plus a vote-tag plane, resident on the device
across ticks, and per batch

  1. **window advance** — the current epoch moved by ``delta``: a shift
     along the epoch axis and a neutral fill of the new columns;
  2. **scatter** — attestation ``(v, s, t)`` applies ``min`` of ``t`` at
     column ``s-1`` (resp. ``max`` at ``s+1``);
  3. **directional scans** — a reverse cumulative min (resp. forward
     cumulative max) along the epoch axis completes every interval;
  4. **per-pair reads** — each pair reads the post-update planes at its own
     source column (surround candidates) and the vote plane at its target
     column (double-vote candidates: a different recorded tag, or two tags
     on one cell within the batch).

The outputs equal the reference's bit for bit: all three planes and all
five per-pair outputs (``sweep_numpy`` in ``engine.py`` is the numpy twin,
with the reference's signature).

**Storage at the reference's width.** 8 bytes per validator-epoch cell,
two u16 distance planes and a u32 tag plane, held in signed dtypes with an
order-preserving bias (``int16 = d - 2^15``, ``int32 = tag - 2^31``; CUDA
has few operations on ``uint16``/``uint32``): every min, max and comparison
of the reference holds on the biased values, and the conversion to and from
the reference's planes (``planes_to_device`` / ``planes_from_device``) is
exact. Arithmetic runs in int32, in the target domain, as the reference's.

**Tiles.** A 2^20 x 4096 registry is 32 GiB of planes; one int32
temporary of that shape is 16 GiB. So the sweep works in row tiles sized
from ``TILE_BYTES``: the advance shifts the planes tile by tile, in place,
and the update gathers only the rows the batch touches (its pairs sorted
by row), in tiles, writing them back in place. A row no pair touches comes
out of steps 2-3 unchanged (its scans are the identity and its clip is
exact), so skipping it changes no output.

The sweep writes the planes in place; the span store treats an exception
after the first write as corruption of the planes (``PlanesIndeterminate``)
and rebuilds them from its host checkpoint and journal.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import MAX_DISTANCE

_INT_INF = 2**31 - 1
_I32_MIN = -(2**31)
_D_BIAS = 1 << 15  # int16 distance storage = d - 2^15
_TAG_BIAS = 1 << 31  # int32 tag storage = tag - 2^31
# biased neutral fills: min distance MAX_DISTANCE, max distance 0, tag 0
_NEUTRAL = (MAX_DISTANCE - _D_BIAS, -_D_BIAS, _I32_MIN)
_VOTE_NONE_B = 0xFFFFFFFF - _TAG_BIAS  # the scatter-min identity, biased

# Static headroom bound for the int32 target-domain arithmetic (the
# reference's): every epoch the sweep sees must leave MAX_DISTANCE + history
# of int32 headroom. The span store enforces it.
MAX_EPOCH = 1 << 24

# temporaries of one tile: ~64 B per cell of the update (the int32 row
# copies, the scatter plane, the scan's values and int64 indices, flips)
TILE_BYTES = 2 << 30
_BYTES_PER_CELL = 64


class PlanesIndeterminate(RuntimeError):
    """The sweep failed after it began writing the planes in place: they are
    no longer a state the store can trust or retry from."""

    fault_kind = "corruption"


def tile_rows(n: int, tile_bytes: int | None = None) -> int:
    """Rows per tile for a window of ``n`` epochs."""
    return max(1, (TILE_BYTES if tile_bytes is None else tile_bytes) // (n * _BYTES_PER_CELL))


def empty_planes(n_validators_pad: int, history_length: int, device) -> list:
    """Neutral (min_d, max_d, vote_h) planes, biased, on ``device``."""
    shape = (n_validators_pad, history_length)
    return [
        torch.full(shape, fill, dtype=dt, device=device)
        for fill, dt in zip(_NEUTRAL, (torch.int16, torch.int16, torch.int32))
    ]


def planes_to_device(min_d, max_d, vote_h, device) -> list:
    """The reference's uint16/uint16/uint32 planes as biased device planes."""
    out = []
    for a, u, s in ((min_d, np.uint16, np.int16), (max_d, np.uint16, np.int16),
                    (vote_h, np.uint32, np.int32)):
        a = np.ascontiguousarray(a, dtype=u)
        flip = u(1 << (8 * a.itemsize - 1))
        out.append(torch.from_numpy((a ^ flip).view(s)).to(device))
    return out


def planes_from_device(planes) -> tuple:
    """Biased device planes as the reference's uint16/uint16/uint32 arrays."""
    out = []
    for p, u in zip(planes, (np.uint16, np.uint16, np.uint32)):
        a = p.cpu().numpy().view(u)  # lint: allow(host-sync) host export of the planes
        out.append(a ^ u(1 << (8 * a.itemsize - 1)))
    return tuple(out)


def _certs(n: int) -> None:
    """The reference's three proof obligations (``kernels.py:84-95``), on the
    biased storage."""
    from ..ops.bls.fq import _cert

    _cert("slasher_distance_width", MAX_DISTANCE - _D_BIAS, (1 << 15) - 1,
          "distance sentinel fits the biased int16 plane")
    _cert("slasher_target_domain", MAX_EPOCH + MAX_DISTANCE + n, _INT_INF,
          "int32 target-domain arithmetic cannot wrap below MAX_EPOCH")
    _cert("slasher_window_width", n - 1, MAX_DISTANCE,
          "max in-window distance (n-1) representable in the u16 encoding")


def _on(x, dev, dtype):
    """``x`` (a tensor, or anything numpy takes) as a ``dtype`` tensor on
    ``dev``; uint32 values widen exactly into int64."""
    if torch.is_tensor(x):
        return x.to(dev, dtype)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _advance_(planes, dl: int, n: int, rows: int) -> None:
    """Shift every row left by ``dl`` columns and neutral-fill the new ones,
    in place, tile by tile."""
    v_cap = planes[0].shape[0]
    for r0 in range(0, v_cap, rows):
        r1 = min(r0 + rows, v_cap)
        for p, fill in zip(planes, _NEUTRAL):
            t = p[r0:r1]
            if dl < n:
                t[:, : n - dl] = t[:, dl:].clone()
            t[:, n - dl:] = fill


def sweep_(planes, delta, vidx, src, tgt, vh, valid, cur, *, n: int,
           rows: int | None = None) -> tuple:
    """Advance + batch update + candidate detection, in place.

    planes           : [min_d int16, max_d int16, vote_h int32], biased,
                       [V, n] on one device (linear window, newest epoch in
                       the last column)
    delta            : window advance (cur - stored epoch)
    vidx, src, tgt   : [P] flattened (attestation x validator) pairs
    vh               : [P] nonzero 32-bit data-root tag per pair
    valid            : [P] padding mask
    cur              : the current epoch (last column's epoch)

    Returns ``(min_target, max_target, min_flag, max_flag, dbl_flag)`` as
    [P] tensors on the planes' device. Raises ``PlanesIndeterminate`` when
    it fails after the first write to the planes.
    """
    _certs(n)
    min_s, max_s, vote_s = planes
    dev = min_s.device
    v_cap = min_s.shape[0]
    rows = tile_rows(n) if rows is None else max(1, int(rows))
    cur, delta = int(cur), int(delta)
    base = cur - (n - 1)
    dl = min(max(delta, 0), n)

    i32, i64 = torch.int32, torch.int64
    vidx = _on(vidx, dev, i64)
    src = _on(src, dev, i32)
    tgt = _on(tgt, dev, i32)
    vh_b = (_on(vh, dev, i64) - _TAG_BIAS).to(i32)
    valid = _on(valid, dev, torch.bool)
    p = vidx.shape[0]
    vi = vidx.clamp(0, v_cap - 1)
    col_min = src - 1 - base
    ok_min = valid & (col_min >= 0) & (col_min < n)
    col_max = src + 1 - base
    ok_max = valid & (col_max >= 0) & (col_max < n)
    col_t = tgt - base
    in_w = (col_t >= 0) & (col_t < n)
    ok_t = valid & in_w
    col_t_c = col_t.clamp(0, n - 1).to(i64)
    col_s = (src - base).clamp(0, n - 1).to(i64)

    min_target = torch.empty(p, dtype=i32, device=dev)
    max_target = torch.empty(p, dtype=i32, device=dev)
    min_flag = torch.empty(p, dtype=torch.bool, device=dev)
    max_flag = torch.empty(p, dtype=torch.bool, device=dev)
    dbl_flag = torch.empty(p, dtype=torch.bool, device=dev)
    e = base + torch.arange(n, dtype=i32, device=dev)

    touched, inv = torch.unique(vi, sorted=True, return_inverse=True)
    order = torch.argsort(inv, stable=True)
    inv_sorted = inv[order]
    n_rows = touched.shape[0]
    starts = torch.arange(0, n_rows, rows, device=dev)
    bounds = torch.searchsorted(inv_sorted, torch.cat([starts, starts.new_tensor([n_rows])]))
    # the touched rows' tile boundaries: the sweep's one read before it writes
    bounds = bounds.tolist()  # lint: allow(host-sync)

    written = False
    try:
        # -- 1. window advance, in place over the whole registry
        if dl:
            written = True
            _advance_(planes, dl, n, rows)

        # -- 2-4. the touched rows, tile by tile
        for i, s0 in enumerate(range(0, n_rows, rows)):
            s1 = min(s0 + rows, n_rows)
            rr = touched[s0:s1]
            q = order[bounds[i]:bounds[i + 1]]
            loc = inv[q] - s0
            t = s1 - s0
            qt, qv = tgt[q], valid[q]

            mn = min_s.index_select(0, rr).to(i32) + (_D_BIAS + e)
            scat = torch.full((t, n), _INT_INF, dtype=i32, device=dev)
            k = ok_min[q]
            scat.view(-1).scatter_reduce_(0, loc[k] * n + col_min[q][k], qt[k], "amin")
            # min_targets[e] aggregates attestations with source-1 >= e
            mn = torch.minimum(mn, torch.cummin(scat.flip(1), 1).values.flip(1))
            new_mn = (mn - e).clamp_(0, MAX_DISTANCE)
            del mn

            mx = max_s.index_select(0, rr).to(i32) + (_D_BIAS + e)
            scat.fill_(-_INT_INF)
            k = ok_max[q]
            scat.view(-1).scatter_reduce_(0, loc[k] * n + col_max[q][k], qt[k], "amax")
            # max_targets[e] aggregates attestations with source+1 <= e
            mx = torch.maximum(mx, torch.cummax(scat, 1).values)
            new_mx = (mx - e).clamp_(0, MAX_DISTANCE)
            del mx

            # the vote plane: first-seen tag wins; candidates are a recorded
            # different tag or two tags on one cell within the batch
            vt = vote_s.index_select(0, rr)
            cq = col_t_c[q]
            pre = torch.where(in_w[q], vt[loc, cq], _I32_MIN)
            k = ok_t[q]
            cell = loc[k] * n + col_t[q][k]
            tags = vh_b[q][k]
            scat.fill_(_VOTE_NONE_B)
            scat.view(-1).scatter_reduce_(0, cell, tags, "amin")
            smin_p = scat[loc, cq]
            fresh = torch.where(scat != _VOTE_NONE_B, scat, _I32_MIN)
            new_vt = torch.where(vt != _I32_MIN, vt, fresh)
            del fresh
            scat.fill_(_I32_MIN)
            scat.view(-1).scatter_reduce_(0, cell, tags, "amax")
            smax_p = scat[loc, cq]
            del scat
            dbl_flag[q] = qv & in_w[q] & (((pre != _I32_MIN) & (pre != vh_b[q])) | (smin_p != smax_p))

            cs = col_s[q]
            mt = new_mn[loc, cs] + e[cs]
            xt = new_mx[loc, cs] + e[cs]
            min_target[q], max_target[q] = mt, xt
            min_flag[q] = qv & (qt > mt)
            max_flag[q] = qv & (qt < xt)

            written = True
            min_s.index_copy_(0, rr, (new_mn - _D_BIAS).to(torch.int16))
            max_s.index_copy_(0, rr, (new_mx - _D_BIAS).to(torch.int16))
            vote_s.index_copy_(0, rr, new_vt)
    except Exception as e_:
        if written:
            raise PlanesIndeterminate(f"slasher sweep failed mid-update: {e_!r}") from e_
        raise
    return min_target, max_target, min_flag, max_flag, dbl_flag
