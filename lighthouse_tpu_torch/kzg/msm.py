"""G1 multi-scalar multiplication over the trusted-setup points.

The port of ``lighthouse_tpu/kzg/msm.py``. The host path is the
pure-Python Pippenger over the port's oracle; the device path keeps the
setup resident as a ``[N, 3, 25]`` limb tensor (one upload per point list
and device, the KZG analog of the device pubkey cache) and runs the whole
MSM as one 255-step ``curve.scale_bits`` ladder over all N lanes followed by
a halving tree (``g1.psum``) — no per-call upload beyond the 255 x N bit
plane.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..oracle import curves as oc
from ..oracle.fields import R

_SCALAR_BITS = 255
_MAX_RESIDENT = 8

# (points, device) -> resident [N, 3, 25] tensor. Keyed by the points'
# content: callers pass fresh slices of one setup list (a proof's monomial
# prefix), which an identity key would upload again on every call.
_device_setups: OrderedDict = OrderedDict()


def _device_points(points, device: torch.device):
    from ..ops.bls import g1 as dg1

    key = (tuple(points), str(device))
    hit = _device_setups.get(key)
    if hit is None:
        hit = dg1.from_oracle_batch(points, device)
        _device_setups[key] = hit
        while len(_device_setups) > _MAX_RESIDENT:
            _device_setups.popitem(last=False)
    else:
        _device_setups.move_to_end(key)
    return hit


def pippenger(points, scalars, window: int = 8):
    """Host bucket MSM: ceil(255/w) windows of bucket-accumulate + sweep, all
    in Jacobian coordinates (one affine normalization at the end)."""
    ops = oc.OPS_FQ
    sc = [int(s) % R for s in scalars]
    jac = [oc._to_jac(p, ops) if p is not None else None for p in points]
    n_windows = (_SCALAR_BITS + window - 1) // window
    acc = None
    for wi in range(n_windows - 1, -1, -1):
        if acc is not None:
            for _ in range(window):
                acc = oc._jac_double(acc, ops)
        shift = wi * window
        buckets = [None] * (1 << window)
        for p, s in zip(jac, sc):
            d = (s >> shift) & ((1 << window) - 1)
            if d:
                buckets[d] = oc._jac_add(buckets[d], p, ops)
        running, win_sum = None, None
        for b in range(len(buckets) - 1, 0, -1):
            running = oc._jac_add(running, buckets[b], ops)
            win_sum = oc._jac_add(win_sum, running, ops)
        acc = oc._jac_add(acc, win_sum, ops)
    return oc._to_affine(acc, ops)


def scalar_bits(scalars) -> np.ndarray:
    """Scalars (reduced mod r) -> int64 bit plane [255, n], MSB first."""
    raw = b"".join((int(s) % R).to_bytes(32, "big") for s in scalars)
    all_bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32), axis=1)
    # 256-bit rows, scalars < 2^255: drop the always-zero top bit
    return np.ascontiguousarray(all_bits[:, 256 - _SCALAR_BITS :].T).astype(np.int64)


def msm(points, scalars, backend: str | None = None):
    """sum scalars[i] * points[i] (oracle affine in, oracle affine out).

    The MSM seam every host-side setup MSM goes through (blob commitments,
    cell proofs, interpolant commitments). ``backend`` takes the kzg seam's
    names (``host`` / ``device``) and the bls seam's (``oracle`` /
    ``native`` / ``tpu``); None defers to ``bls.get_backend()``. The device
    arm runs on ``bls.get_device()``, else on CUDA (raising without it)."""
    from .. import bls
    from ..device import resolve_device

    backend = backend or bls.get_backend()
    if backend in ("host", "oracle", "native"):
        return pippenger(points, scalars)
    if backend not in ("device", "tpu"):
        raise ValueError(f"unknown msm backend {backend!r}")
    from ..ops.bls import curve, g1 as dg1

    dev = resolve_device(bls.get_device())
    pts = _device_points(points, dev)
    bits = torch.from_numpy(scalar_bits(scalars)).to(dev)
    scaled = curve.scale_bits(dg1.K, pts, bits)
    return dg1.to_oracle(dg1.psum(scaled))
