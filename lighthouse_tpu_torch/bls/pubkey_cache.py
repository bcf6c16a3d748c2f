"""The device-resident validator pubkey cache ``[N, 3, 25]``.

Port of ``lighthouse_tpu/beacon_chain/pubkey_cache.py:device_pubkeys_from_raw``:
every validator key decompressed once, resident on the card as projective
limb planes, so a batch gathers its keys on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bls import fq
from .serde import _be_bytes_to_limbs


def device_pubkeys_from_raw(raw: np.ndarray, device=None) -> torch.Tensor:
    """Raw affine pubkeys ([n, 96] uint8: x || y big-endian) -> the
    projective cache [n, 3, 25] int64 (z = 1) on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = raw.shape[0]
    out = np.zeros((n, 3, fq.NLIMBS), dtype=np.int64)
    out[:, 0] = _be_bytes_to_limbs(raw[:, :48])
    out[:, 1] = _be_bytes_to_limbs(raw[:, 48:])
    out[:, 2, 0] = 1
    return torch.from_numpy(out).to(dev)


def device_pubkeys_from_limbs(x: np.ndarray, y: np.ndarray, device=None) -> torch.Tensor:
    """Affine canonical limbs x, y [n, 25] -> the cache [n, 3, 25] (z = 1)."""
    dev = resolve_device(device)
    n = x.shape[0]
    out = np.zeros((n, 3, fq.NLIMBS), dtype=np.int64)
    out[:, 0] = x
    out[:, 1] = y
    out[:, 2, 0] = 1
    return torch.from_numpy(out).to(dev)
