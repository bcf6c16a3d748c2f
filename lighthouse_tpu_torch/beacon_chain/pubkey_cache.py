"""Validator pubkey cache: every key decompressed once, resident for batches.

The port's copy of ``lighthouse_tpu/beacon_chain/pubkey_cache.py``
(Lighthouse ``beacon_node/beacon_chain/src/validator_pubkey_cache.rs:12-25``:
"keeps all validator pubkeys decompressed in memory"). The host side keeps
the reference's oracle points and ``bls.PublicKey`` objects; the device side
is the projective ``[n, 3, 25]`` int64 tensor that
``bls.backend.verify_indexed_sets_device`` gathers keys from, grown
incrementally as the registry grows.

``from_affine`` is the bulk seam (``ValidatorPubkeyCache::load_from_store``
in Lighthouse): a restarting node seeds the cache from stored affine points
without decompressing and subgroup-checking each key again, which at 2^20
keys would take hours in Python. The seed is held to the state's compressed
keys byte for byte; its ``PublicKey`` objects are built on first use.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bls
from ..oracle.curves import B1
from ..oracle.fields import P


def compress_affine(raw: np.ndarray) -> np.ndarray:
    """Raw affine G1 points ([n, 96] uint8: x || y big-endian, no infinity)
    -> their 48-byte compressed encodings [n, 48]: x with the compression
    flag, and the sign flag where y > (p - 1) / 2. Vectorised over rows."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    half = np.frombuffer(((P - 1) // 2).to_bytes(48, "big"), np.uint8)
    ys = raw[:, 48:]
    diff = ys != half
    first = diff.argmax(axis=1)
    rows = np.arange(raw.shape[0])
    above = diff.any(axis=1) & (ys[rows, first] > half[first])
    out = raw[:, :48].copy()
    out[:, 0] |= np.where(above, 0xA0, 0x80).astype(np.uint8)
    return out


def off_curve_rows(raw: np.ndarray) -> np.ndarray:
    """Indices of the rows of raw affine G1 points ([n, 96] uint8) that are
    not points of the curve: x or y not below p, or y^2 != x^3 + 4 mod p."""
    b = np.ascontiguousarray(raw, dtype=np.uint8).tobytes()
    fb = int.from_bytes
    bad = []
    for i in range(0, len(b), 96):
        x, y = fb(b[i:i + 48], "big"), fb(b[i + 48:i + 96], "big")
        if x >= P or y >= P or (y * y - x * x * x - B1) % P:
            bad.append(i // 96)
    return np.asarray(bad, dtype=np.int64)


class ValidatorPubkeyCache:
    """``device``: where ``device_array`` lives; None follows the ``bls``
    backend's device (``bls.set_backend``; default CUDA, raising without
    it). Nothing touches a device until ``device_array`` is called."""

    def __init__(self, device=None):
        self._points: list = []          # oracle affine points (None: seeded, built on use)
        self._pubkeys: list = []         # bls.PublicKey (None: not built yet)
        self._bytes_to_index: dict[bytes, int] = {}
        self._seed: np.ndarray | None = None  # [n_seed, 96] affine rows of a seeded cache
        self._device_name = device
        self._device = None              # [n, 3, 25] int64 tensor (lazily built)
        self._device_len = 0

    @classmethod
    def from_affine(cls, state, raw: np.ndarray, device=None) -> "ValidatorPubkeyCache":
        """A cache seeded from stored affine points: ``raw`` [n, 96] uint8
        (x || y big-endian) for ``state.validators[:n]``. Every row must be
        a point of the curve and compress to exactly the state's ``pubkey``
        bytes, else ValueError; validators past ``n`` are imported key by
        key. The subgroup check is not repeated: a row on the curve that
        compresses to the state's key is that key's own point, which was
        checked when its deposit entered the registry."""
        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        n = raw.shape[0]
        if raw.ndim != 2 or raw.shape[1] != 96 or n > len(state.validators):
            raise ValueError(f"seed of shape {raw.shape} for {len(state.validators)} validators")
        keys = [bytes(v.pubkey) for v in state.validators[:n]]
        want = np.frombuffer(b"".join(keys), np.uint8).reshape(n, 48)
        bad = np.flatnonzero((compress_affine(raw) != want).any(axis=1))
        if bad.size:
            raise ValueError(
                f"seeded pubkey {int(bad[0])} does not compress to the state's key "
                f"({bad.size} mismatches)"
            )
        bad = off_curve_rows(raw)
        if bad.size:
            raise ValueError(
                f"seeded pubkey {int(bad[0])} is not on the curve ({bad.size} rows)"
            )
        self = cls(device)
        self._seed = raw
        self._points = [None] * n
        self._pubkeys = [None] * n
        self._bytes_to_index = dict(zip(keys, range(n)))
        self.import_new_pubkeys(state)
        return self

    def __len__(self) -> int:
        return len(self._points)

    @property
    def device(self) -> torch.device:
        """Where ``device_array`` lives, resolved (raises when that is CUDA
        and there is none)."""
        from ..device import resolve_device

        return resolve_device(
            bls.get_device() if self._device_name is None else self._device_name
        )

    def import_new_pubkeys(self, state) -> None:
        """Decompress + subgroup-check any validators beyond the cache length
        (import_new_pubkeys in the reference; invalid keys are impossible in a
        valid state, so errors raise)."""
        for v in state.validators[len(self._points):]:
            pk_bytes = bytes(v.pubkey)
            pk = bls.PublicKey.from_bytes(pk_bytes)
            self._bytes_to_index[pk_bytes] = len(self._points)
            self._points.append(pk.point)
            self._pubkeys.append(pk)

    def get(self, index: int) -> bls.PublicKey | None:
        if not 0 <= index < len(self._pubkeys):
            return None
        pk = self._pubkeys[index]
        if pk is None:
            pk = self._pubkeys[index] = bls.PublicKey(self.get_point(index))
        return pk

    def get_index(self, pubkey_bytes: bytes) -> int | None:
        return self._bytes_to_index.get(bytes(pubkey_bytes))

    def get_point(self, index: int):
        if not 0 <= index < len(self._points):
            return None
        pt = self._points[index]
        if pt is None:
            row = self._seed[index]
            pt = self._points[index] = (
                int.from_bytes(row[:48].tobytes(), "big"),
                int.from_bytes(row[48:].tobytes(), "big"),
            )
        return pt

    # -- device residency --------------------------------------------------------

    def device_array(self) -> torch.Tensor:
        """[n, 3, 25] projective points on the cache's device, built
        incrementally: seeded rows in one upload, imported keys after them."""
        from ..bls.pubkey_cache import device_pubkeys_from_raw
        from ..device import resolve_device
        from ..ops.bls import g1

        n = len(self._points)
        if self._device is None or self._device_len < n:
            dev = self.device
            start = self._device_len
            parts = [] if self._device is None else [self._device]
            n_seed = 0 if self._seed is None else self._seed.shape[0]
            if start < n_seed:
                parts.append(device_pubkeys_from_raw(self._seed[start:], device=dev))
                start = n_seed
            if start < n:
                parts.append(g1.from_oracle_batch(self._points[start:], dev))
            self._device = parts[0] if len(parts) == 1 else torch.cat(parts)
            self._device_len = n
        return self._device

    def device_gather(self, indices) -> torch.Tensor:
        """Gather [k, 3, 25] pubkey points for validator indices on device."""
        arr = self.device_array()
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=arr.device)
        return arr[idx]
