"""Device-resident columnar mirror of the validator registry: the port of
``lighthouse_tpu/epoch_engine/mirror.py``.

The numpy epoch path re-gathers every validator's fields out of Python
objects each epoch — an O(n) interpreted loop that dwarfs the arithmetic at
mainnet scale. The mirror gathers ONCE per state lineage, keeps the
epoch-processing registry columns as tensors on one explicit
``torch.device`` (int64 for the u64 columns, with FAR_FUTURE_EPOCH held as
``kernels.FAR``; bool for the flags, including the derived electra
``compounding`` plane), and between epochs writes only the rows the
block-level delta journal (``deltas.py``) marked dirty (``index_put_``).

Host numpy shadows of the same columns, in the reference's uint64 form,
serve two jobs: computing the dirty rows' new values without a device round
trip, and diffing the sweep's outputs so the write-back touches only the
Python validator objects that changed. Balances, inactivity and
participation live as numpy arrays on the state and are uploaded whole each
epoch; the mirror counts every host<->device byte.

Over a serving mesh (``mesh=``, the reference's ``sharding=``) every
per-validator column is a list of row blocks, block ``s`` on ``mesh[s]``
(``epoch_engine/sharded.py`` sweeps them); the queue columns stay on
``mesh[0]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .deltas import install_journal, journal_of
from .kernels import EPOCH_COLUMNS, FAR_FUTURE_EPOCH, bucket, from_device, to_device

_REG_DTYPES = {
    "effective": np.uint64,
    "slashed": np.bool_,
    "activation": np.uint64,
    "exit": np.uint64,
    "withdrawable": np.uint64,
    "eligibility": np.uint64,
    "compounding": np.bool_,
}

_FIELD_ATTRS = {
    "effective": "effective_balance",
    "slashed": "slashed",
    "activation": "activation_epoch",
    "exit": "exit_epoch",
    "withdrawable": "withdrawable_epoch",
    "eligibility": "activation_eligibility_epoch",
}

# columns derived from validator fields rather than read off an attribute.
# "compounding" feeds the electra per-validator max_effective_balance plane;
# mutation sites that rewrite withdrawal_credentials journal the row
# (switch_to_compounding_validator), and pre-electra credential changes
# (capella 0x00 -> 0x01) never flip the 0x02 test, so delta syncs stay exact.
_DERIVED = {
    "compounding": lambda v: bytes(v.withdrawal_credentials)[:1] == b"\x02",
}

# padding row: an inactive, zero-balance validator that every sweep stage
# provably ignores
_PAD_VALUES = {
    "effective": 0,
    "slashed": False,
    "activation": FAR_FUTURE_EPOCH,
    "exit": FAR_FUTURE_EPOCH,
    "withdrawable": FAR_FUTURE_EPOCH,
    "eligibility": FAR_FUTURE_EPOCH,
    "compounding": False,
}


def _field_value(v, name):
    getter = _DERIVED.get(name)
    if getter is not None:
        return getter(v)
    return getattr(v, _FIELD_ATTRS[name])


def _nbytes(t) -> int:
    """Bytes of a column, one tensor or a list of row blocks."""
    if isinstance(t, (list, tuple)):
        return sum(x.numel() * x.element_size() for x in t)
    return t.numel() * t.element_size()


@dataclass
class MirrorStats:
    full_syncs: int = 0
    delta_syncs: int = 0
    dirty_rows: int = 0
    host_to_device_bytes: int = 0
    device_to_host_bytes: int = 0
    epochs: int = 0
    last_host_to_device_bytes: int = 0
    writeback_rows: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class RegistryMirror:
    """Columnar registry mirror bound to one state object's lifetime and one
    device, or a mesh of them (the columns in row blocks)."""

    def __init__(self, device: torch.device, mesh=None):
        self.mesh = None if mesh is None else list(mesh)
        self.device = device if self.mesh is None else self.mesh[0]
        self.n = 0
        self.n_pad = 0
        self.cols: dict[str, torch.Tensor] = {}  # name -> device tensor (padded)
        self.shadow: dict[str, np.ndarray] = {}  # name -> host numpy (padded)
        self.stats = MirrorStats()
        self._pubkey_map: dict[bytes, int] | None = None
        self._pubkey_n = 0

    # -- host<->device helpers -------------------------------------------

    def put(self, arr: np.ndarray, epochs: bool = False, device=None) -> torch.Tensor:
        """Upload a host column (``kernels.to_device``), counting its bytes."""
        t = to_device(arr, self.device if device is None else device, epochs=epochs)
        nbytes = t.numel() * t.element_size()
        self.stats.host_to_device_bytes += nbytes
        self.stats.last_host_to_device_bytes += nbytes
        return t

    def put_rows(self, arr: np.ndarray, epochs: bool = False):
        """Upload a padded per-validator column: one tensor, or over a mesh
        its row blocks, block s on ``mesh[s]``."""
        if self.mesh is None:
            return self.put(arr, epochs)
        b = arr.shape[0] // len(self.mesh)
        return [self.put(arr[s * b:(s + 1) * b], epochs, dev) for s, dev in enumerate(self.mesh)]

    def pad_and_put(self, arr: np.ndarray, fill=0):
        """Pad a per-validator host array to the shape bucket and upload
        (the per-epoch balances/participation/inactivity path)."""
        if arr.shape[0] != self.n_pad:
            padded = np.full(self.n_pad, fill, dtype=arr.dtype)
            padded[: arr.shape[0]] = arr
            arr = padded
        return self.put_rows(arr)

    def pubkey_map(self, state) -> dict[bytes, int]:
        """Lazy pubkey -> validator-index map over this mirror's state
        lineage (the registry is append-only and pubkeys are immutable, so
        the map only ever extends)."""
        vs = state.validators
        m = self._pubkey_map
        if m is None:
            m = {}
            self._pubkey_map = m
            self._pubkey_n = 0
        for i in range(self._pubkey_n, len(vs)):
            m[bytes(vs[i].pubkey)] = i
        self._pubkey_n = len(vs)
        return m

    # -- sync -------------------------------------------------------------

    def sync(self, state) -> None:
        """Bring the device registry columns up to date with the state's
        Python validator objects, by journal deltas when possible."""
        self.stats.last_host_to_device_bytes = 0
        vs = state.validators
        n = len(vs)
        j = journal_of(state)
        if not self.cols or j is None or not j.valid or n < j.n_base:
            self._full_gather(state, n)
            return
        dirty = sorted(j.dirty.union(range(j.n_base, n)))
        dirty = [i for i in dirty if i < n]
        if n > self.n_pad:
            self._regrow(n)
        if dirty:
            self._apply_rows(vs, dirty)
        self.n = n
        j.reset(n)
        self.stats.delta_syncs += 1
        self.stats.dirty_rows += len(dirty)

    def _full_gather(self, state, n: int) -> None:
        vs = state.validators
        self.n = n
        self.n_pad = bucket(n)
        for name, dt in _REG_DTYPES.items():
            col = np.full(self.n_pad, _PAD_VALUES[name], dtype=dt)
            col[:n] = [_field_value(v, name) for v in vs]
            self.shadow[name] = col
            self.cols[name] = self.put_rows(col, epochs=name in EPOCH_COLUMNS)
        j = journal_of(state)
        if j is None:
            install_journal(state, n)
        else:
            j.reset(n)
        self.stats.full_syncs += 1
        self._set_resident_gauge()

    def _regrow(self, n: int) -> None:
        new_pad = bucket(n)
        for name, dt in _REG_DTYPES.items():
            col = np.full(new_pad, _PAD_VALUES[name], dtype=dt)
            col[: self.n_pad] = self.shadow[name]
            self.shadow[name] = col
            self.cols[name] = self.put_rows(col, epochs=name in EPOCH_COLUMNS)
        self.n_pad = new_pad
        self._set_resident_gauge()

    def _set_resident_gauge(self) -> None:
        from ..utils import metrics

        metrics.EPOCH_MIRROR_BYTES.set(sum(_nbytes(t) for t in self.cols.values()))

    def _apply_rows(self, vs, rows: list[int]) -> None:
        idx = np.asarray(rows, dtype=np.int64)
        for name, dt in _REG_DTYPES.items():
            vals = np.asarray([_field_value(vs[i], name) for i in rows], dtype=dt)
            self.shadow[name][idx] = vals
        b = self.n_pad if self.mesh is None else self.n_pad // len(self.mesh)
        for s, dev in enumerate(self.mesh or [self.device]):
            sel = idx[(idx >= s * b) & (idx < (s + 1) * b)]
            if not sel.size:
                continue
            loc = self.put(sel - s * b, device=dev)
            for name in _REG_DTYPES:
                col = self.cols[name] if self.mesh is None else self.cols[name][s]
                col.index_put_((loc,), self.put(self.shadow[name][sel],
                                                epochs=name in EPOCH_COLUMNS, device=dev))

    # -- post-sweep write-back --------------------------------------------

    def apply_outputs(self, state, outs: dict) -> None:
        """Adopt the sweep's new registry columns as the device-resident
        truth and write back only the changed rows to the Python objects."""
        vs = state.validators
        n = self.n
        changed_total = 0
        for name in _REG_DTYPES:
            if name not in outs:
                continue
            new_dev = outs[name]
            new_host = from_device(new_dev, epochs=name in EPOCH_COLUMNS)
            self.stats.device_to_host_bytes += _nbytes(new_dev)
            old = self.shadow[name]
            changed = np.nonzero(new_host[:n] != old[:n])[0]
            if changed.size:
                attr = _FIELD_ATTRS[name]
                cast = bool if name == "slashed" else int
                for i in changed:
                    setattr(vs[int(i)], attr, cast(new_host[i]))
                changed_total += int(changed.size)
            self.shadow[name] = new_host
            self.cols[name] = new_dev
        self.stats.writeback_rows += changed_total
        self.stats.epochs += 1
        j = journal_of(state)
        if j is not None:
            j.reset(n)
