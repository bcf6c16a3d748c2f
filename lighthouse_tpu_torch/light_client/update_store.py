"""Period-indexed LightClientUpdate archive (spec ``get_light_client_update``
serving side + ref ``light_client_server_cache.rs`` best-update tracking).

The port's copy of ``lighthouse_tpu/light_client/update_store.py``: the same
ranking and the same KV rows (column ``lcu``), so either package restores the
other's archive.

One best ``LightClientUpdate`` per sync-committee period, ranked by the spec
``is_better_update`` total order (supermajority first, then committee /
finality relevance, then participation, then age). Accepted updates are
persisted to the hot KV store as SINGLE WAL frames (key = 8-byte BE period,
value = fork byte + SSZ) so a restart serves the same archive — on a
durable ``LevelStore`` each accept is one crash-atomic commit.
"""

from __future__ import annotations

import struct

import numpy as np

from ..store.kv import DBColumn
from .types import light_client_types

# matches network/codec.py's fork tagging (kept local: light_client must not
# import the network layer)
_FORK_ORDER = ["phase0", "altair", "bellatrix", "capella", "deneb", "electra"]

_ZERO_ROOT = b"\x00" * 32


def sync_committee_period(spec, slot: int) -> int:
    return spec.compute_epoch_at_slot(int(slot)) // int(
        spec.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    )


def _num_active(update) -> int:
    return int(
        np.asarray(
            update.sync_aggregate.sync_committee_bits, dtype=bool
        ).sum()
    )


def _is_sync_committee_update(update) -> bool:
    return any(
        bytes(b) != _ZERO_ROOT for b in update.next_sync_committee_branch
    )


def _is_finality_update(update) -> bool:
    return any(bytes(b) != _ZERO_ROOT for b in update.finality_branch)


def is_better_update(spec, new, old) -> bool:
    """The spec's ``is_better_update`` total order (sync-protocol.md):
    True when ``new`` should replace ``old`` for its period."""
    max_active = int(spec.preset.SYNC_COMMITTEE_SIZE)
    new_active, old_active = _num_active(new), _num_active(old)
    new_super = new_active * 3 >= max_active * 2
    old_super = old_active * 3 >= max_active * 2
    if new_super != old_super:
        return new_super
    if not new_super and new_active != old_active:
        return new_active > old_active

    # relevant sync committee: the committee branch is populated AND the
    # attested header sits in the period the signature slot belongs to
    new_rel = _is_sync_committee_update(new) and sync_committee_period(
        spec, int(new.attested_header.beacon.slot)
    ) == sync_committee_period(spec, int(new.signature_slot))
    old_rel = _is_sync_committee_update(old) and sync_committee_period(
        spec, int(old.attested_header.beacon.slot)
    ) == sync_committee_period(spec, int(old.signature_slot))
    if new_rel != old_rel:
        return new_rel

    new_fin, old_fin = _is_finality_update(new), _is_finality_update(old)
    if new_fin != old_fin:
        return new_fin

    # sync-committee finality: the finalized header lives in the attested
    # header's period, so applying the update cannot skip a committee
    if new_fin:
        new_cf = sync_committee_period(
            spec, int(new.finalized_header.beacon.slot)
        ) == sync_committee_period(spec, int(new.attested_header.beacon.slot))
        old_cf = old_fin and sync_committee_period(
            spec, int(old.finalized_header.beacon.slot)
        ) == sync_committee_period(spec, int(old.attested_header.beacon.slot))
        if new_cf != old_cf:
            return new_cf

    if new_active != old_active:
        return new_active > old_active
    if int(new.attested_header.beacon.slot) != int(
        old.attested_header.beacon.slot
    ):
        return int(new.attested_header.beacon.slot) < int(
            old.attested_header.beacon.slot
        )
    return int(new.signature_slot) < int(old.signature_slot)


class LightClientUpdateStore:
    """Best update per period, optionally backed by a KV store.

    ``kv`` is any ``store.kv.KeyValueStore`` (the chain passes its hot
    store); ``None`` keeps the archive memory-only. Known periods are
    restored from the column on construction — a restarted node serves its
    archive without re-seeing the blocks."""

    def __init__(self, spec, kv=None):
        self.spec = spec
        self._kv = kv
        self._best: dict[int, object] = {}
        if kv is not None:
            self._restore()

    # -- persistence --------------------------------------------------------

    def _decode_frame(self, value: bytes):
        fork = _FORK_ORDER[value[0]]
        cls = light_client_types(
            self.spec.preset.name, fork
        ).LightClientUpdate
        return cls.decode(value[1:])

    def _restore(self) -> None:
        for key, value in self._kv.iter_column(DBColumn.LightClientUpdate):
            if len(key) != 8 or not value:
                continue
            period = struct.unpack(">Q", key)[0]
            try:
                self._best[period] = self._decode_frame(value)
            except Exception:  # noqa: BLE001 — a bad row is skipped, not fatal
                continue

    def _load(self, period: int):
        """Read-through backfill: a period absent from the hot map (pruned
        to bound memory, or skipped by a partial restore) is fetched from
        its persisted KV frame and re-cached, so ``updates_by_range``
        serves the full archive over both HTTP and Req/Resp."""
        if self._kv is None:
            return None
        value = self._kv.get(
            DBColumn.LightClientUpdate, struct.pack(">Q", int(period))
        )
        if not value:
            return None
        try:
            update = self._decode_frame(value)
        except Exception:  # noqa: BLE001 — a bad row serves nothing
            return None
        self._best[int(period)] = update
        return update

    def _get(self, period: int):
        u = self._best.get(int(period))
        return u if u is not None else self._load(period)

    def _persist(self, period: int, update) -> None:
        if self._kv is None:
            return
        fork = self.spec.fork_name_at_slot(int(update.signature_slot))
        value = bytes([_FORK_ORDER.index(fork)]) + type(update).encode(update)
        # ONE frame per accept: crash-atomic on LevelStore-backed nodes
        self._kv.do_atomically(
            [
                (
                    "put",
                    DBColumn.LightClientUpdate,
                    struct.pack(">Q", period),
                    value,
                )
            ]
        )

    # -- ranking ------------------------------------------------------------

    def consider(self, update) -> bool:
        """Rank ``update`` against the period's incumbent; keep + persist
        the winner. Returns True when ``update`` became the served one."""
        period = sync_committee_period(
            self.spec, int(update.attested_header.beacon.slot)
        )
        # read-through: a pruned period's persisted incumbent still ranks
        old = self._get(period)
        if old is not None and not is_better_update(self.spec, update, old):
            return False
        self._best[period] = update
        self._persist(period, update)
        return True

    # -- serving ------------------------------------------------------------

    def get_updates(self, start_period: int, count: int) -> list:
        """Best updates for ``[start_period, start_period + count)`` —
        periods with no update are skipped (the API contract: the response
        carries what the server holds, in period order). Periods missing
        from the hot map read through to their persisted KV frames."""
        out = []
        for p in range(int(start_period), int(start_period) + int(count)):
            u = self._get(p)
            if u is not None:
                out.append(u)
        return out

    def best(self, period: int):
        return self._get(int(period))

    def prune_hot(self, keep: int) -> int:
        """Evict all but the newest ``keep`` periods from the hot map. The
        KV frames stay — serving reads pruned periods back through
        ``_load`` on demand. Returns the number of evicted periods."""
        periods = sorted(self._best)
        evict = periods[: max(len(periods) - max(int(keep), 0), 0)]
        for p in evict:
            del self._best[p]
        return len(evict)

    def known_periods(self) -> list[int]:
        return sorted(self._best)

    def __len__(self) -> int:
        return len(self._best)
