"""Block-level delta journal for the device-resident registry mirror.

The mirror (``mirror.py``) keeps the validator registry's epoch-processing
columns as device arrays. Between epochs, block processing mutates a handful
of validators (slashings, exits, deposits); re-gathering the whole registry
from Python objects each epoch would throw the device residency away. The
journal records exactly which validator indices were touched so the next
``RegistryMirror.sync`` scatters only those rows host→device.

The journal is attached to the state object itself (``state._registry_deltas``
— a per-state attribute that ``state.copy()``, unlike ``_committee_caches``,
drops), so a copied state triggers a clean full re-gather. Mutation sites
that cannot be attributed to a single index (fork upgrades, the numpy epoch
path's field loops) call ``invalidate_registry_journal`` instead, forcing the
next sync to re-gather.

The port's copy of ``lighthouse_tpu/epoch_engine/deltas.py``. Import-light on
purpose: no torch here — the journal marks run on every block whether or not
the device backend is active.
"""

from __future__ import annotations

_ATTR = "_registry_deltas"

# Past this many dirty rows a full columnar re-gather is cheaper than the
# per-row scatter bookkeeping; the journal degrades to "invalid" (full sync).
_MAX_TRACKED = 8192


class RegistryDeltaJournal:
    __slots__ = ("dirty", "valid", "n_base")

    def __init__(self, n_validators: int):
        self.dirty: set[int] = set()
        self.valid = True
        self.n_base = n_validators  # registry length at last sync

    def mark(self, index: int) -> None:
        if not self.valid:
            return
        self.dirty.add(int(index))
        if len(self.dirty) > _MAX_TRACKED:
            self.invalidate()

    def invalidate(self) -> None:
        self.valid = False
        self.dirty.clear()

    def reset(self, n_validators: int) -> None:
        self.dirty.clear()
        self.valid = True
        self.n_base = n_validators


def journal_of(state) -> RegistryDeltaJournal | None:
    return getattr(state, _ATTR, None)


def install_journal(state, n_validators: int) -> RegistryDeltaJournal:
    j = RegistryDeltaJournal(n_validators)
    object.__setattr__(state, _ATTR, j)
    return j


def mark_registry_delta(state, index: int) -> None:
    """Record that ``state.validators[index]`` was mutated (cheap no-op when
    no mirror is bound to this state)."""
    j = getattr(state, _ATTR, None)
    if j is not None:
        j.mark(index)


def invalidate_registry_journal(state) -> None:
    """Force the next mirror sync to re-gather (bulk/untracked mutation)."""
    j = getattr(state, _ATTR, None)
    if j is not None:
        j.invalidate()
