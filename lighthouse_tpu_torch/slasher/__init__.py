"""Slashing detection over min/max target arrays (ref slasher/): the port of
``lighthouse_tpu/slasher``.

Two implementations share the ``SlasherService`` surface:

* the seed per-row path (``slasher.py`` + ``arrays.py`` + ``db.py``):
  validator-chunk rows loaded through the KV store per batch — the
  DB-backed twin, kept as the parity oracle;
* the device-resident engine (``engine.py`` + ``kernels.py``): ONE
  ``[n_validators, history_length]`` span store resident on the device
  across ticks, per-batch update + double/surround detection as one sweep.

The backend seam mirrors the port's ``epoch_engine``: ``set_backend(name,
*, device=None)`` selects

* ``device`` — the default: the engine's torch sweep on ``device`` (CUDA
  when None, raising without it; ``device="cpu"`` runs the sweep on the
  CPU, as the tests do). The seed ``Slasher``'s row update runs on the same
  device.
* ``numpy``  — the engine on its field-for-field numpy twin.

Unlike the reference there is no ``auto`` backend and no environment
variable (``LIGHTHOUSE_SLASHER_BACKEND``, ``LIGHTHOUSE_SLASHER_HISTORY``):
nothing falls back to numpy because no card is present, and the window
comes from the ``SlasherConfig`` passed in. The one demotion is the
``slasher_device`` fault domain's, lossless and loud (``engine.py``).

This module stays import-light (no engine import until ``make_slasher``).
"""

from __future__ import annotations

from .config import MAX_DISTANCE, SlasherConfig
from .db import SlasherDB
from .service import SlasherService
from .slasher import Slasher

__all__ = [
    "MAX_DISTANCE",
    "Slasher",
    "SlasherConfig",
    "SlasherDB",
    "SlasherService",
    "device_backend_active",
    "get_backend",
    "get_device",
    "make_slasher",
    "set_backend",
]

_BACKEND = "device"
_DEVICE = None  # None: CUDA (device.resolve_device)


def set_backend(name: str, *, device=None) -> None:
    """Select the slasher backend; ``device`` is where ``"device"`` runs."""
    global _BACKEND, _DEVICE
    if name not in ("device", "numpy"):
        raise ValueError(f"unknown slasher backend {name!r}")
    _BACKEND = name
    _DEVICE = device


def get_backend() -> str:
    return _BACKEND


def get_device():
    return _DEVICE


def device_backend_active() -> bool:
    return _BACKEND == "device"


def make_slasher(store=None, types=None, config: SlasherConfig | None = None,
                 **kw):
    """Construct the engine-backed slasher behind the backend seam (the
    client / node assembly point). ``store`` is the KV store the engine
    checkpoints into (``EngineSlasher.persist``); the engine keeps its
    record index in memory and prunes it with the window.

    With no config the window is the reference's 4096 epochs. The engine's
    planes are DENSE — 8 bytes per validator-epoch cell — so a large
    registry sizes the window to its memory budget (2^20 validators x 4096
    epochs = 32 GiB; x 512 = 4 GiB); the drop window for old evidence
    shrinks with it, exactly like a reference node configured with a
    shorter ``--slasher-history-length``.
    """
    from .engine import EngineSlasher

    slasher = EngineSlasher(store, types, config or SlasherConfig(), **kw)
    if store is not None:
        # restart-from-disk: rehydrate the surveillance window from the
        # last checkpoint (engine.persist) so pre-restart votes still
        # convict a post-restart equivocator
        try:
            slasher.restore()
        except Exception as e:  # noqa: BLE001 — corrupt checkpoint: start fresh
            from ..utils.logging import get_logger

            get_logger("slasher").warning(
                "Slasher checkpoint restore failed", error=str(e)
            )
    return slasher
