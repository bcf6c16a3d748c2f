"""Device-resident epoch engine: the port of ``lighthouse_tpu/epoch_engine``.

The backend seam mirrors the port's ``bls``: a module-level selection set by
``set_backend``, with everything above it (``per_epoch.process_epoch``, and
through it ``per_slot`` and ``state_advance``) backend-blind.

Backends:

* ``device`` — the default: the PyTorch sweep (``engine.py`` +
  ``kernels.py``) over a device-resident registry mirror (``mirror.py``) on
  ``set_backend``'s ``device`` (default CUDA, raising without it; pass
  ``device="cpu"`` to run the sweep on the CPU). Covers every fork through
  electra; a newer fork runs the numpy path.
* ``numpy`` — the columnar host path in ``state_transition/per_epoch.py``,
  taken only when selected explicitly.

Unlike the reference there is no ``auto`` backend and no environment
variable: nothing falls back to numpy or the CPU because no card is present.
``set_backend(mesh_devices=)`` (the reference's ``sharding=``) sweeps the
registry in row blocks over a device list (``sharded.py``).
The one demotion left is the reference's fault domain: a supervised fault
of the sweep (``epoch_device``) hands that boundary to the numpy path with
the state untouched.
"""

from __future__ import annotations

from .deltas import (  # noqa: F401 — re-exported for the mutation sites
    invalidate_registry_journal,
    journal_of,
    mark_registry_delta,
)

_BACKEND = "device"
_DEVICE = None  # None: CUDA (device.resolve_device)
_MESH = None  # None: one device; else the row blocks' devices
# (fork, "device" | "numpy") -> epoch boundaries that took that path since
# the last reset_boundary_counts (the conformance phase's per-fork check)
_BOUNDARIES: dict = {}


def set_backend(name: str, *, device=None, mesh_devices=None) -> None:
    """Select the epoch backend; ``device`` is where ``"device"`` runs;
    ``mesh_devices`` (an explicit device list, ``bls.mesh.mesh_devices``;
    an empty list or one entry: off) splits the sweep into row blocks, and
    None keeps the mesh as it is, as ``bls.set_backend`` does."""
    global _BACKEND, _DEVICE, _MESH
    if name not in ("device", "numpy"):
        raise ValueError(f"unknown epoch backend {name!r}")
    _BACKEND = name
    _DEVICE = device
    if mesh_devices is not None:
        from ..bls.mesh import mesh_devices as _mesh_of

        _MESH = _mesh_of(mesh_devices)


def get_backend() -> str:
    return _BACKEND


def get_device():
    return _DEVICE


def get_mesh():
    return None if _MESH is None else list(_MESH)


def device_backend_active() -> bool:
    return _BACKEND == "device"


def maybe_process_epoch_on_device(spec, state, device=None) -> bool:
    """The ``process_epoch`` seam: True when the device engine fully handled
    the epoch transition, False when the numpy path should run (the numpy
    backend is selected, the fork has no sweep, or the sweep faulted).

    The device engine runs inside the ``epoch_device`` fault domain
    (resilience.supervisor): a faulted or quarantined sweep returns False
    with the state untouched, so the numpy twin owns that boundary.
    Exceptions from the *write-back* phase deliberately propagate: by then
    the state is partially mutated, and a second full numpy transition
    would apply the epoch twice."""
    handled = device_backend_active()
    if handled:
        from .engine import process_epoch_on_device

        handled = process_epoch_on_device(
            spec, state, device=_DEVICE if device is None else device, mesh_devices=_MESH
        )
    key = (getattr(state, "fork_name", "phase0"), "device" if handled else "numpy")
    _BOUNDARIES[key] = _BOUNDARIES.get(key, 0) + 1
    return handled


def boundary_counts() -> dict:
    """{(fork, "device" | "numpy"): boundaries} since the last reset."""
    return dict(_BOUNDARIES)


def reset_boundary_counts() -> None:
    _BOUNDARIES.clear()


def prepare_state(state, device=None):
    """Bind mirror + delta journal ahead of the first boundary (state_advance
    warm-up). No-op unless the device backend is active."""
    if not device_backend_active():
        return None
    from .engine import prepare_state as _prep

    return _prep(state, device=_DEVICE if device is None else device, mesh_devices=_MESH)


def engine_stats(state) -> dict | None:
    """Mirror counters for observability (chip_smoke's epoch phase)."""
    from .engine import mirror_of

    m = mirror_of(state)
    return None if m is None else m.stats.as_dict()
