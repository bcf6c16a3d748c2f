"""The serving mesh and the device glue of the sharded BLS serving tier: the
port of ``lighthouse_tpu/bls/mesh.py``.

The data-parallel serving tier (``firehose/sharding.py``) is device-free so
its fault-domain logic stays unit-testable; everything that touches devices
lives here:

* **the mesh** is an explicit list of ``torch.device``s, floored to a power
  of two (the ladder halves it N -> N/2 -> ... and the shard shapes stay
  stable). Repeats are allowed: ``[cuda:0] * 4`` is four logical shards on
  one card, ``[cpu] * 4`` four on the CPU. ``None``, an empty list or one
  entry means the mesh is off (the single-device path, unchanged). No
  environment variable, no ``"auto"`` and no count of the visible cards
  chooses it: the caller passes it (``bls.set_backend(mesh_devices=)``,
  ``bn --mesh-devices``).
* **dispatch glue** — ``make_mesh_backend`` binds the per-shard-verdict
  path (``sharded.verify_staged_pershard``) into the ``stage`` /
  ``dispatch`` / ``probe`` callables ``MeshVerifier`` takes. A shard's
  index is its position in the mesh list.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def mesh_devices(devices) -> list[torch.device] | None:
    """The mesh for a device list: the first ``pow2_floor(len)`` entries as
    ``torch.device``s, or None (mesh off) for None or fewer than two."""
    if devices is None:
        return None
    devs = [torch.device(d) for d in devices]
    if len(devs) < 2:
        return None
    return devs[: pow2_floor(len(devs))]


def parse_mesh_devices(text: str | None) -> list[str] | None:
    """``bn --mesh-devices`` -> the device list: ``cuda:0,cuda:1`` (a
    comma-separated list of torch devices); empty means off."""
    if not text:
        return None
    return [d.strip() for d in text.split(",") if d.strip()] or None


def device_context(dev: torch.device):
    """The context a shard's launches run under: its card made current (the
    kernels take operands on the current device and launch on its stream),
    or nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def replicate(cache: torch.Tensor, devices) -> list[torch.Tensor]:
    """The pubkey cache for every shard: ONE copy per distinct device (four
    logical shards on one card share the card's cache; ``Tensor.to`` copies
    nothing onto the device the cache is on)."""
    copies: dict[torch.device, torch.Tensor] = {}
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = cache.to(d)
    return [copies[torch.device(d)] for d in devices]


class MeshBackend:
    """The device side of the serving tier: staging (host prep + per-shard
    uploads), dispatch (the per-shard-verdict path) and a per-device
    liveness probe for fault attribution. ``cache_fn`` resolves the pubkey
    cache at call time (it grows with the validator registry); its replicas
    on the other devices are kept until it changes."""

    def __init__(self, cache_fn, devices):
        self.cache_fn = cache_fn
        self.devices = [torch.device(d) for d in devices]
        self._lock = threading.Lock()
        self._replicas: tuple | None = None  # (cache, its length, per-shard caches)

    def caches(self, device_ids) -> list[torch.Tensor]:
        cache = self.cache_fn()
        with self._lock:
            r = self._replicas
            if r is None or r[0] is not cache or r[1] != cache.shape[0]:
                r = self._replicas = (cache, cache.shape[0], replicate(cache, self.devices))
        return [r[2][i] for i in device_ids]

    def stage(self, shard_items, device_ids, shard_cap: int):
        """Host stage + per-shard upload for one tick's sub-batches, run on
        the firehose prep thread while the device thread verifies the
        previous tick."""
        from . import sharded

        staged = sharded.stage_indexed_shards(shard_items, shard_cap)
        return sharded.put_staged(staged, [self.devices[i] for i in device_ids])

    def dispatch(self, shard_items, device_ids, staged=None, shard_cap: int | None = None):
        """Per-shard verdicts for one tick. ``staged`` (from ``stage``) skips
        re-staging on the fast path; the ladder's re-staging rungs pass
        fresh ``shard_items``."""
        from . import sharded

        devs = [self.devices[i] for i in device_ids]
        if staged is None:
            cap = shard_cap or sharded.bucket(max((len(sh) for sh in shard_items), default=1))
            staged = sharded.put_staged(sharded.stage_indexed_shards(shard_items, cap), devs)
        oks = sharded.verify_staged_pershard(self.caches(device_ids), staged, devs)
        return [bool(o) for o in oks]

    def probe(self, device_id: int) -> None:
        """One tiny op on one device, waited for: the fault-attribution probe
        the ladder runs after an unattributed mesh fault."""
        dev = self.devices[device_id]
        with device_context(dev):
            out = torch.arange(4, dtype=torch.int64, device=dev).sum()
            got = int(out)  # lint: allow(host-sync) the probe waits for its device by design
            if got != 6:
                raise RuntimeError(f"probe of {dev} returned {got}")


def make_mesh_backend(cache_fn, devices) -> MeshBackend:
    return MeshBackend(cache_fn, devices)
