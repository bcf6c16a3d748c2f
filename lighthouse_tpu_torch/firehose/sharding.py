"""Shard-aware serving tier: group planning + per-shard fault domains. The
port's copy of ``lighthouse_tpu/firehose/sharding.py``, whole.

The data-parallel layer between the firehose engine and the device mesh.
Deliberately device-free (like ``resilience/``): the mesh arithmetic lives in
``bls/mesh.py`` + ``bls/sharded.py`` and is injected as callables, so every
fault-domain decision here is unit-testable with stubs.

Two pieces:

* ``plan_shards`` — forms N fixed-shape sub-batches per tick: whole
  signature-set *groups* (1 set per unaggregated attestation, 3 per
  aggregate) are least-loaded-assigned to shards so a group never straddles
  a shard boundary, and each sub-batch is padded to a shared power-of-two
  cap — padding per shard, not per mesh, so a steady-state stream keeps
  one per-shard shape.

* ``MeshVerifier`` — the per-shard fault domains and the mesh degradation
  ladder. One ``resilience`` supervisor per device (``bls_shard<i>``) plus
  one mesh-level supervisor (``bls_mesh``) drive the ladder::

      mesh N -> mesh N/2 -> ... -> single device [-> CPU oracle]

  A faulted shard demotes ONLY itself (its supervisor walks the normal
  HEALTHY -> DEGRADED -> QUARANTINED machinery); the mesh shrinks around it
  — first within the call (the ladder descends past the faulted shard) and
  then across calls (a quarantined shard leaves ``healthy`` until its
  probation probe, at which point the mesh re-grows; both transitions are
  visible in the resilience metrics). The CPU oracle rung is present only
  when the caller passes ``oracle_fn`` (the chain does so for a CPU mesh,
  never for a mesh of cards). Verdict integrity is fail-closed: when every
  rung faults the call raises ``SupervisedFault`` and callers count the
  batch as errored — work may be dropped, never falsely verified.

  Injection seams (``resilience.inject``): ``mesh.shard<i>`` faults device
  i's pre-dispatch liveness check; ``bls.mesh_verify`` /
  ``bls.mesh_verify/mesh<k>`` target the mesh rungs themselves.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..resilience import SupervisorConfig, get_supervisor
from ..resilience.supervisor import run_with_deadline
from ..utils.metrics import MESH_ACTIVE_DEVICES, MESH_SHARD_VERDICTS

MESH_DOMAIN = "bls_mesh"
SHARD_DOMAIN_PREFIX = "bls_shard"


def pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _bucket(n: int, floor: int = 1) -> int:
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


@dataclass
class ShardPlan:
    """One tick's shard assignment: ``shard_items[s]`` is shard s's
    sub-batch (item triples, ≤ ``cap``), ``group_shard[g]`` maps group g to
    its shard — the per-shard verdict vector indexes back to groups."""

    shard_items: list
    group_shard: list
    cap: int


def plan_shards(groups, n_shards: int, cap_floor: int = 4) -> ShardPlan:
    """Assign whole groups to shards, least-loaded-first (deterministic:
    ties go to the lowest shard index), then bucket the cap to the largest
    fill. Groups never straddle shards, so one shard's verdict covers each
    of its groups completely."""
    shard_items = [[] for _ in range(n_shards)]
    group_shard = []
    fills = [0] * n_shards
    for g in groups:
        s = min(range(n_shards), key=lambda i: (fills[i], i))
        shard_items[s].extend(g)
        group_shard.append(s)
        fills[s] += len(g)
    cap = _bucket(max([cap_floor] + fills))
    return ShardPlan(shard_items, group_shard, cap)


class MeshShrunk(RuntimeError):
    """Not enough healthy shards for a mesh rung — the ladder descends to
    the next (smaller) rung; health only changes via probation probes."""


class MeshVerifier:
    """Per-shard fault domains + the mesh degradation ladder (module
    docstring). All device work is injected:

    * ``dispatch_fn(shard_items, device_ids, staged=None, shard_cap=None)``
      -> per-shard verdict list (``bls.mesh.MeshBackend.dispatch``);
    * ``stage_fn(shard_items, device_ids, shard_cap)`` -> opaque staged
      arrays (prep-thread H2D double-buffering; optional);
    * ``single_fn(flat_items) -> bool`` — the single-device engine (the
      ladder's bit-identical-to-today rung);
    * ``oracle_fn(flat_items) -> bool`` — the device-free CPU rung of last
      resort;
    * ``probe_fn(device_id)`` — tiny per-device op for attributing an
      unattributed mesh fault to the shard that caused it (optional).

    Holds NO mutable state of its own — per-call state is call-local and
    cross-call health lives in the process-global supervisors, so instances
    are freely shared between the engine's prep and device threads.
    """

    def __init__(
        self,
        n_devices: int,
        dispatch_fn,
        single_fn=None,
        oracle_fn=None,
        stage_fn=None,
        probe_fn=None,
        cap_floor: int = 4,
        probe_deadline_s: float = 30.0,
        domain: str = MESH_DOMAIN,
        shard_domain_prefix: str = SHARD_DOMAIN_PREFIX,
    ):
        self.n_devices = pow2_floor(max(1, n_devices))
        self.dispatch_fn = dispatch_fn
        self.single_fn = single_fn
        self.oracle_fn = oracle_fn
        self.stage_fn = stage_fn
        self.probe_fn = probe_fn
        self.cap_floor = cap_floor
        self.probe_deadline_s = probe_deadline_s
        self.domain = domain
        # mesh-level supervisor: no in-place retries (a failed mesh rung
        # descends to the shrunken mesh instead of re-dispatching the same
        # shape — the smaller rung IS the retry)
        self.mesh_sup = get_supervisor(domain, SupervisorConfig(max_retries=0))
        # per-device fault domains; deadline 0 = no watchdog thread on the
        # (in-process, non-blocking) liveness check — the dispatch itself
        # runs under the mesh supervisor's watchdog
        self.shard_sups = [
            get_supervisor(
                f"{shard_domain_prefix}{i}",
                SupervisorConfig(deadline_s=0, max_retries=0),
            )
            for i in range(self.n_devices)
        ]

    # -- shard health -------------------------------------------------------

    def healthy_indices(self) -> list[int]:
        """Devices currently allowed to serve (a QUARANTINED shard leaves
        this set until its probation probe re-admits it — that exit/return
        is the cross-call mesh shrink/re-grow)."""
        return [
            i for i in range(self.n_devices)
            if self.shard_sups[i].device_allowed()
        ]

    def _check_shards(self, idxs, failed: set) -> None:
        """Pre-dispatch per-shard liveness seam: the ``mesh.shard<i>``
        injection point, run through each shard's OWN supervisor so a fault
        demotes exactly that shard."""
        for i in idxs:
            try:
                self.shard_sups[i].run(f"mesh.shard{i}", lambda: None)
            except Exception:
                failed.add(i)
                raise

    def _attribute(self, idxs, failed: set) -> None:
        """After an unattributed mesh dispatch fault: probe each
        participating device (bounded by ``run_with_deadline`` — a wedged
        device must not pin the serving thread) through its shard
        supervisor; faulted shards demote and leave the next rung's mesh.
        Attribution is best-effort — it must never mask the dispatch fault."""
        if self.probe_fn is None:
            return
        for i in idxs:
            try:
                self.shard_sups[i].run(
                    f"mesh.shard{i}.probe",
                    lambda i=i: run_with_deadline(
                        f"mesh.shard{i}.probe",
                        lambda: self.probe_fn(i),
                        self.probe_deadline_s,
                    ),
                )
            except Exception:  # noqa: BLE001 — recorded by the supervisor
                failed.add(i)

    # -- staging (prep-thread half of the double buffer) --------------------

    def stage(self, groups):
        """Host prep + per-shard H2D for one tick, run on the firehose prep
        thread while the device thread verifies the previous tick. Returns
        an opaque handle for ``verify_groups`` or None (no ``stage_fn``, a
        degraded mesh, or a staging fault — dispatch re-stages inline)."""
        if self.stage_fn is None or not groups:
            return None
        idxs = self._block_for(self.n_devices, set())
        if idxs is None:
            return None  # shrunken mesh: let the ladder pick the layout
        plan = plan_shards(groups, self.n_devices, self.cap_floor)
        try:
            arrays = self.stage_fn(plan.shard_items, tuple(idxs), plan.cap)
        except Exception:  # noqa: BLE001 — staging is an optimization only
            return None
        return {"plan": plan, "device_ids": list(idxs), "arrays": arrays}

    # -- the supervised mesh ladder ----------------------------------------

    def _block_for(self, size: int, failed: set) -> list[int] | None:
        """First aligned ``size``-device block with every member healthy.
        Shrunken meshes come from ALIGNED BLOCKS (0..N/2, N/2..N, ...), not
        arbitrary healthy subsets: the compile-family count stays bounded
        (≤ 2N-1 meshes ever), selection is deterministic, and blocks match
        real pod ICI locality."""
        allowed = set(self.healthy_indices()) - failed
        for start in range(0, self.n_devices, size):
            block = list(range(start, start + size))
            if all(i in allowed for i in block):
                return block
        return None

    def _mesh_rung(self, groups, size: int, failed: set, staged):
        def run():
            idxs = self._block_for(size, failed)
            if idxs is None:
                raise MeshShrunk(
                    f"no fully-healthy {size}-device block "
                    f"(failed={sorted(failed)})"
                )
            self._check_shards(idxs, failed)
            try:
                if staged is not None and staged["device_ids"] == idxs:
                    plan = staged["plan"]
                    verdicts = self.dispatch_fn(
                        None, tuple(idxs), staged=staged["arrays"]
                    )
                else:
                    plan = plan_shards(groups, size, self.cap_floor)
                    verdicts = self.dispatch_fn(
                        plan.shard_items, tuple(idxs), shard_cap=plan.cap
                    )
            except Exception:
                self._attribute(idxs, failed)
                raise
            MESH_ACTIVE_DEVICES.set(len(idxs), domain=self.domain)
            # the kernel reports False for a shard with no valid rows; an
            # empty shard is not a failure — count it apart so the
            # failed-shard counter stays a real health signal
            owned = set(plan.group_shard)
            for s, ok in enumerate(verdicts):
                if s not in owned:
                    MESH_SHARD_VERDICTS.inc(result="empty")
                else:
                    MESH_SHARD_VERDICTS.inc(result="ok" if ok else "failed")
            return [
                bool(verdicts[plan.group_shard[g]])
                for g in range(len(groups))
            ]

        return run

    def _rungs(self, groups, staged):
        rungs = []
        size = self.n_devices
        failed: set[int] = set()
        first = True
        while size > 1:
            rungs.append((
                f"mesh{size}",
                self._mesh_rung(groups, size, failed, staged if first else None),
            ))
            first = False
            size //= 2
        flat = [it for g in groups for it in g]
        n = len(groups)
        if self.single_fn is not None:
            # one verdict for the whole flat batch: True verifies every
            # group; False means "no attribution" — callers bisect
            rungs.append((
                "device_single", lambda: [bool(self.single_fn(flat))] * n
            ))
        if self.oracle_fn is not None:
            rungs.append((
                "cpu_oracle", lambda: [bool(self.oracle_fn(flat))] * n
            ))
        return rungs

    def verify_groups(self, groups, staged=None) -> list[bool]:
        """Per-GROUP verdicts for one tick (group g's bool is its shard's
        RLC verdict: True proves every set in the group). Raises
        ``SupervisedFault`` when every rung faulted — the caller fails
        closed (counts the batch errored, verifies nothing)."""
        groups = list(groups)
        if not groups:
            return []
        return self.mesh_sup.run_ladder(
            "bls.mesh_verify", self._rungs(groups, staged)
        )

    def verify_items(self, items) -> bool:
        """The ``_batch_verify_items`` drop-in: one bool for a flat item
        batch (each item its own group — per-shard verdicts simply sharpen
        the downstream bisection). Exceptions propagate like the ladder's."""
        return all(self.verify_groups([[it] for it in items]))

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "healthy": self.healthy_indices(),
            "mesh": self.mesh_sup.snapshot(),
            "shards": {
                i: s.snapshot() for i, s in enumerate(self.shard_sups)
            },
        }
