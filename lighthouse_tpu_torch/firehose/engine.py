"""The streaming verification engine: intake -> host prep -> device verify.
The port's copy of ``lighthouse_tpu/firehose/engine.py``, whole.

Two pipeline threads double-buffer the work:

  * the **prep thread** pulls fixed-shape batches from the
    ``AdaptiveBatcher`` and runs the host-side stage (committee/cache
    lookups, signature-set construction — everything before the device
    dispatch) for batch N+1;
  * the **device thread** runs batched verification (and bisection fallback
    on a poisoned batch) for batch N.

The handoff between them is a bounded queue of depth ``prep_depth`` (default
1): while the device verifies batch N, the host prepares N+1 and then blocks
— back-pressure propagates to the intake, where the batcher sheds
lowest-priority work instead of growing without bound. The intake itself
(``submit``) never blocks, so gossip/network threads stay responsive under
any device stall.

``synchronous=True`` disables the threads; ``drain()`` runs the pipeline
inline on the caller's thread (the deterministic test mode, mirroring
``BeaconProcessor(synchronous=True)``).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

from ..beacon_processor.processor import WorkType
from ..resilience import faults
from ..utils.metrics import (
    FIREHOSE_BATCH_FILL,
    FIREHOSE_BATCHES_FORMED,
    FIREHOSE_QUEUE_LATENCY,
    FIREHOSE_VERIFIED,
    GOSSIP_VERDICT_LATENCY,
)
from .batcher import AdaptiveBatcher, FirehoseConfig, FirehoseItem
from .bisect import bisect_verify

_LATENCY_RESERVOIR = 4096  # most-recent queue latencies kept for percentiles


@dataclass
class FirehoseStats:
    submitted: int
    verified: int
    rejected: int
    errored: int
    dropped: int
    batches_formed: int
    p50_latency_s: float | None
    p99_latency_s: float | None
    device_faults: int = 0
    expired: int = 0
    # end-to-end gossip->verdict percentiles: measured from the WIRE-ingest
    # stamp when items carry one (falls back to intake enqueue time)
    p50_e2e_s: float | None = None
    p99_e2e_s: float | None = None

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "verified": self.verified,
            "rejected": self.rejected,
            "errored": self.errored,
            "dropped": self.dropped,
            "batches_formed": self.batches_formed,
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "device_faults": self.device_faults,
            "expired": self.expired,
            "p50_e2e_s": self.p50_e2e_s,
            "p99_e2e_s": self.p99_e2e_s,
        }


class FirehoseEngine:
    """Streaming batch scheduler between the work intake and the BLS device
    backend.

    ``prepare_fn(payloads) -> list[(group, meta) | Exception]`` is the host
    stage: one signature-set *group* (list of ``(indices, signing_root,
    sig_bytes)`` triples) per payload plus opaque ``meta`` handed to the
    result callback (e.g. the resolved IndexedAttestation), or an Exception
    marking that payload invalid before any crypto (unknown committee,
    malformed encoding, ...).

    ``verify_items_fn(flat_items) -> bool`` is the device stage: the batched
    RLC verifier (``BeaconChain._batch_verify_items`` shape). A poisoned
    batch is isolated by bisection (``bisect.bisect_verify``), never by
    per-set fallback.
    """

    def __init__(
        self,
        prepare_fn,
        verify_items_fn,
        config: FirehoseConfig | None = None,
        synchronous: bool = False,
        supervisor=None,
        fallback_verify_fn=None,
        shard_planner=None,
    ):
        self.config = config or FirehoseConfig()
        self.batcher = AdaptiveBatcher(self.config)
        self.prepare_fn = prepare_fn
        self.verify_items_fn = verify_items_fn
        # optional fault domain (resilience.BackendSupervisor): device calls
        # run down the degradation ladder full -> halved -> fallback_verify_fn
        # with watchdog + classified retries instead of failing the batch
        self.supervisor = supervisor
        self.fallback_verify_fn = fallback_verify_fn
        # optional sharded serving tier (sharding.MeshVerifier): the prep
        # thread stages per-shard sub-batches + H2D transfers for batch N+1
        # while the device thread runs batch N over the mesh, and verdicts
        # come back per SHARD — a poisoned shard bisects only its own
        # groups. The planner carries its own fault-domain ladder (mesh ->
        # shrunken mesh -> single device [-> CPU oracle]), so it is never
        # combined with `supervisor` (that would double-wrap)
        self.shard_planner = shard_planner
        self.synchronous = synchronous
        # callback(payload, ok, meta) used when submit() gives none
        self.default_callback = None
        self.verified = 0
        self.rejected = 0          # bad signature (bisection-condemned)
        self.errored = 0           # prep-stage rejections
        self.batches_formed = 0
        self.device_faults = 0     # batches that lost their device verdict
        self._latencies: list[float] = []
        self._e2e_latencies: list[float] = []  # wire-ingest -> verdict
        self._stats_lock = threading.Lock()
        self._prepared: queue.Queue = queue.Queue(maxsize=self.config.prep_depth)
        self._threads: list[threading.Thread] = []
        self._stopping = False
        self._aborted = False      # stop() gave up on a wedged thread
        if not synchronous:
            for name, target in (
                ("firehose-prep", self._prep_loop),
                ("firehose-device", self._device_loop),
            ):
                th = threading.Thread(target=target, daemon=True, name=name)
                th.start()
                self._threads.append(th)

    # -- intake -------------------------------------------------------------------

    def submit(
        self,
        payload,
        work_type: WorkType = WorkType.GossipAttestation,
        callback=None,
        ingest_at: float | None = None,
        deadline: float | None = None,
    ) -> bool:
        """Non-blocking intake. Returns False when the item was shed.
        ``ingest_at``/``deadline`` propagate the wire-ingest stamp and the
        item's expiry (loadshed.deadline): expired items are shed at batch
        form time and end-to-end latency is measured from ``ingest_at``."""
        return self.batcher.submit(
            FirehoseItem(
                work_type=work_type, payload=payload, callback=callback,
                ingest_at=ingest_at, deadline=deadline,
            )
        )

    # -- pipeline stages ----------------------------------------------------------

    def _prep_batch(self, batch: list[FirehoseItem]):
        """Host stage: payloads -> signature-set groups (or Exceptions).
        With a shard planner attached, also stages the tick's per-shard
        sub-batches + host->device transfers (so they double-buffer against
        the device thread's in-flight verify)."""
        with self._stats_lock:
            self.batches_formed += 1
        FIREHOSE_BATCHES_FORMED.inc(work_type=batch[0].work_type.name)
        FIREHOSE_BATCH_FILL.observe(len(batch))
        groups = self.prepare_fn([it.payload for it in batch])
        staged = None
        if self.shard_planner is not None:
            real = [
                g for g in groups
                if not isinstance(g, Exception) and g[0]
            ]
            if real:
                staged = self.shard_planner.stage([g for g, _ in real])
        return batch, groups, staged

    def _supervised_verify(self, items) -> bool:
        """The device verify call, run through the fault domain when one is
        attached: full shape -> halved shapes -> CPU fallback, with watchdog
        + bounded transient retries. A ``False`` verdict is a result (it
        triggers bisection), never a fault."""
        if self.supervisor is None:
            return self.verify_items_fn(items)
        rungs = [("device_full", lambda: self.verify_items_fn(items))]
        if len(items) > 1:
            mid = (len(items) + 1) // 2

            def reduced():
                return self.verify_items_fn(items[:mid]) and self.verify_items_fn(
                    items[mid:]
                )

            rungs.append(("device_reduced", reduced))
        if self.fallback_verify_fn is not None:
            rungs.append(
                ("cpu_fallback", lambda: self.fallback_verify_fn(items))
            )
        return self.supervisor.run_ladder("firehose.device_verify", rungs)

    def _sharded_verdicts(self, groups, staged) -> dict[int, bool]:
        """Mesh path: per-SHARD verdicts from the planner, then bisection
        only among the groups of failed shards (a poisoned shard never
        forces a whole-tick bisection)."""
        per_group = self.shard_planner.verify_groups(groups, staged=staged)
        verdicts = {i: ok for i, ok in enumerate(per_group) if ok}
        bad = [i for i, ok in enumerate(per_group) if not ok]
        if bad:
            for i, ok in zip(
                bad,
                bisect_verify(
                    [groups[i] for i in bad],
                    self._supervised_verify,
                    assume_failed=True,
                ),
            ):
                verdicts[i] = ok
        return verdicts

    def _verify_batch(self, prepped) -> None:
        """Device stage: batched verify, bisection on failure, callbacks."""
        batch, entries, staged = prepped
        real = [
            (it, group, meta)
            for it, entry in zip(batch, entries)
            if not isinstance(entry, Exception)
            for group, meta in (entry,)
            if group
        ]
        verdicts: dict[int, bool] = {}
        device_failed = False
        if real:
            # a device fault must not strand the batch without verdicts:
            # every item still gets its callback, counted as errored —
            # and the fault is classified + recorded, never dropped silently
            try:
                if self.shard_planner is not None:
                    verdicts = self._sharded_verdicts(
                        [group for _, group, _ in real], staged
                    )
                elif self._supervised_verify(
                    [item for _, group, _ in real for item in group]
                ):
                    for i, _ in enumerate(real):
                        verdicts[i] = True
                else:
                    for i, ok in enumerate(
                        bisect_verify(
                            [group for _, group, _ in real],
                            self._supervised_verify,
                            assume_failed=True,
                        )
                    ):
                        verdicts[i] = ok
            except Exception as e:  # noqa: BLE001 — device fault fails the batch
                device_failed = True
                faults.record_fault(
                    "firehose.verify_batch", e, domain="firehose"
                )
                with self._stats_lock:
                    self.device_faults += 1
                for i, _ in enumerate(real):
                    verdicts[i] = False
        now = time.monotonic()
        n_ok = n_bad = n_err = 0
        lats = []
        e2e_lats = []
        ri = 0
        for it, entry in zip(batch, entries):
            meta = None
            if isinstance(entry, Exception) or not entry[0]:
                ok = False
                n_err += 1
                if not isinstance(entry, Exception):
                    meta = entry[1]
            else:
                ok = verdicts[ri]
                meta = real[ri][2]
                ri += 1
                if device_failed:
                    n_err += 1
                else:
                    n_ok += ok
                    n_bad += not ok
            lats.append(now - it.enqueued_at)
            e2e_lats.append(
                now - (it.ingest_at if it.ingest_at is not None
                       else it.enqueued_at)
            )
            cb = it.callback or self.default_callback
            if cb is not None:
                try:
                    cb(it.payload, ok, meta)
                except Exception:  # noqa: BLE001 — callbacks never kill the pipe
                    pass
        with self._stats_lock:
            self.verified += n_ok
            self.rejected += n_bad
            self.errored += n_err
            self._latencies.extend(lats)
            if len(self._latencies) > _LATENCY_RESERVOIR:
                del self._latencies[: -_LATENCY_RESERVOIR]
            self._e2e_latencies.extend(e2e_lats)
            if len(self._e2e_latencies) > _LATENCY_RESERVOIR:
                del self._e2e_latencies[: -_LATENCY_RESERVOIR]
        for v in lats:
            FIREHOSE_QUEUE_LATENCY.observe(v)
        for v in e2e_lats:
            GOSSIP_VERDICT_LATENCY.observe(v)
        FIREHOSE_VERIFIED.inc(n_ok, result="ok")
        if n_bad:
            FIREHOSE_VERIFIED.inc(n_bad, result="bad_signature")
        if n_err:
            FIREHOSE_VERIFIED.inc(n_err, result="prep_error")

    # -- threaded pipeline --------------------------------------------------------

    def _handoff(self, prepped) -> bool:
        """Abort-aware put onto the bounded prep->device queue: blocks at
        prep_depth for back-pressure, but stays cancellable so a wedged
        device thread can never pin the prep thread past ``stop()``."""
        while True:
            try:
                self._prepared.put(prepped, timeout=0.2)
                return True
            except queue.Full:
                if self._aborted:
                    return False

    def _prep_loop(self) -> None:
        while True:
            batch = self.batcher.next_batch()
            if batch is None:          # batcher closed and drained
                self._handoff(None)
                return
            try:
                prepped = self._prep_batch(batch)
            except Exception as e:  # noqa: BLE001 — poison batch, keep pumping
                # classified fault record instead of a silent poison
                faults.record_fault("firehose.prep", e, domain="firehose")
                prepped = (batch, [e] * len(batch), None)
            if not self._handoff(prepped):  # blocks at prep_depth: double buffer
                return

    def _device_loop(self) -> None:
        while True:
            try:
                prepped = self._prepared.get(timeout=0.2)
            except queue.Empty:
                if self._aborted:
                    return
                continue
            if prepped is None:
                return
            try:
                self._verify_batch(prepped)
            except Exception as e:  # noqa: BLE001 — a device fault drops one batch
                faults.record_fault("firehose.device_loop", e, domain="firehose")
                with self._stats_lock:
                    self.errored += len(prepped[0])
                    self.device_faults += 1

    # -- synchronous mode / shutdown ---------------------------------------------

    def drain(self) -> int:
        """Inline pipeline for ``synchronous=True``: form + prep + verify
        until the intake is empty. Returns batches processed."""
        n = 0
        while True:
            batch = self.batcher.form_now()
            if batch is None:
                return n
            self._verify_batch(self._prep_batch(batch))
            n += 1

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until everything ACCEPTED so far has a verdict or was
        evicted (or the timeout expires — a hard deadline: a wedged device
        call is recorded as a classified hang fault, never waited out).
        Threaded mode only. Gate-rejected submissions never enter
        ``submitted``, so only post-accept evictions count against it — a
        batch mid-verify keeps this False until its verdicts land."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._stats_lock:
                settled = self.verified + self.rejected + self.errored
            shed = self.batcher.evicted + sum(self.batcher.expired.values())
            if settled + shed >= self.batcher.submitted:
                return True
            time.sleep(0.005)
        faults.record_fault(
            "firehose.flush",
            f"flush timeout: verdicts still outstanding after {timeout:.1f}s",
            kind=faults.FaultKind.HANG,
            domain="firehose",
        )
        return False

    def stop(self, drain_timeout: float = 30.0) -> bool:
        """Drain + shut down the pipeline. ``drain_timeout`` is a HARD
        deadline across both threads: a device call wedged inside the
        backend cannot block shutdown forever — the wedge is recorded as a
        classified hang fault, the handoff queue is aborted so the prep
        thread exits, and the stranded daemon thread is abandoned. Returns
        True on a clean drain, False when a thread had to be abandoned."""
        if self.synchronous:
            self.drain()
            return True
        if not self._stopping:
            self._stopping = True
            self.batcher.close()
        deadline = time.monotonic() + drain_timeout
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        alive = [th.name for th in self._threads if th.is_alive()]
        if not alive:
            return True
        faults.record_fault(
            "firehose.shutdown",
            f"threads {alive} still alive after the {drain_timeout:.1f}s "
            "drain deadline (wedged device call?)",
            kind=faults.FaultKind.HANG,
            domain="firehose",
        )
        self._aborted = True
        try:  # unwedge a prep thread blocked on the handoff queue
            while True:
                self._prepared.get_nowait()
        except queue.Empty:
            pass
        for th in self._threads:
            th.join(timeout=0.5)
        return False

    # -- reporting ----------------------------------------------------------------

    def total_dropped(self) -> int:
        return sum(self.batcher.dropped.values())

    @staticmethod
    def _percentile(sorted_vals: list[float], q: float) -> float | None:
        if not sorted_vals:
            return None
        idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
        return sorted_vals[idx]

    def stats(self) -> FirehoseStats:
        with self._stats_lock:
            lats = sorted(self._latencies)
            e2e = sorted(self._e2e_latencies)
            return FirehoseStats(
                submitted=self.batcher.submitted,
                verified=self.verified,
                rejected=self.rejected,
                errored=self.errored,
                dropped=self.total_dropped(),
                batches_formed=self.batches_formed,
                p50_latency_s=self._percentile(lats, 0.50),
                p99_latency_s=self._percentile(lats, 0.99),
                device_faults=self.device_faults,
                expired=sum(self.batcher.expired.values()),
                p50_e2e_s=self._percentile(e2e, 0.50),
                p99_e2e_s=self._percentile(e2e, 0.99),
            )

    def resilience(self) -> dict | None:
        """Attached fault-domain snapshot (None without a supervisor)."""
        return None if self.supervisor is None else self.supervisor.snapshot()
