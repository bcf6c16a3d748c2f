"""Prometheus-style metrics registry: the port's copy of
``lighthouse_tpu/utils/metrics.py``.

The collectors (Counter, Gauge, Histogram, Registry) and only the metric
families the port's modules record into (chain, beacon processor, store,
caches, firehose, resilience, epoch engine, loadshed, network). Names follow Lighthouse's so
dashboards transfer. Collectors are process-global and cheap enough for hot
paths (an observe is a couple of dict ops); exposition is the Prometheus
text format.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class _Metric:
    def __init__(self, name: str, help_text: str, label_names: tuple = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text, label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def collect(self):
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield key, "", v


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text, label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def collect(self):
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield key, "", v


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    @contextmanager
    def time(self, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    def collect(self):
        with self._lock:
            snapshot = [
                (key, list(counts), self._totals[key], self._sums[key])
                for key, counts in self._counts.items()
            ]
        for key, counts, total, total_sum in snapshot:
            for b, c in zip(self.buckets, counts):
                yield key, f'le="{b}"', c
            yield key, 'le="+Inf"', total
            yield key, "__sum__", total_sum
            yield key, "__count__", total


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help_text, label_names=(), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, label_names, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name, help_text, label_names=()):
        return self._register(Counter, name, help_text, label_names)

    def gauge(self, name, help_text, label_names=()):
        return self._register(Gauge, name, help_text, label_names)

    def histogram(self, name, help_text, label_names=(), buckets=_DEFAULT_BUCKETS):
        return self._register(
            Histogram, name, help_text, label_names, buckets=buckets
        )

    def render(self) -> str:
        """Prometheus text exposition format."""
        out = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, extra, value in m.collect():
                labels = [
                    f'{n}="{v}"' for n, v in zip(m.label_names, key) if v != ""
                ]
                if extra == "__sum__":
                    name, labels_s = f"{m.name}_sum", ",".join(labels)
                elif extra == "__count__":
                    name, labels_s = f"{m.name}_count", ",".join(labels)
                elif extra:
                    name = f"{m.name}_bucket"
                    labels_s = ",".join(labels + [extra])
                else:
                    name, labels_s = m.name, ",".join(labels)
                body = f"{{{labels_s}}}" if labels_s else ""
                out.append(f"{name}{body} {value}")
        return "\n".join(out) + "\n"


# process-global registry (Lighthouse's lazy_static metric statics)
REGISTRY = Registry()

# -- the metric families the port records (names mirror Lighthouse) ---------------

BLOCK_PROCESSING_TIMES = REGISTRY.histogram(
    "beacon_block_processing_seconds",
    "Full runtime of block processing (beacon_chain/src/metrics.rs)",
)

ATTESTATION_BATCH_SETUP_TIMES = REGISTRY.histogram(
    "beacon_attestation_batch_signature_setup_times",
    "Batch attestation signature-set construction "
    "(attestation_verification/batch.rs:57)",
)

ATTESTATION_BATCH_VERIFY_TIMES = REGISTRY.histogram(
    "beacon_attestation_batch_signature_verify_times",
    "Batch attestation signature verification "
    "(attestation_verification/batch.rs:106)",
)

FORK_CHOICE_GET_HEAD_TIMES = REGISTRY.histogram(
    "beacon_fork_choice_get_head_seconds",
    "Fork-choice head computation",
)

PROCESSOR_WORK_EVENTS = REGISTRY.counter(
    "beacon_processor_work_events_total",
    "Work events accepted by the beacon processor",
    label_names=("work_type",),
)

PROCESSOR_QUEUE_LENGTH = REGISTRY.gauge(
    "beacon_processor_queue_length",
    "Current per-work-type queue length",
    label_names=("work_type",),
)

PROCESSOR_OVERFLOW_DROPS = REGISTRY.counter(
    "beacon_processor_overflow_drops_total",
    "Work dropped on queue overflow, per work type",
    label_names=("work_type",),
)

PROCESSOR_EXPIRED_DROPS = REGISTRY.counter(
    "beacon_processor_expired_drops_total",
    "Work dropped past its deadline before dispatch, per work type",
    label_names=("work_type",),
)

FIREHOSE_SHUFFLING_CACHE = REGISTRY.counter(
    "firehose_shuffling_cache_total",
    "Attester/shuffling cache tier lookups (hit / miss)",
    label_names=("result",),
)

EARLY_ATTESTER_CACHE = REGISTRY.counter(
    "early_attester_cache_total",
    "Head-block attestation-data cache lookups (hit / miss / evict)",
    label_names=("result",),
)

STORE_FREEZE_TIMES = REGISTRY.histogram(
    "store_beacon_state_freeze_seconds",
    "Cold-migration time per state (store/src/metrics.rs)",
)

GOSSIP_VERDICT_LATENCY = REGISTRY.histogram(
    "gossip_verdict_latency_seconds",
    "End-to-end wire-ingest to verification-verdict latency",
)
ADMISSION_LEVEL = REGISTRY.gauge(
    "loadshed_admission_level",
    "Current admission level (0=HEALTHY 1=BUSY 2=SATURATED)",
)
ADMISSION_TRANSITIONS = REGISTRY.counter(
    "loadshed_admission_transitions_total",
    "Admission-level transitions",
    label_names=("from_level", "to_level"),
)
SHED_REQUESTS = REGISTRY.counter(
    "loadshed_shed_total",
    "Requests shed by admission control, per surface and priority class",
    label_names=("surface", "priority"),
)
RPC_EXPIRED = REGISTRY.counter(
    "rpc_server_expired_total",
    "Req/Resp requests dropped server-side past the client deadline",
    label_names=("method",),
)
RPC_RTT = REGISTRY.histogram(
    "rpc_rtt_seconds",
    "Req/Resp round-trip times feeding the adaptive timeout estimator",
)
FIREHOSE_EXPIRED = REGISTRY.counter(
    "firehose_expired_total",
    "Firehose items dropped past their deadline before device dispatch",
    label_names=("work_type",),
)
FIREHOSE_INTAKE_DEPTH = REGISTRY.gauge(
    "firehose_intake_depth",
    "Buffered items per work type in the firehose intake",
    label_names=("work_type",),
)
FIREHOSE_DROPPED = REGISTRY.counter(
    "firehose_dropped_total",
    "Items shed by firehose back-pressure, per work type",
    label_names=("work_type",),
)
FIREHOSE_BATCHES_FORMED = REGISTRY.counter(
    "firehose_batches_formed_total",
    "Device batches formed by the adaptive batcher",
    label_names=("work_type",),
)
FIREHOSE_BATCH_FILL = REGISTRY.histogram(
    "firehose_batch_fill",
    "Items per formed firehose batch (pre-padding)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)
FIREHOSE_QUEUE_LATENCY = REGISTRY.histogram(
    "firehose_queue_latency_seconds",
    "Intake-to-verdict latency through the firehose pipeline",
)
FIREHOSE_VERIFIED = REGISTRY.counter(
    "firehose_items_total",
    "Firehose verification outcomes (ok / bad_signature / prep_error)",
    label_names=("result",),
)
RESILIENCE_FAULTS = REGISTRY.counter(
    "resilience_faults_total",
    "Classified device-path faults (resilience/faults.py taxonomy)",
    label_names=("domain", "stage", "kind"),
)
RESILIENCE_HEALTH = REGISTRY.gauge(
    "resilience_health_state",
    "Fault-domain health (0 healthy, 1 degraded, 2 quarantined)",
    label_names=("domain",),
)
RESILIENCE_DEMOTIONS = REGISTRY.counter(
    "resilience_demotions_total",
    "Health-state demotions per fault domain",
    label_names=("domain",),
)
RESILIENCE_PROMOTIONS = REGISTRY.counter(
    "resilience_promotions_total",
    "Health-state re-promotions per fault domain",
    label_names=("domain",),
)
RESILIENCE_RETRIES = REGISTRY.counter(
    "resilience_retries_total",
    "Transient-fault retries on a supervised stage",
    label_names=("domain", "stage"),
)
RESILIENCE_FALLBACK_CALLS = REGISTRY.counter(
    "resilience_fallback_calls_total",
    "Supervised calls answered below the full device rung",
    label_names=("domain", "rung"),
)
RESILIENCE_WATCHDOG_TIMEOUTS = REGISTRY.counter(
    "resilience_watchdog_timeouts_total",
    "Supervised calls that blew the watchdog deadline (hangs)",
    label_names=("domain", "stage"),
)
EPOCH_MIRROR_BYTES = REGISTRY.gauge(
    "epoch_mirror_bytes",
    "Device-resident bytes of the epoch-engine registry mirror columns, "
    "set at every (re)grow/full-gather (epoch_engine/mirror.py)",
)
LC_COMMITTEE_CACHE_BYTES = REGISTRY.gauge(
    "lc_committee_cache_bytes",
    "Device-resident bytes of the light-client per-period committee cache, "
    "set at every cache rebuild (light_client/engine.py)",
)
KZG_TABLE_BYTES = REGISTRY.gauge(
    "kzg_table_bytes",
    "Device-resident bytes of the KZG cell-verification tables, set when "
    "the CellEngine builds them (kzg/engine.py)",
)
