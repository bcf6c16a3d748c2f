"""Gossip firehose verification engine: the port's copy of
``lighthouse_tpu/firehose`` (batcher, bisection, engine).

The streaming layer between the beacon processor and the batched BLS
device backend (``bls.backend.verify_indexed_sets_device``):

  * **adaptive batching** (``batcher.py``) — fixed-shape signature-set
    batches (padded downstream to the backend's power-of-two shapes) formed
    under a latency deadline, so a trickle never stalls and a burst
    amortizes one device dispatch over many sets;
  * **double-buffered pipeline** (``engine.py``) — host-side work for batch
    N+1 overlaps device verification of batch N;
  * **back-pressure + shedding** (``batcher.py``) — a bounded intake with a
    per-WorkType drop policy (lowest priority shed first);
  * **bisection fallback** (``bisect.py``) — an aggregate batch failure is
    split and retried to isolate the poisoned set(s) in O(bad * log n)
    batched calls instead of n per-set calls.

  * **sharded serving tier** (``sharding.py``) — N fixed-shape sub-batches
    per tick data-parallel over the device mesh with per-shard verdicts and
    per-shard fault domains (mesh -> N/2 -> single device ladder), behind
    ``bls.set_backend(mesh_devices=)`` (``bls/mesh.py``).

The attester/shuffling cache tier (``attester_cache.py``) resolves gossip
committees for the chain.
"""

from .batcher import AdaptiveBatcher, FirehoseConfig, FirehoseItem
from .bisect import bisect_verify
from .engine import FirehoseEngine, FirehoseStats
from .sharding import MeshShrunk, MeshVerifier, ShardPlan, plan_shards

__all__ = [
    "AdaptiveBatcher",
    "FirehoseConfig",
    "FirehoseEngine",
    "FirehoseItem",
    "FirehoseStats",
    "MeshShrunk",
    "MeshVerifier",
    "ShardPlan",
    "bisect_verify",
    "plan_shards",
]
