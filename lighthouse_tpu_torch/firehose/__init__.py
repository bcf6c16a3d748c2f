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

Not ported yet: the attester/shuffling cache tier (``attester_cache.py``,
which needs the state transition) and the sharded serving tier
(``sharding.py``, multi-GPU).
"""

from .batcher import AdaptiveBatcher, FirehoseConfig, FirehoseItem
from .bisect import bisect_verify
from .engine import FirehoseEngine, FirehoseStats

__all__ = [
    "AdaptiveBatcher",
    "FirehoseConfig",
    "FirehoseEngine",
    "FirehoseItem",
    "FirehoseStats",
    "bisect_verify",
]
