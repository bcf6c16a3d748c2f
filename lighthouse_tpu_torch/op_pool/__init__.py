"""Operation pool: attestations, slashings, exits awaiting inclusion.

Twin of ``beacon_node/operation_pool``: attestations aggregated per
``AttestationData`` (attestation_storage.rs), block packing by greedy
max-cover over reward-weighted candidates (max_cover.rs), plus the naive
per-(slot,committee) aggregation pool for gossip subnets
(``beacon_chain/src/naive_aggregation_pool.rs``).

The port's copy of ``lighthouse_tpu/op_pool``.
"""

from .pool import OperationPool
from .max_cover import maximum_cover
from .naive_aggregation import NaiveAggregationPool
