"""Eth1 bridge: deposit-contract log ingestion, eth1-data voting, genesis.

The port's copy of ``lighthouse_tpu/eth1/`` (Lighthouse's ``beacon_node/eth1``
and ``beacon_node/genesis``'s eth1_genesis_service): a provider seam abstracts the execution-chain RPC
(``eth_getLogs``-shaped), the deposit cache keeps the incremental
deposit-contract merkle tree with proof generation, the service follows the
eth1 chain at a distance and supplies block production with eth1-data votes
and provable deposits.
"""

from .deposit_cache import DepositCache, DepositLog
from .genesis import eth1_genesis_state, is_valid_genesis_state
from .provider import Eth1Block, Eth1Provider, MockEth1Provider
from .service import Eth1Service

__all__ = [
    "DepositCache",
    "DepositLog",
    "Eth1Block",
    "Eth1Provider",
    "Eth1Service",
    "MockEth1Provider",
    "eth1_genesis_state",
    "is_valid_genesis_state",
]
