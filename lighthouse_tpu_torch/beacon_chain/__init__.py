"""Beacon chain runtime (beacon_node/beacon_chain twin).

The port's copy of ``lighthouse_tpu/beacon_chain``.
"""

from .chain import BeaconChain, BlockError
from .pubkey_cache import ValidatorPubkeyCache
