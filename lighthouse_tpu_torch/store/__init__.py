"""Storage: column KV abstraction, MemoryStore, hot/cold DB.

Twin of ``beacon_node/store``: ``KeyValueStore`` trait + ``MemoryStore`` +
``HotColdDB`` split (``hot_cold_store.rs:51-81``).

The port's copy of ``lighthouse_tpu/store``.
"""

from .kv import DBColumn, KeyValueStore, MemoryStore, LevelStore
from .hot_cold import HotColdDB, StoreConfig
