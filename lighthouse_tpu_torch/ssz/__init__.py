"""SSZ: SimpleSerialize type system, serialization, and merkleization.

The port's copy of ``lighthouse_tpu/ssz``: the twin of Lighthouse's
``consensus/types`` SSZ substrate (ethereum_ssz + tree_hash crates). Vectorized numpy SHA-256 makes whole-tree merkleization a
batched array op rather than a per-node call.
"""

from .core import (
    SSZError,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Vector,
    Union,
    hash_tree_root,
    serialize,
    deserialize,
)
from .merkle import merkleize_chunks, mix_in_length, ZERO_HASHES
from .sha256 import sha256_pairs, sha256 as sha256_bytes
