"""Operation-pool persistence (operation_pool/src/persistence.rs): the port's
copy of ``lighthouse_tpu/op_pool/persistence.py`` (the same bytes).

The pool's attestations / slashings / exits survive restarts: on shutdown
the pool is serialized into the store's metadata bucket and rehydrated on
boot. Format: one JSON document with hex-encoded SSZ payloads — attestation
variants store (packed aggregation bits, compressed signature) pairs so the
union-aggregated pool state round-trips exactly.
"""

from __future__ import annotations

import json

import numpy as np

from ..oracle import curves as oc
from ..types.containers import AttestationData

META_KEY = b"op_pool_v1"


def persist(store, pool) -> None:
    """The op-pool persistence barrier: serialize + one metadata put (the
    ``persist.op_pool`` crash point; shutdown AND per-slot durable-datadir
    cadence both route through here)."""
    from ..resilience.crashpoints import maybe_crash

    maybe_crash("persist.op_pool", owner=getattr(store.hot, "owner", None))
    store.put_meta(META_KEY, serialize_pool(pool))


def serialize_pool(pool) -> bytes:
    with pool._lock:
        atts = []
        for data, variants in pool._attestations.values():
            atts.append(
                {
                    "data": type(data).encode(data).hex(),
                    "variants": [
                        {
                            "n": int(bits.size),
                            "bits": np.packbits(bits).tobytes().hex(),
                            "sig": oc.g2_compress(sig).hex(),
                        }
                        for bits, sig in variants
                    ],
                }
            )
        doc = {
            "attestations": atts,
            "proposer_slashings": [
                type(s).encode(s).hex()
                for s in pool._proposer_slashings.values()
            ],
            "attester_slashings": [
                type(s).encode(s).hex() for s in pool._attester_slashings
            ],
            "voluntary_exits": [
                type(e).encode(e).hex()
                for e in pool._voluntary_exits.values()
            ],
            "bls_changes": [
                type(c).encode(c).hex() for c in pool._bls_changes.values()
            ],
        }
    return json.dumps(doc).encode()


def restore_pool(pool, ns, blob: bytes) -> int:
    """Rehydrate ``pool`` in place from ``serialize_pool`` output; returns
    the number of attestation variants restored."""
    doc = json.loads(blob)
    n = 0
    with pool._lock:
        for entry in doc.get("attestations", []):
            data = AttestationData.decode(bytes.fromhex(entry["data"]))
            root = type(data).hash_tree_root(data)
            variants = []
            for v in entry["variants"]:
                bits = np.unpackbits(
                    np.frombuffer(bytes.fromhex(v["bits"]), dtype=np.uint8)
                )[: v["n"]].astype(bool)
                variants.append(
                    (bits, oc.g2_decompress(bytes.fromhex(v["sig"])))
                )
                n += 1
            pool._attestations[root] = (data, variants)
        for h in doc.get("proposer_slashings", []):
            s = ns.ProposerSlashing.decode(bytes.fromhex(h))
            pool._proposer_slashings[
                int(s.signed_header_1.message.proposer_index)
            ] = s
        for h in doc.get("attester_slashings", []):
            pool._attester_slashings.append(
                ns.AttesterSlashing.decode(bytes.fromhex(h))
            )
        for h in doc.get("voluntary_exits", []):
            e = ns.SignedVoluntaryExit.decode(bytes.fromhex(h))
            pool._voluntary_exits[int(e.message.validator_index)] = e
        for h in doc.get("bls_changes", []):
            from ..types.containers import SignedBLSToExecutionChange

            c = SignedBLSToExecutionChange.decode(bytes.fromhex(h))
            pool._bls_changes[int(c.message.validator_index)] = c
    return n
