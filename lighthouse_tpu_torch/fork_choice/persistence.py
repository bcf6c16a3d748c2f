"""Fork-choice persistence (beacon_chain/src/persisted_fork_choice.rs): the
port's copy of ``lighthouse_tpu/fork_choice/persistence.py``. A snapshot's
bytes equal the reference's for the same fork choice, and either package
restores the other's.

Snapshots the proto-array graph (nodes, indices, vote columns) and the
fork-choice store (checkpoints, justified balances, equivocators) to one
JSON document in the store's metadata bucket, and rebuilds a live
``ForkChoice`` from it on boot — so a restarted node keeps its head, its
accumulated attestation weight, and its optimistic/invalid knowledge
instead of reverting to the anchor.
"""

from __future__ import annotations

import json

import numpy as np

from .fork_choice import ForkChoice, ForkChoiceStore, QueuedAttestation
from .proto_array import ExecutionStatus, ProtoArrayForkChoice, ProtoNode

META_KEY = b"fork_choice_v1"


def persist(store, fc: "ForkChoice") -> None:
    """The fork-choice persistence barrier: serialize + one metadata put
    (a single-key write — atomic at the WAL frame layer). The
    ``persist.fork_choice`` crash point lets the chaos sweep kill a node
    exactly between the block batch and this snapshot."""
    from ..resilience.crashpoints import maybe_crash

    maybe_crash(
        "persist.fork_choice", owner=getattr(store.hot, "owner", None)
    )
    store.put_meta(META_KEY, serialize_fork_choice(fc))

_hex = bytes.hex


def _unhex_opt(v):
    return bytes.fromhex(v) if v is not None else None


def serialize_fork_choice(fc: ForkChoice) -> bytes:
    proto, store = fc.proto, fc.store
    nodes = [
        {
            "root": _hex(n.root),
            "parent": n.parent,
            "je": n.justified_epoch,
            "fe": n.finalized_epoch,
            "slot": n.slot,
            "state_root": _hex(n.state_root),
            "target_root": _hex(n.target_root),
            "exec_hash": _hex(n.execution_block_hash)
            if n.execution_block_hash
            else None,
            "exec_status": n.execution_status.value,
            "weight": n.weight,
            "best_child": n.best_child,
            "best_descendant": n.best_descendant,
            "uje": n.unrealized_justified_epoch,
            "ufe": n.unrealized_finalized_epoch,
        }
        for n in proto.nodes
    ]
    doc = {
        "proto": {
            "nodes": nodes,
            "justified_epoch": proto.justified_epoch,
            "finalized_epoch": proto.finalized_epoch,
            "justified_root": _hex(proto.justified_root),
            "finalized_root": _hex(proto.finalized_root),
            "vote_cur": proto._vote_cur.tolist(),
            "vote_next": proto._vote_next.tolist(),
            "vote_epoch": proto._vote_epoch.tolist(),
            "old_balances": proto._old_balances.tolist(),
            "id_roots": [_hex(r) for r in proto._id_roots],
            "proposer_boost_root": _hex(proto.proposer_boost_root),
            "prev_boost_score": getattr(proto, "_prev_boost_score", 0),
        },
        "store": {
            "current_slot": store.current_slot,
            "justified_checkpoint": [
                store.justified_checkpoint[0],
                _hex(store.justified_checkpoint[1]),
            ],
            "finalized_checkpoint": [
                store.finalized_checkpoint[0],
                _hex(store.finalized_checkpoint[1]),
            ],
            "justified_balances": store.justified_balances.tolist(),
            "unrealized_justified": [
                store.unrealized_justified_checkpoint[0],
                _hex(store.unrealized_justified_checkpoint[1]),
            ]
            if store.unrealized_justified_checkpoint
            else None,
            "unrealized_finalized": [
                store.unrealized_finalized_checkpoint[0],
                _hex(store.unrealized_finalized_checkpoint[1]),
            ]
            if store.unrealized_finalized_checkpoint
            else None,
            "equivocating": sorted(int(i) for i in store.equivocating_indices),
            "proposer_boost_root": _hex(store.proposer_boost_root),
        },
        "queued_attestations": [
            {
                "slot": q.slot,
                "root": _hex(q.block_root),
                "indices": [int(i) for i in q.attesting_indices],
                "target_epoch": q.target_epoch,
            }
            for q in fc.queued_attestations
        ],
    }
    return json.dumps(doc).encode()


def restore_fork_choice(spec, blob: bytes) -> ForkChoice:
    doc = json.loads(blob)
    p = doc["proto"]
    proto = ProtoArrayForkChoice(
        finalized_root=bytes.fromhex(p["finalized_root"]),
        finalized_slot=0,
        justified_epoch=p["justified_epoch"],
        finalized_epoch=p["finalized_epoch"],
        justified_root=bytes.fromhex(p["justified_root"]),
    )
    proto.nodes = []
    proto.indices = {}
    for i, n in enumerate(p["nodes"]):
        node = ProtoNode(
            root=bytes.fromhex(n["root"]),
            parent=n["parent"],
            justified_epoch=n["je"],
            finalized_epoch=n["fe"],
            slot=n["slot"],
            state_root=bytes.fromhex(n["state_root"]),
            target_root=bytes.fromhex(n["target_root"]),
            execution_block_hash=_unhex_opt(n["exec_hash"]),
            execution_status=ExecutionStatus(n["exec_status"]),
            weight=n["weight"],
            best_child=n["best_child"],
            best_descendant=n["best_descendant"],
            unrealized_justified_epoch=n["uje"],
            unrealized_finalized_epoch=n["ufe"],
        )
        proto.nodes.append(node)
        proto.indices[node.root] = i
    proto._vote_cur = np.asarray(p["vote_cur"], dtype=np.int64)
    proto._vote_next = np.asarray(p["vote_next"], dtype=np.int64)
    proto._vote_epoch = np.asarray(p["vote_epoch"], dtype=np.uint64)
    proto._old_balances = np.asarray(p["old_balances"], dtype=np.int64)
    proto._id_roots = [bytes.fromhex(r) for r in p["id_roots"]]
    proto._root_ids = {r: i for i, r in enumerate(proto._id_roots) if i > 0}
    proto.proposer_boost_root = bytes.fromhex(p["proposer_boost_root"])
    proto._prev_boost_score = p.get("prev_boost_score", 0)

    s = doc["store"]
    store = ForkChoiceStore(
        current_slot=s["current_slot"],
        justified_checkpoint=(
            s["justified_checkpoint"][0],
            bytes.fromhex(s["justified_checkpoint"][1]),
        ),
        finalized_checkpoint=(
            s["finalized_checkpoint"][0],
            bytes.fromhex(s["finalized_checkpoint"][1]),
        ),
        justified_balances=np.asarray(
            s["justified_balances"], dtype=np.uint64
        ),
    )
    if s["unrealized_justified"]:
        store.unrealized_justified_checkpoint = (
            s["unrealized_justified"][0],
            bytes.fromhex(s["unrealized_justified"][1]),
        )
    if s["unrealized_finalized"]:
        store.unrealized_finalized_checkpoint = (
            s["unrealized_finalized"][0],
            bytes.fromhex(s["unrealized_finalized"][1]),
        )
    store.equivocating_indices = set(s["equivocating"])
    store.proposer_boost_root = bytes.fromhex(s["proposer_boost_root"])

    fc = ForkChoice(spec, store, proto)
    fc.queued_attestations = [
        QueuedAttestation(
            slot=q["slot"],
            block_root=bytes.fromhex(q["root"]),
            attesting_indices=q["indices"],
            target_epoch=q["target_epoch"],
        )
        for q in doc.get("queued_attestations", [])
    ]
    return fc
