"""Blinded block variants (execution payload replaced by its header).

The reference defines ``BlindedBeaconBlock`` via superstruct macros
(``consensus/types/src/beacon_block.rs`` blinded variants, used by the
builder flow in ``beacon_node/execution_layer/src/lib.rs``); here the
classes are derived from the full containers by swapping the payload field
for the header. Because ``ExecutionPayloadHeader`` carries the Merkle roots
of the list fields, a blinded block's ``hash_tree_root`` equals the full
block's — a proposer signature over one is valid for the other, which is
what makes the blinded production/publication round-trip sound.
"""

from __future__ import annotations

from ..ssz import Container
from .containers import BLSSignature


def blinded_types(ns):
    """Augment a ``for_preset`` namespace with ``blinded_body_types``,
    ``blinded_block_types`` (signed, fork-indexed). Idempotent."""
    if hasattr(ns, "blinded_block_types"):
        return ns
    bodies, signed_blocks = {}, {}
    for fork, hdr_cls in ns.payload_header_types.items():
        body_cls = ns.body_types[fork]
        fields = [
            (("execution_payload_header", hdr_cls)
             if name == "execution_payload" else (name, t))
            for name, t in body_cls.FIELDS
        ]
        body = type(
            f"BlindedBeaconBlockBody_{fork}", (Container,), {"FIELDS": fields}
        )
        inner_full = dict(ns.block_types[fork].FIELDS)["message"]
        blk_fields = [
            (name, body if name == "body" else t)
            for name, t in inner_full.FIELDS
        ]
        blk = type(
            f"BlindedBeaconBlock_{fork}", (Container,), {"FIELDS": blk_fields}
        )
        signed = type(
            f"SignedBlindedBeaconBlock_{fork}",
            (Container,),
            {"FIELDS": [("message", blk), ("signature", BLSSignature)]},
        )
        bodies[fork] = body
        signed_blocks[fork] = signed
    ns.blinded_body_types = bodies
    ns.blinded_block_types = signed_blocks
    return ns


def payload_to_header(ns, fork: str, payload):
    """ExecutionPayload -> ExecutionPayloadHeader (list fields replaced by
    their hash_tree_roots — per_block_processing builds headers the same
    way; spec ``get_execution_payload_header``)."""
    payload_cls = ns.payload_types[fork]
    hdr_cls = ns.payload_header_types[fork]
    types = dict(payload_cls.FIELDS)
    fields = {}
    for name, _ in payload_cls.FIELDS:
        if name in ("transactions", "withdrawals"):
            fields[f"{name}_root"] = types[name].hash_tree_root(
                getattr(payload, name)
            )
        else:
            fields[name] = getattr(payload, name)
    return hdr_cls(**fields)


def blind_signed_block(ns, fork: str, signed_block):
    """Full signed block -> signed blinded block (same signature — the tree
    roots agree)."""
    blinded_types(ns)
    body = signed_block.message.body
    blinded_body_cls = ns.blinded_body_types[fork]
    fields = {}
    for name, _ in blinded_body_cls.FIELDS:
        if name == "execution_payload_header":
            fields[name] = payload_to_header(ns, fork, body.execution_payload)
        else:
            fields[name] = getattr(body, name)
    blinded_cls = ns.blinded_block_types[fork]
    inner_cls = dict(blinded_cls.FIELDS)["message"]
    msg = signed_block.message
    inner = inner_cls(
        slot=msg.slot,
        proposer_index=msg.proposer_index,
        parent_root=msg.parent_root,
        state_root=msg.state_root,
        body=blinded_body_cls(**fields),
    )
    return blinded_cls(message=inner, signature=signed_block.signature)


def unblind_signed_block(ns, fork: str, signed_blinded, payload):
    """Signed blinded block + the matching full payload -> full signed block.
    Raises ``ValueError`` if the payload does not match the header root."""
    hdr = signed_blinded.message.body.execution_payload_header
    rebuilt = payload_to_header(ns, fork, payload)
    if type(hdr).hash_tree_root(hdr) != type(rebuilt).hash_tree_root(rebuilt):
        raise ValueError("payload does not match the blinded header")
    body_cls = ns.body_types[fork]
    bb = signed_blinded.message.body
    fields = {}
    for name, _ in body_cls.FIELDS:
        if name == "execution_payload":
            fields[name] = payload
        else:
            fields[name] = getattr(bb, name)
    block_cls = ns.block_types[fork]
    inner_cls = dict(block_cls.FIELDS)["message"]
    msg = signed_blinded.message
    inner = inner_cls(
        slot=msg.slot,
        proposer_index=msg.proposer_index,
        parent_root=msg.parent_root,
        state_root=msg.state_root,
        body=body_cls(**fields),
    )
    return block_cls(message=inner, signature=signed_blinded.signature)
