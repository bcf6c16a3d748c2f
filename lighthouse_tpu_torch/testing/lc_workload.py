"""Light-client session fabricator: the port's copy of
``lighthouse_tpu/testing/lc_workload.py`` (the sessions the reference's
bench, engine tests and conformance KATs draw).

Sessions are REAL: interop validators, real sync-committee aggregate
signatures over real signing roots — only the attested headers are
synthetic (deterministic per seed), since the signature check is blind to
whether the header root is on any chain. Heterogeneity knobs: per-session
bitfields, attested slots, and signature slots all vary.
"""

from __future__ import annotations

import numpy as np

from ..oracle.fields import R as CURVE_ORDER
from ..types.containers import BeaconBlockHeader, for_preset
from ..light_client.types import light_client_types
from ..light_client.verify import sync_signing_root


def fabricate_lc_sessions(harness, n_sessions: int, seed: int = 0):
    """Build ``n_sessions`` heterogeneous optimistic-update sessions signed
    by ``harness.state``'s current sync committee.

    Returns ``(sessions, genesis_validators_root)`` where sessions is a
    list of ``(update, sync_committee)`` pairs — the shape
    ``light_client.engine.verify_update_batch`` consumes."""
    spec = harness.spec
    state = harness.state
    ns = for_preset(spec.preset.name)
    fork = spec.fork_name_at_slot(int(state.slot))
    lc = light_client_types(spec.preset.name, fork)
    committee = state.current_sync_committee
    gvr = bytes(state.genesis_validators_root)
    pk_to_idx = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    c = len(committee.pubkeys)
    floor = int(spec.preset.MIN_SYNC_COMMITTEE_PARTICIPANTS)
    rng = np.random.default_rng(seed)
    sessions = []
    for i in range(n_sessions):
        bits = rng.random(c) < 0.75
        while bits.sum() < max(floor, 1):
            bits[rng.integers(0, c)] = True
        hdr = lc.LightClientHeader(
            beacon=BeaconBlockHeader(
                slot=int(state.slot) + i,
                proposer_index=i % max(1, len(state.validators)),
                parent_root=rng.bytes(32),
                state_root=rng.bytes(32),
                body_root=rng.bytes(32),
            )
        )
        update = lc.LightClientOptimisticUpdate(
            attested_header=hdr,
            sync_aggregate=ns.SyncAggregate(
                sync_committee_bits=np.array(bits, dtype=bool),
                sync_committee_signature=b"\x00" * 96,
            ),
            signature_slot=int(state.slot) + i + 1,
        )
        root = sync_signing_root(spec, update, gvr)
        agg_sk = 0
        for j in range(c):
            if bits[j]:
                idx = pk_to_idx[bytes(committee.pubkeys[j])]
                agg_sk = (agg_sk + harness.sks[idx]) % CURVE_ORDER
        update.sync_aggregate.sync_committee_signature = harness._nb.sign(
            agg_sk.to_bytes(32, "big"), root
        )
        sessions.append((update, committee))
    return sessions, gvr


def tamper_session(session, mode: str = "signature"):
    """Corrupted copy of a fabricated session for reject-path tests:
    ``signature`` flips a byte in the aggregate signature, ``header``
    re-signs nothing while changing the attested header (stale sig)."""
    update, committee = session
    u = type(update).decode(update.serialize())
    if mode == "signature":
        sig = bytearray(bytes(u.sync_aggregate.sync_committee_signature))
        sig[50] ^= 0x01
        u.sync_aggregate.sync_committee_signature = bytes(sig)
    elif mode == "header":
        u.attested_header.beacon.state_root = b"\xfe" * 32
    else:
        raise ValueError(f"unknown tamper mode {mode!r}")
    return (u, committee)
