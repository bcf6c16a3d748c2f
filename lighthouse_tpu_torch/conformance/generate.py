"""Generate golden conformance vectors: the port's copy of
``lighthouse_tpu/conformance/generate.py``.

The repo's vectors under ``tests/vectors/`` were produced by the reference
package's generator from its oracle ciphersuite and state harness; this copy,
driven through the port's oracle, native backend and ``StateHarness``, writes
the same families byte for byte (pinned by tests/test_torch_conformance.py).
Lighthouse's equivalent inputs are the official consensus-spec-tests.

    python -m lighthouse_tpu_torch.conformance.generate OUT_DIR [FAMILY ...]

It never writes into ``handler.default_vector_root()``: the checked-in tree
is what the runner holds the port to, and is not regenerated from it.
Generation applies blocks with the ``native`` bls backend and the ``numpy``
epoch backend (restored afterwards), so it needs no device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def _w(path: str, name: str, data) -> None:
    os.makedirs(path, exist_ok=True)
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(os.path.join(path, name), mode) as f:
        if isinstance(data, bytes):
            f.write(data)
        else:
            json.dump(data, f, indent=1)


def _case_dir(root, config, fork, runner, handler, idx):
    return os.path.join(root, config, fork, runner, handler, f"case_{idx}")


def gen_bls(root: str, config: str = "general") -> None:
    from ..oracle import ciphersuite as cs
    from ..oracle import curves as oc

    fork = "phase0"

    def hx(b: bytes) -> str:
        return b.hex()

    sks = [cs.keygen_from_ikm(bytes([i]) * 32) for i in range(1, 5)]
    pks = [oc.g1_compress(cs.sk_to_pk(sk)).hex() for sk in sks]
    msg = b"\x11" * 32
    sigs = [oc.g2_compress(cs.sign(sk, msg)).hex() for sk in sks]

    # sign
    for i, sk in enumerate(sks[:2]):
        _w(
            _case_dir(root, config, fork, "bls", "sign", i),
            "data.json",
            {
                "input": {"privkey": sk.to_bytes(32, "big").hex(), "message": hx(msg)},
                "output": sigs[i],
            },
        )
    # verify: valid, wrong message, wrong key, infinity sig
    cases = [
        ({"pubkey": pks[0], "message": hx(msg), "signature": sigs[0]}, True),
        ({"pubkey": pks[0], "message": hx(b"\x22" * 32), "signature": sigs[0]}, False),
        ({"pubkey": pks[1], "message": hx(msg), "signature": sigs[0]}, False),
        (
            {
                "pubkey": pks[0],
                "message": hx(msg),
                "signature": (b"\xc0" + b"\x00" * 95).hex(),
            },
            False,
        ),
    ]
    for i, (inp, out) in enumerate(cases):
        _w(
            _case_dir(root, config, fork, "bls", "verify", i),
            "data.json",
            {"input": inp, "output": out},
        )
    # aggregate
    agg = None
    for sk in sks:
        agg = oc.g2_add(agg, cs.sign(sk, msg))
    _w(
        _case_dir(root, config, fork, "bls", "aggregate", 0),
        "data.json",
        {"input": sigs, "output": oc.g2_compress(agg).hex()},
    )
    # fast_aggregate_verify: valid + one wrong-key
    _w(
        _case_dir(root, config, fork, "bls", "fast_aggregate_verify", 0),
        "data.json",
        {
            "input": {
                "pubkeys": pks,
                "message": hx(msg),
                "signature": oc.g2_compress(agg).hex(),
            },
            "output": True,
        },
    )
    _w(
        _case_dir(root, config, fork, "bls", "fast_aggregate_verify", 1),
        "data.json",
        {
            "input": {
                "pubkeys": pks[:3],
                "message": hx(msg),
                "signature": oc.g2_compress(agg).hex(),
            },
            "output": False,
        },
    )
    # batch_verify: all valid; one poisoned
    msgs = [bytes([i]) * 32 for i in range(3)]
    sets = []
    for i, m in enumerate(msgs):
        a = None
        for sk in sks[: i + 2]:
            a = oc.g2_add(a, cs.sign(sk, m))
        sets.append(
            {
                "pubkeys": pks[: i + 2],
                "message": m.hex(),
                "signature": oc.g2_compress(a).hex(),
            }
        )
    _w(
        _case_dir(root, config, fork, "bls", "batch_verify", 0),
        "data.json",
        {"input": {"sets": sets}, "output": True},
    )
    poisoned = [dict(s) for s in sets]
    poisoned[1]["signature"] = poisoned[0]["signature"]
    _w(
        _case_dir(root, config, fork, "bls", "batch_verify", 1),
        "data.json",
        {"input": {"sets": poisoned}, "output": False},
    )


def gen_shuffling(root: str, config: str = "minimal") -> None:
    from ..ops.shuffle import shuffle_list
    from ..types.spec import mainnet_spec, minimal_spec

    spec = minimal_spec() if config == "minimal" else mainnet_spec()
    rounds = spec.preset.SHUFFLE_ROUND_COUNT
    for i, (seed_byte, count) in enumerate([(0x42, 8), (0x07, 33), (0xA5, 100)]):
        seed = bytes([seed_byte]) * 32
        mapping = np.asarray(
            shuffle_list(np.arange(count, dtype=np.uint64), seed, rounds)
        ).tolist()
        _w(
            _case_dir(root, config, "phase0", "shuffling", "core", i),
            "mapping.json",
            {"seed": seed.hex(), "count": count, "mapping": mapping},
        )


FORKS = ["phase0", "altair", "bellatrix", "capella", "deneb", "electra"]


def fork_overrides(fork: str, at_epoch: int = 0) -> dict:
    """Spec overrides activating every fork up to ``fork`` at ``at_epoch``
    (0 = genesis-active, the per-fork vector convention)."""
    return {f"{f}_fork_epoch": at_epoch for f in FORKS[1 : FORKS.index(fork) + 1]}


def _harness(fork: str, n=32):
    from ..testing.harness import StateHarness
    from ..types.spec import minimal_spec

    return StateHarness(minimal_spec(**fork_overrides(fork)), n)


def gen_ssz_static(root: str, config: str = "minimal") -> None:
    for fork in FORKS:
        h = _harness(fork)
        h.extend_chain(3)
        state = h.state
        block = h.produce_block(state.slot + 1)
        objs = {
            "BeaconState": (type(state), state),
            "SignedBeaconBlock": (type(block), block),
        }
        atts = h.attestations_for_slot(
            state, state.slot, state.latest_block_header.tree_root()
        )
        if atts:
            objs["Attestation"] = (type(atts[0]), atts[0])
        for name, (cls, value) in objs.items():
            d = _case_dir(root, config, fork, "ssz_static", name, 0)
            _w(d, "serialized.ssz", cls.encode(value))
            _w(d, "root.json", {"root": value.tree_root().hex()})


def gen_operations(root: str, config: str = "minimal") -> None:
    from ..state_transition import process_slots
    from ..types.helpers import compute_signing_root, get_domain

    fork = "phase0"
    h = _harness(fork)
    h.extend_chain(2)
    spec = h.spec
    state_cls = type(h.state)

    # --- attestation: valid + bad-target error case
    prev = h.state
    att = h.attestations_for_slot(prev, prev.slot, h.head_root(prev))[0]
    pre = prev.copy()
    process_slots(spec, pre, prev.slot + spec.min_attestation_inclusion_delay)
    d = _case_dir(root, config, fork, "operations", "attestation", 0)
    _w(d, "pre.ssz", state_cls.encode(pre))
    _w(d, "attestation.ssz", type(att).encode(att))
    post = pre.copy()
    from .handler import _op_attestation

    _op_attestation(spec, post, att)
    _w(d, "post.ssz", state_cls.encode(post))

    bad = type(att).decode(type(att).encode(att))
    bad.data.target.root = b"\xde" * 32
    d = _case_dir(root, config, fork, "operations", "attestation", 1)
    _w(d, "pre.ssz", state_cls.encode(pre))
    _w(d, "attestation.ssz", type(bad).encode(bad))
    _w(d, "meta.json", {"error": True})

    # --- voluntary exit: advance past shard_committee_period
    from ..types.containers import SignedVoluntaryExit, VoluntaryExit

    exit_state = h.state.copy()
    target_epoch = spec.shard_committee_period + 1
    process_slots(spec, exit_state, target_epoch * spec.preset.SLOTS_PER_EPOCH)
    exit_msg = VoluntaryExit(epoch=target_epoch, validator_index=3)
    domain = get_domain(
        spec, exit_state, spec.DOMAIN_VOLUNTARY_EXIT, epoch=target_epoch
    )
    sig = h._sign(3, compute_signing_root(exit_msg, domain))
    sve = SignedVoluntaryExit(message=exit_msg, signature=sig)
    d = _case_dir(root, config, fork, "operations", "voluntary_exit", 0)
    _w(d, "pre.ssz", state_cls.encode(exit_state))
    _w(d, "voluntary_exit.ssz", SignedVoluntaryExit.encode(sve))
    post = exit_state.copy()
    from .handler import _op_exit

    _op_exit(spec, post, sve)
    _w(d, "post.ssz", state_cls.encode(post))
    # error twin: wrong signature
    bad = SignedVoluntaryExit(message=exit_msg, signature=h._sign(4, b"\x00" * 32))
    d = _case_dir(root, config, fork, "operations", "voluntary_exit", 1)
    _w(d, "pre.ssz", state_cls.encode(exit_state))
    _w(d, "voluntary_exit.ssz", SignedVoluntaryExit.encode(bad))
    _w(d, "meta.json", {"error": True})

    # --- proposer slashing: two conflicting headers by validator 0
    from ..types.containers import BeaconBlockHeader, SignedBeaconBlockHeader
    from ..types.containers import ProposerSlashing

    st = h.state
    slot = st.slot
    proposer = 0
    hdrs = []
    for i, body_root in enumerate((b"\x01" * 32, b"\x02" * 32)):
        header = BeaconBlockHeader(
            slot=slot,
            proposer_index=proposer,
            parent_root=b"\x03" * 32,
            state_root=b"\x04" * 32,
            body_root=body_root,
        )
        dom = get_domain(
            spec, st, spec.DOMAIN_BEACON_PROPOSER,
            epoch=spec.compute_epoch_at_slot(slot),
        )
        hdrs.append(
            SignedBeaconBlockHeader(
                message=header,
                signature=h._sign(proposer, compute_signing_root(header, dom)),
            )
        )
    ps = ProposerSlashing(signed_header_1=hdrs[0], signed_header_2=hdrs[1])
    d = _case_dir(root, config, fork, "operations", "proposer_slashing", 0)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "proposer_slashing.ssz", ProposerSlashing.encode(ps))
    post = st.copy()
    from .handler import _op_proposer_slashing

    _op_proposer_slashing(spec, post, ps)
    _w(d, "post.ssz", state_cls.encode(post))
    # error twin: identical headers (not slashable)
    same = ProposerSlashing(signed_header_1=hdrs[0], signed_header_2=hdrs[0])
    d = _case_dir(root, config, fork, "operations", "proposer_slashing", 1)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "proposer_slashing.ssz", ProposerSlashing.encode(same))
    _w(d, "meta.json", {"error": True})

    # --- attester slashing: double vote by one committee
    from ..state_transition import get_beacon_committee
    from ..types.containers import AttestationData, Checkpoint

    st2 = h.state
    committee = get_beacon_committee(spec, st2, st2.slot, 0)
    epoch = spec.compute_epoch_at_slot(st2.slot)
    datas = []
    for root_byte in (0x0A, 0x0B):
        datas.append(
            AttestationData(
                slot=st2.slot,
                index=0,
                beacon_block_root=bytes([root_byte]) * 32,
                source=st2.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=bytes([root_byte]) * 32),
            )
        )
    dom = get_domain(spec, st2, spec.DOMAIN_BEACON_ATTESTER, epoch=epoch)
    ns = h.ns
    from ..oracle.fields import R as CURVE_ORDER

    indexed = []
    for data in datas:
        agg_sk = sum(h.sks[int(v)] for v in committee) % CURVE_ORDER
        indexed.append(
            ns.IndexedAttestation(
                attesting_indices=sorted(int(v) for v in committee),
                data=data,
                signature=h._nb.sign(
                    agg_sk.to_bytes(32, "big"), compute_signing_root(data, dom)
                ),
            )
        )
    aslash = ns.AttesterSlashing(attestation_1=indexed[0], attestation_2=indexed[1])
    d = _case_dir(root, config, fork, "operations", "attester_slashing", 0)
    _w(d, "pre.ssz", state_cls.encode(st2))
    _w(d, "attester_slashing.ssz", ns.AttesterSlashing.encode(aslash))
    post = st2.copy()
    from .handler import _op_attester_slashing

    _op_attester_slashing(spec, post, aslash)
    _w(d, "post.ssz", state_cls.encode(post))
    # error twin: same attestation twice
    same = ns.AttesterSlashing(attestation_1=indexed[0], attestation_2=indexed[0])
    d = _case_dir(root, config, fork, "operations", "attester_slashing", 1)
    _w(d, "pre.ssz", state_cls.encode(st2))
    _w(d, "attester_slashing.ssz", ns.AttesterSlashing.encode(same))
    _w(d, "meta.json", {"error": True})


def gen_epoch_processing(root: str, config: str = "minimal") -> None:
    from ..state_transition import process_epoch, process_slots

    for fork in FORKS:
        h = _harness(fork)
        h.extend_chain(h.spec.preset.SLOTS_PER_EPOCH + 2)
        state = h.state.copy()
        # advance to the last slot of the epoch; pre = state ready for epoch proc
        spe = h.spec.preset.SLOTS_PER_EPOCH
        target = (state.slot // spe + 1) * spe - 1
        process_slots(h.spec, state, target)
        state_cls = type(state)
        d = _case_dir(root, config, fork, "epoch_processing", "full", 0)
        _w(d, "pre.ssz", state_cls.encode(state))
        post = state.copy()
        process_epoch(h.spec, post)
        _w(d, "post.ssz", state_cls.encode(post))


def gen_rewards(root: str, config: str = "minimal") -> None:
    """Per-fork rewards vectors: pre.ssz is a state on the last slot of its
    epoch, deltas.json the per-validator balance deltas the rewards stages
    must produce. Generator and runner share ``handler._apply_rewards``, so
    the vectors freeze today's columnar-numpy truth — the exact outputs the
    device epoch kernels (including electra) are parity-tested against.
    Case 1 is a leak twin: finality rolled back far past
    MIN_EPOCHS_TO_INACTIVITY_PENALTY with participation gutted, so the
    inactivity-leak branch pays real penalties."""
    from ..state_transition import process_slots
    from ..types.containers import Checkpoint

    from .handler import _apply_rewards

    for fork in FORKS:
        h = _harness(fork)
        h.extend_chain(h.spec.preset.SLOTS_PER_EPOCH + 2)
        spe = h.spec.preset.SLOTS_PER_EPOCH
        state = h.state.copy()
        target = (state.slot // spe + 1) * spe - 1
        process_slots(h.spec, state, target)
        state_cls = type(state)

        def emit(idx, st):
            d = _case_dir(root, config, fork, "rewards", "core", idx)
            _w(d, "pre.ssz", state_cls.encode(st))
            post = st.copy()
            _apply_rewards(h.spec, post)
            _w(
                d,
                "deltas.json",
                {
                    "deltas": [
                        int(a) - int(b)
                        for a, b in zip(post.balances, st.balances)
                    ]
                },
            )

        emit(0, state)

        # leak twin: park the state deep in an unfinalized stretch. The
        # slot jump skips the block-roots history on purpose — target/head
        # lookups then miss, which IS the leak's non-participation.
        leak = state.copy()
        leak.slot = 8 * spe - 1
        leak.finalized_checkpoint = Checkpoint(epoch=0, root=b"\x00" * 32)
        leak.justification_bits = np.zeros(4, dtype=bool)
        if fork == "phase0":
            leak.previous_epoch_attestations = list(
                leak.previous_epoch_attestations
            )[:1]
        else:
            for field in (
                "previous_epoch_participation",
                "current_epoch_participation",
            ):
                part = np.asarray(getattr(leak, field), dtype=np.uint8)
                part[::2] = 0  # half the set stops attesting: no 2/3 quorum
                setattr(leak, field, part)
            scores = np.asarray(leak.inactivity_scores, dtype=np.uint64)
            scores[:] = 50  # a standing score makes the penalty term bite
            leak.inactivity_scores = scores
        emit(1, leak)


def gen_finality(root: str, config: str = "minimal") -> None:
    """Finality vectors (cases/finality.rs shape): pre.ssz + a multi-epoch
    block chain -> post.ssz, meta.json pinning the justified/finalized
    checkpoints the full transition must reach. One fork per epoch-kernel
    family (phase0 / altair / electra) — bellatrix, capella and deneb share
    the altair family's epoch stage sequence bit-for-bit, so their four-epoch
    signed-block chains would re-verify ~100 block signatures each for zero
    added epoch coverage (their block-level differences are pinned by the
    operations and epoch_processing families)."""
    for fork in ("phase0", "altair", "electra"):
        h = _harness(fork)
        h.extend_chain(2)
        pre = h.state.copy()
        state_cls = type(pre)
        spe = h.spec.preset.SLOTS_PER_EPOCH
        blocks = []
        while h.state.slot < 4 * spe + 1:
            slot = h.state.slot + 1
            prev = h.state
            atts = []
            if prev.slot + h.spec.min_attestation_inclusion_delay <= slot:
                atts = h.attestations_for_slot(prev, prev.slot, h.head_root(prev))
            block = h.produce_block(slot, attestations=atts)
            h.apply_block(block)
            blocks.append(block)
        post = h.state
        assert int(post.finalized_checkpoint.epoch) >= 2, (
            f"{fork}: finality never advanced"
        )
        d = _case_dir(root, config, fork, "finality", "core", 0)
        _w(
            d,
            "meta.json",
            {
                "finalized_epoch": int(post.finalized_checkpoint.epoch),
                "justified_epoch": int(
                    post.current_justified_checkpoint.epoch
                ),
            },
        )
        _w(d, "pre.ssz", state_cls.encode(pre))
        for i, b in enumerate(blocks):
            _w(d, f"blocks_{i}.ssz", type(b).encode(b))
        _w(d, "post.ssz", state_cls.encode(post))


def gen_sanity_blocks(root: str, config: str = "minimal") -> None:
    for fork in FORKS:
        h = _harness(fork)
        h.extend_chain(2)
        pre = h.state.copy()
        state_cls = type(pre)
        blocks = []
        for _ in range(3):
            slot = h.state.slot + 1
            atts = []
            prev = h.state
            if prev.slot + h.spec.min_attestation_inclusion_delay <= slot:
                atts = h.attestations_for_slot(prev, prev.slot, h.head_root(prev))
            block = h.produce_block(slot, attestations=atts)
            h.apply_block(block)
            blocks.append(block)
        d = _case_dir(root, config, fork, "sanity_blocks", "chain", 0)
        _w(d, "pre.ssz", state_cls.encode(pre))
        for i, b in enumerate(blocks):
            _w(d, f"blocks_{i}.ssz", type(b).encode(b))
        _w(d, "post.ssz", state_cls.encode(h.state))


def gen_operations_merge(root: str, config: str = "minimal") -> None:
    """Fork-specific operation vectors: execution payloads (bellatrix),
    withdrawals + credential rotation (capella), EL-triggered requests and
    committee-bits attestations (electra). Mirrors the per-fork handler dirs
    of testing/ef_tests/src/cases/operations.rs."""
    from ..state_transition import process_slots
    from ..types.helpers import compute_domain, compute_signing_root

    # --- bellatrix: execution_payload valid + wrong-parent error twin
    h = _harness("bellatrix")
    h.extend_chain(3)
    st = h.state.copy()
    process_slots(h.spec, st, st.slot + 1)
    state_cls = type(st)
    payload = h._execution_payload(st, st.slot, "bellatrix")
    payload_cls = type(payload)
    d = _case_dir(root, config, "bellatrix", "operations", "execution_payload", 0)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "execution_payload.ssz", payload_cls.encode(payload))
    post = st.copy()
    from ..state_transition.per_block import process_execution_payload

    process_execution_payload(h.spec, post, payload)
    _w(d, "post.ssz", state_cls.encode(post))
    bad = payload_cls.decode(payload_cls.encode(payload))
    bad.parent_hash = b"\xbe" * 32
    d = _case_dir(root, config, "bellatrix", "operations", "execution_payload", 1)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "execution_payload.ssz", payload_cls.encode(bad))
    _w(d, "meta.json", {"error": True})

    # --- capella: withdrawals sweep + bls_to_execution_change
    h = _harness("capella")
    h.extend_chain(3)
    st = h.state.copy()
    # give a validator inside the sweep window (the cursor advances
    # MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP per block) an eth1 credential +
    # excess balance -> partial withdrawal
    wv = (int(st.next_withdrawal_validator_index) + 1) % len(st.validators)
    st.validators[wv].withdrawal_credentials = (
        b"\x01" + b"\x00" * 11 + b"\x11" * 20
    )
    st.balances[wv] = int(st.balances[wv]) + 5_000_000_000
    state_cls = type(st)
    from ..state_transition.per_block import (
        _expected_withdrawals_list,
        process_withdrawals,
    )

    ns = h.ns
    wlist = _expected_withdrawals_list(h.spec, st)
    assert wlist, "capella withdrawals vector needs a non-empty sweep"
    payload = h._execution_payload(st, st.slot, "capella")
    payload.withdrawals = wlist
    payload_cls = type(payload)
    d = _case_dir(root, config, "capella", "operations", "withdrawals", 0)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "execution_payload.ssz", payload_cls.encode(payload))
    post = st.copy()
    process_withdrawals(h.spec, post, payload)
    _w(d, "post.ssz", state_cls.encode(post))
    bad = payload_cls.decode(payload_cls.encode(payload))
    bad.withdrawals = []
    d = _case_dir(root, config, "capella", "operations", "withdrawals", 1)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "execution_payload.ssz", payload_cls.encode(bad))
    _w(d, "meta.json", {"error": True})

    # bls_to_execution_change: interop credentials are 0x00||sha256(pk)[1:]
    from ..types.containers import BLSToExecutionChange, SignedBLSToExecutionChange

    st2 = h.state.copy()
    change = BLSToExecutionChange(
        validator_index=2,
        from_bls_pubkey=bytes(st2.validators[2].pubkey),
        to_execution_address=b"\x22" * 20,
    )
    domain = compute_domain(
        h.spec.DOMAIN_BLS_TO_EXECUTION_CHANGE,
        h.spec.genesis_fork_version,
        bytes(st2.genesis_validators_root),
    )
    signed = SignedBLSToExecutionChange(
        message=change,
        signature=h._sign(2, compute_signing_root(change, domain)),
    )
    d = _case_dir(root, config, "capella", "operations", "bls_to_execution_change", 0)
    _w(d, "pre.ssz", state_cls.encode(st2))
    _w(d, "address_change.ssz", SignedBLSToExecutionChange.encode(signed))
    post = st2.copy()
    from ..state_transition.per_block import process_bls_to_execution_change

    process_bls_to_execution_change(h.spec, post, signed, verify=True)
    _w(d, "post.ssz", state_cls.encode(post))
    badsig = SignedBLSToExecutionChange(
        message=change, signature=h._sign(3, b"\x00" * 32)
    )
    d = _case_dir(root, config, "capella", "operations", "bls_to_execution_change", 1)
    _w(d, "pre.ssz", state_cls.encode(st2))
    _w(d, "address_change.ssz", SignedBLSToExecutionChange.encode(badsig))
    _w(d, "meta.json", {"error": True})

    # --- electra: EL-triggered requests + committee-bits attestation
    h = _harness("electra")
    h.extend_chain(3)
    spec = h.spec
    ns = h.ns
    st = h.state.copy()
    state_cls = type(st)
    from ..state_transition.electra import (
        process_consolidation_request,
        process_deposit_request,
        process_withdrawal_request,
    )

    # deposit_request: appends to pending_deposits (EIP-6110; no failure path)
    dreq = ns.DepositRequest(
        pubkey=bytes(st.validators[0].pubkey),
        withdrawal_credentials=b"\x01" + b"\x00" * 11 + b"\x33" * 20,
        amount=32_000_000_000,
        signature=b"\x0a" * 96,
        index=7,
    )
    d = _case_dir(root, config, "electra", "operations", "deposit_request", 0)
    _w(d, "pre.ssz", state_cls.encode(st))
    _w(d, "deposit_request.ssz", ns.DepositRequest.encode(dreq))
    post = st.copy()
    process_deposit_request(spec, post, dreq)
    _w(d, "post.ssz", state_cls.encode(post))

    # withdrawal_request full-exit: validator 4 owns an execution credential.
    # Invalid requests are spec'd as NO-OPS (post == pre), not errors. Exit
    # requests require shard_committee_period epochs of activity first.
    addr = b"\x44" * 20
    st_w = st.copy()
    process_slots(
        spec,
        st_w,
        (spec.shard_committee_period + 1) * spec.preset.SLOTS_PER_EPOCH,
    )
    st_w.validators[4].withdrawal_credentials = b"\x01" + b"\x00" * 11 + addr
    wreq = ns.WithdrawalRequest(
        source_address=addr,
        validator_pubkey=bytes(st_w.validators[4].pubkey),
        amount=0,  # FULL_EXIT_REQUEST_AMOUNT
    )
    d = _case_dir(root, config, "electra", "operations", "withdrawal_request", 0)
    _w(d, "pre.ssz", state_cls.encode(st_w))
    _w(d, "withdrawal_request.ssz", ns.WithdrawalRequest.encode(wreq))
    post = st_w.copy()
    process_withdrawal_request(spec, post, wreq)
    assert post.tree_root() != st_w.tree_root(), "exit request must take effect"
    _w(d, "post.ssz", state_cls.encode(post))
    wrong = ns.WithdrawalRequest(
        source_address=b"\x55" * 20,
        validator_pubkey=bytes(st_w.validators[4].pubkey),
        amount=0,
    )
    d = _case_dir(root, config, "electra", "operations", "withdrawal_request", 1)
    _w(d, "pre.ssz", state_cls.encode(st_w))
    _w(d, "withdrawal_request.ssz", ns.WithdrawalRequest.encode(wrong))
    _w(d, "post.ssz", state_cls.encode(st_w))  # no-op: post == pre

    # consolidation_request self-switch to compounding (0x01 -> 0x02)
    st_c = st.copy()
    st_c.validators[5].withdrawal_credentials = b"\x01" + b"\x00" * 11 + addr
    creq = ns.ConsolidationRequest(
        source_address=addr,
        source_pubkey=bytes(st_c.validators[5].pubkey),
        target_pubkey=bytes(st_c.validators[5].pubkey),
    )
    d = _case_dir(root, config, "electra", "operations", "consolidation_request", 0)
    _w(d, "pre.ssz", state_cls.encode(st_c))
    _w(d, "consolidation_request.ssz", ns.ConsolidationRequest.encode(creq))
    post = st_c.copy()
    process_consolidation_request(spec, post, creq)
    assert post.tree_root() != st_c.tree_root(), "switch must take effect"
    _w(d, "post.ssz", state_cls.encode(post))

    # electra attestation (committee_bits + index=0 wire shape, EIP-7549)
    prev = h.state
    att = h.attestations_for_slot(prev, prev.slot, h.head_root(prev))[0]
    pre = prev.copy()
    process_slots(spec, pre, prev.slot + spec.min_attestation_inclusion_delay)
    d = _case_dir(root, config, "electra", "operations", "attestation", 0)
    _w(d, "pre.ssz", state_cls.encode(pre))
    _w(d, "attestation.ssz", type(att).encode(att))
    post = pre.copy()
    from .handler import _op_attestation

    _op_attestation(spec, post, att)
    _w(d, "post.ssz", state_cls.encode(post))
    badatt = type(att).decode(type(att).encode(att))
    badatt.data.index = 3  # electra: non-zero data.index is invalid
    d = _case_dir(root, config, "electra", "operations", "attestation", 1)
    _w(d, "pre.ssz", state_cls.encode(pre))
    _w(d, "attestation.ssz", type(att).encode(badatt))
    _w(d, "meta.json", {"error": True})


def gen_transition(root: str, config: str = "minimal") -> None:
    """Fork-boundary vectors: start one epoch before the fork, run blocks
    across it (cases/transition.rs). pre decodes as the old fork's state,
    post as the new fork's; blocks switch class at the boundary slot."""
    from ..testing.harness import StateHarness
    from ..types.spec import minimal_spec

    for i in range(1, len(FORKS)):
        pre_fork, post_fork = FORKS[i - 1], FORKS[i]
        overrides = fork_overrides(pre_fork)
        overrides[f"{post_fork}_fork_epoch"] = 1
        spec = minimal_spec(**overrides)
        h = StateHarness(spec, 32)
        spe = spec.preset.SLOTS_PER_EPOCH
        h.extend_chain(2)
        pre = h.state.copy()
        blocks = []
        # cross the boundary: blocks up to one slot past the fork epoch start
        while h.state.slot < spe + 1:
            slot = h.state.slot + 1
            prev = h.state
            atts = []
            if prev.slot + spec.min_attestation_inclusion_delay <= slot:
                atts = h.attestations_for_slot(prev, prev.slot, h.head_root(prev))
            block = h.produce_block(slot, attestations=atts)
            h.apply_block(block)
            blocks.append(block)
        d = _case_dir(root, config, post_fork, "transition", "core", 0)
        _w(
            d,
            "meta.json",
            {"pre_fork": pre_fork, "post_fork": post_fork, "fork_epoch": 1},
        )
        _w(d, "pre.ssz", type(pre).encode(pre))
        for j, b in enumerate(blocks):
            _w(d, f"blocks_{j}.ssz", type(b).encode(b))
        _w(d, "post.ssz", type(h.state).encode(h.state))


# deterministic insecure trusted-setup geometry shared with the handler
KZG_SETUP_N = 8
KZG_SETUP_G2 = 4
KZG_CELLS = 8


def _kzg_pair():
    from ..kzg import Kzg
    from ..kzg.setup import insecure_setup

    kzg = Kzg(insecure_setup(KZG_SETUP_N, n_g2=KZG_SETUP_G2))
    return kzg


def _blob(kzg, seed: int) -> bytes:
    from ..oracle.fields import R

    rng = np.random.default_rng(seed)
    out = b""
    for _ in range(kzg.n):
        out += (int.from_bytes(rng.bytes(31), "big") % R).to_bytes(32, "big")
    return out


def gen_kzg(root: str, config: str = "general") -> None:
    """KZG vectors (cases/kzg_*.rs families), deneb blob families + fulu cell
    families, generated from the host path and checked per backend by the
    handler. Geometry rides an insecure deterministic setup (meta.json)."""
    kzg = _kzg_pair()
    meta = {"setup_n": KZG_SETUP_N, "setup_n_g2": KZG_SETUP_G2}
    blobs = [_blob(kzg, s) for s in (1, 2, 3)]
    comms = [kzg.blob_to_kzg_commitment(b) for b in blobs]

    for i, (b, c) in enumerate(zip(blobs, comms)):
        d = _case_dir(root, config, "deneb", "kzg", "blob_to_kzg_commitment", i)
        _w(d, "data.json", {"input": {"blob": b.hex()}, "output": c.hex(), **meta})

    z = (7).to_bytes(32, "big")
    proof, y = kzg.compute_kzg_proof(blobs[0], z)
    d = _case_dir(root, config, "deneb", "kzg", "compute_kzg_proof", 0)
    _w(
        d,
        "data.json",
        {
            "input": {"blob": blobs[0].hex(), "z": z.hex()},
            "output": [proof.hex(), y.hex()],
            **meta,
        },
    )
    for i, (zv, yv, pv, ok) in enumerate(
        [
            (z, y, proof, True),
            (z, (int.from_bytes(y, "big") ^ 1).to_bytes(32, "big"), proof, False),
        ]
    ):
        d = _case_dir(root, config, "deneb", "kzg", "verify_kzg_proof", i)
        _w(
            d,
            "data.json",
            {
                "input": {
                    "commitment": comms[0].hex(),
                    "z": zv.hex(),
                    "y": yv.hex(),
                    "proof": pv.hex(),
                },
                "output": ok,
                **meta,
            },
        )

    bproofs = [
        kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, comms)
    ]
    d = _case_dir(root, config, "deneb", "kzg", "compute_blob_kzg_proof", 0)
    _w(
        d,
        "data.json",
        {
            "input": {"blob": blobs[0].hex(), "commitment": comms[0].hex()},
            "output": bproofs[0].hex(),
            **meta,
        },
    )
    for i, (b, c, p, ok) in enumerate(
        [
            (blobs[0], comms[0], bproofs[0], True),
            (blobs[0], comms[1], bproofs[0], False),
        ]
    ):
        d = _case_dir(root, config, "deneb", "kzg", "verify_blob_kzg_proof", i)
        _w(
            d,
            "data.json",
            {
                "input": {
                    "blob": b.hex(),
                    "commitment": c.hex(),
                    "proof": p.hex(),
                },
                "output": ok,
                **meta,
            },
        )
    for i, (bs, cs, ps, ok) in enumerate(
        [
            (blobs, comms, bproofs, True),
            (blobs, comms, [bproofs[1], bproofs[0], bproofs[2]], False),
        ]
    ):
        d = _case_dir(
            root, config, "deneb", "kzg", "verify_blob_kzg_proof_batch", i
        )
        _w(
            d,
            "data.json",
            {
                "input": {
                    "blobs": [b.hex() for b in bs],
                    "commitments": [c.hex() for c in cs],
                    "proofs": [p.hex() for p in ps],
                },
                "output": ok,
                **meta,
            },
        )

    # fulu cell families on the same setup
    from ..kzg.cells import CellContext

    ctx = CellContext(kzg, cells_per_ext_blob=KZG_CELLS)
    meta_c = {**meta, "cells_per_ext_blob": KZG_CELLS}
    cells, cproofs = ctx.compute_cells_and_kzg_proofs(blobs[0])
    d = _case_dir(
        root, config, "fulu", "kzg_cells", "compute_cells_and_kzg_proofs", 0
    )
    _w(
        d,
        "data.json",
        {
            "input": {"blob": blobs[0].hex()},
            "output": [
                [c.hex() for c in cells],
                [p.hex() for p in cproofs],
            ],
            **meta_c,
        },
    )
    half = list(range(0, ctx.cells, 2))
    d = _case_dir(
        root, config, "fulu", "kzg_cells", "recover_cells_and_kzg_proofs", 0
    )
    _w(
        d,
        "data.json",
        {
            "input": {
                "cell_indices": half,
                "cells": [cells[j].hex() for j in half],
            },
            "output": [
                [c.hex() for c in cells],
                [p.hex() for p in cproofs],
            ],
            **meta_c,
        },
    )
    tampered = bytearray(cells[1])
    tampered[0] ^= 1
    for i, (idxs, cs, ps, ok) in enumerate(
        [
            (
                list(range(ctx.cells)),
                [c.hex() for c in cells],
                [p.hex() for p in cproofs],
                True,
            ),
            (
                [0, 1],
                [cells[0].hex(), bytes(tampered).hex()],
                [cproofs[0].hex(), cproofs[1].hex()],
                False,
            ),
        ]
    ):
        d = _case_dir(
            root, config, "fulu", "kzg_cells", "verify_cell_kzg_proof_batch", i
        )
        _w(
            d,
            "data.json",
            {
                "input": {
                    "commitment": comms[0].hex(),
                    "cell_indices": idxs,
                    "cells": cs,
                    "proofs": ps,
                },
                "output": ok,
                **meta_c,
            },
        )


GENERATORS = {
    "bls": gen_bls,
    "shuffling": gen_shuffling,
    "ssz_static": gen_ssz_static,
    "operations": gen_operations,
    "operations_merge": gen_operations_merge,
    "rewards": gen_rewards,
    "finality": gen_finality,
    "epoch_processing": gen_epoch_processing,
    "sanity_blocks": gen_sanity_blocks,
    "transition": gen_transition,
    "kzg": gen_kzg,
}


def generate(root: str, families=None) -> int:
    """Write ``families`` (default: all, in the reference's order) under
    ``root``; returns the number of files under it. Refuses the repo's own
    vector tree and a ``root`` that already holds files."""
    from .. import bls, epoch_engine
    from .handler import default_vector_root

    if os.path.realpath(root) == os.path.realpath(default_vector_root()):
        raise ValueError("generate never rewrites the checked-in vector tree")
    if os.path.isdir(root) and any(files for _, _, files in os.walk(root)):
        raise ValueError(f"{root} already holds files")
    prev = (bls.get_backend(), bls.get_device(),
            epoch_engine.get_backend(), epoch_engine.get_device())
    bls.set_backend("native")
    epoch_engine.set_backend("numpy")
    try:
        for name in families or GENERATORS:
            GENERATORS[name](root)
    finally:
        bls.set_backend(prev[0], device=prev[1])
        epoch_engine.set_backend(prev[2], device=prev[3])
    return sum(len(fs) for _, _, fs in os.walk(root))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m lighthouse_tpu_torch.conformance.generate "
              "OUT_DIR [FAMILY ...]", file=sys.stderr)
        return 2
    n = generate(argv[0], argv[1:] or None)
    print(f"wrote {n} vector files under {argv[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
