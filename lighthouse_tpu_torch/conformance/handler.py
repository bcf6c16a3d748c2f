"""Conformance runner: walk the vector tree, run every case, consume every file.

The port's copy of ``lighthouse_tpu/conformance/handler.py``: Lighthouse's
``testing/ef_tests/src/handler.rs:13-99`` (Handler walks fork/handler/suite
dirs, one Case impl per family) combined with the
``check_all_files_accessed.py`` discipline (``Makefile:126-131``): ``run_all``
records every file each case reads and fails if ANY file under the vector
root was not consumed.

Unlike the reference, ``run_all`` takes the device explicitly and reads no
environment variable: for the run it puts the ``bls``, epoch and KZG
backends on ``"device"`` at that device (restoring them afterwards), so the
state families' bulk verifies, every epoch boundary and the KZG families'
MSMs and cell batches run on it, and the BLS matrix runs each case on the
``oracle``, ``native`` and ``device`` backends.
"""

from __future__ import annotations

import json
import os

import numpy as np


class ConformanceError(AssertionError):
    pass


class CaseContext:
    """Tracks file consumption for one case directory."""

    def __init__(self, path: str, tracker: set):
        self.path = path
        self._tracker = tracker

    def read(self, name: str) -> bytes:
        p = os.path.join(self.path, name)
        with open(p, "rb") as f:
            data = f.read()
        self._tracker.add(os.path.abspath(p))
        return data

    def json(self, name: str):
        return json.loads(self.read(name).decode())

    def has(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, name))


# ---------------------------------------------------------------------------
# Case implementations, keyed by runner name (directory level under the fork)
# ---------------------------------------------------------------------------


def _ns_and_spec(config: str, fork: str):
    from ..types.containers import for_preset
    from ..types.spec import mainnet_spec, minimal_spec

    from .generate import fork_overrides

    mk = minimal_spec if config == "minimal" else mainnet_spec
    # vectors for a fork are generated with that fork active from genesis
    spec = mk(**fork_overrides(fork))
    return for_preset(spec.preset.name), spec


def _ssz_type(ns, fork: str, name: str):
    """Resolve a container class by its spec name for the given fork."""
    per_fork = {
        "BeaconState": ns.state_types,
        "SignedBeaconBlock": ns.block_types,
        "Attestation": ns.attestation_types,
        "IndexedAttestation": ns.indexed_attestation_types,
        "AttesterSlashing": ns.attester_slashing_types,
    }
    if name in per_fork:
        return per_fork[name][fork]
    fixed = {
        "AggregateAndProof": ns.AggregateAndProof,
        "SignedAggregateAndProof": ns.SignedAggregateAndProof,
        "SyncAggregate": ns.SyncAggregate,
        "SyncCommittee": ns.SyncCommittee,
        "ExecutionPayload": ns.payload_types.get(fork),
        "DepositRequest": getattr(ns, "DepositRequest", None),
        "WithdrawalRequest": getattr(ns, "WithdrawalRequest", None),
        "ConsolidationRequest": getattr(ns, "ConsolidationRequest", None),
    }
    if fixed.get(name) is not None:
        return fixed[name]
    from ..types import containers as c

    return getattr(c, name)


def case_ssz_static(ctx: CaseContext, config: str, fork: str, handler: str):
    """serialized.ssz must decode, re-encode byte-identical, and tree-root to
    root.json (ssz_static family, testing/ef_tests/src/cases/ssz_static.rs)."""
    ns, _ = _ns_and_spec(config, fork)
    cls = _ssz_type(ns, fork, handler)
    data = ctx.read("serialized.ssz")
    expected = ctx.json("root.json")
    value = cls.decode(data)
    if cls.encode(value) != data:
        raise ConformanceError(f"{ctx.path}: ssz round-trip mismatch")
    root = value.tree_root() if hasattr(value, "tree_root") else cls.hash_tree_root(value)
    if root.hex() != expected["root"]:
        raise ConformanceError(
            f"{ctx.path}: root {root.hex()} != {expected['root']}"
        )


def case_shuffling(ctx: CaseContext, config: str, fork: str, handler: str):
    """Full-list mapping + per-index agreement (cases/shuffling.rs)."""
    from ..ops.shuffle import compute_shuffled_index, shuffle_list
    from ..types.spec import mainnet_spec, minimal_spec

    spec = minimal_spec() if config == "minimal" else mainnet_spec()
    data = ctx.json("mapping.json")
    seed = bytes.fromhex(data["seed"])
    count = data["count"]
    expected = data["mapping"]
    rounds = spec.preset.SHUFFLE_ROUND_COUNT
    got = np.asarray(
        shuffle_list(np.arange(count, dtype=np.uint64), seed, rounds)
    ).tolist()
    if got != expected:
        raise ConformanceError(f"{ctx.path}: shuffle_list mismatch")
    for i in range(count):
        j = compute_shuffled_index(i, count, seed, rounds)
        if expected[j] != i:
            raise ConformanceError(
                f"{ctx.path}: compute_shuffled_index({i}) inconsistent"
            )


BLS_BACKENDS = ("oracle", "native", "device")


def case_bls(ctx: CaseContext, config: str, fork: str, handler: str):
    """BLS families over the seam, run per backend (cases/bls_*.rs; Lighthouse
    runs its whole EF matrix once per crypto backend). ``"device"`` runs on
    the device ``run_all`` placed the bls backend on."""
    from .. import bls

    data = ctx.json("data.json")
    prev, dev = bls.get_backend(), bls.get_device()
    try:
        for backend in BLS_BACKENDS:
            bls.set_backend(backend, device=dev)
            _run_bls_case(handler, data, backend)
    finally:
        bls.set_backend(prev, device=dev)


def _run_bls_case(handler: str, data: dict, backend: str):
    from .. import bls

    def pk(h):
        return bls.PublicKey.from_bytes(bytes.fromhex(h))

    if handler == "sign":
        sk = bls.SecretKey.from_bytes(bytes.fromhex(data["input"]["privkey"]))
        sig = sk.sign(bytes.fromhex(data["input"]["message"]))
        if sig.serialize().hex() != data["output"]:
            raise ConformanceError(f"bls/sign [{backend}]: mismatch")
    elif handler == "verify":
        ok_expected = data["output"]
        try:
            p = pk(data["input"]["pubkey"])
            sig = bls.Signature.from_bytes(bytes.fromhex(data["input"]["signature"]))
            ok = sig.verify(p, bytes.fromhex(data["input"]["message"]))
        except bls.BlsError:
            ok = False
        if ok != ok_expected:
            raise ConformanceError(f"bls/verify [{backend}]: {ok} != {ok_expected}")
    elif handler == "aggregate":
        sigs = [
            bls.Signature.from_bytes(bytes.fromhex(h)) for h in data["input"]
        ]
        agg = bls.AggregateSignature.aggregate(sigs)
        if agg.serialize().hex() != data["output"]:
            raise ConformanceError(f"bls/aggregate [{backend}]: mismatch")
    elif handler == "fast_aggregate_verify":
        ok_expected = data["output"]
        try:
            pks = [pk(h) for h in data["input"]["pubkeys"]]
            agg = bls.AggregateSignature.from_bytes(
                bytes.fromhex(data["input"]["signature"])
            )
            ok = agg.fast_aggregate_verify(
                bytes.fromhex(data["input"]["message"]), pks
            )
        except bls.BlsError:
            ok = False
        if ok != ok_expected:
            raise ConformanceError(
                f"bls/fast_aggregate_verify [{backend}]: {ok} != {ok_expected}"
            )
    elif handler == "batch_verify":
        sets = []
        for s in data["input"]["sets"]:
            sets.append(
                bls.SignatureSet.multiple_pubkeys(
                    bls.Signature.from_bytes(bytes.fromhex(s["signature"])),
                    [pk(h) for h in s["pubkeys"]],
                    bytes.fromhex(s["message"]),
                )
            )
        ok = bls.verify_signature_sets(sets)
        if ok != data["output"]:
            raise ConformanceError(
                f"bls/batch_verify [{backend}]: {ok} != {data['output']}"
            )
    else:
        raise ConformanceError(f"unknown bls handler {handler}")


def _op_attestation(spec, state, op):
    from ..state_transition.per_block import ConsensusContext, process_attestation

    process_attestation(spec, state, op, 0, ConsensusContext(), verify=True)


def _op_exit(spec, state, op):
    from ..state_transition.per_block import process_exit

    process_exit(spec, state, op, verify=True)


def _op_proposer_slashing(spec, state, op):
    from ..state_transition.per_block import (
        ConsensusContext,
        process_proposer_slashing,
    )

    process_proposer_slashing(spec, state, op, ConsensusContext(), verify=True)


def _op_attester_slashing(spec, state, op):
    from ..state_transition.per_block import process_attester_slashing

    process_attester_slashing(spec, state, op, verify=True)


def _op_execution_payload(spec, state, op):
    from ..state_transition.per_block import process_execution_payload

    process_execution_payload(spec, state, op)


def _op_withdrawals(spec, state, op):
    from ..state_transition.per_block import process_withdrawals

    process_withdrawals(spec, state, op)


def _op_bls_change(spec, state, op):
    from ..state_transition.per_block import process_bls_to_execution_change

    process_bls_to_execution_change(spec, state, op, verify=True)


def _op_deposit_request(spec, state, op):
    from ..state_transition.electra import process_deposit_request

    process_deposit_request(spec, state, op)


def _op_withdrawal_request(spec, state, op):
    from ..state_transition.electra import process_withdrawal_request

    process_withdrawal_request(spec, state, op)


def _op_consolidation_request(spec, state, op):
    from ..state_transition.electra import process_consolidation_request

    process_consolidation_request(spec, state, op)


def case_operations(ctx: CaseContext, config: str, fork: str, handler: str):
    """pre.ssz + <op>.ssz -> post.ssz, or meta.json {"error": true}
    (cases/operations.rs shape). EL-request handlers (electra) treat invalid
    inputs as spec'd no-ops, so their "failure" vectors have post == pre."""
    from ..state_transition.per_block import BlockProcessingError

    ns, spec = _ns_and_spec(config, fork)
    state_cls = _ssz_type(ns, fork, "BeaconState")
    state = state_cls.decode(ctx.read("pre.ssz"))
    expect_error = ctx.has("meta.json") and ctx.json("meta.json").get("error")

    op_files = {
        "attestation": ("attestation.ssz", "Attestation", _op_attestation),
        "voluntary_exit": (
            "voluntary_exit.ssz", "SignedVoluntaryExit", _op_exit,
        ),
        "proposer_slashing": (
            "proposer_slashing.ssz", "ProposerSlashing", _op_proposer_slashing,
        ),
        "attester_slashing": (
            "attester_slashing.ssz", "AttesterSlashing", _op_attester_slashing,
        ),
        "execution_payload": (
            "execution_payload.ssz", "ExecutionPayload", _op_execution_payload,
        ),
        "withdrawals": (
            "execution_payload.ssz", "ExecutionPayload", _op_withdrawals,
        ),
        "bls_to_execution_change": (
            "address_change.ssz", "SignedBLSToExecutionChange", _op_bls_change,
        ),
        "deposit_request": (
            "deposit_request.ssz", "DepositRequest", _op_deposit_request,
        ),
        "withdrawal_request": (
            "withdrawal_request.ssz", "WithdrawalRequest",
            _op_withdrawal_request,
        ),
        "consolidation_request": (
            "consolidation_request.ssz", "ConsolidationRequest",
            _op_consolidation_request,
        ),
    }
    fname, cls_name, op_fn = op_files[handler]
    op_cls = _ssz_type(ns, fork, cls_name)
    op = op_cls.decode(ctx.read(fname))
    try:
        op_fn(spec, state, op)
        failed = False
    except BlockProcessingError:
        failed = True
    if expect_error:
        if not failed:
            raise ConformanceError(f"{ctx.path}: expected rejection, op applied")
        return
    if failed:
        raise ConformanceError(f"{ctx.path}: valid operation rejected")
    post = state_cls.decode(ctx.read("post.ssz"))
    if state.tree_root() != post.tree_root():
        raise ConformanceError(f"{ctx.path}: post-state root mismatch")


def _apply_rewards(spec, state):
    """The rewards sub-transition slice shared by the generator and the
    rewards runner: justification/finalization first (it feeds the
    finality-delay / leak terms), then (altair+) inactivity updates, then
    rewards/penalties — the head of ``_process_epoch_phase0`` /
    ``_process_epoch_altair``, in production order."""
    from ..state_transition import per_epoch as pe

    cols = pe._Cols(state)
    if getattr(state, "fork_name", "phase0") == "phase0":
        pe.process_justification_and_finalization_phase0(spec, state, cols)
        pe.process_rewards_and_penalties_phase0(spec, state, cols)
    else:
        pe.process_justification_and_finalization_altair(spec, state, cols)
        pe.process_inactivity_updates(spec, state, cols)
        pe.process_rewards_and_penalties_altair(spec, state, cols)


def case_rewards(ctx: CaseContext, config: str, fork: str, handler: str):
    """pre.ssz + deltas.json: the per-validator balance deltas the rewards
    stages must produce (cases/rewards.rs shape, fused across components).
    These pin the exact columnar-numpy outputs the device epoch kernels are
    parity-tested against — including the electra fork family."""
    ns, spec = _ns_and_spec(config, fork)
    state_cls = _ssz_type(ns, fork, "BeaconState")
    state = state_cls.decode(ctx.read("pre.ssz"))
    pre_bal = [int(b) for b in state.balances]
    _apply_rewards(spec, state)
    expected = ctx.json("deltas.json")["deltas"]
    got = [int(a) - b for a, b in zip(state.balances, pre_bal)]
    if got != expected:
        diffs = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
        raise ConformanceError(
            f"{ctx.path}: reward deltas mismatch at validators {diffs[:8]}"
        )


def case_finality(ctx: CaseContext, config: str, fork: str, handler: str):
    """pre.ssz + a multi-epoch block chain -> post.ssz, with meta.json
    pinning the justified/finalized checkpoints the full transition must
    reach (cases/finality.rs). The chain crosses epoch boundaries, so every
    epoch stage — device-kernel or columnar — is on the hook."""
    from ..state_transition import (
        BlockSignatureStrategy,
        per_block_processing,
        process_slots,
    )

    ns, spec = _ns_and_spec(config, fork)
    state_cls = _ssz_type(ns, fork, "BeaconState")
    block_cls = _ssz_type(ns, fork, "SignedBeaconBlock")
    meta = ctx.json("meta.json")
    state = state_cls.decode(ctx.read("pre.ssz"))
    i = 0
    while ctx.has(f"blocks_{i}.ssz"):
        sb = block_cls.decode(ctx.read(f"blocks_{i}.ssz"))
        if state.slot < sb.message.slot:
            process_slots(spec, state, sb.message.slot)
        per_block_processing(
            spec, state, sb, strategy=BlockSignatureStrategy.VERIFY_BULK
        )
        i += 1
    if int(state.finalized_checkpoint.epoch) != meta["finalized_epoch"]:
        raise ConformanceError(
            f"{ctx.path}: finalized epoch "
            f"{int(state.finalized_checkpoint.epoch)} != "
            f"{meta['finalized_epoch']}"
        )
    if int(state.current_justified_checkpoint.epoch) != meta["justified_epoch"]:
        raise ConformanceError(
            f"{ctx.path}: justified epoch "
            f"{int(state.current_justified_checkpoint.epoch)} != "
            f"{meta['justified_epoch']}"
        )
    post = state_cls.decode(ctx.read("post.ssz"))
    if state.tree_root() != post.tree_root():
        raise ConformanceError(f"{ctx.path}: finality post-state mismatch")


def case_epoch_processing(ctx: CaseContext, config: str, fork: str, handler: str):
    """pre.ssz -> process_epoch -> post.ssz (cases/epoch_processing.rs, fused
    single-pass instead of per-sub-transition)."""
    from ..state_transition import process_epoch

    ns, spec = _ns_and_spec(config, fork)
    state_cls = _ssz_type(ns, fork, "BeaconState")
    state = state_cls.decode(ctx.read("pre.ssz"))
    process_epoch(spec, state)
    post = state_cls.decode(ctx.read("post.ssz"))
    if state.tree_root() != post.tree_root():
        raise ConformanceError(f"{ctx.path}: epoch post-state mismatch")


def case_sanity_blocks(ctx: CaseContext, config: str, fork: str, handler: str):
    """pre.ssz + blocks_N.ssz... -> post.ssz with full signature verification
    (cases/sanity_blocks.rs)."""
    from ..state_transition import BlockSignatureStrategy, per_block_processing, process_slots

    ns, spec = _ns_and_spec(config, fork)
    state_cls = _ssz_type(ns, fork, "BeaconState")
    block_cls = _ssz_type(ns, fork, "SignedBeaconBlock")
    state = state_cls.decode(ctx.read("pre.ssz"))
    i = 0
    while ctx.has(f"blocks_{i}.ssz"):
        sb = block_cls.decode(ctx.read(f"blocks_{i}.ssz"))
        if state.slot < sb.message.slot:
            process_slots(spec, state, sb.message.slot)
        per_block_processing(
            spec, state, sb, strategy=BlockSignatureStrategy.VERIFY_BULK
        )
        i += 1
    post = state_cls.decode(ctx.read("post.ssz"))
    if state.tree_root() != post.tree_root():
        raise ConformanceError(f"{ctx.path}: sanity post-state mismatch")


def case_transition(ctx: CaseContext, config: str, fork: str, handler: str):
    """Cross-fork chain: pre decodes as the old fork's state, blocks switch
    class at the boundary, post decodes as the new fork's state
    (cases/transition.rs)."""
    from ..state_transition import (
        BlockSignatureStrategy,
        per_block_processing,
        process_slots,
    )
    from ..types.containers import for_preset
    from ..types.spec import mainnet_spec, minimal_spec

    from .generate import fork_overrides

    meta = ctx.json("meta.json")
    pre_fork, fork_epoch = meta["pre_fork"], meta["fork_epoch"]
    overrides = fork_overrides(pre_fork)
    overrides[f"{fork}_fork_epoch"] = fork_epoch
    mk = minimal_spec if config == "minimal" else mainnet_spec
    spec = mk(**overrides)
    ns = for_preset(spec.preset.name)
    state = ns.state_types[pre_fork].decode(ctx.read("pre.ssz"))
    i = 0
    while ctx.has(f"blocks_{i}.ssz"):
        raw = ctx.read(f"blocks_{i}.ssz")
        # the block's slot (bytes 100..108 of any SignedBeaconBlock: 4-byte
        # message offset + 96-byte signature, then the fixed slot field)
        slot = int.from_bytes(raw[100:108], "little")
        block_fork = spec.fork_name_at_epoch(spec.compute_epoch_at_slot(slot))
        sb = ns.block_types[block_fork].decode(raw)
        if state.slot < sb.message.slot:
            process_slots(spec, state, sb.message.slot)
        per_block_processing(
            spec, state, sb, strategy=BlockSignatureStrategy.VERIFY_BULK
        )
        i += 1
    post = ns.state_types[fork].decode(ctx.read("post.ssz"))
    if state.tree_root() != post.tree_root():
        raise ConformanceError(f"{ctx.path}: transition post-state mismatch")


def _kzg_from_meta(data: dict):
    from ..kzg import Kzg
    from ..kzg.setup import insecure_setup

    return Kzg(insecure_setup(data["setup_n"], n_g2=data["setup_n_g2"]))


def case_kzg(ctx: CaseContext, config: str, fork: str, handler: str):
    """Deneb blob families (cases/kzg_*.rs) on the vector's setup geometry."""
    from ..kzg import KzgError

    data = ctx.json("data.json")
    kzg = _kzg_from_meta(data)
    inp, expected = data["input"], data["output"]
    try:
        if handler == "blob_to_kzg_commitment":
            got = kzg.blob_to_kzg_commitment(bytes.fromhex(inp["blob"])).hex()
        elif handler == "compute_kzg_proof":
            proof, y = kzg.compute_kzg_proof(
                bytes.fromhex(inp["blob"]), bytes.fromhex(inp["z"])
            )
            got = [proof.hex(), y.hex()]
        elif handler == "verify_kzg_proof":
            got = kzg.verify_kzg_proof(
                bytes.fromhex(inp["commitment"]),
                bytes.fromhex(inp["z"]),
                bytes.fromhex(inp["y"]),
                bytes.fromhex(inp["proof"]),
            )
        elif handler == "compute_blob_kzg_proof":
            got = kzg.compute_blob_kzg_proof(
                bytes.fromhex(inp["blob"]), bytes.fromhex(inp["commitment"])
            ).hex()
        elif handler == "verify_blob_kzg_proof":
            got = kzg.verify_blob_kzg_proof(
                bytes.fromhex(inp["blob"]),
                bytes.fromhex(inp["commitment"]),
                bytes.fromhex(inp["proof"]),
            )
        elif handler == "verify_blob_kzg_proof_batch":
            got = kzg.verify_blob_kzg_proof_batch(
                [bytes.fromhex(b) for b in inp["blobs"]],
                [bytes.fromhex(c) for c in inp["commitments"]],
                [bytes.fromhex(p) for p in inp["proofs"]],
            )
        else:
            raise ConformanceError(f"unknown kzg handler {handler}")
    except KzgError:
        got = False
    if got != expected:
        raise ConformanceError(f"{ctx.path}: kzg/{handler} mismatch")


def case_kzg_cells(ctx: CaseContext, config: str, fork: str, handler: str):
    """Fulu/PeerDAS cell families on the vector's setup geometry."""
    from ..kzg import KzgError
    from ..kzg.cells import CellContext

    data = ctx.json("data.json")
    cc = CellContext(
        _kzg_from_meta(data), cells_per_ext_blob=data["cells_per_ext_blob"]
    )
    inp, expected = data["input"], data["output"]
    try:
        if handler == "compute_cells_and_kzg_proofs":
            cells, proofs = cc.compute_cells_and_kzg_proofs(
                bytes.fromhex(inp["blob"])
            )
            got = [[c.hex() for c in cells], [p.hex() for p in proofs]]
        elif handler == "recover_cells_and_kzg_proofs":
            cells, proofs = cc.recover_cells_and_kzg_proofs(
                inp["cell_indices"],
                [bytes.fromhex(c) for c in inp["cells"]],
            )
            got = [[c.hex() for c in cells], [p.hex() for p in proofs]]
        elif handler == "verify_cell_kzg_proof_batch":
            got = cc.verify_cell_kzg_proof_batch(
                [bytes.fromhex(inp["commitment"])] * len(inp["cell_indices"]),
                inp["cell_indices"],
                [bytes.fromhex(c) for c in inp["cells"]],
                [bytes.fromhex(p) for p in inp["proofs"]],
            )
        else:
            raise ConformanceError(f"unknown kzg_cells handler {handler}")
    except KzgError:
        got = False
    if got != expected:
        raise ConformanceError(f"{ctx.path}: kzg_cells/{handler} mismatch")


_RUNNERS = {
    "ssz_static": case_ssz_static,
    "shuffling": case_shuffling,
    "bls": case_bls,
    "operations": case_operations,
    "rewards": case_rewards,
    "finality": case_finality,
    "epoch_processing": case_epoch_processing,
    "sanity_blocks": case_sanity_blocks,
    "transition": case_transition,
    "kzg": case_kzg,
    "kzg_cells": case_kzg_cells,
}


# ---------------------------------------------------------------------------
# Walker
# ---------------------------------------------------------------------------


def default_vector_root() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "tests", "vectors")


def run_all(root: str | None = None, runners: list[str] | None = None, *,
            device, observer=None) -> int:
    """Run every case under root on ``device``; fail on any unconsumed file.
    Returns the number of cases run.

    ``device`` (required: ``"cuda"``, a ``torch.device``, or ``"cpu"`` for
    the kernels' plain versions) is where the ``bls``, epoch and KZG device
    backends run for the duration of the call. ``observer(event, fork,
    runner, n_cases)``, if given, is called with ``"start"`` and ``"end"``
    around each fork's runner directory (the chip script times families and
    reads kernel launches there)."""
    from .. import bls, epoch_engine
    from ..device import resolve_device
    from ..kzg import engine as kzg_engine

    dev = resolve_device(device)
    root = root or default_vector_root()
    if not os.path.isdir(root):
        raise ConformanceError(f"no vector tree at {root}")
    prev = (bls.get_backend(), bls.get_device(),
            epoch_engine.get_backend(), epoch_engine.get_device(),
            kzg_engine.get_kzg_backend(), kzg_engine.get_kzg_device())
    bls.set_backend("device", device=dev)
    epoch_engine.set_backend("device", device=dev)
    kzg_engine.set_kzg_backend("device", device=dev)
    try:
        return _walk(root, runners, observer)
    finally:
        bls.set_backend(prev[0], device=prev[1])
        epoch_engine.set_backend(prev[2], device=prev[3])
        kzg_engine.set_kzg_backend(prev[4], device=prev[5])


def _walk(root: str, runners, observer) -> int:
    consumed: set = set()
    n_cases = 0

    def _subdirs(path):
        # stray FILES at intermediate levels are left unconsumed on purpose:
        # the all-files-consumed check below reports them with a clean error
        return sorted(
            e for e in os.listdir(path) if os.path.isdir(os.path.join(path, e))
        )

    for config in _subdirs(root):
        for fork in _subdirs(os.path.join(root, config)):
            fork_dir = os.path.join(root, config, fork)
            for runner in _subdirs(fork_dir):
                if runners and runner not in runners:
                    raise ConformanceError(
                        f"runner {runner} present on disk but not requested — "
                        "all vectors must be consumed"
                    )
                fn = _RUNNERS.get(runner)
                if fn is None:
                    raise ConformanceError(f"no case impl for runner {runner!r}")
                runner_dir = os.path.join(fork_dir, runner)
                if observer is not None:
                    observer("start", fork, runner, n_cases)
                for handler in _subdirs(runner_dir):
                    handler_dir = os.path.join(runner_dir, handler)
                    for case in _subdirs(handler_dir):
                        ctx = CaseContext(
                            os.path.join(handler_dir, case), consumed
                        )
                        fn(ctx, config, fork, handler)
                        n_cases += 1
                if observer is not None:
                    observer("end", fork, runner, n_cases)
    # all-files-consumed check
    all_files = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            all_files.add(os.path.abspath(os.path.join(dirpath, f)))
    missed = all_files - consumed
    if missed:
        listing = "\n  ".join(sorted(missed)[:20])
        raise ConformanceError(
            f"{len(missed)} vector file(s) never consumed:\n  {listing}"
        )
    return n_cases
