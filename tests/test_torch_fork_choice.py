"""The port's fork choice against the reference's.

``lighthouse_tpu_torch.fork_choice`` is the port's copy of
``lighthouse_tpu.fork_choice`` (proto-array LMD-GHOST and the spec wrapper).
Each scenario of ``tests/test_fork_choice.py`` runs on both packages: the
heads, every node's weight and best child, the pruned index and the
proposer heads must be equal, and equal to the values the reference's own
test expects. Host code only; exact equality.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu import fork_choice as r_fc
from lighthouse_tpu.types import spec as r_spec
from lighthouse_tpu_torch import fork_choice as p_fc
from lighthouse_tpu_torch.types import spec as p_spec

PACKAGES = {"reference": (r_fc, r_spec), "port": (p_fc, p_spec)}


def R(i):
    return bytes([i]) * 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _proto(fc):
    return fc.ProtoArrayForkChoice(
        finalized_root=R(0), finalized_slot=0, justified_epoch=0, finalized_epoch=0
    )


def _add(p, i, parent, slot=None, **kw):
    p.on_block(slot=i if slot is None else slot, root=R(i), parent_root=R(parent),
               state_root=b"\x00" * 32, target_root=R(0), justified_epoch=0,
               finalized_epoch=0, **kw)


def _nodes(p):
    """Every node's (root, parent, weight, best child, best descendant)."""
    return [(n.root, n.parent, int(n.weight), n.best_child, n.best_descendant)
            for n in p.nodes]


def _votes_fork(fc, _spec):
    p = _proto(fc)
    _add(p, 1, 0)
    _add(p, 2, 0)
    balances = np.full(3, 32, dtype=np.uint64)
    p.process_attestation(0, R(1), 1)
    p.process_attestation(1, R(2), 1)
    p.process_attestation(2, R(2), 1)
    heads = [p.find_head(0, R(0), 0, balances)]
    for v in range(3):
        p.process_attestation(v, R(1), 2)
    heads.append(p.find_head(0, R(0), 0, balances))
    return heads, _nodes(p)


def _tie(fc, _spec):
    p = _proto(fc)
    _add(p, 1, 0)
    _add(p, 2, 0)
    return [p.find_head(0, R(0), 0, np.zeros(0, np.uint64))], _nodes(p)


def _equivocation(fc, _spec):
    p = _proto(fc)
    _add(p, 1, 0)
    _add(p, 2, 0)
    balances = np.full(2, 32, dtype=np.uint64)
    p.process_attestation(0, R(1), 1)
    p.process_attestation(1, R(2), 1)
    heads = [p.find_head(0, R(0), 0, balances),
             p.find_head(0, R(0), 0, balances, equivocating_indices={1})]
    return heads, _nodes(p)


def _invalidation(fc, _spec):
    p = _proto(fc)
    _add(p, 1, 0, execution_status=fc.ExecutionStatus.OPTIMISTIC)
    _add(p, 2, 1, execution_status=fc.ExecutionStatus.OPTIMISTIC)
    _add(p, 3, 0, execution_status=fc.ExecutionStatus.VALID)
    balances = np.full(1, 32, dtype=np.uint64)
    p.process_attestation(0, R(2), 1)
    heads = [p.find_head(0, R(0), 0, balances)]
    p.process_execution_payload_invalidation(R(1))
    heads.append(p.find_head(0, R(0), 0, balances))
    statuses = [n.execution_status.name for n in p.nodes]
    return heads, _nodes(p) + statuses


def _boost(fc, _spec):
    p = _proto(fc)
    _add(p, 1, 0)
    _add(p, 2, 0)
    balances = np.array([10**9] + [42_333_333_333] * 3, dtype=np.uint64)
    p.process_attestation(0, R(1), 1)
    heads = [p.find_head(0, R(0), 0, balances)]
    heads.append(p.find_head(0, R(0), 0, balances, proposer_boost_root=R(2),
                             proposer_score_boost=40))
    nodes = _nodes(p)
    heads.append(p.find_head(0, R(0), 0, balances))
    return heads, nodes + _nodes(p)


def _prune(fc, _spec):
    p = _proto(fc)
    for i in range(1, 6):
        _add(p, i, i - 1)
    desc = [p.is_descendant(R(2), R(5)), p.is_descendant(R(5), R(2))]
    p.maybe_prune(R(3), prune_threshold=2)
    desc.append(p.is_descendant(R(3), R(5)))
    return desc, _nodes(p) + [sorted(p.indices.items())]


def _queued(fc, spec):
    f = fc.ForkChoice.from_anchor(spec.minimal_spec(), R(0), 0, (0, R(0)), (0, R(0)),
                                  np.full(4, 32, np.uint64))

    class Blk:
        slot = 1
        parent_root = R(0)
        state_root = b"\x00" * 32

    class St:
        class current_justified_checkpoint:
            epoch = 0
            root = R(0)

        class finalized_checkpoint:
            epoch = 0
            root = R(0)

    class IA:
        attesting_indices = [0, 1]

        class data:
            slot = 1
            beacon_block_root = R(1)

            class target:
                epoch = 0

    f.on_block(1, Blk, R(1), St)
    f.on_attestation(1, IA)
    queued = [len(f.queued_attestations)]
    heads = [f.get_head(2)]
    queued.append(len(f.queued_attestations))
    return heads + queued, _nodes(f.proto)


def _proposer_head(fc, spec):
    balances = np.full(64, 32 * 10**9, dtype=np.uint64)
    anchor = b"\x10" * 32
    f = fc.ForkChoice.from_anchor(spec.minimal_spec(), anchor, 0, (0, anchor), (0, anchor),
                                  balances)
    for root, slot, parent in ((b"\x11" * 32, 1, anchor), (b"\x12" * 32, 2, b"\x11" * 32)):
        f.proto.on_block(root=root, slot=slot, parent_root=parent, state_root=root,
                         target_root=parent, justified_epoch=0, finalized_epoch=0)
    heads = [f.get_proposer_head(3, b"\x12" * 32), f.get_proposer_head(4, b"\x12" * 32)]
    f.proto.nodes[f.proto.indices[b"\x12" * 32]].weight = int(balances.sum())
    heads.append(f.get_proposer_head(3, b"\x12" * 32))
    return heads, _nodes(f.proto)


def _vote_table(fc, spec):
    """Attestations through the wrapper (immediate and queued), with
    overlapping validators, older and newer target epochs, unknown roots and
    growing maximum indices: the vote table and the weights after get_head."""
    f = fc.ForkChoice.from_anchor(spec.minimal_spec(), R(0), 0, (0, R(0)), (0, R(0)),
                                  np.full(40, 32, np.uint64))

    class St:
        class current_justified_checkpoint:
            epoch = 0
            root = R(0)

        class finalized_checkpoint:
            epoch = 0
            root = R(0)

    for i, parent in ((1, 0), (2, 0), (3, 1)):
        blk = type("Blk", (), {"slot": i, "parent_root": R(parent), "state_root": b"\x00" * 32})
        f.on_block(i, blk, R(i), St)

    def att(indices, root, slot, epoch):
        data = type("D", (), {"slot": slot, "beacon_block_root": root,
                              "target": type("T", (), {"epoch": epoch})})
        return type("IA", (), {"attesting_indices": indices, "data": data})

    out = []
    for indices, root, slot, epoch, now in (([0, 5, 9], R(1), 1, 0, 2), ([3, 17, 30], R(3), 3, 0, 3),
                                            ([5, 9, 33], R(2), 2, 1, 3), ([0, 39], R(3), 3, 0, 4),
                                            ([12, 13], R(9), 3, 1, 4), ([], R(1), 1, 1, 4)):
        try:
            f.on_attestation(now, att(indices, root, slot, epoch))
        except Exception as e:  # noqa: BLE001 — the unknown root
            out.append(type(e).__name__)
        out.append(f.get_head(now))
    p = f.proto
    return out, [p._vote_cur.tolist(), p._vote_next.tolist(), p._vote_epoch.tolist(), _nodes(p)]


SCENARIOS = {
    # scenario -> the reference test's expected first output
    "votes_pick_heavier_fork": (_votes_fork, [R(2), R(1)]),
    "tie_breaks_by_root": (_tie, [R(2)]),
    "equivocating_validator_removed": (_equivocation, [R(2), R(1)]),
    "invalidation_propagates": (_invalidation, [R(2), R(3)]),
    "proposer_boost": (_boost, [R(1), R(2), R(1)]),
    "is_descendant_and_prune": (_prune, [True, False, True]),
    "queued_attestation_applies_next_slot": (_queued, [R(1), 1, 0]),
    "get_proposer_head": (_proposer_head, [b"\x11" * 32, b"\x12" * 32, b"\x12" * 32]),
    "vote_table": (_vote_table, None),  # no fixed expectation: the reference's trace
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    fn, expected = SCENARIOS[name]
    ref = fn(*PACKAGES["reference"])
    port = fn(*PACKAGES["port"])
    if expected is not None:
        assert ref[0] == expected
    assert port == ref


def test_prune_threshold_keeps_small_arrays():
    """Below the prune threshold nothing moves; past it the indices are
    rebased identically."""
    out = []
    for fc, _ in PACKAGES.values():
        p = _proto(fc)
        for i in range(1, 9):
            _add(p, i, i - 1)
        p.maybe_prune(R(4), prune_threshold=100)
        kept = len(p.nodes)
        p.maybe_prune(R(6), prune_threshold=1)
        out.append((kept, _nodes(p), sorted(p.indices.items())))
    assert out[0] == out[1]
    assert out[0][0] == 9
