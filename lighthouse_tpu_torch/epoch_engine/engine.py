"""Single-pass device epoch processing behind ``process_epoch``: the port of
``lighthouse_tpu/epoch_engine/engine.py``.

Orchestrates one epoch boundary on the device: sync the registry mirror
(delta scatter or first-bind gather), upload the flat per-epoch columns
(balances, inactivity, participation — or the phase0 attestation masks),
run the sweep (kernels.py), apply the scalar justification / finalization
decisions to the checkpoint objects, write back the changed registry rows,
and run the residual host-side stages (vote/slashings/randao resets,
historical accumulators, participation rotation, sync-committee rotation)
in exactly the numpy path's order.

Fork coverage: phase0, the altair family (altair/bellatrix/capella/deneb)
and electra, whose only residual host work is appending brand-new
validators for unknown-pubkey deposits (proof of possession included) and
rebuilding the pending queues from the sweep's stop positions.

``mesh_devices`` (the reference's ``sharding=``) splits the mirror into row
blocks over a device list and runs ``sharded.run_sweep_sharded``; None (or
one device) keeps the single-device sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls.mesh import mesh_devices as _mesh_of
from ..device import resolve_device
from .kernels import I64_MAX, consts_for, from_device, queue_bucket, run_sweep, sweep_headroom
from .mirror import RegistryMirror

_SUPPORTED_FORKS = (
    "phase0", "altair", "bellatrix", "capella", "deneb", "electra",
)

_MIRROR_ATTR = "_epoch_mirror"


def supported_fork(fork: str) -> bool:
    return fork in _SUPPORTED_FORKS


def mirror_of(state, create: bool = False, device=None, mesh=None) -> RegistryMirror | None:
    """The state's mirror; with ``create``, one on ``device`` or in row
    blocks over ``mesh`` (a mirror bound elsewhere is replaced)."""
    m = getattr(state, _MIRROR_ATTR, None)
    if create and (m is None or m.mesh != mesh or (mesh is None and m.device != device)):
        m = RegistryMirror(device, mesh)
        object.__setattr__(state, _MIRROR_ATTR, m)
    return m


def _placement(device, mesh_devices):
    """(device, mesh): the mesh's first device when a mesh is given."""
    mesh = _mesh_of(mesh_devices)
    return (resolve_device(device) if mesh is None else mesh[0]), mesh


def prepare_state(state, device=None, mesh_devices=None) -> RegistryMirror | None:
    """Bind a mirror + delta journal ahead of the first epoch boundary so
    block processing starts journaling immediately (state_advance warm-up
    hook). No-op for forks the sweep does not cover."""
    if not supported_fork(getattr(state, "fork_name", "phase0")):
        return None
    dev, mesh = _placement(device, mesh_devices)
    m = mirror_of(state, create=True, device=dev, mesh=mesh)
    m.sync(state)
    return m


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _device_sweep(spec, state, dev: torch.device, mesh=None):
    """The DEVICE region of one epoch boundary: mirror bind/sync, column
    upload, the int64 headroom proof, the sweep, and a synchronize. No
    ``state`` mutation happens in here, and a deferred CUDA fault surfaces
    at the synchronize, before any host-side write-back: a faulted boundary
    leaves the state byte-identical and the numpy path can take over."""
    from ..ops.bls.fq import _cert
    from ..state_transition.beacon_state_util import get_current_epoch

    fork = getattr(state, "fork_name", "phase0")
    mirror = mirror_of(state, create=True, device=dev, mesh=mesh)
    mirror.sync(state)

    consts = consts_for(spec, fork)
    cur_ep = get_current_epoch(spec, state)
    cols = dict(mirror.cols)
    balances = np.asarray(state.balances, dtype=np.uint64)
    cols["balances"] = mirror.pad_and_put(balances)
    inactivity = None
    if fork == "phase0":
        _phase0_host_columns(spec, state, mirror, cols)
    else:
        inactivity = np.asarray(state.inactivity_scores, dtype=np.uint64)
        cols["inactivity"] = mirror.pad_and_put(inactivity)
        cols["prev_part"] = mirror.pad_and_put(
            np.asarray(state.previous_epoch_participation, dtype=np.uint8)
        )
        cols["cur_part"] = mirror.pad_and_put(
            np.asarray(state.current_epoch_participation, dtype=np.uint8)
        )

    scalars = {
        "cur_epoch": int(cur_ep),
        "finalized_epoch": int(state.finalized_checkpoint.epoch),
        "prev_justified_epoch": int(state.previous_justified_checkpoint.epoch),
        "cur_justified_epoch": int(state.current_justified_checkpoint.epoch),
        "bits": [bool(b) for b in np.asarray(state.justification_bits, dtype=bool)],
        "slash_sum": int(np.asarray(state.slashings, dtype=np.uint64).sum()),
    }
    dep_amount, carry = None, 0
    if consts.family == "electra":
        dep_amount = _electra_queue_columns(state, mirror, consts, cols)
        for k in ("earliest_exit_epoch", "exit_balance_to_consume",
                  "deposit_balance_to_consume", "eth1_deposit_index",
                  "deposit_requests_start_index"):
            scalars[k] = int(getattr(state, k))
        carry = max(scalars["exit_balance_to_consume"],
                    scalars["deposit_balance_to_consume"])

    sh = mirror.shadow
    n = mirror.n
    active = (sh["activation"][:n] <= np.uint64(cur_ep)) & (
        np.uint64(cur_ep) < sh["exit"][:n])
    bound = sweep_headroom(
        consts, sh["effective"][:n], active, balances,
        inactivity if inactivity is not None else np.zeros(0, np.uint64),
        scalars["slash_sum"], cur_ep, dep_amount, carry,
    )
    assert _cert(
        "epoch_churn_cumsum_headroom", bound, I64_MAX,
        "every sum and product of this sweep fits int64 (per-sweep, from the registry)",
    )
    if mesh is None:
        outs = run_sweep(consts, cols, scalars)
    else:
        from .sharded import run_sweep_sharded

        outs = run_sweep_sharded(consts, cols, scalars, mesh)
    for d in {dev, *(mesh or ())}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return mirror, outs


def process_epoch_on_device(spec, state, device=None, mesh_devices=None) -> bool:
    """Run one epoch transition through the device engine on ``device``
    (default CUDA; raises without it — resolved before the supervised
    region, so a missing card is never taken for a fault), or in row blocks
    over ``mesh_devices`` (a device list; None or one entry: off). Returns False
    (state untouched) when the state's fork family has no sweep, when the
    ``epoch_device`` fault domain has the backend quarantined, or when the
    sweep faults — the numpy path then handles this boundary (the
    degradation ladder's device -> numpy demotion)."""
    dev, mesh = _placement(device, mesh_devices)
    fork = getattr(state, "fork_name", "phase0")
    if not supported_fork(fork):
        return False
    from ..resilience import SupervisedFault, epoch_supervisor

    sup = epoch_supervisor()
    if not sup.device_allowed():
        sup.note_fallback(rung="numpy")
        return False
    try:
        mirror, outs = sup.run("epoch.sweep", lambda: _device_sweep(spec, state, dev, mesh))
    except SupervisedFault:
        # device state is indeterminate: drop the mirror so a later attempt
        # re-binds from scratch, and let the numpy path own this boundary
        if getattr(state, _MIRROR_ATTR, None) is not None:
            object.__delattr__(state, _MIRROR_ATTR)
        sup.note_fallback(rung="numpy")
        return False

    _apply_justification(spec, state, outs)
    n = mirror.n
    state.balances = from_device(outs["balances"])[:n]
    mirror.stats.device_to_host_bytes += mirror.n_pad * 8
    if fork != "phase0":
        state.inactivity_scores = from_device(outs["inactivity"])[:n]
        mirror.stats.device_to_host_bytes += mirror.n_pad * 8
    mirror.apply_outputs(state, outs)

    from ..types.spec import fork_at_least

    if fork_at_least(fork, "electra"):
        _electra_host_finish(spec, state, mirror, outs)
    _host_tail(spec, state, fork)
    return True


# =============================================================================
# host-side stages
# =============================================================================


class _MaskCols:
    """The slice of ``per_epoch._Cols`` that ``_attesting_mask`` reads,
    served from the mirror's host shadows — no Python-object re-gather."""

    def __init__(self, mirror):
        self.n = mirror.n
        self.slashed = mirror.shadow["slashed"][: mirror.n]


def _phase0_host_columns(spec, state, mirror, cols) -> None:
    """Resolve phase0 pending attestations into per-validator columns: the
    unslashed source/target/head masks and the earliest-inclusion
    (delay, proposer) pair — the only stage that must walk attestations."""
    from ..state_transition.per_epoch import (
        _attesting_mask,
        _matching_attestations,
        _matching_head_attestations,
        _matching_target_attestations,
    )
    from ..state_transition.beacon_state_util import (
        get_attesting_indices,
        get_current_epoch,
    )

    hcols = _MaskCols(mirror)
    cur_ep = get_current_epoch(spec, state)
    n = hcols.n
    zeros = np.zeros(n, dtype=bool)
    prev_ep = max(cur_ep - 1, 0)
    cur_tgt = (
        _attesting_mask(
            spec, state,
            _matching_target_attestations(spec, state, cur_ep), hcols,
        )
        if cur_ep > 1
        else zeros
    )
    if cur_ep > 0:
        src_atts = _matching_attestations(spec, state, prev_ep)
        src = _attesting_mask(spec, state, src_atts, hcols)
        tgt = _attesting_mask(
            spec, state,
            _matching_target_attestations(spec, state, prev_ep), hcols,
        )
        head = _attesting_mask(
            spec, state,
            _matching_head_attestations(spec, state, prev_ep), hcols,
        )
    else:
        src_atts = []
        src = tgt = head = zeros
    earliest: dict[int, tuple[int, int]] = {}
    for a in src_atts:
        idx = get_attesting_indices(spec, state, a.data, a.aggregation_bits)
        for i in idx:
            i = int(i)
            cand = (int(a.inclusion_delay), int(a.proposer_index))
            if i not in earliest or cand[0] < earliest[i][0]:
                earliest[i] = cand
    incl_delay = np.ones(n, dtype=np.uint64)
    incl_proposer = np.zeros(n, dtype=np.int32)
    has_incl = np.zeros(n, dtype=bool)
    for i, (delay, proposer) in earliest.items():
        incl_delay[i] = delay
        incl_proposer[i] = proposer
        has_incl[i] = True
    cols["src_mask"] = mirror.pad_and_put(src, fill=False)
    cols["tgt_mask"] = mirror.pad_and_put(tgt, fill=False)
    cols["head_mask"] = mirror.pad_and_put(head, fill=False)
    cols["cur_tgt_mask"] = mirror.pad_and_put(cur_tgt, fill=False)
    cols["incl_delay"] = mirror.pad_and_put(incl_delay, fill=1)
    cols["incl_proposer"] = mirror.pad_and_put(incl_proposer, fill=0)
    cols["has_incl"] = mirror.pad_and_put(has_incl, fill=False)


class _MirrorPubkeyCtxt:
    """``lookup_pubkey_index`` context backed by the mirror's lazy pubkey
    map — the map auto-extends over registry appends, so a second pending
    deposit for a pubkey the previous one just added resolves to the new
    index exactly like the numpy twin's linear scan."""

    def __init__(self, mirror):
        self._mirror = mirror

    def lookup_pubkey_index(self, state, pubkey):
        return self._mirror.pubkey_map(state).get(bytes(pubkey))


def _electra_queue_columns(state, mirror, consts, cols) -> np.ndarray:
    """Upload the electra pending-queue columns; returns the deposit amounts.
    Only the first MAX_PENDING_DEPOSITS_PER_EPOCH deposits can ever be
    examined by the sweep (every loop iteration advances the capped position
    counter), so the deposit columns have one fixed shape whatever the queue
    depth. Pubkeys resolve host-side against the mirror's map; unknown
    pubkeys (-1) are flagged for host application."""
    maxq = consts.max_pending_deposits_per_epoch
    pending = list(state.pending_deposits)[:maxq]
    dep_amount = np.zeros(maxq, dtype=np.uint64)
    dep_slot = np.zeros(maxq, dtype=np.uint64)
    dep_index = np.full(maxq, -1, dtype=np.int32)
    dep_valid = np.zeros(maxq, dtype=bool)
    if pending:
        pkmap = mirror.pubkey_map(state)
        for i, d in enumerate(pending):
            dep_amount[i] = int(d.amount)
            dep_slot[i] = int(d.slot)
            dep_index[i] = pkmap.get(bytes(d.pubkey), -1)
            dep_valid[i] = True
    cols["dep_amount"] = mirror.put(dep_amount)
    cols["dep_slot"] = mirror.put(dep_slot)
    cols["dep_index"] = mirror.put(dep_index)
    cols["dep_valid"] = mirror.put(dep_valid)

    cons = list(state.pending_consolidations)
    qc = queue_bucket(len(cons))
    con_src = np.zeros(qc, dtype=np.int32)
    con_tgt = np.zeros(qc, dtype=np.int32)
    con_valid = np.zeros(qc, dtype=bool)
    for i, c in enumerate(cons):
        con_src[i] = int(c.source_index)
        con_tgt[i] = int(c.target_index)
        con_valid[i] = True
    cols["con_src"] = mirror.put(con_src)
    cols["con_tgt"] = mirror.put(con_tgt)
    cols["con_valid"] = mirror.put(con_valid)
    return dep_amount


def _electra_host_finish(spec, state, mirror, outs) -> None:
    """The residual host half of the electra stages, after the mirror
    write-back: apply unknown-pubkey deposits in queue order (registry
    appends + proof-of-possession checks), run the hysteresis update for
    rows appended after the kernel's effective-balance stage ran, rebuild
    the pending queues from the kernel's stop positions, and land the
    scalar churn carries."""
    from ..state_transition.electra import (
        apply_pending_deposit,
        get_max_effective_balance,
    )

    s = int(outs["dep_stop"])
    postponed = _host(outs["dep_postponed"])
    host_mask = _host(outs["dep_host"])
    pending = list(state.pending_deposits)
    n_pre = len(state.validators)
    ctxt = _MirrorPubkeyCtxt(mirror)
    for i in range(s):
        if host_mask[i]:
            apply_pending_deposit(spec, state, pending[i], ctxt)
    # hysteresis for appended validators (effective starts at 0; the numpy
    # twin's effective-balance loop runs after deposits and fixes them up)
    inc = spec.effective_balance_increment
    down = inc // 4
    up = inc // 4 * 5
    bal = np.asarray(state.balances, dtype=np.uint64)
    for i in range(n_pre, len(state.validators)):
        v = state.validators[i]
        b = int(bal[i])
        if b + down < int(v.effective_balance) or (
            int(v.effective_balance) + up < b
        ):
            v.effective_balance = min(
                b - b % inc, get_max_effective_balance(spec, v)
            )
    state.pending_deposits = pending[s:] + [
        pending[i] for i in range(s) if postponed[i]
    ]
    state.deposit_balance_to_consume = int(outs["dep_btc"])
    state.pending_consolidations = list(state.pending_consolidations)[
        int(outs["cons_consumed"]):
    ]
    if bool(outs["has_ejection"]):
        state.earliest_exit_epoch = int(outs["earliest_exit"])
        state.exit_balance_to_consume = int(outs["exit_btc"])


def _apply_justification(spec, state, outs) -> None:
    """Scalar checkpoint bookkeeping from the kernel's decision flags, in
    _weigh_justification_and_finalization's exact order."""
    if not bool(outs["do_just"]):
        return
    from ..state_transition.beacon_state_util import (
        get_block_root,
        get_current_epoch,
        get_previous_epoch,
    )
    from ..types.containers import Checkpoint

    prev_ep = get_previous_epoch(spec, state)
    cur_ep = get_current_epoch(spec, state)
    old_prev = state.previous_justified_checkpoint
    old_cur = state.current_justified_checkpoint
    state.previous_justified_checkpoint = state.current_justified_checkpoint
    if bool(outs["cj_prev"]):
        state.current_justified_checkpoint = Checkpoint(
            epoch=prev_ep, root=get_block_root(spec, state, prev_ep)
        )
    if bool(outs["cj_cur"]):
        state.current_justified_checkpoint = Checkpoint(
            epoch=cur_ep, root=get_block_root(spec, state, cur_ep)
        )
    state.justification_bits = _host(outs["bits"]).astype(bool)
    sel = int(outs["fin_sel"])
    if sel == 1:
        state.finalized_checkpoint = old_prev
    elif sel == 2:
        state.finalized_checkpoint = old_cur


def _host_tail(spec, state, fork: str) -> None:
    """The non-validator-axis epoch stages, in the numpy path's order."""
    from ..state_transition import per_epoch as pe

    pe.process_eth1_data_reset(spec, state)
    pe.process_slashings_reset(spec, state)
    pe.process_randao_mixes_reset(spec, state)
    pe.process_historical_roots_update(spec, state)
    if fork == "phase0":
        state.previous_epoch_attestations = list(
            state.current_epoch_attestations
        )
        state.current_epoch_attestations = []
    else:
        pe.process_participation_flag_updates(spec, state)
        pe.process_sync_committee_updates(spec, state)
