"""Fused single-pass epoch sweeps over the validator axis, in PyTorch: the port
of ``lighthouse_tpu/epoch_engine/kernels.py``.

One sweep per fork family (phase0 / altair-like / electra) computes everything
``state_transition/per_epoch.py`` does per validator — justification balances,
inactivity scores, rewards and penalties, registry updates (eligibility,
ejections with exact exit-queue semantics, the churn-limited activation
queue), slashing penalties and hysteresis effective-balance updates — as
eager tensor code on one explicit ``torch.device``. The electra family adds
the EIP-7251 stages in the same idiom: balance-denominated exit churn as a
prefix sum, the pending-deposit queue as a masked cumulative sum against the
activation-exit budget with one ``index_add`` into balances, the pending-
consolidation queue as a short loop over the padded queue (its order is the
semantics), and a per-validator ``max_effective_balance`` plane. The
validator axis is padded to a shape bucket; padding rows are arithmetic
no-ops (inactive, zero-balance, far-future epochs).

Bit-exactness contract: every expression equals the numpy path's, so the
parity tests assert field-for-field identity and equal ``tree_root``.
Sequential spec constructs are vectorised in closed form, as in the
reference: the exit queue assigns the rank-th ejection epoch
``eq0 + (min(c0, churn) + rank) // churn``; the activation queue is a stable
sort of (eligibility epoch, index), since a stable sort of the key over
ascending indices is the reference's ``lexsort``.

Number format. The reference sweeps uint64 planes with numpy's wrap-around;
here every u64 column is int64:

* ``FAR_FUTURE_EPOCH`` (2^64 - 1) is held as ``FAR`` = 2^63 - 1: it still
  sorts last and compares above every real epoch. ``to_device`` maps it at
  upload and ``from_device`` back at write-back; any other value >= FAR
  is refused.
* Headroom: the reference proves ``n_pad * MAX_EFFECTIVE_BALANCE_ELECTRA *
  multiplier <= 2^64 - 1`` once per shape. Against 2^63 - 1 that static
  bound fails at n_pad = 2^21 (1.29e19 > 9.22e18), the bucket of today's
  ~1.1M-index mainnet registry. So ``sweep_headroom`` proves, before every
  sweep, from the registry's own values (total effective balance, the
  largest balance, score and deposit), that no sum or product the sweep
  forms reaches 2^63.
* The reference's wrapping sites (``rank = cumsum - 1`` before the first
  ejection, ``zero - amt`` in the consolidation step, ``available -
  processed`` when the churn was not reached) are either masked off or are
  a plain subtraction that cannot go below zero; int64 gives the same
  selected values.

Scalars (epochs, checkpoints, churn carries) are host ints: the decisions
that depend only on them (``do_just``, ``do_rp``) are taken on the host;
everything derived from the planes stays a device tensor until the engine
reads it after one synchronize.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FAR_FUTURE_EPOCH = 2**64 - 1
I64_MAX = 2**63 - 1
FAR = I64_MAX  # FAR_FUTURE_EPOCH on the device

# the registry columns that hold epochs (FAR_FUTURE_EPOCH possible)
EPOCH_COLUMNS = ("activation", "exit", "withdrawable", "eligibility")

# phase0 constant (per_epoch.BASE_REWARDS_PER_EPOCH)
BASE_REWARDS_PER_EPOCH = 4
# altair participation weights (per_block.PARTICIPATION_FLAG_WEIGHTS)
PARTICIPATION_FLAG_WEIGHTS = (14, 26, 14)
WEIGHT_DENOMINATOR = 64
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2


class EpochConsts(NamedTuple):
    """Spec snapshot the sweep reads (one per fork family and spec)."""

    family: str  # "phase0" | "altair" | "electra"
    effective_balance_increment: int
    max_effective_balance: int
    ejection_balance: int
    min_per_epoch_churn_limit: int
    churn_limit_quotient: int
    max_seed_lookahead: int
    min_validator_withdrawability_delay: int
    min_epochs_to_inactivity_penalty: int
    base_reward_factor: int
    proposer_reward_quotient: int
    epochs_per_slashings_vector: int
    proportional_slashing_multiplier: int
    # phase0 only
    inactivity_penalty_quotient: int
    # altair family only
    inactivity_score_bias: int
    inactivity_score_recovery_rate: int
    inactivity_penalty_quotient_altair: int
    # deneb+ caps the activation churn
    cap_activation_churn: bool
    max_per_epoch_activation_churn_limit: int
    # electra family (EIP-7251 balance-denominated churn + pending queues)
    min_activation_balance: int = 0
    max_effective_balance_electra: int = 0
    min_per_epoch_churn_limit_electra: int = 0
    max_per_epoch_activation_exit_churn_limit: int = 0
    max_pending_deposits_per_epoch: int = 0
    slots_per_epoch: int = 0


def consts_for(spec, fork: str) -> EpochConsts:
    from ..types.spec import fork_at_least, proportional_slashing_multiplier_for

    if fork == "phase0":
        family = "phase0"
    elif fork_at_least(fork, "electra"):
        family = "electra"
    else:
        family = "altair"
    return EpochConsts(
        family=family,
        effective_balance_increment=spec.effective_balance_increment,
        max_effective_balance=spec.max_effective_balance,
        ejection_balance=spec.ejection_balance,
        min_per_epoch_churn_limit=spec.min_per_epoch_churn_limit,
        churn_limit_quotient=spec.churn_limit_quotient,
        max_seed_lookahead=spec.max_seed_lookahead,
        min_validator_withdrawability_delay=spec.min_validator_withdrawability_delay,
        min_epochs_to_inactivity_penalty=spec.min_epochs_to_inactivity_penalty,
        base_reward_factor=spec.base_reward_factor,
        proposer_reward_quotient=spec.proposer_reward_quotient,
        epochs_per_slashings_vector=spec.preset.EPOCHS_PER_SLASHINGS_VECTOR,
        proportional_slashing_multiplier=proportional_slashing_multiplier_for(spec, fork),
        inactivity_penalty_quotient=spec.inactivity_penalty_quotient,
        inactivity_score_bias=spec.inactivity_score_bias,
        inactivity_score_recovery_rate=spec.inactivity_score_recovery_rate,
        inactivity_penalty_quotient_altair=spec.inactivity_penalty_quotient_altair,
        cap_activation_churn=fork_at_least(fork, "deneb"),
        max_per_epoch_activation_churn_limit=spec.max_per_epoch_activation_churn_limit,
        min_activation_balance=spec.min_activation_balance,
        max_effective_balance_electra=spec.max_effective_balance_electra,
        min_per_epoch_churn_limit_electra=spec.min_per_epoch_churn_limit_electra,
        max_per_epoch_activation_exit_churn_limit=(
            spec.max_per_epoch_activation_exit_churn_limit
        ),
        max_pending_deposits_per_epoch=spec.preset.MAX_PENDING_DEPOSITS_PER_EPOCH,
        slots_per_epoch=spec.preset.SLOTS_PER_EPOCH,
    )


def bucket(n: int) -> int:
    """Validator-axis shape bucket: power of two >= 256."""
    b = 256
    while b < n:
        b *= 2
    return b


def queue_bucket(n: int) -> int:
    """Pending-consolidation-queue shape bucket: power of two >= 8."""
    b = 8
    while b < n:
        b *= 2
    return b


# =============================================================================
# host <-> device columns
# =============================================================================


def to_device(arr: np.ndarray, device, epochs: bool = False) -> torch.Tensor:
    """A host column -> its device tensor: uint64 (and int32) as int64, bool
    and uint8 as they are. ``epochs`` maps FAR_FUTURE_EPOCH to FAR."""
    a = np.asarray(arr)
    if a.dtype == np.uint64:
        if epochs:
            far = a == np.uint64(FAR_FUTURE_EPOCH)
            if a.size and int(np.where(far, 0, a).max()) >= FAR:
                raise ValueError("an epoch >= 2^63 - 1 other than FAR_FUTURE_EPOCH")
            a = np.where(far, np.uint64(FAR), a)
        elif a.size and int(a.max()) > I64_MAX:
            raise ValueError("a u64 value >= 2^63 does not fit the sweep's int64")
        a = a.astype(np.int64)
    elif a.dtype == np.int32:
        a = a.astype(np.int64)
    elif a.dtype not in (np.bool_, np.uint8, np.int64):
        raise TypeError(f"unexpected column dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_device(t, epochs: bool = False) -> np.ndarray:
    """A device column (one tensor, or its row blocks in order) -> the
    host's uint64 (bool) array; ``epochs`` maps FAR back to
    FAR_FUTURE_EPOCH. Negative values cannot be u64 and raise."""
    # the write-back's read, once per column after the sweep's synchronize
    if isinstance(t, (list, tuple)):
        a = np.concatenate([x.detach().cpu().numpy() for x in t])  # lint: allow(host-sync)
    else:
        a = t.detach().cpu().numpy()  # lint: allow(host-sync)
    if a.dtype == np.bool_:
        return a
    if a.size and int(a.min()) < 0:
        raise ValueError("negative value in a u64 column")
    out = a.astype(np.uint64)
    if epochs:
        out[a == FAR] = np.uint64(FAR_FUTURE_EPOCH)
    return out


def _isqrt(t):
    """Exact integer sqrt of a 0-d int64 tensor (< 2^62). float64 seeds the
    root; two correction steps each way absorb its rounding."""
    s = torch.floor(torch.sqrt(t.to(torch.float64))).to(torch.int64)
    for _ in range(2):
        s = torch.where((s + 1) * (s + 1) <= t, s + 1, s)
    for _ in range(2):
        s = torch.where((s > 0) & (s * s > t), s - 1, s)
    return s


def sweep_headroom(C: EpochConsts, effective, active, balances, inactivity,
                   slash_sum: int, cur_ep: int, dep_amount=None, carry: int = 0) -> int:
    """An upper bound on every sum and product the sweep forms on these inputs
    (host numpy columns, padding included; ``carry`` the largest electra
    churn carry), for the int64 obligation ``epoch_churn_cumsum_headroom``
    (<= 2^63 - 1). Totals come from the registry, not the shape bucket."""
    inc = C.effective_balance_increment
    sum_eff = int(effective.sum(dtype=np.uint64))
    max_eff = int(effective.max(initial=0))
    total = max(inc, int(effective[active].sum(dtype=np.uint64)))
    root = int(np.sqrt(np.float64(total)))
    isqrt_low = max(root - 1, 1)
    slashing = slash_sum * max(C.proportional_slashing_multiplier, 1)
    incs = max(sum_eff // inc, 1)  # any flag or attesting balance, in increments
    if C.family == "phase0":
        base = max_eff * C.base_reward_factor // isqrt_low
        reward = base * incs
        leak = max_eff * max(cur_ep, 1)
    else:
        base = max_eff // inc * (inc * C.base_reward_factor // isqrt_low)
        reward = base * max(PARTICIPATION_FLAG_WEIGHTS) * incs
        leak = max_eff * (int(inactivity.max(initial=0)) + C.inactivity_score_bias)
    deposits = 0 if dep_amount is None else int(dep_amount.sum(dtype=np.uint64))
    return max(
        3 * sum_eff + carry + C.max_per_epoch_activation_exit_churn_limit,  # x3 tests, churn
        slashing,
        max_eff // inc * min(slashing, total),  # the slashing penalty's numerator
        reward,
        leak + BASE_REWARDS_PER_EPOCH * base,  # a validator's penalties
        int(balances.max(initial=0)) + 3 * reward + sum_eff + deposits,  # after credits
        (root + 2) ** 2,  # _isqrt's correction squares
    )


# =============================================================================
# sweep stages
# =============================================================================
#
# Each family's sweep is cut at its registry-wide reductions so that the
# sharded sweep (``sharded.py``) runs the same stages on row blocks: a
# block's ``_partials`` (masks + partial sums), the sum of every block's
# partials, ``_globals`` (the scalars the deltas read), then the
# per-validator stages. The queue stages (exit ranks, the activation queue,
# the phase0 proposer micro-rewards, electra's deposits and consolidations)
# take their cross-row inputs as arguments.


def _sum_where(mask, x):
    return torch.where(mask, x, 0).sum()


def _flag_mask(part, flag: int, active_mask, slashed):
    return active_mask & ((part & (1 << flag)) != 0) & ~slashed


# positions in the partials vector
P_TOTAL, P_PREV_TB, P_CUR_TB, P_FLAG0, P_ACTIVE, P_EJECT, P_EJECT_EFF, P_EXIT_MAX = (
    0, 1, 2, 3, 6, 7, 8, 9)


def _partials(C: EpochConsts, cols, cur_ep: int):
    """Masks of one row block (or the whole registry) and its partial
    reductions as one int64 vector: active, previous-target and
    current-target effective balance, the three flag (phase0: source,
    target, head) balances, the active and ejection counts, the ejected
    effective balance and the largest exit epoch short of FAR. Every entry
    but the last adds across blocks; the last takes the maximum."""
    eff, sl = cols["effective"], cols["slashed"]
    act, ext = cols["activation"], cols["exit"]
    prev_ep = max(cur_ep - 1, 0)
    active_cur = (act <= cur_ep) & (cur_ep < ext)
    active_prev = (act <= prev_ep) & (prev_ep < ext)
    if C.family == "phase0":
        flags = [cols["src_mask"], cols["tgt_mask"], cols["head_mask"]]
        prev_tgt, cur_tgt = cols["tgt_mask"], cols["cur_tgt_mask"]
    else:
        flags = [_flag_mask(cols["prev_part"], f, active_prev, sl) for f in range(3)]
        prev_tgt = flags[TIMELY_TARGET_FLAG_INDEX]
        cur_tgt = _flag_mask(cols["cur_part"], TIMELY_TARGET_FLAG_INDEX, active_cur, sl)
    eject = active_cur & (eff <= C.ejection_balance) & (ext == FAR)
    sums = torch.stack([
        _sum_where(active_cur, eff), _sum_where(prev_tgt, eff), _sum_where(cur_tgt, eff),
        *(_sum_where(m, eff) for m in flags),
        active_cur.sum(), eject.sum(), _sum_where(eject, eff),
        torch.where(ext != FAR, ext, 0).max(),
    ])
    masks = {"active_cur": active_cur, "active_prev": active_prev, "flags": flags,
             "prev_tgt": prev_tgt, "eject": eject}
    return masks, sums


def combine_partials(parts: list) -> torch.Tensor:
    """Row blocks' partials vectors (one device) -> the registry's."""
    p = torch.stack(parts)
    return torch.cat([p[:, :P_EXIT_MAX].sum(0), p[:, P_EXIT_MAX:].max(0).values])


def _globals(C: EpochConsts, red, scalars) -> dict:
    """The registry-wide scalars every per-validator stage reads: total and
    target balances, justification and finalization, the flag increments,
    and the registry counts."""
    inc = C.effective_balance_increment
    cur_ep = scalars["cur_epoch"]
    total = red[P_TOTAL].clamp(min=inc)
    do_just = cur_ep > 1
    new_bits, cj_prev, cj_cur, fin_sel, f_new = _justification(
        do_just, total, red[P_PREV_TB].clamp(min=inc), red[P_CUR_TB].clamp(min=inc),
        scalars["bits"], scalars["prev_justified_epoch"], scalars["cur_justified_epoch"],
        scalars["finalized_epoch"], cur_ep,
    )
    return {
        "total": total, "f_new": f_new, "bits": new_bits, "cj_prev": cj_prev, "cj_cur": cj_cur,
        "fin_sel": fin_sel, "do_just": do_just,
        "flag_inc": torch.stack([red[P_FLAG0 + f].clamp(min=inc) // inc for f in range(3)]),
        "n_active": red[P_ACTIVE], "n_eject": red[P_EJECT], "eject_eff": red[P_EJECT_EFF],
        "exit_max": red[P_EXIT_MAX],
    }


def _justification(do_just: bool, total, prev_tb, cur_tb, bits, prev_jcp_ep: int,
                   cur_jcp_ep: int, fin_ep: int, cur_ep: int):
    """New justification bits + checkpoint-update flags + finalized selector
    (0 none / 1 old-previous-justified / 2 old-current-justified)."""
    cond_prev = (prev_tb * 3 >= total * 2) & do_just
    cond_cur = (cur_tb * 3 >= total * 2) & do_just
    nb0 = cond_cur
    nb1 = cond_prev | bool(bits[0])
    nb2, nb3 = bool(bits[1]), bool(bits[2])
    r1 = nb1 & (nb2 and nb3 and prev_jcp_ep + 3 == cur_ep)
    r2 = nb1 & (nb2 and prev_jcp_ep + 2 == cur_ep)
    r3 = nb0 & nb1 & (nb2 and cur_jcp_ep + 2 == cur_ep)
    r4 = nb0 & nb1 & (cur_jcp_ep + 1 == cur_ep)
    fin_sel = torch.where((r3 | r4) & do_just, 2, torch.where((r1 | r2) & do_just, 1, 0))
    dev = total.device
    if do_just:
        new_bits = torch.stack([nb0, nb1, torch.tensor(nb2, device=dev),
                                torch.tensor(nb3, device=dev)])
    else:
        new_bits = torch.tensor([bool(b) for b in bits[:4]], device=dev)
    f_new = torch.where(
        fin_sel == 2, cur_jcp_ep, torch.where(fin_sel == 1, prev_jcp_ep, fin_ep)
    )
    return new_bits, cond_prev, cond_cur, fin_sel, f_new


# -- registry updates -------------------------------------------------------


def _churn_and_eq0(C: EpochConsts, cur_ep: int, g):
    """The churn limit and the exit queue's first epoch (before electra)."""
    churn = (g["n_active"] // C.churn_limit_quotient).clamp(min=C.min_per_epoch_churn_limit)
    eq0 = g["exit_max"].clamp(min=cur_ep + 1 + C.max_seed_lookahead)
    return churn, eq0


def _exit_queue(C: EpochConsts, eject, rank, eq0, c_eff, churn, exit_ep, withdrawable):
    """The exact initiate_validator_exit queue in closed form: the rank-th
    ejection (registry order) exits at ``eq0 + (c_eff + rank) // churn``."""
    assigned = eq0 + (c_eff + rank) // churn
    exit_new = torch.where(eject, assigned, exit_ep)
    wd_new = torch.where(eject, assigned + C.min_validator_withdrawability_delay, withdrawable)
    return exit_new, wd_new


def _eligibility(C: EpochConsts, cur_ep: int, effective, eligibility):
    if C.family == "electra":
        ready = effective >= C.min_activation_balance
    else:
        ready = effective == C.max_effective_balance
    return torch.where((eligibility == FAR) & ready, cur_ep + 1, eligibility)


def _activation_limit(C: EpochConsts, churn):
    return churn.clamp(max=C.max_per_epoch_activation_churn_limit) if C.cap_activation_churn \
        else churn


def activation_taken(key, cand, limit):
    """FIFO by (eligibility epoch, index) over the whole registry: a stable
    sort of ``key`` (eligibility where a candidate, else FAR) and the first
    ``limit`` candidates taken."""
    order = torch.sort(key, stable=True).indices
    pos = torch.arange(order.shape[0], device=order.device)
    return torch.zeros_like(cand).scatter_(0, order, (pos < limit) & cand[order])


def _registry_updates(C: EpochConsts, cur_ep: int, cols, m, g):
    """Eligibility flags, the vectorised exit queue and the churn-limited
    activation queue (process_registry_updates, before electra)."""
    eff, act, ext = cols["effective"], cols["activation"], cols["exit"]
    elig_new = _eligibility(C, cur_ep, eff, cols["eligibility"])
    churn, eq0 = _churn_and_eq0(C, cur_ep, g)
    c_eff = torch.minimum((ext == eq0).sum(), churn)
    rank = torch.cumsum(m["eject"], 0) - 1  # valid where eject
    exit_new, wd_new = _exit_queue(C, m["eject"], rank, eq0, c_eff, churn, ext,
                                   cols["withdrawable"])
    cand = (elig_new <= g["f_new"]) & (act == FAR)
    taken = activation_taken(torch.where(cand, elig_new, FAR), cand, _activation_limit(C, churn))
    act_new = torch.where(taken, cur_ep + 1 + C.max_seed_lookahead, act)
    return elig_new, exit_new, wd_new, act_new


def _slashings(C: EpochConsts, cur_ep: int, total, slash_sum: int, effective, slashed,
               withdrawable_snapshot, balances):
    inc = C.effective_balance_increment
    adjusted = total.clamp(max=slash_sum * C.proportional_slashing_multiplier)
    target_wd = cur_ep + C.epochs_per_slashings_vector // 2
    hit = slashed & (withdrawable_snapshot == target_wd)
    if C.family == "electra":
        # EIP-7251 overflow-safe form: per-increment penalty first
        penalty = effective // inc * (adjusted // (total // inc))
    else:
        penalty = effective // inc * adjusted // total * inc
    return torch.where(hit, balances - torch.minimum(penalty, balances), balances)


def _effective_updates(C: EpochConsts, balances, effective, max_eff=None):
    inc = C.effective_balance_increment
    down = inc // 4  # HYSTERESIS_DOWNWARD_MULTIPLIER = 1
    up = inc // 4 * 5  # HYSTERESIS_UPWARD_MULTIPLIER = 5
    need = (balances + down < effective) | (effective + up < balances)
    capped = balances - balances % inc
    if max_eff is None:
        capped = capped.clamp(max=C.max_effective_balance)
    else:
        capped = torch.minimum(capped, max_eff)
    return torch.where(need, capped, effective)


# -- the per-validator delta stages -----------------------------------------


def _altair_deltas(C: EpochConsts, cols, scalars, m, g):
    """Inactivity updates (reading the just-updated finalized epoch) and
    rewards/penalties of the altair family -> (balances, inactivity)."""
    effective, slashed = cols["effective"], cols["slashed"]
    balances, inact = cols["balances"], cols["inactivity"]
    cur_ep = scalars["cur_epoch"]
    inc = C.effective_balance_increment
    prev_ep = max(cur_ep - 1, 0)
    prev_tgt, total, f_new = m["prev_tgt"], g["total"], g["f_new"]
    do_rp = cur_ep > 0
    eligible = m["active_prev"] | (slashed & (prev_ep + 1 < cols["withdrawable"]))
    is_leak = (prev_ep - f_new) > C.min_epochs_to_inactivity_penalty
    s1 = torch.where(eligible & prev_tgt, inact - inact.clamp(max=1), inact)
    s1 = torch.where(eligible & ~prev_tgt, s1 + C.inactivity_score_bias, s1)
    s2 = torch.where(
        eligible & ~is_leak, s1 - s1.clamp(max=C.inactivity_score_recovery_rate), s1
    )
    inact_new = s2 if do_rp else inact

    total_increments = total // inc
    per_inc = inc * C.base_reward_factor // _isqrt(total)
    base = (effective // inc) * per_inc
    rewards = torch.zeros_like(balances)
    penalties = torch.zeros_like(balances)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        mask = m["flags"][flag_index]
        numer = base * (weight * g["flag_inc"][flag_index])
        denom = total_increments * WEIGHT_DENOMINATOR
        rewards = torch.where(eligible & mask & ~is_leak, rewards + numer // denom, rewards)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = torch.where(
                eligible & ~mask, penalties + base * weight // WEIGHT_DENOMINATOR, penalties
            )
    inact_denom = C.inactivity_score_bias * C.inactivity_penalty_quotient_altair
    penalties = torch.where(
        eligible & ~prev_tgt, penalties + effective * inact_new // inact_denom, penalties
    )
    bal = balances
    if do_rp:
        bal = balances + rewards
        bal = bal - torch.minimum(penalties, bal)
    return bal, inact_new


def _phase0_base(C: EpochConsts, cols, g):
    return cols["effective"] * C.base_reward_factor // _isqrt(g["total"]) // BASE_REWARDS_PER_EPOCH


def _phase0_proposer_rewards(C: EpochConsts, cols, base):
    """Each included attester's proposer micro-reward, to be added at its
    ``incl_proposer`` row (an index anywhere in the registry)."""
    ok = cols["has_incl"] & ~cols["slashed"]
    return torch.where(ok, base // C.proposer_reward_quotient, 0)


def _phase0_deltas(C: EpochConsts, cols, scalars, m, g, base, proposer):
    """Rewards and penalties before altair -> balances; ``proposer`` holds
    the proposer micro-rewards landing on each row."""
    effective, slashed, balances = cols["effective"], cols["slashed"], cols["balances"]
    cur_ep = scalars["cur_epoch"]
    prev_ep = max(cur_ep - 1, 0)
    do_rp = cur_ep > 0
    eligible = m["active_prev"] | (slashed & (prev_ep + 1 < cols["withdrawable"]))
    delay = prev_ep - g["f_new"]
    is_leak = delay > C.min_epochs_to_inactivity_penalty
    total_increments = g["total"] // C.effective_balance_increment
    rewards = torch.zeros_like(balances)
    penalties = torch.zeros_like(balances)
    for mask, increments in zip(m["flags"], g["flag_inc"]):
        rewards = torch.where(
            eligible & mask,
            rewards + torch.where(is_leak, base, base * increments // total_increments),
            rewards,
        )
        penalties = torch.where(eligible & ~mask, penalties + base, penalties)

    # proposer & inclusion-delay micro-rewards (earliest inclusion, host-
    # resolved into per-validator delay/proposer columns)
    ok = cols["has_incl"] & ~slashed
    proposer_reward = base // C.proposer_reward_quotient
    rewards = rewards + proposer
    safe_delay = torch.where(ok, cols["incl_delay"], 1)
    rewards = torch.where(ok, rewards + (base - proposer_reward) // safe_delay, rewards)

    # inactivity-leak penalties
    leak_pen = BASE_REWARDS_PER_EPOCH * base - base // C.proposer_reward_quotient
    penalties = torch.where(eligible & is_leak, penalties + leak_pen, penalties)
    penalties = torch.where(
        eligible & ~m["prev_tgt"] & is_leak,
        penalties + effective * delay // C.inactivity_penalty_quotient,
        penalties,
    )
    bal = balances
    if do_rp:
        bal = balances + rewards
        bal = bal - torch.minimum(penalties, bal)
    return bal


_FLAG_KEYS = ("bits", "cj_prev", "cj_cur", "fin_sel", "f_new", "do_just")


def _sweep_altair(C: EpochConsts, cols, scalars):
    cur_ep = scalars["cur_epoch"]
    m, red = _partials(C, cols, cur_ep)
    g = _globals(C, red, scalars)
    bal, inact_new = _altair_deltas(C, cols, scalars, m, g)
    elig_new, exit_new, wd_new, act_new = _registry_updates(C, cur_ep, cols, m, g)
    bal = _slashings(C, cur_ep, g["total"], scalars["slash_sum"], cols["effective"],
                     cols["slashed"], cols["withdrawable"], bal)
    return {
        "balances": bal,
        "inactivity": inact_new,
        "effective": _effective_updates(C, bal, cols["effective"]),
        "activation": act_new,
        "exit": exit_new,
        "withdrawable": wd_new,
        "eligibility": elig_new,
        **{k: g[k] for k in _FLAG_KEYS},
    }


def _sweep_phase0(C: EpochConsts, cols, scalars):
    cur_ep = scalars["cur_epoch"]
    m, red = _partials(C, cols, cur_ep)
    g = _globals(C, red, scalars)
    base = _phase0_base(C, cols, g)
    proposer = torch.zeros_like(cols["balances"]).index_add(
        0, cols["incl_proposer"], _phase0_proposer_rewards(C, cols, base))
    bal = _phase0_deltas(C, cols, scalars, m, g, base, proposer)
    elig_new, exit_new, wd_new, act_new = _registry_updates(C, cur_ep, cols, m, g)
    bal = _slashings(C, cur_ep, g["total"], scalars["slash_sum"], cols["effective"],
                     cols["slashed"], cols["withdrawable"], bal)
    return {
        "balances": bal,
        "effective": _effective_updates(C, bal, cols["effective"]),
        "activation": act_new,
        "exit": exit_new,
        "withdrawable": wd_new,
        "eligibility": elig_new,
        **{k: g[k] for k in _FLAG_KEYS},
    }


# =============================================================================
# electra family (EIP-7251 balance churn + pending deposit/consolidation queues)
# =============================================================================


def _balance_churn_limits(C: EpochConsts, total):
    """get_balance_churn_limit / get_activation_exit_churn_limit — the
    balance-denominated churn (EIP-7251), floored to the increment."""
    churn = (total // C.churn_limit_quotient).clamp(min=C.min_per_epoch_churn_limit_electra)
    churn = churn - churn % C.effective_balance_increment
    return churn, churn.clamp(max=C.max_per_epoch_activation_exit_churn_limit)


def _electra_exit_start(C: EpochConsts, cur_ep: int, scalars, churn_aexit):
    """``E0 = max(earliest_exit, cur+1+lookahead)`` and the epoch's starting
    exit budget ``btc0``."""
    e0 = max(scalars["earliest_exit_epoch"], cur_ep + 1 + C.max_seed_lookahead)
    btc0 = churn_aexit if scalars["earliest_exit_epoch"] < e0 else scalars["exit_balance_to_consume"]
    return e0, btc0


def _electra_exits(csum, e0: int, btc0, churn_aexit):
    """The exit epoch of the ejection whose inclusive balance cumsum (index
    order) is ``csum``: ``E0 + ceil((csum - btc0) / churn)``."""
    return e0 + torch.where(csum > btc0, (csum - btc0 - 1) // churn_aexit + 1, 0)


def _registry_updates_electra(C: EpochConsts, cur_ep: int, cols, m, g, csum, e0: int, btc0,
                              churn_aexit):
    """Electra process_registry_updates: MIN_ACTIVATION_BALANCE eligibility,
    balance-churned ejections in closed form (``csum`` the ejections'
    inclusive balance cumsum), and limit-free activations."""
    act = cols["activation"]
    elig_new = _eligibility(C, cur_ep, cols["effective"], cols["eligibility"])
    assigned = _electra_exits(csum, e0, btc0, churn_aexit)
    exit_new = torch.where(m["eject"], assigned, cols["exit"])
    wd_new = torch.where(m["eject"], assigned + C.min_validator_withdrawability_delay,
                         cols["withdrawable"])
    # activations: every finalized-eligible candidate activates (EIP-7251
    # throttles via the pending-deposit balance churn, not a queue limit)
    cand = (elig_new <= g["f_new"]) & (act == FAR)
    act_new = torch.where(cand, cur_ep + 1 + C.max_seed_lookahead, act)
    return elig_new, exit_new, wd_new, act_new


def _electra_exit_carries(g, e0: int, btc0, churn_aexit):
    """(has_ejection, earliest_exit, exit_btc) from the registry's total
    ejected balance (the last entry of the inclusive cumsum)."""
    earliest = _electra_exits(g["eject_eff"], e0, btc0, churn_aexit)
    return g["n_eject"] > 0, earliest, btc0 + (earliest - e0) * churn_aexit - g["eject_eff"]


def deposit_plan(C: EpochConsts, next_ep: int, f_new, exit_at, wd_at, dep_amount, dep_slot,
                 dep_index, dep_valid, dbtc_in: int, churn_aexit, bridge_wait: bool):
    """process_pending_deposits as a masked cumulative sum over the first
    MAX_PENDING_DEPOSITS_PER_EPOCH queue entries, given each known
    deposit's post-registry exit and withdrawable epochs (``exit_at``,
    ``wd_at``). The loop's three break conditions become stop positions
    (first gate failure, first churn overflow among budget-consuming
    entries, queue end); the realised stop is their minimum. Returns the
    amount each entry adds at its validator's row, the stop, the postponed
    and unknown-pubkey masks (for the host) and the carried budget."""
    maxq = dep_amount.shape[0]
    pos = torch.arange(maxq, device=dep_amount.device)
    gate_fail = dep_valid & (((dep_slot > 0) & bridge_wait)
                             | (dep_slot > f_new * C.slots_per_epoch))
    s_gate = torch.where(gate_fail, pos, maxq).min()
    known = dep_index >= 0
    withdrawn = dep_valid & known & (wd_at < next_ep)
    exited = dep_valid & known & ~withdrawn & (exit_at < FAR)
    consumes = dep_valid & ~withdrawn & ~exited  # the budget-charged branch
    csum = torch.cumsum(torch.where(consumes, dep_amount, 0), 0)
    available = churn_aexit + dbtc_in
    s_churn = torch.where(consumes & (csum > available), pos, maxq).min()
    s_other = torch.minimum(s_gate, dep_valid.sum())
    s = torch.minimum(s_churn, s_other)
    before = pos < s
    processed = _sum_where(consumes & before, dep_amount)
    add = torch.where(before & known & (withdrawn | consumes), dep_amount, 0)
    dbtc_out = torch.where(s_churn < s_other, available - processed, 0)
    return add, s, before & exited, before & dep_valid & ~known, dbtc_out


def consolidations(next_ep: int, slashed, effective, wd_new, balances, con_src, con_tgt,
                   con_valid):
    """process_pending_consolidations over the padded queue, in order (the
    reference's ``lax.scan``): duplicate sources and chains move running
    balances, so each step moves ``min(balance, effective)`` source ->
    target against the carried plane. Slashed sources are skipped but
    consumed; the first live source still inside its withdrawability delay
    stops the sweep. The planes may be the whole registry or any gathered
    subset the indices address."""
    bal = balances.clone()
    stopped = torch.zeros(1, dtype=torch.bool, device=bal.device)
    consumed = torch.zeros(1, dtype=torch.int64, device=bal.device)
    for k in range(con_src.shape[0]):
        src, tgt, valid = con_src[k:k + 1], con_tgt[k:k + 1], con_valid[k:k + 1]
        skip = slashed[src]
        stopped = stopped | (valid & ~skip & (wd_new[src] > next_ep))
        do = valid & ~stopped & ~skip
        amt = torch.where(do, torch.minimum(bal[src], effective[src]), 0)
        bal.index_add_(0, src, -amt)
        bal.index_add_(0, tgt, amt)
        consumed = consumed + (valid & ~stopped)
    return bal, consumed[0]


def electra_certs(C: EpochConsts, n_pad: int, dep_width: int) -> None:
    from ..ops.bls.fq import _cert

    assert _cert(
        "epoch_validator_index_domain", n_pad, 2**31 - 1,
        "validator-axis gather/scatter indices fit int32",
    )
    assert _cert(
        "epoch_deposit_plane_width", C.max_pending_deposits_per_epoch,
        dep_width, "deposit sweep never reads past the fixed queue plane",
    )


def _sweep_electra(C: EpochConsts, cols, scalars):
    effective = cols["effective"]
    cur_ep = scalars["cur_epoch"]
    electra_certs(C, effective.shape[0], cols["dep_amount"].shape[0])

    m, red = _partials(C, cols, cur_ep)
    g = _globals(C, red, scalars)
    bal, inact_new = _altair_deltas(C, cols, scalars, m, g)
    next_ep = cur_ep + 1
    _, churn_aexit = _balance_churn_limits(C, g["total"])
    e0, btc0 = _electra_exit_start(C, cur_ep, scalars, churn_aexit)
    csum = torch.cumsum(torch.where(m["eject"], effective, 0), 0)
    elig_new, exit_new, wd_new, act_new = _registry_updates_electra(
        C, cur_ep, cols, m, g, csum, e0, btc0, churn_aexit)
    bal = _slashings(C, cur_ep, g["total"], scalars["slash_sum"], effective, cols["slashed"],
                     cols["withdrawable"], bal)
    # deposit/consolidation classification reads the POST-registry exit and
    # withdrawable planes — the numpy twin's loops run after the updates
    gi = cols["dep_index"].clamp(0, effective.shape[0] - 1)
    add, dep_stop, dep_postponed, dep_host, dbtc_out = deposit_plan(
        C, next_ep, g["f_new"], exit_new[gi], wd_new[gi], cols["dep_amount"], cols["dep_slot"],
        cols["dep_index"], cols["dep_valid"], scalars["deposit_balance_to_consume"],
        churn_aexit,
        scalars["eth1_deposit_index"] < scalars["deposit_requests_start_index"],
    )
    bal = bal.index_add(0, gi, add)
    bal, cons_consumed = consolidations(
        next_ep, cols["slashed"], effective, wd_new, bal, cols["con_src"], cols["con_tgt"],
        cols["con_valid"],
    )
    has_ejection, earliest_out, exit_btc_out = _electra_exit_carries(g, e0, btc0, churn_aexit)
    return {
        "balances": bal,
        "inactivity": inact_new,
        "effective": _effective_updates(C, bal, effective, max_eff=max_effective(C, cols)),
        "activation": act_new,
        "exit": exit_new,
        "withdrawable": wd_new,
        "eligibility": elig_new,
        **{k: g[k] for k in _FLAG_KEYS},
        "dep_stop": dep_stop,
        "dep_postponed": dep_postponed,
        "dep_host": dep_host,
        "dep_btc": dbtc_out,
        "cons_consumed": cons_consumed,
        "has_ejection": has_ejection,
        "earliest_exit": earliest_out,
        "exit_btc": exit_btc_out,
    }


def max_effective(C: EpochConsts, cols):
    """The per-validator max_effective_balance plane (EIP-7251)."""
    return torch.where(
        cols["compounding"], C.max_effective_balance_electra, C.min_activation_balance
    )


_SWEEPS = {"phase0": _sweep_phase0, "altair": _sweep_altair, "electra": _sweep_electra}


def run_sweep(consts: EpochConsts, cols: dict, scalars: dict) -> dict:
    """One epoch sweep of ``consts.family`` over the device columns ``cols``
    (all on one device) and the host ``scalars``; returns device tensors
    (and host flags), not yet synchronised."""
    return _SWEEPS[consts.family](consts, cols, scalars)
