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


def from_device(t: torch.Tensor, epochs: bool = False) -> np.ndarray:
    """A device column -> the host's uint64 (bool) array; ``epochs`` maps FAR
    back to FAR_FUTURE_EPOCH. Negative values cannot be u64 and raise."""
    a = t.detach().cpu().numpy()
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


def _sum_where(mask, x):
    return torch.where(mask, x, 0).sum()


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


def _registry_updates(C: EpochConsts, cur_ep: int, f_new, effective, activation,
                      exit_ep, withdrawable, eligibility, active_cur):
    """Eligibility flags, the vectorised exit queue and the churn-limited
    activation queue (process_registry_updates, before electra)."""
    elig_new = torch.where(
        (eligibility == FAR) & (effective == C.max_effective_balance), cur_ep + 1, eligibility
    )
    churn = (active_cur.sum() // C.churn_limit_quotient).clamp(min=C.min_per_epoch_churn_limit)
    # -- ejections: exact initiate_validator_exit queue semantics ----------
    eject = active_cur & (effective <= C.ejection_balance) & (exit_ep == FAR)
    min_exit = cur_ep + 1 + C.max_seed_lookahead
    eq0 = torch.where(exit_ep != FAR, exit_ep, 0).max().clamp(min=min_exit)
    c_eff = torch.minimum((exit_ep == eq0).sum(), churn)
    rank = torch.cumsum(eject, 0) - 1  # valid where eject
    assigned = eq0 + (c_eff + rank) // churn
    exit_new = torch.where(eject, assigned, exit_ep)
    wd_new = torch.where(eject, assigned + C.min_validator_withdrawability_delay, withdrawable)
    # -- activation queue: FIFO by (eligibility epoch, index) --------------
    cand = (elig_new <= f_new) & (activation == FAR)
    limit = churn
    if C.cap_activation_churn:
        limit = limit.clamp(max=C.max_per_epoch_activation_churn_limit)
    order = torch.sort(torch.where(cand, elig_new, FAR), stable=True).indices
    pos = torch.arange(order.shape[0], device=order.device)
    taken = torch.zeros_like(cand).scatter_(0, order, (pos < limit) & cand[order])
    act_new = torch.where(taken, min_exit, activation)
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


def _flag_mask(part, flag: int, active_mask, slashed):
    return active_mask & ((part & (1 << flag)) != 0) & ~slashed


def _altair_head(C: EpochConsts, cols, scalars):
    """The fork-independent front of the altair-family sweep: justification,
    inactivity updates, and rewards/penalties."""
    effective = cols["effective"]
    slashed = cols["slashed"]
    activation = cols["activation"]
    exit_ep = cols["exit"]
    withdrawable = cols["withdrawable"]
    balances = cols["balances"]
    inact = cols["inactivity"]
    prev_part = cols["prev_part"]
    cur_part = cols["cur_part"]
    cur_ep = scalars["cur_epoch"]

    inc = C.effective_balance_increment
    prev_ep = max(cur_ep - 1, 0)
    active_cur = (activation <= cur_ep) & (cur_ep < exit_ep)
    active_prev = (activation <= prev_ep) & (prev_ep < exit_ep)
    total = _sum_where(active_cur, effective).clamp(min=inc)

    # --- justification & finalization ------------------------------------
    prev_tgt = _flag_mask(prev_part, TIMELY_TARGET_FLAG_INDEX, active_prev, slashed)
    cur_tgt = _flag_mask(cur_part, TIMELY_TARGET_FLAG_INDEX, active_cur, slashed)
    prev_tb = _sum_where(prev_tgt, effective).clamp(min=inc)
    cur_tb = _sum_where(cur_tgt, effective).clamp(min=inc)
    do_just = cur_ep > 1
    new_bits, cj_prev, cj_cur, fin_sel, f_new = _justification(
        do_just, total, prev_tb, cur_tb, scalars["bits"], scalars["prev_justified_epoch"],
        scalars["cur_justified_epoch"], scalars["finalized_epoch"], cur_ep,
    )

    # --- inactivity updates (reads the just-updated finalized epoch) -----
    do_rp = cur_ep > 0
    eligible = active_prev | (slashed & (prev_ep + 1 < withdrawable))
    is_leak = (prev_ep - f_new) > C.min_epochs_to_inactivity_penalty
    s1 = torch.where(eligible & prev_tgt, inact - inact.clamp(max=1), inact)
    s1 = torch.where(eligible & ~prev_tgt, s1 + C.inactivity_score_bias, s1)
    s2 = torch.where(
        eligible & ~is_leak, s1 - s1.clamp(max=C.inactivity_score_recovery_rate), s1
    )
    inact_new = s2 if do_rp else inact

    # --- rewards & penalties ---------------------------------------------
    total_increments = total // inc
    per_inc = inc * C.base_reward_factor // _isqrt(total)
    base = (effective // inc) * per_inc
    rewards = torch.zeros_like(balances)
    penalties = torch.zeros_like(balances)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        mask = _flag_mask(prev_part, flag_index, active_prev, slashed)
        flag_increments = _sum_where(mask, effective).clamp(min=inc) // inc
        numer = base * (weight * flag_increments)
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

    return {
        "bal": bal, "inact_new": inact_new, "bits": new_bits, "cj_prev": cj_prev,
        "cj_cur": cj_cur, "fin_sel": fin_sel, "f_new": f_new, "do_just": do_just,
        "active_cur": active_cur, "total": total,
    }


def _sweep_altair(C: EpochConsts, cols, scalars):
    cur_ep = scalars["cur_epoch"]
    h = _altair_head(C, cols, scalars)
    elig_new, exit_new, wd_new, act_new = _registry_updates(
        C, cur_ep, h["f_new"], cols["effective"], cols["activation"], cols["exit"],
        cols["withdrawable"], cols["eligibility"], h["active_cur"],
    )
    bal = _slashings(C, cur_ep, h["total"], scalars["slash_sum"], cols["effective"],
                     cols["slashed"], cols["withdrawable"], h["bal"])
    return {
        "balances": bal,
        "inactivity": h["inact_new"],
        "effective": _effective_updates(C, bal, cols["effective"]),
        "activation": act_new,
        "exit": exit_new,
        "withdrawable": wd_new,
        "eligibility": elig_new,
        **{k: h[k] for k in ("bits", "cj_prev", "cj_cur", "fin_sel", "f_new", "do_just")},
    }


def _sweep_phase0(C: EpochConsts, cols, scalars):
    effective = cols["effective"]
    slashed = cols["slashed"]
    activation = cols["activation"]
    exit_ep = cols["exit"]
    withdrawable = cols["withdrawable"]
    balances = cols["balances"]
    src_mask = cols["src_mask"]
    tgt_mask = cols["tgt_mask"]
    head_mask = cols["head_mask"]
    cur_ep = scalars["cur_epoch"]

    inc = C.effective_balance_increment
    prev_ep = max(cur_ep - 1, 0)
    active_cur = (activation <= cur_ep) & (cur_ep < exit_ep)
    active_prev = (activation <= prev_ep) & (prev_ep < exit_ep)
    total = _sum_where(active_cur, effective).clamp(min=inc)

    # --- justification (target masks are host-gathered, unslashed) -------
    prev_tb = _sum_where(tgt_mask, effective).clamp(min=inc)
    cur_tb = _sum_where(cols["cur_tgt_mask"], effective).clamp(min=inc)
    do_just = cur_ep > 1
    new_bits, cj_prev, cj_cur, fin_sel, f_new = _justification(
        do_just, total, prev_tb, cur_tb, scalars["bits"], scalars["prev_justified_epoch"],
        scalars["cur_justified_epoch"], scalars["finalized_epoch"], cur_ep,
    )

    # --- rewards & penalties ---------------------------------------------
    do_rp = cur_ep > 0
    eligible = active_prev | (slashed & (prev_ep + 1 < withdrawable))
    delay = prev_ep - f_new
    is_leak = delay > C.min_epochs_to_inactivity_penalty
    base = effective * C.base_reward_factor // _isqrt(total) // BASE_REWARDS_PER_EPOCH
    total_increments = total // inc
    rewards = torch.zeros_like(balances)
    penalties = torch.zeros_like(balances)
    for mask in (src_mask, tgt_mask, head_mask):
        increments = _sum_where(mask, effective).clamp(min=inc) // inc
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
    rewards = rewards.index_add(0, cols["incl_proposer"], torch.where(ok, proposer_reward, 0))
    safe_delay = torch.where(ok, cols["incl_delay"], 1)
    rewards = torch.where(ok, rewards + (base - proposer_reward) // safe_delay, rewards)

    # inactivity-leak penalties
    leak_pen = BASE_REWARDS_PER_EPOCH * base - base // C.proposer_reward_quotient
    penalties = torch.where(eligible & is_leak, penalties + leak_pen, penalties)
    penalties = torch.where(
        eligible & ~tgt_mask & is_leak,
        penalties + effective * delay // C.inactivity_penalty_quotient,
        penalties,
    )
    bal = balances
    if do_rp:
        bal = balances + rewards
        bal = bal - torch.minimum(penalties, bal)

    # --- registry updates / slashings / effective balances ---------------
    elig_new, exit_new, wd_new, act_new = _registry_updates(
        C, cur_ep, f_new, effective, activation, exit_ep, withdrawable,
        cols["eligibility"], active_cur,
    )
    bal = _slashings(C, cur_ep, total, scalars["slash_sum"], effective, slashed,
                     withdrawable, bal)
    return {
        "balances": bal,
        "effective": _effective_updates(C, bal, effective),
        "activation": act_new,
        "exit": exit_new,
        "withdrawable": wd_new,
        "eligibility": elig_new,
        "bits": new_bits,
        "cj_prev": cj_prev,
        "cj_cur": cj_cur,
        "fin_sel": fin_sel,
        "f_new": f_new,
        "do_just": do_just,
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


def _registry_updates_electra(C: EpochConsts, cur_ep: int, f_new, effective, activation,
                              exit_ep, withdrawable, eligibility, active_cur,
                              earliest_exit_in: int, exit_btc_in: int, churn_aexit):
    """Electra process_registry_updates: MIN_ACTIVATION_BALANCE eligibility,
    balance-churned ejections in closed form, and limit-free activations.
    With ``E0 = max(earliest_exit, cur+1+lookahead)`` and ``btc0`` the
    epoch's starting exit budget, the k-th ejection (index order, inclusive
    balance cumsum ``C_k``) lands on ``E0 + ceil((C_k - btc0) / churn)``."""
    elig_new = torch.where(
        (eligibility == FAR) & (effective >= C.min_activation_balance), cur_ep + 1, eligibility
    )
    eject = active_cur & (effective <= C.ejection_balance) & (exit_ep == FAR)
    min_exit = cur_ep + 1 + C.max_seed_lookahead
    e0 = max(earliest_exit_in, min_exit)
    btc0 = churn_aexit if earliest_exit_in < e0 else exit_btc_in
    csum = torch.cumsum(torch.where(eject, effective, 0), 0)
    add = torch.where(csum > btc0, (csum - btc0 - 1) // churn_aexit + 1, 0)
    assigned = e0 + add
    exit_new = torch.where(eject, assigned, exit_ep)
    wd_new = torch.where(eject, assigned + C.min_validator_withdrawability_delay, withdrawable)
    # activations: every finalized-eligible candidate activates (EIP-7251
    # throttles via the pending-deposit balance churn, not a queue limit)
    cand = (elig_new <= f_new) & (activation == FAR)
    act_new = torch.where(cand, min_exit, activation)
    return (elig_new, exit_new, wd_new, act_new, eject.any(), e0 + add[-1],
            btc0 + add[-1] * churn_aexit - csum[-1])


def _deposits_stage(C: EpochConsts, next_ep: int, f_new, exit_new, wd_new, balances,
                    dep_amount, dep_slot, dep_index, dep_valid, dbtc_in: int, churn_aexit,
                    bridge_wait: bool):
    """process_pending_deposits as a masked cumulative sum over the first
    MAX_PENDING_DEPOSITS_PER_EPOCH queue entries. The loop's three break
    conditions become stop positions (first gate failure, first churn
    overflow among budget-consuming entries, queue end); the realised stop
    is their minimum. Known-index deposits are added into balances here;
    unknown-pubkey ones are flagged for the host."""
    maxq = dep_amount.shape[0]
    pos = torch.arange(maxq, device=dep_amount.device)
    gate_fail = dep_valid & (((dep_slot > 0) & bridge_wait)
                             | (dep_slot > f_new * C.slots_per_epoch))
    s_gate = torch.where(gate_fail, pos, maxq).min()
    known = dep_index >= 0
    gi = dep_index.clamp(0, exit_new.shape[0] - 1)
    withdrawn = dep_valid & known & (wd_new[gi] < next_ep)
    exited = dep_valid & known & ~withdrawn & (exit_new[gi] < FAR)
    consumes = dep_valid & ~withdrawn & ~exited  # the budget-charged branch
    csum = torch.cumsum(torch.where(consumes, dep_amount, 0), 0)
    available = churn_aexit + dbtc_in
    s_churn = torch.where(consumes & (csum > available), pos, maxq).min()
    s_other = torch.minimum(s_gate, dep_valid.sum())
    s = torch.minimum(s_churn, s_other)
    before = pos < s
    processed = _sum_where(consumes & before, dep_amount)
    apply_dev = before & known & (withdrawn | consumes)
    bal = balances.index_add(0, gi, torch.where(apply_dev, dep_amount, 0))
    dbtc_out = torch.where(s_churn < s_other, available - processed, 0)
    return bal, s, before & exited, before & dep_valid & ~known, dbtc_out


def _consolidations(next_ep: int, slashed, effective, wd_new, balances, con_src, con_tgt,
                    con_valid):
    """process_pending_consolidations over the padded queue, in order (the
    reference's ``lax.scan``): duplicate sources and chains move running
    balances, so each step moves ``min(balance, effective)`` source ->
    target against the carried plane. Slashed sources are skipped but
    consumed; the first live source still inside its withdrawability delay
    stops the sweep."""
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


def _sweep_electra(C: EpochConsts, cols, scalars):
    from ..ops.bls.fq import _cert

    effective = cols["effective"]
    slashed = cols["slashed"]
    withdrawable = cols["withdrawable"]
    cur_ep = scalars["cur_epoch"]
    n_pad = effective.shape[0]
    assert _cert(
        "epoch_validator_index_domain", n_pad, 2**31 - 1,
        "validator-axis gather/scatter indices fit int32",
    )
    assert _cert(
        "epoch_deposit_plane_width", C.max_pending_deposits_per_epoch,
        cols["dep_amount"].shape[0], "deposit sweep never reads past the fixed queue plane",
    )

    h = _altair_head(C, cols, scalars)
    bal, f_new, total = h["bal"], h["f_new"], h["total"]
    next_ep = cur_ep + 1
    _, churn_aexit = _balance_churn_limits(C, total)
    (elig_new, exit_new, wd_new, act_new, has_ejection, earliest_out,
     exit_btc_out) = _registry_updates_electra(
        C, cur_ep, f_new, effective, cols["activation"], cols["exit"], withdrawable,
        cols["eligibility"], h["active_cur"], scalars["earliest_exit_epoch"],
        scalars["exit_balance_to_consume"], churn_aexit,
    )
    bal = _slashings(C, cur_ep, total, scalars["slash_sum"], effective, slashed,
                     withdrawable, bal)
    # deposit/consolidation classification reads the POST-registry exit and
    # withdrawable planes — the numpy twin's loops run after the updates
    bal, dep_stop, dep_postponed, dep_host, dbtc_out = _deposits_stage(
        C, next_ep, f_new, exit_new, wd_new, bal, cols["dep_amount"], cols["dep_slot"],
        cols["dep_index"], cols["dep_valid"], scalars["deposit_balance_to_consume"],
        churn_aexit,
        scalars["eth1_deposit_index"] < scalars["deposit_requests_start_index"],
    )
    bal, cons_consumed = _consolidations(
        next_ep, slashed, effective, wd_new, bal, cols["con_src"], cols["con_tgt"],
        cols["con_valid"],
    )
    max_eff = torch.where(
        cols["compounding"], C.max_effective_balance_electra, C.min_activation_balance
    )
    return {
        "balances": bal,
        "inactivity": h["inact_new"],
        "effective": _effective_updates(C, bal, effective, max_eff=max_eff),
        "activation": act_new,
        "exit": exit_new,
        "withdrawable": wd_new,
        "eligibility": elig_new,
        **{k: h[k] for k in ("bits", "cj_prev", "cj_cur", "fin_sel", "f_new", "do_just")},
        "dep_stop": dep_stop,
        "dep_postponed": dep_postponed,
        "dep_host": dep_host,
        "dep_btc": dbtc_out,
        "cons_consumed": cons_consumed,
        "has_ejection": has_ejection,
        "earliest_exit": earliest_out,
        "exit_btc": exit_btc_out,
    }


_SWEEPS = {"phase0": _sweep_phase0, "altair": _sweep_altair, "electra": _sweep_electra}


def run_sweep(consts: EpochConsts, cols: dict, scalars: dict) -> dict:
    """One epoch sweep of ``consts.family`` over the device columns ``cols``
    (all on one device) and the host ``scalars``; returns device tensors
    (and host flags), not yet synchronised."""
    return _SWEEPS[consts.family](consts, cols, scalars)
