"""The epoch sweep over a serving mesh: the registry mirror's columns in row
blocks, one block per device. The port of the reference's ``sharding=``
(GSPMD over a ``validators`` axis, ``epoch_engine/engine.py:43-67,142-160``),
where XLA inserts the cross-shard reductions; here they are explicit.

Block ``s`` holds rows ``[s*b, (s+1)*b)`` on ``devices[s]`` and every
per-validator stage runs on its block under that device's context. What
reads the whole registry is combined on ``devices[0]`` before the stages
that read it:

* the partial sums (``kernels._partials``: total active balance, the target
  and flag balances, the active and ejection counts, the largest exit
  epoch) are added (the exit epoch maxed) across blocks before any delta;
* the exit queue's equal-epoch count is added across blocks; each block's
  ejection ranks (electra: its ejected-balance cumsum) start at the
  exclusive prefix of the earlier blocks';
* the activation queue's stable sort runs over the blocks' keys joined;
* phase0's proposer micro-rewards, electra's deposits and consolidations
  address rows anywhere in the registry: their operands are gathered onto
  ``devices[0]``, the queue logic runs there (``kernels.deposit_plan``,
  ``kernels.consolidations``) and the results land back in the blocks.

Every stage is the unsharded sweep's own function (``kernels.py``), so the
outputs equal ``run_sweep``'s field for field.
"""

from __future__ import annotations

import torch

from ..bls.mesh import device_context
from . import kernels as K
from .kernels import FAR, P_EJECT, P_EJECT_EFF, EpochConsts


def _on(v, dev):
    return v.to(dev) if torch.is_tensor(v) else v


def _to(g: dict, dev) -> dict:
    return {k: _on(v, dev) for k, v in g.items()}


def _gather(blocks, idx, key: str, b: int, fill=0):
    """``plane[idx]`` over the row blocks, for global row indices ``idx`` on
    ``devices[0]`` (an index no block holds gives ``fill``)."""
    out = None
    for s, blk in enumerate(blocks):
        plane = blk[key]
        lo = s * b
        in_b = (idx >= lo) & (idx < lo + b)
        loc = (idx - lo).clamp(0, b - 1).to(plane.device)
        vals = torch.where(in_b, plane[loc].to(idx.device), fill)
        out = vals if out is None else torch.where(in_b, vals, out)
    return out


def run_sweep_sharded(C: EpochConsts, cols: dict, scalars: dict, devices) -> dict:
    """One epoch sweep over row blocks. ``cols`` holds every per-validator
    column as a list of blocks (block s on ``devices[s]``) and the queue
    columns as tensors on ``devices[0]``. Returns ``run_sweep``'s outputs
    with the per-validator ones as lists of blocks."""
    n_blk = len(devices)
    dev0 = devices[0]
    blocks = [{k: v[s] for k, v in cols.items() if isinstance(v, list)} for s in range(n_blk)]
    b = blocks[0]["effective"].shape[0]
    cur_ep = scalars["cur_epoch"]
    min_exit = cur_ep + 1 + C.max_seed_lookahead

    def each(fn):
        out = []
        for s, dev in enumerate(devices):
            with device_context(dev):
                out.append(fn(s, blocks[s]))
        return out

    # -- the registry-wide sums, before any per-validator delta -------------
    pm = each(lambda s, blk: K._partials(C, blk, cur_ep))
    ms = [m for m, _ in pm]
    with device_context(dev0):
        parts = torch.stack([p.to(dev0) for _, p in pm])
        g0 = K._globals(C, K.combine_partials(list(parts)), scalars)
        off_n = torch.cumsum(parts[:, P_EJECT], 0) - parts[:, P_EJECT]
        off_eff = torch.cumsum(parts[:, P_EJECT_EFF], 0) - parts[:, P_EJECT_EFF]
    gs = [_to(g0, dev) for dev in devices]

    # -- balances: rewards, penalties, inactivity ---------------------------
    if C.family == "phase0":
        bases = each(lambda s, blk: K._phase0_base(C, blk, gs[s]))
        prop_vals = each(lambda s, blk: K._phase0_proposer_rewards(C, blk, bases[s]))
        with device_context(dev0):
            prop = torch.zeros(n_blk * b, dtype=torch.int64, device=dev0)
            for s, blk in enumerate(blocks):
                prop.index_add_(0, blk["incl_proposer"].to(dev0), prop_vals[s].to(dev0))
        bal = each(lambda s, blk: K._phase0_deltas(
            C, blk, scalars, ms[s], gs[s], bases[s], prop[s * b:(s + 1) * b].to(devices[s])))
        inact = None
    else:
        out = each(lambda s, blk: K._altair_deltas(C, blk, scalars, ms[s], gs[s]))
        bal, inact = [o[0] for o in out], [o[1] for o in out]

    # -- registry updates -----------------------------------------------------
    if C.family == "electra":
        with device_context(dev0):
            _, churn_aexit = K._balance_churn_limits(C, g0["total"])
            e0, btc0 = K._electra_exit_start(C, cur_ep, scalars, churn_aexit)
        regs = each(lambda s, blk: K._registry_updates_electra(
            C, cur_ep, blk, ms[s], gs[s],
            torch.cumsum(torch.where(ms[s]["eject"], blk["effective"], 0), 0)
            + off_eff[s].to(devices[s]),
            e0, _on(btc0, devices[s]), churn_aexit.to(devices[s])))
    else:
        with device_context(dev0):
            churn, eq0 = K._churn_and_eq0(C, cur_ep, g0)
            same = torch.stack([(blk["exit"] == eq0.to(blk["exit"].device)).sum().to(dev0)
                                for blk in blocks]).sum()
            c_eff = torch.minimum(same, churn)

        def exits(s, blk):
            dev = devices[s]
            elig_new = K._eligibility(C, cur_ep, blk["effective"], blk["eligibility"])
            rank = torch.cumsum(ms[s]["eject"], 0) - 1 + off_n[s].to(dev)
            exit_new, wd_new = K._exit_queue(C, ms[s]["eject"], rank, eq0.to(dev), c_eff.to(dev),
                                             churn.to(dev), blk["exit"], blk["withdrawable"])
            cand = (elig_new <= gs[s]["f_new"]) & (blk["activation"] == FAR)
            return elig_new, exit_new, wd_new, cand

        ex = each(exits)
        with device_context(dev0):
            cand = torch.cat([e[3].to(dev0) for e in ex])
            key = torch.cat([torch.where(e[3], e[0], FAR).to(dev0) for e in ex])
            taken = K.activation_taken(key, cand, K._activation_limit(C, churn))
        regs = [(e[0], e[1], e[2], torch.where(taken[s * b:(s + 1) * b].to(devices[s]), min_exit,
                                               blocks[s]["activation"]))
                for s, e in enumerate(ex)]
    elig_new = [r[0] for r in regs]
    exit_new = [r[1] for r in regs]
    wd_new = [r[2] for r in regs]
    act_new = [r[3] for r in regs]
    bal = each(lambda s, blk: K._slashings(C, cur_ep, gs[s]["total"], scalars["slash_sum"],
                                           blk["effective"], blk["slashed"], blk["withdrawable"],
                                           bal[s]))

    out = {"activation": act_new, "exit": exit_new, "withdrawable": wd_new,
           "eligibility": elig_new, **{k: g0[k] for k in K._FLAG_KEYS}}
    if C.family != "electra":
        out["balances"] = bal
        out["effective"] = each(lambda s, blk: K._effective_updates(C, bal[s], blk["effective"]))
        if inact is not None:
            out["inactivity"] = inact
        return out

    # -- electra's queues: deposits, then consolidations ----------------------
    K.electra_certs(C, n_blk * b, cols["dep_amount"].shape[0])
    post = [{"exit": e, "withdrawable": w, "balances": x} for e, w, x in zip(exit_new, wd_new, bal)]
    next_ep = cur_ep + 1
    with device_context(dev0):
        di = cols["dep_index"]
        add, dep_stop, dep_postponed, dep_host, dbtc_out = K.deposit_plan(
            C, next_ep, g0["f_new"], _gather(post, di, "exit", b),
            _gather(post, di, "withdrawable", b), cols["dep_amount"], cols["dep_slot"], di,
            cols["dep_valid"], scalars["deposit_balance_to_consume"], churn_aexit,
            scalars["eth1_deposit_index"] < scalars["deposit_requests_start_index"],
        )

    def deposit(s, blk):
        lo, dev = s * b, devices[s]
        in_b = ((di >= lo) & (di < lo + b)).to(dev)
        loc = (di - lo).clamp(0, b - 1).to(dev)
        return bal[s].index_add(0, loc, torch.where(in_b, add.to(dev), 0))

    bal = each(deposit)
    with device_context(dev0):
        q = cols["con_src"].shape[0]
        rows, inv = torch.unique(torch.cat([cols["con_src"], cols["con_tgt"]]), return_inverse=True)
        mini = [{"b": x, "e": blk["effective"], "sl": blk["slashed"], "wd": w}
                for x, blk, w in zip(bal, blocks, wd_new)]
        mini_bal, cons_consumed = K.consolidations(
            next_ep, _gather(mini, rows, "sl", b, False), _gather(mini, rows, "e", b),
            _gather(mini, rows, "wd", b), _gather(mini, rows, "b", b),
            inv[:q], inv[q:], cols["con_valid"],
        )

    def land(s, blk):
        lo, dev = s * b, devices[s]
        in_b = (rows >= lo) & (rows < lo + b)
        return bal[s].index_put(((rows[in_b] - lo).to(dev),), mini_bal[in_b].to(dev))

    bal = each(land)
    has_ejection, earliest_out, exit_btc_out = K._electra_exit_carries(g0, e0, btc0, churn_aexit)
    out.update({
        "balances": bal,
        "inactivity": inact,
        "effective": each(lambda s, blk: K._effective_updates(
            C, bal[s], blk["effective"], max_eff=K.max_effective(C, blk))),
        "dep_stop": dep_stop, "dep_postponed": dep_postponed, "dep_host": dep_host,
        "dep_btc": dbtc_out, "cons_consumed": cons_consumed, "has_ejection": has_ejection,
        "earliest_exit": earliest_out, "exit_btc": exit_btc_out,
    })
    return out
