"""Batched light-client update verification: ONE pairing check per batch.

The port of ``lighthouse_tpu/ops/lc/verify.py``. Per session (spec
``process_light_client_update`` signature core): the participants'
aggregated committee pubkey P_i signs the attested header's signing root
m_i, so the check is e(P_i, H(m_i)) == e(G1, sig_i). Every session shares
the G1 generator on the signature side, so B heterogeneous sessions
(distinct periods, bitfields, attested roots) fold under random weights r_i
into the blst ``verify_multiple_aggregate_signatures`` shape::

    prod_i e(r_i * P_i, H(m_i)) * e(-G1, sum_i r_i * sig_i) == 1

— B+1 pairs, one shared-accumulator Miller product, ONE final
exponentiation. P_i is a bitfield-masked sum over a device-resident
per-period committee pubkey cache ``[P, C, 3, 25]``: session i gathers row
``pidx[i]``, so a batch mixing sync-committee periods runs as one dispatch.

The stages are the main path's (``bls.backend``: ``h2c_stage``,
``aggregate_stage``, ``prologue_stage``, ``pair_stage``) over the gathered
committee rows: the security prologue is blst's ``sigs_groupcheck`` (the
G2 subgroup check psi(Q) == [x]Q fused with the random scaling into one
windowed ladder, infinity rejection for both the aggregate pubkey and the
signature), plus well-formedness + on-curve flags from decompression and
an empty-bitfield reject. A session failing ANY check fails the whole
batch (callers bisect, as the attestation firehose does).

Scalars are int64 tensors holding the uint64 bit patterns
(``curve.scale_u64_with_fixed`` reads them by mask). ``PROBE`` counts at run
time what each call runs — pairing checks, pairs and aggregation sums (the
reference counts them at trace time; a torch program is its run).
"""

from __future__ import annotations

import torch

from ...bls import backend
from ..bls import g2

PROBE = {"pairing_checks": 0, "pairs": 0, "agg_sums": 0}


def lc_h2c(u0, u1):
    """Stage 1: device hash-to-curve for the signing roots.

    u0/u1 [B, 2, 25] hash_to_field residues (host SHA-256) -> affine G2
    message points (mx, my) [B, 2, 25] each."""
    return backend.h2c_stage(u0, u1)


def lc_prep(cache, pidx, bits, sxc0, sxc1, s_flag, sig_wf, scalars, valid):
    """Stage 2: committee gather + masked aggregation + security prologue.

    cache  [P, C, 3, 25]  per-period committee pubkeys (projective); row p
                          holds period p's C decompressed keys
    pidx   [B] int64      per-session cache row (heterogeneous periods)
    bits   [B, C] bool    sync-committee participation bitfields
    sxc0/sxc1 [B, 25]     raw signature x limbs (flags cleared)
    s_flag [B] int64      lex-sign bit; sig_wf [B] bool well-formed encoding
    scalars [B] int64     random weights (uint64 bit patterns); valid [B]
                          bool real sessions

    Returns affine (pkx, pky, sax, say) for the pairing stage plus the
    per-session set_ok flags. The aggregation and the prologue are the
    main path's (``bls.backend``), over the gathered rows ``cache[pidx]``."""
    sig, on_curve = g2.decompress(torch.stack([sxc0, sxc1], dim=-2), s_flag)
    pk_agg = backend.aggregate_stage(cache[pidx], bits)  # [B, C, 3, 25] -> [B, 3, 25]
    PROBE["agg_sums"] += 1
    pkx, pky, sax, say, set_ok = backend.prologue_stage(pk_agg, sig, scalars, valid)
    set_ok = set_ok & (~valid | (sig_wf & on_curve & torch.any(bits, dim=1)))
    return pkx, pky, sax, say, set_ok


def lc_pair(pkx, pky, sax, say, mxa, mya, set_ok, valid):
    """Stage 3: B+1-pair Miller product + ONE final exponentiation +
    verdict (the main path's pair stage). The -G1 generator pairs with the
    scaled signature sum."""
    PROBE["pairing_checks"] += 1
    PROBE["pairs"] += valid.shape[0] + 1
    return backend.pair_stage(pkx, pky, sax, say, mxa, mya, set_ok, valid)


def lc_batch_check(cache, pidx, bits, u0, u1, sxc0, sxc1, s_flag, sig_wf,
                   scalars, valid):
    """The full batched update check (the stages composed): a bool tensor —
    the WHOLE batch of sessions verifies. Padded rows carry valid=False and
    contribute the identity everywhere."""
    mxa, mya = lc_h2c(u0, u1)
    pkx, pky, sax, say, set_ok = lc_prep(
        cache, pidx, bits, sxc0, sxc1, s_flag, sig_wf, scalars, valid
    )
    return lc_pair(pkx, pky, sax, say, mxa, mya, set_ok, valid)
