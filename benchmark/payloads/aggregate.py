"""SignedAggregateAndProof payloads, run as a closed loop.

A payload is a group of three signature sets: the selection proof (the
aggregator's key over the slot's root), the aggregator's signature (its key
over its own AggregateAndProof root) and the aggregate (a committee's
participants over the slot's attestation data root, which electra's
committees share). The mix's numbers:

* ``intake_depth``: the closed loop keeps the intake this deep from a pool
  of one slot's aggregates, ``aggregators_per_committee`` in each of the
  configuration's committees, cycled;
* ``participation``: the range of a committee's share that signs an
  aggregate; every seed gets the same shares, in another order;
* ``invalid``: ``count`` payloads submitted once each at sequence positions
  ``first``, ``first + apart``, ...; the bad set is the aggregate signed
  over another message, then the selection proof, in turn (one bad set at
  each end of a group).
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.fixtures import chunked
from benchmark.harness.traffic import Entry, Traffic, committee_shape, sample_of, shares
from benchmark.reference import curves as oc


def plan(cfg, params, rng, seconds, workers) -> Traffic:
    if params["loop"] != "closed":
        raise ValueError("aggregate mixes run as a closed loop")
    n, sk0 = cfg["validators"], int(cfg["base_secret_key"], 0)
    n_comm, width = committee_shape(cfg)
    per = params["aggregators_per_committee"]
    members = rng.choice(n, n_comm * width, replace=False).reshape(n_comm, width)
    m_data, m_slot, m_bad = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    pool_n = n_comm * per
    inv = params["invalid"]
    pool_shares = shares(*params["participation"], pool_n, rng)
    extra_shares = shares(*params["participation"], inv["count"], rng)

    def draw(c, aggregator_pos, share):
        a = int(members[c, aggregator_pos])
        k = int(min(width, max(1, round(share * width))))
        chosen = members[c, np.sort(rng.choice(width, k, replace=False))]
        return a, chosen

    drawn = []
    for c in range(n_comm):
        for pos in rng.choice(width, per, replace=False):
            drawn.append(draw(c, pos, pool_shares[len(drawn)]))
    drawn = [drawn[i] for i in rng.permutation(pool_n)]
    for share in extra_shares:
        drawn.append(draw(int(rng.integers(n_comm)), int(rng.integers(width)), share))
    m_aggs = [rng.bytes(32) for _ in drawn]

    entries = []
    data_pairs, bad_data, slot_pairs, bad_slot, own = [], [], [], [], []
    for e, ((a, chosen), m_agg) in enumerate(zip(drawn, m_aggs)):
        bad = None if e < pool_n else (2, 0)[(e - pool_n) % 2]
        ix = tuple(int(v) for v in chosen)
        entries.append(Entry(
            group=[((a,), m_slot, None), ((a,), m_agg, None), (ix, m_data, None)],
            sets=3, keys=2 + len(ix),
        ))
        (bad_data if bad == 2 else data_pairs).append(((len(ix), int(chosen.sum())), (e, 2)))
        (bad_slot if bad == 0 else slot_pairs).append(((1, a), (e, 0)))
        own.append(((sk0 + a, m_agg), (e, 1)))
    s_bits = (width * n).bit_length()
    jobs, targets = [], []
    for msg, pairs, kmax, bits in ((m_data, data_pairs, width, s_bits),
                                   (m_bad, bad_data, width, s_bits),
                                   (m_slot, slot_pairs, 1, n.bit_length()),
                                   (m_bad, bad_slot, 1, n.bit_length())):
        for ch in chunked(pairs, workers):
            jobs.append(("shared", msg, sk0, kmax, bits, [p for p, _ in ch]))
            targets.append([t for _, t in ch])
    for ch in chunked(own, 2 * workers):
        jobs.append(("distinct", [p for p, _ in ch]))
        targets.append([t for _, t in ch])

    first, apart = inv["first"], inv["apart"]
    extra_at = {first + i * apart: pool_n + i for i in range(inv["count"])}
    sample = sample_of(list(range(pool_n)), params["sample"], rng)
    return Traffic(
        payload="aggregate", loop="closed", work_type=params["work_type"],
        batch_limit=cfg["batch_limits"][params["batch_limit"]], entries=entries,
        sample=sample + list(range(pool_n, len(entries))), wait_s=params["wait_s"],
        pool_size=pool_n, intake_depth=params["intake_depth"], extra_at=extra_at,
        jobs=jobs, targets=targets,
    )


def warm_items(cfg, n_payloads, rng) -> list:
    """The sets of ``n_payloads`` aggregates at the widest committee, with a
    well-formed signature and random messages."""
    n = cfg["validators"]
    _, width = committee_shape(cfg)
    sig = oc.g2_compress(oc.g2_generator())
    items = []
    for _ in range(n_payloads):
        a = (int(rng.integers(n)),)
        items.append((a, rng.bytes(32), sig))
        items.append((a, rng.bytes(32), sig))
        items.append((tuple(int(v) for v in rng.choice(n, width, replace=False)),
                      rng.bytes(32), sig))
    return items
