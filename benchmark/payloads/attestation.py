"""Unaggregated single-key attestations, run as an open loop.

Each payload is one signature set: a validator's key over the slot's
attestation data root (electra: every committee signs one root). The mix's
numbers:

* ``arrivals``: the segments of the open loop; a segment that runs past the
  window's end (``to`` above 1) carries payloads after it, at the same
  load, which the window's metrics leave out;
* ``invalid``: ``count`` payloads signed over another message, at
  positions drawn from the seed among the payloads due in the shares
  ``from`` to ``to`` of the window. Placed after the window, their
  bisections cost the window nothing; spread over a stretch that several
  batches cover, some fall in the front half of their batch and some in
  the back half.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.fixtures import chunked
from benchmark.harness.traffic import Entry, Traffic, arrivals, sample_of
from benchmark.reference import curves as oc


def plan(cfg, params, rng, seconds, workers) -> Traffic:
    if params["loop"] != "open":
        raise ValueError("attestation mixes run as an open loop")
    n, sk0 = cfg["validators"], int(cfg["base_secret_key"], 0)
    due = arrivals(params["arrivals"], seconds, rng)
    count = len(due)
    voters = rng.choice(n, count, replace=False)
    m_data, m_bad = rng.bytes(32), rng.bytes(32)
    inv = params["invalid"]
    lo, hi = np.searchsorted(due, [inv["from"] * seconds, inv["to"] * seconds])
    if hi - lo < inv["count"]:
        raise ValueError("fewer payloads due where the invalid ones go than the mix asks for")
    bad = set(int(i) for i in lo + rng.choice(hi - lo, inv["count"], replace=False))
    entries, good_pairs, bad_pairs = [], [], []
    for e, v in enumerate(voters):
        v = int(v)
        entries.append(Entry(group=[((v,), m_data, None)], sets=1, keys=1))
        (bad_pairs if e in bad else good_pairs).append(((1, v), (e, 0)))
    jobs, targets = [], []
    for msg, pairs in ((m_data, good_pairs), (m_bad, bad_pairs)):
        for ch in chunked(pairs, workers):
            jobs.append(("shared", msg, sk0, 1, n.bit_length(), [p for p, _ in ch]))
            targets.append([t for _, t in ch])
    sample = sample_of([e for e in range(count) if e not in bad], params["sample"], rng)
    return Traffic(
        payload="attestation", loop="open", work_type=params["work_type"],
        batch_limit=cfg["batch_limits"][params["batch_limit"]], entries=entries,
        sample=sample + sorted(bad), wait_s=params["wait_s"], due=[float(t) for t in due],
        jobs=jobs, targets=targets,
    )


def warm_items(cfg, n_payloads, rng) -> list:
    """The sets of ``n_payloads`` attestations, with a well-formed signature
    and random messages."""
    n = cfg["validators"]
    sig = oc.g2_compress(oc.g2_generator())
    return [((int(rng.integers(n)),), rng.bytes(32), sig) for _ in range(n_payloads)]
