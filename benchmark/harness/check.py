"""The comparison that decides ``correct``.

The reference (``benchmark/reference/bls.py``) judges every sampled entry of
the mix from the inputs the benchmark made: each signature set alone, by
its own pairing equation. Every verdict the window delivered for a sampled
entry, on every submission of it, is held against that judgement. The
numbers compared, each with its limit:

* ``wrong_verdicts``: delivered verdicts of sampled entries that differ
  from the reference's (limit 0: verdicts are exact);
* ``unanswered``: submissions the intake accepted that had no verdict when
  the wait after the window ran out (limit 0);
* ``invalid_unjudged``: invalid entries of the sample that no delivered
  verdict judged, so the run could not show they are rejected (limit 0).

The sample is every invalid entry and ``sample`` valid ones drawn from the
seed; the configurations' guarantee (fail closed, exact per-item verdicts)
is what ``wrong_verdicts`` holds the program to.
"""

from __future__ import annotations

import numpy as np

from ..reference.bls import HashCache, verify_group
from .fixtures import chunked

LIMITS = {"wrong_verdicts": 0, "unanswered": 0, "invalid_unjudged": 0}


def reference_verdicts(traffic, raw, pool=None, workers: int = 0) -> dict:
    """entry id -> the reference's verdict, for the sampled entries. With a
    process ``pool`` of ``workers``, the entries are judged there, each job
    handed the keys of its own entries' sets only."""
    ids = list(traffic.sample)
    if pool is None:
        hashes = HashCache()
        return {e: verify_group(raw, traffic.entries[e].group, hashes) for e in ids}
    jobs = [[own_keys(raw, traffic.entries[e].group) for e in ch]
            for ch in chunked(ids, 4 * max(1, workers))]
    verdicts = [v for out in pool.map(judge_job, jobs) for v in out]
    return dict(zip(ids, verdicts))


def own_keys(raw, group) -> tuple:
    """(the registry rows a group's sets sign with, the group with its
    indices into those rows)."""
    rows, local = [], []
    for ix, m, s in group:
        local.append((tuple(range(len(rows), len(rows) + len(ix))), m, s))
        rows.extend(ix)
    return raw[np.asarray(rows, dtype=np.int64)], local


def judge_job(job) -> list:
    """A worker's share: [(rows, group), ...] -> their verdicts."""
    hashes = HashCache()
    return [verify_group(rows, group, hashes) for rows, group in job]


def compare(traffic, subs, ref: dict) -> dict:
    """The numbers compared (name -> value) and the count of verdicts
    compared."""
    wrong = compared = 0
    judged = set()
    for s in subs:
        if s.ok is None or s.entry not in ref:
            continue
        compared += 1
        judged.add(s.entry)
        wrong += s.ok != ref[s.entry]
    invalid = [e for e, ok in ref.items() if not ok]
    return {
        "wrong_verdicts": wrong,
        "unanswered": sum(1 for s in subs if s.accepted and s.ok is None),
        "invalid_unjudged": sum(1 for e in invalid if e not in judged),
    }, compared


def verdict(numbers: dict, compared: int) -> bool:
    return compared > 0 and all(numbers[k] <= lim for k, lim in LIMITS.items())


def check_block(numbers: dict) -> dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
