"""The traffic generator: a mix's parameter file and a configuration in,
the payloads, their arrival plan, the signing jobs and the reference's
sample out. Everything is drawn from the seed.

A mix file (``benchmark/traffic/<name>.json``) names its payload kind and
loop, and gives the numbers. The payload kind is a module of its own,
``benchmark/payloads/<payload>.py``, found by name: its ``plan(cfg, params,
rng, seconds, workers)`` makes the ``Traffic`` and its ``warm_items(cfg, n,
rng)`` the sets of a verify call of ``n`` payloads for the warm-up. A new
kind of payload is a new file there. The kinds share what is here:

* ``loop``: ``closed`` (the intake is kept ``intake_depth`` deep from a
  cycled pool of payloads) or ``open`` (each payload due at its own time;
  ``arrivals`` is a list of segments ``{from, to, rate}``, shares of the
  window and payloads a second; a segment may run past the window's end);
* ``sample``: the valid payloads the reference judges, besides every
  invalid one; ``wait_s``: how long after the window a verdict may come.

Open-loop arrivals are Poisson in shape with the same set of gaps for
every seed (the quantiles of the exponential at (i + 0.5) / n), shuffled
by the seed, so two seeds differ in order and not in load.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Entry:
    """One payload as the benchmark made it: its signature-set group
    (``(indices, message, signature bytes)`` triples). Whether it is valid is
    the reference's to judge."""

    group: list
    sets: int = 0
    keys: int = 0


@dataclass
class Traffic:
    payload: str
    loop: str
    work_type: str
    batch_limit: int
    entries: list
    sample: list
    wait_s: float
    pool_size: int = 0
    intake_depth: int = 0
    extra_at: dict = field(default_factory=dict)   # closed loop: sequence -> entry id
    due: list = field(default_factory=list)        # open loop: offsets (s), entry order
    jobs: list = field(default_factory=list)       # signing jobs (fixtures.sign_job)
    targets: list = field(default_factory=list)    # per job: [(entry id, set index)]

    def entry_at(self, seq: int) -> int:
        """Closed loop: the entry submitted at sequence position ``seq``."""
        hit = self.extra_at.get(seq)
        if hit is not None:
            return hit
        before = sum(1 for p in self.extra_at if p < seq)
        return (seq - before) % self.pool_size

    def attach(self, results: list) -> None:
        """The signing jobs' results -> each entry's signature bytes."""
        for tgt, sigs in zip(self.targets, results):
            if len(tgt) != len(sigs):
                raise ValueError("a signing job returned the wrong number of signatures")
            for (e, s), sig in zip(tgt, sigs):
                ix, msg, _ = self.entries[e].group[s]
                self.entries[e].group[s] = (ix, msg, sig)
        self.jobs, self.targets = [], []

    def warm_sizes(self) -> list:
        """Payload counts a verify call can carry in this mix, one per
        padded row count: full batches and every bisection level."""
        sizes, b = [], self.batch_limit
        while b >= 1:
            sizes.append(b)
            b //= 2
        return sizes


def rng_for(seed: int) -> np.random.Generator:
    """The seed's generator: any whole number (negative and wider than 64
    bits included) maps to one stream."""
    return np.random.default_rng(int(seed) % (1 << 64))


def shares(lo: float, hi: float, n: int, rng) -> np.ndarray:
    """``n`` evenly spaced values across [lo, hi], in the seed's order."""
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    rng.shuffle(q)
    return q


def arrivals(segments: list, seconds: float, rng) -> np.ndarray:
    """Due offsets (s) from the window's start: per segment round(rate *
    length) payloads with the exponential's quantile gaps, shuffled by
    ``rng``."""
    out = []
    for seg in segments:
        t0, span = seg["from"] * seconds, (seg["to"] - seg["from"]) * seconds
        n = int(round(seg["rate"] * span))
        if n <= 0:
            continue
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / seg["rate"]
        rng.shuffle(gaps)
        t = np.cumsum(gaps)
        out.append(t0 + t * (span * (1.0 - 0.5 / n) / t[-1]))
    return np.sort(np.concatenate(out)) if out else np.zeros(0)


def committee_shape(cfg: dict) -> tuple[int, int]:
    """(committees a slot, committee width) of the configuration's registry
    under its preset (consensus-specs ``get_committee_count_per_slot``)."""
    p = cfg["preset"]
    n = cfg["validators"]
    per_slot = max(1, min(p["MAX_COMMITTEES_PER_SLOT"],
                          n // p["SLOTS_PER_EPOCH"] // p["TARGET_COMMITTEE_SIZE"]))
    width = n // (p["SLOTS_PER_EPOCH"] * per_slot)
    return per_slot, width


def kind(payload: str):
    """``benchmark/payloads/<payload>.py``: a payload kind's generator."""
    if not payload.isidentifier():
        raise ValueError(f"no payload kind {payload!r}")
    return importlib.import_module(f"benchmark.payloads.{payload}")


def plan(cfg: dict, params: dict, seed: int, seconds: float, workers: int = 8) -> Traffic:
    """The seed's payloads (signatures still to sign: ``jobs``)."""
    return kind(params["payload"]).plan(cfg, params, rng_for(seed), seconds, workers)


def warm_items(traffic: Traffic, cfg: dict, n_payloads: int, rng) -> list:
    """Flat signature sets with the shape of ``n_payloads`` of this mix's
    payloads: what a verify call of that size carries, for the warm-up."""
    return kind(traffic.payload).warm_items(cfg, n_payloads, rng)


def sample_of(ids: list, n: int, rng) -> list:
    """``n`` of ``ids`` (all when fewer), drawn from ``rng``, in order."""
    return sorted(int(i) for i in rng.choice(ids, min(n, len(ids)), replace=False))
