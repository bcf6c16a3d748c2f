#!/usr/bin/env python3
"""The knee of an open-loop mix: one window at each offered rate.

    python3 benchmark/tools/sweep.py --workload mainnet-2p20.attestations --seconds 10 \
        --rates 150 200 250 300 350 400 --seed 5

Each rate replaces the rate of every arrival segment of the mix for a whole
run of the cell (set-up, window, wait, check) in this one process. For each it prints the verdict
latency's p50 and p95 over the payloads due in the window, the payloads the
intake shed, and the backlog (payloads due but not yet answered) at each
quarter of the window: a backlog that keeps growing to the window's end
means the rate is above what the program sustains. The knee is the highest
rate with nothing shed and no growing backlog.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.harness import guard, spec  # noqa: E402


def backlog(window, t: float) -> int:
    return sum(1 for s in window.subs if s.due <= t and (s.done is None or s.done > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    guard.cache_env(run.CACHE)
    cell = spec.Cell(spec.benchmark(run.ROOT), args.workload)
    base = dict(cell.params)
    for i, rate in enumerate(args.rates):
        cell.params = dict(base, arrivals=[dict(seg, rate=rate) for seg in base["arrivals"]])
        result, notes, w = run.execute(cell, args.seed + i, args.seconds, False)
        due = [s for s in w.subs if w.t0 <= s.due < w.t_end]
        lat = sorted((s.done - s.due) * 1e3 if s.done is not None else math.inf for s in due)
        q = [backlog(w, w.t0 + f * w.seconds) for f in (0.25, 0.5, 0.75, 1.0)]
        print(json.dumps({
            "rate": rate, "due": len(due), "shed": sum(1 for s in w.subs if not s.accepted),
            "p50_ms": lat[len(lat) // 2], "p95_ms": lat[max(0, math.ceil(0.95 * len(lat)) - 1)],
            "backlog_quarters": q, "correct": result["correct"],
            "setup": notes[0],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
