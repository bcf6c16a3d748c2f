#!/usr/bin/env python3
"""Faults planted in the timed path, run through a whole cell.

    python3 benchmark/tools/faults.py --workload mainnet-2p20.attestations --seconds 10 \
        --faults first_half_left_out second_half_left_out --seeds 31 32 33

Each fault wraps the program's verify call where the firehose calls it
(``run.execute``'s ``wrap_verify``), so everything else is the cell's own
run: its set-up and warm-up, its mix at its own load, the window, the wait
and the check. The faults a cell can have:

* ``unchanged``: the call returns True without verifying;
* ``first_half_left_out`` / ``second_half_left_out``: the call verifies one
  half of its sets and answers for all of them;
* ``answer_altered``: the call's answer is negated where it is produced.

Each run prints the numbers compared beside their limits; the tool exits 0
only when every run comes out not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.harness import guard, spec  # noqa: E402


def unchanged(inner):
    return lambda items: True


def first_half_left_out(inner):
    return lambda items: inner(items[len(items) // 2:])


def second_half_left_out(inner):
    return lambda items: inner(items[: max(1, len(items) // 2)])


def answer_altered(inner):
    return lambda items: not inner(items)


FAULTS = {f.__name__: f for f in (unchanged, first_half_left_out, second_half_left_out,
                                  answer_altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", nargs="+", choices=sorted(FAULTS), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    guard.cache_env(run.CACHE)
    cell = spec.Cell(spec.benchmark(run.ROOT), args.workload)
    caught = runs = 0
    for name in args.faults:
        for seed in args.seeds:
            result, notes, _ = run.execute(cell, seed, args.seconds, False,
                                           wrap_verify=FAULTS[name])
            for line in notes[-6:]:
                print(f"[{name} seed {seed}] {line}", flush=True)
            print(json.dumps({"fault": name, "seed": seed, "correct": result["correct"],
                              "check": result["check"]}), flush=True)
            caught += not result["correct"]
            runs += 1
    print(f"faults: {caught} of {runs} runs came out not correct", flush=True)
    return 0 if caught == runs else 1


if __name__ == "__main__":
    sys.exit(main())
