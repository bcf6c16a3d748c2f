#!/usr/bin/env python3
"""The control of the check that decides ``correct``: the reference put in the
program's place with one guarantee broken, run through a whole cell.

    python3 benchmark/tools/control.py --workload mainnet-2p20.aggregates --seconds 30 --seeds 11 12 13

The control verifier judges a batch by the reference's ``well_formed_set``
on every set: the signature decodes into G2's subgroup and the keys
aggregate, but the pairing equation is left out. That breaks the
configurations' guarantee that every invalid set is rejected (a signature
over another message passes), the shortcut a change to the verify path
would be tempted by. Everything else is the cell's own run: its set-up, its
mix at its own load, the window, the wait and the check. Each seed prints
the numbers compared beside their limits; the tool exits 0 only when every
seed's run comes out not correct.
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
from benchmark.reference import bls as rb  # noqa: E402


def control_verifier(raw):
    hashes = rb.HashCache()

    def verify(items):
        return all(rb.well_formed_set(raw, ix, m, s, hashes) for ix, m, s in items)

    return verify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    guard.cache_env(run.CACHE)
    cell = spec.Cell(spec.benchmark(run.ROOT), args.workload)
    caught = 0
    for seed in args.seeds:
        result, notes, _ = run.execute(cell, seed, args.seconds, False, device=args.device,
                                       verifier=control_verifier, warm=False)
        for line in notes:
            print(f"[seed {seed}] {line}", flush=True)
        print(json.dumps({"seed": seed, "correct": result["correct"], "check": result["check"]}),
              flush=True)
        caught += not result["correct"]
    print(f"control: {caught} of {len(args.seeds)} runs came out not correct", flush=True)
    return 0 if caught == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
