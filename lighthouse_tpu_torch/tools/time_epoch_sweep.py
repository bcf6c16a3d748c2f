#!/usr/bin/env python3
"""Time a checkout's single-device epoch sweep on one CUDA card.

    cd <checkout> && python3 <this file> [--validators N] [--reps R] [--out OUT.json]

The script runs from the root of any checkout of the port and imports THAT
checkout's ``lighthouse_tpu_torch``, so the same file times two commits on
the same card (run it in each checkout, in the order parent, change,
change, parent). It builds the electra mainnet state of ``chip_smoke.py``'s
phase 11 (``_epoch_state`` of this file's own checkout: N validators, the
pubkeys unique byte strings, every sync-committee member the generator,
neither of which the epoch sweep reads), then drives the engine's device
region (``epoch_engine.engine._device_sweep``: mirror sync, column upload,
the sweep, a synchronize; it leaves the state untouched, so it repeats on
the same state) once to bind the mirror and R times timed. It prints one
JSON object: per call, the device region's wall time and the sweep alone
(``run_sweep`` on the arguments the engine gave it, between CUDA events),
median, min and max, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _spread(xs: list) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--validators", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    sys.path.insert(0, os.getcwd())  # the checkout's package, not this file's
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_epoch_sweep: no CUDA card", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.epoch_engine import engine
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.types.spec import mainnet_spec

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import chip_smoke  # this file's checkout: the state builder of phase 11

    n = args.validators
    raw = np.zeros((n, 96), dtype=np.uint8)
    raw[:, :48] = np.frombuffer(oc.G1_X.to_bytes(48, "big"), dtype=np.uint8)
    raw[:, 48:] = np.frombuffer(oc.G1_Y.to_bytes(48, "big"), dtype=np.uint8)
    comp = [b"\xa0" + i.to_bytes(47, "big") for i in range(n)]
    spec = mainnet_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                        deneb_fork_epoch=0, electra_fork_epoch=0)
    t = time.time()
    state, _ = chip_smoke._epoch_state(spec, raw, comp, np.random.default_rng(7))
    build_s = time.time() - t
    dev = torch.device("cuda", 0)

    captured = []
    run_sweep = engine.run_sweep

    def capture(*a):
        if not captured:
            captured.append(a)
        return run_sweep(*a)

    engine.run_sweep = capture
    t = time.time()
    engine._device_sweep(spec, state, dev)  # binds the mirror
    bind_s = time.time() - t
    region_ms = []
    for _ in range(args.reps):
        t = time.perf_counter()
        engine._device_sweep(spec, state, dev)
        region_ms.append((time.perf_counter() - t) * 1e3)
    engine.run_sweep = run_sweep
    sweep_ms = []
    for _ in range(args.reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        run_sweep(*captured[0])
        e1.record()
        torch.cuda.synchronize()
        sweep_ms.append(e0.elapsed_time(e1))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"checkout": os.getcwd(), "validators": n, "fork": state.fork_name, "reps": args.reps,
           "state_build_s": build_s, "bind_s": bind_s, "device_region_ms": _spread(region_ms),
           "run_sweep_ms": _spread(sweep_ms), "device_region_all_ms": region_ms,
           "run_sweep_all_ms": sweep_ms, "card": card}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
