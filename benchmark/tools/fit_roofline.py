#!/usr/bin/env python3
"""Fit the roofline's work model to the program's kernel launches.

    python3 benchmark/tools/fit_roofline.py --device cuda --shapes 256x512,128x512,64x4 [--write]
    python3 benchmark/tools/fit_roofline.py --device cpu --shapes 4x4,8x4,4x8,8x8

For each shape ``NxK`` (N signature sets of K keys each, so that nothing is
padded) one ``verify_indexed_sets_device`` call runs while every launch of
the program's two hand kernels is counted as modular products: rows times
the schedule's products a row (``L``) for a plan-kernel launch, rows times
the sum over the chain's multiply steps for a chain-kernel launch. On CUDA
the count is also rebuilt from ``fused_mul.launch_log`` and must agree.
The products are fitted as a*N*K + b*N + c by least squares; the residuals
are printed, and ``--write`` stores a, b, c in
``benchmark/metrics/roofline_work.json`` (the other prices there stay),
with the device, the shapes and the residual under ``fitted_at``: a fit on
another device that gives the same constants is added beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark.harness import fixtures  # noqa: E402
from benchmark.reference import curves as oc  # noqa: E402

WORK_JSON = os.path.join(ROOT, "benchmark", "metrics", "roofline_work.json")


def count_products(device: str, n: int, k: int, cache, fm, backend) -> tuple[int, int | None]:
    """(products counted at the wrappers, products from launch_log or None)."""
    import torch

    counted = [0]
    run_fused, run_chain = fm.run_fused, fm.run_chain

    def fused(sched, a, b):
        counted[0] += a.shape[0] * sched.L
        return run_fused(sched, a, b)

    def chain(prog, bases):
        rows = bases.reshape(-1, prog.n_el, bases.shape[-1]).shape[0]
        counted[0] += rows * sum(prog.scheds[d].L for d, *_ in prog.steps if d != fm.COPY)
        return run_chain(prog, bases)

    rng = np.random.default_rng(n * 1000 + k)
    sig = oc.g2_compress(oc.g2_generator())
    items = [(tuple(int(v) for v in rng.integers(cache.shape[0], size=k)), rng.bytes(32), sig)
             for _ in range(n)]
    backend.verify_indexed_sets_device(cache, items, device=device)   # warm: derive schedules
    fm.reset_counts()
    fm.run_fused, fm.run_chain = fused, chain
    try:
        backend.verify_indexed_sets_device(cache, items, device=device)
    finally:
        fm.run_fused, fm.run_chain = run_fused, run_chain
    if device != "cuda":
        return counted[0], None
    torch.cuda.synchronize()
    logged = 0
    for (kind, label, rows), times in fm.launch_log.items():
        if kind == "CHAIN":
            prog = fm.CHAINS[label]
            per = sum(prog.scheds[d].L for d, *_ in prog.steps if d != fm.COPY)
        else:
            per = fm.SCHEDULES[label].L
        logged += times * rows * per
    return counted[0], logged


def fit(points: list) -> tuple:
    """Least-squares a, b, c of products = a*N*K + b*N + c, and residuals."""
    A = np.array([[n * k, n, 1] for n, k, _ in points], dtype=np.float64)
    y = np.array([p for _, _, p in points], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return coef, y - A @ coef


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", required=True, help="comma-separated NxK")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    raw = fixtures.registry_walk((0x1D0C5EED, 64))
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device=args.device)
    points = []
    for shape in args.shapes.split(","):
        n, k = (int(x) for x in shape.lower().split("x"))
        counted, logged = count_products(args.device, n, k, cache, fm, backend)
        if logged is not None and logged != counted:
            print(f"{shape}: wrappers counted {counted}, launch_log gives {logged}", flush=True)
            return 1
        points.append((n, k, counted))
        print(json.dumps({"sets": n, "keys": k, "products": counted}), flush=True)
    coef, res = fit(points)
    a, b, c = (float(x) for x in coef)
    print(json.dumps({"a": a, "b": b, "c": c, "max_abs_residual": float(np.abs(res).max())}),
          flush=True)
    if args.write:
        with open(WORK_JSON) as f:
            work = json.load(f)
        old = work["products"]
        same = all(round(old[k]) == round(v) for k, v in (("a", a), ("b", b), ("c", c)))
        fitted = dict(old["fitted_at"]) if same else {}
        device = torch.cuda.get_device_name(0) if args.device == "cuda" else args.device
        fitted[device] = {"shapes": [[n, k] for n, k, _ in points],
                          "max_abs_residual": float(np.abs(res).max()),
                          "launch_log_agreed": args.device == "cuda"}
        work["products"] = {"a": a, "b": b, "c": c, "fitted_at": fitted}
        with open(WORK_JSON, "w") as f:
            json.dump(work, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
