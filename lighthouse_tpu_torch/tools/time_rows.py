#!/usr/bin/env python3
"""Time a checkout's fused-multiply kernel at every row of a chip_smoke report.

    cd <checkout> && python3 <this file> REPORT.json OUT.json

REPORT.json is what ``chip_smoke.py --report`` wrote: its configuration and
its kernel rows (entry kind, schedule label, rows; K3 rows also carry the
plan signature, the plan cache's key without the plan's id). The script runs
from the root of any checkout of the port, imports THAT checkout's
``lighthouse_tpu_torch`` and ``chip_smoke`` (fixture helpers), drives one
warm-up batch at the report's configuration so that every plan signature is
prepared, and then times, on one CUDA card:

* each K1 / K3 row at the report's row count: the entry (``fused_mul`` or
  ``execute_plan``, whatever that checkout does before and in its launch)
  and its kernel alone (``cuda_fused``: from the lane operands where the
  checkout's kernel takes lanes and leaves the input lincombs to torch,
  from the raw operands where the kernel runs the lincombs itself);
* each chain row: the chain's entry (``fq.inv`` / ``fq.sqrt_candidate``,
  ``tower._sqrt_chain``, ``tower.fq12_cyclotomic_exp_abs_x``), reduce walks
  included, however that checkout runs the chain's steps.

Each number is device time per call from a CUDA graph of the calls (no host
enqueue cost) and, for entries, also per call from Python (events around a
loop of calls). Inputs are random canonical elements (timing only).
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys


def _time_graph(fn, reps: int) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (3 * reps)


def _time(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.ops.bls import fq, fused_mul as fm, plans, tower

    with open(sys.argv[1]) as f:
        report = json.load(f)
    cfg = report["config"]
    dev = torch.device("cuda")
    fm.build()
    rng = np.random.default_rng(cfg["seed"])
    sk0 = int(rng.integers(1 << 62)) | 1
    raw = cs._registry(cfg["validators"], sk0)
    items = cs._batch(rng, cfg["validators"], sk0, cfg["sets"], cfg["keys"])
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device=dev)
    if not backend.verify_indexed_sets_device(cache, items, device=dev):
        raise RuntimeError("warm-up batch did not verify")
    torch.cuda.synchronize()

    lanes_in = "Ain" in inspect.signature(fm.cuda_fused).parameters
    by_sig = {k[1:]: p for k, p in fm._PLAN_CACHE.items()}
    gen = torch.Generator().manual_seed(20261017)

    def canon(*shape):
        x = torch.randint(0, 1 << 16, shape + (25,), generator=gen, dtype=torch.int64)
        x[..., 23] &= 0x0FFF  # value < 2^380 < p
        x[..., 24] = 0
        return x.to(dev)

    def bound(t):
        return None if t is None else plans._Bound(*t)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    out = {"card": card, "lanes_in": lanes_in, "rows": []}
    for r in report["kernels"]:
        kind, name, rows = r["kind"], r["name"], r["rows"]
        row = {"kind": kind, "name": name, "rows": rows}
        if kind == "CHAIN":
            if name == "cyc_exp_abs_x":
                g = canon(rows, 12)
                entry = lambda: tower.fq12_cyclotomic_exp_abs_x(g)  # noqa: E731
            elif name == "fq2_sqrt":
                w = canon(rows // 2, 2)
                entry = lambda: tower._sqrt_chain(w)  # noqa: E731
            else:
                x = canon(rows)
                fn = {"inv": fq.inv, "sqrt_candidate": fq.sqrt_candidate}[name]
                entry = lambda: fn(x)  # noqa: E731
            row["entry_ms"] = _time_graph(entry, 1)
            row["entry_launch_ms"] = _time(entry, 2)
        else:
            if kind == "K1":
                sched = fm.mul_schedule(False)
                a, b = canon(rows, 1), canon(rows, 1)
                entry = lambda: fm.fused_mul(a[:, 0], b[:, 0])  # noqa: E731
                lanes = (a, b, None)
            else:
                prep = by_sig[_tup(r["signature"])]
                sched = prep.sched
                sig = r["signature"]
                a, b = canon(rows, sig[0]), canon(rows, prep.plan.n_b)
                args = (bound(sig[1]), bound(sig[2]), sig[3], bound(sig[4]))
                entry = lambda: fm.execute_plan(prep.plan, a, b, *args)  # noqa: E731
                if lanes_in:
                    A = plans.apply_tables(prep.lin_a, a).contiguous()
                    B = plans.apply_tables(
                        prep.lin_b, plans.append_const_pool(prep.plan, b)
                    ).contiguous()
                    lanes = (A, B, a if sched.n_pass else None)
            kernel = (
                (lambda: fm.cuda_fused(sched, *lanes)) if lanes_in
                else (lambda: fm.cuda_fused(sched, a, b))
            )
            row["kernel_ms"] = _time_graph(kernel, 100)
            row["entry_ms"] = _time_graph(entry, 20)
            row["entry_launch_ms"] = _time(entry, 50)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    with open(sys.argv[2], "w") as f:
        json.dump(out, f, indent=1)
    print(f"time_rows: {len(out['rows'])} rows on {card}", flush=True)
    return 0


def _tup(x):
    """JSON lists back to the nested tuples of a plan cache key."""
    return tuple(_tup(v) for v in x) if isinstance(x, list) else x


if __name__ == "__main__":
    sys.exit(main())
