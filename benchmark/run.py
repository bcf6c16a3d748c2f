#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``lighthouse_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload mainnet-2p20.aggregates --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The cell, its configuration and its mix are
read from ``BENCHMARK.json`` by name (``harness/spec.py``). A run:

1. set-up: CUDA start; the registry (walked from the configuration's base
   secret key, kept in ``benchmark/.cache/`` after the first build); the
   program's pubkey cache uploaded to the card; one verify call at each
   padded shape the mix can give the program; the seed's payloads signed in
   worker processes meanwhile;
2. the window: the program's ``FirehoseEngine`` over its
   ``verify_indexed_sets_device`` and the resident cache, driven by the mix
   for ``--seconds`` (with ``--trace 1`` under the device profiler), then the
   wait for verdicts still owed;
3. the check: the reference judges the sampled payloads, in worker
   processes, and every verdict delivered for them is compared
   (``harness/check.py``).

Standard output's last line is the result: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the trace's
device times. Standard error ends with each number compared beside its
limit. The run exits non-zero and prints no result when the card is missing,
when fewer cards are visible than the cell asks for, or when a module of JAX,
of ``lighthouse_tpu`` or ``bench.py`` was loaded.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import check, fixtures, guard, spec  # noqa: E402
from benchmark.harness import traffic as tg  # noqa: E402
from benchmark.harness.drive import Recorder, make_engine, run_window  # noqa: E402
from benchmark.harness.readings import Context  # noqa: E402

MAX_WORKERS = 8


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def look_for_cards(chips: int) -> str | None:
    """None when ``chips`` CUDA devices are visible, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA device(s) visible, the cell asks for {chips}"
    return None


def _pool(workers: int):
    if workers <= 0:
        return None
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(workers)


def execute(cell, seed: int, seconds: float, trace: bool, device=None, workers=None,
            wrap_verify=None, verifier=None, warm=True) -> tuple:
    """One run of ``cell``: (the result object, the lines for standard
    error, the window). ``device`` defaults to CUDA. ``wrap_verify(inner)`` wraps the
    program's verify call (the tests' faults); ``verifier(raw)`` replaces it
    (the control); ``warm=False`` skips the warm-up (the tests' stand-ins)."""
    notes = []
    split = {}
    cfg, params = cell.config, cell.params
    sk0 = int(cfg["base_secret_key"], 0)
    if workers is None:
        workers = min(MAX_WORKERS, os.cpu_count() or 1)
    split["start_and_imports_s"] = time.monotonic() - T_PROCESS
    pool = _pool(workers)
    try:
        t = time.monotonic()
        raw, reg_built = fixtures.registry(cfg["validators"], sk0, CACHE, pool)
        split["registry_built_s" if reg_built else "registry_loaded_s"] = time.monotonic() - t
        t = time.monotonic()
        traffic = tg.plan(cfg, params, seed, seconds, max(1, workers))
        split["plan_s"] = time.monotonic() - t
        pending = (pool.map_async(fixtures.sign_job, traffic.jobs) if pool is not None
                   else [fixtures.sign_job(j) for j in traffic.jobs])

        t = time.monotonic()
        import torch

        from lighthouse_tpu_torch.bls import backend, pubkey_cache
        from lighthouse_tpu_torch.ops.bls import fq
        from lighthouse_tpu_torch.ops.bls import fused_mul as fm

        dev = torch.device(device or "cuda")
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.init()
            torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
        split["cuda_start_s"] = time.monotonic() - t

        t = time.monotonic()
        cache = pubkey_cache.device_pubkeys_from_raw(raw, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        split["cache_upload_s"] = time.monotonic() - t

        t = time.monotonic()
        builds_before = dict(fq.builds)
        warm_rng = tg.rng_for(seed ^ 0x5EED)
        for n in traffic.warm_sizes() if warm else ():
            backend.verify_indexed_sets_device(cache, tg.warm_items(traffic, cfg, n, warm_rng),
                                               device=dev)
        split["warmup_s"] = time.monotonic() - t
        built_now = {k: v - builds_before.get(k, 0) for k, v in fq.builds.items()
                     if v - builds_before.get(k, 0)}

        t = time.monotonic()
        results = pending.get() if pool is not None else pending
        if pool is not None:
            pool.close()
            pool.join()
            pool = None
        traffic.attach(results)
        split["fixtures_wait_s"] = time.monotonic() - t
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()

    if verifier is not None:
        inner = verifier(raw)
    else:
        def inner(items):
            return backend.verify_indexed_sets_device(cache, items, device=dev)
    if wrap_verify is not None:
        inner = wrap_verify(inner)

    recorder = Recorder(traffic)
    host_half = []
    prepare_batch = backend.prepare_batch

    def timed_prepare_batch(*a, **k):
        t0 = time.monotonic()
        try:
            return prepare_batch(*a, **k)
        finally:
            host_half.append((t0, time.monotonic()))

    engine = make_engine(traffic, recorder, inner)
    # the set-up's objects (the registry's pool, the payloads) move out of the
    # collector's sight, so its passes in the window cost what the program's
    # own objects cost
    gc.collect()
    gc.freeze()
    tracer = None
    if trace and cuda:
        from benchmark.harness.trace import DeviceTrace

        tracer = DeviceTrace()
    marks = {}

    def on_start():
        if tracer is not None:
            tracer.start()
        marks["launches"] = fm.launches
        marks["builds"] = dict(fq.builds)
        backend.prepare_batch = timed_prepare_batch

    def on_close():
        marks["launches"] = fm.launches - marks["launches"]
        marks["builds"] = {k: v - marks["builds"].get(k, 0) for k, v in fq.builds.items()
                           if v - marks["builds"].get(k, 0)}

    try:
        window = run_window(engine, traffic, recorder, seconds, on_start, on_close)
    finally:
        backend.prepare_batch = prepare_batch
    setup_s = window.t0 - T_PROCESS
    if tracer is not None:
        t = time.monotonic()
        tracer.stop(window.t0, window.t_end)
        notes.append(f"trace: {len(tracer.events)} device operations in the window, stopped and "
                     f"reduced in {time.monotonic() - t:.2f} s")
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    count = 1 if cuda else 0
    del engine, cache, inner
    if cuda:
        torch.cuda.empty_cache()

    t = time.monotonic()
    pool = _pool(workers)
    try:
        ref = check.reference_verdicts(traffic, raw, pool, workers)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    numbers, compared = check.compare(traffic, window.subs, ref)
    ok = check.verdict(numbers, compared)
    ref_s = time.monotonic() - t

    ctx = Context(cell, traffic, window, recorder, setup_s, marks["launches"], tracer)
    metrics = {}
    for m in (cell.per_layer() if trace else cell.end_to_end()):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    due = [s for s in window.subs if window.t0 <= s.due < window.t_end]
    shed = sum(1 for s in window.subs if not s.accepted)
    unanswered = numbers["unanswered"]
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(mem_peak)}
    result = {"correct": ok, "attempted": len(due), "failed": shed + unanswered +
              numbers["wrong_verdicts"], "metrics": metrics, "device": device}
    if tracer is not None:
        device["busy_s"] = tracer.busy_s()
        device["window_s"] = window.t_end - window.t0
        spans = {
            "verify call: prepare_batch (host half: hash_to_field, parsing, copies)": host_half,
            "verify call: device stages (host dispatch, verdict read)":
                [(c[0], c[1]) for c in recorder.calls],
            "prepare_fn (prep thread) only": recorder.preps,
        }
        result["breakdown"] = {"device_ops": tracer.device_ops(),
                               "idle_gaps": tracer.idle_gaps(spans)}
    result["check"] = check.check_block(numbers)

    built = [k for k, v in (("the kernel library", built_now.get("lib_build")),
                            ("the registry", "registry_built_s" in split)) if v]
    notes.append("setup: " + json.dumps({k: round(v, 4) for k, v in split.items()})
                 + f" total {setup_s:.4f} s"
                 + (f" (a first run in this checkout: it built {' and '.join(built)})" if built else ""))
    notes.append("warm-up builds: " + json.dumps(built_now))
    notes.append("builds inside the window (none expected): " + json.dumps(marks["builds"]))
    lat = sorted(window.lateness)
    if lat:
        notes.append(f"generator lateness ms: p50 {lat[len(lat) // 2] * 1e3:.3f} "
                     f"p95 {lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3:.3f} "
                     f"max {lat[-1] * 1e3:.3f} over {len(lat)} payloads")
    notes.append(f"window: {len(window.subs)} submitted, {len(due)} due in the window, "
                 f"{shed} shed at the intake, {len(recorder.calls)} verify calls, "
                 f"{sum(1 for c in recorder.calls if not c[5])} of them False")
    durs = sorted(c[1] - c[0] for c in recorder.calls if c[5])
    if durs:
        q = [durs[min(len(durs) - 1, int(f * len(durs)))] * 1e3 for f in (0.1, 0.5, 0.9)]
        notes.append(f"verify calls that returned True, ms: p10 {q[0]:.1f} p50 {q[1]:.1f} "
                     f"p90 {q[2]:.1f} over {len(durs)}")
        thirds = []
        for k in range(3):
            a = window.t0 + k * window.seconds / 3
            part = sorted(c[1] - c[0] for c in recorder.calls
                          if c[5] and a <= c[0] < a + window.seconds / 3)
            thirds.append(f"{part[len(part) // 2] * 1e3:.1f}" if part else "-")
        notes.append("their p50 ms by thirds of the window: " + " ".join(thirds))
    notes.append(f"reference: {len(ref)} sampled payloads judged in {ref_s:.2f} s, "
                 f"{compared} delivered verdicts compared")
    for k, v in check.check_block(numbers).items():
        notes.append(f"check {k}: {v['value']} (limit {v['limit']})")
    return result, notes, window


def main(argv=None) -> int:
    args = parse(argv)
    guard.cache_env(CACHE)
    cell = spec.Cell(spec.benchmark(ROOT), args.workload)
    why_not = look_for_cards(cell.chips)
    if why_not is not None:
        log(f"benchmark: no run: {why_not}")
        return 3
    import lighthouse_tpu_torch  # noqa: F401  (the program: a checkout without it fails here)
    result, notes, _ = execute(cell, args.seed, args.seconds, bool(args.trace))
    bad = guard.forbidden_loaded()
    if bad:
        log(f"benchmark: no result: forbidden modules loaded: {', '.join(bad)}")
        return 4
    for line in notes:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
