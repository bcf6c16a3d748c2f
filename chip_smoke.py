#!/usr/bin/env python3
"""Drive lighthouse_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py                  # the full configuration (below)
    python3 chip_smoke.py --validators 4096 --sets 8 --keys 16 --batches 1

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. build the fused field-multiply kernel (csrc/fused_mul.cu, nvcc, sm_90a);
  2. build the fixture with the port's pure-Python oracle: a registry of
     consecutive secret keys (pk_i = pk_{i-1} + G in Jacobian coordinates,
     one batched normalisation), cached as .npz under .fixture_cache/, and
     per-set aggregate signatures signed by the oracle;
  3. one warm-up batch through the main path, recording the shapes the path
     gives the kernel;
  4. each kernel entry (K1 fused_mul, K2 fused_mul lazy, K3 execute_plan on
     MUL12, CYC_SQR, a curve add plan, a Miller line plan) launched at those
     shapes and held bit-exact against its plain PyTorch version, timed
     beside its bound;
  5. the main path: counts set to 0, timed valid batches (each must verify
     True) and one batch with a poisoned signature (must give False), counts
     read; every kernel entry must have launched, the plain version never;
  6. the h2c stage's message points held against the oracle's
     hash_to_curve on the first messages.

Full configuration (mainnet gossip): 2^20 validator pubkeys resident as the
[N, 3, 25] cache, batches of 64 aggregate signature sets, 512 keys per set,
4 timed batches. The last line of stdout is the result object; the line
before it the kernel table; before that the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, ".fixture_cache")
H100_BYTES_PER_S = 3.35e12
# int32 multiply-add rate outside the tensor cores: an H100 SM has half as
# many INT32 lanes as FP32 lanes, so half the 67 TFLOP/s fp32 peak
H100_INT32_OPS_PER_S = 33.5e12


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------------------
# Fixture (pure-Python oracle; signatures never come from the port's own code)
# --------------------------------------------------------------------------------------


def _registry(n: int, sk0: int):
    """Affine pubkeys of secret keys sk0 .. sk0+n-1 as raw [n, 96] bytes."""
    import numpy as np

    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import P

    path = os.path.join(FIXTURE_DIR, f"registry_{n}_{sk0:x}.npz")
    if os.path.exists(path):
        return np.load(path)["raw"]
    gx, gy = oc.g1_generator()
    x1, y1 = oc.g1_mul((gx, gy), sk0)
    X, Y, Z = [x1], [y1], [1]
    for _ in range(n - 1):
        # mixed Jacobian + affine G addition (add-2007-bl madd, a = 0)
        x, y, z = X[-1], Y[-1], Z[-1]
        zz = z * z % P
        u2 = gx * zz % P
        s2 = gy * z % P * zz % P
        h = (u2 - x) % P
        if h == 0:
            raise ValueError("registry walk hit the generator")
        hh = h * h % P
        i4 = 4 * hh % P
        j = h * i4 % P
        r = 2 * (s2 - y) % P
        v = x * i4 % P
        x3 = (r * r - j - 2 * v) % P
        y3 = (r * (v - x3) - 2 * y * j) % P
        z3 = ((z + h) * (z + h) - zz - hh) % P
        X.append(x3)
        Y.append(y3)
        Z.append(z3)
    # one batched normalisation (Montgomery's trick)
    pref = [0] * n
    acc = 1
    for i in range(n):
        acc = acc * Z[i] % P
        pref[i] = acc
    inv = pow(acc, P - 2, P)
    xs = bytearray()
    ys = bytearray()
    out_x = [0] * n
    out_y = [0] * n
    for i in range(n - 1, -1, -1):
        zi = inv * pref[i - 1] % P if i else inv
        inv = inv * Z[i] % P
        zi2 = zi * zi % P
        out_x[i] = X[i] * zi2 % P
        out_y[i] = Y[i] * zi2 % P * zi % P
    for i in range(n):
        xs += out_x[i].to_bytes(48, "big")
        ys += out_y[i].to_bytes(48, "big")
    raw = np.concatenate(
        [np.frombuffer(bytes(xs), np.uint8).reshape(n, 48),
         np.frombuffer(bytes(ys), np.uint8).reshape(n, 48)],
        axis=1,
    )
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    np.savez(path, raw=raw)
    return raw


def _batch(rng, n_val: int, sk0: int, n_sets: int, k: int, poison: bool = False):
    """n_sets (indices, message, signature bytes) triples signed by the oracle
    with each set's aggregate secret key; ``poison`` swaps in a signature of
    another message for set 0."""
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    items = []
    for s in range(n_sets):
        idx = rng.choice(n_val, size=k, replace=False)
        msg = rng.bytes(32)
        agg_sk = (k * sk0 + int(idx.sum())) % R
        msg_signed = rng.bytes(32) if (poison and s == 0) else msg
        items.append(([int(i) for i in idx], msg, oc.g2_compress(cs.sign(agg_sk, msg_signed))))
    return items


# --------------------------------------------------------------------------------------
# Kernel checks
# --------------------------------------------------------------------------------------


def _sched_ops(sched, rows: int):
    """(int32 operations, bytes) the kernel's function needs at ``rows``:
    each input read once, each output written once."""
    L, w = sched.L, 101
    mac = L * 2601

    def replay(ops, planes, w):
        n = 0
        for op in ops:
            if op[0] == "split":
                n += planes * (w + 1) * 2
                w += 1
            elif op[0] == "trim":
                w = op[1]
            else:
                n += planes * 48 * op[1]
                w = 48
        return n, w

    n, w = replay(sched.pre_ops, L, w)
    mac += n
    if sched.has_out:
        nin = L + sched.n_pass
        mac += sched.R * w * nin * (2 if sched.has_neg else 1)
        n, w = replay(sched.post_ops, sched.R, w)
        mac += n
    nbytes = rows * (2 * L + sched.n_pass + sched.R) * 25 * 8
    return 2 * mac * rows, nbytes


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


def _time_graph(fn, reps: int) -> float:
    """Device time per call of ``fn`` (kernel launches only): ``reps`` calls
    captured in one CUDA graph and replayed, so the host's enqueue cost of
    each launch stays out of the number."""
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


def _kernel_inputs(sched, prep, rows: int, gen, dev):
    """Kernel operands at ``rows``: random canonical inputs through the
    entry's own input lincombs, plus one edge row of maximal limbs."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fq, plans

    def canon(n_el):
        limbs = torch.randint(0, 1 << 16, (rows, n_el, 25), generator=gen, dtype=torch.int64)
        limbs[..., 23] &= 0x0FFF   # value < 2^380 < p
        limbs[..., 24] = 0
        return limbs.to(dev)

    if prep is None:  # K1 / K2: operands straight into the kernel
        lazy = sched.kind == "K2"
        lim = fq.CHAIN_LIMB_TARGET if lazy else fq._IN_LIMB
        vlim = fq.CHAIN_VALUE_LIMIT if lazy else fq._IN_VALUE
        A, B = canon(1), canon(1)
        edge = edge_limbs(lim, vlim - 1)
        A[0, 0] = torch.tensor(edge, device=dev)
        B[0, 0] = torch.tensor(edge, device=dev)
        return A, B, None
    n_a = prep.lin_a[0].shape[1]
    n_b = prep.plan.n_b
    a, b = canon(n_a), canon(n_b)
    A = plans.apply_tables(prep.lin_a, a)
    B = plans.apply_tables(prep.lin_b, plans.append_const_pool(prep.plan, b))
    return A.contiguous(), B.contiguous(), (a.contiguous() if sched.n_pass else None)


def edge_limbs(lim: int, value_max: int) -> list[int]:
    """Limbs as large as the budget allows: limbs 0..22 at ``lim``, the top
    two filled greedily up to value ``value_max``."""
    edge = [lim] * 23
    room = value_max - sum(v << (16 * i) for i, v in enumerate(edge))
    l24 = min(lim, room >> 384)
    l23 = min(lim, (room - (l24 << 384)) >> 368)
    return edge + [l23, l24]


def kernel_checks(shapes: dict, dev) -> list:
    """K1, K2 and K3 entries at the path's shapes: bit-exact against the plain
    version on the card; kernel and plain times; bounds."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    gen = torch.Generator().manual_seed(20261017)
    preps = {p.sched.name: p for p in fm._PLAN_CACHE.values()}
    targets = [
        ("K1", "pallas_mul", None),
        ("K2", "pallas_mul_lazy", None),
        ("K3", "fq12_mul_c", "MUL12"),
        ("K3", "cyc_sqr_c", "CYC_SQR"),
        ("K3", "g2add1", "curve add (G2, level 1)"),
        ("K3", "mldbl2", "Miller doubling line (level 2, pass-through)"),
    ]
    rows_out = []
    for kind, name, label in targets:
        seen = {r: c for (k, n, r), c in shapes.items() if k == kind and n == name}
        if not seen:
            raise RuntimeError(f"{kind} {name}: not launched by the main path")
        rows = max(seen, key=lambda r: (seen[r], r))
        if kind == "K3":
            prep = preps[name]
            sched = prep.sched
        else:
            prep = None
            sched = fm.mul_schedule(kind == "K2")
        A, B, Ain = _kernel_inputs(sched, prep, rows, gen, dev)
        got = fm.cuda_fused(sched, A, B, Ain)
        torch.cuda.synchronize()
        want = fm.plain_fused(sched, A, B, Ain)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        if err != 0:
            raise RuntimeError(f"{kind} {name} rows={rows}: kernel != plain (max |diff| {err})")
        ms = _time_graph(lambda: fm.cuda_fused(sched, A, B, Ain), 100)
        host_ms = _time(lambda: fm.cuda_fused(sched, A, B, Ain), 200)
        plain_ms = _time(lambda: fm.plain_fused(sched, A, B, Ain), 20)
        n_ops, n_bytes = _sched_ops(sched, rows)
        t_ops = n_ops / H100_INT32_OPS_PER_S * 1e3
        t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        rows_out.append({
            "kind": kind, "name": name, "label": label or name, "rows": rows,
            "lanes": sched.L, "out_rows": sched.R, "n_pass": sched.n_pass,
            "max_abs_err": err, "ms": ms, "launch_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "int32_ops": n_ops, "bytes": n_bytes,
        })
        log(f"kernel {kind} {name} rows={rows} L={sched.L} R={sched.R}: exact; "
            f"{ms:.4f} ms kernel (graph replay), {host_ms:.4f} ms per launch from Python, "
            f"{plain_ms:.4f} ms plain, bound {max(t_ops, t_bytes):.6f} ms")
    return rows_out


# --------------------------------------------------------------------------------------
# Main
# --------------------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--validators", type=int, default=1 << 20)
    ap.add_argument("--sets", type=int, default=64)
    ap.add_argument("--keys", type=int, default=512)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "lighthouse_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.ops.bls import fq, fused_mul as fm
    from lighthouse_tpu_torch.oracle import hash_to_curve as oh
    from lighthouse_tpu_torch.oracle.ciphersuite import DST

    dev = torch.device("cuda")
    t_start = time.time()

    # 1. build
    t = time.time()
    fm.build(verbose=True)
    log(f"build: {time.time() - t:.2f} s")

    # 2. fixture
    rng = np.random.default_rng(args.seed)
    sk0 = int(rng.integers(1 << 62)) | 1
    t = time.time()
    raw = _registry(args.validators, sk0)
    log(f"fixture registry: {args.validators} keys in {time.time() - t:.2f} s")
    t = time.time()
    n_b = args.batches + 2  # warm-up, timed, poisoned
    batches = [_batch(rng, args.validators, sk0, args.sets, args.keys) for _ in range(n_b - 1)]
    poisoned = _batch(rng, args.validators, sk0, args.sets, args.keys, poison=True)
    log(f"fixture signatures: {n_b * args.sets} sets in {time.time() - t:.2f} s")
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device=dev)
    torch.cuda.synchronize()

    # 3. warm-up batch (schedules derived and cached; path shapes recorded)
    fm.reset_counts()
    t = time.time()
    if not backend.verify_indexed_sets_device(cache, batches[0], device=dev):
        raise RuntimeError("warm-up batch did not verify")
    torch.cuda.synchronize()
    log(f"warm-up batch: {time.time() - t:.2f} s")
    shapes = dict(fm.launch_log)

    # 4. kernels against their plain versions at the path's shapes
    krows = kernel_checks(shapes, dev)

    # 5. the main path
    torch.cuda.reset_peak_memory_stats()
    stage_ms = {"host": 0.0, "h2c": 0.0, "prep": 0.0, "pair": 0.0}
    fm.reset_counts()
    t_main = time.time()
    for items in batches[1:]:
        t = time.time()
        b = backend.prepare_batch(items, device=dev)
        torch.cuda.synchronize()
        t1 = time.time()
        mxa, mya = backend.h2c_stage(b["u0"], b["u1"])
        torch.cuda.synchronize()
        t2 = time.time()
        pre = backend.prep_stage(
            cache, b["idx"], b["mask"], b["sxc0"], b["sxc1"], b["s_flag"], b["sig_wf"],
            b["scalars"], b["valid"],
        )
        torch.cuda.synchronize()
        t3 = time.time()
        ok = bool(backend.pair_stage(*pre[:4], mxa, mya, pre[4], b["valid"]))
        t4 = time.time()
        if not ok:
            raise RuntimeError("a valid batch did not verify")
        for k, dt in zip(stage_ms, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            stage_ms[k] += dt * 1e3
    t_valid = time.time() - t_main
    if backend.verify_indexed_sets_device(cache, poisoned, device=dev):
        raise RuntimeError("the poisoned batch verified")
    torch.cuda.synchronize()
    counts = dict(fm.launches_by)
    by_name: dict = {}
    for (kind, name, _rows), c in fm.launch_log.items():
        by_name[(kind, name)] = by_name.get((kind, name), 0) + c
    plain = fm.plain_calls
    total = fm.launches
    peak = torch.cuda.max_memory_allocated()
    n_timed = len(batches) - 1
    if plain != 0:
        raise RuntimeError(f"plain version ran {plain} times on the main path")
    for kind, c in counts.items():
        if c == 0:
            raise RuntimeError(f"kernel entry {kind} never launched on the main path")
    for r in krows:
        if by_name.get((r["kind"], r["name"]), 0) == 0:
            raise RuntimeError(f"{r['kind']} {r['name']} never launched on the main path")
    sets_per_s = n_timed * args.sets / t_valid
    log(f"main path: {n_timed} valid batches of {args.sets} sets x {args.keys} keys "
        f"over {args.validators} validators: {t_valid:.3f} s, {sets_per_s:.2f} sets/s")
    log("ms per batch: " + json.dumps({k: v / n_timed for k, v in stage_ms.items()}))
    log(f"kernel launches per batch: {total / (n_timed + 1):.1f} "
        f"({json.dumps({k: v / (n_timed + 1) for k, v in counts.items()})})")
    log(f"max_memory_allocated: {peak} bytes")

    # 6. the h2c stage against the oracle's hash_to_curve
    msgs = [m for _, m, _ in batches[1][:2]]
    u0, u1 = backend.h2c.hash_to_field_batch(msgs, DST, dev)
    mx, my = backend.h2c_stage(u0, u1)
    for i, m in enumerate(msgs):
        ox, oy = oh.hash_to_curve_g2(m, DST)
        got = [fq.to_int(fq.canonical(v[i, j])) for v in (mx, my) for j in (0, 1)]
        if got != [ox.c0, ox.c1, oy.c0, oy.c1]:
            raise RuntimeError("h2c stage disagrees with the oracle")
    log("h2c stage == oracle hash_to_curve on 2 messages")

    # 7. device busy share: one more valid batch under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        if not backend.verify_indexed_sets_device(cache, batches[1], device=dev):
            raise RuntimeError("the profiled batch did not verify")
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t) * 1e3
    dev_us: dict = {}
    host_ops = 0
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            if e.key.startswith("aten::"):
                host_ops += e.count
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            dev_us[e.key] = dev_us.get(e.key, 0.0) + us
    busy_ms = sum(dev_us.values()) / 1e3
    batch_ms = t_valid * 1e3 / n_timed
    if busy_ms:
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        log(f"device busy per batch: {busy_ms:.3f} ms of {batch_ms:.3f} ms unprofiled "
            f"({prof_wall_ms:.3f} ms profiled): idle share {1 - busy_ms / batch_ms:.4f}")
        log(f"torch (aten) ops dispatched in the profiled batch: {host_ops}")
        for k, us in top:
            log(f"  device time {us / 1e3:9.3f} ms  {k[:100]}")
    else:
        log("device busy share: not measured (the profiler recorded no device time)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed")
    log(f"elapsed: {time.time() - t_start:.1f} s")
    per_kind = {}
    for r in krows:
        per_kind.setdefault(r["kind"], r)
    src = "lighthouse_tpu_torch/csrc/fused_mul.cu"
    repl = {
        "K1": "lighthouse_tpu/ops/bls/pallas_kernels.py:587 (fused_mul, lazy=False -> _build_call:497)",
        "K2": "lighthouse_tpu/ops/bls/pallas_kernels.py:587 (fused_mul, lazy=True -> _build_call:497)",
        "K3": "lighthouse_tpu/ops/bls/pallas_kernels.py:620 (execute_plan -> _build_call:497)",
    }
    table = []
    for r in krows:
        table.append({
            "name": f"{r['kind']} {r['name']}", "route": "cuda", "source": src,
            "replaces": repl[r["kind"]], "launches": by_name[(r["kind"], r["name"])],
            "entry_launches": counts[r["kind"]], "launch_ms": r["launch_ms"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "rows": r["rows"], "lanes": r["lanes"], "out_rows": r["out_rows"],
        })
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
