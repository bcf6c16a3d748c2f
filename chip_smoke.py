#!/usr/bin/env python3
"""Drive lighthouse_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py                  # the full configuration (below)
    python3 chip_smoke.py --validators 4096 --sets 8 --keys 16 --batches 1

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. build the fused field-multiply kernels (csrc/fused_mul.cu: the plan
     kernel and the chain kernel; nvcc, sm_90a);
  2. build the fixture with the port's pure-Python oracle: a registry of
     consecutive secret keys (pk_i = pk_{i-1} + G in Jacobian coordinates,
     one batched normalisation), cached as .npz under .fixture_cache/, and
     per-set aggregate signatures signed by the oracle;
  3. one warm-up batch through the main path, recording the shapes the path
     gives the kernel;
  4. the plan kernel on every schedule the warm-up launched (K1, every K3
     plan signature) at every row count the path gave it, and the chain
     kernel on every chain (Fermat inversion, the Fq2 square-root chain, the
     |x| cyclotomic power), each held bit-exact against its plain PyTorch
     version and timed beside its bound (chains also beside their own step
     loop of plan-kernel launches); cluster sizes 1/2/4/8 at rows 1;
  5. the main path: counts set to 0, timed valid batches (each must verify
     True) and one batch with a poisoned signature (must give False), counts
     read; K1, K3 and the chain kernel must have launched (K2 only inside
     chains), every checked schedule and chain too, the plain version never;
  6. the h2c stage's message points held against the oracle's
     hash_to_curve on the first messages;
  7. one more valid batch under torch.profiler: device busy time, idle
     share, aten ops dispatched, device time by kernel.

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


SRC = "lighthouse_tpu_torch/csrc/fused_mul.cu"
REPLACES = {
    "K1": "lighthouse_tpu/ops/bls/pallas_kernels.py:587 (fused_mul, lazy=False -> _build_call:497)",
    "K3": "lighthouse_tpu/ops/bls/pallas_kernels.py:620 (execute_plan -> _build_call:497)",
    "CHAIN": "lighthouse_tpu/ops/bls/pallas_kernels.py:587/:620 (one _build_call:497 launch per "
             "step of fq.py:887 pow_fixed_scan, tower.py:282 _sqrt_chain, "
             "tower.py:588 fq12_cyclotomic_exp_abs_x)",
}


def _replay_ops(ops, planes: int, w: int):
    """(multiply-adds, final width) of a split/trim/fold schedule."""
    n = 0
    for op in ops:
        if op[0] == "split":
            n += planes * (w + 1)
            w += 1
        elif op[0] == "trim":
            w = op[1]
        else:
            n += planes * 48 * op[1]
            w = 48
    return n, w


def _step_ops(sched) -> int:
    """int32 operations of one plan step on one row (a multiply-add counts
    two): the input lincombs' nonzero terms (int64 multiply-adds, counted as
    int32 ones so the bound stays a lower bound), the 51x51 digit conv, the
    schedule ops and the output map's nonzero terms."""
    terms = [int((pos != neg).sum()) for pos, neg, _ in (sched.lin_a, sched.lin_b)]
    mac = 25 * sum(terms) + sched.L * 2601
    n, w = _replay_ops(sched.pre_ops, sched.L, 101)
    mac += n
    if sched.has_out:
        mac += w * int((sched.mpos != sched.mneg).sum())
        mac += _replay_ops(sched.post_ops, sched.R, w)[0]
    return 2 * mac


def _bound(n_ops: int, n_bytes: int):
    t_ops = n_ops / H100_INT32_OPS_PER_S * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def edge_limbs(lim: int, value_max: int, top: int) -> list[int]:
    """Limbs as large as the budget allows: limbs 0..22 at ``lim``, the top
    two filled greedily up to value ``value_max`` (limb 24 at most ``top``)."""
    edge = [lim] * 23
    room = value_max - sum(v << (16 * i) for i, v in enumerate(edge))
    l24 = min(lim, room >> 384, top)
    l23 = min(lim, (room - (l24 << 384)) >> 368)
    return edge + [l23, l24]


def _operand(rows: int, n_el: int, bound, gen, dev):
    """Random canonical elements, with row 0 at the bound's maxima."""
    import torch

    x = torch.randint(0, 1 << 16, (rows, n_el, 25), generator=gen, dtype=torch.int64)
    x[..., 23] &= 0x0FFF   # value < 2^380 < p
    x[..., 24] = 0
    x[0] = torch.tensor(edge_limbs(*bound), dtype=torch.int64)
    return x.to(dev)


def _check_layouts(sched=None, prog=None, C: int = 1) -> None:
    """The host's shared-memory sizes equal the CUDA source's own layout
    (lh_plan_smem_bytes / lh_chain_smem_bytes) at cluster size C."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    lib = fm._lib()
    if sched is not None:
        want = lib.lh_plan_smem_bytes(
            sched.n_a, sched.n_b, sched.L, sched.lanes_per_cta(C), sched.wmax, C,
            sched.threads(C),
        )
        got, what = sched.smem_bytes(C), sched.label
    else:
        threads, lane_words, all_words, got = prog.launch_shape(C)
        want = lib.lh_chain_smem_bytes(prog.n_state, prog.n_el, lane_words, all_words, threads)
        what = prog.name
    if got != want:
        raise RuntimeError(f"{what} C={C}: host smem {got} != the kernel's layout {want}")


def _signature(sched):
    """The plan cache's key of a K3 schedule without the plan's id: (n_a,
    bound keys of a and b, name, output bound key); None for K1."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    for key, prep in fm._PLAN_CACHE.items():
        if prep.sched is sched:
            return key[1:]
    return None


def plan_checks(shapes: dict, dev, gen) -> list:
    """The plan kernel on every schedule the warm-up batch launched: held
    bit-exact against ``plain_plan`` at every row count the path gave it, and
    timed at its most-launched row count beside its bound."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    by_label: dict = {}
    for (kind, label, rows), c in shapes.items():
        if kind in ("K1", "K2", "K3"):
            by_label.setdefault(label, {})[rows] = c
    out = []
    for label in sorted(by_label, key=lambda lb: -sum(by_label[lb].values())):
        sched = fm.SCHEDULES[label]
        seen = by_label[label]
        for rows in sorted(seen):
            a = _operand(rows, sched.n_a, sched.in_bounds[0], gen, dev)
            b = _operand(rows, sched.n_b, sched.in_bounds[1], gen, dev)
            got = fm.cuda_fused(sched, a, b)
            torch.cuda.synchronize()
            err = int((got - fm.plain_plan(sched, a, b)).abs().max().item())
            if err != 0:
                raise RuntimeError(f"{label} rows={rows}: plan kernel != plain (max |diff| {err})")
        rows = max(seen, key=lambda r: (seen[r], r))
        a = _operand(rows, sched.n_a, sched.in_bounds[0], gen, dev)
        b = _operand(rows, sched.n_b, sched.in_bounds[1], gen, dev)
        C = fm.cluster_size(rows, sched.L) if sched.has_out else 1
        _check_layouts(sched=sched, C=C)
        ms = _time_graph(lambda: fm.cuda_fused(sched, a, b), 100)
        host_ms = _time(lambda: fm.cuda_fused(sched, a, b), 100)
        plain_ms = _time(lambda: fm.plain_plan(sched, a, b), 10)
        n_bytes = rows * (sched.n_a + sched.n_b + sched.R) * 200 + sched.ints.nbytes + sched.i64.nbytes
        bound_ms, bound_by = _bound(rows * _step_ops(sched), n_bytes)
        out.append({
            "kind": sched.kind, "name": label, "rows": rows, "lanes": sched.L,
            "out_rows": sched.R, "n_pass": sched.n_pass, "cluster": C,
            "threads": sched.threads(C), "smem": sched.smem_bytes(C), "max_abs_err": 0,
            "ms": ms, "launch_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shapes": {str(r): c for r, c in sorted(seen.items())},
            "signature": _signature(sched),
        })
        log(f"plan {sched.kind} {label} rows={rows} L={sched.L} R={sched.R} C={C}: exact at "
            f"rows {sorted(seen)}; {ms:.5f} ms kernel (graph), {host_ms:.5f} ms per launch "
            f"from Python, {plain_ms:.3f} ms plain, bound {bound_ms:.7f} ms ({bound_by})")
    return out


def chain_checks(shapes: dict, dev, gen) -> list:
    """The chain kernel on every chain the warm-up batch launched: held
    bit-exact against ``plain_chain`` at the path's rows, timed beside its
    bound (the sum of its steps) and beside its own step loop."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    out = []
    for (kind, name, rows), c in sorted(shapes.items(), key=lambda kv: kv[0][1:]):
        if kind != "CHAIN":
            continue
        prog = fm.CHAINS[name]
        base = _operand(rows, prog.n_el, prog.scheds[0].in_bounds[0], gen, dev)
        got = fm.cuda_chain(prog, base)
        torch.cuda.synchronize()
        err = int((got - fm.plain_chain(prog, base)).abs().max().item())
        if err != 0:
            raise RuntimeError(f"chain {name} rows={rows}: chain kernel != plain (max |diff| {err})")
        C = prog.cluster(rows)
        _check_layouts(prog=prog, C=C)
        ms = _time_graph(lambda: fm.cuda_chain(prog, base), 5)
        host_ms = _time(lambda: fm.cuda_chain(prog, base), 5)
        # the same chain as one plan-kernel launch per step
        step_ms = _time_graph(lambda: fm.replay_chain(prog, base, fm.cuda_fused), 1)
        step_host_ms = _time(lambda: fm.replay_chain(prog, base, fm.cuda_fused), 1)
        plain_ms = _time(lambda: fm.plain_chain(prog, base), 1)
        n_ops = rows * sum(_step_ops(prog.scheds[d]) for d, *_ in prog.steps if d != fm.COPY)
        n_bytes = rows * prog.n_el * 200 * 2 + prog.prog.nbytes
        bound_ms, bound_by = _bound(n_ops, n_bytes)
        threads, _, _, smem = prog.launch_shape(C)
        out.append({
            "kind": "CHAIN", "name": name, "rows": rows, "lanes": max(s.L for s in prog.scheds),
            "out_rows": prog.n_el, "n_pass": 0, "cluster": C, "threads": threads,
            "smem": smem, "steps": len(prog.steps), "mults": prog.n_mults, "max_abs_err": err,
            "ms": ms, "launch_ms": host_ms, "step_loop_ms": step_ms,
            "step_loop_launch_ms": step_host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shapes": {str(rows): c},
        })
        log(f"chain {name} rows={rows} C={C} ({prog.n_mults} multiplies): exact; {ms:.4f} ms "
            f"kernel (graph), {host_ms:.4f} ms from Python; step loop {step_ms:.4f} ms (graph), "
            f"{step_host_ms:.4f} ms from Python; {plain_ms:.1f} ms plain; bound "
            f"{bound_ms:.6f} ms ({bound_by})")
    return out


def cluster_checks(dev, gen) -> list:
    """Cluster sizes 1, 2, 4 and 8 at rows 1 (the final exponentiation's
    shape): MUL12 and CYC_SQR through the plan kernel and the |x| chain,
    each bit-exact against its plain version and timed."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    out = []
    for label in ("fq12_mul_c", "cyc_sqr_c"):
        sched = fm.SCHEDULES[label]
        a = _operand(1, sched.n_a, sched.in_bounds[0], gen, dev)
        b = _operand(1, sched.n_b, sched.in_bounds[1], gen, dev)
        want = fm.plain_plan(sched, a, b)
        for C in (1, 2, 4, 8):
            _check_layouts(sched=sched, C=C)
            got = fm.cuda_fused(sched, a, b, cluster=C)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} cluster {C}: plan kernel != plain")
            ms = _time_graph(lambda: fm.cuda_fused(sched, a, b, cluster=C), 100)
            out.append({"name": label, "cluster": C, "ms": ms})
    prog = fm.CHAINS["cyc_exp_abs_x"]
    base = _operand(1, 12, prog.scheds[0].in_bounds[0], gen, dev)
    want = fm.plain_chain(prog, base)
    for C in (1, 2, 4, 8):
        _check_layouts(prog=prog, C=C)
        got = fm.cuda_chain(prog, base, cluster=C)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"cyc_exp_abs_x cluster {C}: chain kernel != plain")
        ms = _time_graph(lambda: fm.cuda_chain(prog, base, cluster=C), 5)
        out.append({"name": "cyc_exp_abs_x", "cluster": C, "ms": ms})
    log("cluster sizes 1/2/4/8 at rows 1, all exact: " + ", ".join(
        f"{r['name']} C={r['cluster']} {r['ms']:.5f} ms" for r in out))
    return out


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
    ap.add_argument("--report", default=None,
                    help="also write every measurement as JSON to this path")
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
    gen = torch.Generator().manual_seed(20261017)
    prows = plan_checks(shapes, dev, gen)
    crows = chain_checks(shapes, dev, gen)
    clusters = cluster_checks(dev, gen)
    krows = prows + crows

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
    for kind in ("K1", "K3", "CHAIN"):
        if counts[kind] == 0:
            raise RuntimeError(f"kernel entry {kind} never launched on the main path")
    if counts["K2"] != 0:
        raise RuntimeError("K2 launched outside a chain on the main path")
    for r in krows:
        if by_name.get((r["kind"], r["name"]), 0) == 0:
            raise RuntimeError(f"{r['kind']} {r['name']} never launched on the main path")
    sets_per_s = n_timed * args.sets / t_valid
    log(f"main path: {n_timed} valid batches of {args.sets} sets x {args.keys} keys "
        f"over {args.validators} validators: {t_valid:.3f} s, {sets_per_s:.2f} sets/s")
    log("ms per batch: " + json.dumps({k: v / n_timed for k, v in stage_ms.items()}))
    per_batch = {k: v / (n_timed + 1) for k, v in counts.items()}
    log(f"kernel launches per batch: {total / (n_timed + 1):.1f} ({json.dumps(per_batch)})")
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
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    if busy_ms:
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
    table = []
    for r in krows:
        kernel = "chain_kernel" if r["kind"] == "CHAIN" else "plan_kernel"
        table.append({
            "name": f"{kernel} {r['kind']} {r['name']}", "route": "cuda", "source": SRC,
            "replaces": REPLACES[r["kind"]], "launches": by_name[(r["kind"], r["name"])],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "rows": r["rows"], "lanes": r["lanes"], "out_rows": r["out_rows"],
            "cluster": r["cluster"], "launch_ms": r["launch_ms"],
        })
    if args.report:
        with open(args.report, "w") as f:
            json.dump({
                "card": smi.stdout.strip(), "config": vars(args), "sets_per_s": sets_per_s,
                "ms_per_batch": {k: v / n_timed for k, v in stage_ms.items()},
                "launches_per_batch": total / (n_timed + 1), "launches_by": per_batch,
                "busy_ms": busy_ms, "batch_ms": batch_ms, "aten_ops": host_ops,
                "device_ms_by_name": {k: us / 1e3 for k, us in top}, "peak_bytes": peak,
                "kernels": krows, "clusters": clusters,
            }, f, indent=1)
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
