#!/usr/bin/env python3
"""Drive lighthouse_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py                  # the full configuration (below)
    python3 chip_smoke.py --validators 4096 --sets 8 --keys 16 --batches 1

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. build the fused field-multiply kernels (csrc/fused_mul.cu: the plan
     kernel and the chain kernel; nvcc, sm_90a);
  2. build the fixtures with the port's pure-Python oracle: a registry of
     consecutive secret keys (pk_i = pk_{i-1} + G in Jacobian coordinates,
     one batched normalisation), cached as .npz under .fixture_cache/;
     per-set aggregate signatures; one block's signature sets as ``bls``
     objects; a gossip pool of single-key attestations (sig_{i+1} = sig_i +
     H(m) for consecutive keys, one batched normalisation per committee);
  3. one warm-up run of every path below, recording the shapes each path
     gives the kernels;
  4. the plan kernel (K1, every K3 plan signature) and the chain kernel
     (Fermat inversion, the Fq2 square-root chain, the |x| cyclotomic power)
     held bit-exact against their plain PyTorch versions at every row count
     any path gave them; each timed at its most-launched row count on the
     main, block and gossip paths beside its bound (chains also beside their
     own step loop of plan-kernel launches); cluster sizes 1/2/4/8 at rows 1;
  5. the main path (``verify_indexed_sets_device``): counts set to 0, timed
     valid batches (each must verify True) and one batch with a poisoned
     signature (must give False), counts read; K1, K3 and the chain kernel
     must have launched (K2 only inside chains), every timed schedule and
     chain too, the plain version never;
  6. the h2c stage's message points held against the oracle's
     hash_to_curve on the first messages;
  7. one more valid batch under torch.profiler: device busy time, idle
     share, aten ops dispatched, device time by kernel;
  8. the ``bls`` API at block width (``bls.verify_signature_sets``): the
     valid block True, one poisoned signature False, 4 small sets the same
     verdict as ``verify_signature_sets_oracle``, ``warmup()`` True; the
     host half (points -> limbs, hash_to_field) and the device half timed
     apart over repeats (median, min, max), the device half once more
     under the profiler (device busy time, idle share);
  9. the gossip firehose (``FirehoseEngine`` over
     ``verify_indexed_sets_device``, supervised, no CPU fallback) paced at
     50,000 att/s for 3 s and drained: verified att/s, drops, queue latency
     against the SLOs, beside the standalone rate of the same batches; no
     rejected, errored or faulted batch, a clean supervisor;
 10. one synchronous drain of 64 gossip items with 2 poisoned: exactly
     those False, as many verify calls as the reference's bisection makes.
Phases 8-10 each set the counts to 0 before and read them after, as phase
5 does, and hold any shape they launched that phase 4 did not see.

Full configuration: 2^20 validator pubkeys resident as the [N, 3, 25]
cache (mainnet); main path batches of 64 aggregate signature sets, 512 keys
per set, 4 timed batches; a block of 131 sets (proposer, randao, 128
attestation aggregates and one sync aggregate of --keys = 512 keys); a gossip pool
of 64 committees x 32 attesters. The last line of stdout is the result
object; the line before it the kernel table; before that the card's name
and power limit.
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
STREAM_S = 3.0  # firehose stream length (bench.py's BENCH_FIREHOSE_SECONDS default)
FIREHOSE_RATE = 50_000.0  # att/s offered (BASELINE config #5)
COMMITTEES = 64  # gossip pool: one slot's committees, 32 attesters each
BLOCK_ATTESTATIONS = 128  # attestation aggregates in the block (BASELINE config #3)
BLOCK_REPS = 5  # timed repeats of each half of the block verify
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


def _pubkeys(raw, idx):
    """``bls.PublicKey`` objects straight from the registry's affine points
    (no decompression, no subgroup check: the registry is valid by
    construction)."""
    from lighthouse_tpu_torch import bls

    return [
        bls.PublicKey((int.from_bytes(raw[v, :48].tobytes(), "big"),
                       int.from_bytes(raw[v, 48:].tobytes(), "big")))
        for v in idx
    ]


def _block(rng, raw, sk0: int, n_att: int, k: int):
    """One block's signature sets over ``bls`` objects: the proposer and
    randao sets (one key each, through ``PublicKey.from_bytes``), ``n_att``
    attestation aggregates and one sync aggregate of ``k`` keys each, all
    signed by the oracle. Returns (sets, the secret key of each set)."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    n_val = raw.shape[0]
    sets, sks = [], []
    for _ in range(2):
        v = int(rng.integers(n_val))
        pk = bls.PublicKey.from_bytes(oc.g1_compress(_pubkeys(raw, [v])[0].point))
        msg = rng.bytes(32)
        sets.append(bls.SignatureSet.single_pubkey(bls.Signature(cs.sign(sk0 + v, msg)), pk, msg))
        sks.append(sk0 + v)
    for _ in range(n_att + 1):
        idx = rng.choice(n_val, size=k, replace=False)
        msg = rng.bytes(32)
        agg_sk = (k * sk0 + int(idx.sum())) % R
        sets.append(bls.SignatureSet.multiple_pubkeys(
            bls.AggregateSignature(cs.sign(agg_sk, msg)), _pubkeys(raw, idx), msg))
        sks.append(agg_sk)
    return sets, sks


def _poison(sets, sks, j: int):
    """``sets`` with set j's signature made over another message."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.oracle import ciphersuite as cs

    out = list(sets)
    out[j] = bls.SignatureSet.multiple_pubkeys(
        bls.AggregateSignature(cs.sign(sks[j], b"\x5a" * 32)), sets[j].signing_keys, sets[j].message)
    return out


def _g2_walk(p0, h, n: int):
    """[p0, p0 + h, ..., p0 + (n-1) h] (affine G2): one Jacobian add per
    point, then one batched normalisation (Montgomery's trick)."""
    from lighthouse_tpu_torch.oracle import curves as oc

    ops = oc.OPS_FQ2
    hj = oc._to_jac(h, ops)
    jac = [oc._to_jac(p0, ops)]
    for _ in range(n - 1):
        jac.append(oc._jac_add(jac[-1], hj, ops))
    pref, acc = [], ops.one
    for _, _, z in jac:
        acc = acc * z
        pref.append(acc)
    inv = acc.inv()
    out = [None] * n
    for i in range(n - 1, -1, -1):
        x, y, z = jac[i]
        zi = inv * pref[i - 1] if i else inv
        inv = inv * z
        zi2 = zi.square()
        out[i] = (x * zi2, y * zi2 * zi)
    return out


def _gossip_pool(rng, n_val: int, sk0: int, committees: int, size: int):
    """committees x size single-key attestations (one signing root per
    committee, as in one slot) from consecutive validators: with consecutive
    secret keys, sig_{i+1} = sig_i + H(m). Seeded order, committees mixed."""
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    pool = []
    for _ in range(committees):
        msg = rng.bytes(32)
        base = int(rng.integers(n_val - size))
        h = cs.hash_to_g2(msg)
        sigs = _g2_walk(oc.g2_mul(h, (sk0 + base) % R), h, size)
        pool += [([base + i], msg, oc.g2_compress(sg)) for i, sg in enumerate(sigs)]
    return [pool[i] for i in rng.permutation(len(pool))]


# --------------------------------------------------------------------------------------
# The firehose (bench.py's stream generator and SLO block, copied)
# --------------------------------------------------------------------------------------

FIREHOSE_SLOS = {
    "p99_queue_latency_ms": 250.0,
    "max_drop_rate": 0.05,
}


def _pace_stream(engine, pool, rate: float, duration: float,
                 drain_timeout: float) -> tuple[int, float]:
    """Seeded synthetic gossip generator: pace ``rate`` att/s of pool items
    into the engine in 1 ms micro-bursts (the intake is non-blocking;
    overflow sheds inside the engine, never stalls the generator). Returns
    (items offered, wall seconds incl. drain)."""
    t_start = time.perf_counter()
    n_stream = 0
    per_tick = max(1, int(rate / 1000))
    while True:
        elapsed = time.perf_counter() - t_start
        if elapsed >= duration:
            break
        target = min(int(rate * elapsed) + per_tick, int(rate * duration))
        while n_stream < target:
            engine.submit(pool[n_stream % len(pool)])
            n_stream += 1
        time.sleep(0.001)
    engine.stop(drain_timeout=drain_timeout)
    return n_stream, time.perf_counter() - t_start


def _slo_block(st, n_stream: int) -> dict:
    """Measured-vs-declared SLO block for a firehose stats snapshot."""
    drop_rate = st.dropped / n_stream if n_stream else 0.0
    p99_ms = st.p99_latency_s * 1e3 if st.p99_latency_s is not None else None
    return {
        "declared": dict(FIREHOSE_SLOS),
        "measured": {"p99_queue_latency_ms": p99_ms, "drop_rate": drop_rate},
        "met": {
            "p99_queue_latency_ms": (
                p99_ms is not None and p99_ms <= FIREHOSE_SLOS["p99_queue_latency_ms"]
            ),
            "drop_rate": drop_rate <= FIREHOSE_SLOS["max_drop_rate"],
        },
    }


def _spread(ms: list) -> dict:
    """Median, min and max of repeated wall times."""
    ms = sorted(ms)
    return {"median": ms[len(ms) // 2], "min": ms[0], "max": ms[-1]}


def _profiled(fn):
    """One call of ``fn`` under torch.profiler: (its result, wall ms, device
    microseconds by kernel name, aten ops dispatched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
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
    return out, wall_ms, dev_us, host_ops


def _bisect_calls(order: list, bad: set) -> int:
    """Verify calls the reference's bisection (firehose/bisect.py) makes
    after a failed whole batch, for single-item groups in ``order``:
    written out here independently of the port's copy."""
    def rec(lo, hi, known_failed):
        if hi <= lo:
            return 0
        n = 0
        if not known_failed:
            n += 1
            if not any(order[i] in bad for i in range(lo, hi)):
                return n
        if hi - lo == 1:
            return n
        mid = (lo + hi) // 2
        return n + rec(lo, mid, False) + rec(mid, hi, False)

    return rec(0, len(order), True)


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


def _plain_rows(fn, a, b, chunk: int = 4096):
    """``fn(a, b)`` over row chunks (the plan's plain version is
    row-independent): bounded memory at the block's large row counts."""
    import torch

    if a.shape[0] <= chunk:
        return fn(a, b)
    return torch.cat([fn(a[i:i + chunk], b[i:i + chunk]) for i in range(0, a.shape[0], chunk)])


def exact_checks(shapes: dict, dev, gen, done: set) -> int:
    """Hold the plan kernel (K1, K3) and the chain kernel bit-exact against
    their plain versions at every (schedule or chain, rows) in ``shapes``
    (a launch log) not in ``done``; adds them to ``done``. Random canonical
    inputs with row 0 at the bound's maxima. Returns how many it checked."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    n = 0
    for kind, label, rows in sorted(shapes, key=lambda k: (k[0], k[1], k[2])):
        if (kind, label, rows) in done:
            continue
        if kind == "CHAIN":
            prog = fm.CHAINS[label]
            base = _operand(rows, prog.n_el, prog.scheds[0].in_bounds[0], gen, dev)
            got = fm.cuda_chain(prog, base)
            torch.cuda.synchronize()
            err = int((got - fm.plain_chain(prog, base)).abs().max().item())
        else:
            sched = fm.SCHEDULES[label]
            a = _operand(rows, sched.n_a, sched.in_bounds[0], gen, dev)
            b = _operand(rows, sched.n_b, sched.in_bounds[1], gen, dev)
            got = fm.cuda_fused(sched, a, b)
            torch.cuda.synchronize()
            want = _plain_rows(lambda x, y: fm.plain_plan(sched, x, y), a, b)
            err = int((got - want).abs().max().item())
        if err != 0:
            raise RuntimeError(f"{kind} {label} rows={rows}: kernel != plain (max |diff| {err})")
        done.add((kind, label, rows))
        n += 1
    return n


def plan_timing(label: str, rows: int, dev, gen) -> dict:
    """The plan kernel on one schedule at ``rows``: device time (graph
    replay), time per launch from Python, the plain version's time, and the
    bound."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    sched = fm.SCHEDULES[label]
    a = _operand(rows, sched.n_a, sched.in_bounds[0], gen, dev)
    b = _operand(rows, sched.n_b, sched.in_bounds[1], gen, dev)
    C = fm.cluster_size(rows, sched.L) if sched.has_out else 1
    _check_layouts(sched=sched, C=C)
    ms = _time_graph(lambda: fm.cuda_fused(sched, a, b), 100)
    host_ms = _time(lambda: fm.cuda_fused(sched, a, b), 100)
    plain_ms = _time(lambda: _plain_rows(lambda x, y: fm.plain_plan(sched, x, y), a, b), 10)
    n_bytes = rows * (sched.n_a + sched.n_b + sched.R) * 200 + sched.ints.nbytes + sched.i64.nbytes
    bound_ms, bound_by = _bound(rows * _step_ops(sched), n_bytes)
    log(f"plan {sched.kind} {label} rows={rows} L={sched.L} R={sched.R} C={C}: "
        f"{ms:.5f} ms kernel (graph), {host_ms:.5f} ms per launch from Python, "
        f"{plain_ms:.3f} ms plain, bound {bound_ms:.7f} ms ({bound_by})")
    return {
        "kind": sched.kind, "name": label, "rows": rows, "lanes": sched.L,
        "out_rows": sched.R, "n_pass": sched.n_pass, "cluster": C,
        "threads": sched.threads(C), "smem": sched.smem_bytes(C), "max_abs_err": 0,
        "ms": ms, "launch_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "signature": _signature(sched),
    }


def chain_timing(name: str, rows: int, dev, gen) -> dict:
    """The chain kernel on one chain at ``rows``: device time, time from
    Python, its own step loop of plan launches, the plain version, the
    bound (the sum of its steps)."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    prog = fm.CHAINS[name]
    base = _operand(rows, prog.n_el, prog.scheds[0].in_bounds[0], gen, dev)
    C = prog.cluster(rows)
    _check_layouts(prog=prog, C=C)
    ms = _time_graph(lambda: fm.cuda_chain(prog, base), 5)
    host_ms = _time(lambda: fm.cuda_chain(prog, base), 5)
    step_ms = _time_graph(lambda: fm.replay_chain(prog, base, fm.cuda_fused), 1)
    step_host_ms = _time(lambda: fm.replay_chain(prog, base, fm.cuda_fused), 1)
    plain_ms = _time(lambda: fm.plain_chain(prog, base), 1)
    n_ops = rows * sum(_step_ops(prog.scheds[d]) for d, *_ in prog.steps if d != fm.COPY)
    n_bytes = rows * prog.n_el * 200 * 2 + prog.prog.nbytes
    bound_ms, bound_by = _bound(n_ops, n_bytes)
    threads, _, _, smem = prog.launch_shape(C)
    log(f"chain {name} rows={rows} C={C} ({prog.n_mults} multiplies): {ms:.4f} ms "
        f"kernel (graph), {host_ms:.4f} ms from Python; step loop {step_ms:.4f} ms (graph), "
        f"{step_host_ms:.4f} ms from Python; {plain_ms:.1f} ms plain; bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return {
        "kind": "CHAIN", "name": name, "rows": rows, "lanes": max(s.L for s in prog.scheds),
        "out_rows": prog.n_el, "n_pass": 0, "cluster": C, "threads": threads,
        "smem": smem, "steps": len(prog.steps), "mults": prog.n_mults, "max_abs_err": 0,
        "ms": ms, "launch_ms": host_ms, "step_loop_ms": step_ms,
        "step_loop_launch_ms": step_host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def timed_rows(path_logs: dict, dev, gen) -> list:
    """For each path's launch log, each schedule and chain timed at its
    most-launched row count there (one timing per (kind, name, rows) over
    all paths). Each row records the paths that chose it and, per path, the
    launches at that row count."""
    chosen: dict = {}
    for path, shapes in path_logs.items():
        per_name: dict = {}
        for (kind, name, rows), c in shapes.items():
            per_name.setdefault((kind, name), {})[rows] = c
        for (kind, name), seen in per_name.items():
            rows = max(seen, key=lambda r: (seen[r], r))
            chosen.setdefault((kind, name, rows), {})[path] = {
                "launches_at_rows": seen[rows], "shapes": {str(r): c for r, c in sorted(seen.items())},
            }
    out = []
    for (kind, name, rows), paths in sorted(chosen.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])):
        if kind == "CHAIN":
            r = chain_timing(name, rows, dev, gen)
        else:
            r = plan_timing(name, rows, dev, gen)
        r["paths"] = paths
        out.append(r)
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


def _counts_by_name() -> dict:
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    by_name: dict = {}
    for (kind, name, _rows), c in fm.launch_log.items():
        by_name[(kind, name)] = by_name.get((kind, name), 0) + c
    return by_name


def _read_counts(phase: str, need=("K1", "K3", "CHAIN")) -> dict:
    """Counts of the run just driven (set to 0 just before it): every entry
    in ``need`` launched, K2 never outside a chain, the plain version never.
    Returns {"by": launches by entry, "by_name": ..., "log": launch log}."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    counts = dict(fm.launches_by)
    if fm.plain_calls != 0:
        raise RuntimeError(f"{phase}: the plain version ran {fm.plain_calls} times")
    for kind in need:
        if counts[kind] == 0:
            raise RuntimeError(f"{phase}: kernel entry {kind} never launched")
    if counts["K2"] != 0:
        raise RuntimeError(f"{phase}: K2 launched outside a chain")
    return {"by": counts, "by_name": _counts_by_name(), "log": dict(fm.launch_log),
            "total": fm.launches}


def _snapshot_clean(snap: dict) -> None:
    bad = {k: snap[k] for k in ("faults", "retries", "demotions", "fallback_calls",
                                "watchdog_timeouts", "exhausted", "hung_threads") if snap[k]}
    if bad or snap["state"] != "HEALTHY":
        raise RuntimeError(f"firehose supervisor not clean: {snap}")


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

    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.firehose import FirehoseConfig, FirehoseEngine
    from lighthouse_tpu_torch.ops.bls import fq, fused_mul as fm
    from lighthouse_tpu_torch.oracle import hash_to_curve as oh
    from lighthouse_tpu_torch.oracle.ciphersuite import DST
    from lighthouse_tpu_torch.resilience import get_supervisor

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
    t = time.time()
    block, block_sks = _block(rng, raw, sk0, BLOCK_ATTESTATIONS, args.keys)
    block_bad = _poison(block, block_sks, len(block) // 2)
    small, small_sks = _block(rng, raw, sk0, 1, 8)
    small_bad = _poison(small, small_sks, 3)
    n_block_keys = sum(len(s.signing_keys) for s in block)
    log(f"fixture block: {len(block)} sets, {n_block_keys} keys, in {time.time() - t:.2f} s")
    t = time.time()
    pool = _gossip_pool(rng, args.validators, sk0, COMMITTEES, 32)
    bad_pos = (17, 42)
    bis_items = list(pool[:64])
    for j in bad_pos:  # another committee's signature: a valid point, a wrong signer
        other = next(it for it in pool[64:] if it[1] != bis_items[j][1])
        bis_items[j] = (bis_items[j][0], bis_items[j][1], other[2])
    log(f"fixture gossip pool: {len(pool)} single-key attestations in {time.time() - t:.2f} s")
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device=dev)
    torch.cuda.synchronize()

    def verify_gossip(items):
        return backend.verify_indexed_sets_device(cache, items, device=dev)

    def run_block_phase():
        ok = bls.verify_signature_sets(block, device=dev)
        bad = bls.verify_signature_sets(block_bad, device=dev)
        small_dev = [bls.verify_signature_sets(x, device=dev) for x in (small, small_bad)]
        warm = bls.warmup(device=dev)
        return ok, bad, small_dev, warm

    def run_bisect_phase():
        calls = []

        def counting(items):
            calls.append(list(items))
            return verify_gossip(items)

        engine = FirehoseEngine(
            prepare_fn=lambda ps: [([p], None) for p in ps], verify_items_fn=counting,
            config=FirehoseConfig(max_batch=64), synchronous=True,
        )
        verdicts = {}
        for i, it in enumerate(bis_items):
            engine.submit(it, callback=lambda p, ok, m, i=i: verdicts.__setitem__(i, ok))
        engine.drain()
        return verdicts, calls

    # 3. warm-up: one run of every path (schedules derived, path shapes recorded)
    path_logs = {}
    t = time.time()
    fm.reset_counts()
    if not backend.verify_indexed_sets_device(cache, batches[0], device=dev):
        raise RuntimeError("warm-up batch did not verify")
    path_logs["main"] = dict(fm.launch_log)
    log(f"warm-up batch: {time.time() - t:.2f} s")
    t = time.time()
    fm.reset_counts()
    if not bls.verify_signature_sets(block, device=dev):
        raise RuntimeError("warm-up block did not verify")
    path_logs["block"] = dict(fm.launch_log)  # the block's own shapes, for timing
    block_verify_by = dict(fm.launches_by)  # launches in one block verify
    fm.reset_counts()
    if run_block_phase() != (True, False, [True, False], True):
        raise RuntimeError("warm-up of the block phase gave wrong verdicts")
    block_phase_log = dict(fm.launch_log)
    fm.reset_counts()
    if not verify_gossip(pool[:64]):
        raise RuntimeError("warm-up gossip batch did not verify")
    path_logs["gossip"] = dict(fm.launch_log)
    fm.reset_counts()
    run_bisect_phase()
    bisect_log = dict(fm.launch_log)
    torch.cuda.synchronize()
    log(f"warm-up of the block, gossip and bisection paths: {time.time() - t:.2f} s")

    # 4. kernels against their plain versions at every shape the paths gave them
    gen = torch.Generator().manual_seed(20261017)
    done: set = set()
    t = time.time()
    n_exact = sum(
        exact_checks(lg, dev, gen, done)
        for lg in (*path_logs.values(), block_phase_log, bisect_log)
    )
    log(f"exact: {n_exact} (kernel, schedule or chain, rows) shapes bit-exact against the "
        f"plain versions in {time.time() - t:.2f} s")
    krows = timed_rows(path_logs, dev, gen)
    clusters = cluster_checks(dev, gen)

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
    runs = {"main": _read_counts("main path")}
    peak = torch.cuda.max_memory_allocated()
    n_timed = len(batches) - 1
    sets_per_s = n_timed * args.sets / t_valid
    log(f"main path: {n_timed} valid batches of {args.sets} sets x {args.keys} keys "
        f"over {args.validators} validators: {t_valid:.3f} s, {sets_per_s:.2f} sets/s")
    log("ms per batch: " + json.dumps({k: v / n_timed for k, v in stage_ms.items()}))
    per_batch = {k: v / (n_timed + 1) for k, v in runs["main"]["by"].items()}
    log(f"kernel launches per batch: {runs['main']['total'] / (n_timed + 1):.1f} "
        f"({json.dumps(per_batch)})")
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
    prof_ok, prof_wall_ms, dev_us, host_ops = _profiled(
        lambda: backend.verify_indexed_sets_device(cache, batches[1], device=dev))
    if not prof_ok:
        raise RuntimeError("the profiled batch did not verify")
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

    # 8. the bls API at block width (BASELINE config #3)
    fm.reset_counts()
    host_ms, dev_ms = [], []
    for _ in range(BLOCK_REPS):
        t = time.time()
        prepared = bls.prepare_sets(block, device=dev)
        torch.cuda.synchronize()
        host_ms.append((time.time() - t) * 1e3)
        t = time.time()
        if not bls.verify_prepared_sets(prepared):
            raise RuntimeError("the block did not verify (prepared halves)")
        dev_ms.append((time.time() - t) * 1e3)
    blk_ok, blk_prof_ms, blk_dev_us, blk_ops = _profiled(lambda: bls.verify_prepared_sets(prepared))
    if not blk_ok:
        raise RuntimeError("the profiled block did not verify")
    blk_busy_ms = sum(blk_dev_us.values()) / 1e3
    dev_half = _spread(dev_ms)
    block_t = {"host_ms": _spread(host_ms), "device_half_ms": dev_half,
               "device_busy_ms": blk_busy_ms, "profiled_ms": blk_prof_ms, "aten_ops": blk_ops,
               "idle_share": 1 - blk_busy_ms / dev_half["median"] if blk_busy_ms else None}
    t = time.time()
    block_res = run_block_phase()
    block_phase_s = time.time() - t
    runs["block"] = _read_counts("block phase")
    small_oracle = [bls.verify_signature_sets_oracle(x) for x in (small, small_bad)]
    if block_res[0] is not True:
        raise RuntimeError("verify_signature_sets: the valid block did not verify")
    if block_res[1] is not False:
        raise RuntimeError("verify_signature_sets: the block with a poisoned signature verified")
    if block_res[2] != small_oracle or small_oracle != [True, False]:
        raise RuntimeError(f"small sets: device {block_res[2]} != oracle {small_oracle}")
    if block_res[3] is not True:
        raise RuntimeError("bls.warmup() did not return True")
    n_new = exact_checks(runs["block"]["log"], dev, gen, done)
    log(f"block: {len(block)} sets ({n_block_keys} keys; n_pad {backend.bucket(len(block))}, "
        f"k_pad {backend.bucket(args.keys)}): host half (points -> limbs, hash_to_field, "
        f"padding, upload) {json.dumps(block_t['host_ms'])} ms; device half (aggregation + "
        f"verify, to the verdict; wall, host dispatch included) "
        f"{json.dumps(block_t['device_half_ms'])} ms over {BLOCK_REPS} repeats; device busy "
        f"{blk_busy_ms:.3f} ms ({blk_prof_ms:.3f} ms profiled, {blk_ops} aten ops): idle "
        f"share {block_t['idle_share']}; launches per verify {json.dumps(block_verify_by)}; "
        f"valid True, poisoned False, 4 small sets == oracle "
        f"{small_oracle}, warmup() True; phase {block_phase_s:.2f} s; "
        f"launches {json.dumps(runs['block']['by'])}; {n_new} new shapes checked exact")

    # 9. the gossip firehose at BASELINE config #5
    sup = get_supervisor("chip_smoke.firehose")
    engine = FirehoseEngine(
        prepare_fn=lambda ps: [([p], None) for p in ps],
        verify_items_fn=verify_gossip,
        config=FirehoseConfig(max_batch=64, deadline_s=0.010, intake_capacity=1024),
        supervisor=sup,
    )
    fm.reset_counts()
    n_stream, wall = _pace_stream(engine, pool, FIREHOSE_RATE, STREAM_S, 120.0)
    st = engine.stats()
    runs["gossip"] = _read_counts("firehose phase")
    snap = sup.snapshot()
    if st.rejected or st.errored or st.device_faults:
        raise RuntimeError(f"firehose: rejected/errored/faulted batches: {st.as_dict()}")
    _snapshot_clean(snap)
    if st.verified == 0:
        raise RuntimeError("firehose: nothing verified")
    slo = _slo_block(st, n_stream)
    att_per_s = st.verified / wall
    n_new = exact_checks(runs["gossip"]["log"], dev, gen, done)
    t = time.time()
    n_alone = min(8, len(pool) // 64)
    for i in range(n_alone):
        if not verify_gossip(pool[64 * i: 64 * (i + 1)]):
            raise RuntimeError("a standalone gossip batch did not verify")
    alone_s = time.time() - t
    alone_per_s = n_alone * 64 / alone_s
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    fh = {
        "verified_att_per_s": att_per_s, "offered_att_per_s": FIREHOSE_RATE, "offered": n_stream,
        "accepted": st.submitted, "verified": st.verified, "dropped": st.dropped,
        "drop_rate": st.dropped / n_stream, "batches_formed": st.batches_formed,
        "p50_queue_ms": st.p50_latency_s * 1e3, "p99_queue_ms": st.p99_latency_s * 1e3,
        "wall_s": wall, "slo": slo, "standalone_att_per_s": alone_per_s,
        "launches_per_batch": runs["gossip"]["total"] / st.batches_formed,
        "supervisor": snap, "card": card,
    }
    log(f"firehose: {att_per_s:.2f} att/s verified (offered {FIREHOSE_RATE:.0f} att/s for "
        f"{STREAM_S} s: {n_stream} offered, {st.submitted} accepted, {st.dropped} "
        f"dropped, drop rate {fh['drop_rate']:.4f}); {st.batches_formed} batches; queue "
        f"latency p50 {fh['p50_queue_ms']:.2f} ms p99 {fh['p99_queue_ms']:.2f} ms; SLO "
        f"{json.dumps(slo)}; card {card}")
    log(f"firehose beside the standalone rate: {alone_per_s:.2f} att/s for {n_alone} batches of "
        f"64 x 1 unthreaded; {fh['launches_per_batch']:.1f} launches per batch "
        f"({json.dumps(runs['gossip']['by'])}); {n_new} new shapes checked exact")

    # 10. bisection on the card
    fm.reset_counts()
    verdicts, calls = run_bisect_phase()
    runs["bisect"] = _read_counts("bisection phase")
    want = [i not in bad_pos for i in range(64)]
    if [verdicts[i] for i in range(64)] != want:
        raise RuntimeError(f"bisection: verdicts {verdicts} != poisoned at {bad_pos}")
    order = [bis_items.index(it) for it in calls[0]]
    n_calls_ref = 1 + _bisect_calls(order, set(bad_pos))
    if len(calls) != n_calls_ref:
        raise RuntimeError(f"bisection: {len(calls)} verify calls, the reference algorithm "
                           f"makes {n_calls_ref}")
    n_new = exact_checks(runs["bisect"]["log"], dev, gen, done)
    log(f"bisection: 64 items, poisoned at {list(bad_pos)}: exactly those False; "
        f"{len(calls)} verify calls (reference algorithm: {n_calls_ref}), sizes "
        f"{[len(c) for c in calls]}; {n_new} new shapes checked exact")

    log(f"elapsed: {time.time() - t_start:.1f} s")
    table = []
    for r in krows:
        kernel = "chain_kernel" if r["kind"] == "CHAIN" else "plan_kernel"
        for path in r["paths"]:
            launches = runs[path]["by_name"].get((r["kind"], r["name"]), 0)
            if launches == 0:
                raise RuntimeError(f"{r['kind']} {r['name']} never launched on the {path} path")
            table.append({
                "name": f"{kernel} {r['kind']} {r['name']} [{path}]", "route": "cuda",
                "source": SRC, "replaces": REPLACES[r["kind"]], "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                "rows": r["rows"], "lanes": r["lanes"], "out_rows": r["out_rows"],
                "cluster": r["cluster"], "launch_ms": r["launch_ms"],
            })
    if args.report:
        with open(args.report, "w") as f:
            json.dump({
                "card": card, "config": vars(args), "sets_per_s": sets_per_s,
                "ms_per_batch": {k: v / n_timed for k, v in stage_ms.items()},
                "launches_per_batch": runs["main"]["total"] / (n_timed + 1),
                "launches_by": per_batch, "busy_ms": busy_ms, "batch_ms": batch_ms,
                "aten_ops": host_ops, "device_ms_by_name": {k: us / 1e3 for k, us in top},
                "peak_bytes": peak, "kernels": krows, "clusters": clusters,
                "exact_shapes": len(done),
                "block": {"sets": len(block), "keys": n_block_keys, **block_t,
                          "launches": runs["block"]["by"],
                          "launches_per_verify": block_verify_by},
                "firehose": fh,
                "bisect": {"calls": len(calls), "reference_calls": n_calls_ref,
                           "sizes": [len(c) for c in calls], "launches": runs["bisect"]["by"]},
            }, f, indent=1)
    print(card, flush=True)
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
