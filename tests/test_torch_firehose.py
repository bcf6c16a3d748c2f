"""The port's gossip firehose against the reference's, scenario by scenario.

``lighthouse_tpu_torch.firehose`` (batcher, bisection, engine) is the
port's copy of ``lighthouse_tpu.firehose``. The scenarios of
``tests/test_firehose.py`` (TestBisect, TestBackPressure,
TestAdaptiveBatcher, TestEnginePipeline) run against BOTH packages with the
reference test's own assertions; the deterministic ones also return a
trace (verdict callbacks, the fake verifier's calls, batch composition,
``FirehoseStats`` without its times, drop counts) that must be equal across
the packages. Hypothesis draws poison patterns for ``bisect_verify`` and
priority mixes for ``AdaptiveBatcher``, each held equal to the reference.

The whole path: the port's engine over the port's CPU verify
(``verify_indexed_sets_device(device="cpu")``) at 16 validators, 8
single-key items with one poisoned, gives the oracle's per-item verdicts.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import firehose as r_fh
from lighthouse_tpu.beacon_processor.processor import WorkType as R_WT

from lighthouse_tpu_torch import firehose as p_fh
from lighthouse_tpu_torch.beacon_processor.processor import WorkType as P_WT

PKGS = {
    "ref": SimpleNamespace(fh=r_fh, WT=R_WT),
    "port": SimpleNamespace(fh=p_fh, WT=P_WT),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The whole-path test runs at small shapes: one intra-op thread keeps
    torch from competing with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CountingVerifier:
    """Batched fake verifier: items are ('id',) tuples; ids in `bad` fail."""

    def __init__(self, bad):
        self.bad = set(bad)
        self.calls = []

    def __call__(self, items):
        self.calls.append(len(items))
        return not any(it[0] in self.bad for it in items)


def _stats(engine) -> dict:
    d = engine.stats().as_dict()
    for k in ("p50_latency_s", "p99_latency_s", "p50_e2e_s", "p99_e2e_s"):
        d[k] = d[k] is not None  # times differ; their presence must not
    return d


def _dropped(b) -> dict:
    return {t.name: n for t, n in b.dropped.items()}


# -- bisection ---------------------------------------------------------------------


def sc_isolates_exactly_the_poisoned_sets(pkg):
    bad = {3, 11, 12}
    vf = CountingVerifier(bad)
    verdicts = pkg.fh.bisect_verify([[(i,)] for i in range(16)], vf, assume_failed=True)
    assert verdicts == [i not in bad for i in range(16)]
    return verdicts, vf.calls


def sc_single_poison_is_logarithmic(pkg):
    vf = CountingVerifier({37})
    verdicts = pkg.fh.bisect_verify([[(i,)] for i in range(64)], vf, assume_failed=True)
    assert verdicts == [i != 37 for i in range(64)]
    assert len(vf.calls) <= 2 * 6 + 1  # 2 calls per level, log2(64)=6
    return verdicts, vf.calls


def sc_group_fails_as_a_unit(pkg):
    groups = [[(3 * g,), (3 * g + 1,), (3 * g + 2,)] for g in range(8)]
    vf = CountingVerifier({10})  # lives in group 3
    verdicts = pkg.fh.bisect_verify(groups, vf, assume_failed=True)
    assert verdicts == [g != 3 for g in range(8)]
    return verdicts, vf.calls


def sc_all_good_without_assume_failed(pkg):
    vf = CountingVerifier(set())
    assert pkg.fh.bisect_verify([[(1,)], [(2,)]], vf) == [True, True]
    assert vf.calls == [2]  # one batched call, no splitting
    return vf.calls


def sc_bisect_empty(pkg):
    assert pkg.fh.bisect_verify([], CountingVerifier(set())) == []
    return []


# -- back-pressure / shedding ------------------------------------------------------


def sc_drops_lowest_priority_first(pkg):
    WT, fh = pkg.WT, pkg.fh
    b = fh.AdaptiveBatcher(fh.FirehoseConfig(intake_capacity=4))
    for i in range(4):
        assert b.submit(fh.FirehoseItem(WT.GossipAttestation, i))
    assert b.submit(fh.FirehoseItem(WT.GossipAggregate, "agg"))
    assert b.depth(WT.GossipAggregate) == 1
    assert b.depth(WT.GossipAttestation) == 3
    assert b.dropped.get(WT.GossipAttestation) == 1
    assert not b.submit(fh.FirehoseItem(WT.GossipAttestation, "late"))
    assert b.dropped[WT.GossipAttestation] == 2
    assert b.depth() == 4
    batches = []
    while (batch := b.form_now()) is not None:
        batches.append([(it.work_type.name, it.payload) for it in batch])
    return _dropped(b), b.evicted, b.submitted, b.high_water, batches


def sc_per_type_cap(pkg):
    WT, fh = pkg.WT, pkg.fh
    b = fh.AdaptiveBatcher(
        fh.FirehoseConfig(intake_capacity=100, per_type_capacity={WT.GossipAttestation: 2})
    )
    ok = [b.submit(fh.FirehoseItem(WT.GossipAttestation, i)) for i in range(5)]
    assert ok == [True, True, False, False, False]
    assert b.dropped[WT.GossipAttestation] == 3
    return ok, _dropped(b)


def sc_intake_never_blocks_while_device_stalls(pkg):
    """submit() stays non-blocking while the verify stage is wedged: the
    prep thread blocks on the handoff, the intake sheds. (Threaded: how
    many items are accepted depends on the clock, so only invariants.)"""
    fh = pkg.fh
    release = threading.Event()

    def stalled_verify(items):
        release.wait(timeout=10.0)
        return True

    engine = fh.FirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], None) for p in ps],
        verify_items_fn=stalled_verify,
        config=fh.FirehoseConfig(max_batch=4, deadline_s=0.001, intake_capacity=16),
    )
    try:
        t0 = time.monotonic()
        n = 2000
        accepted = sum(engine.submit(i) for i in range(n))
        elapsed = time.monotonic() - t0
        assert elapsed < 2.0, f"intake blocked for {elapsed:.2f}s"
        assert accepted < n  # back-pressure shed the overflow
        assert engine.total_dropped() == n - accepted
    finally:
        release.set()
        engine.stop(drain_timeout=10.0)
    assert engine.stats().verified == accepted
    return None


# -- adaptive batching -------------------------------------------------------------


def sc_full_batch_returns_immediately(pkg):
    fh, WT = pkg.fh, pkg.WT
    b = fh.AdaptiveBatcher(fh.FirehoseConfig(max_batch=4, deadline_s=5.0))
    for i in range(4):
        b.submit(fh.FirehoseItem(WT.GossipAttestation, i))
    t0 = time.monotonic()
    batch = b.next_batch(timeout=1.0)
    assert batch is not None and len(batch) == 4
    assert time.monotonic() - t0 < 1.0  # no deadline wait for a full batch
    return [it.payload for it in batch]


def sc_trickle_flushes_at_deadline(pkg):
    fh, WT = pkg.fh, pkg.WT
    b = fh.AdaptiveBatcher(fh.FirehoseConfig(max_batch=64, deadline_s=0.05))
    b.submit(fh.FirehoseItem(WT.GossipAttestation, "only"))
    t0 = time.monotonic()
    batch = b.next_batch(timeout=2.0)
    dt = time.monotonic() - t0
    assert batch is not None and len(batch) == 1
    assert dt < 1.0  # flushed by the deadline, not the timeout
    return [it.payload for it in batch]


def sc_priority_order_across_types(pkg):
    fh, WT = pkg.fh, pkg.WT
    b = fh.AdaptiveBatcher(fh.FirehoseConfig(max_batch=8))
    b.submit(fh.FirehoseItem(WT.GossipAttestation, "att"))
    b.submit(fh.FirehoseItem(WT.GossipAggregate, "agg"))
    first, second = b.form_now(), b.form_now()
    assert [it.payload for it in first] == ["agg"]  # aggregates first
    assert [it.payload for it in second] == ["att"]
    return [[it.payload for it in first], [it.payload for it in second]]


def sc_batches_are_homogeneous(pkg):
    fh, WT = pkg.fh, pkg.WT
    b = fh.AdaptiveBatcher(fh.FirehoseConfig(max_batch=8))
    for i in range(3):
        b.submit(fh.FirehoseItem(WT.GossipAttestation, i))
    for i in range(2):
        b.submit(fh.FirehoseItem(WT.GossipAggregate, i))
    batch = b.form_now()
    assert len({it.work_type for it in batch}) == 1
    return [(it.work_type.name, it.payload) for it in batch]


# -- pipeline ----------------------------------------------------------------------


def sc_synchronous_drain_verdicts_and_stats(pkg):
    fh = pkg.fh
    bad = {5, 9}
    vf_calls = []

    def verify(items):
        vf_calls.append([it[0] for it in items])
        return not any(it[0] in bad for it in items)

    engine = fh.FirehoseEngine(
        prepare_fn=lambda ps: [ValueError("boom") if p == 7 else ([(p,)], f"meta{p}") for p in ps],
        verify_items_fn=verify,
        config=fh.FirehoseConfig(max_batch=4),
        synchronous=True,
    )
    verdicts = {}
    for i in range(12):
        engine.submit(i, callback=lambda p, ok, meta: verdicts.setdefault(p, (ok, meta)))
    engine.drain()
    st = engine.stats()
    assert st.verified == 9 and st.rejected == 2 and st.errored == 1
    assert verdicts[5] == (False, "meta5")
    assert verdicts[7] == (False, None)  # prep error
    assert verdicts[2] == (True, "meta2")
    assert st.batches_formed == 3
    assert st.p50_latency_s is not None and st.p99_latency_s is not None
    return verdicts, vf_calls, _stats(engine)


def sc_device_fault_still_delivers_verdicts(pkg):
    fh = pkg.fh

    def exploding_verify(items):
        raise RuntimeError("device fell over")

    engine = fh.FirehoseEngine(
        prepare_fn=lambda ps: [([(p,)], None) for p in ps],
        verify_items_fn=exploding_verify,
        config=fh.FirehoseConfig(max_batch=4),
        synchronous=True,
    )
    verdicts = {}
    for i in range(4):
        engine.submit(i, callback=lambda p, ok, m: verdicts.__setitem__(p, ok))
    engine.drain()
    assert verdicts == {0: False, 1: False, 2: False, 3: False}
    st = engine.stats()
    assert st.errored == 4 and st.verified == 0 and st.rejected == 0
    return verdicts, _stats(engine)


def sc_double_buffering_overlaps_prep_and_verify(pkg):
    """While the device verifies batch N, the prep thread is already
    preparing batch N+1. (Threaded: invariants only.)"""
    fh = pkg.fh
    events = []
    lock = threading.Lock()

    def prepare(ps):
        with lock:
            events.append(("prep_start", time.monotonic()))
        time.sleep(0.05)
        with lock:
            events.append(("prep_end", time.monotonic()))
        return [([(p,)], None) for p in ps]

    def verify(items):
        with lock:
            events.append(("verify_start", time.monotonic()))
        time.sleep(0.05)
        with lock:
            events.append(("verify_end", time.monotonic()))
        return True

    engine = fh.FirehoseEngine(
        prepare_fn=prepare, verify_items_fn=verify,
        config=fh.FirehoseConfig(max_batch=4, deadline_s=0.001),
    )
    for i in range(12):  # 3 batches of 4
        engine.submit(i)
    engine.stop(drain_timeout=15.0)
    assert engine.stats().verified == 12
    with lock:
        seq = list(events)
    preps = list(zip([t for n, t in seq if n == "prep_start"], [t for n, t in seq if n == "prep_end"]))
    verifies = list(zip(
        [t for n, t in seq if n == "verify_start"], [t for n, t in seq if n == "verify_end"]
    ))
    assert any(ps < ve and vs < pe for ps, pe in preps for vs, ve in verifies), seq
    return None


SCENARIOS = {
    f.__name__[3:]: f
    for f in (
        sc_isolates_exactly_the_poisoned_sets, sc_single_poison_is_logarithmic,
        sc_group_fails_as_a_unit, sc_all_good_without_assume_failed, sc_bisect_empty,
        sc_drops_lowest_priority_first, sc_per_type_cap,
        sc_intake_never_blocks_while_device_stalls, sc_full_batch_returns_immediately,
        sc_trickle_flushes_at_deadline, sc_priority_order_across_types,
        sc_batches_are_homogeneous, sc_synchronous_drain_verdicts_and_stats,
        sc_device_fault_still_delivers_verdicts,
        sc_double_buffering_overlaps_prep_and_verify,
    )
}
# threaded scenarios return None (their numbers depend on the clock)
TRACES: dict = {}


def _run(name, which):
    TRACES[(name, which)] = SCENARIOS[name](PKGS[which])
    return TRACES[(name, which)]


@pytest.mark.parametrize("which", ["ref", "port"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario(name, which):
    _run(name, which)


@pytest.mark.parametrize(
    "name",
    [n for n in SCENARIOS if n not in (
        "intake_never_blocks_while_device_stalls", "double_buffering_overlaps_prep_and_verify",
    )],
)
def test_port_trace_equals_reference(name):
    """Same verdicts, verifier calls, batches, stats and drops as the
    reference on the same scenario."""
    ref = TRACES[(name, "ref")] if (name, "ref") in TRACES else _run(name, "ref")
    port = TRACES[(name, "port")] if (name, "port") in TRACES else _run(name, "port")
    assert port == ref


# -- hypothesis: random poison patterns and priority mixes -------------------------


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    n=st.integers(min_value=0, max_value=40),
    bad=st.sets(st.integers(min_value=0, max_value=39), max_size=8),
    group=st.integers(min_value=1, max_value=3),
    assume_failed=st.booleans(),
)
def test_bisect_random_poison_equals_reference(n, bad, group, assume_failed):
    groups = [[(group * g + j,) for j in range(group)] for g in range(n)]
    out = {}
    for which, pkg in PKGS.items():
        vf = CountingVerifier(bad)
        out[which] = (pkg.fh.bisect_verify(groups, vf, assume_failed=assume_failed), vf.calls)
    assert out["port"] == out["ref"]
    truth = [not any(it[0] in bad for it in g) for g in groups]
    if not assume_failed or not all(truth) or not groups:
        assert out["port"][0] == truth


_TYPES = ["GossipAttestation", "GossipAggregate", "GossipBlock", "GossipSyncSignature",
          "UnknownBlockAttestation", "LightClientUpdate"]


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    ops=st.lists(
        st.one_of(st.sampled_from(_TYPES), st.just("form")), min_size=1, max_size=60
    ),
    capacity=st.integers(min_value=1, max_value=12),
    max_batch=st.integers(min_value=1, max_value=6),
    att_cap=st.one_of(st.none(), st.integers(min_value=1, max_value=5)),
)
def test_batcher_random_priority_mix_equals_reference(ops, capacity, max_batch, att_cap):
    """The same random submit/form sequence through both batchers: the same
    accept/shed answers, batches (type and payload order), drops,
    evictions and high-water mark."""
    out = {}
    for which, pkg in PKGS.items():
        WT, fh = pkg.WT, pkg.fh
        per_type = {} if att_cap is None else {WT.GossipAttestation: att_cap}
        b = fh.AdaptiveBatcher(fh.FirehoseConfig(
            max_batch=max_batch, intake_capacity=capacity, per_type_capacity=per_type,
        ))
        trace = []
        for i, op in enumerate(ops):
            if op == "form":
                batch = b.form_now()
                trace.append(None if batch is None else [(it.work_type.name, it.payload) for it in batch])
            else:
                trace.append(b.submit(fh.FirehoseItem(getattr(WT, op), i)))
        while (batch := b.form_now()) is not None:
            trace.append([(it.work_type.name, it.payload) for it in batch])
        out[which] = (trace, _dropped(b), b.evicted, b.submitted, b.high_water, b.depth())
    assert out["port"] == out["ref"]
    batches = [t for t in out["port"][0] if isinstance(t, list)]
    assert all(len({w for w, _ in bt}) == 1 and len(bt) <= max_batch for bt in batches)


# -- the whole path: port engine + port CPU verify vs the oracle -------------------


def test_engine_over_port_cpu_verify_matches_oracle():
    """16 validators, 8 single-key gossip attestations, item 5 poisoned:
    the port's engine over ``verify_indexed_sets_device(device="cpu")``
    delivers the oracle's verdict for every item, and bisection isolates
    exactly the poisoned one."""
    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    rng = np.random.default_rng(2026)
    sks = [int(rng.integers(1, 1 << 62)) for _ in range(16)]
    pks = [cs.sk_to_pk(s) for s in sks]
    raw = np.array(
        [list(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")) for p in pks], dtype=np.uint8
    )
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device="cpu")
    msgs = [rng.bytes(32) for _ in range(2)]
    items = []
    for i in range(8):
        v = int(rng.integers(16))
        m = msgs[i % 2]
        signed = rng.bytes(32) if i == 5 else m
        items.append(([v], m, oc.g2_compress(cs.sign(sks[v] % R, signed))))
    want = [
        cs.verify(pks[ix[0]], m, oc.g2_decompress(sb)) for ix, m, sb in items
    ]
    assert want == [i != 5 for i in range(8)]

    calls = []

    def verify(flat):
        calls.append(list(flat))
        return backend.verify_indexed_sets_device(cache, flat, device="cpu")

    engine = p_fh.FirehoseEngine(
        prepare_fn=lambda ps: [([p], None) for p in ps],
        verify_items_fn=verify,
        config=p_fh.FirehoseConfig(max_batch=8),
        synchronous=True,
    )
    verdicts = {}
    for i, it in enumerate(items):
        engine.submit(it, callback=lambda p, ok, m, i=i: verdicts.__setitem__(i, ok))
    engine.drain()
    assert [verdicts[i] for i in range(8)] == want
    st = engine.stats()
    assert (st.verified, st.rejected, st.errored, st.batches_formed) == (7, 1, 0, 1)
    # the reference algorithm's calls on the batch as the engine formed it
    # (the attestation queue is LIFO)
    order = [items.index(it) for it in calls[0]]
    ref_vf = CountingVerifier({5})
    r_fh.bisect_verify([[(i,)] for i in order], ref_vf, assume_failed=True)
    assert [len(c) for c in calls] == [8] + ref_vf.calls
