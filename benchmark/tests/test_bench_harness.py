"""The harness on the CPU: cells and metrics by name, the import guard, the
refusal without a card, due-time latency, the arrival plan and the roofline
constants."""

import os
import re
import types

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import drive, guard, spec
from benchmark.harness import traffic as tg
from benchmark.harness.readings import Context

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_cells_configs_mixes_and_metrics_are_found_by_name():
    bench = spec.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        kind = tg.kind(cell.params["payload"])
        assert callable(kind.plan) and callable(kind.warm_items)
        e2e = [m["name"] for m in cell.end_to_end()]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer(), w["name"]
        for m in cell.end_to_end() + cell.per_layer():
            assert callable(spec.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(spec.HERE, "metrics", f"{m['name']}.py"))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))


def test_benchmark_json_keeps_the_contract_shape():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    reported = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in reported and m["better"] in ("higher", "lower")
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


@pytest.mark.parametrize("modules, found", [
    ({"lighthouse_tpu_torch": 1, "lighthouse_tpu_torch.bls.backend": 1, "numpy": 1}, []),
    ({"benchmark.harness.check": 1, "torch": 1}, []),
    ({"lighthouse_tpu": 1}, ["lighthouse_tpu"]),
    ({"lighthouse_tpu.ops.bls": 1, "lighthouse_tpu_torch": 1}, ["lighthouse_tpu"]),
    ({"jax.numpy": 1}, ["jax"]),
    ({"jaxlib.xla_client": 1, "flax": 1}, ["flax", "jaxlib"]),
    ({"bench": 1}, ["bench"]),
])
def test_the_import_guard_compares_whole_top_level_names(modules, found):
    assert guard.forbidden_loaded(modules) == found


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mainnet-2p20.aggregates", "--seed", str(2**31 + 9),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no run" in out.err


def test_a_run_with_too_few_cards_exits_non_zero(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "mainnet-2p20.attestations", "--seed", "3", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def _ctx(subs, t0=100.0, seconds=10.0):
    w = drive.Window()
    w.t0, w.t_end, w.seconds, w.subs = t0, t0 + seconds, seconds, subs
    return Context(None, None, w, types.SimpleNamespace(calls=[]), 1.0)


def _sub(due, done, submitted=None):
    s = drive.Sub(0, 0, due, 1, 1)
    s.submitted = due if submitted is None else submitted
    s.accepted = True
    s.done = done
    return s


def test_latency_runs_from_the_due_time_so_a_stalled_generator_still_counts():
    read = spec.reader("att.verdict_p95_ms")
    # 100 payloads answered 10 ms after their due time; 10 more whose
    # submission the generator made 2 s late and that were answered 10 ms
    # after the late submission: each waited 2.01 s from its due time
    subs = [_sub(100.0 + i * 0.05, 100.0 + i * 0.05 + 0.010) for i in range(100)]
    subs += [_sub(105.0 + i * 0.01, 107.0 + i * 0.01 + 0.010, 107.0 + i * 0.01) for i in range(10)]
    assert read(_ctx(subs)) == pytest.approx(2010.0)
    # 6 of 110 never answered: the percentile falls on one of them
    for s in subs[:6]:
        s.done = None
    assert read(_ctx(subs)) == 1e9
    # payloads due after the window's end are not in its tail
    late = [_sub(100.0 + i * 0.05, 100.0 + i * 0.05 + 0.010) for i in range(100)]
    late += [_sub(111.0, 150.0) for _ in range(50)]
    assert read(_ctx(late)) == pytest.approx(10.0)


def test_sets_per_s_counts_verdicts_delivered_inside_the_window():
    read = spec.reader("sets_per_s")
    subs = [_sub(100.0, 100.5 + i) for i in range(12)]      # answered at 100.5 .. 111.5
    for s in subs:
        s.sets = 3
    assert read(_ctx(subs)) == pytest.approx(3 * 10 / 10.0)


def test_att_per_s_counts_payloads_answered_inside_the_window():
    read = spec.reader("att_per_s")
    # 100 due 100 ms apart and answered 450 ms later: the last 4 are owed at
    # the window's end; one more shed at the intake is never answered
    subs = [_sub(100.0 + i * 0.1, 100.0 + i * 0.1 + 0.45) for i in range(100)]
    shed = _sub(104.0, None)
    shed.accepted = False
    assert read(_ctx(subs + [shed])) == pytest.approx(96 / 10.0)


def test_every_seed_gets_the_same_arrival_gaps_and_sizes_in_another_order():
    segs = [{"from": 0.0, "to": 1.0, "rate": 250.0}]
    a = tg.arrivals(segs, 10.0, tg.rng_for(1))
    b = tg.arrivals(segs, 10.0, tg.rng_for(2**31 + 5))
    assert len(a) == len(b) == 2500 and a[-1] < 10.0 and a[0] > 0
    assert not np.allclose(a, b)
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0.0)))
    cfg = spec.load_json(os.path.join(spec.HERE, "configs", "gnosis-2p18.json"))
    params = spec.load_json(os.path.join(spec.HERE, "traffic", "aggregates.json"))
    ta = tg.plan(cfg, params, 7, 10.0)
    tb = tg.plan(cfg, params, -3, 10.0)
    assert len(ta.entries) == len(tb.entries) == 64 * 16 + 2
    ka = sorted(e.keys for e in ta.entries[:ta.pool_size])
    kb = sorted(e.keys for e in tb.entries[:tb.pool_size])
    assert ka == kb and min(ka) >= 2 + int(0.9 * 256) and max(ka) <= 2 + 256


def test_the_attestation_mix_puts_its_invalid_payloads_after_the_window():
    cfg = spec.load_json(os.path.join(spec.HERE, "configs", "mainnet-2p20.json"))
    params = spec.load_json(os.path.join(spec.HERE, "traffic", "attestations.json"))
    inv = params["invalid"]
    seen = []
    for seed in (5, 2**31 + 6):
        t = tg.plan(cfg, params, seed, 10.0)
        bad = t.sample[-inv["count"]:]
        assert len(t.due) == len(t.entries) and max(t.due) > 10.0
        assert all(inv["from"] * 10.0 <= t.due[e] < inv["to"] * 10.0 for e in bad)
        assert len(t.sample) == params["sample"] + inv["count"]
        seen.append(bad)
    assert seen[0] != seen[1]
    with pytest.raises(ValueError):
        tg.kind("no-such-kind")


def test_the_configurations_give_the_committee_widths_they_state():
    for name in ("mainnet-2p20", "gnosis-2p18"):
        cfg = spec.load_json(os.path.join(spec.HERE, "configs", f"{name}.json"))
        assert tg.committee_shape(cfg) == (cfg["committees_per_slot"], cfg["committee_width"])


def test_the_roofline_constants_count_the_program_s_products_at_a_tiny_shape():
    """The fitted a*K + b*n + c against the products the program's kernels
    do (counted at the kernel wrappers) in a call of 4 sets of 4 keys."""
    from benchmark.harness import fixtures
    from benchmark.tools import fit_roofline
    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    work = spec.load_json(os.path.join(spec.HERE, "metrics", "roofline_work.json"))
    a, b, c = (work["products"][k] for k in "abc")
    cache = pubkey_cache.device_pubkeys_from_raw(fixtures.registry_walk((0x1D0C5EED, 16)),
                                                 device="cpu")
    counted, _ = fit_roofline.count_products("cpu", 4, 4, cache, fm, backend)
    assert counted == pytest.approx(a * 16 + b * 4 + c, abs=0.5)
    assert work["int32_ops_per_product"] == 2 * 51 * 51
