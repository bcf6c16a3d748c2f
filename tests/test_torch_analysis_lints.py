"""The port's lints (passes 2 and 5) against the reference's.

The reference's fixture corpora (``tests/test_analysis.py``: the racy,
inverted, blocked, unjoined, pragma and except-path modules of the
concurrency certifier, the torn-write module of the durability lint) go
through both packages' passes and give the same (rule, line) findings. On
the port's own tree all three lints are clean with empty baselines. The
host-sync linter (the port's rewrite of the trace-hygiene pass for eager
PyTorch) flags each of its rules on a fixture corpus, honours its pragma
and baseline, and finds the device path clean.

The lockdep acceptance run, as the reference's: with the lock factories
instrumented, a threaded firehose rides its supervisor ladder through
injected transient faults and a 2-node loopback ``LocalNetwork`` (minimal
spec, 16 validators, 4 slots, one node crashed and restarted) runs its
slots; the observed lock-order graph is non-empty, its frames in the
port's package, and acyclic alone and merged with the static graph.
"""

import json
import os
import textwrap

import pytest
import torch

import test_analysis as ref_corpus  # the reference's fixture corpora
from lighthouse_tpu.analysis import concurrency as r_conc, durability as r_dur

from lighthouse_tpu_torch.analysis import concurrency, durability, hygiene


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONCURRENCY_CORPUS = {
    "racy": ref_corpus._RACY_MODULE,
    "inverted": ref_corpus._INVERTED_MODULE,
    "blocked": ref_corpus._BLOCKED_MODULE,
    "unjoined": ref_corpus._UNJOINED_MODULE,
    "pragma": ref_corpus._PRAGMA_MODULE,
    "annexc": ref_corpus._EXC_ANN_MODULE,
}


def _analyze(pkg, root, name, src):
    d = root / "fixmod"
    d.mkdir(parents=True)
    (d / f"{name}.py").write_text(src)
    _index, findings, _edges, cycles = pkg.analyze_tree(str(d))
    return sorted((f.rule, f.line) for f in findings), len(cycles)


@pytest.mark.parametrize("name", sorted(CONCURRENCY_CORPUS))
def test_concurrency_corpus_findings_equal_the_reference(tmp_path, name):
    src = CONCURRENCY_CORPUS[name]
    ref = _analyze(r_conc, tmp_path / "ref", name, src)
    port = _analyze(concurrency, tmp_path / "port", name, src)
    assert port == ref
    if name != "pragma":
        assert port[0], f"{name}: no finding"


def test_concurrency_baseline_survives_line_churn(tmp_path):
    """The baseline keys a finding by (path, rule, source line), so a shifted
    module keeps it suppressed; re-analysing the changed file (the parse is
    memoized per state of the sources) sees the shift."""
    d = tmp_path / "fixmod"
    d.mkdir()
    (d / "racy.py").write_text(ref_corpus._RACY_MODULE)
    _i, findings, _e, _c = concurrency.analyze_tree(str(d))
    assert findings
    baseline = {f.key() for f in findings}
    (d / "racy.py").write_text(ref_corpus._RACY_MODULE.replace(
        "import threading", "import threading\n"))
    _i, shifted, _e, _c = concurrency.analyze_tree(str(d))
    assert [f.line for f in shifted] == [f.line + 1 for f in findings]
    assert all(f.key() in baseline for f in shifted)


def test_durability_corpus_findings_equal_the_reference(tmp_path):
    p = tmp_path / "torn_fixture.py"
    p.write_text(ref_corpus._TORN_MODULE)
    ref = sorted((f.rule, f.line, f.context) for f in r_dur.lint_file(str(p), "torn.py"))
    port = sorted((f.rule, f.line, f.context) for f in durability.lint_file(str(p), "torn.py"))
    assert port == ref and len(port) == 2
    # the baseline round trip over a scoped tree
    pkg = tmp_path / "pkg" / "store"
    pkg.mkdir(parents=True)
    (pkg / "torn.py").write_text(ref_corpus._TORN_MODULE)
    found, sup = durability.lint_tree(root=str(tmp_path / "pkg"), baseline=set())
    assert len(found) == 2 and sup == 0
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([{"path": f.path, "rule": f.rule, "context": f.context}
                              for f in found]))
    left, sup = durability.lint_tree(root=str(tmp_path / "pkg"),
                                     baseline=durability.load_baseline(str(bl)))
    assert not left and sup == 2


def test_port_tree_is_clean_with_empty_baselines():
    findings, sup = hygiene.lint_tree()
    assert not findings and sup == 0, "\n".join(str(f) for f in findings)
    assert hygiene.load_baseline() == set()
    dur, sup = durability.lint_tree()
    assert not dur and sup == 0, "\n".join(str(f) for f in dur)
    assert durability.load_baseline() == set()
    cert = concurrency.certify_concurrency(observed_path="")
    assert cert["ok"] and cert["n_findings"] == 0 and cert["cycles"] == [], cert["findings"]
    assert concurrency.load_baseline() == set()
    # the pass covered the port's thread fabric, not an empty package
    assert cert["n_modules_threading"] >= 45
    assert cert["n_lock_classes"] >= 40
    edges = {(e["from"], e["to"]) for e in cert["lock_graph"]["edges"]}
    assert ("resilience.supervisor.BackendSupervisor._lock",
            "utils.metrics._Metric._lock") in edges


_HOST_SYNC_MODULE = textwrap.dedent(
    '''
    import functools
    import numpy as np
    import torch

    def reads(x: torch.Tensor):
        v = x.sum()
        a = v.item()
        b = float(v)
        c = x.cpu()
        d = x.tolist()
        return a, b, c, d, x.numpy()

    def branches(n):
        t = torch.zeros(n)
        if t.any():                   # fixture: branch on a tensor
            return 1
        while t.sum() > 0:            # fixture: loop on a tensor
            t = t - 1
        return 0

    @functools.lru_cache(maxsize=None)
    def builder(key):
        return key

    def caller():
        return builder([1, 2])        # fixture: unhashable cached argument

    def host_facts(x: torch.Tensor, lazy):
        if x.shape[0] > 4 and x.dtype == torch.int64:   # host facts: not findings
            return x
        if lazy is not None:                            # identity test: not a finding
            return x
        n = int(np.array([1, 2]).sum())                 # numpy: not a finding
        return builder((1, 2)), n, x.data_ptr()

    def allowed(x: torch.Tensor):
        return bool(x.any())          # lint: allow(host-sync)
    '''
)


def test_host_sync_corpus_flags_each_rule(tmp_path):
    p = tmp_path / "syncs.py"
    p.write_text(_HOST_SYNC_MODULE)
    findings = hygiene.lint_file(str(p), "syncs.py")
    assert {f.rule for f in findings} == set(hygiene.RULES)
    by_fn = {(f.rule, f.message.split(" in ")[-1].split(" ")[0]) for f in findings}
    assert ("host-sync", "reads") in by_fn and ("tensor-branch", "branches") in by_fn
    assert sum(1 for f in findings if f.rule == "host-sync") == 5
    assert sum(1 for f in findings if f.rule == "tensor-branch") == 2
    assert [f.rule for f in findings if "builder" in f.message] == ["cache-unhashable"]
    flagged = " ".join(f.message for f in findings)
    assert "host_facts" not in flagged and "allowed" not in flagged
    # the baseline suppresses by (path, rule, source line)
    found, sup = hygiene.lint_tree(root=str(tmp_path), baseline=set(), scope=("syncs.py",))
    assert len(found) == len(findings) and sup == 0
    left, sup = hygiene.lint_tree(root=str(tmp_path), baseline={f.key() for f in found},
                                  scope=("syncs.py",))
    assert not left and sup == len(findings)


def test_lockdep_under_chaos_is_acyclic():
    from lighthouse_tpu_torch import bls, epoch_engine
    from lighthouse_tpu_torch.firehose import FirehoseConfig, FirehoseEngine
    from lighthouse_tpu_torch.resilience import injector
    from lighthouse_tpu_torch.resilience.supervisor import BackendSupervisor, SupervisorConfig
    from lighthouse_tpu_torch.testing.local_network import LocalNetwork
    from lighthouse_tpu_torch.types.spec import minimal_spec

    owned = not concurrency.installed()
    if owned:
        concurrency.install()
    assert concurrency.lockdep_enabled()
    saved = (bls.get_backend(), bls.get_device(), epoch_engine.get_backend(),
             epoch_engine.get_device())
    try:
        concurrency.reset_observed()
        injector.install("stage=firehose.device_verify;mode=raise;kind=transient;every=3")
        sup = BackendSupervisor(
            "lockdep.acceptance",
            SupervisorConfig(deadline_s=10.0, backoff_base_s=0.001, backoff_max_s=0.002),
        )
        engine = FirehoseEngine(
            prepare_fn=lambda ps: [([p], None) for p in ps],
            verify_items_fn=lambda items: True,
            config=FirehoseConfig(max_batch=8),
            supervisor=sup,
            fallback_verify_fn=lambda items: True,
        )
        for i in range(64):
            engine.submit(i)
        engine.flush(timeout=20.0)
        assert engine.stop(drain_timeout=20.0)
        injector.clear()

        bls.set_backend("native")
        epoch_engine.set_backend("numpy")
        net = LocalNetwork(minimal_spec(), n_nodes=2, n_validators=16, device="cpu")
        net.transport.set_gossip_loss(0.05, seed=7)
        for slot in range(1, 5):
            net.run_slot(slot)
            if slot == 2:
                net.crash_node(1)
            if slot == 3:
                net.restart_node(1)

        report = concurrency.observed_report()
        assert report["n_locks"] > 0
        assert report["edges"], "the run recorded no lock order"
        # the lock ids name the port's own classes and sites
        ids = {e["from"] for e in report["edges"]} | {e["to"] for e in report["edges"]}
        assert not any("lighthouse_tpu/" in i for i in ids)
        assert any(i.startswith(("firehose.", "resilience.", "network.", "beacon_chain.",
                                 "utils.")) for i in ids), ids
        alone = concurrency.merge_observed({}, report["edges"])
        assert alone["ok"], alone["merged_cycles"]
        _index, _f, static_edges, _c = concurrency.analyze_tree()
        merged = concurrency.merge_observed(static_edges, report["edges"])
        assert merged["ok"], merged["merged_cycles"]
        assert merged["n_observed_edges"] > 0
        assert any(v["acquisitions"] > 0 for v in report["holds"].values())
    finally:
        injector.clear()
        bls.set_backend(saved[0], device=saved[1])
        epoch_engine.set_backend(saved[2], device=saved[3])
        if owned:
            concurrency.uninstall()
    assert not concurrency.lockdep_enabled() or not owned


def test_cert_dir_is_the_build_directory():
    from lighthouse_tpu_torch.analysis import memory

    d = memory.cert_dir()
    assert d.endswith(os.path.join("lighthouse_tpu_torch", "_build", "analysis"))
    assert concurrency.OBSERVED_DEFAULT_PATH.startswith(d)
