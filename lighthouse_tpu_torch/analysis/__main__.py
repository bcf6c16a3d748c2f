"""``python -m lighthouse_tpu_torch.analysis`` — run the six-pass certifier suite.

The port of ``lighthouse_tpu/analysis/__main__.py``. Exit code 0 iff every
selected pass is clean. ``--json`` emits one machine-readable report on
stdout; the default output is human-oriented. ``--bounds`` / ``--lint`` /
``--recompile`` / ``--supervisor`` / ``--concurrency`` / ``--memory``
select passes; with no selection all six run:

1. **bounds** — the limb-bound certifier (``BOUNDS_CERT.json``), on the
   meta device;
2. **lint** — the host-sync linter over the device path, and the
   durability lint over the persistence packages;
3. **recompile** — the build sentinel's probe (a warm kernel loop on
   ``--device`` builds nothing);
4. **supervisor** — the supervisor-transparency probe on ``--device``;
5. **concurrency** — the lock-discipline certifier and lock-order graph
   (``CONCURRENCY_CERT.json``), merging an observed lockdep graph
   (``--observed``, or ``LOCKDEP_OBSERVED.json`` beside the certificates);
6. **memory** — the device-memory certifier and footprint planner
   (``MEMORY_CERT.json``): graph footprints on the meta device, the
   shared-memory walk, the residency models, the per-tier planner.

``--device`` (default ``cuda``; tests pass ``cpu``) is where the two probes
run. The certificates are written under ``lighthouse_tpu_torch/_build/
analysis/`` (``--cert-dir``), never to the repository root; ``-`` skips a
certificate. When bounds and memory both run, the registry runs once for
both (the memory walk records the bounds' obligations).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from .memory import cert_dir

    ap = argparse.ArgumentParser(prog="lighthouse_tpu_torch.analysis")
    ap.add_argument("--json", action="store_true", help="machine-readable report")
    ap.add_argument("--bounds", action="store_true", help="run the limb-bound certifier")
    ap.add_argument("--lint", action="store_true",
                    help="run the host-sync linter and the durability lint")
    ap.add_argument("--recompile", action="store_true", help="run the build-sentinel probe")
    ap.add_argument("--supervisor", action="store_true",
                    help="run the supervisor-transparency probe")
    ap.add_argument("--concurrency", action="store_true",
                    help="run the concurrency certifier (lock discipline + deadlock graph)")
    ap.add_argument("--memory", action="store_true",
                    help="run the device-memory certifier and footprint planner")
    ap.add_argument("--device", default="cuda",
                    help="where the recompile and supervisor probes run (default cuda)")
    ap.add_argument("--cert-dir", default=None,
                    help="directory of the certificates (default lighthouse_tpu_torch/_build/analysis)")
    ap.add_argument("--cert-out", default=None, help="BOUNDS_CERT.json path ('-' to skip)")
    ap.add_argument("--concurrency-cert-out", default=None,
                    help="CONCURRENCY_CERT.json path ('-' to skip)")
    ap.add_argument("--memory-cert-out", default=None, help="MEMORY_CERT.json path ('-' to skip)")
    ap.add_argument("--observed", default=None,
                    help="lockdep observed-graph JSON to merge into the concurrency cert")
    ap.add_argument("--graphs", nargs="*", default=None,
                    help="restrict certification to graphs whose name contains any substring")
    ap.add_argument("--batches", nargs="*", type=int, default=None,
                    help="batch regimes to certify (default 1 32)")
    args = ap.parse_args(argv)
    any_selected = (
        args.bounds or args.lint or args.recompile or args.supervisor
        or args.concurrency or args.memory
    )
    run_bounds = args.bounds or not any_selected
    run_lint = args.lint or not any_selected
    run_recompile = args.recompile or not any_selected
    run_supervisor = args.supervisor or not any_selected
    run_concurrency = args.concurrency or not any_selected
    run_memory = args.memory or not any_selected
    out_dir = args.cert_dir or cert_dir()

    def out_path(given, name):
        if given == "-":
            return None
        return given or os.path.join(out_dir, name)

    def say(msg):
        if not args.json:
            print(msg, file=sys.stderr)

    report: dict = {"ok": True, "device": args.device}

    def verdict(ok):
        if not ok:
            report["ok"] = False

    if run_supervisor:
        from .supervised import supervisor_probe

        rep = supervisor_probe(args.device)
        report["supervisor"] = rep
        verdict(rep["ok"])
        say(f"supervisor: {len(rep['lint_findings'])} lint finding(s), "
            f"{len(rep['steady_state_builds'])} steady-state build(s), "
            f"transparent={rep['transparent']}, right_device={rep['right_device']} — "
            f"{'ok' if rep['ok'] else 'FAIL'}")

    if run_recompile:
        from .recompile import recompile_probe

        rep = recompile_probe(args.device)
        report["recompile"] = rep
        verdict(rep["ok"])
        say(f"recompile: {len(rep['steady_state_builds'])} steady-state build(s) — "
            f"{'ok' if rep['ok'] else 'FAIL'}")

    if run_lint:
        from .durability import lint_tree as durability_lint_tree
        from .hygiene import lint_tree

        findings, suppressed = lint_tree()
        dur, dur_suppressed = durability_lint_tree()
        report["lint"] = {
            "ok": not findings and not dur,
            "n_findings": len(findings),
            "n_baseline_suppressed": suppressed,
            "findings": [f.as_dict() for f in findings],
            "n_durability_findings": len(dur),
            "n_durability_baseline_suppressed": dur_suppressed,
            "durability_findings": [f.as_dict() for f in dur],
        }
        verdict(report["lint"]["ok"])
        for f in findings + dur:
            say(str(f))
        say(f"lint: {len(findings)} finding(s), {suppressed} baseline-suppressed; durability: "
            f"{len(dur)} finding(s), {dur_suppressed} baseline-suppressed — "
            f"{'FAIL' if findings or dur else 'ok'}")

    if run_concurrency:
        from .concurrency import OBSERVED_DEFAULT_PATH, certify_concurrency
        from .concurrency import write_cert as write_ccert

        observed = args.observed
        if observed is None:
            default_obs = os.path.join(out_dir, os.path.basename(OBSERVED_DEFAULT_PATH))
            observed = default_obs if os.path.exists(default_obs) else ""
        ccert = certify_concurrency(observed_path=observed)
        path = out_path(args.concurrency_cert_out, "CONCURRENCY_CERT.json")
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            write_ccert(ccert, path)
        report["concurrency"] = {
            "ok": ccert["ok"],
            "n_findings": ccert["n_findings"],
            "n_baseline_suppressed": ccert["n_baseline_suppressed"],
            "n_modules_threading": ccert["n_modules_threading"],
            "n_lock_classes": ccert["n_lock_classes"],
            "n_edges": len(ccert["lock_graph"]["edges"]),
            "cycles": ccert["cycles"],
            "lockdep_ok": ccert["lockdep"]["ok"],
            "n_observed_edges": ccert["lockdep"]["n_observed_edges"],
            "findings": ccert["findings"],
            "cert_path": path,
        }
        verdict(ccert["ok"])
        for f in ccert["findings"]:
            say(f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
        for cyc in ccert["cycles"]:
            say(f"lock-order cycle: {cyc}")
        say(f"concurrency: {ccert['n_findings']} finding(s), {ccert['n_baseline_suppressed']} "
            f"baseline-suppressed, {len(ccert['lock_graph']['edges'])} lock-order edge(s), "
            f"{len(ccert['cycles'])} cycle(s), {ccert['lockdep']['n_observed_edges']} observed "
            f"edge(s) — {'ok' if ccert['ok'] else 'FAIL'}")

    batches = tuple(args.batches) if args.batches else (1, 32)
    sink = None
    if run_memory:
        from .bounds import CertSink
        from .memory import certify_memory
        from .memory import write_cert as write_mcert

        sink = CertSink() if run_bounds else None
        mcert = certify_memory(batches=batches, graphs=args.graphs, sink=sink)
        path = out_path(args.memory_cert_out, "MEMORY_CERT.json")
        if path:
            write_mcert(mcert, path)
        report["memory"] = {
            "ok": mcert["ok"],
            "n_rows": mcert["n_rows"],
            "n_failed": mcert["n_failed"],
            "tiers": sorted(mcert["tiers"]),
            "default_tier": mcert["default_tier"],
            "peaks": mcert["peaks"],
            "planner": mcert["planner"],
            "n_smem_rows": sum(1 for r in mcert["rows"] if r["kind"] == "smem_tile"),
            "failed_rows": [r for r in mcert["rows"] if not r["ok"]],
            "cert_path": path,
        }
        verdict(mcert["ok"])
        for r in mcert["rows"]:
            if not r["ok"]:
                say(f"OVER-BUDGET {r}")
        say(f"memory: {mcert['n_rows']} row(s), {mcert['n_failed']} over budget, tiers "
            f"{'/'.join(sorted(mcert['tiers']))} — {'ok' if mcert['ok'] else 'FAIL'}")

    if run_bounds:
        from .bounds import cert_from_sink, certify
        from .bounds import write_cert as write_bcert

        cert = cert_from_sink(sink, batches) if sink is not None else certify(
            batches=batches, graphs=args.graphs)
        path = out_path(args.cert_out, "BOUNDS_CERT.json")
        if path:
            write_bcert(cert, path)
        report["bounds"] = {
            "ok": cert["ok"],
            "n_obligations": cert["n_obligations"],
            "n_failed": cert["n_failed"],
            "min_margin_bits": cert["min_margin_bits"],
            "smem_limit": cert["smem_limit"],
            "cert_path": path,
        }
        verdict(cert["ok"])
        for r in cert["obligations"]:
            if not r["ok"]:
                say(f"UNPROVEN {r}")
        say(f"bounds: {cert['n_obligations']} obligations, {cert['n_failed']} failed, min "
            f"margin {cert['min_margin_bits']} bits — {'ok' if cert['ok'] else 'FAIL'}")

    if args.json:
        print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
