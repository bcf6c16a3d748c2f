"""Cells, configurations, mixes and metric readers, found by name.

``BENCHMARK.json`` at the checkout's root lists them. A cell names a
configuration (its ``file`` under ``benchmark/configs/``) and a mix
(``benchmark/traffic/<traffic>.json``, whose payload kind is
``benchmark/payloads/<payload>.py``). Each metric, end to end or per layer, is read by
``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns a number or
None when the run has nothing to read for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration and mix."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        cfg_entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic_name = self.workload["traffic"]
        self.params = load_json(os.path.join(HERE, "traffic", f"{self.traffic_name}.json"))
        self.chips = int(self.workload["chips"])
        self.bench = bench

    @classmethod
    def from_parts(cls, name: str, config: dict, params: dict, bench: dict, chips: int = 1):
        """A cell made in memory (the tests' small cells)."""
        self = cls.__new__(cls)
        self.workload = {"name": name, "config": config["name"], "traffic": "", "chips": chips}
        self.name, self.config, self.params = name, config, dict(params)
        self.traffic_name, self.chips, self.bench = "", chips, bench
        return self

    def _applies(self, metric: dict, reported: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves") in reported if "moves" in metric else True

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m, set())]

    def per_layer(self) -> list:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"] if self._applies(m, reported)]


def reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
