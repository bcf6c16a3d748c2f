"""Small cells for the benchmark's CPU tests, and the ``card`` marker.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
Tests marked ``card`` drive the program on CUDA; each decides inside itself
whether a card is present and skips when none is.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402

TINY = {
    "name": "tiny-64",
    "preset": {"SLOTS_PER_EPOCH": 4, "TARGET_COMMITTEE_SIZE": 4, "MAX_COMMITTEES_PER_SLOT": 2,
               "MAX_VALIDATORS_PER_COMMITTEE": 2048, "TARGET_AGGREGATORS_PER_COMMITTEE": 16,
               "ATTESTATION_SUBNET_COUNT": 64, "SECONDS_PER_SLOT": 12},
    "validators": 64,
    "batch_limits": {"max_gossip_attestation_batch_size": 4, "max_gossip_aggregate_batch_size": 2},
    "base_secret_key": "0x1d0c5eed0009",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: drives the program on a CUDA card; skips without one")


def tiny_cell(kind: str, **overrides):
    """A cell of the small configuration (64 validators, committees of 8)
    with the named mix's parameters, cut to a few payloads."""
    bench = spec.benchmark(ROOT)
    name = f"tiny-64.{kind}"
    like = "aggregates" if kind == "aggregates" else "attestations"
    bench["workloads"].append({"name": name, "config": "tiny-64", "traffic": like, "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if any(w.endswith("." + like) for w in m.get("workloads", ())):
            m["workloads"].append(name)
    params = spec.load_json(os.path.join(spec.HERE, "traffic", f"{like}.json"))
    if kind == "aggregates":
        params.update(aggregators_per_committee=2, intake_depth=4, sample=2, wait_s=600,
                      invalid={"count": 2, "first": 4, "apart": 1})
    else:
        params.update(arrivals=[{"from": 0.0, "to": 1.0, "rate": 8.0},
                                {"from": 1.0, "to": 2.0, "rate": 8.0}],
                      sample=3, wait_s=600, invalid={"count": 6, "from": 1.0, "to": 2.0})
    params.update(overrides)
    return spec.Cell.from_parts(name, TINY, params, bench)


def stand_in(raw):
    """A sound verifier in the program's place (the reference, set by set):
    fast enough on the CPU to drive whole runs of the small cells."""
    from benchmark.reference import bls as rb

    hashes = rb.HashCache()
    return lambda items: all(rb.verify_set(raw, ix, m, s, hashes) for ix, m, s in items)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
