"""The conformance runner's block families on the CPU, one case per fork:
``sanity_blocks`` (three signed blocks over a harness chain) at every fork and
``transition`` into altair and bellatrix (seven blocks across the fork
boundary at epoch 1, the block class switching there). Each block's
signatures go in one bulk batch through the ``bls`` device arm (the kernels'
plain versions), the boundary runs on the device epoch engine, and the
post-state root is held to the vector's (see test_torch_conformance.py; the
later transitions are in test_torch_conformance_transition.py)."""

import pytest

from test_torch_conformance import FORKS, _backends, _one_thread, run_family  # noqa: F401


@pytest.mark.parametrize("fork", FORKS)
def test_sanity_blocks_on_the_cpu(tmp_path, fork):
    assert run_family(tmp_path, "sanity_blocks", (fork,)) == {}


@pytest.mark.parametrize("fork", ["altair", "bellatrix"])
def test_transition_on_the_cpu(tmp_path, fork):
    pre_fork = FORKS[FORKS.index(fork) - 1]
    assert run_family(tmp_path, "transition", (fork,)) == {(pre_fork, "device"): 1}
