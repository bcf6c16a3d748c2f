"""The conformance runner's ``transition`` family on the CPU into capella,
deneb and electra, one case per fork: seven blocks across the fork boundary
at epoch 1, the block class switching at the boundary, every block's
signatures in one bulk batch through the ``bls`` device arm and the boundary
on the device epoch engine (on the old fork's state), the post-state root
held to the vector's (see test_torch_conformance.py and
test_torch_conformance_blocks.py)."""

import pytest

from test_torch_conformance import FORKS, _backends, _one_thread, run_family  # noqa: F401


@pytest.mark.parametrize("fork", ["capella", "deneb", "electra"])
def test_transition_on_the_cpu(tmp_path, fork):
    pre_fork = FORKS[FORKS.index(fork) - 1]
    assert run_family(tmp_path, "transition", (fork,)) == {(pre_fork, "device"): 1}
