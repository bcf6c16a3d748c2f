"""The conformance runner's ``finality`` family on the CPU, the electra case:
31 signed blocks over four epoch boundaries (each on the device epoch engine),
every block's signatures in one bulk batch through the ``bls`` device arm
(~5 s a block in the kernels' plain versions, so each fork's case has a file
of its own), the justified and finalized epochs and the post-state root held
to the vector's (see test_torch_conformance.py)."""

from test_torch_conformance import _backends, _one_thread, run_family  # noqa: F401


def test_finality_electra_on_the_cpu(tmp_path):
    assert run_family(tmp_path, "finality", ("electra",)) == {("electra", "device"): 4}
