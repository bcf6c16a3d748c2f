"""The port's conformance runner and generator against the checked-in vectors.

``lighthouse_tpu_torch.conformance`` is the port's copy of the reference's
EF-style runner: ``run_all(root, runners, *, device)`` walks
``tests/vectors/<config>/<fork>/<runner>/<handler>/<case>``, runs every case
with the bls, epoch and KZG backends on ``"device"`` at ``device`` (here the
CPU: the kernels' plain versions), runs each BLS case on the oracle, native
and device backends, and fails on any vector file it did not consume.

Each runner family is a case of its own, run over a copy of the tree that
holds only that family (the all-files-consumed rule applies to the copy),
so every family counts; the state families with many blocks are split by
fork over ``tests/test_torch_conformance_*.py`` (one CPU batch verify per
block is ~5 s). ``test_every_family_is_covered`` holds the union of those
cases to the tree on disk. The port's generator writes families byte-equal
to the checked-in ones, and its ``StateHarness`` produces the reference
harness's blocks.
"""

import json
import os
import shutil

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu.testing import StateHarness as RHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch.conformance import ConformanceError, default_vector_root, run_all
from lighthouse_tpu_torch.conformance import generate as pgen
from lighthouse_tpu_torch.conformance import handler
from lighthouse_tpu_torch.kzg import engine as p_kzg
from lighthouse_tpu_torch.testing import StateHarness as PHarness
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors")
FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb", "electra")
BLOCK_FAMILIES = ("sanity_blocks", "transition", "finality")
# (runner, forks) of every case of the port's conformance tests: this file's
# LIGHT families over all their forks, and the block families by fork in
# test_torch_conformance_{blocks,transition,finality}.py
LIGHT = ("bls", "shuffling", "ssz_static", "operations", "rewards", "epoch_processing", "kzg",
         "kzg_cells")
COVERAGE = {
    **{f: None for f in LIGHT},
    "sanity_blocks": FORKS,
    "transition": FORKS[1:],
    "finality": ("phase0", "altair", "electra"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _backends():
    saved = (p_bls.get_backend(), p_bls.get_device(), p_epoch.get_backend(), p_epoch.get_device(),
             p_kzg.get_kzg_backend(), p_kzg.get_kzg_device(), r_bls.get_backend(),
             r_epoch.get_backend())
    yield
    p_bls.set_backend(saved[0], device=saved[1])
    p_epoch.set_backend(saved[2], device=saved[3])
    p_kzg.set_kzg_backend(saved[4], device=saved[5])
    r_bls.set_backend(saved[6])
    r_epoch.set_backend(saved[7])


def family_tree(tmp_path, runner, forks=None):
    """A copy of the vector tree holding only ``runner`` (at ``forks``, or
    every fork that has it); returns (root, the number of cases in it)."""
    root = tmp_path / "vectors"
    n = 0
    for config in sorted(os.listdir(VECTORS)):
        for fork in sorted(os.listdir(os.path.join(VECTORS, config))):
            src = os.path.join(VECTORS, config, fork, runner)
            if os.path.isdir(src) and (forks is None or fork in forks):
                shutil.copytree(src, root / config / fork / runner)
                n += sum(len(os.listdir(os.path.join(src, h))) for h in os.listdir(src))
    assert n > 0, (runner, forks)
    return str(root), n


def run_family(tmp_path, runner, forks=None):
    """run_all over the family's copy on the CPU: every case passes, every
    file consumed; returns the epoch boundaries it ran, by (fork, path)."""
    root, n = family_tree(tmp_path, runner, forks)
    p_epoch.reset_boundary_counts()
    assert run_all(root, device="cpu") == n
    bounds = p_epoch.boundary_counts()
    assert not [k for k in bounds if k[1] != "device"], bounds  # every boundary on the engine
    return bounds


def test_vector_tree_is_the_checked_in_one():
    assert os.path.realpath(default_vector_root()) == os.path.realpath(VECTORS)
    cases = [d for d, subdirs, files in os.walk(VECTORS) if files]
    assert len(cases) == 99
    assert sum(len(files) for _, _, files in os.walk(VECTORS)) == 343


def test_every_family_is_covered():
    on_disk = {}
    for config in os.listdir(VECTORS):
        for fork in os.listdir(os.path.join(VECTORS, config)):
            for runner in os.listdir(os.path.join(VECTORS, config, fork)):
                on_disk.setdefault(runner, set()).add(fork)
    assert set(on_disk) == set(COVERAGE)
    for runner, forks in COVERAGE.items():
        if forks is not None:
            assert on_disk[runner] == set(forks), runner
    assert set(handler._RUNNERS) == set(COVERAGE)


@pytest.mark.parametrize("runner", LIGHT)
def test_run_all_family_on_the_cpu(tmp_path, runner, monkeypatch):
    backends = []
    real = handler._run_bls_case
    monkeypatch.setattr(handler, "_run_bls_case",
                        lambda h, data, backend: (backends.append(backend), real(h, data, backend)))
    bounds = run_family(tmp_path, runner)
    if runner == "bls":  # the BLS matrix: every case on all three backends
        assert len(backends) == 3 * 11
        assert set(backends) == {"oracle", "native", "device"}
    if runner == "epoch_processing":
        assert bounds == {(f, "device"): 1 for f in FORKS}


# -- the runner's own rules ------------------------------------------------------------------


def test_unconsumed_file_fails(tmp_path):
    root, _ = family_tree(tmp_path, "shuffling")
    stray = os.path.join(root, "minimal", "phase0", "shuffling", "core", "case_0", "extra.bin")
    with open(stray, "wb") as f:
        f.write(b"orphan")
    with pytest.raises(ConformanceError, match="never consumed"):
        run_all(root, device="cpu")


def test_corrupt_vector_fails(tmp_path):
    root, _ = family_tree(tmp_path, "shuffling")
    p = os.path.join(root, "minimal", "phase0", "shuffling", "core", "case_0", "mapping.json")
    with open(p) as f:
        data = json.load(f)
    data["mapping"][0], data["mapping"][1] = data["mapping"][1], data["mapping"][0]
    with open(p, "w") as f:
        json.dump(data, f)
    with pytest.raises(ConformanceError):
        run_all(root, device="cpu")


def test_unrequested_runner_fails(tmp_path):
    root, _ = family_tree(tmp_path, "shuffling")
    with pytest.raises(ConformanceError, match="not requested"):
        run_all(root, runners=["bls"], device="cpu")
    assert run_all(root, runners=["shuffling"], device="cpu") == 3


def test_run_all_takes_its_device_and_restores_the_backends(tmp_path):
    root, n = family_tree(tmp_path, "epoch_processing")
    p_bls.set_backend("oracle")
    p_epoch.set_backend("numpy")
    p_kzg.set_kzg_backend("host")
    with pytest.raises(TypeError):
        run_all(root)  # no device: it is never implied
    seen = []
    assert run_all(root, device="cpu",
                   observer=lambda *a: seen.append((a[0], p_epoch.get_backend(),
                                                    p_epoch.get_device().type))) == n
    assert {s[1:] for s in seen} == {("device", "cpu")}
    assert [s[0] for s in seen] == ["start", "end"] * len(FORKS)
    assert (p_bls.get_backend(), p_epoch.get_backend(), p_kzg.get_kzg_backend()) == (
        "oracle", "numpy", "host")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_all(root, device="cuda")  # never run on the CPU in its place


# -- the generator and the harness -----------------------------------------------------------


@pytest.mark.parametrize("family", ["bls", "shuffling", "ssz_static", "operations"])
def test_generate_is_byte_equal_to_the_checked_in_vectors(tmp_path, family):
    out = tmp_path / "gen"
    n = pgen.generate(str(out), [family])
    assert n > 0
    for dirpath, _, files in os.walk(out):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), out)
            with open(os.path.join(dirpath, name), "rb") as a, open(os.path.join(VECTORS, rel), "rb") as b:
                assert a.read() == b.read(), rel
    on_disk = [rel for rel in _files(VECTORS) if rel.split(os.sep)[2] == family
               and not (family == "operations" and rel.split(os.sep)[1] != "phase0")]
    assert sorted(_files(str(out))) == sorted(on_disk)


def _files(root):
    return [os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs]


def test_generate_never_writes_the_checked_in_tree(tmp_path):
    with pytest.raises(ValueError, match="never rewrites"):
        pgen.generate(default_vector_root(), ["shuffling"])
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "f").write_bytes(b"")
    with pytest.raises(ValueError, match="already holds files"):
        pgen.generate(str(tmp_path / "x"), ["shuffling"])
    assert pgen.main([]) == 2


@pytest.mark.parametrize("fork", ["altair", "electra"])
def test_state_harness_blocks_equal_the_reference(fork):
    """The port's StateHarness (signing natively) produces the reference
    harness's blocks, attestations and states, byte for byte."""
    r_bls.set_backend("native")
    p_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_epoch.set_backend("device", device="cpu")
    over = pgen.fork_overrides(fork)
    rh, ph = RHarness(r_minimal(**over), 32), PHarness(p_minimal(**over), 32)
    assert ph.state.serialize() == rh.state.serialize()
    rh.extend_chain(9)  # across the first epoch boundary
    ph.extend_chain(9)
    assert ph.state.serialize() == rh.state.serialize()
    slot = int(rh.state.slot)
    ratts = rh.attestations_for_slot(rh.state, slot, rh.head_root(rh.state))
    patts = ph.attestations_for_slot(ph.state, slot, ph.head_root(ph.state))
    assert [a.serialize() for a in patts] == [a.serialize() for a in ratts]
    rb = rh.produce_block(slot + 1, attestations=ratts)
    pb = ph.produce_block(slot + 1, attestations=patts)
    assert pb.serialize() == rb.serialize()
    assert [s.serialize() for s in ph.signed_aggregate_and_proofs(ph.state, slot, ph.head_root(ph.state))] == [
        s.serialize() for s in rh.signed_aggregate_and_proofs(rh.state, slot, rh.head_root(rh.state))]
