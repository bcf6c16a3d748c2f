"""The port's memory pass (pass 6), its fault enrichment and the CLI.

The five residency models equal the bytes of the port's real structures at
small sizes (the epoch mirror on one device and in 4 row blocks, the
slasher's span planes, the light-client committee cache, the KZG engine's
tables at a tiny insecure geometry, the firehose's staged batch on one
device and over 4 shards), and the reference's models at the same
configuration, or differ by the layout difference each names. The pow2
bucket twins the three allocation sites' buckets. The planner is monotone
in the tier; ``rung_fit`` gates an oversized slasher rung; the seeded
over-budget rows (a widened plane, an unbounded pad, a shared-memory cap
below a schedule) turn the certificate red; an ``oom`` fault record on
``epoch_device`` carries its memory context. ``main(["--json", "--device",
"cpu", ...])`` runs all six passes, exits 0 and writes nothing inside the
repository tree.
"""

import contextlib
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lighthouse_tpu  # noqa: F401  (jax x64)
from lighthouse_tpu.analysis import memory as r_mem

from lighthouse_tpu_torch.analysis import __main__ as cli, memory
from lighthouse_tpu_torch.analysis.bounds import Spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pow2_bucket_twins_every_allocation_site():
    from lighthouse_tpu_torch.epoch_engine import kernels as ek
    from lighthouse_tpu_torch.firehose import sharding as fs
    from lighthouse_tpu_torch.slasher import engine as se

    for n in (1, 7, 255, 256, 257, 5000, 262_144, 1_048_576):
        assert memory._pow2_bucket(n, 256) == ek.bucket(n) == r_mem._pow2_bucket(n, 256)
        assert memory._pow2_bucket(n, 256) == se._bucket(n, 256)
        assert memory._pow2_bucket(n, 4) == fs._bucket(n, floor=4)


def _validators(n):
    from lighthouse_tpu_torch.epoch_engine.kernels import FAR_FUTURE_EPOCH

    return [
        SimpleNamespace(
            effective_balance=32_000_000_000, slashed=False, activation_epoch=0,
            exit_epoch=FAR_FUTURE_EPOCH, withdrawable_epoch=FAR_FUTURE_EPOCH,
            activation_eligibility_epoch=0, withdrawal_credentials=b"\x01" + bytes(31),
        )
        for _ in range(n)
    ]


@pytest.mark.parametrize("mesh", [None, 4])
def test_epoch_mirror_model_equals_its_columns(mesh):
    from lighthouse_tpu_torch.epoch_engine.mirror import RegistryMirror

    state = SimpleNamespace(validators=_validators(300))
    m = RegistryMirror(torch.device("cpu"), None if mesh is None else ["cpu"] * mesh)
    m._full_gather(state, 300)
    cols = [c for col in m.cols.values() for c in (col if isinstance(col, list) else [col])]
    got = memory.tensor_bytes(cols)
    assert got == m.stats.host_to_device_bytes
    want = memory.epoch_mirror_bytes(300, include_epoch_planes=False, mesh_devices=mesh or 1)
    assert got == want * (mesh or 1)
    if mesh:
        per_block = [sum(col[s].nbytes for col in m.cols.values()) for s in range(mesh)]
        assert per_block == [want] * mesh
    # the reference's model at the same registry (its columns are u64/bool too)
    assert memory.epoch_mirror_bytes(300) == r_mem.epoch_mirror_bytes(300)


def test_slasher_planes_model_equals_the_planes():
    from lighthouse_tpu_torch.slasher import engine as se, kernels as sk

    for v, hist in ((1000, 64), (5000, 16)):
        planes = sk.empty_planes(se._bucket(v, 256), hist, "cpu")
        got = memory.tensor_bytes(planes)
        assert got == memory.slasher_span_bytes(v, history=hist)
        assert got == r_mem.slasher_span_bytes(v, history=hist)


def test_lc_committee_cache_model_equals_the_cache():
    from lighthouse_tpu_torch.light_client.engine import LcEngine
    from lighthouse_tpu_torch.types.spec import minimal_spec

    spec = minimal_spec(altair_fork_epoch=0)
    c = int(spec.preset.SYNC_COMMITTEE_SIZE)
    for p in (1, 5):
        eng = LcEngine(spec, device="cpu")
        eng._host_rows = [np.zeros((c, 3, 25), np.int64) for _ in range(p)]
        cache = eng.cache_arr()
        assert memory.tensor_bytes([cache]) == memory.lc_committee_cache_bytes(p, c)
        assert memory.lc_committee_cache_bytes(p, c) == r_mem.lc_committee_cache_bytes(p, c)


def test_kzg_tables_model_equals_the_built_tables():
    from lighthouse_tpu_torch.kzg import Kzg
    from lighthouse_tpu_torch.kzg.cells import CellContext
    from lighthouse_tpu_torch.kzg.engine import CellEngine
    from lighthouse_tpu_torch.kzg.setup import insecure_setup

    ctx = CellContext(Kzg(insecure_setup(16, n_g2=5)), cells_per_ext_blob=8)
    eng = CellEngine(ctx, device="cpu")
    got = memory.tensor_bytes(list(eng.tables()) + [eng.z2_tab])
    assert got == memory.kzg_table_bytes(cells=ctx.cells, k=ctx.k)
    # the layout differences the model names: perm int64 (the reference's is
    # int32) and the two G2 points' z rows, kept beside their x and y rows
    assert got == r_mem.kzg_table_bytes(cells=ctx.cells, k=ctx.k) + 4 * ctx.k + 2 * 2 * 25 * 8


def test_firehose_staging_model_equals_the_staged_batches():
    from lighthouse_tpu_torch.bls import backend, sharded

    items = [([0, 1, 2], b"msg-%d" % i, bytes(96)) for i in range(3)]
    b = backend.prepare_batch(items, device="cpu")
    n_pad, k_pad = b["idx"].shape
    got = memory.tensor_bytes(b.values())
    assert got == memory.staged_tick_bytes(n_pad, k_pad)
    assert got == memory.firehose_staging_bytes(max_batch=3, prep_depth=0, k_pad=k_pad)
    shard_items = [items[:2], items[2:], [], items[:1]]
    staged = sharded.stage_indexed_shards(shard_items, shard_cap=4)
    put = sharded.put_staged(staged, ["cpu"] * 4)
    tensors = [t for sh in put["shards"] for t in sh.values() if isinstance(t, torch.Tensor)]
    got4 = memory.tensor_bytes(tensors)
    assert got4 == memory.firehose_staging_bytes(
        max_batch=4, prep_depth=0, k_pad=staged["k_pad"], n_shards=4)
    # the reference's model: idx is int32 there (5 bytes per key column, 9 here)
    ref = r_mem.firehose_staging_bytes(max_batch=4, prep_depth=0, k_pad=staged["k_pad"],
                                       n_shards=4)
    assert got4 == ref + staged["n_pad"] * 4 * staged["k_pad"]


def test_graph_footprint_tracks_storages_not_pointers():
    """On meta every data_ptr is 0: storages are told apart by identity, a
    view adds no bytes, a dead intermediate frees its bytes."""
    def graph(a):
        t = a + 1                   # new storage
        v = t[..., :5]              # view: no bytes
        u = v * 2                   # new storage
        del t, v
        w = u + 1                   # the first sum is dead by now
        return w

    fp = memory.graph_footprint(graph, (Spec((64, 25)),))
    one = memory.alloc_bytes(64 * 25 * 8)
    five = memory.alloc_bytes(64 * 5 * 8)
    assert fp["arg_bytes"] == one and fp["out_bytes"] == five
    assert fp["temp_bytes"] == one + 2 * five
    assert fp["peak_bytes"] == one + one + five


def test_planner_monotone_rung_gate_and_seeded_red_rows():
    tiers = {"small": {"hbm_bytes": 1 << 20, "smem_block_optin_bytes": 232448},
             **memory.DEVICE_TIERS}
    cert = memory.certify_memory(batches=(1, 32), graphs=["fq.mont_mul"], tiers=tiers)
    assert cert["ok"], [r for r in cert["rows"] if not r["ok"]][:3]
    kinds = {r["kind"] for r in cert["rows"]}
    assert {"graph_footprint", "smem_tile", "residency"} <= kinds
    for graph in cert["peaks"]:
        got = [memory.max_safe_shape(graph, t, cert=cert) for t in ("small", "h100_80gb",
                                                                    "cpu_proxy")]
        assert all(b is not None for b in got) and got == sorted(got), (graph, got)
    # a 2^20-validator slasher rung at a 16384-epoch window (128 GiB of planes)
    # does not fit the card; at 32k validators it does
    v = memory.rung_fit("slasher", 0, 0, 1 << 20, 0, slasher_history=16384)
    assert not v["fits"] and v["margin_bytes"] < 0 and v["domain"] == "slasher"
    assert memory.rung_fit("slasher", 0, 0, 32_768, 0, slasher_history=16384)["fits"]
    assert memory.rung_fit("slasher", 0, 0, 1 << 20, 0, tier="cpu_proxy",
                           slasher_history=16384)["fits"]
    # seeded red rows: a widened plane, an unbounded pad, a shared-memory cap
    red = memory.certify_memory(batches=(1,), graphs=["fq.mont_mul"], slasher_history=1 << 24)
    bad = [r for r in red["rows"] if not r["ok"]]
    assert not red["ok"] and bad and all("slasher_spans" in r["graph"] for r in bad)
    rows = memory.certify_graph_callable(
        lambda x: torch.zeros((1 << 38,), dtype=torch.int32, device=x.device),
        (Spec((1,)),))
    assert not rows[0]["ok"] and rows[0]["min_tier"] is None
    tight = {"h100_80gb": {**memory.DEVICE_TIERS["h100_80gb"], "smem_block_optin_bytes": 4096}}
    small_smem = [r for r in memory.smem_walk(tight) if not r["ok"]]
    assert small_smem and all(r["smem_bytes"] > 4096 for r in small_smem)


def test_oom_fault_record_on_epoch_device_carries_memory_context():
    from lighthouse_tpu_torch.resilience import faults

    rec = faults.record_fault("epoch.sweep", MemoryError("CUDA out of memory"),
                              domain="epoch_device")
    assert rec.kind is faults.FaultKind.OOM
    assert rec.memory is not None
    assert rec.memory["tier"] == "h100_80gb"
    assert rec.memory["tier_hbm_bytes"] == memory.DEVICE_TIERS["h100_80gb"]["hbm_bytes"]
    assert rec.as_dict()["memory"] == rec.memory
    other = faults.record_fault("epoch.sweep", RuntimeError("UNAVAILABLE: reset by peer"),
                                domain="epoch_device")
    assert other.memory is None and "memory" not in other.as_dict()


def _tree_files():
    out = set()
    for dirpath, dirnames, filenames in os.walk(REPO):
        dirnames[:] = [d for d in dirnames if d not in (".git", "__pycache__")]
        out.update(os.path.join(dirpath, f) for f in filenames)
    return out


def test_cli_runs_every_pass_on_cpu_and_writes_nothing_in_the_tree(tmp_path):
    before = _tree_files()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--json", "--device", "cpu", "--cert-dir", str(tmp_path),
                       "--graphs", "fq.mont_mul", "tower.fq2_mul", "--batches", "1"])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and rep["ok"], rep
    for name in ("bounds", "lint", "recompile", "supervisor", "concurrency", "memory"):
        assert rep[name]["ok"], (name, rep[name])
    assert rep["bounds"]["n_obligations"] > 0
    assert rep["bounds"]["smem_limit"] == memory.DEVICE_TIERS["h100_80gb"][
        "smem_block_optin_bytes"]
    assert sorted(os.listdir(tmp_path)) == [
        "BOUNDS_CERT.json", "CONCURRENCY_CERT.json", "MEMORY_CERT.json"]
    assert _tree_files() == before
    mc = json.loads((tmp_path / "MEMORY_CERT.json").read_text())
    assert mc["default_tier"] == "h100_80gb" and mc["planner"]["h100_80gb"]
