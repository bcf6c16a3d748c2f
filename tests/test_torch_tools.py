"""The port's operator tools against the reference's.

``lighthouse_tpu_torch.tools.db`` and ``tools.vm`` are the port's copy of
the reference's ``tools.py``: the database manager (inspect, version,
migrate, compact), the ``lcli`` utilities (skip-slots, transition-blocks,
pretty-ssz) and the validator manager (create, import, list), reached
through ``python -m lighthouse_tpu_torch database-manager`` (``dm``),
``lcli`` and ``validator-manager`` (``vm``). On a port client's datadir both
packages' database managers report the same columns and versions; on the
same inputs both packages' lcli write the same bytes; ``vm create`` and
``account-manager`` write keystores of the keys the reference derives, and
``vm import``/``list`` reach a port keymanager as the reference's do.
"""

import json

import pytest
import torch

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import epoch_engine as r_epoch
from lighthouse_tpu import tools as rtools
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import bls as p_bls
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import epoch_engine as p_epoch
from lighthouse_tpu_torch import slasher as p_slasher
from lighthouse_tpu_torch.cli import main as p_main
from lighthouse_tpu_torch.client import ClientBuilder as PBuilder
from lighthouse_tpu_torch.client import ClientConfig as PConfig
from lighthouse_tpu_torch.kzg import engine as p_kzg
from lighthouse_tpu_torch.tools import db as ptools
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

N = 16
SLOTS = 5
ALTAIR = dict(altair_fork_epoch=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _backends():
    saved = (r_bls.get_backend(), r_epoch.get_backend(), p_bls.get_backend(), p_bls.get_device(),
             p_epoch.get_backend(), p_epoch.get_device(), p_kzg.get_kzg_backend(),
             p_kzg.get_kzg_device(), p_slasher.get_backend(), p_slasher.get_device())
    r_bls.set_backend("native")
    r_epoch.set_backend("numpy")
    p_bls.set_backend("native")
    p_epoch.set_backend("device", device="cpu")
    yield
    r_bls.set_backend(saved[0])
    r_epoch.set_backend(saved[1])
    p_bls.set_backend(saved[2], device=saved[3])
    p_epoch.set_backend(saved[4], device=saved[5])
    p_kzg.set_kzg_backend(saved[6], device=saved[7])
    p_slasher.set_backend(saved[8], device=saved[9])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Harness blocks (altair from genesis) imported by a port client on a
    datadir, which is then stopped; the genesis state's and the blocks' SSZ."""
    rspec, pspec = r_minimal(**ALTAIR), p_minimal(**ALTAIR)
    h = StateHarness(rspec, N, genesis_time=0)
    genesis = h.state.serialize()
    blocks = []
    for slot in range(1, SLOTS + 1):
        b = h.produce_block(slot)
        h.apply_block(b)
        blocks.append(b.serialize())
    path = tmp_path_factory.mktemp("port_bn")
    client = PBuilder(pspec, PConfig(device="cpu", datadir=str(path), interop_validators=N,
                                     genesis_time=0, use_system_clock=False,
                                     http_enabled=False)).build()
    client.chain.slot_clock.set_slot(SLOTS)
    for raw in blocks:
        client.chain.process_block(convert.block_from_ssz(pspec, "altair", raw))
    head = client.chain.head.root
    client.stop()
    for kv in (client.chain.store.hot, client.chain.store.cold):
        kv.close()
    return {"path": str(path), "genesis": genesis, "blocks": blocks, "head": head,
            "post": h.state.serialize(), "rspec": rspec, "pspec": pspec}


def test_db_inspect_and_version_equal_the_reference(chain, capsys):
    path = chain["path"]
    out = ptools.db_inspect(path)
    assert out == rtools.db_inspect(path)
    assert "chain.db" in out and any("Block" in c for c in out["chain.db"])
    v = ptools.db_version(path)
    assert v == rtools.db_version(path) and v["schema_version"] == v["current"]
    assert p_main(["database-manager", "inspect", "--datadir", path]) == 0
    assert json.loads(capsys.readouterr().out) == out
    assert p_main(["dm", "version", "--datadir", path]) == 0
    assert json.loads(capsys.readouterr().out) == v
    assert ptools.db_migrate(path) == {"from": v["current"], "to": v["current"]}
    assert ptools.db_compact(path) == {"compacted": True}
    assert ptools.db_inspect(path) == out


def test_lcli_skip_slots_and_transition_equal_the_reference(chain, tmp_path, capsys):
    genesis, blocks = chain["genesis"], chain["blocks"]
    rspec, pspec = chain["rspec"], chain["pspec"]
    # across an epoch boundary (minimal: 8 slots), the port's on its device engine
    skipped = ptools.skip_slots(pspec, genesis, 10)
    assert skipped == rtools.skip_slots(rspec, genesis, 10)
    post = ptools.transition_blocks(pspec, genesis, blocks)
    assert post == rtools.transition_blocks(rspec, genesis, blocks) == chain["post"]
    # through the CLI, files in and out
    pre = tmp_path / "pre.ssz"
    pre.write_bytes(genesis)
    files = []
    for i, raw in enumerate(blocks):
        files.append(tmp_path / f"b{i}.ssz")
        files[-1].write_bytes(raw)
    spec_flags = ["--preset", "minimal", "--altair-fork-epoch", "0", "--device", "cpu",
                  "--epoch-backend", "device"]
    out = tmp_path / "skipped.ssz"
    assert p_main(["lcli", "skip-slots", "--pre-state", str(pre), "--output", str(out),
                   "--slots", "10", *spec_flags]) == 0
    assert out.read_bytes() == skipped
    out2 = tmp_path / "post.ssz"
    assert p_main(["lcli", "transition-blocks", "--pre-state", str(pre), "--output", str(out2),
                   "--blocks", *map(str, files), *spec_flags]) == 0
    assert out2.read_bytes() == post
    capsys.readouterr()
    assert p_main(["lcli", "pretty-ssz", "--type", "Checkpoint", "--ssz-file",
                   str(_checkpoint_file(tmp_path)), *spec_flags]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == rtools.pretty_ssz(rspec, "Checkpoint", _checkpoint_file(tmp_path).read_bytes())
    with pytest.raises(SystemExit):
        p_main(["lcli", "skip-slots", "--pre-state", str(pre), *spec_flags])


def _checkpoint_file(tmp_path):
    from lighthouse_tpu_torch.types.containers import Checkpoint

    p = tmp_path / "cp.ssz"
    p.write_bytes(Checkpoint.encode(Checkpoint(epoch=3, root=b"\x11" * 32)))
    return p


def test_pretty_ssz_equals_the_reference(chain):
    raw = chain["blocks"][-1]
    ns_block = convert.block_from_ssz(chain["pspec"], "altair", raw)
    pretty = ptools._to_jsonable(ns_block)
    from lighthouse_tpu.types.containers import for_preset as r_for_preset

    rblock = r_for_preset("minimal").block_types["altair"].decode(raw)
    assert pretty == rtools._to_jsonable(rblock)
    assert pretty["message"]["slot"] == SLOTS


def test_validator_manager_and_account_manager_equal_the_reference(tmp_path, capsys):
    """``vm create`` and ``am`` write keystores of the keys the reference
    derives; ``vm import`` and ``vm list`` reach a port keymanager, which
    the reference's ``vm_list`` reads alike."""
    from lighthouse_tpu.keys import derive_sk_from_path as r_derive
    from lighthouse_tpu.ops.bls_oracle import ciphersuite as r_cs
    from lighthouse_tpu.ops.bls_oracle import curves as r_oc
    from lighthouse_tpu_torch.tools import vm as pvm
    from lighthouse_tpu_torch.validator_client import KeymanagerServer, ValidatorStore

    seed = "ab" * 32

    def pubkey(i):
        return r_oc.g1_compress(r_cs.sk_to_pk(r_derive(bytes.fromhex(seed),
                                                         f"m/12381/3600/{i}/0/0"))).hex()

    keys = tmp_path / "vm"
    assert p_main(["vm", "create", "--output-dir", str(keys), "--count", "2", "--first-index",
                   "3", "--password", "pw", "--mnemonic-seed", seed]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "wrote": ["keystore-3.json", "keystore-4.json"], "dir": str(keys)}
    made = [json.loads((keys / f"keystore-{i}.json").read_text()) for i in (3, 4)]
    assert [(m["pubkey"], m["path"], m["crypto"]["kdf"]["function"]) for m in made] == [
        (pubkey(i), f"m/12381/3600/{i}/0/0", "scrypt") for i in (3, 4)]
    am_dir = tmp_path / "am"
    assert p_main(["am", "--output-dir", str(am_dir), "--password", "pw", "--mnemonic-seed",
                   seed]) == 0
    assert json.loads(capsys.readouterr().out) == {"wrote": ["keystore-0.json"], "dir": str(am_dir)}
    assert json.loads((am_dir / "keystore-0.json").read_text())["pubkey"] == pubkey(0)
    km = KeymanagerServer(ValidatorStore(p_minimal())).start()
    try:
        assert p_main(["validator-manager", "import", "--keystores-dir", str(keys), "--password",
                       "pw", "--vc-url", km.url]) == 0
        assert json.loads(capsys.readouterr().out) == [{"status": "imported"}] * 2
        listed = pvm.vm_list(km.url)
        assert listed == rtools.vm_list(km.url)
        assert sorted(d["validating_pubkey"] for d in listed) == ["0x" + pubkey(i) for i in (3, 4)]
        assert p_main(["vm", "list", "--vc-url", km.url]) == 0
        assert json.loads(capsys.readouterr().out) == listed
    finally:
        km.stop()
    for argv in (["vm", "create"], ["vm", "import", "--vc-url", "x"], ["vm", "list"]):
        with pytest.raises(SystemExit):
            p_main(argv)
