"""The port's execution-layer HTTP stack and eth1 bridge against the
reference's.

``lighthouse_tpu_torch.execution_layer.{auth,http,mock,json_server}`` and
``lighthouse_tpu_torch.eth1`` are the port's copies of the reference's
modules. JWT tokens must be byte-equal for one secret and ``iat``; each
package's engine client must drive the other's served mock EL to the same
payloads and statuses, and each eth1 provider the other's served eth1
chain; the deposit cache's roots and proofs, the deposit genesis state,
eth1 voting and deposit inclusion must equal the reference's.
"""

import time

import pytest

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu import eth1 as r_eth1
from lighthouse_tpu import execution_layer as r_el
from lighthouse_tpu.eth1 import http_provider as r_hp
from lighthouse_tpu.state_transition.genesis import interop_secret_keys
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu.types.helpers import compute_domain, compute_signing_root
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch import eth1 as p_eth1
from lighthouse_tpu_torch import execution_layer as p_el
from lighthouse_tpu_torch.eth1 import http_provider as p_hp
from lighthouse_tpu_torch.execution_layer.mock import GENESIS_BLOCK_HASH
from lighthouse_tpu_torch.state_transition.per_block import is_valid_merkle_branch
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

GENESIS = dict(min_genesis_active_validator_count=8, min_genesis_time=0)


@pytest.fixture(scope="module", autouse=True)
def _native():
    prev = r_bls.get_backend()
    r_bls.set_backend("native")
    yield
    r_bls.set_backend(prev)


@pytest.fixture(scope="module")
def deposits():
    """Ten deposits by the interop keys (the reference's native signer), as
    the reference's DepositData and the port's."""
    spec = r_minimal(**GENESIS)
    out = []
    for i, x in enumerate(interop_secret_keys(10)):
        sk = r_bls.SecretKey.from_bytes(x.to_bytes(32, "big"))
        amount = 16 * 10**9 if i == 9 else 32 * 10**9
        msg = r_con.DepositMessage(pubkey=sk.public_key().serialize(),
                                   withdrawal_credentials=b"\x00" * 32, amount=amount)
        domain = compute_domain(spec.DOMAIN_DEPOSIT, spec.genesis_fork_version, b"\x00" * 32)
        out.append(r_con.DepositData(
            pubkey=msg.pubkey, withdrawal_credentials=msg.withdrawal_credentials,
            amount=amount, signature=sk.sign(compute_signing_root(msg, domain)).serialize()))
    return out, [p_con.DepositData.decode(d.serialize()) for d in out]


# -- JWT ----------------------------------------------------------------------


@pytest.mark.parametrize("secret", [b"\x42" * 32, bytes(range(32))])
def test_jwt_tokens_equal_the_reference(secret):
    rk, pk = r_el.JwtKey(secret), p_el.JwtKey(secret)
    now = int(time.time())
    for iat in (0, 1_700_000_000, now):
        assert pk.generate_token(iat=iat) == rk.generate_token(iat=iat)
    tok = pk.generate_token()
    assert rk.validate_token(tok) and pk.validate_token(rk.generate_token())
    for bad in (pk.generate_token(iat=now - 300), "not.a.jwt", ""):
        assert pk.validate_token(bad) == rk.validate_token(bad) is False
    assert not p_el.JwtKey(b"\x43" * 32).validate_token(tok)
    assert p_el.JwtKey.from_hex("0x" + secret.hex()).secret == secret
    with pytest.raises(ValueError):
        p_el.JwtKey(b"\x00" * 16)


# -- the engine API over HTTP, across packages --------------------------------


def _serve(pkg, con):
    key = pkg.JwtKey(b"\x07" * 32)
    return pkg.ExecutionJsonRpcServer(engine=pkg.MockExecutionLayer(),
                                      ns=con.for_preset("minimal"), jwt_key=key).start(), key


def _engine_round(pkg, con, url, key):
    """Capabilities, a payload build with a withdrawal, the payload fetched,
    notified VALID, then tampered (INVALID_BLOCK_HASH). Returns the wire
    results as plain values."""
    eng = pkg.HttpExecutionEngine(url, jwt_key=key)
    caps = sorted(eng.exchange_capabilities())
    wd = [con.Withdrawal(index=0, validator_index=3, address=b"\xaa" * 20, amount=7)]
    status, pid = eng.forkchoice_updated(
        GENESIS_BLOCK_HASH, b"\x00" * 32,
        pkg.PayloadAttributes(timestamp=12, prev_randao=b"\x01" * 32, withdrawals=wd))
    ns = con.for_preset("minimal")
    payload = eng.get_payload(pid, ns.ExecutionPayloadCapella)
    ok = eng.notify_new_payload(payload)
    raw = ns.ExecutionPayloadCapella.encode(payload)
    payload.gas_limit = 999
    bad = eng.notify_new_payload(payload)
    return (caps, status.status.value, pid, raw, ok.status.value, ok.latest_valid_hash,
            bad.status.value)


def test_engine_clients_drive_each_others_servers():
    """The reference's client on its own server gives the wire results; each
    other pairing, on a fresh mock, must give the same."""
    pairs = [(r_el, r_el), (p_el, r_el), (r_el, p_el), (p_el, p_el)]
    got = []
    for client, server in pairs:
        srv, key = _serve(server, r_con if server is r_el else p_con)
        try:
            got.append(_engine_round(client, r_con if client is r_el else p_con, srv.url, key))
        finally:
            srv.stop()
    want = got[0]
    assert want[1] == "VALID" and want[4] == "VALID" and want[6] == "INVALID_BLOCK_HASH"
    assert got[1:] == [want] * 3


def test_engine_server_refuses_a_bad_jwt():
    srv, _ = _serve(p_el, p_con)
    try:
        for key in (r_el.JwtKey(b"\x08" * 32), None):
            with pytest.raises(r_el.EngineApiError):
                r_el.HttpExecutionEngine(srv.url, jwt_key=key).exchange_capabilities()
        assert srv.auth_failures == 2
    finally:
        srv.stop()


def test_eth1_providers_read_each_others_servers(deposits):
    r_dd, p_dd = deposits
    rm, pm = r_eth1.MockEth1Provider(genesis_timestamp=1000), p_eth1.MockEth1Provider(1000)
    for m, dd in ((rm, r_dd), (pm, p_dd)):
        m.mine_block()
        for d in dd[:3]:
            m.submit_deposit(d)
    rs = r_el.ExecutionJsonRpcServer(eth1=rm).start()
    ps = p_el.ExecutionJsonRpcServer(eth1=pm).start()
    try:
        views = []
        for provider_cls, url in ((r_hp.HttpEth1Provider, rs.url), (p_hp.HttpEth1Provider, rs.url),
                                  (r_hp.HttpEth1Provider, ps.url), (p_hp.HttpEth1Provider, ps.url)):
            http = provider_cls(url)
            head = http.latest_block_number()
            blocks = [(b.number, b.hash, b.parent_hash, b.timestamp)
                      for b in map(http.get_block, range(head + 1))]
            logs = [(type(lg.data).encode(lg.data), lg.block_number, lg.index)
                    for lg in http.get_deposit_logs(0, head)]
            views.append((head, blocks, logs))
        assert views[0][0] == 4 and len(views[0][2]) == 3
        assert views[1:] == [views[0]] * 3
    finally:
        rs.stop()
        ps.stop()
    lg = r_eth1.DepositLog(data=r_dd[0], block_number=42, index=7)
    enc = r_hp.encode_deposit_log(lg, b"\x11" * 20)
    assert p_hp.encode_deposit_log(p_eth1.DepositLog(data=p_dd[0], block_number=42, index=7),
                                   b"\x11" * 20) == enc
    back = p_hp.decode_deposit_log(enc)
    assert (p_con.DepositData.encode(back.data), back.block_number, back.index) == (
        p_dd[0].serialize(), 42, 7)


# -- the deposit cache, genesis, voting and inclusion -------------------------


def test_deposit_cache_roots_and_proofs_equal_the_reference(deposits):
    r_dd, p_dd = deposits
    rc, pc = r_eth1.DepositCache(), p_eth1.DepositCache()
    for i, (r, p) in enumerate(zip(r_dd, p_dd)):
        rc.insert_log(r_eth1.DepositLog(data=r, block_number=i, index=i))
        pc.insert_log(p_eth1.DepositLog(data=p, block_number=i, index=i))
    for count in (1, 2, 5, 10):
        root = pc.deposit_root(count)
        assert root == rc.deposit_root(count)
        pd, rd = pc.get_deposits(0, count, count), rc.get_deposits(0, count, count)
        assert [p_con.Deposit.encode(d) for d in pd] == [r_con.Deposit.encode(d) for d in rd]
        for i, dep in enumerate(pd):
            assert is_valid_merkle_branch(p_con.DepositData.hash_tree_root(dep.data),
                                          dep.proof, 33, i, root)
    with pytest.raises(ValueError):
        pc.insert_log(p_eth1.DepositLog(data=p_dd[0], block_number=0, index=99))
    with pytest.raises(ValueError):
        pc.get_deposits(0, 11, 11)


def test_eth1_genesis_state_equals_the_reference(deposits):
    r_dd, p_dd = deposits
    rspec, pspec = r_minimal(**GENESIS), p_minimal(**GENESIS)
    for n in (8, 10):
        rs = r_eth1.eth1_genesis_state(rspec, b"\x11" * 32, 1000, r_dd[:n])
        ps = p_eth1.eth1_genesis_state(pspec, b"\x11" * 32, 1000, p_dd[:n])
        assert ps.tree_root() == rs.tree_root()
        assert p_eth1.is_valid_genesis_state(pspec, ps) is r_eth1.is_valid_genesis_state(rspec, rs)
    assert sum(int(v.activation_epoch) == 0 for v in ps.validators) == 9


def test_eth1_voting_and_deposit_inclusion_equal_the_reference(deposits):
    r_dd, p_dd = deposits
    rspec, pspec = r_minimal(**GENESIS), p_minimal(**GENESIS)
    side = {}
    for who, pkg, spec, dd in (("r", r_eth1, rspec, r_dd), ("p", p_eth1, pspec, p_dd)):
        provider = pkg.MockEth1Provider(genesis_timestamp=0)
        for d in dd[:8]:
            provider.submit_deposit(d)
        svc = pkg.Eth1Service(spec, provider, follow_distance=2)
        first = svc.update()
        state = pkg.eth1_genesis_state(spec, provider.get_block(8).hash,
                                       provider.get_block(8).timestamp, dd[:8])
        for d in dd[8:]:
            provider.submit_deposit(d)
        for _ in range(5):  # past the follow distance, short of the pruning horizon
            provider.mine_block()
        second = svc.update()
        state.slot = spec.preset.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.preset.SLOTS_PER_EPOCH
        state.genesis_time = 0
        vote = svc.eth1_data_vote(state)
        state.eth1_data = vote
        deps = svc.deposits_for_inclusion(state)
        side[who] = (first, second, type(vote).encode(vote),
                     [type(d).encode(d) for d in deps], svc.update())
    assert side["p"] == side["r"]
    assert side["p"][:2] == (8, 2) and len(side["p"][3]) == 2
