"""The port's wire codec against the reference's, byte for byte.

``lighthouse_tpu_torch.network.codec.MessageCodec`` is the port's copy of
the reference's. For every gossip topic and every Req/Resp method (request
and response) on harness-built objects (the reference's ``StateHarness``
under a deneb minimal spec; each object carried to the port's types as SSZ
bytes), the two codecs give equal bytes, each package decodes the other's
bytes to objects of equal ``hash_tree_root``, and the same malformed inputs
raise ``WireError`` in both. The light-client methods, which the port does
not serve yet, raise ``WireError`` in the port's codec and router. Exact
equality everywhere.
"""

import zlib

import numpy as np
import pytest

import lighthouse_tpu  # noqa: F401
from lighthouse_tpu import bls as r_bls
from lighthouse_tpu.network.codec import MessageCodec as RCodec
from lighthouse_tpu.network.codec import WireError as RWireError
from lighthouse_tpu.network.transport import Status as RStatus
from lighthouse_tpu.network.transport import Topic as RTopic
from lighthouse_tpu.testing import StateHarness
from lighthouse_tpu.types import containers as r_con
from lighthouse_tpu.types.spec import minimal_spec as r_minimal
from lighthouse_tpu_torch.network import router as p_router
from lighthouse_tpu_torch.network.codec import LIGHT_CLIENT_METHODS
from lighthouse_tpu_torch.network.codec import MessageCodec as PCodec
from lighthouse_tpu_torch.network.codec import WireError as PWireError
from lighthouse_tpu_torch.network.transport import Status as PStatus
from lighthouse_tpu_torch.network.transport import Topic as PTopic
from lighthouse_tpu_torch.types import containers as p_con
from lighthouse_tpu_torch.types.containers import for_preset as p_for_preset
from lighthouse_tpu_torch.types.spec import minimal_spec as p_minimal

DENEB = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
             deneb_fork_epoch=0)
TOPICS = sorted(v for k, v in vars(RTopic).items() if not k.startswith("_"))


@pytest.fixture(scope="module", autouse=True)
def _native():
    saved = r_bls.get_backend()
    r_bls.set_backend("native")
    yield
    r_bls.set_backend(saved)


def _port(obj):
    """A reference container as the port's type of the same name."""
    ns = p_for_preset("minimal")
    cls = getattr(ns, type(obj).__name__, None) or getattr(p_con, type(obj).__name__)
    return cls.decode(type(obj).encode(obj))


def _port_block(block, fork):
    return p_for_preset("minimal").block_types[fork].decode(block.serialize())


class Objects:
    """One object per gossip topic, blocks of two forks, a column sidecar,
    and a Status, in both packages' types."""

    def __init__(self):
        self.rspec, self.pspec = r_minimal(**DENEB), p_minimal(**DENEB)
        rns = r_con.for_preset("minimal")
        h = StateHarness(self.rspec, 16)
        state0 = h.state.copy()
        b1 = h.produce_block(1)
        h.apply_block(b1)
        root1 = b1.message.tree_root()
        atts = h.unaggregated_attestations_for_slot(h.state, 1, root1)
        saps = h.signed_aggregate_and_proofs(h.state, 1, root1)
        rng = np.random.default_rng(3)
        blk = b1.message
        header = r_con.SignedBeaconBlockHeader(
            message=r_con.BeaconBlockHeader(slot=blk.slot, proposer_index=blk.proposer_index,
                                            parent_root=blk.parent_root, state_root=blk.state_root,
                                            body_root=blk.body.tree_root()),
            signature=b1.signature)
        idx = rns.IndexedAttestation(attesting_indices=[1, 2], data=atts[0].data,
                                     signature=atts[0].signature)
        self.gossip = {
            RTopic.BEACON_BLOCK: b1,
            RTopic.BEACON_ATTESTATION: atts[0],
            RTopic.AGGREGATE_AND_PROOF: saps[0],
            RTopic.VOLUNTARY_EXIT: r_con.SignedVoluntaryExit(
                message=r_con.VoluntaryExit(epoch=0, validator_index=3), signature=b1.signature),
            RTopic.PROPOSER_SLASHING: r_con.ProposerSlashing(
                signed_header_1=header, signed_header_2=header.copy()),
            RTopic.ATTESTER_SLASHING: rns.AttesterSlashing(attestation_1=idx,
                                                           attestation_2=idx.copy()),
            RTopic.SYNC_COMMITTEE_MESSAGE: rns.SyncCommitteeMessage(
                slot=1, beacon_block_root=root1, validator_index=5, signature=b1.signature),
            RTopic.SYNC_CONTRIBUTION: rns.SignedContributionAndProof(
                message=rns.ContributionAndProof(
                    aggregator_index=7,
                    contribution=rns.SyncCommitteeContribution(
                        slot=1, beacon_block_root=root1, subcommittee_index=1,
                        aggregation_bits=rng.integers(
                            0, 2, self.rspec.preset.SYNC_COMMITTEE_SIZE // 4).astype(bool),
                        signature=b1.signature),
                    selection_proof=b1.signature),
                signature=b1.signature),
            RTopic.DATA_COLUMN_SIDECAR: rns.DataColumnSidecar(
                index=3, column=[rng.bytes(rns.BYTES_PER_CELL)],
                kzg_commitments=[b"\xc0" + bytes(47)], kzg_proofs=[b"\xc0" + bytes(47)],
                signed_block_header=header,
                kzg_commitments_inclusion_proof=[rng.bytes(32) for _ in range(
                    len(rns.DataColumnSidecar().kzg_commitments_inclusion_proof))]),
        }
        self.pgossip = {
            t: (_port_block(o, "deneb") if t == RTopic.BEACON_BLOCK else _port(o))
            for t, o in self.gossip.items()
        }
        # a phase0 block beside the deneb one: the fork tag picks the container
        h0 = StateHarness(r_minimal(altair_fork_epoch=2**64 - 1), 16)
        b0 = h0.produce_block(1)
        self.blocks = [b0, b1]
        self.pblocks = [_port_block(b0, "phase0"), self.pgossip[RTopic.BEACON_BLOCK]]
        self.columns = [self.gossip[RTopic.DATA_COLUMN_SIDECAR]]
        self.pcolumns = [self.pgossip[RTopic.DATA_COLUMN_SIDECAR]]
        fields = dict(fork_digest=b"\x01\x02\x03\x04", finalized_root=bytes(state0.genesis_validators_root),
                      finalized_epoch=7, head_root=root1, head_slot=99)
        self.status = (RStatus(**fields), PStatus(**fields))


@pytest.fixture(scope="module")
def objs():
    return Objects()


@pytest.fixture(scope="module")
def codecs(objs):
    return RCodec(objs.rspec), PCodec(objs.pspec)


def _root(obj):
    return obj.tree_root()


def test_topics_equal():
    assert TOPICS == sorted(v for k, v in vars(PTopic).items() if not k.startswith("_"))
    assert len(TOPICS) == 9


@pytest.mark.parametrize("topic", TOPICS)
def test_gossip_bytes_equal_and_cross_decode(objs, codecs, topic):
    rc, pc = codecs
    robj, pobj = objs.gossip[topic], objs.pgossip[topic]
    rb, pb = rc.encode_gossip(topic, robj), pc.encode_gossip(topic, pobj)
    assert pb == rb
    assert _root(pc.decode_gossip(topic, rb)) == _root(robj)
    assert _root(rc.decode_gossip(topic, pb)) == _root(pobj) == _root(robj)


def _requests(objs):
    rst, pst = objs.status
    roots = [bytes([i]) * 32 for i in range(3)]
    ids = [(b"\x01" * 32, 3), (b"\x02" * 32, 15)]
    return {
        "status": (rst, pst),
        "blocks_by_range": ((5, 32), (5, 32)),
        "blocks_by_root": (roots, roots),
        "data_column_sidecars_by_root": (ids, ids),
        "data_column_sidecars_by_range": ((2, 4, [0, 5, 11]), (2, 4, [0, 5, 11])),
        "data_column_sidecars_by_range#all": ((2, 4, None), (2, 4, None)),
    }


REQUESTS = ["status", "blocks_by_range", "blocks_by_root", "data_column_sidecars_by_root",
            "data_column_sidecars_by_range", "data_column_sidecars_by_range#all"]


def _plain(x):
    if isinstance(x, (RStatus, PStatus)):
        return tuple(bytes(v) if isinstance(v, (bytes, bytearray)) else int(v)
                     for v in (x.fork_digest, x.finalized_root, x.finalized_epoch, x.head_root,
                               x.head_slot))
    return x


@pytest.mark.parametrize("case", REQUESTS)
def test_request_bytes_equal_and_cross_decode(objs, codecs, case):
    rc, pc = codecs
    method = case.split("#")[0]
    rp, pp = _requests(objs)[case]
    rb, pb = rc.encode_request(method, rp), pc.encode_request(method, pp)
    assert pb == rb
    assert _plain(pc.decode_request(method, rb)) == _plain(rc.decode_request(method, pb)) == _plain(rp)


RESPONSES = ["status", "blocks_by_range", "blocks_by_root", "data_column_sidecars_by_root",
             "data_column_sidecars_by_range"]


@pytest.mark.parametrize("method", RESPONSES)
def test_response_bytes_equal_and_cross_decode(objs, codecs, method):
    rc, pc = codecs
    if method == "status":
        rp, pp = objs.status
    elif method.startswith("blocks"):
        rp, pp = objs.blocks, objs.pblocks
    else:
        rp, pp = objs.columns, objs.pcolumns
    rb, pb = rc.encode_response(method, rp), pc.encode_response(method, pp)
    assert pb == rb
    rd, pd = rc.decode_response(method, pb), pc.decode_response(method, rb)
    if method == "status":
        assert _plain(rd) == _plain(pd) == _plain(rp)
    else:
        assert [_root(x) for x in pd] == [_root(x) for x in rd] == [_root(x) for x in rp]
        assert [type(x).__name__ for x in pd] == [type(x).__name__ for x in rp]


def _malformed():
    z = zlib.compress
    return [
        ("decode_gossip", (RTopic.BEACON_ATTESTATION, b"not zlib")),
        ("decode_gossip", ("no_such_topic", z(b""))),
        ("encode_gossip", ("no_such_topic", None)),
        ("decode_request", ("status", b"\x00\x01")),
        ("decode_request", ("no_such_method", z(b""))),
        ("encode_request", ("no_such_method", None)),
        ("encode_response", ("no_such_method", [])),
        ("decode_response", ("no_such_method", z(b""))),
    ]


@pytest.mark.parametrize("i", range(len(_malformed())))
def test_malformed_inputs_raise_wire_error_in_both(codecs, i):
    rc, pc = codecs
    name, args = _malformed()[i]
    with pytest.raises(RWireError):
        getattr(rc, name)(*args)
    with pytest.raises(PWireError):
        getattr(pc, name)(*args)


@pytest.mark.parametrize("method", LIGHT_CLIENT_METHODS)
def test_light_client_methods_raise_until_ported(codecs, method):
    """Divergence from the reference (ROADMAP Queue 3): the port has no
    light-client server yet, so its codec refuses the four light-client
    methods in every direction and its router refuses to serve them; the
    reference encodes them."""
    rc, pc = codecs
    payload = {"light_client_bootstrap": b"\x01" * 32,
               "light_client_updates_by_range": (1, 2)}.get(method)
    raw = rc.encode_request(method, payload)
    for call, args in (("encode_request", (method, payload)), ("decode_request", (method, raw)),
                       ("encode_response", (method, None)),
                       ("decode_response", (method, zlib.compress(b"")))):
        with pytest.raises(PWireError, match="ROADMAP Queue 1 item 2.4"):
            getattr(pc, call)(*args)
    router = p_router.Router(type("Svc", (), {})())
    with pytest.raises(PWireError, match="not ported yet"):
        router.on_rpc(method, payload, "peer")
