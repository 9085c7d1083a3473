"""The statesync messages and the serving side of the statesync reactor in
the port (``cometbft_tpu_torch/statesync``) held to the JAX package's: the
four messages' bytes equal and each package decoding the other's; over the
same kvstore snapshots (``snapshot_interval``), the reactors answer
``SnapshotsRequest`` and ``ChunkRequest`` with the same bytes; responses are
routed to an attached syncer as the reference routes them."""

import hashlib
import random
import types

import pytest

from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
from cometbft_tpu.config import test_config as ref_test_config
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.mempool import CListMempool as RefMempool
from cometbft_tpu.proxy import AppConns as RefAppConns
from cometbft_tpu.proxy import local_client_creator as ref_creator
from cometbft_tpu.state import BlockExecutor as RefExecutor
from cometbft_tpu.state import StateStore as RefStateStore
from cometbft_tpu.state import make_genesis_state as ref_genesis_state
from cometbft_tpu.statesync import StatesyncReactor as RefReactor
from cometbft_tpu.statesync import messages as ref_m
from cometbft_tpu.store import BlockStore as RefBlockStore
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import Commit as RefCommit
from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
from cometbft_tpu.types import GenesisValidator as RefGenesisValidator
from cometbft_tpu.types import Time as RefTime
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.priv_validator import MockPV as RefMockPV
from cometbft_tpu.types.vote import vote_to_commit_sig as ref_commit_sig
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import test_config as make_test_config
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
from cometbft_tpu_torch.statesync import StatesyncReactor
from cometbft_tpu_torch.statesync import messages as m
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import BlockID, Commit, Vote
from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.vote import vote_to_commit_sig

pytestmark = pytest.mark.torch_port

CHAIN_ID = "torch-ssync-chain"
N_BLOCKS = 10
SNAPSHOT_INTERVAL = 3
CHUNK = 48


def _messages(seed: int):
    rng = random.Random(seed)
    return [
        ("SnapshotsRequest", {}),
        ("SnapshotsResponse", dict(height=rng.randrange(0, 1 << 40), format=rng.randrange(0, 9),
                                   chunks=rng.randrange(0, 500), hash=rng.randbytes(32),
                                   metadata=rng.randbytes(rng.randrange(0, 40)))),
        ("SnapshotsResponse", {}),
        ("ChunkRequest", dict(height=rng.randrange(1, 1 << 40), format=rng.randrange(0, 3),
                              index=rng.randrange(0, 1000))),
        ("ChunkResponse", dict(height=rng.randrange(1, 1 << 40), format=1,
                               index=rng.randrange(0, 1000),
                               chunk=rng.randbytes(rng.randrange(0, 300)), missing=False)),
        ("ChunkResponse", dict(height=7, format=1, index=3, chunk=b"", missing=True)),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_message_bytes_equal_the_reference(seed):
    for name, fields in _messages(seed):
        got = m.encode(getattr(m, name)(**fields))
        want = ref_m.encode(getattr(ref_m, name)(**fields))
        assert got == want
        back, ref_back = m.decode(want), ref_m.decode(got)
        assert type(back).__name__ == type(ref_back).__name__ == name
        assert vars(back) == vars(ref_back)
    assert (m.SNAPSHOT_CHANNEL, m.CHUNK_CHANNEL) == (ref_m.SNAPSHOT_CHANNEL, ref_m.CHUNK_CHANNEL)


def test_unknown_message_raises_the_same():
    for data in (b"", b"\x2a\x00"):
        with pytest.raises(ValueError) as got:
            m.decode(data)
        with pytest.raises(ValueError) as want:
            ref_m.decode(data)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        m.encode(object())


def _secret(i: int) -> bytes:
    return hashlib.sha256(b"torch-ssync-%d" % i).digest()


def _ref_chain():
    """The reference's chain: 3 validators, one kvstore tx a block, the app
    snapshotting every SNAPSHOT_INTERVAL heights in CHUNK-byte chunks."""
    pvs = [RefMockPV(ref_ed.gen_priv_key_from_secret(_secret(i))) for i in range(3)]
    gen = RefGenesisDoc(chain_id=CHAIN_ID, genesis_time=RefTime(1_700_000_000, 0), validators=[
        RefGenesisValidator(pv.address(), pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(pvs)])
    gen.validate_and_complete()
    return gen, _build(types.SimpleNamespace(
        KV=RefKV, AppConns=RefAppConns, creator=ref_creator, Mempool=RefMempool,
        cfg=ref_test_config, StateStore=RefStateStore, BlockStore=RefBlockStore, MemDB=RefMemDB,
        Executor=RefExecutor, genesis_state=ref_genesis_state, BlockID=RefBlockID,
        Commit=RefCommit, Vote=RefVote, commit_sig=ref_commit_sig), gen, pvs)


def _port_chain(gen_json: str):
    pvs = [MockPV(ed25519.gen_priv_key_from_secret(_secret(i))) for i in range(3)]
    gen = GenesisDoc.from_json(gen_json)
    return _build(types.SimpleNamespace(
        KV=KVStoreApplication, AppConns=AppConns, creator=local_client_creator,
        Mempool=CListMempool, cfg=make_test_config, StateStore=StateStore, BlockStore=BlockStore,
        MemDB=MemDB, Executor=BlockExecutor, genesis_state=make_genesis_state, BlockID=BlockID,
        Commit=Commit, Vote=Vote, commit_sig=vote_to_commit_sig), gen, pvs)


def _build(p, gen, pvs):
    state = p.genesis_state(gen)
    app = p.KV(snapshot_interval=SNAPSHOT_INTERVAL, snapshot_chunk_size=CHUNK)
    conns = p.AppConns(p.creator(app))
    conns.start()
    mempool = p.Mempool(p.cfg().mempool, conns.mempool)
    ss, bs = p.StateStore(p.MemDB()), p.BlockStore(p.MemDB())
    ss.save(state)
    ex = p.Executor(ss, conns.consensus, mempool, None, bs)
    by_addr = {pv.address(): pv for pv in pvs}
    last = p.Commit(height=0, round=0)
    for h in range(1, N_BLOCKS + 1):
        for j in range(h):
            mempool.check_tx(b"key%d-%d=val%d" % (h, j, h * j))
        block = ex.create_proposal_block(h, state, last, state.validators.get_proposer().address)
        parts = block.make_part_set()
        bid = p.BlockID(block.hash(), parts.header())
        sigs = [p.commit_sig(by_addr[v.address].sign_vote(CHAIN_ID, p.Vote(
            type=PRECOMMIT_TYPE, height=h, round=0, block_id=bid,
            timestamp=block.header.time.add_nanos(10**9 * (i + 1)),
            validator_address=v.address, validator_index=i)))
            for i, v in enumerate(state.validators.validators)]
        last = p.Commit(height=h, round=0, block_id=bid, signatures=sigs)
        bs.save_block(block, parts, last)
        state, _ = ex.apply_block(state, bid, block)
    return state, conns


class Peer:
    """A peer double that keeps what the reactor sends it."""

    def __init__(self, peer_id: str = "ab" * 20):
        self.id = peer_id
        self.sent: list = []

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        self.sent.append((chan_id, msg))
        return True


@pytest.fixture(scope="module")
def chains():
    from cometbft_tpu.sidecar import backend as ref_be
    from cometbft_tpu_torch.sidecar import backend as be

    old, ref_old = be._backend, ref_be._backend
    be.set_backend(be.CpuBackend())
    ref_be.set_backend(ref_be.CpuBackend())
    try:
        gen, (ref_state, ref_conns) = _ref_chain()
        state, conns = _port_chain(gen.to_json())
    finally:
        be._backend, ref_be._backend = old, ref_old
    assert state.app_hash == ref_state.app_hash
    return conns, ref_conns


def _serve(reactor, chan, msg_bytes):
    peer = Peer()
    reactor.receive(chan, peer, msg_bytes)
    return peer.sent


def test_snapshots_request_answered_as_the_reference(chains):
    conns, ref_conns = chains
    port, ref = StatesyncReactor(snapshot_conn=conns.snapshot), RefReactor(
        snapshot_conn=ref_conns.snapshot)
    req = m.encode(m.SnapshotsRequest())
    got, want = _serve(port, m.SNAPSHOT_CHANNEL, req), _serve(ref, m.SNAPSHOT_CHANNEL, req)
    assert got == want
    heights = [m.decode(b).height for _, b in got]
    assert heights == [9, 6, 3]  # newest first
    assert _serve(StatesyncReactor(), m.SNAPSHOT_CHANNEL, req) == []
    assert port.get_channels()[0].__dict__ == ref.get_channels()[0].__dict__
    assert port.get_channels()[1].__dict__ == ref.get_channels()[1].__dict__


def test_chunk_requests_answered_as_the_reference(chains):
    conns, ref_conns = chains
    port, ref = StatesyncReactor(snapshot_conn=conns.snapshot), RefReactor(
        snapshot_conn=ref_conns.snapshot)
    snaps = [m.decode(b) for _, b in _serve(port, m.SNAPSHOT_CHANNEL,
                                              m.encode(m.SnapshotsRequest()))]
    asked = 0
    for snap in snaps:
        assert snap.chunks > 1
        for index in range(snap.chunks + 1):  # the last one is past the end: missing
            req = m.encode(m.ChunkRequest(height=snap.height, format=snap.format, index=index))
            got, want = _serve(port, m.CHUNK_CHANNEL, req), _serve(ref, m.CHUNK_CHANNEL, req)
            assert got == want and got[0][0] == m.CHUNK_CHANNEL
            resp = m.decode(got[0][1])
            assert resp.missing == (index == snap.chunks)
            asked += 1
    req = m.encode(m.ChunkRequest(height=4, format=1, index=0))  # no snapshot at 4
    assert _serve(port, m.CHUNK_CHANNEL, req) == _serve(ref, m.CHUNK_CHANNEL, req)
    assert m.decode(_serve(StatesyncReactor(), m.CHUNK_CHANNEL, req)[0][1]).missing
    assert asked > 6


class Syncer:
    def __init__(self):
        self.snapshots, self.chunks = [], []

    def add_snapshot(self, peer_id, snap):
        self.snapshots.append((peer_id, vars(snap)))

    def add_chunk(self, height, fmt, index, chunk):
        self.chunks.append((height, fmt, index, chunk))


class Switch:
    def __init__(self, peers):
        self.peers = {p.id: p for p in peers}
        self.broadcasts = []

    def get_peer(self, peer_id):
        return self.peers.get(peer_id)

    def broadcast(self, chan_id, msg):
        self.broadcasts.append((chan_id, msg))


def test_responses_route_to_the_syncer_as_the_reference():
    out = {}
    for name, reactor_cls, mm in (("port", StatesyncReactor, m), ("ref", RefReactor, ref_m)):
        syncer, peer = Syncer(), Peer("cd" * 20)
        reactor = reactor_cls()
        reactor.add_peer(peer)  # no syncer: nothing asked
        reactor.set_syncer(syncer)
        reactor.add_peer(peer)  # a syncing node asks every new peer
        reactor.set_switch(Switch([peer]))
        reactor.request_snapshots()
        reactor.request_chunk(peer.id, 9, 1, 2)
        reactor.request_chunk("no-such-peer", 9, 1, 3)
        for name_, fields in _messages(5):
            if name_ in ("SnapshotsResponse", "ChunkResponse"):
                reactor.receive(mm.SNAPSHOT_CHANNEL, peer,
                                mm.encode(getattr(mm, name_)(**fields)))
        out[name] = (peer.sent, reactor.switch.broadcasts, syncer.snapshots, syncer.chunks)
    assert out["port"] == out["ref"]
    assert len(out["port"][2]) == 2 and len(out["port"][3]) == 1  # a missing chunk is dropped
