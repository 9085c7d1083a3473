"""The port's consensus and mempool reactors (``consensus/reactor.py``,
``mempool/reactor.py``) on its Switch, against the JAX package's.

- The catch-up cascade (``tests/test_reactor_catchup.py``'s scenarios and
  doubles): the same state machine state in both packages (validators from
  fixed secrets, one fixed clock), the same ``_gossip_once`` passes; the
  peer double must receive the same messages, byte for byte, in the same
  order, with the same marks and catch-up counts.
- Two port and two reference validators over 127.0.0.1 TCP, each package
  on its ``CpuBackend``, each node a ``ConsensusState`` with a
  ``ConsensusReactor`` and a ``MempoolReactor`` on its own ``Switch`` in a
  full mesh: every node commits the same block at every height to 3, and a
  transaction entered at a port node is committed on every node.
- A fresh port node syncs a reference-built chain through its
  ``BlocksyncReactor`` on a port ``Switch``, from a reference node serving
  it through the reference's reactor and Switch over TCP; the port's
  evidence reactor registers its channel on the Switch.
- The counted exceptions: a failing gossip pass (``gossip_errors``), a
  refused ``VoteSetMaj23`` (``maj23_conflicts``: logged, not punished), a
  duplicate gossiped transaction (``check_tx_errors``).

Every wait has its own timeout; nothing asserts a wall-clock time."""

from __future__ import annotations

import hashlib
import threading
import time
import types

import pytest
import torch
import torch_chains as tc

from cometbft_tpu.blocksync.reactor import BlocksyncReactor as RefBlocksyncReactor
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.mempool.reactor import decode_txs_message as ref_decode_txs
from cometbft_tpu.mempool.reactor import encode_txs_message as ref_encode_txs
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
from cometbft_tpu_torch.mempool.reactor import decode_txs_message, encode_txs_message
from cometbft_tpu_torch.p2p.reactor import BLOCKSYNC_CHANNEL
from cometbft_tpu_torch.sidecar import backend

pytestmark = pytest.mark.torch_port

CHAIN_ID = "reactor-chain"
WAIT_S = 60.0


def pkg(side: str):
    """The classes and functions one package gives the tests, by name."""
    if side == "ref":
        from cometbft_tpu import config as cfg_mod
        from cometbft_tpu.abci.example.kvstore import KVStoreApplication
        from cometbft_tpu.consensus import cstypes
        from cometbft_tpu.consensus import messages as cmsg
        from cometbft_tpu.consensus.reactor import ConsensusReactor, PeerState
        from cometbft_tpu.consensus.state import ConsensusState
        from cometbft_tpu.crypto import ed25519 as ed
        from cometbft_tpu.libs.db import MemDB
        from cometbft_tpu.mempool import CListMempool
        from cometbft_tpu.mempool.reactor import MempoolReactor
        from cometbft_tpu.p2p.key import NodeKey
        from cometbft_tpu.p2p.node_info import NodeInfo
        from cometbft_tpu.p2p.switch import Switch
        from cometbft_tpu.p2p.transport import MultiplexTransport
        from cometbft_tpu.proxy import AppConns, local_client_creator
        from cometbft_tpu.state import BlockExecutor, StateStore, make_genesis_state
        from cometbft_tpu.store import BlockStore
        from cometbft_tpu.types import GenesisDoc, GenesisValidator, Time, cmttime
        from cometbft_tpu.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE, BlockID, Commit
        from cometbft_tpu.types.part_set import PartSetHeader
        from cometbft_tpu.types.priv_validator import MockPV
        from cometbft_tpu.types.proposal import Proposal
        from cometbft_tpu.types.vote import Vote
        from cometbft_tpu.types.vote_set import VoteSet
    else:
        from cometbft_tpu_torch import config as cfg_mod
        from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
        from cometbft_tpu_torch.consensus import cstypes
        from cometbft_tpu_torch.consensus import messages as cmsg
        from cometbft_tpu_torch.consensus.reactor import ConsensusReactor, PeerState
        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.crypto import ed25519 as ed
        from cometbft_tpu_torch.libs.db import MemDB
        from cometbft_tpu_torch.mempool import CListMempool
        from cometbft_tpu_torch.mempool.reactor import MempoolReactor
        from cometbft_tpu_torch.p2p.key import NodeKey
        from cometbft_tpu_torch.p2p.node_info import NodeInfo
        from cometbft_tpu_torch.p2p.switch import Switch
        from cometbft_tpu_torch.p2p.transport import MultiplexTransport
        from cometbft_tpu_torch.proxy import AppConns, local_client_creator
        from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types import Time, cmttime
        from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE, BlockID, Commit
        from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
        from cometbft_tpu_torch.types.part_set import PartSetHeader
        from cometbft_tpu_torch.types.priv_validator import MockPV
        from cometbft_tpu_torch.types.proposal import Proposal
        from cometbft_tpu_torch.types.vote import Vote
        from cometbft_tpu_torch.types.vote_set import VoteSet
    return types.SimpleNamespace(**{k: v for k, v in locals().items() if k != "side"})


def pvs_of(P, tag: bytes, n: int = 4):
    return [P.MockPV(priv_key=P.ed.gen_priv_key_from_secret(
        hashlib.sha256(b"%s-%d" % (tag, i)).digest())) for i in range(n)]


def genesis_of(P, pvs):
    gen = P.GenesisDoc(chain_id=CHAIN_ID, genesis_time=P.Time(1700000000, 0), validators=[
        P.GenesisValidator(pv.address(), pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(pvs)])
    gen.validate_and_complete()
    return gen


def node_of(P, gen, pv, name: str, gossip_sleep=None):
    state = P.make_genesis_state(gen)
    conns = P.AppConns(P.local_client_creator(P.KVStoreApplication()))
    conns.start()
    cfg = P.cfg_mod.test_config()
    mempool = P.CListMempool(cfg.mempool, conns.mempool)
    state_store, block_store = P.StateStore(P.MemDB()), P.BlockStore(P.MemDB())
    state_store.save(state)
    executor = P.BlockExecutor(state_store, conns.consensus, mempool, None, block_store)
    cs = P.ConsensusState(cfg.consensus, state, executor, block_store, mempool, name=name)
    cs.set_priv_validator(pv)
    return types.SimpleNamespace(cs=cs, state=state, executor=executor, mempool=mempool, cfg=cfg)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def backends():
    """Both packages on their ``CpuBackend``: the nodes check each vote and
    commit of the other package's nodes as it comes, and the port's plain
    PyTorch verify (``TorchBackend(device="cpu")``) takes ~1 s a call on this
    CPU, which would time a live mesh's rounds out."""
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.CpuBackend())
    try:
        yield
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed._verified.clear()
        ed25519._verified.clear()


# -- the catch-up cascade ------------------------------------------------------


class FakePeer:
    """tests/test_reactor_catchup.py's peer double: the raw bytes sent, and a
    switchable ``try_send`` (a full send queue answers False)."""

    def __init__(self, peer_id: str = "peer1", accept: bool = True):
        self.id = peer_id
        self.accept = accept
        self.sent = []

    def try_send(self, chan, data) -> bool:
        if not self.accept:
            return False
        self.sent.append((chan, bytes(data)))
        return True

    send = try_send

    def set(self, key, val):
        pass


class _Counter:
    def __init__(self):
        self.n = 0

    def inc(self, k: int = 1):
        self.n += k


def _vote(P, state, pv, vtype, height, round_, block_id=None):
    idx, _ = state.validators.get_by_address(pv.address())
    return pv.sign_vote(CHAIN_ID, P.Vote(type=vtype, height=height, round=round_,
                                         block_id=block_id or P.BlockID(),
                                         timestamp=P.Time(1700000001, 0),
                                         validator_address=pv.address(), validator_index=idx))


def _fill(P, cs, state, pvs, round_, vtypes=None, block_id=None):
    for pv in pvs:
        for t in vtypes or (P.PREVOTE_TYPE, P.PRECOMMIT_TYPE):
            assert cs.rs.votes.add_vote(_vote(P, state, pv, t, cs.rs.height, round_, block_id), "f")


def _last_commit(P, state, pvs, height):
    bid = P.BlockID(b"\x11" * 32, P.PartSetHeader(total=1, hash=b"\x22" * 32))
    vs = P.VoteSet(CHAIN_ID, height, 0, P.PRECOMMIT_TYPE, state.validators)
    for pv in pvs:
        assert vs.add_vote(_vote(P, state, pv, P.PRECOMMIT_TYPE, height, 0, bid))
    return vs


def _block_1(P, n):
    block = n.executor.create_proposal_block(
        1, n.state, P.Commit(height=0, round=0, block_id=P.BlockID(), signatures=[]),
        n.pvs[0].address())
    return block, block.make_part_set()


def _proposal(P, n, round_, pol_round, parts, block):
    return n.pvs[0].sign_proposal(CHAIN_ID, P.Proposal(
        height=1, round=round_, pol_round=pol_round,
        block_id=P.BlockID(block.hash(), parts.header()), timestamp=P.Time(1700000001, 0)))


def sc_behind_in_rounds(P, n, reactor, peer, ps):
    rs = n.cs.rs
    rs.votes.set_round(3)
    rs.round, rs.step = 2, P.cstypes.STEP_PREVOTE
    _fill(P, n.cs, n.state, n.pvs, 0)
    ps.height, ps.round, ps.step = rs.height, 0, P.cstypes.STEP_PREVOTE_WAIT


def sc_new_height_last_commit(P, n, reactor, peer, ps):
    rs = n.cs.rs
    rs.height = 2
    rs.votes = P.cstypes.HeightVoteSet(CHAIN_ID, 2, n.state.validators)
    rs.last_commit = _last_commit(P, n.state, n.pvs, 1)
    ps.height, ps.round, ps.step = 2, 0, P.cstypes.STEP_NEW_HEIGHT


def sc_propose_pol_prevotes(P, n, reactor, peer, ps):
    rs = n.cs.rs
    rs.votes.set_round(3)
    rs.round, rs.step = 2, P.cstypes.STEP_PREVOTE
    bid = P.BlockID(b"\x33" * 32, P.PartSetHeader(total=1, hash=b"\x44" * 32))
    _fill(P, n.cs, n.state, n.pvs, 1, (P.PREVOTE_TYPE,), bid)
    ps.height, ps.round, ps.step = rs.height, 2, P.cstypes.STEP_PROPOSE
    ps.proposal_pol_round = 1


def sc_one_height_behind_no_store(P, n, reactor, peer, ps):
    sc_new_height_last_commit(P, n, reactor, peer, ps)
    ps.height, ps.round, ps.step = 1, 0, P.cstypes.STEP_PREVOTE


def sc_behind_in_height_parts_and_seen_commit(P, n, reactor, peer, ps):
    block, parts = _block_1(P, n)
    bid = P.BlockID(block.hash(), parts.header())
    vs = P.VoteSet(CHAIN_ID, 1, 0, P.PRECOMMIT_TYPE, n.state.validators)
    for pv in n.pvs:
        assert vs.add_vote(_vote(P, n.state, pv, P.PRECOMMIT_TYPE, 1, 0, bid))
    n.cs.block_store.save_block(block, parts, vs.make_commit())
    rs = n.cs.rs
    rs.height = 2
    rs.votes = P.cstypes.HeightVoteSet(CHAIN_ID, 2, n.state.validators)
    ps.height, ps.round, ps.step = 1, 0, P.cstypes.STEP_PREVOTE


def sc_rejecting_try_send_then_drained(P, n, reactor, peer, ps):
    rs = n.cs.rs
    _fill(P, n.cs, n.state, n.pvs, 0)
    block, parts = _block_1(P, n)
    rs.proposal = _proposal(P, n, 0, -1, parts, block)
    rs.proposal_block_parts = parts
    rs.step = P.cstypes.STEP_PREVOTE
    ps.height, ps.round, ps.step = 1, 0, P.cstypes.STEP_PREVOTE
    peer.accept = False
    for _ in range(10):
        reactor._gossip_once(ps)
    assert not peer.sent and not ps._sent_votes and not ps._sent_parts
    peer.accept = True


def sc_proposal_pol_message(P, n, reactor, peer, ps):
    rs = n.cs.rs
    rs.votes.set_round(2)
    rs.round, rs.step = 1, P.cstypes.STEP_PROPOSE
    block, parts = _block_1(P, n)
    bid = P.BlockID(block.hash(), parts.header())
    _fill(P, n.cs, n.state, n.pvs, 0, (P.PREVOTE_TYPE,), bid)
    rs.proposal = _proposal(P, n, 1, 0, parts, block)
    rs.proposal_block_parts = parts
    ps.height, ps.round, ps.step = 1, 1, P.cstypes.STEP_PROPOSE


def sc_stale_round_part_mark(P, n, reactor, peer, ps):
    rs = n.cs.rs
    rs.votes.set_round(3)
    rs.round, rs.step = 2, P.cstypes.STEP_PREVOTE
    block, parts = _block_1(P, n)
    rs.proposal = _proposal(P, n, 2, -1, parts, block)
    rs.proposal_block_parts = parts
    ps.height, ps.round, ps.step = 1, 2, P.cstypes.STEP_PROPOSE
    assert ps.mark_part_sent(1, 0, 0)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_behind_in_rounds, sc_new_height_last_commit, sc_propose_pol_prevotes,
    sc_one_height_behind_no_store, sc_behind_in_height_parts_and_seen_commit,
    sc_rejecting_try_send_then_drained, sc_proposal_pol_message, sc_stale_round_part_mark)}


def run_cascade(side: str, name: str) -> dict:
    P = pkg(side)
    pvs = pvs_of(P, b"catchup")
    gen = genesis_of(P, pvs)
    n = node_of(P, gen, pvs[0], "catchup")
    n.pvs = pvs
    reactor = P.ConsensusReactor(n.cs, gossip_sleep=0.001)
    counter = _Counter()
    n.cs.metrics.round_catchup_votes_sent = counter
    peer = FakePeer()
    ps = P.PeerState(peer)
    P.cmttime.set_now_source(lambda: P.Time(1700000002, 0))
    try:
        SCENARIOS[name](P, n, reactor, peer, ps)
        for _ in range(40):
            reactor._gossip_once(ps)
        pol = [d for ch, d in peer.sent if isinstance(P.cmsg.decode_consensus_message(d),
                                                      P.cmsg.ProposalPOLMessage)]
        if name == "proposal_pol_message":  # a received ProposalPOL updates the peer state
            reactor.peer_states[peer.id] = ps
            ps.proposal_pol_round = -1
            reactor.receive(0x21, peer, pol[0])
    finally:
        P.cmttime.set_now_source(None)
        n.cs.stop()
    return {"sent": peer.sent, "votes": sorted(ps._sent_votes, key=repr),
            "parts": sorted(ps._sent_parts), "catchup": counter.n,
            "pol_round": ps.proposal_pol_round, "pol_msgs": len(pol)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_catchup_cascade_sends_what_the_reference_sends(name, backends):
    port, ref = run_cascade("port", name), run_cascade("ref", name)
    assert port == ref
    assert port["sent"]
    if name == "behind_in_rounds":
        assert port["catchup"] == 8
    if name == "proposal_pol_message":
        assert port["pol_msgs"] == 1 and port["pol_round"] == 0


def run_votes_lost_in_a_cut(side: str, cut: bool = True) -> dict:
    """The mechanism of the heal-only stall (ROADMAP §3): our prevotes were
    marked as sent to a peer while a partition dropped them; after the heal
    our maj23 query is answered by a ``VoteSetBits`` that holds only the
    peer's own prevote. Both packages add its bits to the marks and clear
    none (Go's ``ApplyVoteSetBitsMessage`` replaces them), so the gossip
    never sends the lost prevotes again."""
    P = pkg(side)
    if side == "ref":
        from cometbft_tpu.libs.bit_array import BitArray
    else:
        from cometbft_tpu_torch.libs.bit_array import BitArray
    pvs = pvs_of(P, b"cut")
    gen = genesis_of(P, pvs)
    n = node_of(P, gen, pvs[0], "cut")
    n.pvs = pvs
    reactor = P.ConsensusReactor(n.cs, gossip_sleep=0.001)
    peer = FakePeer()
    ps = P.PeerState(peer)
    reactor.peer_states[peer.id] = ps
    P.cmttime.set_now_source(lambda: P.Time(1700000002, 0))
    try:
        block, parts = _block_1(P, n)
        bid = P.BlockID(block.hash(), parts.header())
        own = [n.state.validators.get_by_address(pv.address())[0] for pv in pvs]
        _fill(P, n.cs, n.state, pvs[:3], 0, (P.PREVOTE_TYPE,), bid)
        rs = n.cs.rs
        rs.step = P.cstypes.STEP_PRECOMMIT
        ps.height, ps.round, ps.step = 1, 0, P.cstypes.STEP_PREVOTE
        for i in own[:3] if cut else ():  # sent into the cut
            assert ps.mark_vote_sent((1, 0, P.PREVOTE_TYPE, i))
        bits = BitArray(len(pvs))
        bits.set_index(own[3], True)
        reactor.receive(0x23, peer, P.cmsg.encode_consensus_message(P.cmsg.VoteSetBitsMessage(
            height=1, round=0, type=P.PREVOTE_TYPE, block_id=bid, votes=bits)))
        for _ in range(40):
            reactor._gossip_once(ps)
    finally:
        P.cmttime.set_now_source(None)
        n.cs.stop()
    votes = [m.vote.validator_index for m in (P.cmsg.decode_consensus_message(d)
                                               for _, d in peer.sent)
             if isinstance(m, P.cmsg.VoteMessage)]
    return {"sent": peer.sent, "votes_sent": votes, "marks": sorted(ps._sent_votes, key=repr),
            "own": own}


def test_vote_set_bits_leave_votes_lost_in_a_cut_marked(backends):
    port, ref = run_votes_lost_in_a_cut("port"), run_votes_lost_in_a_cut("ref")
    assert port == ref
    own = port["own"]
    assert port["votes_sent"] == []
    assert port["marks"] == sorted([(1, 0, 1, i) for i in own], key=repr)
    # Without the cut the same gossip sends the three prevotes.
    assert sorted(run_votes_lost_in_a_cut("port", cut=False)["votes_sent"]) == sorted(own[:3])


# -- a mixed network over TCP ---------------------------------------------------


def _wire(P, n, gossip_sleep: float):
    nk = P.NodeKey(P.ed.gen_priv_key_from_secret(b"nk-" + n.cs.name.encode()))
    ni = P.NodeInfo(node_id=nk.id, network=CHAIN_ID, moniker=n.cs.name)
    sw = P.Switch(ni, P.MultiplexTransport(ni, nk))
    n.reactor = P.ConsensusReactor(n.cs, gossip_sleep=gossip_sleep)
    n.mreactor = P.MempoolReactor(n.cfg.mempool, n.mempool)
    sw.add_reactor("CONSENSUS", n.reactor)
    sw.add_reactor("MEMPOOL", n.mreactor)
    n.sw, n.nk = sw, nk
    return n


def test_port_and_reference_validators_commit_together_over_tcp(backends):
    ref_p, port_p = pkg("ref"), pkg("port")
    ref_pvs = pvs_of(ref_p, b"mixed")
    gen = genesis_of(ref_p, ref_pvs)
    port_pvs = pvs_of(port_p, b"mixed")
    port_gen = port_p.GenesisDoc.from_json(gen.to_json())
    nodes = [_wire(ref_p, node_of(ref_p, gen, ref_pvs[0], "ref0"), 0.02),
             _wire(port_p, node_of(port_p, port_gen, port_pvs[1], "port1"), 0.02),
             _wire(ref_p, node_of(ref_p, gen, ref_pvs[2], "ref2"), 0.02),
             _wire(port_p, node_of(port_p, port_gen, port_pvs[3], "port3"), 0.02)]
    try:
        addrs = [f"{n.nk.id}@{n.sw.start('127.0.0.1:0')}" for n in nodes]
        for i, n in enumerate(nodes):
            for j in range(i + 1, len(nodes)):
                assert n.sw.dial_peer(addrs[j]) is not None
        deadline = time.monotonic() + WAIT_S
        while any(n.sw.num_peers() < 3 for n in nodes):
            assert time.monotonic() < deadline, [n.sw.num_peers() for n in nodes]
            time.sleep(0.02)
        for n in nodes:
            n.cs.start()
        nodes[1].mempool.check_tx(b"mixed=works")
        for n in nodes:
            assert n.cs.wait_for_height(4, timeout=WAIT_S), (n.cs.name, n.cs.rs.height)
        deadline = time.monotonic() + WAIT_S
        found = lambda n: any(b"mixed=works" in n.cs.block_store.load_block(h).data.txs
                              for h in range(1, n.cs.block_store.height() + 1))
        while not all(found(n) for n in nodes):
            assert time.monotonic() < deadline, [n.cs.block_store.height() for n in nodes]
            time.sleep(0.05)
        for h in range(1, 4):
            hashes = {n.cs.block_store.load_block(h).hash() for n in nodes}
            assert len(hashes) == 1, (h, hashes)
        for n in nodes[1::2]:
            assert n.sw.errors() == {"inbound_errors": 0, "redial_errors": 0,
                                     "recvq_errors": 0, "peer_errors": 0}
            assert n.reactor.gossip_errors == 0 and n.reactor.maj23_conflicts == 0
            assert set(n.mreactor.check_tx_errors) <= {"ErrTxInCache"}
    finally:
        for n in nodes:
            n.cs.stop()
            n.sw.stop()


# -- blocksync and evidence on the Switch ----------------------------------------


def test_port_node_blocksyncs_from_a_reference_node_over_tcp(backends):
    ref_p, port_p = pkg("ref"), pkg("port")
    chain = tc.build_ref_chain(b"p2p-bsync", n_vals=3, n_blocks=6)
    src = RefBlocksyncReactor(state=chain.states[-1], block_exec=None,
                              block_store=chain.block_store, block_sync=False)
    ref_nk = ref_p.NodeKey(ref_p.ed.gen_priv_key_from_secret(b"bsync-src"))
    ref_ni = ref_p.NodeInfo(node_id=ref_nk.id, network=tc.CHAIN_ID, moniker="src")
    ref_sw = ref_p.Switch(ref_ni, ref_p.MultiplexTransport(ref_ni, ref_nk))
    ref_sw.add_reactor("BLOCKSYNC", src)
    node = tc.port_node(chain)
    synced = threading.Event()
    dst = BlocksyncReactor(state=node.state, block_exec=node.executor,
                           block_store=node.block_store, block_sync=True,
                           on_caught_up=lambda state: synced.set())
    nk = port_p.NodeKey(port_p.ed.gen_priv_key_from_secret(b"bsync-dst"))
    ni = port_p.NodeInfo(node_id=nk.id, network=tc.CHAIN_ID, moniker="dst")
    sw = port_p.Switch(ni, port_p.MultiplexTransport(ni, nk))
    sw.add_reactor("BLOCKSYNC", dst)
    sw.add_reactor("EVIDENCE", EvidenceReactor(node.evpool))
    assert sw.node_info.channels == bytes([0x38, BLOCKSYNC_CHANNEL])
    addr = ref_sw.start("127.0.0.1:0")
    sw.start("")
    try:
        assert sw.dial_peer(f"{ref_nk.id}@{addr}") is not None
        deadline = time.monotonic() + WAIT_S
        while node.block_store.height() < len(chain.blocks) - 1:
            assert time.monotonic() < deadline, node.block_store.height()
            time.sleep(0.05)
        for h in range(1, len(chain.blocks)):
            assert node.block_store.load_block(h).encode() == chain.blocks[h - 1].encode()
        assert dst.sync_errors == 0 and dst.prefetch_errors == 0
        assert sw.errors()["peer_errors"] == 0
    finally:
        sw.stop()
        ref_sw.stop()


# -- mempool wire and counted exceptions ------------------------------------------


def test_txs_message_equals_the_reference():
    for txs in ([], [b""], [b"a"], [b"k=v", b"", b"x" * 300]):
        assert encode_txs_message(txs) == ref_encode_txs(txs)
        assert decode_txs_message(ref_encode_txs(txs)) == ref_decode_txs(ref_encode_txs(txs)) == txs


def test_counted_reactor_errors(backends):
    P = pkg("port")
    pvs = pvs_of(P, b"errors")
    n = node_of(P, genesis_of(P, pvs), pvs[0], "errors")
    reactor = P.ConsensusReactor(n.cs, gossip_sleep=0.001)
    peer = FakePeer()
    ps = P.PeerState(peer)
    reactor.peer_states[peer.id] = ps
    msg = P.cmsg.VoteSetMaj23Message(height=1, round=0, type=7, block_id=P.BlockID())
    reactor.receive(0x20, peer, P.cmsg.encode_consensus_message(msg))
    assert reactor.maj23_conflicts == 1 and "invalid vote type" in str(reactor.last_maj23_conflict)
    assert not peer.sent  # logged, not answered, and the peer is not stopped
    planted = {"left": 1}

    def gossip_once(ps_):
        if planted["left"]:
            planted["left"] -= 1
            raise RuntimeError("planted gossip failure")
        reactor._running = False
        return False

    reactor._gossip_once = gossip_once
    reactor._running = True
    t = threading.Thread(target=reactor._gossip_routine, args=(ps,), daemon=True)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive()
    assert reactor.gossip_errors == 1 and "planted" in str(reactor.last_gossip_error)
    mreactor = P.MempoolReactor(n.cfg.mempool, n.mempool)
    mreactor.receive(0x30, peer, encode_txs_message([b"k=v"]))
    mreactor.receive(0x30, peer, encode_txs_message([b"k=v"]))
    assert mreactor.check_tx_errors == {"ErrTxInCache": 1}
    assert type(mreactor.last_check_tx_error).__name__ == "ErrTxInCache"
    n.cs.stop()
