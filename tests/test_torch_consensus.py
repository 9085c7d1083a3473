"""The consensus state machine of the port (``consensus/state.py``, its
ticker and WAL) against the JAX package's.

- The threaded network of ``tests/test_consensus.py``: 4 validators, each a
  started ``ConsensusState`` with a real WAL, an event bus and the kvstore,
  wired by an in-memory broadcast, commit 3 heights with the same blocks,
  and each WAL records the end heights.
- ``_set_proposal`` refuses a forged proposal and a bad POL round with the
  reference's error types and texts, ignores a stale one and takes the
  proposer's; a mismatched block part is refused as the reference refuses it.
- Full-node ingestion (chip_smoke's path (b) at 16 validators): a chain of
  the reference's executor, and a reference and a port node with no priv
  validator, each started, fed each height's proposal, parts, 16 prevotes
  and the source's seen commit as 16 precommits through
  ``send_peer_message``: the same blocks, seen commits, states and app
  hashes, the drains' prebatches on each package's backend (the reference's
  ``CpuBackend``, the port's ``TorchBackend(device="cpu")``).
- A backend that raises during the prebatch: the state machine counts it in
  ``prebatch_errors`` (the last kept) and still admits the votes through the
  single verify, committing the same blocks.
- Restarts: a WAL the reference wrote restores the round it records (a
  peer's vote at an absurd round does not), and a prevote that only the
  privval's state file (the reference's) remembers is re-published, in
  both packages alike; the stall watchdog reads the injected clock and
  counts a failing hook in ``stall_errors``."""

import os
import time

import pytest
import torch
import torch_chains as tc

from cometbft_tpu.consensus import state as ref_state_mod
from cometbft_tpu.consensus.cstypes import STEP_PROPOSE as REF_STEP_PROPOSE
from cometbft_tpu.consensus.messages import BlockPartMessage as RefPartMsg
from cometbft_tpu.consensus.messages import ProposalMessage as RefProposalMsg
from cometbft_tpu.consensus.messages import VoteMessage as RefVoteMsg
from cometbft_tpu.consensus.wal import WAL as RefWAL
from cometbft_tpu.config.config import ConsensusConfig as RefConsensusConfig
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import sigbatch as ref_sigbatch
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.state import store as ref_store
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import Time as RefTime
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.block import PREVOTE_TYPE
from cometbft_tpu.types.proposal import Proposal as RefProposal
from cometbft_tpu.types.vote import VoteError as RefVoteError
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import ConsensusConfig
from cometbft_tpu_torch.config import test_config as make_test_config
from cometbft_tpu_torch.consensus.cstypes import STEP_PROPOSE
from cometbft_tpu_torch.consensus.messages import BlockPartMessage, ProposalMessage, VoteMessage
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.crypto import sigbatch
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
from cometbft_tpu_torch.state import store as port_store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import BlockID, Time
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.part_set import Part, PartSet, PartSetHeader
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote, VoteError

pytestmark = pytest.mark.torch_port

NET_CHAIN = "cs-test-chain"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def backends():
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.TorchBackend(device="cpu"))
    ref_sigbatch.reset()
    sigbatch.reset()
    try:
        yield
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_sigbatch.reset()
        sigbatch.reset()
        ref_ed._verified.clear()
        ed25519._verified.clear()


# -- the threaded network (tests/test_consensus.py:26) --------------------------


def make_network(n: int, tmpdir: str):
    pvs = [MockPV(priv_key=ed25519.gen_priv_key_from_secret(b"net-%d" % i)) for i in range(n)]
    gen = GenesisDoc(chain_id=NET_CHAIN, genesis_time=Time(1700000000, 0), validators=[
        GenesisValidator(pv.address(), pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(pvs)])
    gen.validate_and_complete()
    nodes = []
    for i, pv in enumerate(pvs):
        state = make_genesis_state(gen)
        conns = AppConns(local_client_creator(KVStoreApplication()))
        conns.start()
        cfg = make_test_config()
        mempool = CListMempool(cfg.mempool, conns.mempool)
        state_store, block_store = StateStore(MemDB()), BlockStore(MemDB())
        state_store.save(state)
        bus = EventBus()
        bus.start()
        executor = BlockExecutor(state_store, conns.consensus, mempool, None, block_store,
                                 event_bus=bus)
        cs = ConsensusState(cfg.consensus, state, executor, block_store, mempool, event_bus=bus,
                            wal=WAL(os.path.join(tmpdir, f"wal{i}", "wal")), name=f"node{i}")
        cs.set_priv_validator(pv)
        nodes.append(cs)

    def make_broadcast(src):
        def broadcast(msg):
            for j, peer in enumerate(nodes):
                if j != src:
                    peer.send_peer_message(msg, peer_id=f"node{src}")
        return broadcast

    for i, cs in enumerate(nodes):
        cs.set_broadcast(make_broadcast(i))
    return nodes


def test_four_validators_commit_and_record_end_heights(tmp_path, backends):
    nodes = make_network(4, str(tmp_path))
    try:
        for cs in nodes:
            cs.start()
        for cs in nodes:
            assert cs.wait_for_height(4, timeout=60), \
                f"{cs.name} stuck at {cs.rs.height}/{cs.rs.round}/{cs.rs.step}"
        for h in (1, 2, 3):
            assert len({cs.block_store.load_block(h).hash() for cs in nodes}) == 1
        for cs in nodes:
            assert cs.prebatch_errors == 0 and cs.consensus_failures == 0
    finally:
        for cs in nodes:
            cs.stop()
    for cs in nodes:
        heights = [tm.msg.height for tm in cs.wal.iter_messages()
                   if isinstance(tm.msg, EndHeightMessage)]
        assert heights[:4] == [0, 1, 2, 3]


def test_set_proposal_refusals_equal_the_reference(tmp_path, backends):
    nodes = make_network(4, str(tmp_path))
    ref_nodes = _ref_network(4, str(tmp_path / "ref"))
    try:
        for cs, rcs in ((nodes[0], ref_nodes[0]),):
            pv_by_addr = {n.priv_validator.address(): n.priv_validator for n in nodes}
            ref_pv_by_addr = {n.priv_validator.address(): n.priv_validator for n in ref_nodes}
            proposer = cs.rs.validators.get_proposer().address
            ref_proposer = rcs.rs.validators.get_proposer().address
            outsider = next(a for a in pv_by_addr if a != proposer)
            ref_outsider = next(a for a in ref_pv_by_addr if a != ref_proposer)
            bid = BlockID(b"\x09" * 32, PartSetHeader(1, b"\x0a" * 32))
            rbid = RefBlockID.decode(bid.encode())

            def mk(pvs, addr, cls, b, pol_round=-1, height=None, t=Time):
                p = cls(height=height if height is not None else 1, round=0, pol_round=pol_round,
                        block_id=b, timestamp=t(1700000002, 0))
                return pvs[addr].sign_proposal(NET_CHAIN, p)

            cases = [dict(who="outsider"), dict(who="proposer", pol_round=0),
                     dict(who="proposer", pol_round=-2), dict(who="proposer", height=6),
                     dict(who="proposer")]
            for case in cases:
                who = case.pop("who")
                p = mk(pv_by_addr, outsider if who == "outsider" else proposer, Proposal, bid,
                       **case)
                r = mk(ref_pv_by_addr, ref_outsider if who == "outsider" else ref_proposer,
                       RefProposal, rbid, t=RefTime, **case)
                a, b = _outcome(lambda: cs._set_proposal(p)), _outcome(lambda: rcs._set_proposal(r))
                assert a == b, (who, case)
                assert (cs.rs.proposal is None) == (rcs.rs.proposal is None)
            assert cs.rs.proposal is not None
            # A part that fails the proof: quiet from another round, an
            # error from this one, as in the reference.
            wrong = PartSet.from_data(b"some other block entirely" * 100)
            right = PartSet.from_data(b"the proposal this round is about" * 100_000)
            cs.rs.height, cs.rs.round = 5, 1
            cs.rs.proposal_block_parts = PartSet(right.header())
            assert cs._add_proposal_block_part(BlockPartMessage(5, 0, wrong.get_part(0)), "x") \
                is False
            with pytest.raises(ValueError):
                cs._add_proposal_block_part(BlockPartMessage(5, 1, wrong.get_part(0)), "x")
            assert cs._add_proposal_block_part(BlockPartMessage(5, 1, right.get_part(0)), "x")
    finally:
        for cs in nodes + ref_nodes:
            cs.stop()


def _ref_network(n, tmpdir):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_consensus import make_network as ref_make_network

    return [cs for cs, _, _ in ref_make_network(n, tmpdir)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (VoteError, RefVoteError, ValueError) as e:
        return (type(e).__name__, str(e))


# -- full-node ingestion (chip_smoke's path (b) at 16 validators) ----------------

N_VALS = 16
HEIGHTS = 3


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"follow", n_vals=N_VALS, n_blocks=HEIGHTS + 1)


def _feed(chain):
    """Each height's messages in the reference's types: the proposal signed
    by the block's proposer, the parts, the prevotes, the seen commit's
    precommits."""
    pvs = {pv.address(): pv for pv in chain.pvs}
    out = []
    for h in range(1, HEIGHTS + 1):
        block = chain.blocks[h - 1]
        parts = block.make_part_set()
        bid = RefBlockID(block.hash(), parts.header())
        prop = pvs[block.header.proposer_address].sign_proposal(tc.CHAIN_ID, RefProposal(
            height=h, round=0, pol_round=-1, block_id=bid, timestamp=block.header.time))
        seen = chain.seen[h - 1]
        prevotes = [pvs[cs.validator_address].sign_vote(tc.CHAIN_ID, RefVote(
            type=PREVOTE_TYPE, height=h, round=0, block_id=bid,
            timestamp=block.header.time.add_nanos(5 * 10**8 + 977 * i),
            validator_address=cs.validator_address, validator_index=i))
            for i, cs in enumerate(seen.signatures)]
        precommits = [RefVote(type=2, height=h, round=seen.round,
                              block_id=cs.block_id(seen.block_id), timestamp=cs.timestamp,
                              validator_address=cs.validator_address, validator_index=i,
                              signature=cs.signature)
                      for i, cs in enumerate(seen.signatures) if not cs.is_absent()]
        out.append((prop, [parts.get_part(k) for k in range(parts.total)], prevotes, precommits))
    return out


def _follow(side, chain, feed, tmpdir, corrupt=None):
    """Start a follower of one package and feed it every height; returns the
    node and its state machine."""
    if side == "ref":
        node = tc.ref_node(chain)
        cfg = RefConsensusConfig(timeout_propose=600.0, timeout_prevote=600.0,
                                 timeout_precommit=600.0, timeout_commit=600.0,
                                 skip_timeout_commit=True)
        cs = ref_state_mod.ConsensusState(cfg, node.state, node.executor, node.block_store,
                                          node.mempool, wal=RefWAL(os.path.join(tmpdir, "wal")))
        conv = dict(proposal=lambda p: RefProposalMsg(p),
                    part=lambda h, p: RefPartMsg(h, 0, p), vote=lambda v: RefVoteMsg(v))
        step_propose = REF_STEP_PROPOSE
    else:
        node = tc.port_node(chain)
        cfg = ConsensusConfig(timeout_propose=600.0, timeout_prevote=600.0,
                              timeout_precommit=600.0, timeout_commit=600.0,
                              skip_timeout_commit=True)
        cs = ConsensusState(cfg, node.state, node.executor, node.block_store, node.mempool,
                            wal=WAL(os.path.join(tmpdir, "wal")))
        conv = dict(proposal=lambda p: ProposalMessage(Proposal.decode(p.encode())),
                    part=lambda h, p: BlockPartMessage(h, 0, Part.decode(p.encode())),
                    vote=lambda v: VoteMessage(Vote.decode(v.encode())))
        step_propose = STEP_PROPOSE
    cs.start()
    try:
        for h, (prop, parts, prevotes, precommits) in enumerate(feed, start=1):
            cs.send_peer_message(conv["proposal"](prop), "p0")
            for part in parts:
                cs.send_peer_message(conv["part"](h, part), "p0")
            for i, v in enumerate(prevotes + precommits):
                cs.send_peer_message(conv["vote"](v), f"p{i % 4}")
            assert cs.wait_for_height(h + 1, timeout=120), (side, h, cs.rs.step)
            deadline = time.monotonic() + 120
            while not (cs.rs.height == h + 1 and cs.rs.step >= step_propose):
                assert time.monotonic() < deadline, (side, h, "precommits not all in")
                time.sleep(0.002)
    finally:
        cs.stop()
    return node, cs


def _items(side, node):
    bs = node.block_store
    enc = ref_store._encode_state if side == "ref" else port_store._encode_state
    return ([bs.load_block(h).encode() for h in range(1, HEIGHTS + 1)],
            [bs.load_seen_commit(h).encode() for h in range(1, HEIGHTS + 1)],
            enc(node.state_store.load()), node.state_store.load().app_hash)


def test_full_node_ingestion_commits_the_reference_blocks(chain, backends, tmp_path):
    feed = _feed(chain)
    ref_node, ref_cs = _follow("ref", chain, feed, str(tmp_path / "ref"))
    calls = []
    inner = backend.get_backend()

    class Recording:
        def batch_verify(self, pubs, msgs, sigs):
            calls.append(len(pubs))
            return inner.batch_verify(pubs, msgs, sigs)

        def merkle_root(self, leaves):
            return inner.merkle_root(leaves)

    backend.set_backend(Recording())
    port_node, port_cs = _follow("port", chain, feed, str(tmp_path / "port"))
    ref_items, port_items = _items("ref", ref_node), _items("port", port_node)
    assert port_items == ref_items
    assert port_items[0] == [b.encode() for b in chain.blocks[:HEIGHTS]]
    assert port_cs.prebatch_errors == 0 and port_cs.consensus_failures == 0
    # Every vote reached the port's backend once: the drains' prebatches.
    assert sum(calls) >= HEIGHTS * 2 * N_VALS and max(calls) >= 8


def test_a_failing_prebatch_is_counted_and_votes_still_admitted(chain, backends, tmp_path,
                                                                monkeypatch):
    monkeypatch.setenv("CMTPU_VOTE_BATCH_WINDOW_MS", "0")  # the single verify inline
    sigbatch.reset()

    class Failing:
        def batch_verify(self, pubs, msgs, sigs):
            raise RuntimeError("planted backend failure")

        def merkle_root(self, leaves):
            raise RuntimeError("planted backend failure")

    backend.set_backend(Failing())
    feed = _feed(chain)[:1]
    node, cs = _follow("port", chain, feed, str(tmp_path))
    assert cs.prebatch_errors >= 1
    assert "planted backend failure" in str(cs.last_prebatch_error)
    assert cs.consensus_failures == 0
    assert node.block_store.load_block(1).encode() == chain.blocks[0].encode()
    seen = node.block_store.load_seen_commit(1)
    assert 3 * sum(1 for s in seen.signatures if not s.is_absent()) > 2 * N_VALS


# -- restart: WAL catch-up, privval recovery, the stall watchdog -----------------

RESTART_CHAIN = "restart-chain"


def _restart_genesis():
    from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
    from cometbft_tpu.types import GenesisValidator as RefGenesisValidator
    from cometbft_tpu.types.priv_validator import MockPV as RefMockPV

    ref_pvs = [RefMockPV(ref_ed.gen_priv_key_from_secret(b"restart-%d" % i)) for i in range(4)]
    gen = RefGenesisDoc(chain_id=RESTART_CHAIN, genesis_time=RefTime(1700000000, 0), validators=[
        RefGenesisValidator(pv.address(), pv.get_pub_key(), 10, f"v{i}")
        for i, pv in enumerate(ref_pvs)])
    gen.validate_and_complete()
    pvs = [MockPV(priv_key=ed25519.gen_priv_key_from_secret(b"restart-%d" % i)) for i in range(4)]
    return gen, ref_pvs, pvs


def _solo(side, gen, pv, wal_path, clock=None):
    """A node of one package from the reference's genesis, with pv and the
    WAL at wal_path."""
    if side == "ref":
        from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
        from cometbft_tpu.config import test_config as ref_test_config
        from cometbft_tpu.libs.db import MemDB as RefMemDB
        from cometbft_tpu.mempool import CListMempool as RefMempool
        from cometbft_tpu.proxy import AppConns as RefConns
        from cometbft_tpu.proxy import local_client_creator as ref_creator
        from cometbft_tpu.state import BlockExecutor as RefExecutor
        from cometbft_tpu.state import StateStore as RefStateStore
        from cometbft_tpu.state import make_genesis_state as ref_genesis_state
        from cometbft_tpu.store import BlockStore as RefBlockStore

        state, cfg = ref_genesis_state(gen), ref_test_config()
        conns = RefConns(ref_creator(RefKV()))
        conns.start()
        mempool = RefMempool(cfg.mempool, conns.mempool)
        ss, bs = RefStateStore(RefMemDB()), RefBlockStore(RefMemDB())
        ss.save(state)
        cs = ref_state_mod.ConsensusState(
            cfg.consensus, state, RefExecutor(ss, conns.consensus, mempool, None, bs), bs, mempool,
            wal=RefWAL(wal_path) if wal_path else None, name="solo", clock=clock)
    else:
        state, cfg = make_genesis_state(GenesisDoc.from_json(gen.to_json())), make_test_config()
        conns = AppConns(local_client_creator(KVStoreApplication()))
        conns.start()
        mempool = CListMempool(cfg.mempool, conns.mempool)
        ss, bs = StateStore(MemDB()), BlockStore(MemDB())
        ss.save(state)
        cs = ConsensusState(cfg.consensus, state, BlockExecutor(ss, conns.consensus, mempool, None, bs),
                            bs, mempool, wal=WAL(wal_path) if wal_path else None, name="solo",
                            clock=clock)
    cs.set_priv_validator(pv)
    return cs


def _restarted(cs, round_, addr):
    cs.start()
    try:
        deadline = time.monotonic() + 5.0
        own = None
        while time.monotonic() < deadline:
            pv_set = cs.rs.votes.prevotes(round_)
            own = pv_set.get_by_address(addr) if pv_set is not None else None
            if own is not None:
                break
            time.sleep(0.02)
        return (cs.rs.height, cs.rs.round, cs.rs.step >= 4,
                own.encode() if own is not None else None)
    finally:
        cs.stop()


def test_wal_catchup_restores_the_round_as_the_reference(tmp_path, backends):
    """A WAL the reference wrote (the node's own prevotes at rounds 0-2, a
    ticker timeout, and a peer's prevote at round 1000, which must not drag
    the round) restarts a port node and a reference node at round 2 in its
    prevote step, the own vote back in the vote set."""
    import shutil

    from cometbft_tpu.consensus.cstypes import STEP_PROPOSE as RP
    from cometbft_tpu.consensus.messages import TimeoutInfo as RefTimeoutInfo

    gen, ref_pvs, pvs = _restart_genesis()
    from cometbft_tpu.state import make_genesis_state as ref_genesis_state

    vals = ref_genesis_state(gen).validators
    idx0, _ = vals.get_by_address(ref_pvs[0].address())
    idx1, _ = vals.get_by_address(ref_pvs[1].address())
    src = str(tmp_path / "src" / "wal")
    wal = RefWAL(src)
    wal.start()
    for r in range(3):
        wal.write_sync(RefVoteMsg(ref_pvs[0].sign_vote(RESTART_CHAIN, RefVote(
            type=PREVOTE_TYPE, height=1, round=r, block_id=RefBlockID(),
            timestamp=RefTime(1700000001, 0), validator_address=ref_pvs[0].address(),
            validator_index=idx0))))
    wal.write_sync(RefTimeoutInfo(0.4, 1, 2, RP))
    wal.write(RefVoteMsg(ref_pvs[1].sign_vote(RESTART_CHAIN, RefVote(
        type=PREVOTE_TYPE, height=1, round=1000, block_id=RefBlockID(),
        timestamp=RefTime(1700000001, 0), validator_address=ref_pvs[1].address(),
        validator_index=idx1))))
    wal.stop()
    out = {}
    for side, pv in (("ref", ref_pvs[0]), ("port", pvs[0])):
        os.makedirs(tmp_path / side)
        shutil.copy(src, tmp_path / side / "wal")
        cs = _solo(side, gen, pv, str(tmp_path / side / "wal"))
        out[side] = _restarted(cs, 2, pv.address())
        if side == "port":
            assert cs.wal_catchup_errors == 0 and cs.consensus_failures == 0
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (1, 2, True) and out["port"][3] is not None


def test_privval_vote_recovered_from_the_reference_state_file(tmp_path, backends):
    """The privval's sign state holds a prevote that the WAL lost: a port
    node restarted over the reference's key and state files (its WAL only
    the anchor) re-publishes the same vote at the same round, as the
    reference's does."""
    import shutil

    from cometbft_tpu.privval.file import FilePV as RefFilePV
    from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
    from cometbft_tpu.types import GenesisValidator as RefGenesisValidator

    key = ref_ed.gen_priv_key_from_secret(b"restart-filepv")
    src = tmp_path / "src"
    src.mkdir()
    ref_pv = RefFilePV(key, str(src / "key.json"), str(src / "state.json"))
    ref_pv.save()
    others = _restart_genesis()[1][1:]
    gen = RefGenesisDoc(chain_id=RESTART_CHAIN, genesis_time=RefTime(1700000000, 0), validators=[
        RefGenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(), 10, f"v{i}")
        for i, pv in enumerate([ref_pv] + others)])
    gen.validate_and_complete()
    from cometbft_tpu.state import make_genesis_state as ref_genesis_state

    idx, _ = ref_genesis_state(gen).validators.get_by_address(ref_pv.address())
    signed = ref_pv.sign_vote(RESTART_CHAIN, RefVote(
        type=PREVOTE_TYPE, height=1, round=2, block_id=RefBlockID(),
        timestamp=RefTime(1700000001, 0), validator_address=ref_pv.address(),
        validator_index=idx))
    out = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(src / "key.json", d / "key.json")
        shutil.copy(src / "state.json", d / "state.json")
        if side == "ref":
            pv, w = RefFilePV.load(str(d / "key.json"), str(d / "state.json")), RefWAL(str(d / "wal"))
        else:
            from cometbft_tpu_torch import convert

            pv = convert.file_pv_from_state_files(str(d / "key.json"), str(d / "state.json"))
            w = WAL(str(d / "wal"))
        w.start()
        w.stop()
        cs = _solo(side, gen, pv, str(d / "wal"))
        out[side] = _restarted(cs, 2, ref_pv.address())
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (1, 2, True)
    assert Vote.decode(out["port"][3]).signature == signed.signature


def test_stall_watchdog_is_clock_driven_and_counts_hook_errors(backends):
    """The stall watchdog reads the injected clock: a virtual jump past the
    budget fires the hook once, re-armed after; a hook that raises is
    counted in ``stall_errors`` (the reference passes over it)."""
    from cometbft_tpu_torch.simnet.clock import SimClock

    gen, _, pvs = _restart_genesis()
    clock = SimClock()
    cs = _solo("port", gen, pvs[0], None, clock=clock)
    cs._stall_factor = 2.0
    fired = []

    class Counter:
        n = 0

        def inc(self, v=1):
            Counter.n += v

    cs.metrics.consensus_stalls_total = Counter()
    cs.set_on_stall(lambda: fired.append(clock.now()))
    budget = cs.config.round_timeout_budget(0) * 2.0
    assert cs._stall_check() is False
    clock.run(until=budget + 1.0)
    assert cs._stall_check() is True and len(fired) == 1 and Counter.n == 1
    assert cs._stall_check() is False and cs.stall_errors == 0

    def boom():
        raise RuntimeError("planted hook failure")

    cs.set_on_stall(boom)
    clock.run(until=2 * budget + 2.0)
    assert cs._stall_check() is True
    assert cs.stall_errors == 1 and "planted hook failure" in str(cs.last_stall_error)
