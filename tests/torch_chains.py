"""Chains built by the JAX package's blocksync path, and the in-process peer
doubles that serve them, for the port's blocksync tests
(``tests/test_torch_block.py``, ``test_torch_state.py``,
``test_torch_abci_app.py``, ``test_torch_blocksync.py``).

A chain is built as the package's own ``tests/test_blocksync*.py`` build
theirs: a ``BlockExecutor`` over a ``PersistentKVStoreApplication`` and a
``CListMempool``, every block signed by every validator (``MockPV`` over
keys from fixed seeds). A few kvstore transactions ride each block, a
``val:`` transaction can promote a new validator, and an evidence pool
double can put a ``DuplicateVoteEvidence`` into one block. The port's
nodes start from the same genesis, carried across as genesis JSON.
"""

from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass, field

from cometbft_tpu.abci.example.kvstore import PersistentKVStoreApplication as RefApp
from cometbft_tpu.blocksync import reactor as ref_reactor
from cometbft_tpu.config import test_config as ref_test_config
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.mempool import CListMempool as RefMempool
from cometbft_tpu.proxy import AppConns as RefAppConns
from cometbft_tpu.proxy import local_client_creator as ref_local_creator
from cometbft_tpu.state import BlockExecutor as RefExecutor
from cometbft_tpu.state import StateStore as RefStateStore
from cometbft_tpu.state import make_genesis_state as ref_genesis_state
from cometbft_tpu.store import BlockStore as RefBlockStore
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import Commit as RefCommit
from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
from cometbft_tpu.types import GenesisValidator as RefGenesisValidator
from cometbft_tpu.types import PartSetHeader as RefPSH
from cometbft_tpu.types import Time as RefTime
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.block import PRECOMMIT_TYPE
from cometbft_tpu.types.evidence import DuplicateVoteEvidence as RefDupEvidence
from cometbft_tpu.types.priv_validator import MockPV as RefMockPV
from cometbft_tpu.types.vote import vote_to_commit_sig as ref_vote_to_commit_sig
from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication
from cometbft_tpu_torch.blocksync import reactor as port_reactor
from cometbft_tpu_torch.config import MempoolConfig
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.genesis import GenesisDoc

CHAIN_ID = "torch-bsync-chain"
GENESIS_TIME = RefTime(1_700_000_000, 0)


def ref_pv(tag: bytes, i: int) -> RefMockPV:
    secret = hashlib.sha256(b"%s-validator-%d" % (tag, i)).digest()
    return RefMockPV(ref_ed.gen_priv_key_from_secret(secret))


class EvidencePool:
    """An evidence pool double: hands what ``evidence`` holds to the next
    proposal (once) and accepts whatever a block carries (the package's own
    blocksync tests run with no pool)."""

    def __init__(self):
        self.evidence: list = []
        self.checked: list[int] = []

    def pending_evidence(self, max_bytes: int):
        evidence, self.evidence = self.evidence, []
        return evidence, sum(len(ev.bytes()) for ev in evidence)

    def check_evidence(self, evidence) -> None:
        self.checked.append(len(evidence))

    def update(self, state, evidence) -> None:
        pass


@dataclass
class RefChain:
    """A chain of ``n_blocks`` heights and what it was built with."""

    gen: RefGenesisDoc
    pvs: list
    block_store: RefBlockStore
    state_store: RefStateStore
    blocks: list  # blocks[h - 1] is height h
    seen: list  # seen[h - 1], the commit signed for height h
    states: list  # states[h], the state after applying height h (states[0] genesis)
    promote_at: int | None
    new_pv: RefMockPV | None
    evidence_at: int | None
    db_items: list = field(default_factory=list)

    @property
    def gen_json(self) -> str:
        return self.gen.to_json()


def _sign_commit(state, pv_by_addr, height: int, bid, time: RefTime) -> RefCommit:
    sigs = []
    for idx, val in enumerate(state.validators.validators):
        vote = RefVote(
            type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
            timestamp=time.add_nanos(10**9 * (idx + 1)),
            validator_address=val.address, validator_index=idx,
        )
        sigs.append(ref_vote_to_commit_sig(pv_by_addr[val.address].sign_vote(CHAIN_ID, vote)))
    return RefCommit(height=height, round=0, block_id=bid, signatures=sigs)


def build_ref_chain(tag: bytes, n_vals: int = 3, n_blocks: int = 10, promote_at=None,
                    evidence_at=None, txs_per_block: int = 3) -> RefChain:
    """Build and apply ``n_blocks`` heights with the package's executor, one
    ``key=value`` transaction a slot, a ``val:`` transaction at
    ``promote_at`` (the new validator joins the set two heights later) and a
    duplicate-vote evidence of validator 0 in the block at ``evidence_at``."""
    pvs = [ref_pv(tag, i) for i in range(n_vals)]
    new_pv = ref_pv(tag, n_vals) if promote_at else None
    gen = RefGenesisDoc(
        chain_id=CHAIN_ID, genesis_time=GENESIS_TIME,
        validators=[RefGenesisValidator(pv.address(), pv.get_pub_key(), 10, "") for pv in pvs],
    )
    gen.validate_and_complete()
    state = ref_genesis_state(gen)
    conns = RefAppConns(ref_local_creator(RefApp()))
    conns.start()
    mempool = RefMempool(ref_test_config().mempool, conns.mempool)
    db = RefMemDB()
    ss, bs = RefStateStore(db), RefBlockStore(db)
    ss.save(state)
    evpool = EvidencePool()
    ex = RefExecutor(ss, conns.consensus, mempool, evpool, bs)
    pv_by_addr = {pv.address(): pv for pv in pvs}
    if new_pv is not None:
        pv_by_addr[new_pv.address()] = new_pv
    last_commit = RefCommit(height=0, round=0)
    blocks, seen, states = [], [], [state]
    for h in range(1, n_blocks + 1):
        for j in range(txs_per_block):
            mempool.check_tx(b"%s-key-%d-%d=value-%d" % (tag, h, j, h * j))
        if h == promote_at:
            mempool.check_tx(b"val:" + base64.b64encode(new_pv.get_pub_key().bytes()) + b"!15")
        if h == evidence_at:
            evpool.evidence = [_duplicate_vote(state, pvs[0], h - 1)]
        proposer = state.validators.get_proposer()
        block = ex.create_proposal_block(h, state, last_commit, proposer.address)
        parts = block.make_part_set()
        bid = RefBlockID(block.hash(), parts.header())
        commit = _sign_commit(state, pv_by_addr, h, bid, block.header.time)
        bs.save_block(block, parts, commit)
        state, _ = ex.apply_block(state, bid, block)
        blocks.append(block)
        seen.append(commit)
        states.append(state)
        last_commit = commit
    return RefChain(gen, pvs, bs, ss, blocks, seen, states, promote_at, new_pv, evidence_at,
                    list(db.iterator()))


def _duplicate_vote(state, pv, height: int) -> RefDupEvidence:
    """Validator ``pv`` precommits two different blocks at ``height``."""
    idx, val = state.last_validators.get_by_address(pv.address())
    votes = []
    for tag in (b"a", b"b"):
        h = hashlib.sha256(b"conflict-" + tag).digest()
        bid = RefBlockID(h, RefPSH(1, hashlib.sha256(h).digest()))
        vote = RefVote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                       timestamp=GENESIS_TIME, validator_address=val.address,
                       validator_index=idx)
        votes.append(pv.sign_vote(CHAIN_ID, vote))
    return RefDupEvidence.new(votes[0], votes[1], state.last_block_time, state.last_validators)


# -- nodes that sync ---------------------------------------------------------


@dataclass
class Node:
    state: object
    executor: object
    block_store: object
    state_store: object
    db: object
    mempool: object
    evpool: EvidencePool


def ref_node(chain: RefChain) -> Node:
    state = ref_genesis_state(chain.gen)
    conns = RefAppConns(ref_local_creator(RefApp()))
    conns.start()
    mempool = RefMempool(ref_test_config().mempool, conns.mempool)
    db = RefMemDB()
    ss, bs = RefStateStore(db), RefBlockStore(db)
    ss.save(state)
    evpool = EvidencePool()
    return Node(state, RefExecutor(ss, conns.consensus, mempool, evpool, bs), bs, ss, db,
                mempool, evpool)


def port_node(chain: RefChain) -> Node:
    gen = GenesisDoc.from_json(chain.gen_json)
    state = make_genesis_state(gen)
    conns = AppConns(local_client_creator(PersistentKVStoreApplication()))
    conns.start()
    mempool = CListMempool(MempoolConfig(), conns.mempool)
    db = MemDB()
    ss, bs = StateStore(db), BlockStore(db)
    ss.save(state)
    evpool = EvidencePool()
    return Node(state, BlockExecutor(ss, conns.consensus, mempool, evpool, bs), bs, ss, db,
                mempool, evpool)


class Peer:
    """A peer double that serves a chain: a block request is answered at
    once, through the syncing reactor's ``receive``, by the reference's
    encoding of the stored block (``corrupt`` maps a height to other block
    bytes to serve instead)."""

    def __init__(self, peer_id: str, chain: RefChain, corrupt=None):
        self.id = peer_id
        self.chain = chain
        self.corrupt = dict(corrupt or {})
        self.reactor = None
        self.served: list[int] = []
        self.stopped = False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if self.stopped:
            return False
        kind, payload = ref_reactor.decode_message(msg)
        if kind == "block_request":
            self.served.append(payload)
            if payload in self.corrupt:
                reply = self.corrupt[payload]
            else:
                block = self.chain.blocks[payload - 1] if payload <= len(self.chain.blocks) else None
                reply = (ref_reactor.encode_block_response(block) if block is not None
                         else ref_reactor.encode_no_block_response(payload))
            self.reactor.receive(chan_id, self, reply)
        elif kind == "status_request":
            self.reactor.receive(chan_id, self, ref_reactor.encode_status_response(
                len(self.chain.blocks), 1))
        return True


class Switch:
    """A switch double: peers by id, and the peers it stopped."""

    def __init__(self):
        self.peers: dict = {}
        self.stops: list[tuple[str, str]] = []
        self.reactor = None

    def get_peer(self, peer_id):
        return self.peers.get(peer_id)

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        for p in list(self.peers.values()):
            p.try_send(chan_id, msg)

    def stop_peer_for_error(self, peer, reason) -> None:
        self.stops.append((peer.id, str(reason)))
        peer.stopped = True
        self.peers.pop(peer.id, None)
        self.reactor.remove_peer(peer, reason)


def sync(reactor_cls, node: Node, peers, max_rounds: int = 200):
    """Sync ``node`` from ``peers`` through a reactor of ``reactor_cls``,
    driven on this thread (make the requests, try sync steps until none
    applies) until it is caught up. Returns (reactor, switch, heights
    applied in order)."""
    reactor = reactor_cls(state=node.state, block_exec=node.executor,
                          block_store=node.block_store, block_sync=True)
    switch = Switch()
    switch.reactor = reactor
    reactor.set_switch(switch)
    for p in peers:
        p.reactor = reactor
        switch.peers[p.id] = p
        reactor.add_peer(p)
    applied = []
    for _ in range(max_rounds):
        reactor.pool.make_requests()
        progressed = False
        while True:
            h = reactor.pool.height
            if not reactor._try_sync_one():
                break
            applied.append(h)
            progressed = True
        if reactor.pool.height >= reactor.pool.max_peer_height and not progressed:
            break
    job = reactor._pf_job
    if job is not None:
        job[0].wait(timeout=60.0)
    return reactor, switch, applied


REACTORS = {"ref": ref_reactor.BlocksyncReactor, "port": port_reactor.BlocksyncReactor}
