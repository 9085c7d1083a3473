"""Evidence in the port (``evidence/verify.py``, ``pool.py``, ``reactor.py``)
against the JAX package's, on a chain that package's executor built
(``tests/torch_chains.py``: 4 validators, 6 heights) and its stores carried
across byte for byte: ``verify_evidence`` accepts or rejects each case with
the same exception type and text (a valid duplicate vote, each rejection
of ``verify_duplicate_vote``, light-client attacks of both kinds, evidence
too old); the pool's lifecycle (test_evidence_pool.py) leaves the same
database items; a light-client attack found by each package's detector
reaches a pool over a node's stores and the next block through the
``BlockExecutor``, the block byte for byte the reference's; the reactor
gossips the same bytes. The duplicate-vote signatures go through each
package's ``crypto/sigbatch``. Both packages verify on their
``CpuBackend``."""

import dataclasses
import threading

import pytest
import torch
import torch_chains as tc
import torch_light_chains as lc

from cometbft_tpu.crypto import sigbatch as ref_sigbatch
from cometbft_tpu.evidence import pool as ref_pool_mod
from cometbft_tpu.evidence import reactor as ref_reactor_mod
from cometbft_tpu.evidence import verify as ref_verify
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.light import detector as ref_detector
from cometbft_tpu.light import provider as ref_provider
from cometbft_tpu.types import block as rb
from cometbft_tpu.types.evidence import DuplicateVoteEvidence as RefDup
from cometbft_tpu.types.evidence import encode_evidence as ref_encode_evidence
from cometbft_tpu.types.light_block import LightBlock as RefLightBlock
from cometbft_tpu.types.vote import Vote as RefVote
from cometbft_tpu.types.vote import vote_to_commit_sig as ref_vote_to_commit_sig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import sigbatch
from cometbft_tpu_torch.evidence import pool as pool_mod
from cometbft_tpu_torch.evidence import reactor as reactor_mod
from cometbft_tpu_torch.evidence import verify
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light import provider
from cometbft_tpu_torch.p2p.reactor import EVIDENCE_CHANNEL
from cometbft_tpu_torch.state.store import _decode_state
from cometbft_tpu_torch.types import BlockID, Commit
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.evidence import encode_evidence

pytestmark = pytest.mark.torch_port

N_BLOCKS = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"evidence", n_vals=4, n_blocks=N_BLOCKS)


@pytest.fixture
def pair():
    """Both packages' recording host backends, and fresh sigbatch singletons."""
    with lc.Pair() as be:
        old = (sigbatch.set_batcher(None), ref_sigbatch.set_batcher(None))
        yield be
        sigbatch.set_batcher(old[0])
        ref_sigbatch.set_batcher(old[1])


def _stores(chain, pkg):
    """(state, state store, block store) of the chain's node."""
    if pkg == "ref":
        return chain.states[-1], chain.state_store, chain.block_store
    bs, ss = convert.stores_from_items(chain.db_items)
    return _decode_state(dict(chain.db_items)[b"stateKey"]), ss, bs


def _port_ev(ev):
    return convert.evidence_from_wire(ref_encode_evidence(ev))


def _dup_votes(chain, height=2, signer=0, other=None, mutate=None):
    """Two precommits of validator ``signer`` at ``height`` for different
    blocks (``other``: the second from that validator instead), signed in
    the reference, as DuplicateVoteEvidence; ``mutate`` edits the
    evidence's fields."""
    vals = chain.state_store.load_validators(height)
    pv_by_addr = {pv.address(): pv for pv in chain.pvs}
    t = chain.block_store.load_block_meta(height).header.time
    votes = []
    for k, mark in enumerate((b"\xaa", b"\xbb")):
        addr = vals.validators[other if (k and other is not None) else signer].address
        idx, _ = vals.get_by_address(addr)
        v = RefVote(type=rb.PRECOMMIT_TYPE, height=height, round=0,
                    block_id=rb.BlockID(mark * 32, rb.PartSetHeader(1, mark * 32)),
                    timestamp=t, validator_address=addr, validator_index=idx)
        votes.append(pv_by_addr[addr].sign_vote(tc.CHAIN_ID, v))
    ev = RefDup(vote_a=votes[0], vote_b=votes[1], total_voting_power=vals.total_voting_power(),
                validator_power=vals.validators[signer].voting_power, timestamp=t)
    if mutate is not None:
        ev = mutate(ev)
    return ev


def _forged(chain, height: int, app_hash: bytes = b"\xee" * 32) -> RefLightBlock:
    """The header at ``height`` with another app hash, signed by the same
    validators: a light-client attack's conflicting block."""
    meta = chain.block_store.load_block_meta(height)
    vals = chain.state_store.load_validators(height)
    header = dataclasses.replace(meta.header, app_hash=app_hash)
    bid = rb.BlockID(header.hash(), rb.PartSetHeader(1, b"\x05" * 32))
    pv_by_addr = {pv.address(): pv for pv in chain.pvs}
    sigs = []
    for idx, val in enumerate(vals.validators):
        vote = RefVote(type=rb.PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                       timestamp=header.time.add_nanos(10**9), validator_address=val.address,
                       validator_index=idx)
        sigs.append(ref_vote_to_commit_sig(pv_by_addr[val.address].sign_vote(tc.CHAIN_ID, vote)))
    return RefLightBlock(rb.SignedHeader(header, rb.Commit(height=height, round=0, block_id=bid,
                                                           signatures=sigs)), vals)


def _attack(chain, conflicting_h: int, common_h: int, app_hash=b"\xee" * 32):
    common = ref_provider.BlockStoreProvider(tc.CHAIN_ID, chain.block_store,
                                             chain.state_store).light_block(common_h)
    return ref_detector.make_attack_evidence(_forged(chain, conflicting_h, app_hash), common)


def _flip_sig(ev):
    sig = bytearray(ev.vote_b.signature)
    sig[7] ^= 0x10
    return dataclasses.replace(ev, vote_b=dataclasses.replace(ev.vote_b, signature=bytes(sig)))


def _too_old(state):
    params = state.consensus_params
    tight = dataclasses.replace(params, evidence=dataclasses.replace(
        params.evidence, max_age_num_blocks=1, max_age_duration_ns=10**9))
    return dataclasses.replace(state, consensus_params=tight,
                               last_block_time=state.last_block_time.add_nanos(3600 * 10**9))


EVIDENCE_CASES = {
    # name: (evidence from the chain, state edit, outcome type)
    "duplicate_vote": (lambda c: _dup_votes(c), None, None),
    "not_a_validator": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, vote_a=dataclasses.replace(ev.vote_a, validator_address=b"\x42" * 20))),
        None, "ValueError"),
    "different_round": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, vote_b=dataclasses.replace(ev.vote_b, round=1))), None, "ValueError"),
    "different_validators": (lambda c: _dup_votes(c, other=1), None, "ValueError"),
    "same_block": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, vote_b=dataclasses.replace(ev.vote_b, block_id=ev.vote_a.block_id))),
        None, "ValueError"),
    "wrong_validator_power": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, validator_power=99)), None, "ValueError"),
    "wrong_total_power": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, total_voting_power=99)), None, "ValueError"),
    "invalid_signature": (lambda c: _dup_votes(c, mutate=_flip_sig), None, "VoteError"),
    "other_time": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, timestamp=ev.timestamp.add_nanos(1))), None, "ValueError"),
    "missing_block": (lambda c: _dup_votes(c, mutate=lambda ev: dataclasses.replace(
        ev, vote_a=dataclasses.replace(ev.vote_a, height=N_BLOCKS + 5))), None, "ValueError"),
    "too_old": (lambda c: _dup_votes(c), _too_old, "ValueError"),
    "lunatic_attack": (lambda c: _attack(c, 5, 3), None, None),
    "equivocation_attack": (lambda c: _attack(c, 4, 4), None, None),
    "no_conflict": (lambda c: _attack(c, 4, 4, c.block_store.load_block_meta(4).header.app_hash),
                    None, "ValueError"),
    "attack_other_time": (lambda c: dataclasses.replace(
        _attack(c, 5, 3), timestamp=c.block_store.load_block_meta(4).header.time),
        None, "ValueError"),
}


@pytest.mark.parametrize("name", list(EVIDENCE_CASES))
def test_verify_evidence_agrees_with_the_reference(chain, pair, name):
    make, edit, want = EVIDENCE_CASES[name]
    ev = make(chain)
    out = {}
    for pkg, mod, e in (("ref", ref_verify, ev), ("port", verify, _port_ev(ev))):
        state, ss, bs = _stores(chain, pkg)
        if edit is not None:
            state = edit(state)
        out[pkg] = lc.outcome(lambda: mod.verify_evidence(e, state, ss, bs))
    assert out["port"] == out["ref"]
    assert (None if out["ref"] is None else out["ref"][0]) == want
    assert pair.port.batches == pair.ref.batches
    assert sigbatch.counters()["fallbacks"] == 0


# -- the pool -------------------------------------------------------------------


def _pools(chain):
    out = {}
    for pkg, mod, db in (("ref", ref_pool_mod, RefMemDB()), ("port", pool_mod, MemDB())):
        state, ss, bs = _stores(chain, pkg)
        out[pkg] = (state, mod.EvidencePool(db, ss, bs), db)
    return out


def _items(db):
    return [(bytes(k), bytes(v)) for k, v in db.iterator()]


def _lifecycle(chain, steps):
    """Run steps(pkg, state, pool, evidence) on both packages' pools; the
    pools' database items and stats must be equal after each step."""
    pools = _pools(chain)
    results = {}
    for pkg, (state, pool, db) in pools.items():
        ev = _dup_votes(chain)
        ev = ev if pkg == "ref" else _port_ev(ev)
        results[pkg] = []
        for step in steps:
            results[pkg].append((lc.outcome(lambda: step(state, pool, ev)), _items(db),
                                 pool.stats_snapshot()))
    assert results["port"] == results["ref"]
    return results["port"]


def _later(state, **kw):
    return dataclasses.replace(state, last_block_height=state.last_block_height + 1,
                               last_block_time=state.last_block_time.add_nanos(10**9), **kw)


def test_pool_add_pending_commit_lifecycle(chain, pair):
    steps = [
        lambda s, p, ev: p.add_evidence(ev),
        lambda s, p, ev: p.add_evidence(ev),  # a re-add is a no-op
        lambda s, p, ev: p.update(_later(s), [ev]),
        lambda s, p, ev: p.check_evidence([ev]),  # already committed
    ]
    results = _lifecycle(chain, steps)
    assert results[0][0] is None and results[0][2]["pending"] == 1
    assert results[2][2]["committed_total"] == 1 and results[2][2]["pending"] == 0
    assert results[3][0] == ("ValueError", "evidence was already committed")


def test_pool_prunes_expired_evidence(chain, pair):
    def expire(s, p, ev):
        params = s.consensus_params
        tight = dataclasses.replace(params, evidence=dataclasses.replace(
            params.evidence, max_age_num_blocks=2, max_age_duration_ns=10**9))
        p.update(dataclasses.replace(s, last_block_height=s.last_block_height + 3,
                                     last_block_time=ev.time().add_nanos(2 * 10**9),
                                     consensus_params=tight), [])

    results = _lifecycle(chain, [lambda s, p, ev: p.add_evidence(ev), expire])
    assert results[1][2]["pending"] == 0 and results[1][2]["expired_total"] == 1


def test_pool_keeps_evidence_until_both_bounds_pass(chain, pair):
    def young(s, p, ev):
        params = s.consensus_params
        tight = dataclasses.replace(params, evidence=dataclasses.replace(
            params.evidence, max_age_num_blocks=2, max_age_duration_ns=10**12))
        p.update(dataclasses.replace(s, last_block_height=s.last_block_height + 3,
                                     last_block_time=ev.time().add_nanos(10**9),
                                     consensus_params=tight), [])

    results = _lifecycle(chain, [lambda s, p, ev: p.add_evidence(ev), young])
    assert results[1][2]["pending"] == 1


def test_pool_turns_conflicting_votes_into_evidence(chain, pair):
    """report_conflicting_votes, then update: the same evidence key and
    bytes in both pools; a pair it cannot use is dropped, and counted."""
    ev = _dup_votes(chain)
    out = {}
    for pkg, (state, pool, db) in _pools(chain).items():
        e = ev if pkg == "ref" else _port_ev(ev)
        pool.report_conflicting_votes(e.vote_a, e.vote_b)
        pool.report_conflicting_votes(e.vote_a, None)  # not a vote pair
        pool.update(_later(state), [])
        out[pkg] = (_items(db), pool.stats_snapshot())
        if pkg == "port":
            assert pool.consensus_buffer_errors == 1
            assert pool.last_consensus_buffer_error is not None
    assert out["port"] == out["ref"] and out["ref"][1]["added_total"] == 1


# -- a light-client attack, from the detector to a committed block ---------------


def _replay(chain, pkg):
    """A node of the package that applied the chain's blocks (its own
    executor, kvstore app and mempool), ready to propose the next height."""
    node = tc.ref_node(chain) if pkg == "ref" else tc.port_node(chain)
    state = node.state
    for h in range(1, N_BLOCKS + 1):
        ref_block = chain.blocks[h - 1]
        block = ref_block if pkg == "ref" else Block.decode(ref_block.encode())
        parts = block.make_part_set()
        bid = (rb.BlockID if pkg == "ref" else BlockID)(block.hash(), parts.header())
        seen = chain.seen[h - 1] if pkg == "ref" else Commit.decode(chain.seen[h - 1].encode())
        node.block_store.save_block(block, parts, seen)
        state, _ = node.executor.apply_block(state, bid, block)
    node.state = state
    return node


class _ForkingWitness:
    """Serves the primary's chain, but at ``fork`` the reference-signed
    conflicting block (decoded into the package's types)."""

    def __init__(self, primary, forged, decode):
        self.primary = primary
        self.forged = decode(forged.encode())
        self.evidences = []

    def chain_id(self):
        return tc.CHAIN_ID

    def light_block(self, height):
        if height == self.forged.height:
            return self.forged
        return self.primary.light_block(height)

    def report_evidence(self, ev):
        self.evidences.append(ev)


def test_attack_reaches_the_next_block(chain, pair):
    """test_light_attack_e2e without the network: each package's client
    trusts height 1 of its node (BlockStoreProvider over the node's stores),
    a witness serves a conflicting tip signed by the same validators; the
    detector raises ErrLightClientAttack and reports to an EvidencePool over
    the node's stores; the node's executor proposes the next block with the
    evidence, applies it, and the pool marks it committed. The evidence and
    the block are byte for byte the reference's."""
    from cometbft_tpu.evidence.pool import EvidencePool as RefPool
    from cometbft_tpu.light.client import Client as RefClient
    from cometbft_tpu.light.client import TrustOptions as RefTrust
    from cometbft_tpu.light.store import LightStore as RefStore
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.types.light_block import LightBlock

    forged = _forged(chain, N_BLOCKS)
    out = {}
    for pkg in ("ref", "port"):
        node = _replay(chain, pkg)
        pool_cls, prov_mod = (RefPool, ref_provider) if pkg == "ref" else (EvidencePool, provider)
        pool = pool_cls(RefMemDB() if pkg == "ref" else MemDB(), node.state_store, node.block_store)

        class Primary(prov_mod.BlockStoreProvider):
            def report_evidence(self, ev):
                pool.add_evidence(ev)

        primary = Primary(tc.CHAIN_ID, node.block_store, node.state_store)
        witness = _ForkingWitness(primary, forged,
                                  RefLightBlock.decode if pkg == "ref" else LightBlock.decode)
        client_cls, trust_cls, store = ((RefClient, RefTrust, RefStore(RefMemDB())) if pkg == "ref"
                                        else (Client, TrustOptions, LightStore(MemDB())))
        lb1 = primary.light_block(1)
        client = client_cls(tc.CHAIN_ID, trust_cls(3600 * 10**9, 1, lb1.hash()), primary,
                            [witness], store)
        now = node.state.last_block_time.add_nanos(10 * 10**9)
        attack = lc.outcome(lambda: client.verify_light_block_at_height(N_BLOCKS, now))
        enc = ref_encode_evidence if pkg == "ref" else encode_evidence
        pending = [enc(e) for e in pool.pending_evidence(-1)[0]]
        node.executor.evpool = pool
        state = node.state
        proposer = state.validators.get_proposer().address
        block = node.executor.create_proposal_block(N_BLOCKS + 1, state, chain.seen[-1] if pkg
                                                    == "ref" else Commit.decode(
                                                        chain.seen[-1].encode()), proposer)
        parts = block.make_part_set()
        bid = (rb.BlockID if pkg == "ref" else BlockID)(block.hash(), parts.header())
        node.block_store.save_block(block, parts, chain.seen[-1] if pkg == "ref"
                                    else Commit.decode(chain.seen[-1].encode()))
        state, _ = node.executor.apply_block(state, bid, block)
        stored = node.block_store.load_block(N_BLOCKS + 1)
        out[pkg] = {
            "attack": attack, "pending": pending, "to_witness": [enc(e) for e in witness.evidences],
            "block": block.encode(), "stored_evidence": [enc(e) for e in stored.evidence],
            "committed": [pool._is_committed(e) for e in stored.evidence],
            "after": pool.stats_snapshot(), "state_height": state.last_block_height,
        }
        if pkg == "port":
            assert client.detector_errors == 0 and client.speculation["errors"] == 0
    assert out["port"] == out["ref"]
    ref = out["ref"]
    assert ref["attack"][0] == "ErrLightClientAttack"
    assert len(ref["pending"]) == 1 and ref["stored_evidence"] == ref["pending"]
    assert ref["committed"] == [True] and ref["after"]["pending"] == 0


# -- the reactor ----------------------------------------------------------------


class _Peer:
    def __init__(self):
        self.id = "peer-1"
        self.sent: list = []
        self.event = threading.Event()

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, msg))
        self.event.set()
        return True


def test_reactor_gossips_the_same_bytes(chain, pair):
    """A pool with pending evidence: each package's reactor sends its peer
    the same evidence-list message on channel 0x38; a peer's message puts
    the evidence into an empty pool, and one the pool refuses is dropped,
    and counted."""
    ev = _dup_votes(chain)
    sent = {}
    for pkg, mod in (("ref", ref_reactor_mod), ("port", reactor_mod)):
        state, pool, db = _pools(chain)[pkg]
        pool.add_evidence(ev if pkg == "ref" else _port_ev(ev))
        reactor = mod.EvidenceReactor(pool)
        reactor.start()
        peer = _Peer()
        reactor.add_peer(peer)
        assert peer.event.wait(10.0)
        reactor.stop()
        reactor.remove_peer(peer, "done")
        sent[pkg] = peer.sent[0]
        assert [c.id for c in reactor.get_channels()] == [EVIDENCE_CHANNEL]
    assert sent["port"] == sent["ref"] and sent["port"][0] == EVIDENCE_CHANNEL
    _, fresh, fresh_db = _pools(chain)["port"]
    reactor = reactor_mod.EvidenceReactor(fresh)
    reactor.receive(EVIDENCE_CHANNEL, _Peer(), sent["port"][1])
    assert fresh.stats_snapshot()["pending"] == 1 and reactor.receive_errors == 0
    bad = reactor_mod.encode_evidence_list_msg([_port_ev(_dup_votes(chain, signer=2,
                                                                    mutate=_flip_sig))])
    reactor.receive(EVIDENCE_CHANNEL, _Peer(), bad)
    assert reactor.receive_errors == 1 and "invalid signature" in str(reactor.last_receive_error)
    assert fresh.stats_snapshot()["pending"] == 1


def test_convert_round_trips(chain):
    """convert.evidence_from_wire and light_block_from_wire: the port's
    objects from the reference's bytes encode back to the same bytes and
    hash the same."""
    for ev in (_dup_votes(chain), _attack(chain, 5, 3), _attack(chain, 4, 4)):
        port = convert.evidence_from_wire(ref_encode_evidence(ev))
        assert encode_evidence(port) == ref_encode_evidence(ev)
        assert port.hash() == ev.hash() and port.height() == ev.height()
    lb = _forged(chain, 3)
    port_lb = convert.light_block_from_wire(lb.encode())
    assert port_lb.encode() == lb.encode() and port_lb.hash() == lb.hash()
    port_lb.validate_basic(tc.CHAIN_ID)
