"""The application path in the port (the local ABCI client, the kvstore
applications, ``CListMempool``, ``BlockExecutor``) against the JAX package.
The port's executor applies the blocks that package's executor built (4
validators, one promoted at height 3, a duplicate-vote evidence at height 6)
and at every height gives its app hash, ``LastResultsHash``, validator sets
and stored ABCI responses; a chain the port builds itself, through its own
mempool and ``create_proposal_block``, with its own ``MockPV`` signing, is
the reference's chain byte for byte. No tolerance."""

import base64

import pytest
import torch_chains as tc

from cometbft_tpu.abci import types as ref_abci
from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
from cometbft_tpu.config import test_config as ref_test_config
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.mempool import CListMempool as RefMempool
from cometbft_tpu.proxy import AppConns as RefAppConns
from cometbft_tpu.proxy import local_client_creator as ref_local_creator
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.state import store as ref_store
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import MempoolConfig
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.mempool import clist_mempool
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.state import BlockExecutor
from cometbft_tpu_torch.state import store as port_store
from cometbft_tpu_torch.types import BlockID, Commit, Vote
from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.vote import vote_to_commit_sig

pytestmark = pytest.mark.torch_port

N_BLOCKS = 8


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"abci", n_vals=4, n_blocks=N_BLOCKS, promote_at=3, evidence_at=6)


@pytest.fixture(autouse=True)
def backends():
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


def test_executor_applies_the_reference_blocks(chain):
    node = tc.port_node(chain)
    state = node.state
    for h in range(1, N_BLOCKS + 1):
        block = convert.block_from_wire(chain.blocks[h - 1].encode())
        parts = block.make_part_set()
        state, retain = node.executor.apply_block(state, BlockID(block.hash(), parts.header()), block)
        ref = chain.states[h]
        assert state.app_hash == ref.app_hash
        assert state.last_results_hash == ref.last_results_hash
        assert state.validators.hash() == ref.validators.hash()
        assert state.next_validators.hash() == ref.next_validators.hash()
        assert port_store._encode_state(state) == ref_store._encode_state(ref)
        assert node.state_store.load_abci_responses(h) == chain.state_store.load_abci_responses(h)
        assert retain == 0
    updates = [node.state_store.load_abci_responses(h)["end_block"]["validator_updates"]
               for h in range(1, N_BLOCKS + 1)]
    assert [len(u) for u in updates] == [0, 0, 1, 0, 0, 0, 0, 0]
    assert updates[2][0]["power"] == 15
    assert state.validators.size() == 5
    assert node.evpool.checked == [0, 0, 0, 0, 0, 1, 0, 0]


def test_port_builds_the_reference_chain(chain):
    """Proposals from the port's mempool and executor, signed by the port's
    MockPV over the same seeds, are the reference's blocks and commits."""
    node = tc.port_node(chain)
    state = node.state
    pvs = {pv.address(): MockPV(ed25519.PrivKey(pv.priv_key.bytes())) for pv in chain.pvs}
    if chain.new_pv is not None:
        pvs[chain.new_pv.address()] = MockPV(ed25519.PrivKey(chain.new_pv.priv_key.bytes()))
    last_commit = Commit(height=0, round=0)
    for h in range(1, N_BLOCKS + 1):
        ref_block = chain.blocks[h - 1]
        for tx in ref_block.data.txs:
            node.mempool.check_tx(tx)
        node.evpool.evidence = convert.block_from_wire(ref_block.encode()).evidence
        block = node.executor.create_proposal_block(
            h, state, last_commit, state.validators.get_proposer().address)
        assert block.encode() == ref_block.encode()
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        sigs = []
        for idx, val in enumerate(state.validators.validators):
            vote = Vote(type=PRECOMMIT_TYPE, height=h, round=0, block_id=bid,
                        timestamp=block.header.time.add_nanos(10**9 * (idx + 1)),
                        validator_address=val.address, validator_index=idx)
            sigs.append(vote_to_commit_sig(pvs[val.address].sign_vote(tc.CHAIN_ID, vote)))
        commit = Commit(height=h, round=0, block_id=bid, signatures=sigs)
        assert commit.encode() == chain.seen[h - 1].encode()
        node.block_store.save_block(block, parts, commit)
        assert node.executor.process_proposal(block, state)
        state, _ = node.executor.apply_block(state, bid, block)
        assert node.mempool.size() == 0
        last_commit = commit
    assert list(node.db.iterator()) == chain.db_items


def test_mempool_matches_reference():
    """The same admissions, reaps and updates give the same answers and
    errors."""
    ref_conns = RefAppConns(ref_local_creator(RefKV()))
    ref_conns.start()
    conns = AppConns(local_client_creator(KVStoreApplication()))
    conns.start()
    cfg = ref_test_config().mempool
    cfg.size, cfg.max_tx_bytes = 6, 40
    ref_mp = RefMempool(cfg, ref_conns.mempool)
    mp = CListMempool(MempoolConfig(size=6, max_tx_bytes=40), conns.mempool)
    script = [b"a=1", b"b=2", b"a=1", b"", b"x" * 41, b"c=3", b"d=4", b"e=5", b"f=6", b"g=7"]
    for tx in script:
        outcomes = []
        for m in (ref_mp, mp):
            try:
                res = []
                m.check_tx(tx, callback=res.append)
                outcomes.append(("ok", [r.code for r in res]))
            except Exception as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1], tx
    assert mp.size() == ref_mp.size() and mp.size_bytes() == ref_mp.size_bytes()
    assert mp.reap_max_bytes_max_gas(20, -1) == ref_mp.reap_max_bytes_max_gas(20, -1)
    assert mp.reap_max_bytes_max_gas(-1, 3) == ref_mp.reap_max_bytes_max_gas(-1, 3)
    assert mp.reap_max_txs(-1) == ref_mp.reap_max_txs(-1)
    committed = [b"a=1", b"c=3"]
    for m, mod in ((ref_mp, ref_abci), (mp, abci)):
        m.lock()
        try:
            m.update(1, committed, [mod.ResponseDeliverTx(code=0)] * 2, None, None)
        finally:
            m.unlock()
    assert mp.reap_max_txs(-1) == ref_mp.reap_max_txs(-1)
    with pytest.raises(clist_mempool.ErrTxInCache):
        mp.check_tx(b"a=1")


def test_kvstore_matches_reference():
    ref_app, app = RefKV(), KVStoreApplication()
    for h in range(1, 4):
        for tx in (b"k%d=v" % h, b"raw-%d" % h, b""):
            assert app.check_tx(abci.RequestCheckTx(tx=tx)).code == \
                ref_app.check_tx(ref_abci.RequestCheckTx(tx=tx)).code
        app.begin_block(abci.RequestBeginBlock())
        ref_app.begin_block(ref_abci.RequestBeginBlock())
        for tx in (b"k%d=v" % h, b"raw-%d" % h):
            r, rr = app.deliver_tx(abci.RequestDeliverTx(tx=tx)), ref_app.deliver_tx(
                ref_abci.RequestDeliverTx(tx=tx))
            assert (r.code, [(a.key, a.value, a.index) for e in r.events for a in e.attributes]) == \
                (rr.code, [(a.key, a.value, a.index) for e in rr.events for a in e.attributes])
        assert app.commit().data == ref_app.commit().data
    q, rq = app.query(abci.RequestQuery(data=b"k2")), ref_app.query(ref_abci.RequestQuery(data=b"k2"))
    assert (q.value, q.log, q.height) == (rq.value, rq.log, rq.height)
    assert app.info(abci.RequestInfo()).last_block_app_hash == \
        ref_app.info(ref_abci.RequestInfo()).last_block_app_hash
    provable, ref_provable = KVStoreApplication(provable=True), RefKV(provable=True)
    for a, mod in ((provable, abci), (ref_provable, ref_abci)):
        a.begin_block(mod.RequestBeginBlock())
        a.deliver_tx(mod.RequestDeliverTx(tx=b"p=1"))
    assert provable.commit().data == ref_provable.commit().data
    with pytest.raises(NotImplementedError, match="proof_value"):
        provable.query(abci.RequestQuery(data=b"p", prove=True))


def test_persistent_kvstore_validator_txs():
    from cometbft_tpu.abci.example.kvstore import PersistentKVStoreApplication as RefPKV
    from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication

    app, ref_app = PersistentKVStoreApplication(), RefPKV()
    key = base64.b64encode(bytes(range(32)))
    txs = [b"val:" + key + b"!7", b"val:" + key + b"!0", b"val:" + key + b"!0", b"val:!!", b"val:xx"]
    app.begin_block(abci.RequestBeginBlock())
    ref_app.begin_block(ref_abci.RequestBeginBlock())
    for tx in txs:
        r = app.deliver_tx(abci.RequestDeliverTx(tx=tx))
        rr = ref_app.deliver_tx(ref_abci.RequestDeliverTx(tx=tx))
        assert (r.code, r.log) == (rr.code, rr.log)
    end, ref_end = app.end_block(abci.RequestEndBlock(height=1)), ref_app.end_block(
        ref_abci.RequestEndBlock(height=1))
    assert [(u.pub_key.bytes(), u.power) for u in end.validator_updates] == \
        [(u.pub_key.bytes(), u.power) for u in ref_end.validator_updates]


def test_executor_refuses_an_event_bus():
    with pytest.raises(ValueError, match="event bus is not ported"):
        BlockExecutor(None, None, None, None, event_bus=object())
