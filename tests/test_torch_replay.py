"""The Handshaker in the port (``consensus/replay.py``) against the JAX
package: the five height cases of ``tests/test_replay.py`` (a synced
restart, the app wiped, a crash after ``save_block``, a crash after the
app's Commit, an app ahead of the store) run in both packages on the same
chain (4 validators from fixed secrets, 3 blocks of one kvstore
transaction), with equal states (their stored bytes), app hashes, replayed
block counts and error texts; and the two packages' stores carried across
(``convert.stores_from_items``). No tolerance."""

from types import SimpleNamespace

import pytest

import cometbft_tpu.abci.example.kvstore as ref_kvstore
import cometbft_tpu.config as ref_config
import cometbft_tpu.consensus.replay as ref_replay
import cometbft_tpu.crypto.ed25519 as ref_ed
import cometbft_tpu.libs.db as ref_db
import cometbft_tpu.mempool as ref_mempool
import cometbft_tpu.proxy as ref_proxy
import cometbft_tpu.sidecar.backend as ref_backend
import cometbft_tpu.state as ref_state
import cometbft_tpu.state.store as ref_state_store
import cometbft_tpu.store as ref_store
import cometbft_tpu.types as ref_types
import cometbft_tpu.types.block as ref_block
import cometbft_tpu.types.genesis as ref_genesis
import cometbft_tpu.types.priv_validator as ref_pv
import cometbft_tpu.types.vote as ref_vote
import cometbft_tpu_torch.abci.example.kvstore as kvstore
import cometbft_tpu_torch.config as config
import cometbft_tpu_torch.consensus.replay as replay
import cometbft_tpu_torch.crypto.ed25519 as ed
import cometbft_tpu_torch.libs.db as db
import cometbft_tpu_torch.mempool as mempool
import cometbft_tpu_torch.proxy as proxy
import cometbft_tpu_torch.sidecar.backend as backend
import cometbft_tpu_torch.state as state
import cometbft_tpu_torch.state.store as state_store
import cometbft_tpu_torch.store as store
import cometbft_tpu_torch.types as types
import cometbft_tpu_torch.types.block as block_mod
import cometbft_tpu_torch.types.genesis as genesis
import cometbft_tpu_torch.types.priv_validator as pv_mod
import cometbft_tpu_torch.types.vote as vote_mod
from cometbft_tpu_torch import convert

pytestmark = pytest.mark.torch_port

CHAIN_ID = "replay-test-chain"
NUM_BLOCKS = 3

REF = SimpleNamespace(kv=ref_kvstore, config=ref_config, replay=ref_replay, ed=ref_ed,
                      db=ref_db, mempool=ref_mempool, proxy=ref_proxy, state=ref_state,
                      state_store=ref_state_store, store=ref_store, types=ref_types,
                      block=ref_block, genesis=ref_genesis, pv=ref_pv, vote=ref_vote)
PORT = SimpleNamespace(kv=kvstore, config=config, replay=replay, ed=ed, db=db, mempool=mempool,
                       proxy=proxy, state=state, state_store=state_store, store=store,
                       types=types, block=block_mod, genesis=genesis, pv=pv_mod, vote=vote_mod)


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
        ed._verified.clear()


class Chain:
    """``tests/test_replay.py``'s chain in package ``p``: NUM_BLOCKS heights
    whose stores survive restarts; the validators' keys come from fixed
    secrets, so both packages build the same blocks."""

    def __init__(self, p):
        self.p = p
        pvs = [p.pv.MockPV(p.ed.gen_priv_key_from_secret(b"replay-%d" % i)) for i in range(4)]
        self.gen = p.genesis.GenesisDoc(
            chain_id=CHAIN_ID,
            genesis_time=p.types.Time(1700000000, 0),
            validators=[p.genesis.GenesisValidator(address=pv.address(), pub_key=pv.get_pub_key(),
                                                   power=10, name=f"v{i}")
                        for i, pv in enumerate(pvs)],
        )
        self.gen.validate_and_complete()
        self.pv_by_addr = {pv.address(): pv for pv in pvs}
        self.app_db = p.db.MemDB()
        self.db = p.db.MemDB()
        self.state_store = p.state.StateStore(self.db)
        self.block_store = p.store.BlockStore(self.db)
        st = p.state.make_genesis_state(self.gen)
        self.state_store.save(st)
        conns = self.fresh_conns()
        self.mempool = p.mempool.CListMempool(p.config.MempoolConfig(), conns.mempool)
        self.executor = p.state.BlockExecutor(self.state_store, conns.consensus, self.mempool,
                                              None, self.block_store)
        last_commit = p.types.Commit(height=0, round=0)
        for h in range(1, NUM_BLOCKS + 1):
            self.mempool.check_tx(b"key%d=value%d" % (h, h))
            blk, block_id, seen = self.make_next(st, last_commit)
            self.block_store.save_block(blk, blk.make_part_set(), seen)
            st, _ = self.executor.apply_block(st, block_id, blk)
            last_commit = seen
        self.state = st
        self.last_commit = last_commit

    def fresh_conns(self):
        conns = self.p.proxy.AppConns(self.p.proxy.local_client_creator(
            self.p.kv.KVStoreApplication(db=self.app_db)))
        conns.start()
        return conns

    def wiped_conns(self):
        self.app_db = self.p.db.MemDB()
        return self.fresh_conns()

    def make_next(self, st, last_commit):
        p = self.p
        height = st.last_block_height + 1
        blk = self.executor.create_proposal_block(height, st, last_commit,
                                                  st.validators.get_proposer().address)
        if height == 1:
            blk.last_commit = p.types.Commit(height=0, round=0)
        block_id = p.types.BlockID(blk.hash(), blk.make_part_set().header())
        sigs = []
        for idx, val in enumerate(st.validators.validators):
            vote = p.types.Vote(type=p.block.PRECOMMIT_TYPE, height=height, round=0,
                                block_id=block_id,
                                timestamp=blk.header.time.add_nanos(10**9 * (idx + 1)),
                                validator_address=val.address, validator_index=idx)
            sigs.append(p.vote.vote_to_commit_sig(
                self.pv_by_addr[val.address].sign_vote(CHAIN_ID, vote)))
        seen = p.types.Commit(height=height, round=0, block_id=block_id, signatures=sigs)
        return blk, block_id, seen

    def handshake(self, conns):
        h = self.p.replay.Handshaker(self.state_store, self.state_store.load(),
                                     self.block_store, self.gen)
        return h.handshake(conns), h


def _app(conns):
    return conns.query._app


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return (type(e).__name__, str(e))


def _case(name, c: Chain):
    """One of ``tests/test_replay.py``'s cases on chain ``c``; what it gives."""
    p = c.p
    if name == "synced":
        conns = c.fresh_conns()
        st, h = c.handshake(conns)
        return st, h.n_blocks, _app(conns)
    if name == "wiped":
        conns = c.wiped_conns()
        st, h = c.handshake(conns)
        return st, h.n_blocks, _app(conns)
    if name == "after_save_block":
        blk, block_id, seen = c.make_next(c.state, c.last_commit)
        c.block_store.save_block(blk, blk.make_part_set(), seen)
        conns = c.fresh_conns()
        st, h = c.handshake(conns)
        st2, h2 = c.handshake(c.fresh_conns())  # the state was saved: a no-op
        assert (st2.last_block_height, h2.n_blocks) == (NUM_BLOCKS + 1, 0)
        return st, h.n_blocks, _app(conns)
    if name == "after_app_commit":
        pre = c.state_store.load()
        c.mempool.check_tx(b"crash=tx")
        blk, block_id, seen = c.make_next(c.state, c.last_commit)
        c.block_store.save_block(blk, blk.make_part_set(), seen)
        new_state, _ = c.executor.apply_block(c.state, block_id, blk)
        c.state_store.save(pre)
        conns = c.fresh_conns()
        size = _app(conns).size
        st, h = c.handshake(conns)
        assert _app(conns).size == size  # the mock replay executed nothing
        assert st.app_hash == new_state.app_hash
        return st, h.n_blocks, _app(conns)
    assert name == "app_ahead"
    conns = c.fresh_conns()
    _app(conns).height = NUM_BLOCKS + 5
    return _outcome(lambda: c.handshake(conns))


@pytest.mark.parametrize("name", ["synced", "wiped", "after_save_block", "after_app_commit",
                                  "app_ahead"])
def test_handshake_cases_match_the_reference(name):
    port, ref = _case(name, Chain(PORT)), _case(name, Chain(REF))
    if name == "app_ahead":
        assert port[0] == ref[0] == "AppHeightError"
        assert port[1] == ref[1] and "higher than core" in port[1]
        return
    (st, n, app), (ref_st, ref_n, ref_app) = port, ref
    assert state_store._encode_state(st) == ref_state_store._encode_state(ref_st)
    assert n == ref_n
    assert (app.height, app.size, app.app_hash) == (ref_app.height, ref_app.size, ref_app.app_hash)
    assert st.app_hash == app.app_hash


def test_wrong_app_hash_raises_the_reference_text():
    """An app whose state differs from the chain's: AppHashMismatchError with
    the reference's text."""
    texts = []
    for p in (PORT, REF):
        c = Chain(p)
        conns = c.fresh_conns()
        _app(conns).app_hash = b"\x07" * 8
        texts.append(_outcome(lambda: c.handshake(conns)))
    assert texts[0] == texts[1] and texts[0][0] == "AppHashMismatchError"
    assert "Did you reset CometBFT without resetting the application?" in texts[0][1]


def test_port_handshakes_the_reference_stores():
    """The port's Handshaker over the reference chain's stores (their DB items
    carried across), the app wiped and the block after ``save_block`` alone:
    the reference's resulting state."""
    ref = Chain(REF)
    blk, block_id, seen = ref.make_next(ref.state, ref.last_commit)
    ref.block_store.save_block(blk, blk.make_part_set(), seen)
    bs, ss = convert.stores_from_items(list(ref.db.iterator()))
    gen = genesis.GenesisDoc.from_json(ref.gen.to_json())
    conns = proxy.AppConns(proxy.local_client_creator(kvstore.KVStoreApplication()))
    conns.start()
    h = replay.Handshaker(ss, ss.load(), bs, gen)
    st = h.handshake(conns)
    ref_conns = ref.wiped_conns()
    ref_st, ref_h = ref.handshake(ref_conns)
    assert state_store._encode_state(st) == ref_state_store._encode_state(ref_st)
    assert h.n_blocks == ref_h.n_blocks == NUM_BLOCKS + 1
    assert _app(conns).app_hash == _app(ref_conns).app_hash
