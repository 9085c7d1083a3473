"""The chain state, ``validate_block`` and the block and state stores in the
port against the JAX package, on a chain that package's executor built (4
validators, one promoted at height 3, a duplicate-vote evidence at height
6). The port starts from the same genesis, reads the states and blocks by
their bytes, and must give the same verdicts and the same exception type and
text for each header-against-state error; its stores over a reference node's
key-value items load the same blocks, commits, metas and states, and prune
them to the same items. The reference runs on its ``CpuBackend``, the port on
its own. No tolerance."""

import dataclasses

import pytest
import torch_chains as tc

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.state import state as ref_state_mod
from cometbft_tpu.state import store as ref_store
from cometbft_tpu.state.validation import validate_block as ref_validate_block
from cometbft_tpu.store import BlockStore as RefBlockStore
from cometbft_tpu.types.block import Block as RefBlock
from cometbft_tpu.types.block import BlockID as RefBlockID
from cometbft_tpu.types.block import Commit as RefCommit
from cometbft_tpu.types.block import CommitSig as RefCommitSig
from cometbft_tpu.types.block import Consensus as RefConsensus
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.state import make_genesis_state, median_time
from cometbft_tpu_torch.state import store as port_store
from cometbft_tpu_torch.state.validation import validate_block
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.genesis import GenesisDoc

pytestmark = pytest.mark.torch_port

N_BLOCKS = 8
ERR_HEIGHT = 6  # after the set change: its last commit has 5 signatures


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"state", n_vals=4, n_blocks=N_BLOCKS, promote_at=3, evidence_at=6)


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


def port_state(ref_state):
    return convert.state_from_store_bytes(ref_store._encode_state(ref_state))


def port_block(ref_block):
    return convert.block_from_wire(ref_block.encode())


def test_genesis_state_matches(chain):
    state = make_genesis_state(GenesisDoc.from_json(chain.gen_json))
    assert port_store._encode_state(state) == ref_store._encode_state(chain.states[0])
    assert state.validators.hash() == chain.states[0].validators.hash()
    assert state.next_validators.hash() == chain.states[0].next_validators.hash()
    assert state.consensus_params.hash() == chain.states[0].consensus_params.hash()
    with pytest.raises(ValueError, match="genesis doc must include non-empty chain_id"):
        make_genesis_state(dataclasses.replace(GenesisDoc.from_json(chain.gen_json), chain_id=""))


@pytest.mark.parametrize("height", range(1, N_BLOCKS + 1))
def test_validate_block_accepts_the_chain(chain, height):
    state, block = port_state(chain.states[height - 1]), port_block(chain.blocks[height - 1])
    validate_block(state, block)
    if height > 1:
        assert median_time(block.last_commit, state.last_validators) == block.header.time


def _header(**changes):
    def mutate(block: RefBlock) -> RefBlock:
        return dataclasses.replace(block, header=dataclasses.replace(block.header, **changes))

    return mutate


def _flip_last_commit_sig(block: RefBlock) -> RefBlock:
    sigs = list(block.last_commit.signatures)
    cs = sigs[1]
    bad = bytearray(cs.signature)
    bad[5] ^= 0x01
    sigs[1] = RefCommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, bytes(bad))
    commit = RefCommit(height=block.last_commit.height, round=block.last_commit.round,
                       block_id=block.last_commit.block_id, signatures=sigs)
    header = dataclasses.replace(block.header, last_commit_hash=commit.hash())
    return dataclasses.replace(block, header=header, last_commit=commit)


def _drop_last_commit_sigs(block: RefBlock) -> RefBlock:
    sigs = list(block.last_commit.signatures)
    for i in range(2, len(sigs)):
        sigs[i] = RefCommitSig.absent()
    commit = RefCommit(height=block.last_commit.height, round=block.last_commit.round,
                       block_id=block.last_commit.block_id, signatures=sigs)
    header = dataclasses.replace(block.header, last_commit_hash=commit.hash())
    return dataclasses.replace(block, header=header, last_commit=commit)


OTHER = bytes(range(32))
ERRORS = {
    "version": _header(version=RefConsensus(block=10, app=0)),
    "chain_id": _header(chain_id="another-chain"),
    "height": _header(height=ERR_HEIGHT + 1),
    "last_block_id": _header(last_block_id=RefBlockID()),
    "app_hash": _header(app_hash=OTHER),
    "consensus_hash": _header(consensus_hash=OTHER),
    "last_results_hash": _header(last_results_hash=OTHER),
    "validators_hash": _header(validators_hash=OTHER),
    "next_validators_hash": _header(next_validators_hash=OTHER),
    "proposer_not_a_validator": _header(proposer_address=OTHER[:20]),
    "proposer_size": _header(proposer_address=OTHER[:19]),
    "time": lambda b: _header(time=b.header.time.add_nanos(1))(b),
    "bad_last_commit_signature": _flip_last_commit_sig,
    "last_commit_without_quorum": _drop_last_commit_sigs,
    "data_hash": _header(data_hash=OTHER),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_validate_block_errors_match(chain, case):
    ref_state = chain.states[ERR_HEIGHT - 1]
    bad = ERRORS[case](chain.blocks[ERR_HEIGHT - 1])
    with pytest.raises(Exception) as ref_exc:
        ref_validate_block(ref_state, bad)
    with pytest.raises(Exception) as port_exc:
        validate_block(port_state(ref_state), port_block(bad))
    assert type(port_exc.value).__name__ == type(ref_exc.value).__name__
    assert str(port_exc.value) == str(ref_exc.value)


def test_initial_block_errors_match(chain):
    """Height 1 against the genesis state: its time must be genesis time,
    its height the initial height."""
    cases = [_header(time=chain.blocks[0].header.time.add_nanos(5)), _header(height=2)]
    for mutate in cases:
        bad = mutate(chain.blocks[0])
        with pytest.raises(Exception) as ref_exc:
            ref_validate_block(chain.states[0], bad)
        with pytest.raises(Exception) as port_exc:
            validate_block(port_state(chain.states[0]), port_block(bad))
        assert (type(port_exc.value).__name__, str(port_exc.value)) == \
            (type(ref_exc.value).__name__, str(ref_exc.value))


def test_make_block_matches(chain):
    """The state's MakeBlock at a height, from the same transactions, last
    commit and evidence, builds the same block bytes."""
    h = 6
    ref = chain.blocks[h - 1]
    state = port_state(chain.states[h - 1])
    block = state.make_block(h, list(ref.data.txs), port_block(ref).last_commit,
                             port_block(ref).evidence, ref.header.proposer_address)
    assert block.encode() == ref.encode()


# -- stores ------------------------------------------------------------------


def test_block_store_loads_a_reference_node(chain):
    bs, _ = convert.stores_from_items(chain.db_items)
    assert (bs.base(), bs.height(), bs.size()) == (1, N_BLOCKS, N_BLOCKS)
    ref_bs = chain.block_store
    for h in range(1, N_BLOCKS + 1):
        assert bs.load_block(h).encode() == ref_bs.load_block(h).encode()
        assert bs.load_block_meta(h).encode() == ref_bs.load_block_meta(h).encode()
        assert bs.load_seen_commit(h).encode() == ref_bs.load_seen_commit(h).encode()
        assert bs.load_block_part(h, 0).encode() == ref_bs.load_block_part(h, 0).encode()
        assert bs.load_block_by_hash(chain.blocks[h - 1].hash()).encode() == \
            chain.blocks[h - 1].encode()
        if h < N_BLOCKS:
            assert bs.load_block_commit(h).encode() == ref_bs.load_block_commit(h).encode()
    assert bs.load_block(N_BLOCKS + 1) is None
    assert bs.load_block_commit(N_BLOCKS) is None


def test_state_store_loads_a_reference_node(chain):
    _, ss = convert.stores_from_items(chain.db_items)
    ref_ss = chain.state_store
    assert port_store._encode_state(ss.load()) == ref_store._encode_state(ref_ss.load())
    assert port_store._encode_state(ss.load()) == ref_store._encode_state(chain.states[-1])
    for h in range(1, N_BLOCKS + 2):
        vals, ref_vals = ss.load_validators(h), ref_ss.load_validators(h)
        assert vals.encode() == ref_vals.encode()
        assert vals.get_proposer().address == ref_vals.get_proposer().address
        assert ss.load_consensus_params(h).encode() == ref_ss.load_consensus_params(h).encode()
    for h in range(1, N_BLOCKS + 1):
        assert ss.load_abci_responses(h) == ref_ss.load_abci_responses(h)
    with pytest.raises(port_store.NoValidatorsError) as port_exc:
        ss.load_validators(N_BLOCKS + 5)
    with pytest.raises(ref_store.NoValidatorsError) as ref_exc:
        ref_ss.load_validators(N_BLOCKS + 5)
    assert str(port_exc.value) == str(ref_exc.value)


def test_pruning_gives_the_same_items(chain):
    """Both packages prune a copy of the same node to the same items."""
    bs, ss = convert.stores_from_items(chain.db_items)
    ref_db = RefMemDB()
    for k, v in chain.db_items:
        ref_db.set(k, v)
    ref_bs, ref_ss = RefBlockStore(ref_db), ref_store.StateStore(ref_db)
    assert bs.prune_blocks(4) == ref_bs.prune_blocks(4)
    ss.prune_states(4)
    ref_ss.prune_states(4)
    assert list(bs._db.iterator()) == list(ref_db.iterator())
    assert ss.load_validators(6).encode() == ref_ss.load_validators(6).encode()


def test_convert_round_trips(chain):
    raw = ref_store._encode_state(chain.states[5])
    state = convert.state_from_store_bytes(raw)
    assert port_store._encode_state(state) == raw
    assert port_store._encode_state(state.copy()) == raw
    for ref in chain.blocks:
        assert convert.block_from_wire(ref.encode()).encode() == ref.encode()
    assert Block.decode(chain.blocks[0].encode()).hash() == chain.blocks[0].hash()
    assert ref_state_mod.median_time(chain.blocks[4].last_commit, chain.states[3].last_validators) == \
        chain.blocks[4].header.time


@pytest.mark.parametrize("backend", ["memdb", "sqlite"])
def test_db_backends_match_the_reference(chain, tmp_path, backend):
    """Both packages' ``new_db`` of a backend, given a node's items by a
    batch and a delete, hold the same items and ranges; the port opens the
    reference's sqlite file and loads its blocks and state."""
    from cometbft_tpu.libs import db as ref_db_mod
    from cometbft_tpu_torch.libs import db as db_mod
    from cometbft_tpu_torch.store import BlockStore

    ref_db = ref_db_mod.new_db("ref", backend, str(tmp_path))
    db = db_mod.new_db("port", backend, str(tmp_path))
    for d in (ref_db, db):
        batch = d.new_batch()
        for k, v in chain.db_items:
            batch.set(k, v)
        batch.write()
        d.delete(b"blockStore")
    assert list(db.iterator()) == list(ref_db.iterator())
    assert list(db.reverse_iterator(b"H:", b"H;")) == list(ref_db.reverse_iterator(b"H:", b"H;"))
    assert db.get(b"blockStore") is None and db.has(b"stateKey")
    if backend == "sqlite":
        ref_db.set(b"blockStore", dict(chain.db_items)[b"blockStore"])
        ref_db.close()
        db.close()
        db = db_mod.SQLiteDB(str(tmp_path / "ref.sqlite"))
        assert list(db.iterator()) == chain.db_items
    else:
        db.set(b"blockStore", dict(chain.db_items)[b"blockStore"])
    assert BlockStore(db).load_block(N_BLOCKS).encode() == chain.blocks[-1].encode()
    assert port_store._encode_state(port_store.StateStore(db).load()) == \
        ref_store._encode_state(chain.states[-1])
    db.close()


def test_abci_responses_round_trip_as_the_reference(chain):
    """The stored ABCI responses decode (for a replay) to the same objects
    in both packages."""
    from cometbft_tpu.state import execution as ref_execution
    from cometbft_tpu_torch.state import execution

    for h in (3, 6):
        raw = chain.state_store.load_abci_responses(h)
        ref, port = ref_execution.decode_responses(raw), execution.decode_responses(raw)
        assert [(r.code, r.data, r.gas_wanted, r.log) for r in port["deliver_txs"]] == \
            [(r.code, r.data, r.gas_wanted, r.log) for r in ref["deliver_txs"]]
        assert [(u.pub_key.bytes(), u.power) for u in port["end_block"].validator_updates] == \
            [(u.pub_key.bytes(), u.power) for u in ref["end_block"].validator_updates]
        assert execution._encode_responses(port) == ref_execution._encode_responses(ref)
    with pytest.raises(RuntimeError, match="legacy summary format"):
        execution.decode_responses({"end_block": {"validator_updates": 3}})


def test_bootstrap_writes_the_reference_items(chain):
    """StateStore.bootstrap (the statesync entry) of the same state writes
    the same items."""
    from cometbft_tpu_torch.libs.db import MemDB

    ref_db, db = RefMemDB(), MemDB()
    ref_store.StateStore(ref_db).bootstrap(chain.states[6])
    port_store.StateStore(db).bootstrap(port_state(chain.states[6]))
    assert list(db.iterator()) == list(ref_db.iterator())
