"""Blocks, part sets, evidence and blocksync messages in the port against
the JAX package, on blocks that package's executor built (a 4-validator
chain with a validator promoted at height 3, so that its set changes at
height 5, and a duplicate-vote evidence in the block at height 6). Every
block decodes in the port and re-encodes to the same bytes, with the same
hashes and part sets; every message encodes to the same bytes. No
tolerance."""

import dataclasses

import pytest
import torch_chains as tc

from cometbft_tpu.blocksync import reactor as ref_reactor
from cometbft_tpu.crypto.merkle import hash_from_byte_slices as ref_hash_from_byte_slices
from cometbft_tpu.libs.bit_array import BitArray as RefBitArray
from cometbft_tpu.types import params as ref_params
from cometbft_tpu.types import part_set as ref_part_set
from cometbft_tpu.types import evidence as ref_evidence
from cometbft_tpu.types.evidence import evidence_list_hash as ref_evidence_list_hash
from cometbft_tpu.types.results import results_hash as ref_results_hash
from cometbft_tpu.types.tx import txs_hash as ref_txs_hash
from cometbft_tpu_torch import convert, native
from cometbft_tpu_torch.blocksync import reactor as port_reactor
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs.bit_array import BitArray
from cometbft_tpu_torch.types import evidence, params
from cometbft_tpu_torch.types.block import Block, BlockMeta
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES, Part, PartSet
from cometbft_tpu_torch.types.results import results_hash
from cometbft_tpu_torch.types.tx import txs_hash

pytestmark = pytest.mark.torch_port

N_BLOCKS = 8
PROMOTE_AT = 3
EVIDENCE_AT = 6


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"blk", n_vals=4, n_blocks=N_BLOCKS, promote_at=PROMOTE_AT,
                              evidence_at=EVIDENCE_AT)


@pytest.mark.parametrize("height", range(1, N_BLOCKS + 1))
def test_block_decodes_and_reencodes(chain, height):
    ref = chain.blocks[height - 1]
    wire = ref.encode()
    block = convert.block_from_wire(wire)
    assert block.encode() == wire
    assert block.hash() == ref.hash()
    assert block.data.hash() == ref.data.hash()
    assert block.header.hash() == ref.header.hash()
    if ref.last_commit is not None:
        assert block.last_commit.hash() == ref.last_commit.hash()
    block.validate_basic()
    ref_parts, parts = ref.make_part_set(), block.make_part_set()
    assert parts.header().encode() == ref_parts.header().encode()
    assert [parts.get_part(i).encode() for i in range(parts.total)] == \
        [ref_parts.get_part(i).encode() for i in range(ref_parts.total)]


def test_promotion_changes_the_set_in_the_header(chain):
    """The promoted validator signs from height PROMOTE_AT + 2: the header's
    validators hash changes there, and the next commit has 5 signatures."""
    hashes = [b.header.validators_hash for b in chain.blocks]
    changed = [h for h in range(2, N_BLOCKS + 1) if hashes[h - 1] != hashes[h - 2]]
    assert changed == [PROMOTE_AT + 2]
    block = convert.block_from_wire(chain.blocks[PROMOTE_AT + 2].encode())
    assert len(block.last_commit.signatures) == 5


def test_block_with_evidence(chain):
    ref = chain.blocks[EVIDENCE_AT - 1]
    assert len(ref.evidence) == 1
    block = Block.decode(ref.encode())
    (ev,) = block.evidence
    assert isinstance(ev, evidence.DuplicateVoteEvidence)
    assert ev.encode() == ref.evidence[0].encode()
    assert ev.hash() == ref.evidence[0].hash()
    assert ev.height() == ref.evidence[0].height() == EVIDENCE_AT - 1
    ev.validate_basic()
    assert evidence.evidence_list_hash(block.evidence) == ref_evidence_list_hash(ref.evidence)
    assert block.header.evidence_hash == ref.header.evidence_hash
    assert evidence.encode_evidence_list(block.evidence) == ref_evidence.encode_evidence_list(ref.evidence)
    assert evidence.evidence_list_hash([]) == ref_evidence_list_hash([])


def test_light_client_attack_evidence_round_trips(chain):
    """The second evidence type: a conflicting light block built from the
    chain's own signed header, same bytes and hash in both packages."""
    from cometbft_tpu.types.block import SignedHeader as RefSignedHeader
    from cometbft_tpu.types.evidence import LightBlock as RefLightBlock
    from cometbft_tpu.types.evidence import LightClientAttackEvidence as RefLCA

    h = 4
    ref_ev = RefLCA(
        conflicting_block=RefLightBlock(
            RefSignedHeader(chain.blocks[h - 1].header, chain.seen[h - 1]),
            chain.states[h - 1].validators),
        common_height=h - 1,
        byzantine_validators=list(chain.states[h - 1].validators.validators[:2]),
        total_voting_power=chain.states[h - 1].validators.total_voting_power(),
        timestamp=chain.blocks[h - 1].header.time,
    )
    wire = ref_evidence.encode_evidence(ref_ev)
    ev = evidence.decode_evidence(wire)
    assert isinstance(ev, evidence.LightClientAttackEvidence)
    assert evidence.encode_evidence(ev) == wire
    assert ev.hash() == ref_ev.hash()
    ev.validate_basic()


def test_block_meta_and_txs(chain):
    for h in (1, EVIDENCE_AT):
        raw = chain.block_store._db.get(b"H:%d" % h)
        meta = BlockMeta.decode(raw)
        assert meta.encode() == raw
        assert meta.num_txs == len(chain.blocks[h - 1].data.txs)
    for n in (0, 1, 3, 40):
        txs = [b"tx-%d" % i for i in range(n)]
        assert txs_hash(txs) == ref_txs_hash(txs)


def test_results_hash_and_params(chain):
    class R:
        def __init__(self, code, data):
            self.code, self.data, self.gas_wanted, self.gas_used = code, data, 1, 0

    rs = [R(i % 3, b"d%d" % i) for i in range(40)]
    assert results_hash(rs) == ref_results_hash(rs)
    assert results_hash([]) == ref_results_hash([])
    ref_cp = ref_params.ConsensusParams(
        block=ref_params.BlockParams(1_000_000, 50), version=ref_params.VersionParams(3))
    cp = params.ConsensusParams.decode(ref_cp.encode())
    assert cp.encode() == ref_cp.encode() and cp.hash() == ref_cp.hash()
    assert params.ConsensusParams().hash() == ref_params.ConsensusParams().hash()
    assert chain.blocks[0].header.consensus_hash == params.ConsensusParams().hash()
    with pytest.raises(ValueError) as port_exc:
        dataclasses.replace(cp, block=params.BlockParams(0, -1)).validate_basic()
    with pytest.raises(ValueError) as ref_exc:
        dataclasses.replace(ref_cp, block=ref_params.BlockParams(0, -1)).validate_basic()
    assert str(port_exc.value) == str(ref_exc.value)


def test_genesis_json_round_trips(chain):
    gen = GenesisDoc.from_json(chain.gen_json)
    assert gen.to_json() == chain.gen_json
    assert gen.validator_hash() == chain.gen.validator_hash()


# -- part sets ----------------------------------------------------------------


@pytest.mark.parametrize("n_bytes", [100, 3 * BLOCK_PART_SIZE_BYTES - 7, 33 * BLOCK_PART_SIZE_BYTES + 5])
def test_part_set_parity(n_bytes):
    """Parts, proofs and roots byte-identical, below and above the 32 parts
    from which the port's proofs take the native pass."""
    native.load()  # built: 32 parts or more take the native pass
    data = bytes((i * 7 + 3) % 251 for i in range(n_bytes))
    ref = ref_part_set.PartSet.from_data(data)
    ps = PartSet.from_data(data)
    assert (ps.total, ps.hash(), ps.byte_size) == (ref.total, ref.hash(), ref.byte_size)
    assert merkle.last_proofs_path == ("host-native" if ps.total >= 32 else "pure-python")
    for i in range(ps.total):
        assert ps.get_part(i).encode() == ref.get_part(i).encode()
        assert Part.decode(ref.get_part(i).encode()).encode() == ref.get_part(i).encode()
    assert ps.get_reader() == data


def test_add_part_rejects_a_bad_proof_with_the_reference_text():
    data = bytes(range(256)) * 700
    ref, ps = ref_part_set.PartSet.from_data(data), PartSet.from_data(data)
    good = ref.get_part(1)
    cases = [
        dataclasses.replace(good, bytes=b"\x00" * len(good.bytes)),
        ref_part_set.PartSet.from_data(data[::-1]).get_part(0),
        dataclasses.replace(good, index=99),
        dataclasses.replace(good, index=2),
    ]
    for bad in cases:
        rx_ref, rx = ref_part_set.PartSet(ref.header()), PartSet(ps.header())
        with pytest.raises(Exception) as ref_exc:
            rx_ref.add_part(bad)
        with pytest.raises(Exception) as port_exc:
            rx.add_part(Part.decode(bad.encode()))
        assert type(port_exc.value).__name__ == type(ref_exc.value).__name__
        assert str(port_exc.value) == str(ref_exc.value)
        assert rx.count == 0


@pytest.fixture
def data():
    return bytes(range(256)) * 700  # ~175 KB -> 3 parts


def test_split_and_reassemble(data):
    ps = PartSet.from_data(data)
    assert ps.total == (len(data) + BLOCK_PART_SIZE_BYTES - 1) // BLOCK_PART_SIZE_BYTES
    assert ps.is_complete()
    assert ps.get_reader() == data
    rx = PartSet(ps.header())
    for i in range(ps.total):
        assert rx.add_part(ps.get_part(i))
    assert rx.is_complete()
    assert rx.get_reader() == data
    assert rx.hash() == ps.hash()


def test_add_part_rejects_bad_proof(data):
    ps = PartSet.from_data(data)
    rx = PartSet(ps.header())
    good = ps.get_part(1)
    bad = dataclasses.replace(good, bytes=b"\x00" * len(good.bytes))
    with pytest.raises(Exception):
        rx.add_part(bad)
    assert rx.count == 0
    other = PartSet.from_data(data[::-1])
    with pytest.raises(Exception):
        rx.add_part(other.get_part(0))
    assert rx.count == 0
    assert rx.add_part(good)
    assert rx.count == 1


def test_duplicate_and_out_of_range(data):
    ps = PartSet.from_data(data)
    rx = PartSet(ps.header())
    p0 = ps.get_part(0)
    assert rx.add_part(p0)
    assert not rx.add_part(p0), "duplicate part must report not-added"
    with pytest.raises(Exception):
        rx.add_part(dataclasses.replace(p0, index=99))
    assert not rx.is_complete()
    assert rx.bit_array().get_index(0)
    assert not rx.bit_array().get_index(1)


def test_bit_array_matches_reference():
    ref, port = RefBitArray(70), BitArray(70)
    for i in (0, 3, 63, 64, 69):
        assert port.set_index(i, True) == ref.set_index(i, True)
    assert port.encode() == ref.encode()
    assert BitArray.decode(ref.encode()).encode() == ref.encode()
    assert repr(port) == repr(ref)
    other_ref, other = RefBitArray(70), BitArray(70)
    other_ref.set_index(5, True)
    other.set_index(5, True)
    assert port.or_with(other).encode() == ref.or_with(other_ref).encode()
    assert port.sub(other).encode() == ref.sub(other_ref).encode()
    assert port.not_().encode() == ref.not_().encode()
    assert port.num_true_bits() == ref.num_true_bits() == 5


# -- blocksync messages -------------------------------------------------------


def test_blocksync_messages_encode_identically(chain):
    block = chain.blocks[EVIDENCE_AT - 1]
    port_block = Block.decode(block.encode())
    pairs = [
        (port_reactor.encode_block_request(7), ref_reactor.encode_block_request(7)),
        (port_reactor.encode_no_block_response(7), ref_reactor.encode_no_block_response(7)),
        (port_reactor.encode_block_response(port_block), ref_reactor.encode_block_response(block)),
        (port_reactor.encode_status_request(), ref_reactor.encode_status_request()),
        (port_reactor.encode_status_response(9, 1), ref_reactor.encode_status_response(9, 1)),
    ]
    for port_bytes, ref_bytes in pairs:
        assert port_bytes == ref_bytes
        kind, payload = port_reactor.decode_message(ref_bytes)
        ref_kind, ref_payload = ref_reactor.decode_message(ref_bytes)
        assert kind == ref_kind
        if kind == "block_response":
            assert payload.encode() == ref_payload.encode()
        else:
            assert payload == ref_payload
    with pytest.raises(ValueError, match="unknown blocksync message"):
        port_reactor.decode_message(b"")
    assert merkle.hash_from_byte_slices([b"a"] * 40) == ref_hash_from_byte_slices([b"a"] * 40)
