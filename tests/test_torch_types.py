"""The port's types (``cometbft_tpu_torch/types``) against the reference's
on the same inputs, carried across by wire bytes (``convert.py``): canonical
sign bytes (one at a time and the vectorized ``vote_sign_bytes_all``, both
sides of its 64-row switch), header, validator-set and commit hashes, and
encode/decode round trips. No tolerance: bytes must be equal."""

import hashlib

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cometbft_tpu.crypto import bn254 as ref_bn
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import encoding as ref_encoding
from cometbft_tpu.types import block as rb
from cometbft_tpu.types import canonical as ref_canonical
from cometbft_tpu.types.cmttime import GO_ZERO_SECONDS
from cometbft_tpu.types.cmttime import Time as RefTime
from cometbft_tpu.types.light_block import LightBlock as RefLightBlock
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu.types.vote import Vote as RefVote
from cometbft_tpu.types.vote import vote_to_commit_sig as ref_vote_to_commit_sig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import encoding
from cometbft_tpu_torch.types import block as pb
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote, vote_to_commit_sig

pytestmark = pytest.mark.torch_port

CHAIN_ID = "torch-types-chain"

# Seconds: zero, negative, Go's zero time, the int64 ends, a real epoch.
SECONDS = st.one_of(
    st.sampled_from([0, -1, GO_ZERO_SECONDS, 1_700_000_000, 2**63 - 1, -(2**63)]),
    st.integers(-(2**63), 2**63 - 1),
)
# Nanos at every varint width (1 to 5 bytes below 10^9), and negative.
NANOS = st.one_of(
    st.sampled_from([0, 1, 127, 128, 2**14 - 1, 2**14, 2**21 - 1, 2**21, 2**28 - 1, 2**28,
                     999_999_999, -1]),
    st.integers(0, 999_999_999),
)
FLAGS = st.sampled_from([rb.BLOCK_ID_FLAG_ABSENT, rb.BLOCK_ID_FLAG_COMMIT, rb.BLOCK_ID_FLAG_NIL])


def _block_id(seed: int) -> rb.BlockID:
    h = hashlib.sha256(b"block-%d" % seed).digest()
    return rb.BlockID(h, rb.PartSetHeader(1 + seed % 7, hashlib.sha256(h).digest()))


def _ref_commit(rows, height, round_, block_id) -> rb.Commit:
    """A commit of the given (flag, seconds, nanos) rows; an absent row with
    the Go zero time is a well-formed absent CommitSig."""
    sigs = [rb.CommitSig.absent() if flag == rb.BLOCK_ID_FLAG_ABSENT and RefTime(s, ns).is_zero()
            else rb.CommitSig(flag, bytes([i % 256]) * 20, RefTime(s, ns), bytes([i % 251]) * 64)
            for i, (flag, s, ns) in enumerate(rows)]
    return rb.Commit(height=height, round=round_, block_id=block_id, signatures=sigs)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    rows=st.lists(st.tuples(FLAGS, SECONDS, NANOS), min_size=1, max_size=130),
    height=st.integers(0, 2**63 - 1),
    round_=st.integers(0, 2**31),
    zero_block=st.booleans(),
    chain_id=st.sampled_from([CHAIN_ID, "", "chain", "c" * 50]),
)
def test_vote_sign_bytes_equal_the_reference(rows, height, round_, zero_block, chain_id):
    block_id = rb.BlockID() if zero_block else _block_id(height % 97)
    ref = _ref_commit(rows, height, round_, block_id)
    port = convert.commit_from_wire(ref.encode())
    assert port.encode() == ref.encode()
    want_all = ref.vote_sign_bytes_all(chain_id)
    assert port.vote_sign_bytes_all(chain_id) == want_all
    assert [port.vote_sign_bytes(chain_id, i) for i in range(len(rows))] == want_all
    # and each equals the canonical vote built field by field
    for i in (0, len(rows) - 1):
        cs = port.signatures[i]
        vote_bid = port.block_id if cs.for_block_flag() else pb.BlockID()
        assert want_all[i] == canonical.vote_sign_bytes_from_parts(
            chain_id, pb.PRECOMMIT_TYPE, height, round_, vote_bid, cs.timestamp)


@pytest.mark.parametrize("n", [63, 64, 65, 200])
def test_sign_bytes_all_memo_and_switch(n):
    """Distinct nanos as real precommits have, on both sides of the 64-row
    switch: equal to the reference, memoized per chain id."""
    rows = [(rb.BLOCK_ID_FLAG_COMMIT if i % 5 else rb.BLOCK_ID_FLAG_NIL, 1_700_000_000, 7 * i)
            for i in range(n)]
    ref = _ref_commit(rows, 12, 1, _block_id(3))
    port = convert.commit_from_wire(ref.encode())
    got = port.vote_sign_bytes_all(CHAIN_ID)
    assert got == ref.vote_sign_bytes_all(CHAIN_ID)
    assert port.vote_sign_bytes_all(CHAIN_ID) is got
    assert port.vote_sign_bytes_all("other") == ref.vote_sign_bytes_all("other")


@settings(max_examples=25, deadline=None)
@given(
    height=st.integers(1, 2**63 - 1),
    seconds=SECONDS,
    nanos=NANOS,
    chain_id=st.sampled_from(["", CHAIN_ID]),
    empty_hashes=st.booleans(),
)
def test_header_hash_and_round_trip(height, seconds, nanos, chain_id, empty_hashes):
    h = lambda tag: b"" if empty_hashes else hashlib.sha256(tag).digest()  # noqa: E731
    ref = rb.Header(
        version=rb.Consensus(11, 3), chain_id=chain_id, height=height,
        time=RefTime(seconds, nanos), last_block_id=_block_id(height % 13),
        last_commit_hash=h(b"lc"), data_hash=h(b"d"), validators_hash=hashlib.sha256(b"v").digest(),
        next_validators_hash=h(b"nv"), consensus_hash=h(b"c"), app_hash=h(b"a"),
        last_results_hash=h(b"r"), evidence_hash=h(b"e"), proposer_address=b"\x07" * 20,
    )
    port = pb.Header.decode(ref.encode())
    assert port.encode() == ref.encode()
    assert port.hash() == ref.hash()
    assert pb.Header().hash() is None and rb.Header().hash() is None


def _ref_set(n: int, bn254_at=(), powers=None) -> RefValidatorSet:
    keys = []
    for i in range(n):
        secret = hashlib.sha256(b"torch-types-key-%d" % i).digest()
        if i in bn254_at:
            keys.append(ref_bn.PrivKey(secret).pub_key())
        else:
            keys.append(ref_ed.gen_priv_key_from_secret(secret).pub_key())
    powers = powers or [10 + (i * 7) % 23 for i in range(n)]
    return RefValidatorSet([RefValidator.new(k, p) for k, p in zip(keys, powers)])


def _port_set(ref: RefValidatorSet) -> ValidatorSet:
    return convert.validator_set_from_wire(
        [(ref_encoding.pub_key_to_proto(v.pub_key), v.voting_power) for v in ref.validators])


@pytest.mark.parametrize("n,bn254_at", [(1, ()), (4, (2,)), (31, ()), (32, ()), (33, (0, 32))])
def test_validator_set_hash_and_encoding(n, bn254_at):
    """Both sides of the native tree's 32-leaf switch; ed25519 and bn254 keys."""
    ref = _ref_set(n, bn254_at)
    port = _port_set(ref)
    assert port.hash() == ref.hash()
    assert port.encode() == ref.encode()
    assert [v.bytes() for v in port.validators] == [v.bytes() for v in ref.validators]
    assert port.get_proposer().address == ref.get_proposer().address
    decoded = ValidatorSet.decode(ref.encode())
    assert decoded.encode() == ref.encode() and decoded.hash() == ref.hash()
    port.validate_basic()
    for i, v in enumerate(ref.validators):
        idx, pv = port.get_by_address(v.address)
        assert idx == i and pv.voting_power == v.voting_power
        assert pv.pub_key.type() == v.pub_key.type()
    # a proposer rotation keeps both in step
    port.increment_proposer_priority(3)
    ref.increment_proposer_priority(3)
    assert port.encode() == ref.encode()


@pytest.mark.parametrize("n", [1, 31, 32, 65])
def test_commit_hash_and_round_trip(n):
    rows = [(rb.BLOCK_ID_FLAG_COMMIT, 1_700_000_000 + i, i) if i % 4
            else (rb.BLOCK_ID_FLAG_ABSENT, GO_ZERO_SECONDS, 0) for i in range(n)]
    ref = _ref_commit(rows, 5, 0, _block_id(n))
    port = pb.Commit.decode(ref.encode())
    assert port.encode() == ref.encode()
    assert port.hash() == ref.hash()
    port.validate_basic()
    sh = rb.SignedHeader(rb.Header(chain_id=CHAIN_ID, height=5,
                                   validators_hash=hashlib.sha256(b"v").digest()), ref)
    psh = convert.signed_header_from_wire(sh.encode())
    assert psh.encode() == sh.encode() and psh.commit.hash() == ref.hash()


def test_aggregate_commit_round_trip():
    ref_vals = _ref_set(4, bn254_at=(0, 1, 2, 3))
    privs = [ref_bn.PrivKey(hashlib.sha256(b"torch-types-key-%d" % i).digest()) for i in range(4)]
    by_addr = {p.pub_key().address(): p for p in privs}
    block_id = _block_id(9)
    sigs = []
    for i, v in enumerate(ref_vals.validators):
        if i == 2:
            sigs.append(rb.CommitSig.absent())
            continue
        vote = RefVote(type=rb.PRECOMMIT_TYPE, height=3, round=0, block_id=block_id,
                       timestamp=RefTime(1_700_000_000, 100 + i), validator_address=v.address,
                       validator_index=i)
        signed = vote.with_signature(by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID)))
        sigs.append(ref_vote_to_commit_sig(signed))
    per_vote = rb.Commit(height=3, round=0, block_id=block_id, signatures=sigs)
    port_per_vote = pb.Commit.decode(per_vote.encode())
    agg = rb.aggregate_commit(per_vote, ref_vals)
    port_agg = pb.aggregate_commit(port_per_vote, _port_set(ref_vals))
    assert agg.is_aggregate() and port_agg.encode() == agg.encode()
    assert port_agg.hash() == agg.hash()
    port_agg.validate_basic()
    # anything but an all-bn254 set stays per-vote
    assert pb.aggregate_commit(port_per_vote, _port_set(_ref_set(4))) is port_per_vote


def test_vote_sign_bytes_and_commit_sig():
    for nil in (False, True):
        ref = RefVote(type=rb.PRECOMMIT_TYPE, height=7, round=2,
                      block_id=rb.BlockID() if nil else _block_id(1),
                      timestamp=RefTime(1_700_000_123, 456), validator_address=b"\x01" * 20,
                      validator_index=3, signature=b"\x02" * 64)
        port = Vote.decode(ref.encode())
        assert port.encode() == ref.encode()
        assert port.sign_bytes(CHAIN_ID) == ref.sign_bytes(CHAIN_ID)
        assert vote_to_commit_sig(port).encode() == ref_vote_to_commit_sig(ref).encode()
        port.validate_basic()
    assert ref_canonical.proposal_sign_bytes_from_parts(
        CHAIN_ID, 4, 1, -1, _block_id(2), RefTime(5, 6)) == canonical.proposal_sign_bytes_from_parts(
        CHAIN_ID, 4, 1, -1, pb.BlockID.decode(_block_id(2).encode()), pb.Time(5, 6))


def test_light_block_round_trip():
    ref_vals = _ref_set(5)
    header = rb.Header(chain_id=CHAIN_ID, height=2, time=RefTime(1_700_000_000, 0),
                       validators_hash=ref_vals.hash(), next_validators_hash=ref_vals.hash())
    commit = _ref_commit([(rb.BLOCK_ID_FLAG_COMMIT, 1_700_000_001, i) for i in range(5)], 2, 0,
                         rb.BlockID(header.hash(), rb.PartSetHeader(1, b"\x03" * 32)))
    ref = RefLightBlock(rb.SignedHeader(header, commit), ref_vals)
    port = LightBlock(convert.signed_header_from_wire(ref.signed_header.encode()), _port_set(ref_vals))
    assert port.encode() == ref.encode()
    assert port.hash() == ref.hash()
    assert LightBlock.decode(ref.encode()).encode() == ref.encode()


def test_key_types_not_ported_raise_by_name():
    with pytest.raises(ValueError, match="secp256k1 is not ported"):
        encoding.pub_key_from_proto(b"\x12\x21" + b"\x02" * 33)
    with pytest.raises(ValueError, match="sr25519 is not ported"):
        encoding.pub_key_from_type_and_bytes("sr25519", b"\x00" * 32)
    ed = ref_ed.gen_priv_key_from_secret(b"k").pub_key()
    got = encoding.pub_key_from_proto(ref_encoding.pub_key_to_proto(ed))
    assert got.bytes() == ed.bytes() and got.address() == ed.address()
    assert encoding.pub_key_to_proto(got) == ref_encoding.pub_key_to_proto(ed)
