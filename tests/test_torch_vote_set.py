"""``VoteSet`` in the port (``types/vote_set.py``) against the JAX
package's, in the reference ``test_vote_set.py`` rig shapes: 9 validators
of power 10 from fixed secrets, precommits at height 1 round 0. The votes
are signed by the reference's ``MockPV`` and carried across as
``Vote.encode()`` bytes; both vote sets get the same sequence of adds and
peer +2/3 claims, and each step's outcome (added or not, or the exception's
type and text) must be equal, as must the bit arrays, the majorities, the
sums, the listed votes and ``make_commit``'s bytes. Vote admission goes
through each package's ``crypto/sigbatch.verify_vote_signature``: inline
(window 0) in most cases, and once through the micro-batch window under
``TorchBackend(device="cpu")`` for the port and ``CpuBackend`` for the
reference. No tolerance."""

from dataclasses import replace

import pytest
import torch

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import encoding as ref_encoding
from cometbft_tpu.crypto import sigbatch as ref_sigbatch
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import GenesisDoc, GenesisValidator, Time
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu.types.part_set import PartSetHeader as RefPSH
from cometbft_tpu.types.priv_validator import MockPV
from cometbft_tpu.types.vote_set import VoteSet as RefVoteSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.crypto import sigbatch
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import ErrVoteConflictingVotes, VoteSet

pytestmark = pytest.mark.torch_port

CHAIN = "voteset-chain"
BID = RefBlockID(b"\x01" * 32, RefPSH(1, b"\x02" * 32))
OTHER = RefBlockID(b"\x03" * 32, RefPSH(1, b"\x04" * 32))
FORK = RefBlockID(b"\x07" * 32, RefPSH(1, b"\x08" * 32))
NIL = RefBlockID()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def inline(monkeypatch):
    """Both packages' vote admission inline (window 0), caches clear."""
    monkeypatch.setenv("CMTPU_VOTE_BATCH_WINDOW_MS", "0")
    ref_sigbatch.reset()
    sigbatch.reset()
    ref_ed._verified.clear()
    ed25519._verified.clear()
    yield
    ref_sigbatch.reset()
    sigbatch.reset()
    ref_ed._verified.clear()
    ed25519._verified.clear()


@pytest.fixture(scope="module")
def rig():
    pvs = [MockPV(priv_key=ref_ed.gen_priv_key_from_secret(b"voteset-%d" % i)) for i in range(9)]
    gen = GenesisDoc(chain_id=CHAIN, genesis_time=Time(1700000000, 0), validators=[
        GenesisValidator(pv.address(), pv.get_pub_key(), 10, "") for pv in pvs])
    gen.validate_and_complete()
    from cometbft_tpu.state import make_genesis_state

    vals = make_genesis_state(gen).validators
    by_addr = {pv.address(): pv for pv in pvs}
    ordered = [by_addr[v.address] for v in vals.validators]
    wire_vals = [(ref_encoding.pub_key_to_proto(v.pub_key), v.voting_power)
                 for v in vals.validators]
    return ordered, vals, wire_vals


def _vote(pv, idx, bid, nanos=0, type_=PRECOMMIT_TYPE, round_=0):
    v = RefVote(type=type_, height=1, round=round_, block_id=bid,
                timestamp=Time(1700000001, nanos),
                validator_address=pv.address(), validator_index=idx)
    return pv.sign_vote(CHAIN, v)


def _pair(rig, type_=PRECOMMIT_TYPE):
    _, vals, wire_vals = rig
    ref = RefVoteSet(CHAIN, 1, 0, type_, vals)
    port = VoteSet(CHAIN, 1, 0, type_, convert.validator_set_from_wire(wire_vals))
    return ref, port


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared by type name and text
        return (type(e).__name__, str(e))


def _add_both(ref, port, ref_vote):
    """Add one vote to both sets; the outcomes must be equal."""
    a = _outcome(lambda: ref.add_vote(ref_vote))
    b = _outcome(lambda: port.add_vote(Vote.decode(ref_vote.encode())))
    assert a == b
    return b


def _same_state(ref, port):
    assert port.sum == ref.sum
    assert port.bit_array().encode() == ref.bit_array().encode()
    assert port.has_two_thirds_majority() == ref.has_two_thirds_majority()
    assert port.has_two_thirds_any() == ref.has_two_thirds_any()
    assert port.has_all() == ref.has_all()
    assert port.is_commit() == ref.is_commit()
    (rm, rok), (pm, pok) = ref.two_thirds_majority(), port.two_thirds_majority()
    assert pok == rok and (pm.encode() if pm else None) == (rm.encode() if rm else None)
    assert [v.encode() for v in port.list_votes()] == [v.encode() for v in ref.list_votes()]
    for key, bv in ref.votes_by_block.items():
        assert port.votes_by_block[key].bit_array.encode() == bv.bit_array.encode()
        assert port.votes_by_block[key].sum == bv.sum
        assert port.votes_by_block[key].peer_maj23 == bv.peer_maj23
    assert set(port.votes_by_block) == set(ref.votes_by_block)


def test_exact_two_thirds_boundary_and_commit_bytes(rig, inline):
    pvs = rig[0]
    ref, port = _pair(rig)
    for i in range(6):  # 60 of 90: not a majority
        assert _add_both(ref, port, _vote(pvs[i], i, BID, nanos=i)) == ("ok", True)
    _same_state(ref, port)
    assert not port.has_two_thirds_majority() and not port.has_two_thirds_any()
    assert _outcome(port.make_commit) == _outcome(ref.make_commit)
    assert _add_both(ref, port, _vote(pvs[6], 6, BID, nanos=6)) == ("ok", True)
    _add_both(ref, port, _vote(pvs[7], 7, NIL, nanos=7))  # absent from the commit
    _same_state(ref, port)
    assert port.is_commit()
    assert port.make_commit().encode() == ref.make_commit().encode()


def test_nil_majority_and_two_thirds_any(rig, inline):
    pvs = rig[0]
    ref, port = _pair(rig)
    for i in range(7):
        _add_both(ref, port, _vote(pvs[i], i, NIL))
    _same_state(ref, port)
    maj, ok = port.two_thirds_majority()
    assert ok and maj.is_zero() and port.is_commit()  # the reference's IsCommit quirk
    ref, port = _pair(rig, PREVOTE_TYPE)
    for i in range(4):
        _add_both(ref, port, _vote(pvs[i], i, BID, type_=PREVOTE_TYPE))
    for i in range(4, 8):
        _add_both(ref, port, _vote(pvs[i], i, OTHER, type_=PREVOTE_TYPE))
    _same_state(ref, port)
    assert port.has_two_thirds_any() and not port.has_two_thirds_majority()
    assert _outcome(port.make_commit) == _outcome(ref.make_commit)


def test_duplicates_and_conflicts(rig, inline):
    pvs = rig[0]
    ref, port = _pair(rig)
    v = _vote(pvs[0], 0, BID)
    assert _add_both(ref, port, v) == ("ok", True)
    assert _add_both(ref, port, v) == ("ok", False)
    conflict = _vote(pvs[0], 0, OTHER, nanos=5)
    out = _add_both(ref, port, conflict)
    assert out[0] == "ErrVoteConflictingVotes"
    with pytest.raises(ErrVoteConflictingVotes) as ei:
        port.add_vote(Vote.decode(conflict.encode()))
    assert ei.value.vote_a.block_id != ei.value.vote_b.block_id
    # The same vote re-signed with another timestamp: a different signature.
    resigned = _vote(pvs[0], 0, BID, nanos=9)
    assert _add_both(ref, port, resigned)[0] == "VoteError"
    _same_state(ref, port)


def test_bad_signatures_wrong_indices_and_steps(rig, inline):
    pvs = rig[0]
    ref, port = _pair(rig)
    good = _vote(pvs[2], 2, BID)
    bad = [
        replace(good, signature=b"\x01" * 64),
        replace(good, signature=good.signature[:-1] + bytes([good.signature[-1] ^ 1])),
        replace(good, validator_index=3),  # index/address mismatch
        replace(good, validator_index=9),  # past the set
        replace(good, validator_index=-1),
        replace(good, validator_address=b""),
        replace(good, height=2),
        replace(good, round=1),
        replace(good, type=PREVOTE_TYPE),
    ]
    outs = [_add_both(ref, port, v) for v in bad]
    assert all(o[0] == "VoteError" for o in outs), outs
    assert len(port.list_votes()) == 0
    assert _outcome(lambda: port.add_vote(None)) == _outcome(lambda: ref.add_vote(None))
    assert port.size() == 9
    _same_state(ref, port)


def test_peer_maj23_tracks_a_minority_fork(rig, inline):
    pvs = rig[0]
    ref, port = _pair(rig)
    for i in range(5):
        _add_both(ref, port, _vote(pvs[i], i, BID, nanos=i))
    for vs, bid in ((ref, FORK), (port, BlockID.decode(FORK.encode()))):
        vs.set_peer_maj23("peer-x", bid)
        vs.set_peer_maj23("peer-x", bid)  # the same claim again: no error
    assert (_outcome(lambda: port.set_peer_maj23("peer-x", BlockID.decode(OTHER.encode())))
            == _outcome(lambda: ref.set_peer_maj23("peer-x", OTHER)))
    # A fork vote from a validator that voted BID: kept under the fork's
    # tracked block, and still reported as a conflict.
    for i in range(5):
        assert _add_both(ref, port, _vote(pvs[i], i, FORK, nanos=20 + i))[0] == \
            "ErrVoteConflictingVotes"
    for i in range(5, 7):
        _add_both(ref, port, _vote(pvs[i], i, FORK, nanos=30 + i))
    _same_state(ref, port)
    ba = port.bit_array_by_block_id(BlockID.decode(FORK.encode()))
    assert ba.encode() == ref.bit_array_by_block_id(FORK).encode()
    assert port.has_two_thirds_majority() and port.two_thirds_majority()[0].encode() == \
        FORK.encode()
    assert port.make_commit().encode() == ref.make_commit().encode()


def test_vote_set_from_reference_replays_equal(rig, inline):
    pvs, _, wire_vals = rig
    ref, _ = _pair(rig)
    ref.set_peer_maj23("peer-y", FORK)
    order = []
    for i in range(7):
        v = _vote(pvs[i], i, BID, nanos=40 + i)
        ref.add_vote(v)
        order.append(v.encode())
    for i in range(2):
        v = _vote(pvs[i], i, FORK, nanos=50 + i)
        with pytest.raises(Exception):
            ref.add_vote(v)
        order.append(v.encode())
    port = convert.vote_set_from_reference(CHAIN, 1, 0, PRECOMMIT_TYPE, wire_vals, order,
                                           {"peer-y": FORK.encode()})
    _same_state(ref, port)
    assert port.make_commit().encode() == ref.make_commit().encode()
    assert port.get_by_index(3).encode() == ref.get_by_index(3).encode()
    addr = pvs[4].address()
    assert port.get_by_address(addr).encode() == ref.get_by_address(addr).encode()
    assert port.get_by_address(b"\x00" * 20) is None and port.get_by_index(99) is None


def test_zero_height_refused():
    with pytest.raises(ValueError) as ei:
        VoteSet(CHAIN, 0, 0, PRECOMMIT_TYPE, None)
    with pytest.raises(ValueError) as er:
        RefVoteSet(CHAIN, 0, 0, PRECOMMIT_TYPE, None)
    assert str(ei.value) == str(er.value)


def test_admission_through_the_window_on_the_backend(rig, monkeypatch):
    """With the micro-batch window on, a vote's signature reaches the
    process backend through sigbatch (one dispatch) in both packages."""
    pvs = rig[0]
    monkeypatch.setenv("CMTPU_VOTE_BATCH_WINDOW_MS", "2")
    monkeypatch.setenv("CMTPU_COALESCE", "0")
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.TorchBackend(device="cpu"))
    ref_sigbatch.reset()
    sigbatch.reset()
    ref_ed._verified.clear()
    ed25519._verified.clear()
    try:
        ref, port = _pair(rig)
        assert _add_both(ref, port, _vote(pvs[1], 1, BID, nanos=77)) == ("ok", True)
        bad = replace(_vote(pvs[2], 2, BID, nanos=78), signature=b"\x02" * 64)
        assert _add_both(ref, port, bad)[0] == "VoteError"
        rc, pc = ref_sigbatch.counters(), sigbatch.counters()
        assert pc["dispatches"] == rc["dispatches"] >= 1
        assert pc["fallbacks"] == 0
        _same_state(ref, port)
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_sigbatch.reset()
        sigbatch.reset()
        ref_ed._verified.clear()
        ed25519._verified.clear()
