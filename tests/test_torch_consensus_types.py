"""The consensus data types of the port against the JAX package's: the
proposal (``types/proposal.py``: sign bytes, encoding, ``validate_basic``
texts), every consensus message (``consensus/messages.py``) both ways on
the wire and in the WAL's tagged form, the WAL (``consensus/wal.py``: the
files of one message sequence byte-identical, each package reading the
other's file; the catch-up and repair scans of ``test_wal_repair.py``'s
cases, outcomes and repaired files equal), ``FilePV``'s key and
last-sign-state files and its double-sign refusals (``privval/file.py``),
the pubsub query language and the event bus (``libs/pubsub.py``,
``types/events.py``), and the events ``BlockExecutor`` publishes for one
block. Inputs are built in the reference from fixed secrets and carried
across as wire bytes or files. No tolerance."""

import json
import os
import shutil
import struct
from dataclasses import replace

import pytest

from cometbft_tpu.consensus import messages as ref_msgs
from cometbft_tpu.consensus import wal as ref_wal
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.libs.bit_array import BitArray as RefBitArray
from cometbft_tpu.libs.pubsub import Query as RefQuery
from cometbft_tpu.privval.file import FilePV as RefFilePV
from cometbft_tpu.types import cmttime as ref_cmttime
from cometbft_tpu.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu.types.block import BlockID as RefBlockID
from cometbft_tpu.types.cmttime import Time as RefTime
from cometbft_tpu.types.events import EventBus as RefEventBus
from cometbft_tpu.types.part_set import PartSetHeader as RefPSH
from cometbft_tpu.types.proposal import Proposal as RefProposal
from cometbft_tpu.types.vote import Vote as RefVote
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.consensus import messages as msgs
from cometbft_tpu_torch.consensus import wal
from cometbft_tpu_torch.libs.pubsub import Query
from cometbft_tpu_torch.types import cmttime
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote

pytestmark = pytest.mark.torch_port

CHAIN = "cs-types-chain"
BID = RefBlockID(b"\x11" * 32, RefPSH(3, b"\x22" * 32))
KEY = ref_ed.gen_priv_key_from_secret(b"consensus-types")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e))


def _ref_proposal(**kw):
    p = RefProposal(height=7, round=2, pol_round=1, block_id=BID, timestamp=RefTime(1700000100, 123456789))
    p = replace(p, **kw)
    return replace(p, signature=KEY.sign(p.sign_bytes(CHAIN)))


def test_proposal_sign_bytes_encoding_and_checks():
    for kw in ({}, {"pol_round": -1}, {"round": 0, "pol_round": -1}, {"height": 1 << 40}):
        ref = _ref_proposal(**kw)
        port = convert.proposal_from_wire(ref.encode())
        assert port.encode() == ref.encode()
        assert port.sign_bytes(CHAIN) == ref.sign_bytes(CHAIN)
        assert _outcome(port.validate_basic) == _outcome(ref.validate_basic)
        assert RefProposal.decode(port.encode()) == ref
    bad = [{"type": 1}, {"height": -1}, {"round": -1}, {"pol_round": -2},
           {"block_id": RefBlockID()}, {"signature": b""}, {"signature": b"\x01" * 4096},
           {"block_id": RefBlockID(b"\x01" * 31, RefPSH(1, b"\x02" * 32))}]
    for kw in bad:
        ref = replace(_ref_proposal(), **kw)
        port = Proposal.decode(ref.encode()) if "type" not in kw else replace(
            convert.proposal_from_wire(_ref_proposal().encode()), **kw)
        if "type" in kw:
            assert port.encode() == ref.encode()
        got, want = _outcome(port.validate_basic), _outcome(ref.validate_basic)
        assert got == want and want[0] != "ok", (kw, got)


def _ref_vote(i, bid=BID, type_=PREVOTE_TYPE):
    v = RefVote(type=type_, height=7, round=2, block_id=bid, timestamp=RefTime(1700000101, i),
                validator_address=KEY.pub_key().address(), validator_index=i)
    return replace(v, signature=KEY.sign(v.sign_bytes(CHAIN)))


def _ref_messages():
    from cometbft_tpu.types.part_set import PartSet as RefPartSet

    parts = RefPartSet.from_data(b"block bytes " * 500, 1024)
    ba = RefBitArray(13)
    for i in (0, 4, 12):
        ba.set_index(i, True)
    return [
        ref_msgs.NewRoundStepMessage(7, 2, 4, 11, 1),
        ref_msgs.NewValidBlockMessage(7, 2, parts.header(), ba, True),
        ref_msgs.NewValidBlockMessage(7, 2, parts.header(), None, False),
        ref_msgs.ProposalMessage(_ref_proposal()),
        ref_msgs.ProposalPOLMessage(7, 1, ba),
        ref_msgs.ProposalPOLMessage(7, 1, None),
        ref_msgs.BlockPartMessage(7, 2, parts.get_part(1)),
        ref_msgs.VoteMessage(_ref_vote(3)),
        ref_msgs.VoteMessage(_ref_vote(4, RefBlockID(), PRECOMMIT_TYPE)),
        ref_msgs.HasVoteMessage(7, 2, PRECOMMIT_TYPE, 9),
        ref_msgs.VoteSetMaj23Message(7, 2, PREVOTE_TYPE, BID),
        ref_msgs.VoteSetBitsMessage(7, 2, PRECOMMIT_TYPE, BID, ba),
        ref_msgs.VoteSetBitsMessage(7, 2, PRECOMMIT_TYPE, RefBlockID(), None),
    ]


def test_every_consensus_message_both_ways():
    for ref in _ref_messages():
        raw = ref_msgs.encode_consensus_message(ref)
        port = msgs.decode_consensus_message(raw)
        assert type(port).__name__ == type(ref).__name__
        assert msgs.encode_consensus_message(port) == raw
        assert port.encode() == ref.encode()
        assert ref_msgs.decode_consensus_message(msgs.encode_consensus_message(port)).encode() == \
            ref.encode()
    with pytest.raises(ValueError) as e1:
        msgs.decode_consensus_message(b"\x52\x00")
    with pytest.raises(ValueError) as e2:
        ref_msgs.decode_consensus_message(b"\x52\x00")
    assert str(e1.value) == str(e2.value)


def test_wal_tagged_messages_and_timeouts_both_ways():
    refs = [m for m in _ref_messages() if isinstance(m, (
        ref_msgs.ProposalMessage, ref_msgs.BlockPartMessage, ref_msgs.VoteMessage,
        ref_msgs.HasVoteMessage))]
    refs += [ref_msgs.TimeoutInfo(0.25, 7, 2, 3), ref_msgs.TimeoutInfo(0.0, 1, 0, 1)]
    for ref in refs:
        raw = ref_msgs.encode_wal_message(ref)
        port = msgs.decode_wal_message(raw)
        assert msgs.encode_wal_message(port) == raw
        assert ref_msgs.decode_wal_message(msgs.encode_wal_message(port)).encode() == ref.encode()
    for codec in (msgs.encode_wal_message, ref_msgs.encode_wal_message):
        assert _outcome(lambda: codec(object()))[0] == "ValueError"
    assert _outcome(lambda: msgs.decode_wal_message(b"\x09x")) == \
        _outcome(lambda: ref_msgs.decode_wal_message(b"\x09x"))


@pytest.fixture
def fixed_now():
    """Both packages' cmttime.now() on one fixed clock, so the WALs' frame
    times are the same."""
    ticks = {"ref": 0, "port": 0}

    def make(name, cls):
        def now():
            ticks[name] += 1
            return cls(1700000200 + ticks[name], 1000 * ticks[name])
        return now

    ref_cmttime.set_now_source(make("ref", RefTime))
    cmttime.set_now_source(make("port", Time))
    yield ticks
    ref_cmttime.set_now_source(None)
    cmttime.set_now_source(None)


def _sequence(mod_msgs, mod_wal, messages):
    """The reference's message list in one package's own types."""
    out = []
    for m in messages:
        if isinstance(m, ref_wal.EndHeightMessage):
            out.append(mod_wal.EndHeightMessage(m.height))
        else:
            out.append(mod_msgs.decode_wal_message(ref_msgs.encode_wal_message(m)))
    return out


def _wal_items():
    items = [ref_wal.EndHeightMessage(0)]
    items += [m for m in _ref_messages() if isinstance(m, (
        ref_msgs.ProposalMessage, ref_msgs.BlockPartMessage, ref_msgs.VoteMessage))]
    items += [ref_msgs.TimeoutInfo(0.1, 7, 2, 5), ref_wal.EndHeightMessage(7),
              ref_msgs.HasVoteMessage(8, 0, PREVOTE_TYPE, 1), ref_msgs.TimeoutInfo(0.2, 8, 1, 3)]
    return items


def test_wal_files_byte_identical_and_read_across(tmp_path, fixed_now):
    items = _wal_items()
    rpath, ppath = str(tmp_path / "ref" / "wal"), str(tmp_path / "port" / "wal")
    rw, pw = ref_wal.WAL(rpath), wal.WAL(ppath)
    rw.start()
    pw.start()
    for i, (r, p) in enumerate(zip(items[1:], _sequence(msgs, wal, items)[1:])):
        if i % 2:
            rw.write(r)
            pw.write(p)
        else:
            rw.write_sync(r)
            pw.write_sync(p)
    rw.stop()
    pw.stop()
    with open(rpath, "rb") as f1, open(ppath, "rb") as f2:
        assert f1.read() == f2.read()
    # Each package reads the other's file.
    port_read = convert.wal_messages_from_file(rpath)
    ref_read = list(ref_wal.WAL(ppath).iter_messages())
    assert len(port_read) == len(ref_read) == len(items)
    for tp, tr, want in zip(port_read, ref_read, items):
        assert (tp.time.seconds, tp.time.nanos) == (tr.time.seconds, tr.time.nanos)
        if isinstance(want, ref_wal.EndHeightMessage):
            assert tp.msg == wal.EndHeightMessage(want.height) and tr.msg == want
        else:
            assert msgs.encode_wal_message(tp.msg) == ref_msgs.encode_wal_message(want)
            assert ref_msgs.encode_wal_message(tr.msg) == ref_msgs.encode_wal_message(want)
    pw2, rw2 = wal.WAL(rpath), ref_wal.WAL(ppath)
    (p_after, p_saw), (r_after, r_saw) = pw2.catchup_scan(7, 8), rw2.catchup_scan(7, 8)
    pw2.stop()
    rw2.stop()
    assert (p_saw, r_saw) == (False, False) and len(p_after) == len(r_after) == 2
    assert [msgs.encode_wal_message(t.msg) for t in p_after] == \
        [ref_msgs.encode_wal_message(t.msg) for t in r_after]


# -- the repair and catch-up scans (test_wal_repair.py's cases) ---------------


def _repair_items():
    return [ref_wal.EndHeightMessage(0), ref_msgs.TimeoutInfo(0.1, 1, 0, 1),
            ref_wal.EndHeightMessage(1), ref_msgs.TimeoutInfo(0.1, 2, 0, 1),
            ref_msgs.TimeoutInfo(0.2, 2, 1, 2)]


def _spans(data):
    spans, pos = [], 0
    while pos < len(data):
        _, ln = struct.unpack(">II", data[pos: pos + 8])
        spans.append((pos, pos + 8 + ln))
        pos += 8 + ln
    return spans


def _corrupt(data, idx):
    b = bytearray(data)
    b[_spans(data)[idx][1] - 1] ^= 0xFF
    return bytes(b)


def _torn(data, idx):
    return data[: _spans(data)[idx][0] + 9]


def _scan(mod, path):
    def run():
        w = mod.WAL(path)
        try:
            got, saw = w.catchup_scan(1, 2)
            return ([m.msg.height for m in got] if got is not None else None, saw,
                    w.has_end_height(0), w.has_end_height(1), w.has_end_height(2))
        finally:
            w.stop()
    return _outcome(run)


@pytest.mark.parametrize("case", ["clean", "after_marker", "before_marker", "both", "torn"])
def test_wal_catchup_and_repair_scans_equal(tmp_path, fixed_now, case):
    src = str(tmp_path / "src" / "wal")
    w = ref_wal.WAL(src)
    for item in _repair_items():
        w.write_sync(item)
    w.stop()
    with open(src, "rb") as f:
        data = f.read()
    data = {"clean": lambda d: d, "after_marker": lambda d: _corrupt(d, 3),
            "before_marker": lambda d: _corrupt(d, 1),
            "both": lambda d: _corrupt(_corrupt(d, 1), 3), "torn": lambda d: _torn(d, 4)}[case](data)
    paths = {}
    for name in ("ref", "port"):
        os.makedirs(tmp_path / name)
        paths[name] = str(tmp_path / name / "wal")
        with open(paths[name], "wb") as f:
            f.write(data)
    assert _scan(wal, paths["port"]) == _scan(ref_wal, paths["ref"])
    kept_port = wal.repair_wal(paths["port"], paths["port"] + ".fixed")
    kept_ref = ref_wal.repair_wal(paths["ref"], paths["ref"] + ".fixed")
    assert kept_port == kept_ref
    with open(paths["port"] + ".fixed", "rb") as f1, open(paths["ref"] + ".fixed", "rb") as f2:
        assert f1.read() == f2.read()
    assert _scan(wal, paths["port"] + ".fixed") == _scan(ref_wal, paths["ref"] + ".fixed")
    if case == "after_marker":
        assert _scan(wal, paths["port"])[0] == "DataCorruptionError"
    if case == "torn":
        assert kept_port == 4


# -- FilePV ------------------------------------------------------------------


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_file_pv_files_and_double_sign_refusals(tmp_path):
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    rdir.mkdir()
    pdir.mkdir()
    ref = RefFilePV(ref_ed.gen_priv_key_from_secret(b"filepv"), str(rdir / "key.json"),
                    str(rdir / "state.json"))
    ref.save()
    shutil.copy(rdir / "key.json", pdir / "key.json")
    shutil.copy(rdir / "state.json", pdir / "state.json")
    port = convert.file_pv_from_state_files(str(pdir / "key.json"), str(pdir / "state.json"))
    assert port.address() == ref.address()
    port.save()
    assert _read(pdir / "key.json") == _read(rdir / "key.json")
    assert _read(pdir / "state.json") == _read(rdir / "state.json")

    def vote(h, r, t, bid=BID, nanos=0):
        return RefVote(type=t, height=h, round=r, block_id=bid,
                       timestamp=RefTime(1700000300, nanos),
                       validator_address=ref.address(), validator_index=0)

    def prop(h, r, nanos=0, bid=BID):
        return RefProposal(height=h, round=r, pol_round=-1, block_id=bid,
                           timestamp=RefTime(1700000300, nanos))

    steps = [
        ("vote", vote(5, 0, PREVOTE_TYPE)),
        ("vote", vote(5, 0, PREVOTE_TYPE)),  # the same: the same signature
        ("vote", vote(5, 0, PREVOTE_TYPE, nanos=9)),  # only the time differs
        ("vote", vote(5, 0, PREVOTE_TYPE, bid=RefBlockID())),  # conflicting data
        ("vote", vote(5, 0, PRECOMMIT_TYPE)),
        ("vote", vote(5, 0, PREVOTE_TYPE)),  # step regression
        ("proposal", prop(5, 1)),
        ("proposal", prop(5, 1, nanos=4)),  # only the time differs
        ("proposal", prop(5, 1, bid=RefBlockID(b"\x33" * 32, RefPSH(1, b"\x44" * 32)))),
        ("vote", vote(5, 0, PRECOMMIT_TYPE)),  # round regression
        ("vote", vote(4, 3, PRECOMMIT_TYPE)),  # height regression
        ("vote", vote(6, 0, PRECOMMIT_TYPE)),
    ]
    for kind, obj in steps:
        if kind == "vote":
            a = _outcome(lambda: ref.sign_vote(CHAIN, obj).encode())
            b = _outcome(lambda: port.sign_vote(CHAIN, Vote.decode(obj.encode())).encode())
        else:
            a = _outcome(lambda: ref.sign_proposal(CHAIN, obj).encode())
            b = _outcome(lambda: port.sign_proposal(CHAIN, Proposal.decode(obj.encode())).encode())
        assert a == b, (kind, obj)
        assert _read(pdir / "state.json") == _read(rdir / "state.json")
    # A restart reads the state back and keeps refusing.
    again = convert.file_pv_from_state_files(str(pdir / "key.json"), str(pdir / "state.json"))
    ref_again = RefFilePV.load(str(rdir / "key.json"), str(rdir / "state.json"))
    v = vote(5, 9, PREVOTE_TYPE)
    assert _outcome(lambda: again.sign_vote(CHAIN, Vote.decode(v.encode()))) == \
        _outcome(lambda: ref_again.sign_vote(CHAIN, v))


def test_file_pv_key_types(tmp_path):
    from cometbft_tpu_torch.privval.file import KEY_TYPES, FilePV

    (tmp_path / "bn").mkdir()
    ref = RefFilePV.generate(str(tmp_path / "bn" / "k.json"), str(tmp_path / "bn" / "s.json"),
                             key_type="bn254")
    ref.save()
    port = FilePV.load(str(tmp_path / "bn" / "k.json"), str(tmp_path / "bn" / "s.json"))
    assert port.priv_key.type() == "bn254"
    assert port.get_pub_key().bytes() == ref.get_pub_key().bytes()
    assert port.priv_key.sign(b"msg") == ref.priv_key.sign(b"msg")
    before = _read(tmp_path / "bn" / "k.json")
    port.save()
    assert _read(tmp_path / "bn" / "k.json") == before
    for kt in ("secp256k1", "sr25519"):
        d = tmp_path / kt
        d.mkdir()
        RefFilePV.generate(str(d / "k.json"), str(d / "s.json"), key_type=kt).save()
        with pytest.raises(ValueError, match=f"key type {kt} is not ported"):
            FilePV.load(str(d / "k.json"), str(d / "s.json"))
        with pytest.raises(ValueError, match=f"key type {kt} is not ported"):
            FilePV.generate(key_type=kt)
    assert KEY_TYPES == ("ed25519", "secp256k1", "sr25519", "bn254")
    with pytest.raises(ValueError) as e1:
        FilePV.generate(key_type="dilithium")
    with pytest.raises(ValueError) as e2:
        RefFilePV.generate(key_type="dilithium")
    assert str(e1.value) == str(e2.value)
    legacy = json.loads((tmp_path / "bn" / "k.json").read_text())
    legacy["priv_key"]["type"] = "tendermint/PrivKeyEd25519"
    legacy["priv_key"]["value"] = __import__("base64").b64encode(KEY.bytes()).decode()
    del legacy["priv_key"]["type"]
    (tmp_path / "bn" / "legacy.json").write_text(json.dumps(legacy))
    assert FilePV.load(str(tmp_path / "bn" / "legacy.json"), str(tmp_path / "none.json")
                       ).priv_key.type() == "ed25519"


# -- pubsub and the event bus ---------------------------------------------------

QUERIES = ["tm.event='Tx'", "note.text='to AND fro' AND tm.event='Tx'", "a='1' and b='2'",
           "cmd='BANDAGE'", "tx.height>41", "tx.height>=42", "tx.height>42", "tx.height<43",
           "tx.height<=42", "tx.height=42", "account.owner CONTAINS 'Ivan'",
           "account.owner EXISTS", "account.missing EXISTS", "transfer.recipient='addr2'",
           "tm.event='Tx' AND tx.height=5", "", "tm.event=", "=x", "height >>",
           "a='unterminated", "a ISH 'x'", r"a='x\'y'"]
ATTRS = [{"tm.event": ["Tx"]}, {"tm.event": ["NewBlock"]}, {},
         {"note.text": ["to AND fro"], "tm.event": ["Tx"]}, {"a": ["1"], "b": ["2"]},
         {"cmd": ["BANDAGE"]}, {"tx.height": ["42"]}, {"tx.height": ["not-a-number"]},
         {"account.owner": ["Ivan Ivanov"]}, {"transfer.recipient": ["addr1", "addr2"]},
         {"tm.event": ["Tx"], "tx.height": ["5"]}]


def test_query_language_equal():
    for text in QUERIES:
        port, ref = _outcome(lambda: Query(text)), _outcome(lambda: RefQuery(text))
        assert port[0] == ref[0], text
        if port[0] != "ok":
            assert port == ref
            continue
        assert [port[1].matches(a) for a in ATTRS] == [ref[1].matches(a) for a in ATTRS], text
        assert str(port[1]) == str(ref[1])


def _drain(sub):
    out = []
    while not sub.out.empty():
        out.append(sub.out.get_nowait())
    return out


def test_event_bus_typed_publishers():
    from cometbft_tpu.types import events as rev
    from cometbft_tpu_torch.types import events as pev

    buses = {"ref": (RefEventBus(), rev, RefQuery), "port": (EventBus(), pev, Query)}
    seen = {}
    for name, (bus, ev, Q) in buses.items():
        bus.start()
        subs = {q: bus.subscribe("s", Q(q), 100) for q in (
            "tm.event='Vote'", "tm.event='NewRoundStep'", "tm.event='Tx' AND tx.height=3",
            "app.key='k1'", "tm.event='ValidatorSetUpdates'")}
        rs = ev.EventDataRoundState(height=3, round=1, step="RoundStepPropose")
        bus.publish_new_round_step(rs)
        bus.publish_vote(ev.EventDataVote(vote="v"))
        for h in (2, 3):
            bus.publish_tx(ev.EventDataTx(height=h, tx=b"k1=v1", index=0, result=None),
                           events=[{"type": "app", "attributes": [{"key": "key", "value": "k1"}]}])
        bus.publish_validator_set_updates(ev.EventDataValidatorSetUpdates(validator_updates=[1]))
        for pub in ("publish_polka", "publish_lock", "publish_unlock", "publish_relock",
                    "publish_timeout_propose", "publish_timeout_wait", "publish_valid_block"):
            getattr(bus, pub)(rs)
        seen[name] = {q: [(m.events, type(m.data).__name__) for m in _drain(s)]
                      for q, s in subs.items()}
        assert bus.num_clients() == 1
        bus.unsubscribe_all("s")
        bus.stop()
    assert seen["port"] == seen["ref"]
    assert all(seen["port"].values())


def test_block_executor_publishes_the_reference_events():
    """One block of four kvstore transactions applied by each package's
    executor over its own node, each with an event bus subscribed to every
    event: the same event types, attributes and payload bytes."""
    import torch_chains as tc

    from cometbft_tpu.crypto import ed25519 as ref_ed2
    from cometbft_tpu.sidecar import backend as ref_backend
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.sidecar import backend

    chain = tc.build_ref_chain(b"events", n_vals=3, n_blocks=2, txs_per_block=4)
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.CpuBackend())
    try:
        from cometbft_tpu.types import BlockID as RBID
        from cometbft_tpu_torch.types.block import Block, BlockID

        out = {}
        raw = chain.blocks[0].encode()
        for name, node, bus, Q in (("ref", tc.ref_node(chain), RefEventBus(), RefQuery),
                                   ("port", tc.port_node(chain), EventBus(), Query)):
            bus.start()
            sub = bus.subscribe("all", Q(""), 1000)
            node.executor.event_bus = bus
            if name == "ref":
                block = chain.blocks[0]
                bid = RBID(block.hash(), block.make_part_set().header())
            else:
                block = Block.decode(raw)
                bid = BlockID(block.hash(), block.make_part_set().header())
            node.executor.apply_block(node.state, bid, block)
            out[name] = [(m.events, type(m.data).__name__, _payload(m.data))
                         for m in _drain(sub)]
            bus.stop()
        assert out["port"] == out["ref"]
        kinds = [e["tm.event"][0] for e, _, _ in out["port"]]
        assert kinds[:2] == ["NewBlock", "NewBlockHeader"] and kinds.count("Tx") == 4
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed2._verified.clear()
        ed25519._verified.clear()


def _payload(data):
    """What an event carries, as bytes where it has an encoding."""
    name = type(data).__name__
    if name == "EventDataNewBlock":
        return (data.block.encode(), data.block_id.encode())
    if name == "EventDataNewBlockHeader":
        return (data.header.encode(), data.num_txs)
    if name == "EventDataTx":
        return (data.height, data.tx, data.index, data.result.code, data.result.data)
    if name == "EventDataValidatorSetUpdates":
        return [(u.pub_key.bytes(), u.power) for u in data.validator_updates]
    return repr(data)
