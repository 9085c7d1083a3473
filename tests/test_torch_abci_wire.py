"""The ABCI wire codec of the port (``cometbft_tpu_torch/abci/wire.py``) held
to the JAX package's: every Request and Response type encodes to the same
bytes, each package decodes the other's, the varint framing is the same, and
the JAX package's fuzz corpora (``tests/test_decode_fuzz.py``'s seeds and
mutations) raise the same error family in both, never ``TypeError``."""

import io
import random
import types

import pytest

import cometbft_tpu.abci.types as ref_abci
from cometbft_tpu.abci import wire as ref_aw
from cometbft_tpu.crypto import bn254 as ref_bn254
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto.merkle import ProofOp as RefProofOp
from cometbft_tpu.types.block import Header as RefHeader
from cometbft_tpu.types.params import ConsensusParams as RefParams
import cometbft_tpu_torch.abci.types as abci
from cometbft_tpu_torch.abci import wire as aw
from cometbft_tpu_torch.crypto import bn254
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOp
from cometbft_tpu_torch.types.block import Header
from cometbft_tpu_torch.types.params import ConsensusParams

pytestmark = pytest.mark.torch_port

# test_decode_fuzz.py's family: a decoder never raises TypeError.
_DecodeError = (ValueError, KeyError, IndexError, OverflowError)

PKGS = {
    "port": types.SimpleNamespace(abci=abci, aw=aw, ed=ed25519, bn254=bn254, ProofOp=ProofOp,
                                  Header=Header, Params=ConsensusParams),
    "reference": types.SimpleNamespace(abci=ref_abci, aw=ref_aw, ed=ref_ed, bn254=ref_bn254,
                                       ProofOp=RefProofOp, Header=RefHeader, Params=RefParams),
}


def _requests(p):
    """test_abci_socket.py's requests, built in package ``p``."""
    a = p.abci
    pub = p.ed.gen_priv_key_from_secret(b"abci-wire").pub_key()
    bls = p.bn254.PubKey(b"\x07" * p.bn254.PUB_KEY_SIZE)
    ci = a.CommitInfo(round=2, votes=[
        a.VoteInfo(validator_address=b"\x01" * 20, validator_power=10, signed_last_block=True),
        a.VoteInfo(validator_address=b"\x02" * 20, validator_power=3)])
    mb = a.Misbehavior(type=a.MISBEHAVIOR_DUPLICATE_VOTE, validator_address=b"\x03" * 20,
                       validator_power=7, height=11, time_seconds=1700000000,
                       total_voting_power=13)
    return [
        a.RequestEcho(message="hello"),
        a.RequestFlush(),
        a.RequestInfo(version="0.37", block_version=11, p2p_version=8, abci_version="1.0"),
        a.RequestInitChain(time_seconds=1700000000, chain_id="t", consensus_params=p.Params(),
                           validators=[a.ValidatorUpdate(pub_key=pub, power=5),
                                       a.ValidatorUpdate(pub_key=bls, power=2)],
                           app_state_bytes=b"{}", initial_height=1),
        a.RequestInitChain(),
        a.RequestQuery(data=b"k", path="/store", height=3, prove=True),
        a.RequestBeginBlock(hash=b"\xaa" * 32, header=p.Header(chain_id="t", height=9),
                            last_commit_info=ci, byzantine_validators=[mb]),
        a.RequestBeginBlock(),
        a.RequestCheckTx(tx=b"tx1", type=a.CHECK_TX_TYPE_RECHECK),
        a.RequestDeliverTx(tx=b"tx2"),
        a.RequestEndBlock(height=9),
        a.RequestCommit(),
        a.RequestListSnapshots(),
        a.RequestOfferSnapshot(snapshot=a.Snapshot(height=8, format=1, chunks=3, hash=b"h",
                                                   metadata=b"m"), app_hash=b"\xbb" * 32),
        a.RequestOfferSnapshot(),
        a.RequestLoadSnapshotChunk(height=8, format=1, chunk=2),
        a.RequestApplySnapshotChunk(index=2, chunk=b"data", sender="p1"),
        a.RequestPrepareProposal(max_tx_bytes=1000, txs=[b"a", b"", b"b"], local_last_commit=ci,
                                 misbehavior=[mb], height=9, time_seconds=1700000001,
                                 next_validators_hash=b"\xcc" * 32,
                                 proposer_address=b"\x04" * 20),
        a.RequestProcessProposal(txs=[b"a"], proposed_last_commit=ci, misbehavior=[],
                                 hash=b"\xdd" * 32, height=9, time_seconds=1700000002,
                                 next_validators_hash=b"\xee" * 32,
                                 proposer_address=b"\x05" * 20),
    ]


def _responses(p):
    a = p.abci
    pub = p.ed.gen_priv_key_from_secret(b"abci-wire2").pub_key()
    ev = a.Event(type="transfer",
                 attributes=[a.EventAttribute(key="amount", value="7", index=True),
                             a.EventAttribute(key="to", value="")])
    return [
        a.ResponseException(error="boom"),
        a.ResponseEcho(message="hi"),
        a.ResponseFlush(),
        a.ResponseInfo(data="kv", version="1", app_version=2, last_block_height=10,
                       last_block_app_hash=b"\x01" * 32),
        a.ResponseInitChain(consensus_params=p.Params(),
                            validators=[a.ValidatorUpdate(pub_key=pub, power=1)],
                            app_hash=b"\x02" * 32),
        a.ResponseInitChain(),
        a.ResponseQuery(code=0, log="l", info="i", index=4, key=b"k", value=b"v",
                        proof_ops=[p.ProofOp(type="simple:v", key=b"k", data=b"pf"),
                                   p.ProofOp(type="x", key=b"", data=b"")],
                        height=9, codespace="cs"),
        a.ResponseQuery(code=6, log="does not exist"),
        a.ResponseBeginBlock(events=[ev, a.Event(type="empty")]),
        a.ResponseCheckTx(code=1, data=b"d", log="l", info="i", gas_wanted=5, gas_used=3,
                          events=[ev], codespace="cs"),
        a.ResponseDeliverTx(code=0, data=b"ok", events=[ev]),
        a.ResponseEndBlock(validator_updates=[a.ValidatorUpdate(pub_key=pub, power=9),
                                              a.ValidatorUpdate(pub_key=pub, power=0)],
                           consensus_param_updates=p.Params(), events=[ev]),
        a.ResponseEndBlock(),
        a.ResponseCommit(data=b"\x03" * 32, retain_height=5),
        a.ResponseListSnapshots(snapshots=[a.Snapshot(height=4, format=1, chunks=2, hash=b"h"),
                                           a.Snapshot(height=8, format=1, chunks=1)]),
        a.ResponseOfferSnapshot(result=a.OFFER_SNAPSHOT_ACCEPT),
        a.ResponseOfferSnapshot(result=a.OFFER_SNAPSHOT_REJECT_FORMAT),
        a.ResponseLoadSnapshotChunk(chunk=b"chunk"),
        a.ResponseApplySnapshotChunk(result=a.APPLY_CHUNK_RETRY, refetch_chunks=[0, 1, 3],
                                     reject_senders=["p2", ""]),
        a.ResponsePrepareProposal(txs=[b"a", b"b"]),
        a.ResponseProcessProposal(status=a.PROCESS_PROPOSAL_ACCEPT),
    ]


def _ids(msgs):
    return [f"{i}-{type(m).__name__}" for i, m in enumerate(msgs)]


@pytest.mark.parametrize("i", range(len(_requests(PKGS["port"]))),
                         ids=_ids(_requests(PKGS["port"])))
def test_request_bytes_equal_both_ways(i):
    req, ref_req = _requests(PKGS["port"])[i], _requests(PKGS["reference"])[i]
    got, want = aw.encode_request(req), ref_aw.encode_request(ref_req)
    assert got == want
    assert aw.decode_request(want) == req
    assert ref_aw.decode_request(got) == ref_req
    assert aw.encode_request(aw.decode_request(want)) == want


@pytest.mark.parametrize("i", range(len(_responses(PKGS["port"]))),
                         ids=_ids(_responses(PKGS["port"])))
def test_response_bytes_equal_both_ways(i):
    resp, ref_resp = _responses(PKGS["port"])[i], _responses(PKGS["reference"])[i]
    got, want = aw.encode_response(resp), ref_aw.encode_response(ref_resp)
    assert got == want
    assert aw.decode_response(want) == resp
    assert ref_aw.decode_response(got) == ref_resp
    # The gRPC transport carries the inner bodies: the same bytes too.
    assert aw._enc_resp_body(resp) == ref_aw._enc_resp_body(ref_resp)


def test_framing_is_the_same():
    msgs = [aw.encode_request(r) for r in _requests(PKGS["port"])] + [b"", b"x" * 300]
    buf, ref_buf = io.BytesIO(), io.BytesIO()
    for m in msgs:
        aw.write_message(buf, m)
        ref_aw.write_message(ref_buf, m)
    assert buf.getvalue() == ref_buf.getvalue()
    buf.seek(0)
    assert [aw.read_message(buf) for _ in msgs] == msgs
    assert aw.read_message(buf) is None
    for bad in (b"\x05ab", b"\xff" * 11, b"\x80\x80\x80\x80\x80\x80\x80\x80\x80\x80\x01",
                b"\x80\x80\x80\x80\x02"):
        outcome = []
        for codec in (aw, ref_aw):
            try:
                outcome.append(("ok", codec.read_message(io.BytesIO(bad))))
            except (ValueError, EOFError) as e:
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1], bad


def test_unknown_and_unsupported_raise_the_same():
    for data in (b"", b"\xfa\x01\x00"):
        for dec in ("decode_request", "decode_response"):
            with pytest.raises(ValueError) as got:
                getattr(aw, dec)(data)
            with pytest.raises(ValueError) as want:
                getattr(ref_aw, dec)(data)
            assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unsupported pubkey type"):
        aw._enc_pub_key(object())
    # A secp256k1 key (field 2) is not ported: refused in the same family.
    with pytest.raises(ValueError, match="secp256k1 is not ported"):
        aw._dec_pub_key(b"\x12\x21" + b"\x02" * 33)


# -- the fuzz corpora of tests/test_decode_fuzz.py ---------------------------------


def _corpus(seed: int, n: int = 300):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        size = rng.choice([0, 1, 2, 7, 33, 120, 1000])
        out.append(bytes(rng.getrandbits(8) for _ in range(size)))
    return out


def _mutations(valid: bytes, seed: int, n: int = 200):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        b = bytearray(valid)
        op = rng.randrange(3)
        if op == 0 and b:
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
        elif op == 1 and b:
            del b[rng.randrange(len(b)):]
        else:
            i = rng.randrange(len(b) + 1)
            b[i:i] = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 9)))
        out.append(bytes(b))
    return out


def _outcome(decode, encode, blob):
    try:
        msg = decode(blob)
    except _DecodeError as e:
        return ("error", type(e).__name__)
    return ("ok", encode(msg))


def _same_outcomes(kind: str, blobs):
    dec, enc = getattr(aw, f"decode_{kind}"), getattr(aw, f"encode_{kind}")
    ref_dec, ref_enc = getattr(ref_aw, f"decode_{kind}"), getattr(ref_aw, f"encode_{kind}")
    errors = 0
    for blob in blobs:
        got, want = _outcome(dec, enc, blob), _outcome(ref_dec, ref_enc, blob)
        assert got[0] == want[0], (blob.hex(), got, want)
        if got[0] == "ok":
            assert got[1] == want[1], blob.hex()
        else:
            errors += 1
    return errors


@pytest.mark.parametrize("kind,seeds,valid", [
    ("request", (9, 10), lambda a: a.RequestCheckTx(tx=b"k=v")),
    ("response", (11, 12), lambda a: a.ResponseCheckTx(code=1, data=b"d", log="l")),
], ids=["request", "response"])
def test_fuzz_corpora_raise_the_same_family(kind, seeds, valid):
    blob = getattr(aw, f"encode_{kind}")(valid(abci))
    assert blob == getattr(ref_aw, f"encode_{kind}")(valid(ref_abci))
    errors = _same_outcomes(kind, _corpus(seeds[0]) + _mutations(blob, seeds[1]))
    assert errors > 0


@pytest.mark.parametrize("kind", ["request", "response"])
def test_mutations_of_every_type_raise_the_same_family(kind):
    msgs = _requests(PKGS["port"]) if kind == "request" else _responses(PKGS["port"])
    enc = getattr(aw, f"encode_{kind}")
    blobs = []
    for i, m in enumerate(msgs):
        blobs += _mutations(enc(m), 1000 + i, 40)
    _same_outcomes(kind, blobs)
