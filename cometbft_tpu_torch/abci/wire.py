"""ABCI wire codec: Request/Response oneof messages + varint framing
(proto/tendermint/abci/types.proto + abci/types/messages.go
WriteMessage/ReadMessage — gogoproto length-delimited framing), the port's
copy of ``cometbft_tpu/abci/wire.py``: the same bytes both ways.

Field numbers follow types.proto exactly (Request oneof :23-42, Response
oneof :156-176) so a conforming external app server can speak to this node.
Submessages reuse the hand-rolled codec in wire/proto.py and the existing
types-layer encoders (Header, ConsensusParams).
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.wire import proto as wire


# -- submessages -------------------------------------------------------------


def _enc_timestamp(seconds: int, nanos: int = 0) -> bytes:
    return wire.field_varint(1, seconds) + wire.field_varint(2, nanos)


def _dec_timestamp(data: bytes) -> int:
    f = wire.decode_fields(data)
    return wire.get_varint(f, 1)


def _enc_event_attr(a: abci.EventAttribute) -> bytes:
    return (
        wire.field_string(1, a.key)
        + wire.field_string(2, a.value)
        + wire.field_bool(3, a.index)
    )


def _dec_event_attr(data: bytes) -> abci.EventAttribute:
    f = wire.decode_fields(data)
    return abci.EventAttribute(
        key=wire.get_string(f, 1), value=wire.get_string(f, 2), index=wire.get_bool(f, 3)
    )


def _enc_event(e: abci.Event) -> bytes:
    out = wire.field_string(1, e.type)
    for a in e.attributes:
        out += wire.field_message(2, _enc_event_attr(a), emit_empty=True)
    return out


def _dec_event(data: bytes) -> abci.Event:
    f = wire.decode_fields(data)
    return abci.Event(
        type=wire.get_string(f, 1),
        attributes=[_dec_event_attr(b) for b in wire.get_repeated_bytes(f, 2)],
    )


def _enc_pub_key(pub) -> bytes:
    """crypto.proto PublicKey oneof: ed25519=1, secp256k1=2, bn254=3. The
    port has no secp256k1 key yet (ROADMAP §1 item 9)."""
    from cometbft_tpu_torch.crypto import bn254, ed25519

    if isinstance(pub, ed25519.PubKey):
        return wire.field_bytes(1, pub.bytes())
    if isinstance(pub, bn254.PubKey):
        return wire.field_bytes(3, pub.bytes())
    raise ValueError(f"unsupported pubkey type {type(pub)!r}")


def _dec_pub_key(data: bytes):
    from cometbft_tpu_torch.crypto import bn254, ed25519
    from cometbft_tpu_torch.crypto.encoding import not_ported

    f = wire.decode_fields(data)
    if 1 in f:
        return ed25519.PubKey(wire.get_bytes(f, 1))
    if 2 in f:
        raise not_ported("secp256k1")
    if 3 in f:
        return bn254.PubKey(wire.get_bytes(f, 3))
    raise ValueError("empty PublicKey")


def _enc_validator_update(vu: abci.ValidatorUpdate) -> bytes:
    return wire.field_message(
        1, _enc_pub_key(vu.pub_key), emit_empty=True
    ) + wire.field_varint(2, vu.power)


def _dec_validator_update(data: bytes) -> abci.ValidatorUpdate:
    f = wire.decode_fields(data)
    return abci.ValidatorUpdate(
        pub_key=_dec_pub_key(wire.get_bytes(f, 1)), power=wire.get_varint(f, 2)
    )


def _enc_vote_info(v: abci.VoteInfo) -> bytes:
    val = wire.field_bytes(1, v.validator_address) + wire.field_varint(
        2, v.validator_power
    )
    return wire.field_message(1, val, emit_empty=True) + wire.field_bool(
        2, v.signed_last_block
    )


def _dec_vote_info(data: bytes) -> abci.VoteInfo:
    f = wire.decode_fields(data)
    vf = wire.decode_fields(wire.get_bytes(f, 1))
    return abci.VoteInfo(
        validator_address=wire.get_bytes(vf, 1),
        validator_power=wire.get_varint(vf, 2),
        signed_last_block=wire.get_bool(f, 2),
    )


def _enc_commit_info(ci: abci.CommitInfo) -> bytes:
    out = wire.field_varint(1, ci.round)
    for v in ci.votes:
        out += wire.field_message(2, _enc_vote_info(v), emit_empty=True)
    return out


def _dec_commit_info(data: bytes) -> abci.CommitInfo:
    f = wire.decode_fields(data)
    return abci.CommitInfo(
        round=wire.get_varint(f, 1),
        votes=[_dec_vote_info(b) for b in wire.get_repeated_bytes(f, 2)],
    )


def _enc_misbehavior(m: abci.Misbehavior) -> bytes:
    val = wire.field_bytes(1, m.validator_address) + wire.field_varint(
        2, m.validator_power
    )
    return (
        wire.field_varint(1, m.type)
        + wire.field_message(2, val, emit_empty=True)
        + wire.field_varint(3, m.height)
        + wire.field_message(4, _enc_timestamp(m.time_seconds), emit_empty=True)
        + wire.field_varint(5, m.total_voting_power)
    )


def _dec_misbehavior(data: bytes) -> abci.Misbehavior:
    f = wire.decode_fields(data)
    vf = wire.decode_fields(wire.get_bytes(f, 2))
    return abci.Misbehavior(
        type=wire.get_varint(f, 1),
        validator_address=wire.get_bytes(vf, 1),
        validator_power=wire.get_varint(vf, 2),
        height=wire.get_varint(f, 3),
        time_seconds=_dec_timestamp(wire.get_bytes(f, 4)),
        total_voting_power=wire.get_varint(f, 5),
    )


def _enc_snapshot(s: abci.Snapshot) -> bytes:
    return (
        wire.field_varint(1, s.height)
        + wire.field_varint(2, s.format)
        + wire.field_varint(3, s.chunks)
        + wire.field_bytes(4, s.hash)
        + wire.field_bytes(5, s.metadata)
    )


def _dec_snapshot(data: bytes) -> abci.Snapshot:
    f = wire.decode_fields(data)
    return abci.Snapshot(
        height=wire.get_uvarint(f, 1),
        format=wire.get_uvarint(f, 2),
        chunks=wire.get_uvarint(f, 3),
        hash=wire.get_bytes(f, 4),
        metadata=wire.get_bytes(f, 5),
    )


def _enc_proof_ops(ops: list) -> bytes:
    out = b""
    for op in ops:
        body = (
            wire.field_string(1, op.type)
            + wire.field_bytes(2, op.key)
            + wire.field_bytes(3, op.data)
        )
        out += wire.field_message(1, body, emit_empty=True)
    return out


def _dec_proof_ops(data: bytes) -> list:
    from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOp

    f = wire.decode_fields(data)
    out = []
    for b in wire.get_repeated_bytes(f, 1):
        of = wire.decode_fields(b)
        out.append(
            ProofOp(
                type=wire.get_string(of, 1),
                key=wire.get_bytes(of, 2),
                data=wire.get_bytes(of, 3),
            )
        )
    return out


def _enc_params(params) -> bytes | None:
    if params is None:
        return None
    return params.encode()


def _dec_params(data: bytes):
    if not data:
        return None
    from cometbft_tpu_torch.types.params import ConsensusParams

    return ConsensusParams.decode(data)


def _dec_header(data: bytes):
    from cometbft_tpu_torch.types.block import Header

    return Header.decode(data)


# -- request bodies ----------------------------------------------------------


def _enc_req_body(req) -> bytes:
    t = type(req).__name__
    if t == "RequestEcho":
        return wire.field_string(1, req.message)
    if t in ("RequestFlush", "RequestCommit", "RequestListSnapshots"):
        return b""
    if t == "RequestInfo":
        return (
            wire.field_string(1, req.version)
            + wire.field_varint(2, req.block_version)
            + wire.field_varint(3, req.p2p_version)
            + wire.field_string(4, req.abci_version)
        )
    if t == "RequestInitChain":
        out = wire.field_message(1, _enc_timestamp(req.time_seconds), emit_empty=True)
        out += wire.field_string(2, req.chain_id)
        out += wire.field_message(3, _enc_params(req.consensus_params))
        for vu in req.validators:
            out += wire.field_message(4, _enc_validator_update(vu), emit_empty=True)
        out += wire.field_bytes(5, req.app_state_bytes)
        out += wire.field_varint(6, req.initial_height)
        return out
    if t == "RequestQuery":
        return (
            wire.field_bytes(1, req.data)
            + wire.field_string(2, req.path)
            + wire.field_varint(3, req.height)
            + wire.field_bool(4, req.prove)
        )
    if t == "RequestBeginBlock":
        out = wire.field_bytes(1, req.hash)
        out += wire.field_message(
            2, req.header.encode() if req.header else b"", emit_empty=True
        )
        out += wire.field_message(3, _enc_commit_info(req.last_commit_info), emit_empty=True)
        for m in req.byzantine_validators:
            out += wire.field_message(4, _enc_misbehavior(m), emit_empty=True)
        return out
    if t == "RequestCheckTx":
        return wire.field_bytes(1, req.tx) + wire.field_varint(2, req.type)
    if t == "RequestDeliverTx":
        return wire.field_bytes(1, req.tx)
    if t == "RequestEndBlock":
        return wire.field_varint(1, req.height)
    if t == "RequestOfferSnapshot":
        return wire.field_message(
            1, _enc_snapshot(req.snapshot) if req.snapshot else None
        ) + wire.field_bytes(2, req.app_hash)
    if t == "RequestLoadSnapshotChunk":
        return (
            wire.field_varint(1, req.height)
            + wire.field_varint(2, req.format)
            + wire.field_varint(3, req.chunk)
        )
    if t == "RequestApplySnapshotChunk":
        return (
            wire.field_varint(1, req.index)
            + wire.field_bytes(2, req.chunk)
            + wire.field_string(3, req.sender)
        )
    if t == "RequestPrepareProposal":
        out = wire.field_varint(1, req.max_tx_bytes)
        for tx in req.txs:
            out += wire.field_bytes(2, tx, emit_default=True)
        out += wire.field_message(3, _enc_commit_info(req.local_last_commit), emit_empty=True)
        for m in req.misbehavior:
            out += wire.field_message(4, _enc_misbehavior(m), emit_empty=True)
        out += wire.field_varint(5, req.height)
        out += wire.field_message(6, _enc_timestamp(req.time_seconds), emit_empty=True)
        out += wire.field_bytes(7, req.next_validators_hash)
        out += wire.field_bytes(8, req.proposer_address)
        return out
    if t == "RequestProcessProposal":
        out = b""
        for tx in req.txs:
            out += wire.field_bytes(1, tx, emit_default=True)
        out += wire.field_message(2, _enc_commit_info(req.proposed_last_commit), emit_empty=True)
        for m in req.misbehavior:
            out += wire.field_message(3, _enc_misbehavior(m), emit_empty=True)
        out += wire.field_bytes(4, req.hash)
        out += wire.field_varint(5, req.height)
        out += wire.field_message(6, _enc_timestamp(req.time_seconds), emit_empty=True)
        out += wire.field_bytes(7, req.next_validators_hash)
        out += wire.field_bytes(8, req.proposer_address)
        return out
    raise ValueError(f"unknown request type {t}")


_REQ_FIELDS = {
    "RequestEcho": 1,
    "RequestFlush": 2,
    "RequestInfo": 3,
    "RequestInitChain": 5,
    "RequestQuery": 6,
    "RequestBeginBlock": 7,
    "RequestCheckTx": 8,
    "RequestDeliverTx": 9,
    "RequestEndBlock": 10,
    "RequestCommit": 11,
    "RequestListSnapshots": 12,
    "RequestOfferSnapshot": 13,
    "RequestLoadSnapshotChunk": 14,
    "RequestApplySnapshotChunk": 15,
    "RequestPrepareProposal": 16,
    "RequestProcessProposal": 17,
}
_REQ_BY_FIELD = {v: k for k, v in _REQ_FIELDS.items()}


def encode_request(req) -> bytes:
    """Request oneof (types.proto:22-42)."""
    num = _REQ_FIELDS[type(req).__name__]
    return wire.field_message(num, _enc_req_body(req), emit_empty=True)


def decode_request(data: bytes):
    f = wire.decode_fields(data)
    for num, name in _REQ_BY_FIELD.items():
        if num in f:
            return _dec_req_body(name, wire.get_bytes(f, num))
    raise ValueError("empty Request")


def _dec_req_body(name: str, data: bytes):
    f = wire.decode_fields(data)
    if name == "RequestEcho":
        return abci.RequestEcho(message=wire.get_string(f, 1))
    if name == "RequestFlush":
        return abci.RequestFlush()
    if name == "RequestInfo":
        return abci.RequestInfo(
            version=wire.get_string(f, 1),
            block_version=wire.get_uvarint(f, 2),
            p2p_version=wire.get_uvarint(f, 3),
            abci_version=wire.get_string(f, 4),
        )
    if name == "RequestInitChain":
        return abci.RequestInitChain(
            time_seconds=_dec_timestamp(wire.get_bytes(f, 1)),
            chain_id=wire.get_string(f, 2),
            consensus_params=_dec_params(wire.get_bytes(f, 3)),
            validators=[_dec_validator_update(b) for b in wire.get_repeated_bytes(f, 4)],
            app_state_bytes=wire.get_bytes(f, 5),
            initial_height=wire.get_varint(f, 6),
        )
    if name == "RequestQuery":
        return abci.RequestQuery(
            data=wire.get_bytes(f, 1),
            path=wire.get_string(f, 2),
            height=wire.get_varint(f, 3),
            prove=wire.get_bool(f, 4),
        )
    if name == "RequestBeginBlock":
        hdr = wire.get_bytes(f, 2)
        return abci.RequestBeginBlock(
            hash=wire.get_bytes(f, 1),
            header=_dec_header(hdr) if hdr else None,
            last_commit_info=_dec_commit_info(wire.get_bytes(f, 3)),
            byzantine_validators=[
                _dec_misbehavior(b) for b in wire.get_repeated_bytes(f, 4)
            ],
        )
    if name == "RequestCheckTx":
        return abci.RequestCheckTx(tx=wire.get_bytes(f, 1), type=wire.get_varint(f, 2))
    if name == "RequestDeliverTx":
        return abci.RequestDeliverTx(tx=wire.get_bytes(f, 1))
    if name == "RequestEndBlock":
        return abci.RequestEndBlock(height=wire.get_varint(f, 1))
    if name == "RequestCommit":
        return abci.RequestCommit()
    if name == "RequestListSnapshots":
        return abci.RequestListSnapshots()
    if name == "RequestOfferSnapshot":
        snap = wire.get_bytes(f, 1)
        return abci.RequestOfferSnapshot(
            snapshot=_dec_snapshot(snap) if snap else None,
            app_hash=wire.get_bytes(f, 2),
        )
    if name == "RequestLoadSnapshotChunk":
        return abci.RequestLoadSnapshotChunk(
            height=wire.get_uvarint(f, 1),
            format=wire.get_uvarint(f, 2),
            chunk=wire.get_uvarint(f, 3),
        )
    if name == "RequestApplySnapshotChunk":
        return abci.RequestApplySnapshotChunk(
            index=wire.get_uvarint(f, 1),
            chunk=wire.get_bytes(f, 2),
            sender=wire.get_string(f, 3),
        )
    if name == "RequestPrepareProposal":
        return abci.RequestPrepareProposal(
            max_tx_bytes=wire.get_varint(f, 1),
            txs=wire.get_repeated_bytes(f, 2),
            local_last_commit=_dec_commit_info(wire.get_bytes(f, 3)),
            misbehavior=[_dec_misbehavior(b) for b in wire.get_repeated_bytes(f, 4)],
            height=wire.get_varint(f, 5),
            time_seconds=_dec_timestamp(wire.get_bytes(f, 6)),
            next_validators_hash=wire.get_bytes(f, 7),
            proposer_address=wire.get_bytes(f, 8),
        )
    if name == "RequestProcessProposal":
        return abci.RequestProcessProposal(
            txs=wire.get_repeated_bytes(f, 1),
            proposed_last_commit=_dec_commit_info(wire.get_bytes(f, 2)),
            misbehavior=[_dec_misbehavior(b) for b in wire.get_repeated_bytes(f, 3)],
            hash=wire.get_bytes(f, 4),
            height=wire.get_varint(f, 5),
            time_seconds=_dec_timestamp(wire.get_bytes(f, 6)),
            next_validators_hash=wire.get_bytes(f, 7),
            proposer_address=wire.get_bytes(f, 8),
        )
    raise ValueError(f"unknown request name {name}")


# -- response bodies ---------------------------------------------------------


def _enc_events(num: int, events: list) -> bytes:
    out = b""
    for e in events:
        out += wire.field_message(num, _enc_event(e), emit_empty=True)
    return out


def _enc_resp_body(resp) -> bytes:
    t = type(resp).__name__
    if t == "ResponseException":
        return wire.field_string(1, resp.error)
    if t == "ResponseEcho":
        return wire.field_string(1, resp.message)
    if t == "ResponseFlush":
        return b""
    if t == "ResponseInfo":
        return (
            wire.field_string(1, resp.data)
            + wire.field_string(2, resp.version)
            + wire.field_varint(3, resp.app_version)
            + wire.field_varint(4, resp.last_block_height)
            + wire.field_bytes(5, resp.last_block_app_hash)
        )
    if t == "ResponseInitChain":
        out = wire.field_message(1, _enc_params(resp.consensus_params))
        for vu in resp.validators:
            out += wire.field_message(2, _enc_validator_update(vu), emit_empty=True)
        out += wire.field_bytes(3, resp.app_hash)
        return out
    if t == "ResponseQuery":
        return (
            wire.field_varint(1, resp.code)
            + wire.field_string(3, resp.log)
            + wire.field_string(4, resp.info)
            + wire.field_varint(5, resp.index)
            + wire.field_bytes(6, resp.key)
            + wire.field_bytes(7, resp.value)
            + wire.field_message(8, _enc_proof_ops(resp.proof_ops) if resp.proof_ops else None)
            + wire.field_varint(9, resp.height)
            + wire.field_string(10, resp.codespace)
        )
    if t == "ResponseBeginBlock":
        return _enc_events(1, resp.events)
    if t in ("ResponseCheckTx", "ResponseDeliverTx"):
        return (
            wire.field_varint(1, resp.code)
            + wire.field_bytes(2, resp.data)
            + wire.field_string(3, resp.log)
            + wire.field_string(4, resp.info)
            + wire.field_varint(5, resp.gas_wanted)
            + wire.field_varint(6, resp.gas_used)
            + _enc_events(7, resp.events)
            + wire.field_string(8, resp.codespace)
        )
    if t == "ResponseEndBlock":
        out = b""
        for vu in resp.validator_updates:
            out += wire.field_message(1, _enc_validator_update(vu), emit_empty=True)
        out += wire.field_message(2, _enc_params(resp.consensus_param_updates))
        out += _enc_events(3, resp.events)
        return out
    if t == "ResponseCommit":
        return wire.field_bytes(2, resp.data) + wire.field_varint(3, resp.retain_height)
    if t == "ResponseListSnapshots":
        out = b""
        for s in resp.snapshots:
            out += wire.field_message(1, _enc_snapshot(s), emit_empty=True)
        return out
    if t == "ResponseOfferSnapshot":
        return wire.field_varint(1, resp.result)
    if t == "ResponseLoadSnapshotChunk":
        return wire.field_bytes(1, resp.chunk)
    if t == "ResponseApplySnapshotChunk":
        out = wire.field_varint(1, resp.result)
        for c in resp.refetch_chunks:
            out += wire.field_varint(2, c, emit_default=True)
        for s in resp.reject_senders:
            out += wire.field_string(3, s, emit_default=True)
        return out
    if t == "ResponsePrepareProposal":
        out = b""
        for tx in resp.txs:
            out += wire.field_bytes(1, tx, emit_default=True)
        return out
    if t == "ResponseProcessProposal":
        return wire.field_varint(1, resp.status)
    raise ValueError(f"unknown response type {t}")


_RESP_FIELDS = {
    "ResponseException": 1,
    "ResponseEcho": 2,
    "ResponseFlush": 3,
    "ResponseInfo": 4,
    "ResponseInitChain": 6,
    "ResponseQuery": 7,
    "ResponseBeginBlock": 8,
    "ResponseCheckTx": 9,
    "ResponseDeliverTx": 10,
    "ResponseEndBlock": 11,
    "ResponseCommit": 12,
    "ResponseListSnapshots": 13,
    "ResponseOfferSnapshot": 14,
    "ResponseLoadSnapshotChunk": 15,
    "ResponseApplySnapshotChunk": 16,
    "ResponsePrepareProposal": 17,
    "ResponseProcessProposal": 18,
}
_RESP_BY_FIELD = {v: k for k, v in _RESP_FIELDS.items()}


def encode_response(resp) -> bytes:
    num = _RESP_FIELDS[type(resp).__name__]
    return wire.field_message(num, _enc_resp_body(resp), emit_empty=True)


def decode_response(data: bytes):
    f = wire.decode_fields(data)
    for num, name in _RESP_BY_FIELD.items():
        if num in f:
            return _dec_resp_body(name, wire.get_bytes(f, num))
    raise ValueError("empty Response")


def _dec_resp_body(name: str, data: bytes):
    f = wire.decode_fields(data)
    if name == "ResponseException":
        return abci.ResponseException(error=wire.get_string(f, 1))
    if name == "ResponseEcho":
        return abci.ResponseEcho(message=wire.get_string(f, 1))
    if name == "ResponseFlush":
        return abci.ResponseFlush()
    if name == "ResponseInfo":
        return abci.ResponseInfo(
            data=wire.get_string(f, 1),
            version=wire.get_string(f, 2),
            app_version=wire.get_uvarint(f, 3),
            last_block_height=wire.get_varint(f, 4),
            last_block_app_hash=wire.get_bytes(f, 5),
        )
    if name == "ResponseInitChain":
        return abci.ResponseInitChain(
            consensus_params=_dec_params(wire.get_bytes(f, 1)),
            validators=[_dec_validator_update(b) for b in wire.get_repeated_bytes(f, 2)],
            app_hash=wire.get_bytes(f, 3),
        )
    if name == "ResponseQuery":
        proof = wire.get_bytes(f, 8)
        return abci.ResponseQuery(
            code=wire.get_uvarint(f, 1),
            log=wire.get_string(f, 3),
            info=wire.get_string(f, 4),
            index=wire.get_varint(f, 5),
            key=wire.get_bytes(f, 6),
            value=wire.get_bytes(f, 7),
            proof_ops=_dec_proof_ops(proof) if proof else [],
            height=wire.get_varint(f, 9),
            codespace=wire.get_string(f, 10),
        )
    if name == "ResponseBeginBlock":
        return abci.ResponseBeginBlock(
            events=[_dec_event(b) for b in wire.get_repeated_bytes(f, 1)]
        )
    if name in ("ResponseCheckTx", "ResponseDeliverTx"):
        cls = abci.ResponseCheckTx if name == "ResponseCheckTx" else abci.ResponseDeliverTx
        return cls(
            code=wire.get_uvarint(f, 1),
            data=wire.get_bytes(f, 2),
            log=wire.get_string(f, 3),
            info=wire.get_string(f, 4),
            gas_wanted=wire.get_varint(f, 5),
            gas_used=wire.get_varint(f, 6),
            events=[_dec_event(b) for b in wire.get_repeated_bytes(f, 7)],
            codespace=wire.get_string(f, 8),
        )
    if name == "ResponseEndBlock":
        params = wire.get_bytes(f, 2)
        return abci.ResponseEndBlock(
            validator_updates=[
                _dec_validator_update(b) for b in wire.get_repeated_bytes(f, 1)
            ],
            consensus_param_updates=_dec_params(params),
            events=[_dec_event(b) for b in wire.get_repeated_bytes(f, 3)],
        )
    if name == "ResponseCommit":
        return abci.ResponseCommit(
            data=wire.get_bytes(f, 2), retain_height=wire.get_varint(f, 3)
        )
    if name == "ResponseListSnapshots":
        return abci.ResponseListSnapshots(
            snapshots=[_dec_snapshot(b) for b in wire.get_repeated_bytes(f, 1)]
        )
    if name == "ResponseOfferSnapshot":
        return abci.ResponseOfferSnapshot(result=wire.get_varint(f, 1))
    if name == "ResponseLoadSnapshotChunk":
        return abci.ResponseLoadSnapshotChunk(chunk=wire.get_bytes(f, 1))
    if name == "ResponseApplySnapshotChunk":
        return abci.ResponseApplySnapshotChunk(
            result=wire.get_varint(f, 1),
            refetch_chunks=wire.get_repeated_uvarint(f, 2),
            reject_senders=[b.decode() for b in wire.get_repeated_bytes(f, 3)],
        )
    if name == "ResponsePrepareProposal":
        return abci.ResponsePrepareProposal(txs=wire.get_repeated_bytes(f, 1))
    if name == "ResponseProcessProposal":
        return abci.ResponseProcessProposal(status=wire.get_varint(f, 1))
    raise ValueError(f"unknown response name {name}")


# -- stream framing ----------------------------------------------------------


def write_message(sock_file, msg_bytes: bytes) -> None:
    """gogoproto length-delimited: uvarint byte length then the message
    (abci/types/messages.go WriteMessage)."""
    sock_file.write(wire.encode_uvarint(len(msg_bytes)) + msg_bytes)


def read_message(sock_file) -> bytes | None:
    """Counterpart of write_message; None on clean EOF."""
    shift = 0
    length = 0
    while True:
        b = sock_file.read(1)
        if not b:
            return None
        length |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint length overflow")
    if length > 256 * 1024 * 1024:
        raise ValueError(f"message too large: {length}")
    data = b""
    while len(data) < length:
        chunk = sock_file.read(length - len(data))
        if not chunk:
            raise EOFError("short read inside message")
        data += chunk
    return data
