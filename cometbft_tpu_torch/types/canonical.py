"""Canonical sign bytes (types/canonical.go and
proto/tendermint/types/canonical.proto), the port's copy of
``cometbft_tpu/types/canonical.py``.

The rules that matter on the wire:
height/round are sfixed64 (fixed-size so signing hardware can parse),
block_id is dropped entirely when zero (nil votes), the timestamp submessage
is always emitted (gogoproto non-nullable), and the result is
length-delimited (protoio MarshalDelimited — types/vote.go VoteSignBytes).
"""

from __future__ import annotations

from cometbft_tpu_torch.types.block import PROPOSAL_TYPE, BlockID, PartSetHeader
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.wire import proto as wire


def canonical_block_id_bytes(block_id: BlockID) -> bytes | None:
    """CanonicalizeBlockID (types/canonical.go:18-34): None when zero."""
    if block_id.is_zero():
        return None
    psh = wire.field_varint(1, block_id.part_set_header.total) + wire.field_bytes(
        2, block_id.part_set_header.hash
    )
    return wire.field_bytes(1, block_id.hash) + wire.field_message(
        2, psh, emit_empty=True
    )


def vote_sign_bytes_from_parts(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp: Time,
) -> bytes:
    """Length-delimited CanonicalVote (types/vote.go VoteSignBytes)."""
    out = wire.field_varint(1, msg_type)
    out += wire.field_sfixed64(2, height)
    out += wire.field_sfixed64(3, round_)
    cbid = canonical_block_id_bytes(block_id)
    if cbid is not None:
        out += wire.field_message(4, cbid, emit_empty=True)
    out += wire.field_message(5, timestamp.encode(), emit_empty=True)
    out += wire.field_string(6, chain_id)
    return wire.length_delimited(out)


def decode_canonical_vote(
    sign_bytes: bytes,
) -> tuple[int, int, int, BlockID, Time]:
    """Inverse of vote_sign_bytes_from_parts: (type, height, round, block_id,
    timestamp). The privval keeps only the sign bytes and signature of its
    last vote; crash recovery decodes them back into a Vote when the WAL
    lost the original (the privval syncs before the WAL does)."""
    n, pos = wire.decode_uvarint(sign_bytes, 0)
    body = sign_bytes[pos : pos + n]
    if len(body) != n:
        raise ValueError("truncated canonical vote")
    fields = wire.decode_fields(body)
    msg_type = wire.get_varint(fields, 1)
    height = wire.get_sfixed64(fields, 2)
    round_ = wire.get_sfixed64(fields, 3)
    block_id = BlockID()
    cbid = wire.get_bytes(fields, 4)
    if cbid:
        cf = wire.decode_fields(cbid)
        psh = PartSetHeader()
        psh_raw = wire.get_bytes(cf, 2)
        if psh_raw:
            pf = wire.decode_fields(psh_raw)
            psh = PartSetHeader(wire.get_varint(pf, 1), wire.get_bytes(pf, 2))
        block_id = BlockID(wire.get_bytes(cf, 1), psh)
    timestamp = Time.decode(wire.get_bytes(fields, 5))
    return msg_type, height, round_, block_id, timestamp


def proposal_sign_bytes_from_parts(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id: BlockID,
    timestamp: Time,
) -> bytes:
    """Length-delimited CanonicalProposal (types/proposal.go ProposalSignBytes)."""
    out = wire.field_varint(1, PROPOSAL_TYPE)
    out += wire.field_sfixed64(2, height)
    out += wire.field_sfixed64(3, round_)
    out += wire.field_varint(4, pol_round)
    cbid = canonical_block_id_bytes(block_id)
    if cbid is not None:
        out += wire.field_message(5, cbid, emit_empty=True)
    out += wire.field_message(6, timestamp.encode(), emit_empty=True)
    out += wire.field_string(7, chain_id)
    return wire.length_delimited(out)
