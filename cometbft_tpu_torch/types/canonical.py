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

from cometbft_tpu_torch.types.block import PROPOSAL_TYPE, BlockID
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
