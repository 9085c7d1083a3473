"""Consensus messages (consensus/msgs.go + proto/tendermint/consensus), the
port's copy of ``cometbft_tpu/consensus/messages.py``.

Used both by the gossip reactor (wire) and the WAL (tagged local encoding).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.libs.bit_array import BitArray
from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
from cometbft_tpu_torch.types.part_set import Part
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import proto as wire


@dataclass
class NewRoundStepMessage:
    """consensus/reactor.go NewRoundStepMessage."""

    height: int = 0
    round: int = 0
    step: int = 0
    seconds_since_start_time: int = 0
    last_commit_round: int = 0

    def encode(self) -> bytes:
        return (
            wire.field_varint(1, self.height)
            + wire.field_varint(2, self.round)
            + wire.field_varint(3, self.step)
            + wire.field_varint(4, self.seconds_since_start_time)
            + wire.field_varint(5, self.last_commit_round)
        )

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(
            wire.get_varint(f, 1), wire.get_varint(f, 2), wire.get_varint(f, 3),
            wire.get_varint(f, 4), wire.get_varint(f, 5),
        )


@dataclass
class NewValidBlockMessage:
    height: int = 0
    round: int = 0
    block_part_set_header: PartSetHeader = dfield(default_factory=PartSetHeader)
    block_parts: BitArray | None = None
    is_commit: bool = False

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.height)
        out += wire.field_varint(2, self.round)
        out += wire.field_message(3, self.block_part_set_header.encode(), emit_empty=True)
        if self.block_parts is not None:
            out += wire.field_message(4, self.block_parts.encode(), emit_empty=True)
        out += wire.field_bool(5, self.is_commit)
        return out

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        bp = None
        if 4 in f:
            bp = BitArray.decode(wire.get_bytes(f, 4))
        return cls(
            wire.get_varint(f, 1),
            wire.get_varint(f, 2),
            PartSetHeader.decode(wire.get_bytes(f, 3)),
            bp,
            wire.get_bool(f, 5),
        )


@dataclass
class ProposalMessage:
    proposal: Proposal = None

    def encode(self) -> bytes:
        return wire.field_message(1, self.proposal.encode(), emit_empty=True)

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(Proposal.decode(wire.get_bytes(f, 1)))


@dataclass
class ProposalPOLMessage:
    height: int = 0
    proposal_pol_round: int = 0
    proposal_pol: BitArray | None = None

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.height)
        out += wire.field_varint(2, self.proposal_pol_round)
        if self.proposal_pol is not None:
            out += wire.field_message(3, self.proposal_pol.encode(), emit_empty=True)
        return out

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        pol = BitArray.decode(wire.get_bytes(f, 3)) if 3 in f else None
        return cls(wire.get_varint(f, 1), wire.get_varint(f, 2), pol)


@dataclass
class BlockPartMessage:
    height: int = 0
    round: int = 0
    part: Part = None

    def encode(self) -> bytes:
        return (
            wire.field_varint(1, self.height)
            + wire.field_varint(2, self.round)
            + wire.field_message(3, self.part.encode(), emit_empty=True)
        )

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(
            wire.get_varint(f, 1),
            wire.get_varint(f, 2),
            Part.decode(wire.get_bytes(f, 3)),
        )


@dataclass
class VoteMessage:
    vote: Vote = None

    def encode(self) -> bytes:
        return wire.field_message(1, self.vote.encode(), emit_empty=True)

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(Vote.decode(wire.get_bytes(f, 1)))


@dataclass
class HasVoteMessage:
    height: int = 0
    round: int = 0
    type: int = 0
    index: int = 0

    def encode(self) -> bytes:
        return (
            wire.field_varint(1, self.height)
            + wire.field_varint(2, self.round)
            + wire.field_varint(3, self.type)
            + wire.field_varint(4, self.index)
        )

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(
            wire.get_varint(f, 1), wire.get_varint(f, 2),
            wire.get_varint(f, 3), wire.get_varint(f, 4),
        )


@dataclass
class VoteSetMaj23Message:
    height: int = 0
    round: int = 0
    type: int = 0
    block_id: BlockID = dfield(default_factory=BlockID)

    def encode(self) -> bytes:
        return (
            wire.field_varint(1, self.height)
            + wire.field_varint(2, self.round)
            + wire.field_varint(3, self.type)
            + wire.field_message(4, self.block_id.encode(), emit_empty=True)
        )

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(
            wire.get_varint(f, 1), wire.get_varint(f, 2), wire.get_varint(f, 3),
            BlockID.decode(wire.get_bytes(f, 4)),
        )


@dataclass
class VoteSetBitsMessage:
    height: int = 0
    round: int = 0
    type: int = 0
    block_id: BlockID = dfield(default_factory=BlockID)
    votes: BitArray | None = None

    def encode(self) -> bytes:
        out = (
            wire.field_varint(1, self.height)
            + wire.field_varint(2, self.round)
            + wire.field_varint(3, self.type)
            + wire.field_message(4, self.block_id.encode(), emit_empty=True)
        )
        if self.votes is not None:
            out += wire.field_message(5, self.votes.encode(), emit_empty=True)
        return out

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        votes = BitArray.decode(wire.get_bytes(f, 5)) if 5 in f else None
        return cls(
            wire.get_varint(f, 1), wire.get_varint(f, 2), wire.get_varint(f, 3),
            BlockID.decode(wire.get_bytes(f, 4)), votes,
        )


@dataclass
class TimeoutInfo:
    """consensus/state.go timeoutInfo: a scheduled timeout firing."""

    duration: float = 0.0
    height: int = 0
    round: int = 0
    step: int = 0

    def encode(self) -> bytes:
        return (
            wire.field_varint(1, int(self.duration * 1e9))
            + wire.field_varint(2, self.height)
            + wire.field_varint(3, self.round)
            + wire.field_varint(4, self.step)
        )

    @classmethod
    def decode(cls, d: bytes):
        f = wire.decode_fields(d)
        return cls(
            wire.get_varint(f, 1) / 1e9, wire.get_varint(f, 2),
            wire.get_varint(f, 3), wire.get_varint(f, 4),
        )


# -- reactor channel wire envelope (oneof tag) --------------------------------

_WIRE_TAGS = [
    (NewRoundStepMessage, 1),
    (NewValidBlockMessage, 2),
    (ProposalMessage, 3),
    (ProposalPOLMessage, 4),
    (BlockPartMessage, 5),
    (VoteMessage, 6),
    (HasVoteMessage, 7),
    (VoteSetMaj23Message, 8),
    (VoteSetBitsMessage, 9),
]
_TAG_BY_TYPE = {t: n for t, n in _WIRE_TAGS}
_TYPE_BY_TAG = {n: t for t, n in _WIRE_TAGS}


def encode_consensus_message(msg) -> bytes:
    """tendermint.consensus.Message oneof envelope."""
    tag = _TAG_BY_TYPE[type(msg)]
    return wire.field_message(tag, msg.encode(), emit_empty=True)


def decode_consensus_message(data: bytes):
    f = wire.decode_fields(data)
    for tag, typ in _TYPE_BY_TAG.items():
        if tag in f:
            return typ.decode(wire.get_bytes(f, tag))
    raise ValueError("unknown consensus message")


# -- WAL tagged encoding ------------------------------------------------------

from cometbft_tpu_torch.consensus import wal as _walmod  # noqa: E402  (tags)


def encode_wal_message(msg) -> bytes:
    if isinstance(msg, ProposalMessage):
        return bytes([_walmod.MSG_PROPOSAL]) + msg.encode()
    if isinstance(msg, BlockPartMessage):
        return bytes([_walmod.MSG_BLOCK_PART]) + msg.encode()
    if isinstance(msg, VoteMessage):
        return bytes([_walmod.MSG_VOTE]) + msg.encode()
    if isinstance(msg, TimeoutInfo):
        return bytes([_walmod.MSG_TIMEOUT]) + msg.encode()
    if isinstance(msg, HasVoteMessage):
        return bytes([_walmod.MSG_HAS_VOTE]) + msg.encode()
    raise ValueError(f"unknown WAL message {msg!r}")


def decode_wal_message(data: bytes):
    tag, body = data[0], data[1:]
    if tag == _walmod.MSG_PROPOSAL:
        return ProposalMessage.decode(body)
    if tag == _walmod.MSG_BLOCK_PART:
        return BlockPartMessage.decode(body)
    if tag == _walmod.MSG_VOTE:
        return VoteMessage.decode(body)
    if tag == _walmod.MSG_TIMEOUT:
        return TimeoutInfo.decode(body)
    if tag == _walmod.MSG_HAS_VOTE:
        return HasVoteMessage.decode(body)
    raise ValueError(f"unknown WAL tag {tag}")
