"""Evidence of Byzantine behavior (types/evidence.go), the port's copy of
``cometbft_tpu/types/evidence.py``: the two evidence types, their wire
codecs and hashes. ``evidence/verify.py`` verifies them."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.types.block import SignedHeader
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import proto as wire


@dataclass
class DuplicateVoteEvidence:
    """Two conflicting votes from one validator (types/evidence.go:35-160)."""

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Time = dfield(default_factory=Time)

    TYPE_NAME = "duplicate_vote"

    @classmethod
    def new(cls, vote1: Vote, vote2: Vote, block_time: Time, val_set: ValidatorSet):
        """NewDuplicateVoteEvidence orders votes lexically by BlockID key
        (types/evidence.go:60-85)."""
        if vote1 is None or vote2 is None or val_set is None:
            raise ValueError("missing vote or validator set")
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise ValueError("validator is not in validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return cls(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def bytes(self) -> bytes:
        return self.encode()

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> Time:
        return self.timestamp

    def validate_basic(self) -> None:
        """types/evidence.go:121-145."""
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("one or both of the votes are empty")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError(
                "duplicate votes in invalid order (should be lexicographically ordered)"
            )

    def encode(self) -> bytes:
        out = wire.field_message(1, self.vote_a.encode(), emit_empty=True)
        out += wire.field_message(2, self.vote_b.encode(), emit_empty=True)
        out += wire.field_varint(3, self.total_voting_power)
        out += wire.field_varint(4, self.validator_power)
        out += wire.field_message(5, self.timestamp.encode(), emit_empty=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "DuplicateVoteEvidence":
        f = wire.decode_fields(data)
        return cls(
            vote_a=Vote.decode(wire.get_bytes(f, 1)),
            vote_b=Vote.decode(wire.get_bytes(f, 2)),
            total_voting_power=wire.get_varint(f, 3),
            validator_power=wire.get_varint(f, 4),
            timestamp=Time.decode(wire.get_bytes(f, 5)),
        )


@dataclass
class LightClientAttackEvidence:
    """A conflicting light block trace (types/evidence.go:195-330)."""

    conflicting_block: "LightBlock"
    common_height: int
    byzantine_validators: list = dfield(default_factory=list)
    total_voting_power: int = 0
    timestamp: Time = dfield(default_factory=Time)

    TYPE_NAME = "light_client_attack"

    def bytes(self) -> bytes:
        return self.encode()

    def hash(self) -> bytes:
        """types/evidence.go:307-314: H(conflicting header hash[:31] || varint
        common height) — NOTE CometBFT copies only Size-1 bytes of the
        block hash (an upstream quirk preserved for hash compatibility)."""
        height_varint = _go_put_varint(self.common_height)
        bz = bytearray(tmhash.SIZE + len(height_varint))
        block_hash = self.conflicting_block.signed_header.header.hash()
        # Go copies from a possibly-nil hash (zero bytes copied) — mirror
        # that tolerance for adversarial headers with no ValidatorsHash.
        if block_hash is not None:
            bz[: tmhash.SIZE - 1] = block_hash[: tmhash.SIZE - 1]
        bz[tmhash.SIZE :] = height_varint
        return tmhash.sum(bytes(bz))

    def height(self) -> int:
        return self.common_height

    def time(self) -> Time:
        return self.timestamp

    def validate_basic(self) -> None:
        """types/evidence.go:341-371."""
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.conflicting_block.signed_header is None:
            raise ValueError("conflicting block missing header")
        if self.total_voting_power <= 0:
            raise ValueError("negative or zero total voting power")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")
        conflicting_height = self.conflicting_block.signed_header.header.height
        if self.common_height > conflicting_height:
            raise ValueError(
                f"common height is ahead of the conflicting block height "
                f"({self.common_height} > {conflicting_height})"
            )
        self.conflicting_block.validate_basic(
            self.conflicting_block.signed_header.header.chain_id
        )

    def encode(self) -> bytes:
        out = wire.field_message(
            1, self.conflicting_block.encode(), emit_empty=True
        )
        out += wire.field_varint(2, self.common_height)
        for v in self.byzantine_validators:
            out += wire.field_message(3, v.encode(), emit_empty=True)
        out += wire.field_varint(4, self.total_voting_power)
        out += wire.field_message(5, self.timestamp.encode(), emit_empty=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "LightClientAttackEvidence":
        f = wire.decode_fields(data)
        return cls(
            conflicting_block=LightBlock.decode(wire.get_bytes(f, 1)),
            common_height=wire.get_varint(f, 2),
            byzantine_validators=[
                Validator.decode(b) for b in wire.get_repeated_bytes(f, 3)
            ],
            total_voting_power=wire.get_varint(f, 4),
            timestamp=Time.decode(wire.get_bytes(f, 5)),
        )


def _go_put_varint(v: int) -> bytes:
    """Go binary.PutVarint: zigzag + uvarint."""
    uv = (v << 1) if v >= 0 else ((-v) << 1) - 1
    return wire.encode_uvarint(uv)


@dataclass
class LightBlock:
    """types/light.go LightBlock = SignedHeader + ValidatorSet."""

    signed_header: SignedHeader
    validator_set: ValidatorSet | None

    def encode(self) -> bytes:
        out = wire.field_message(1, self.signed_header.encode(), emit_empty=True)
        if self.validator_set is not None:
            out += wire.field_message(2, self.validator_set.encode(), emit_empty=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "LightBlock":
        f = wire.decode_fields(data)
        vs = None
        if 2 in f:
            vs = ValidatorSet.decode(wire.get_bytes(f, 2))
        return cls(
            signed_header=SignedHeader.decode(wire.get_bytes(f, 1)),
            validator_set=vs,
        )

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go LightBlock.ValidateBasic."""
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        vs_hash = self.validator_set.hash()
        if self.signed_header.header.validators_hash != vs_hash:
            raise ValueError(
                f"expected validators hash of header to match validator set hash "
                f"({self.signed_header.header.validators_hash.hex()} != {vs_hash.hex()})"
            )


# -- evidence list wire + hashing (types/evidence.go:400-450) -----------------


def encode_evidence(ev) -> bytes:
    """tendermint.types.Evidence oneof wrapper."""
    if isinstance(ev, DuplicateVoteEvidence):
        return wire.field_message(1, ev.encode(), emit_empty=True)
    if isinstance(ev, LightClientAttackEvidence):
        return wire.field_message(2, ev.encode(), emit_empty=True)
    raise ValueError(f"evidence is not recognized: {ev}")


def decode_evidence(data: bytes):
    f = wire.decode_fields(data)
    if 1 in f:
        return DuplicateVoteEvidence.decode(wire.get_bytes(f, 1))
    if 2 in f:
        return LightClientAttackEvidence.decode(wire.get_bytes(f, 2))
    raise ValueError("evidence is not recognized")


def encode_evidence_list(evidence: list) -> bytes:
    out = b""
    for ev in evidence:
        out += wire.field_message(1, encode_evidence(ev), emit_empty=True)
    return out


def decode_evidence_list(data: bytes) -> list:
    if not data:
        return []
    f = wire.decode_fields(data)
    return [decode_evidence(b) for b in wire.get_repeated_bytes(f, 1)]


def evidence_list_hash(evidence: list) -> bytes:
    """EvidenceList.Hash: merkle over Evidence.Bytes (types/evidence.go:436)."""
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evidence])


MAX_EVIDENCE_BYTES_DENOMINATOR = 10
