"""Vote (types/vote.go), the port's copy of ``cometbft_tpu/types/vote.py``."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield, replace

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block import (
    MAX_SIGNATURE_SIZE,
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    BlockID,
)
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.wire import proto as wire


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


@dataclass(frozen=True)
class Vote:
    """types/vote.go:50-63."""

    type: int = 0
    height: int = 0
    round: int = 0
    block_id: BlockID = dfield(default_factory=BlockID)
    timestamp: Time = dfield(default_factory=Time)
    validator_address: bytes = b""
    validator_index: int = 0
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        """VoteSignBytes (types/vote.go:85-95).

        Memoized per instance: a gossiped vote is sign-bytes-checked by
        every admission path it crosses (prebatch, VoteSet, evidence), and
        in-process meshes share one Vote object across all receivers. The
        cache never enters __eq__/__hash__ (dataclass uses fields only).
        """
        cached = self.__dict__.get("_sign_bytes")
        if cached is not None and cached[0] == chain_id:
            return cached[1]
        sb = canonical.vote_sign_bytes_from_parts(
            chain_id, self.type, self.height, self.round, self.block_id, self.timestamp
        )
        object.__setattr__(self, "_sign_bytes", (chain_id, sb))
        return sb

    def verify(self, chain_id: str, pub_key) -> None:
        """types/vote.go Verify: address match + signature check."""
        if pub_key.address() != self.validator_address:
            raise VoteError("invalid validator address")
        if not pub_key.verify_signature(self.sign_bytes(chain_id), self.signature):
            raise VoteError("invalid signature")

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def with_signature(self, sig: bytes) -> "Vote":
        return replace(self, signature=sig)

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.type)
        out += wire.field_varint(2, self.height)
        out += wire.field_varint(3, self.round)
        out += wire.field_message(4, self.block_id.encode(), emit_empty=True)
        out += wire.field_message(5, self.timestamp.encode(), emit_empty=True)
        out += wire.field_bytes(6, self.validator_address)
        out += wire.field_varint(7, self.validator_index)
        out += wire.field_bytes(8, self.signature)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        f = wire.decode_fields(data)
        return cls(
            type=wire.get_uvarint(f, 1),
            height=wire.get_varint(f, 2),
            round=wire.get_varint(f, 3),
            block_id=BlockID.decode(wire.get_bytes(f, 4)),
            timestamp=Time.decode(wire.get_bytes(f, 5)),
            validator_address=wire.get_bytes(f, 6),
            validator_index=wire.get_varint(f, 7),
            signature=wire.get_bytes(f, 8),
        )

    def validate_basic(self) -> None:
        """types/vote.go:168-210."""
        if not is_vote_type_valid(self.type):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got: {self.block_id}")
        self.block_id.validate_basic()
        if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
            raise ValueError("expected ValidatorAddress size to be 20 bytes")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("signature is too big")


class VoteError(Exception):
    pass


def vote_to_commit_sig(vote: Vote | None):
    """Vote → CommitSig (types/block.go CommitSig from vote / MakeCommit path)."""
    from cometbft_tpu_torch.types.block import CommitSig

    if vote is None:
        return CommitSig.absent()
    if vote.block_id.is_zero():
        flag = 3  # BlockIDFlagNil
    else:
        flag = 2  # BlockIDFlagCommit
    return CommitSig(
        block_id_flag=flag,
        validator_address=vote.validator_address,
        timestamp=vote.timestamp,
        signature=vote.signature,
    )
