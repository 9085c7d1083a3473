"""Block proposal (types/proposal.go), the port's copy of
``cometbft_tpu/types/proposal.py``."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block import MAX_SIGNATURE_SIZE, PROPOSAL_TYPE, BlockID
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.wire import proto as wire


@dataclass(frozen=True)
class Proposal:
    """types/proposal.go:23-41."""

    type: int = PROPOSAL_TYPE
    height: int = 0
    round: int = 0
    pol_round: int = -1
    block_id: BlockID = dfield(default_factory=BlockID)
    timestamp: Time = dfield(default_factory=Time)
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        """ProposalSignBytes (types/proposal.go:80-92)."""
        return canonical.proposal_sign_bytes_from_parts(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.block_id,
            self.timestamp,
        )

    def validate_basic(self) -> None:
        """types/proposal.go:44-77."""
        if self.type != PROPOSAL_TYPE:
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1:
            raise ValueError("negative POLRound (exception: -1)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError(f"expected a complete, non-empty BlockID, got: {self.block_id}")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("signature is too big")

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.type)
        out += wire.field_varint(2, self.height)
        out += wire.field_varint(3, self.round)
        out += wire.field_varint(4, self.pol_round)
        out += wire.field_message(5, self.block_id.encode(), emit_empty=True)
        out += wire.field_message(6, self.timestamp.encode(), emit_empty=True)
        out += wire.field_bytes(7, self.signature)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        f = wire.decode_fields(data)
        return cls(
            type=wire.get_uvarint(f, 1),
            height=wire.get_varint(f, 2),
            round=wire.get_varint(f, 3),
            pol_round=wire.get_varint(f, 4),
            block_id=BlockID.decode(wire.get_bytes(f, 5)),
            timestamp=Time.decode(wire.get_bytes(f, 6)),
            signature=wire.get_bytes(f, 7),
        )
