"""Validator (types/validator.go), the port's copy of
``cometbft_tpu/types/validator.py``."""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import encoding as key_encoding
from cometbft_tpu_torch.wire import proto as wire


@dataclass
class Validator:
    """types/validator.go:17-35. Mutable: priority changes every round."""

    address: bytes
    pub_key: object
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key, voting_power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, voting_power, 0)

    def copy(self) -> "Validator":
        return Validator(
            self.address, self.pub_key, self.voting_power, self.proposer_priority
        )

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """types/validator.go:64-84: higher priority wins; ties break to the
        smaller address."""
        if other is None:
            return self
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("Cannot compare identical validators")

    def bytes(self) -> bytes:
        """SimpleValidator proto bytes — the Merkle leaf of ValidatorSet.Hash
        (types/validator.go:117-133)."""
        pk = key_encoding.pub_key_to_proto(self.pub_key)
        return wire.field_message(1, pk, emit_empty=True) + wire.field_varint(
            2, self.voting_power
        )

    def validate_basic(self) -> None:
        """types/validator.go ValidateBasic."""
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("validator address is the wrong size")
        if self.address != self.pub_key.address():
            raise ValueError("validator address does not match its pubkey")

    def encode(self) -> bytes:
        """tendermint.types.Validator wire form."""
        out = wire.field_bytes(1, self.address)
        out += wire.field_message(
            2, key_encoding.pub_key_to_proto(self.pub_key), emit_empty=True
        )
        out += wire.field_varint(3, self.voting_power)
        out += wire.field_varint(4, self.proposer_priority)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Validator":
        f = wire.decode_fields(data)
        return cls(
            address=wire.get_bytes(f, 1),
            pub_key=key_encoding.pub_key_from_proto(wire.get_bytes(f, 2)),
            voting_power=wire.get_varint(f, 3),
            proposer_priority=wire.get_varint(f, 4),
        )
