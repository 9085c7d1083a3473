"""LightBlock: the light client's unit of data (types/light.go), the port's
copy of ``cometbft_tpu/types/light_block.py``.

SignedHeader (header + its commit) plus the validator set of that height —
everything needed to verify the commit and chain to the next header.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field as dfield

from cometbft_tpu_torch.types.block import SignedHeader
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.wire import proto as wire


@dataclass
class LightBlock:
    """types/light.go LightBlock."""

    signed_header: SignedHeader
    validator_set: ValidatorSet
    # Encode memo (immutable-after-construction, the Commit._hash contract):
    # providers hand the same LightBlock to store saves and gossip encodes
    # repeatedly, and a 4k-validator block costs ~100 ms per encode.
    _enc: bytes | None = dfield(default=None, compare=False, repr=False)

    @property
    def height(self) -> int:
        return self.signed_header.header.height

    @property
    def header(self):
        return self.signed_header.header

    def hash(self) -> bytes:
        return self.signed_header.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go LightBlock.ValidateBasic."""
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != self.validator_set.hash():
            raise ValueError(
                f"expected validators hash of header to match validator set "
                f"hash ({self.signed_header.header.validators_hash.hex()} != "
                f"{self.validator_set.hash().hex()})"
            )

    def encode(self) -> bytes:
        if self._enc is None:
            self._enc = wire.field_message(
                1, self.signed_header.encode(), emit_empty=True
            ) + wire.field_message(
                2, self.validator_set.encode(), emit_empty=True
            )
        return self._enc

    @classmethod
    def decode(cls, data: bytes) -> "LightBlock":
        f = wire.decode_fields(data)
        # No encode-memo from the wire input: a peer's non-canonical field
        # order must not survive as this block's canonical encoding.
        return cls(
            signed_header=SignedHeader.decode(wire.get_bytes(f, 1)),
            validator_set=ValidatorSet.decode(wire.get_bytes(f, 2)),
        )
