"""Block parts: 64 KiB chunks with Merkle inclusion proofs
(types/part_set.go), the port's copy of ``cometbft_tpu/types/part_set.py``.

Blocks are gossiped piece-wise: the proposer splits the proto-encoded block
into parts (types/part_set.go:150,166), the PartSetHeader carries the Merkle
root over the parts, and receivers verify each part's proof before assembly
(types/part_set.go:266 AddPart).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.crypto.merkle import Proof, proofs_from_byte_slices
from cometbft_tpu_torch.libs.bit_array import BitArray
from cometbft_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, PartSetHeader
from cometbft_tpu_torch.wire import proto as wire
from cometbft_tpu_torch.wire.types import decode_proof, encode_proof


@dataclass
class Part:
    index: int
    bytes: bytes
    proof: Proof

    def validate_basic(self) -> None:
        """types/part_set.go Part.ValidateBasic."""
        if len(self.bytes) > BLOCK_PART_SIZE_BYTES:
            raise ValueError(
                f"too big: {len(self.bytes)} bytes, max: {BLOCK_PART_SIZE_BYTES}"
            )
        self.proof.validate_basic()

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.index)
        out += wire.field_bytes(2, self.bytes)
        out += wire.field_message(3, encode_proof(self.proof), emit_empty=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Part":
        f = wire.decode_fields(data)
        return cls(
            index=wire.get_uvarint(f, 1),
            bytes=wire.get_bytes(f, 2),
            proof=decode_proof(wire.get_bytes(f, 3)),
        )


class PartSet:
    """types/part_set.go:125-300."""

    def __init__(self, header: PartSetHeader):
        self._header = header
        self._parts: list[Part | None] = [None] * header.total
        self._bit_array = BitArray(header.total)
        self._count = 0
        self._byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """NewPartSetFromData (types/part_set.go:150-180): split, build the
        Merkle proofs over the raw part bytes."""
        total = (len(data) + part_size - 1) // part_size
        if total == 0:
            total = 1
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        root, proofs = proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=total, hash=root))
        for i, chunk in enumerate(chunks):
            part = Part(index=i, bytes=chunk, proof=proofs[i])
            ps._parts[i] = part
            ps._bit_array.set_index(i, True)
            ps._byte_size += len(chunk)
        ps._count = total
        return ps

    def header(self) -> PartSetHeader:
        return self._header

    def has_header(self, header: PartSetHeader) -> bool:
        return self._header == header

    def bit_array(self) -> BitArray:
        return self._bit_array.copy()

    def hash(self) -> bytes:
        return self._header.hash

    @property
    def total(self) -> int:
        return self._header.total

    @property
    def count(self) -> int:
        return self._count

    @property
    def byte_size(self) -> int:
        return self._byte_size

    def is_complete(self) -> bool:
        return self._count == self._header.total

    def add_part(self, part: Part) -> bool:
        """types/part_set.go:266-295: proof-checked insertion."""
        if part.index >= self._header.total:
            raise ValueError("error part set unexpected index")
        if self._parts[part.index] is not None:
            return False
        # Check hash proof against the part-set root.
        if part.proof.index != part.index or part.proof.total != self._header.total:
            raise ValueError("error part set invalid proof")
        part.proof.verify(self._header.hash, part.bytes)
        self._parts[part.index] = part
        self._bit_array.set_index(part.index, True)
        self._count += 1
        self._byte_size += len(part.bytes)
        return True

    def get_part(self, index: int) -> Part | None:
        if index < 0 or index >= len(self._parts):
            return None
        return self._parts[index]

    def get_reader(self) -> bytes:
        """Assembled block bytes (only when complete)."""
        if not self.is_complete():
            raise ValueError("cannot read incomplete part set")
        return b"".join(p.bytes for p in self._parts)
