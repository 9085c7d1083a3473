"""Consensus parameters (types/params.go), the port's copy of
``cometbft_tpu/types/params.py``."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield, replace

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.wire import proto as wire

MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MiB (types/params.go:14)
BLOCK_PART_SIZE_BYTES = 65536  # types/params.go:20
MAX_BLOCK_PARTS_COUNT = (MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES) + 1

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUBKEY_TYPE_SR25519 = "sr25519"
ABCI_PUBKEY_TYPE_BN254 = "bn254"  # fork addition (types/params.go:27)

# MaxVotesCount caps the validator-set size (types/params.go MaxVotesCount).
MAX_VOTES_COUNT = 10000


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 22020096  # 21 MiB default (types/params.go DefaultBlockParams)
    max_gas: int = -1

    def encode(self) -> bytes:
        return wire.field_varint(1, self.max_bytes) + wire.field_varint(2, self.max_gas)

    @classmethod
    def decode(cls, data: bytes) -> "BlockParams":
        f = wire.decode_fields(data)
        return cls(wire.get_varint(f, 1), wire.get_varint(f, 2))


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 10**9  # 48h, proto Duration
    max_bytes: int = 1048576

    def encode(self) -> bytes:
        dur = wire.field_varint(1, self.max_age_duration_ns // 10**9) + wire.field_varint(
            2, self.max_age_duration_ns % 10**9
        )
        return (
            wire.field_varint(1, self.max_age_num_blocks)
            + wire.field_message(2, dur, emit_empty=True)
            + wire.field_varint(3, self.max_bytes)
        )

    @classmethod
    def decode(cls, data: bytes) -> "EvidenceParams":
        f = wire.decode_fields(data)
        df = wire.decode_fields(wire.get_bytes(f, 2))
        dur = wire.get_varint(df, 1) * 10**9 + wire.get_varint(df, 2)
        return cls(wire.get_varint(f, 1), dur, wire.get_varint(f, 3))


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple = (ABCI_PUBKEY_TYPE_ED25519,)

    def encode(self) -> bytes:
        out = b""
        for t in self.pub_key_types:
            out += wire.field_string(1, t, emit_default=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ValidatorParams":
        f = wire.decode_fields(data)
        return cls(tuple(b.decode() for b in wire.get_repeated_bytes(f, 1)))


@dataclass(frozen=True)
class VersionParams:
    app: int = 0

    def encode(self) -> bytes:
        return wire.field_varint(1, self.app)

    @classmethod
    def decode(cls, data: bytes) -> "VersionParams":
        f = wire.decode_fields(data)
        return cls(wire.get_uvarint(f, 1))


@dataclass(frozen=True)
class ConsensusParams:
    """types/params.go ConsensusParams."""

    block: BlockParams = dfield(default_factory=BlockParams)
    evidence: EvidenceParams = dfield(default_factory=EvidenceParams)
    validator: ValidatorParams = dfield(default_factory=ValidatorParams)
    version: VersionParams = dfield(default_factory=VersionParams)

    def hash(self) -> bytes:
        """HashConsensusParams (types/params.go): SHA-256 of HashedParams
        {block_max_bytes, block_max_gas}. NOTE: CometBFT hashes only the
        block-size subset (params.go HashedParams)."""
        hp = wire.field_varint(1, self.block.max_bytes) + wire.field_varint(
            2, self.block.max_gas
        )
        from cometbft_tpu_torch.crypto import tmhash

        return tmhash.sum(hp)

    def validate_basic(self) -> None:
        """types/params.go ValidateBasic."""
        if self.block.max_bytes == 0:
            raise ValueError("block.MaxBytes cannot be 0")
        if self.block.max_bytes < -1:
            raise ValueError(
                f"block.MaxBytes must be -1 or greater than 0. Got {self.block.max_bytes}"
            )
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(
                f"block.MaxBytes is too big. {self.block.max_bytes} > {MAX_BLOCK_SIZE_BYTES}"
            )
        if self.block.max_gas < -1:
            raise ValueError(f"block.MaxGas must be greater or equal to -1. Got {self.block.max_gas}")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError(
                f"evidence.MaxAgeNumBlocks must be greater than 0. Got {self.evidence.max_age_num_blocks}"
            )
        if self.evidence.max_age_duration_ns <= 0:
            raise ValueError(
                "evidence.MaxAgeDuration must be greater than 0 if provided"
            )
        max_bytes = self.block.max_bytes
        if max_bytes == -1:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        if self.evidence.max_bytes > max_bytes:
            raise ValueError(
                f"evidence.MaxBytesEvidence is greater than upper bound, {self.evidence.max_bytes} > {max_bytes}"
            )
        if self.evidence.max_bytes < 0:
            raise ValueError(
                f"evidence.MaxBytes must be non negative. Got: {self.evidence.max_bytes}"
            )
        if not self.pub_key_types_valid():
            raise ValueError(f"invalid pub key types: {self.validator.pub_key_types}")

    def pub_key_types_valid(self) -> bool:
        if not self.validator.pub_key_types:
            return False
        valid = {
            ABCI_PUBKEY_TYPE_ED25519,
            ABCI_PUBKEY_TYPE_SECP256K1,
            ABCI_PUBKEY_TYPE_SR25519,
            ABCI_PUBKEY_TYPE_BN254,
        }
        return all(t in valid for t in self.validator.pub_key_types)

    def update(self, updates) -> "ConsensusParams":
        """ConsensusParams.Update from an ABCI param-change (types/params.go).
        `updates` is an abci.ConsensusParams-shaped object with optional
        block/evidence/validator/version sections."""
        res = self
        if updates is None:
            return res
        if getattr(updates, "block", None) is not None:
            res = replace(
                res,
                block=BlockParams(updates.block.max_bytes, updates.block.max_gas),
            )
        if getattr(updates, "evidence", None) is not None:
            res = replace(
                res,
                evidence=EvidenceParams(
                    updates.evidence.max_age_num_blocks,
                    updates.evidence.max_age_duration_ns,
                    updates.evidence.max_bytes,
                ),
            )
        if getattr(updates, "validator", None) is not None:
            res = replace(
                res,
                validator=ValidatorParams(tuple(updates.validator.pub_key_types)),
            )
        if getattr(updates, "version", None) is not None:
            res = replace(res, version=VersionParams(updates.version.app))
        return res

    def encode(self) -> bytes:
        return (
            wire.field_message(1, self.block.encode(), emit_empty=True)
            + wire.field_message(2, self.evidence.encode(), emit_empty=True)
            + wire.field_message(3, self.validator.encode(), emit_empty=True)
            + wire.field_message(4, self.version.encode(), emit_empty=True)
        )

    @classmethod
    def decode(cls, data: bytes) -> "ConsensusParams":
        f = wire.decode_fields(data)
        return cls(
            block=BlockParams.decode(wire.get_bytes(f, 1)),
            evidence=EvidenceParams.decode(wire.get_bytes(f, 2)),
            validator=ValidatorParams.decode(wire.get_bytes(f, 3)),
            version=VersionParams.decode(wire.get_bytes(f, 4)),
        )


DEFAULT_CONSENSUS_PARAMS = ConsensusParams()
