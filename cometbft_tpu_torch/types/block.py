"""Block, Data, BlockMeta, Header, Commit, BlockID and SignedHeader
(types/block.go, types/block_meta.go), the port's copy of
``cometbft_tpu/types/block.py``.

Wire layouts follow proto/tendermint/types/types.proto; hashes follow
CometBFT exactly: Header.Hash is the Merkle root over the 14
protobuf-encoded header fields (types/block.go:440-475), Commit.Hash the
root over proto-encoded CommitSigs (types/block.go:895-913), and the
wrapper-value encoding of primitive fields mirrors cdcEncode
(types/encoding_helper.go). Both roots go through
``crypto/merkle.hash_from_byte_slices`` (the native tree from 32 items).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.wire import proto as wire

MAX_HEADER_BYTES = 626  # types/block.go MaxHeaderBytes

BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3

# Blocks are gossiped in parts of this size (types/params.go:20 BlockPartSizeBytes).
BLOCK_PART_SIZE_BYTES = 65536

MAX_COMMIT_OVERHEAD_BYTES = 94  # types/block.go MaxCommitOverheadBytes
MAX_COMMIT_SIG_BYTES = 109  # types/block.go MaxCommitSigBytes


def cdc_encode_bytes(b: bytes) -> bytes:
    """cdcEncode for HexBytes: gogotypes.BytesValue{Value: b} or nil if empty
    (types/encoding_helper.go)."""
    if not b:
        return b""
    return wire.field_bytes(1, b)


def cdc_encode_string(s: str) -> bytes:
    if not s:
        return b""
    return wire.field_string(1, s)


def cdc_encode_int64(v: int) -> bytes:
    if v == 0:
        return b""
    return wire.field_varint(1, v)


@dataclass(frozen=True)
class Consensus:
    """tendermint.version.Consensus (proto/tendermint/version/types.proto)."""

    block: int = 0
    app: int = 0

    def encode(self) -> bytes:
        return wire.field_varint(1, self.block) + wire.field_varint(2, self.app)

    @classmethod
    def decode(cls, data: bytes) -> "Consensus":
        f = wire.decode_fields(data)
        return cls(wire.get_uvarint(f, 1), wire.get_uvarint(f, 2))


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def encode(self) -> bytes:
        return wire.field_varint(1, self.total) + wire.field_bytes(2, self.hash)

    @classmethod
    def decode(cls, data: bytes) -> "PartSetHeader":
        f = wire.decode_fields(data)
        return cls(wire.get_uvarint(f, 1), wire.get_bytes(f, 2))

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError(
                f"wrong Hash: expected size {tmhash.SIZE}, got {len(self.hash)}"
            )


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = dfield(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        """Either an empty blockID (nil-vote) — types/block.go BlockID.IsZero."""
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == tmhash.SIZE
        )

    def encode(self) -> bytes:
        # part_set_header is gogoproto non-nullable: always marshaled, so a
        # zero BlockID encodes as b"\x12\x00" (types.pb.go BlockID
        # MarshalToSizedBuffer emits tag 0x12 unconditionally). This shapes
        # the height-1 header hash of every chain.
        return wire.field_bytes(1, self.hash) + wire.field_message(
            2, self.part_set_header.encode(), emit_empty=True
        )

    def key(self) -> bytes:
        """Map key: hash || proto(PartSetHeader) (types/block.go Key), the
        order of a DuplicateVoteEvidence's two votes."""
        return self.hash + self.part_set_header.encode()

    @classmethod
    def decode(cls, data: bytes) -> "BlockID":
        f = wire.decode_fields(data)
        return cls(
            wire.get_bytes(f, 1), PartSetHeader.decode(wire.get_bytes(f, 2))
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError("wrong Hash")
        self.part_set_header.validate_basic()


@dataclass(frozen=True)
class Header:
    """types/block.go Header."""

    version: Consensus = dfield(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time: Time = dfield(default_factory=Time)
    last_block_id: BlockID = dfield(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes | None:
        """Merkle root over the 14 encoded fields (types/block.go:440-475).
        None when ValidatorsHash is missing (header not yet complete).

        Memoized per instance (frozen dataclass; the cache lives in
        __dict__, outside __eq__/__hash__): consensus compares
        proposal/locked block hashes on every vote admission, and at
        scenario scale that re-merkleization dominates the profile.
        """
        if not self.validators_hash:
            return None
        cached = self.__dict__.get("_hash_memo")
        if cached is not None:
            return cached
        hv = merkle.hash_from_byte_slices(
            [
                self.version.encode(),
                cdc_encode_string(self.chain_id),
                cdc_encode_int64(self.height),
                self.time.encode(),
                self.last_block_id.encode(),
                cdc_encode_bytes(self.last_commit_hash),
                cdc_encode_bytes(self.data_hash),
                cdc_encode_bytes(self.validators_hash),
                cdc_encode_bytes(self.next_validators_hash),
                cdc_encode_bytes(self.consensus_hash),
                cdc_encode_bytes(self.app_hash),
                cdc_encode_bytes(self.last_results_hash),
                cdc_encode_bytes(self.evidence_hash),
                cdc_encode_bytes(self.proposer_address),
            ]
        )
        object.__setattr__(self, "_hash_memo", hv)
        return hv

    def encode(self) -> bytes:
        """proto Header (non-nullable version/time/last_block_id always emitted)."""
        out = wire.field_message(1, self.version.encode(), emit_empty=True)
        out += wire.field_string(2, self.chain_id)
        out += wire.field_varint(3, self.height)
        out += wire.field_message(4, self.time.encode(), emit_empty=True)
        out += wire.field_message(5, self.last_block_id.encode(), emit_empty=True)
        out += wire.field_bytes(6, self.last_commit_hash)
        out += wire.field_bytes(7, self.data_hash)
        out += wire.field_bytes(8, self.validators_hash)
        out += wire.field_bytes(9, self.next_validators_hash)
        out += wire.field_bytes(10, self.consensus_hash)
        out += wire.field_bytes(11, self.app_hash)
        out += wire.field_bytes(12, self.last_results_hash)
        out += wire.field_bytes(13, self.evidence_hash)
        out += wire.field_bytes(14, self.proposer_address)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        f = wire.decode_fields(data)
        return cls(
            version=Consensus.decode(wire.get_bytes(f, 1)),
            chain_id=wire.get_string(f, 2),
            height=wire.get_varint(f, 3),
            time=Time.decode(wire.get_bytes(f, 4)),
            last_block_id=BlockID.decode(wire.get_bytes(f, 5)),
            last_commit_hash=wire.get_bytes(f, 6),
            data_hash=wire.get_bytes(f, 7),
            validators_hash=wire.get_bytes(f, 8),
            next_validators_hash=wire.get_bytes(f, 9),
            consensus_hash=wire.get_bytes(f, 10),
            app_hash=wire.get_bytes(f, 11),
            last_results_hash=wire.get_bytes(f, 12),
            evidence_hash=wire.get_bytes(f, 13),
            proposer_address=wire.get_bytes(f, 14),
        )

    def validate_basic(self) -> None:
        """types/block.go:376-432."""
        if len(self.chain_id) > 50:
            raise ValueError("chainID is too long")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.height == 0:
            raise ValueError("zero Height")
        self.last_block_id.validate_basic()
        _validate_hash(self.last_commit_hash, "LastCommitHash")
        _validate_hash(self.data_hash, "DataHash")
        _validate_hash(self.evidence_hash, "EvidenceHash")
        if len(self.proposer_address) not in (0, tmhash.TRUNCATED_SIZE):
            raise ValueError("invalid ProposerAddress length")
        _validate_hash(self.validators_hash, "ValidatorsHash")
        _validate_hash(self.next_validators_hash, "NextValidatorsHash")
        _validate_hash(self.consensus_hash, "ConsensusHash")
        _validate_hash(self.last_results_hash, "LastResultsHash")


def _validate_hash(h: bytes, name: str) -> None:
    """types/validation.go ValidateHash: empty or tmhash.Size."""
    if h and len(h) != tmhash.SIZE:
        raise ValueError(
            f"wrong {name}: expected size {tmhash.SIZE}, got {len(h)}"
        )


@dataclass(frozen=True)
class CommitSig:
    """types/block.go:575-660."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Time = dfield(default_factory=Time)
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(block_id_flag=BLOCK_ID_FLAG_ABSENT)

    @classmethod
    def for_block(cls, addr: bytes, ts: Time, sig: bytes) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_COMMIT, addr, ts, sig)

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def for_block_flag(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.block_id_flag)
        out += wire.field_bytes(2, self.validator_address)
        out += wire.field_message(3, self.timestamp.encode(), emit_empty=True)
        out += wire.field_bytes(4, self.signature)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "CommitSig":
        f = wire.decode_fields(data)
        return cls(
            block_id_flag=wire.get_uvarint(f, 1),
            validator_address=wire.get_bytes(f, 2),
            timestamp=Time.decode(wire.get_bytes(f, 3)),
            signature=wire.get_bytes(f, 4),
        )

    def validate_basic(self, aggregated: bool = False) -> None:
        """types/block.go:700-740. aggregated=True is the aggregate wire form:
        the signature bytes live in the commit-level aggregate, so a
        non-absent entry must carry an EMPTY per-sig column."""
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present for absent CommitSig")
            if not self.timestamp.is_zero():
                raise ValueError("time is present for absent CommitSig")
            if self.signature:
                raise ValueError("signature is present for absent CommitSig")
        else:
            if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
                raise ValueError("expected ValidatorAddress size to be 20 bytes")
            if aggregated:
                if self.signature:
                    raise ValueError(
                        "per-signature bytes present in aggregate commit"
                    )
            else:
                if not self.signature:
                    raise ValueError("signature is missing")
                if len(self.signature) > MAX_SIGNATURE_SIZE:
                    raise ValueError("signature is too big")


# types/signable.go MaxSignatureSize is 96, sized for compressed bn254 G2;
# this system's bn254 signatures are UNCOMPRESSED G2 (crypto/bn254.py
# SIGNATURE_SIZE = 128), so per-vote bn254 commits need the extra room.
MAX_SIGNATURE_SIZE = 128
# Aggregate-commit wire form: one bn254 G2 sum, 64 bytes compressed in new
# blocks; the uncompressed 128-byte form stays accepted, so that older blocks
# keep validating.
AGG_SIGNATURE_SIZE = 128
AGG_SIGNATURE_SIZE_COMPRESSED = 64


@dataclass
class Commit:
    """types/block.go:745-930."""

    height: int = 0
    round: int = 0
    block_id: BlockID = dfield(default_factory=BlockID)
    signatures: list = dfield(default_factory=list)
    # Aggregate wire form (CMTPU_AGG_COMMITS): one G2 sum over every
    # non-absent signature plus a signer bitmap; the per-sig columns above
    # are then empty. Both empty = the per-vote form, byte-identical on the
    # wire (fields 5/6 are simply not emitted).
    agg_signature: bytes = b""
    agg_bitmap: bytes = b""
    _hash: bytes | None = dfield(default=None, compare=False, repr=False)
    _sb_cache: tuple | None = dfield(default=None, compare=False, repr=False)
    _sba_cache: tuple | None = dfield(default=None, compare=False, repr=False)

    def size(self) -> int:
        return len(self.signatures)

    def is_aggregate(self) -> bool:
        return bool(self.agg_signature)

    def agg_signer(self, idx: int) -> bool:
        """Whether validator idx's signature is folded into agg_signature."""
        byte = idx >> 3
        if byte >= len(self.agg_bitmap):
            return False
        return bool(self.agg_bitmap[byte] & (1 << (idx & 7)))

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [cs.encode() for cs in self.signatures]
            )
        return self._hash

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Reconstruct the canonical signed vote of validator val_idx
        (types/block.go:785-813) — per-sig timestamps make every batch entry
        distinct message bytes.

        Hot path: VerifyCommitLight(10k validators) calls this once per
        signature, but type/height/round/block_id/chain_id are commit-wide
        constants — only field 5 (timestamp) varies. The canonical prefix
        (one per BlockIDFlag: commit block_id vs nil's dropped block_id) and
        the chain_id suffix are built once and cached; per call this splices
        the timestamp and re-runs only the outer length delimiter."""
        cs = self.signatures[val_idx]
        _, pre_commit, pre_nil, suffix = self._sign_bytes_cache(chain_id)
        prefix = pre_commit if cs.for_block_flag() else pre_nil
        return self._splice_sign_bytes(prefix, suffix, cs)

    def _sign_bytes_cache(self, chain_id: str) -> tuple:
        from cometbft_tpu_torch.types import canonical

        cache = self._sb_cache
        if cache is None or cache[0] != chain_id:
            head = (
                wire.field_varint(1, PRECOMMIT_TYPE)
                + wire.field_sfixed64(2, self.height)
                + wire.field_sfixed64(3, self.round)
            )
            cbid = canonical.canonical_block_id_bytes(self.block_id)
            pre_commit = head + (
                wire.field_message(4, cbid, emit_empty=True)
                if cbid is not None
                else b""
            )
            self._sb_cache = cache = (
                chain_id, pre_commit, head, wire.field_string(6, chain_id)
            )
        return cache

    def vote_sign_bytes_all(self, chain_id: str) -> list:
        """Every validator's canonical sign bytes at once — the batch-verify
        feeder. Vectorized over the commit with numpy: per-signature work is
        two varints spliced into a shared template, so the whole 10k-row
        build is a handful of array passes grouped by byte layout
        (flag x varint widths). Byte-identical to vote_sign_bytes(i).

        Memoized per (chain_id, commit): the light client's trusting and
        light checks of one hop, plus a bisection descent revisiting pivot
        commits, would otherwise rebuild the same 4k-row list several times
        per descent. Commits are immutable after construction (the same
        contract _hash and _sb_cache rely on)."""
        cached = self._sba_cache
        if cached is not None and cached[0] == chain_id:
            return cached[1]
        n = len(self.signatures)
        if n < 64:
            out = [self.vote_sign_bytes(chain_id, i) for i in range(n)]
            self._sba_cache = (chain_id, out)
            return out
        import numpy as np

        _, pre_commit, pre_nil, suffix = self._sign_bytes_cache(chain_id)

        secs = np.fromiter(
            (cs.timestamp.seconds for cs in self.signatures), np.int64, n
        ).view(np.uint64)
        nanos = np.fromiter(
            (cs.timestamp.nanos for cs in self.signatures), np.int64, n
        ).view(np.uint64)
        flags = np.fromiter(
            (cs.for_block_flag() for cs in self.signatures), bool, n
        )

        def varint_slots(v):
            slots = np.empty((n, 10), np.uint8)
            vv = v.copy()
            lens = np.ones(n, np.int64)
            for s in range(10):
                b = (vv & np.uint64(0x7F)).astype(np.uint8)
                vv = vv >> np.uint64(7)
                cont = vv != 0
                slots[:, s] = b | (cont.astype(np.uint8) << 7)
                if s:
                    lens += (v >> np.uint64(7 * s)) != 0
            return slots, lens

        sec_slots, sec_lens = varint_slots(secs)
        nano_slots, nano_lens = varint_slots(nanos)
        has_sec = secs != 0
        has_nano = nanos != 0
        ts_lens = has_sec * (1 + sec_lens) + has_nano * (1 + nano_lens)

        out: list = [None] * n
        # Group rows with identical byte layout; realistic commits produce
        # one or two groups (same epoch -> same sec width; nano width 1..5).
        key = (
            flags.astype(np.int64) * 10000
            + has_sec * 1000
            + sec_lens * has_sec * 100
            + has_nano * 10
            + nano_lens * has_nano
        )
        for k in np.unique(key):
            rows = np.nonzero(key == k)[0]
            r0 = rows[0]
            prefix = pre_commit if flags[r0] else pre_nil
            tsl = int(ts_lens[r0])
            body_len = len(prefix) + 2 + tsl + len(suffix)
            outer = wire.encode_uvarint(body_len)
            total = len(outer) + body_len
            g = len(rows)
            m = np.empty((g, total), np.uint8)
            pos = 0
            for const in (outer, prefix, bytes([0x2A, tsl])):
                m[:, pos : pos + len(const)] = np.frombuffer(const, np.uint8)
                pos += len(const)
            if has_sec[r0]:
                m[:, pos] = 0x08
                sl = int(sec_lens[r0])
                m[:, pos + 1 : pos + 1 + sl] = sec_slots[rows, :sl]
                pos += 1 + sl
            if has_nano[r0]:
                m[:, pos] = 0x10
                nl = int(nano_lens[r0])
                m[:, pos + 1 : pos + 1 + nl] = nano_slots[rows, :nl]
                pos += 1 + nl
            m[:, pos : pos + len(suffix)] = np.frombuffer(suffix, np.uint8)
            buf = m.tobytes()
            for j, i in enumerate(rows):
                out[i] = buf[j * total : (j + 1) * total]
        self._sba_cache = (chain_id, out)
        return out

    @staticmethod
    def _splice_sign_bytes(prefix: bytes, suffix: bytes, cs) -> bytes:
        # Inline Timestamp{1: seconds varint, 2: nanos varint} + the field-5
        # and outer length delimiters: this runs once per signature in
        # VerifyCommitLight(10k), where the generic wire helpers' call
        # overhead dominates.
        ts = bytearray()
        sec = cs.timestamp.seconds
        if sec:
            if sec < 0:
                sec += 1 << 64
            ts.append(0x08)
            while sec > 0x7F:
                ts.append(sec & 0x7F | 0x80)
                sec >>= 7
            ts.append(sec)
        nano = cs.timestamp.nanos
        if nano:
            if nano < 0:
                nano += 1 << 64
            ts.append(0x10)
            while nano > 0x7F:
                ts.append(nano & 0x7F | 0x80)
                nano >>= 7
            ts.append(nano)
        out = prefix + b"\x2a" + wire.encode_uvarint(len(ts)) + ts + suffix
        return wire.encode_uvarint(len(out)) + out

    def encode(self) -> bytes:
        out = wire.field_varint(1, self.height)
        out += wire.field_varint(2, self.round)
        out += wire.field_message(3, self.block_id.encode(), emit_empty=True)
        for cs in self.signatures:
            out += wire.field_message(4, cs.encode(), emit_empty=True)
        if self.agg_signature:
            out += wire.field_bytes(5, self.agg_signature)
            out += wire.field_bytes(6, self.agg_bitmap)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Commit":
        f = wire.decode_fields(data)
        return cls(
            height=wire.get_varint(f, 1),
            round=wire.get_varint(f, 2),
            block_id=BlockID.decode(wire.get_bytes(f, 3)),
            signatures=[CommitSig.decode(b) for b in wire.get_repeated_bytes(f, 4)],
            agg_signature=wire.get_bytes(f, 5),
            agg_bitmap=wire.get_bytes(f, 6),
        )

    def validate_basic(self) -> None:
        """types/block.go:860-893, plus the aggregate-form consistency rules:
        the bitmap must mirror the non-absent entries exactly, every per-sig
        column must be empty, and the G2 point is 64 (compressed) or 128
        (uncompressed) bytes."""
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.agg_bitmap and not self.agg_signature:
            raise ValueError("aggregate bitmap without aggregate signature")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            aggregated = self.is_aggregate()
            if aggregated:
                if len(self.agg_signature) not in (
                    AGG_SIGNATURE_SIZE,
                    AGG_SIGNATURE_SIZE_COMPRESSED,
                ):
                    raise ValueError(
                        "aggregate signature must be 64 (compressed) or "
                        "128 bytes (bn254 G2)"
                    )
                n = len(self.signatures)
                if len(self.agg_bitmap) != (n + 7) // 8:
                    raise ValueError("aggregate bitmap length mismatch")
                if n % 8 and self.agg_bitmap[-1] >> (n % 8):
                    raise ValueError(
                        "aggregate bitmap has bits past the validator count"
                    )
            for i, cs in enumerate(self.signatures):
                try:
                    cs.validate_basic(aggregated=aggregated)
                except ValueError as e:
                    raise ValueError(f"wrong CommitSig #{i}: {e}") from e
                if aggregated and self.agg_signer(i) == cs.is_absent():
                    raise ValueError(
                        f"aggregate bitmap disagrees with CommitSig #{i}"
                    )


def aggregate_commit(commit: "Commit", vals) -> "Commit":
    """Compress a per-vote commit into the aggregate wire form (one G2 sum +
    a signer bitmap) when every participating validator key is bn254
    (CMTPU_AGG_COMMITS call sites). Anything else — mixed key types, a
    malformed signature, an empty commit — returns the input unchanged: the
    per-vote form is always valid, so this can only shrink the wire.

    Only a block's LastCommit goes through here; a node's stored seen
    commit keeps per-vote signatures, so that a restart can rebuild the
    VoteSet from it.
    """
    from cometbft_tpu_torch.crypto import bn254

    if commit.agg_signature or not commit.signatures or vals is None:
        return commit
    if vals.size() != len(commit.signatures):
        return commit
    raw: list = []
    bitmap = bytearray((len(commit.signatures) + 7) // 8)
    for i, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        pk = vals.validators[i].pub_key
        if pk is None or pk.type() != bn254.KEY_TYPE:
            return commit
        raw.append(cs.signature)
        bitmap[i >> 3] |= 1 << (i & 7)
    if not raw:
        return commit
    try:
        agg = bn254.aggregate_signatures_compressed(raw)
    except (ValueError, TypeError):
        # An admitted vote with an unparseable signature would be a bug
        # upstream; never let it block block production — ship per-vote.
        return commit
    stripped = [
        cs
        if cs.is_absent()
        else CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, b"")
        for cs in commit.signatures
    ]
    return Commit(
        height=commit.height,
        round=commit.round,
        block_id=commit.block_id,
        signatures=stripped,
        agg_signature=agg,
        agg_bitmap=bytes(bitmap),
    )


# SignedMsgType values (proto/tendermint/types/types.proto).
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


@dataclass(frozen=True)
class SignedHeader:
    """types/light.go SignedHeader: header + its commit."""

    header: Header
    commit: Commit

    def encode(self) -> bytes:
        return wire.field_message(1, self.header.encode(), emit_empty=True) + (
            wire.field_message(2, self.commit.encode(), emit_empty=True)
        )

    @classmethod
    def decode(cls, data: bytes) -> "SignedHeader":
        f = wire.decode_fields(data)
        return cls(
            Header.decode(wire.get_bytes(f, 1)), Commit.decode(wire.get_bytes(f, 2))
        )

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go SignedHeader.ValidateBasic."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}"
            )
        if self.header.height != self.commit.height:
            raise ValueError("header and commit height mismatch")
        hhash = self.header.hash()
        if hhash != self.commit.block_id.hash:
            raise ValueError("commit signs block which doesn't match the header")


@dataclass
class Data:
    """Block transactions (types/block.go Data)."""

    txs: list = dfield(default_factory=list)
    _hash: bytes | None = dfield(default=None, compare=False, repr=False)

    def hash(self) -> bytes:
        from cometbft_tpu_torch.types.tx import txs_hash

        if self._hash is None:
            self._hash = txs_hash(self.txs)
        return self._hash

    def encode(self) -> bytes:
        return b"".join(wire.field_bytes(1, tx, emit_default=True) for tx in self.txs)

    @classmethod
    def decode(cls, data: bytes) -> "Data":
        f = wire.decode_fields(data)
        return cls(txs=wire.get_repeated_bytes(f, 1))


@dataclass
class Block:
    """types/block.go:43-170."""

    header: Header = dfield(default_factory=Header)
    data: Data = dfield(default_factory=Data)
    evidence: list = dfield(default_factory=list)  # list of Evidence
    last_commit: Commit | None = None
    _hash: bytes | None = dfield(default=None, compare=False, repr=False)

    def hash(self) -> bytes | None:
        """Header hash (types/block.go:123)."""
        if self.last_commit is None and self.header.height > 1:
            return None
        return self.header.hash()

    def validate_basic(self) -> None:
        """Re-derives LastCommitHash/DataHash/EvidenceHash (types/block.go:56-107)."""
        self.header.validate_basic()
        if self.header.height > 1:
            if self.last_commit is None:
                raise ValueError("nil LastCommit")
            self.last_commit.validate_basic()
        if self.last_commit is not None:
            if self.header.last_commit_hash != self.last_commit.hash():
                raise ValueError("wrong Header.LastCommitHash")
        elif self.header.last_commit_hash:
            raise ValueError("wrong Header.LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong Header.DataHash")
        from cometbft_tpu_torch.types.evidence import evidence_list_hash

        if self.header.evidence_hash != evidence_list_hash(self.evidence):
            raise ValueError("wrong Header.EvidenceHash")

    def encode(self) -> bytes:
        from cometbft_tpu_torch.types.evidence import encode_evidence_list

        out = wire.field_message(1, self.header.encode(), emit_empty=True)
        out += wire.field_message(2, self.data.encode(), emit_empty=True)
        out += wire.field_message(3, encode_evidence_list(self.evidence), emit_empty=True)
        if self.last_commit is not None:
            out += wire.field_message(4, self.last_commit.encode(), emit_empty=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        from cometbft_tpu_torch.types.evidence import decode_evidence_list

        f = wire.decode_fields(data)
        last_commit = None
        if 4 in f:
            last_commit = Commit.decode(wire.get_bytes(f, 4))
        return cls(
            header=Header.decode(wire.get_bytes(f, 1)),
            data=Data.decode(wire.get_bytes(f, 2)),
            evidence=decode_evidence_list(wire.get_bytes(f, 3)),
            last_commit=last_commit,
        )

    def make_part_set(self, part_size: int = BLOCK_PART_SIZE_BYTES):
        """The block's parts and their proofs (``PartSet.from_data``, whose
        proofs take ``crypto/merkle.proofs_from_byte_slices``)."""
        from cometbft_tpu_torch.types.part_set import PartSet

        return PartSet.from_data(self.encode(), part_size)


@dataclass(frozen=True)
class BlockMeta:
    """types/block_meta.go."""

    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def encode(self) -> bytes:
        out = wire.field_message(1, self.block_id.encode(), emit_empty=True)
        out += wire.field_varint(2, self.block_size)
        out += wire.field_message(3, self.header.encode(), emit_empty=True)
        out += wire.field_varint(4, self.num_txs)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "BlockMeta":
        f = wire.decode_fields(data)
        return cls(
            block_id=BlockID.decode(wire.get_bytes(f, 1)),
            block_size=wire.get_varint(f, 2),
            header=Header.decode(wire.get_bytes(f, 3)),
            num_txs=wire.get_varint(f, 4),
        )
