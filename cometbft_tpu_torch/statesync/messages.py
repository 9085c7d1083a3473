"""Statesync wire messages (proto/tendermint/statesync/types.proto,
statesync/reactor.go:19-22 channels 0x60/0x61), the port's copy of
``cometbft_tpu/statesync/messages.py``.

Envelope: oneof-style outer message, one tag per variant — the same codec
shape as blocksync (blocksync/reactor.py)."""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.wire import proto

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

_TAG_SNAPSHOTS_REQUEST = 1
_TAG_SNAPSHOTS_RESPONSE = 2
_TAG_CHUNK_REQUEST = 3
_TAG_CHUNK_RESPONSE = 4


@dataclass
class SnapshotsRequest:
    pass


@dataclass
class SnapshotsResponse:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""

    def key(self) -> tuple:
        """Identity of a snapshot across peers (statesync/snapshots.go)."""
        return (self.height, self.format, self.chunks, self.hash)


@dataclass
class ChunkRequest:
    height: int = 0
    format: int = 0
    index: int = 0


@dataclass
class ChunkResponse:
    height: int = 0
    format: int = 0
    index: int = 0
    chunk: bytes = b""
    missing: bool = False


def encode(msg) -> bytes:
    if isinstance(msg, SnapshotsRequest):
        return proto.field_message(_TAG_SNAPSHOTS_REQUEST, b"", emit_empty=True)
    if isinstance(msg, SnapshotsResponse):
        inner = (
            proto.field_varint(1, msg.height)
            + proto.field_varint(2, msg.format)
            + proto.field_varint(3, msg.chunks)
            + proto.field_bytes(4, msg.hash)
            + proto.field_bytes(5, msg.metadata)
        )
        return proto.field_message(_TAG_SNAPSHOTS_RESPONSE, inner, emit_empty=True)
    if isinstance(msg, ChunkRequest):
        inner = (
            proto.field_varint(1, msg.height)
            + proto.field_varint(2, msg.format)
            + proto.field_varint(3, msg.index)
        )
        return proto.field_message(_TAG_CHUNK_REQUEST, inner, emit_empty=True)
    if isinstance(msg, ChunkResponse):
        inner = (
            proto.field_varint(1, msg.height)
            + proto.field_varint(2, msg.format)
            + proto.field_varint(3, msg.index)
            + proto.field_bytes(4, msg.chunk)
            + proto.field_bool(5, msg.missing)
        )
        return proto.field_message(_TAG_CHUNK_RESPONSE, inner, emit_empty=True)
    raise TypeError(f"unknown statesync message {type(msg)}")


def decode(data: bytes):
    fields = proto.decode_fields(data)
    if _TAG_SNAPSHOTS_REQUEST in fields:
        return SnapshotsRequest()
    if _TAG_SNAPSHOTS_RESPONSE in fields:
        f = proto.decode_fields(fields[_TAG_SNAPSHOTS_RESPONSE][-1])
        return SnapshotsResponse(
            height=proto.get_uvarint(f, 1),
            format=proto.get_uvarint(f, 2),
            chunks=proto.get_uvarint(f, 3),
            hash=proto.get_bytes(f, 4),
            metadata=proto.get_bytes(f, 5),
        )
    if _TAG_CHUNK_REQUEST in fields:
        f = proto.decode_fields(fields[_TAG_CHUNK_REQUEST][-1])
        return ChunkRequest(
            height=proto.get_uvarint(f, 1),
            format=proto.get_uvarint(f, 2),
            index=proto.get_uvarint(f, 3),
        )
    if _TAG_CHUNK_RESPONSE in fields:
        f = proto.decode_fields(fields[_TAG_CHUNK_RESPONSE][-1])
        return ChunkResponse(
            height=proto.get_uvarint(f, 1),
            format=proto.get_uvarint(f, 2),
            index=proto.get_uvarint(f, 3),
            chunk=proto.get_bytes(f, 4),
            missing=proto.get_bool(f, 5),
        )
    raise ValueError("unknown statesync message")
