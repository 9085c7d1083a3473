"""Minimal deterministic protobuf encoder and decoder: the subset of the
proto3 wire format the sidecar's framed protocol and the canonical data
structures (``types/``) use.

Counterpart of ``cometbft_tpu/wire/proto.py`` (its field helpers, stdlib
only), so the port puts the same bytes on the wire as the reference. Proto3
rules: default-valued scalar fields are omitted unless asked for; fields go
out in ascending field-number order; ``bytes``, ``string`` and embedded
messages are length-delimited; canonical height and round are ``sfixed64``
(types/canonical.go).
"""

from __future__ import annotations

import struct

# Wire types
WT_VARINT = 0
WT_FIXED64 = 1
WT_LEN = 2
WT_FIXED32 = 5

_UVARINT_1B = [bytes((v,)) for v in range(0x80)]


def encode_uvarint(n: int) -> bytes:
    if n < 0x80:
        if n < 0:
            raise ValueError("uvarint cannot encode negative")
        return _UVARINT_1B[n]
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf: bytes, pos: int = 0) -> tuple[int, int]:
    """At most 10 bytes / 64 bits, as Go's binary.Uvarint and protobuf."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        if shift >= 70:
            raise ValueError("varint too long")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result >= 1 << 64:
                raise ValueError("varint overflows 64 bits")
            return result, pos
        shift += 7


def encode_varint_signed(n: int) -> bytes:
    """proto ``int64``: negative values are 10-byte two's complement varints."""
    if n < 0:
        n += 1 << 64
    return encode_uvarint(n)


def tag(field_num: int, wire_type: int) -> bytes:
    return encode_uvarint((field_num << 3) | wire_type)


def field_varint(field_num: int, value: int, *, emit_default: bool = False) -> bytes:
    if value == 0 and not emit_default:
        return b""
    return tag(field_num, WT_VARINT) + encode_varint_signed(value)


def field_bool(field_num: int, value: bool, *, emit_default: bool = False) -> bytes:
    if not value and not emit_default:
        return b""
    return tag(field_num, WT_VARINT) + (b"\x01" if value else b"\x00")


def field_bytes(field_num: int, value: bytes, *, emit_default: bool = False) -> bytes:
    if not value and not emit_default:
        return b""
    return tag(field_num, WT_LEN) + encode_uvarint(len(value)) + value


def field_string(field_num: int, value: str, *, emit_default: bool = False) -> bytes:
    return field_bytes(field_num, value.encode("utf-8"), emit_default=emit_default)


def field_sfixed64(field_num: int, value: int, *, emit_default: bool = False) -> bytes:
    if value == 0 and not emit_default:
        return b""
    return tag(field_num, WT_FIXED64) + struct.pack("<q", value)


def field_message(field_num: int, encoded: bytes | None, *, emit_empty: bool = False) -> bytes:
    """An embedded message field. None is absent; an empty encoding is
    still emitted under ``emit_empty`` (gogoproto non-nullable fields)."""
    if encoded is None:
        return b""
    if not encoded and not emit_empty:
        return b""
    return tag(field_num, WT_LEN) + encode_uvarint(len(encoded)) + encoded


def encode_bytes_len_prefixed(bz: bytes) -> bytes:
    """uvarint length prefix + raw bytes (types/encoding_helper.go
    cdcEncode-style helpers / libs protoio delimited writing)."""
    return encode_uvarint(len(bz)) + bz


def length_delimited(encoded: bytes) -> bytes:
    """A whole message behind its uvarint length (protoio.MarshalDelimited),
    as canonical vote and proposal sign bytes are framed."""
    return encode_uvarint(len(encoded)) + encoded


# -- decoding: a tolerant field walker -> {field_num: [raw values]}, a raw
# value being an int (varint) or bytes (length-delimited, fixed64, fixed32)


def decode_fields(buf: bytes) -> dict[int, list]:
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = decode_uvarint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            val, pos = decode_uvarint(buf, pos)
        elif wt == WT_FIXED64:
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64")
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == WT_LEN:
            ln, pos = decode_uvarint(buf, pos)
            if pos + ln > len(buf):
                raise ValueError("truncated length-delimited field")
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == WT_FIXED32:
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32")
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(fnum, []).append(val)
    return fields


# Getters raise ValueError on wire-type confusion (a varint where bytes were
# expected, or the reverse): adversarial inputs fail to decode cleanly.


def get_varint(fields: dict, num: int, default: int = 0) -> int:
    """A signed ``int64`` field (two's complement in 64 bits)."""
    v = get_uvarint(fields, num, default)
    return v - (1 << 64) if v >= 1 << 63 else v


def get_uvarint(fields: dict, num: int, default: int = 0) -> int:
    vals = fields.get(num)
    if not vals:
        return default
    v = vals[-1]
    if not isinstance(v, int):
        raise ValueError(f"field {num}: expected varint, got length-delimited")
    return v


def get_bool(fields: dict, num: int) -> bool:
    return bool(get_uvarint(fields, num, 0))


def get_bytes(fields: dict, num: int, default: bytes = b"") -> bytes:
    vals = fields.get(num)
    if not vals:
        return default
    v = vals[-1]
    if not isinstance(v, bytes):
        raise ValueError(f"field {num}: expected length-delimited, got varint")
    return v


def get_string(fields: dict, num: int, default: str = "") -> str:
    v = get_bytes(fields, num, None)
    if v is None:
        return default
    try:
        return v.decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError(f"field {num}: invalid utf-8 string") from None


def get_repeated_bytes(fields: dict, num: int) -> list[bytes]:
    vals = fields.get(num, [])
    if any(not isinstance(v, bytes) for v in vals):
        raise ValueError(f"field {num}: expected length-delimited, got varint")
    return list(vals)


def get_repeated_uvarint(fields: dict, num: int) -> list[int]:
    """A repeated uvarint field, unpacked (one varint a tag) or proto3
    packed (one length-delimited run of varints)."""
    out: list[int] = []
    for v in fields.get(num, []):
        if isinstance(v, int):
            out.append(v)
        else:
            pos = 0
            while pos < len(v):
                val, pos = decode_uvarint(v, pos)
                out.append(val)
    return out
