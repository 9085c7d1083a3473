"""Consensus write-ahead log (consensus/wal.go), the port's copy of
``cometbft_tpu/consensus/wal.py``: the same frames, so each package reads
the other's files.

Every message is written BEFORE processing so a crashed node can replay to
exactly where it left off (wal.go:19-30). Framing matches the reference's
encoder (wal.go:300-340): crc32(IEEE) of payload [4B BE] || length [4B BE]
|| payload, where payload is an encoded TimedWALMessage. An EndHeightMessage
marks each committed height (the replay anchor, consensus/state.go:1686).

Message payloads use a compact tagged encoding (type byte + proto bytes) —
the WAL is node-local, not a wire protocol.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

from cometbft_tpu_torch.types import cmttime
from cometbft_tpu_torch.types.cmttime import Time

MAX_MSG_SIZE_BYTES = 1048576  # 1MB (wal.go maxMsgSizeBytes)

# WAL message type tags.
MSG_END_HEIGHT = 0x01
MSG_PROPOSAL = 0x02
MSG_BLOCK_PART = 0x03
MSG_VOTE = 0x04
MSG_TIMEOUT = 0x05
MSG_EVENT_ROUND_STATE = 0x06
MSG_HAS_VOTE = 0x07


class EndHeightMessage:
    """wal.go EndHeightMessage: height H is irrevocably committed."""

    def __init__(self, height: int):
        self.height = height

    def __eq__(self, other):
        return isinstance(other, EndHeightMessage) and other.height == self.height


class TimedWALMessage:
    def __init__(self, time: Time, msg):
        self.time = time
        self.msg = msg


class WALWriteError(Exception):
    pass


class DataCorruptionError(Exception):
    """wal.go DataCorruptionError: checksum/length failures during decode."""


class WAL:
    """consensus/wal.go baseWAL over a rotating autofile Group: CRC-framed
    frames appended to the head file, rotated at head_size_limit so the WAL
    no longer grows unboundedly in one file (libs/autofile/group.go)."""

    def __init__(self, path: str, codec=None, head_size_limit: int = 10 * 1024 * 1024):
        from cometbft_tpu_torch.libs.autofile import Group

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._codec = codec or _default_codec
        self._decode = _default_decode
        self.group = Group(path, head_size_limit=head_size_limit)
        self._mtx = threading.Lock()
        self._running = True
        # Group commit (CMTPU_WAL_GROUP_MS > 0): concurrent write_sync
        # callers share one fsync — a leader holds a short window open,
        # then syncs once for every frame appended so far. Durability is
        # NEVER weakened: a caller returns only after an fsync that covers
        # its own frame (whole-message durability; the fsync-before-
        # processing invariant of state.go:774 holds unchanged). Default 0
        # keeps the exact serial write+fsync path.
        self._group_ms = float(os.environ.get("CMTPU_WAL_GROUP_MS", "") or 0.0)
        self._sync_cond = threading.Condition()
        self._seq = 0  # frames appended through write_sync
        self._synced = 0  # highest seq covered by a completed fsync
        self._sync_leader = False
        self.group_commits = 0  # fsyncs that covered more than one caller
        self.group_syncs = 0  # total group-path fsyncs

    def start(self) -> None:
        """OnStart writes EndHeightMessage(0) into an empty WAL (wal.go:110)."""
        if os.path.getsize(self.path) == 0 and not self.group.chunk_indices():
            self.write_sync(EndHeightMessage(0))

    def write(self, msg) -> None:
        """Buffered write (wal.go Write; group-buffered in the reference)."""
        if not self._running:
            return
        data = _encode_timed(self._codec, TimedWALMessage(cmttime.now(), msg))
        with self._mtx:
            self.group.write(data)

    def write_sync(self, msg) -> None:
        """Write + fsync — used for own messages so the node never signs
        without the intent being durable (wal.go WriteSync,
        consensus/state.go:774). Rotation is checked AFTER the frame lands
        so a record never splits across chunk files."""
        if not self._running:
            return
        data = _encode_timed(self._codec, TimedWALMessage(cmttime.now(), msg))
        if self._group_ms <= 0:
            with self._mtx:
                self.group.write(data)
                self.group.flush_and_sync()
            self.group.maybe_rotate()
            return
        with self._mtx:
            self.group.write(data)
            self._seq += 1
            my_seq = self._seq
        while True:
            with self._sync_cond:
                if self._synced >= my_seq:
                    return  # a leader's fsync already covered our frame
                if not self._sync_leader:
                    self._sync_leader = True
                    break
                self._sync_cond.wait(0.05)
        # Leader: hold the window open so concurrent writers can append,
        # then fsync once for everyone appended so far. On failure the
        # leadership is released (a follower retakes it and retries) and
        # the error propagates to our caller like the serial path would.
        try:
            time.sleep(self._group_ms / 1000.0)
            with self._mtx:
                target = self._seq
                if self._running:
                    self.group.flush_and_sync()
            self.group.maybe_rotate()
            with self._sync_cond:
                if target - self._synced > 1:
                    self.group_commits += 1
                self.group_syncs += 1
                self._synced = max(self._synced, target)
        finally:
            with self._sync_cond:
                self._sync_leader = False
                self._sync_cond.notify_all()

    def flush_and_sync(self) -> None:
        with self._mtx:
            self.group.flush_and_sync()

    def stop(self) -> None:
        with self._mtx:
            if self._running:
                self._running = False
                self.group.close()

    def reopen(self) -> None:
        """Re-open the append handle after an external rewrite (the repair
        path: state.go loadWalFile after repairWalFile)."""
        with self._mtx:
            self.group.reopen()
            self._running = True

    # -- reading / replay -----------------------------------------------------

    def has_end_height(self, height: int) -> bool:
        """Sanity probe: does ANY intact frame carry EndHeightMessage(height)?
        Tolerant of corruption (wal.go SearchForEndHeight with
        IgnoreDataCorruptionErrors) — skippable bad frames are skipped, an
        unskippable tail ends the scan."""
        for ok, tm in self._scan_frames():
            if ok and isinstance(tm.msg, EndHeightMessage) and tm.msg.height == height:
                return True
        return False

    def catchup_scan(self, end_height: int, cs_height: int | None):
        """One pass serving both catchup questions (replay.go:93-120):
        returns (messages after the LAST EndHeightMessage(end_height) or None
        if that marker is absent, whether EndHeightMessage(cs_height) was
        seen). The marker search tolerates corruption in earlier heights; a
        corrupt frame AFTER the marker (the height being replayed) raises
        DataCorruptionError so the caller can repair the WAL."""
        after: list | None = None
        saw_cs = False
        for ok, tm in self._scan_frames():
            if ok and isinstance(tm.msg, EndHeightMessage):
                if cs_height is not None and tm.msg.height == cs_height:
                    saw_cs = True
                if tm.msg.height == end_height:
                    after = []  # restart collection at the latest marker
                    continue
            if after is None:
                continue  # still searching; corruption here is ignorable
            if not ok:
                raise DataCorruptionError(tm)
            after.append(tm)
        return after, saw_cs

    def _scan_frames(self):
        """Yield (True, TimedWALMessage) per intact frame and (False, reason)
        per skippable corrupt frame (bad CRC with a plausible length — the
        reader can still advance); stop silently at a truncated/garbage tail
        (no resync possible without the reference's per-file groups)."""
        with self.group.reader() as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                crc, length = struct.unpack(">II", hdr)
                if length > MAX_MSG_SIZE_BYTES:
                    return  # garbage length: cannot resync
                payload = f.read(length)
                if len(payload) < length:
                    return  # truncated tail
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    yield False, "checksums do not match"
                    continue
                try:
                    yield True, _decode_timed(self._decode, payload)
                except Exception as e:
                    yield False, f"undecodable payload: {e}"

    def iter_messages(self):
        """Decode every frame; raises DataCorruptionError on a bad frame."""
        with self.group.reader() as f:
            yield from _read_frames(f, self._decode)


def read_messages(path: str) -> list:
    """Every TimedWALMessage of the WAL at ``path`` (its rotated chunks
    first, then the head), without opening it for writing; raises
    DataCorruptionError on a bad frame."""
    from cometbft_tpu_torch.libs.autofile import _GroupReader, group_paths

    with _GroupReader(group_paths(path)) as f:
        return list(_read_frames(f, _default_decode))


def _read_frames(f, decode):
    while True:
        hdr = f.read(8)
        if len(hdr) == 0:
            return
        if len(hdr) < 8:
            raise DataCorruptionError("truncated frame header")
        crc, length = struct.unpack(">II", hdr)
        if length > MAX_MSG_SIZE_BYTES:
            raise DataCorruptionError(
                f"length {length} exceeds maximum possible value"
            )
        payload = f.read(length)
        if len(payload) < length:
            raise DataCorruptionError("truncated frame payload")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise DataCorruptionError("checksums do not match")
        yield _decode_timed(decode, payload)


def _repair_scan(src_path: str):
    """Yield (ok, frame_bytes, is_end_height) per frame; ok=False for
    skippable bad frames (bad CRC or undecodable payload with a plausible
    length). Stops at an unskippable tail (garbage length / truncation)."""
    with open(src_path, "rb") as src:
        while True:
            hdr = src.read(8)
            if len(hdr) < 8:
                return
            crc, length = struct.unpack(">II", hdr)
            if length > MAX_MSG_SIZE_BYTES:
                return
            payload = src.read(length)
            if len(payload) < length:
                return
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                yield False, hdr + payload, False
                continue
            try:
                tm = _decode_timed(_default_decode, payload)
            except Exception:
                # CRC-valid but undecodable (e.g. foreign tag byte): keeping
                # it would make every repair attempt a no-op — drop it.
                yield False, hdr + payload, False
                continue
            yield True, hdr + payload, isinstance(tm.msg, EndHeightMessage)


def repair_wal(src_path: str, dst_path: str) -> int:
    """Rewrite the WAL keeping a gap-free replayable suffix
    (consensus/state.go:320-360 corrupted-WAL repair): skippable bad frames
    BEFORE the last EndHeightMessage are dropped (old heights — replay skips
    them anyway), and the file is truncated at the first bad frame AFTER the
    last marker (the torn-write tail: replaying past a gap could replay
    messages out of order). Returns frames kept."""
    frames = list(_repair_scan(src_path))
    last_marker = -1
    for i, (ok, _, is_end) in enumerate(frames):
        if ok and is_end:
            last_marker = i
    kept = 0
    with open(dst_path, "wb") as dst:
        for i, (ok, raw, _) in enumerate(frames):
            if not ok:
                if i <= last_marker:
                    continue  # droppable old-height frame
                break  # first gap after the marker: stop
            dst.write(raw)
            kept += 1
    return kept


# -- codec --------------------------------------------------------------------


def _encode_timed(codec, tm: TimedWALMessage) -> bytes:
    body = struct.pack(">qi", tm.time.seconds, tm.time.nanos) + codec(tm.msg)
    if len(body) > MAX_MSG_SIZE_BYTES:
        raise WALWriteError(f"msg is too big: {len(body)} bytes")
    return struct.pack(">II", zlib.crc32(body) & 0xFFFFFFFF, len(body)) + body


def _decode_timed(decode, payload: bytes) -> TimedWALMessage:
    secs, nanos = struct.unpack(">qi", payload[:12])
    return TimedWALMessage(Time(secs, nanos), decode(payload[12:]))


def _default_codec(msg) -> bytes:
    """Tag + payload; consensus messages provide .encode()."""
    from cometbft_tpu_torch.consensus import messages as cmsg

    if isinstance(msg, EndHeightMessage):
        from cometbft_tpu_torch.wire import proto as wire

        return bytes([MSG_END_HEIGHT]) + wire.encode_varint_signed(msg.height)
    return cmsg.encode_wal_message(msg)


def _default_decode(data: bytes):
    from cometbft_tpu_torch.consensus import messages as cmsg

    tag = data[0]
    if tag == MSG_END_HEIGHT:
        from cometbft_tpu_torch.wire import proto as wire

        height, _ = wire.decode_varint_signed(data[1:], 0)
        return EndHeightMessage(height)
    return cmsg.decode_wal_message(data)
