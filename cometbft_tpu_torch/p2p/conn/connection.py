"""Multiplexed connection (p2p/conn/connection.go), the port's copy of
``cometbft_tpu/p2p/conn/connection.py``: the same packets on the wire.

N logical channels over one (secret) connection: per-channel priority queues
with recently-sent fairness accounting, global send/recv rate limiting,
ping/pong keep-alive, 10ms flush throttle. Packets are length-delimited
proto: Packet oneof {ping=1, pong=2, msg=3{channel_id, eof, data}}
(proto/tendermint/p2p/conn.proto); messages over max packet size are split
and reassembled at EOF markers.

``ChannelDescriptor`` is the one class of ``p2p/reactor.py``, imported here
where the reference defines it. ``stop`` counts a close that raised
(``close_errors``, ``last_close_error``; the reference passes over it).
"""

from __future__ import annotations

import queue
import threading
import time

from cometbft_tpu_torch.libs import flowrate
from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.p2p.conn import recvq
from cometbft_tpu_torch.p2p.reactor import ChannelDescriptor
from cometbft_tpu_torch.wire import proto as wire

DEFAULT_MAX_PACKET_MSG_PAYLOAD_SIZE = 1024
DEFAULT_SEND_RATE = 512000 * 10
DEFAULT_RECV_RATE = 512000 * 10
PING_INTERVAL = 60.0
PONG_TIMEOUT = 45.0
FLUSH_THROTTLE = 0.01
MAX_MSG_SIZE = 104857600


class UnknownChannelError(ValueError):
    """The remote sent a packet for a channel id this connection never
    registered — a peer-level protocol violation, surfaced through
    ``on_error`` so the switch tears the peer down (and, for persistent
    peers, redials)."""

    def __init__(self, chan_id: int):
        super().__init__(f"unknown channel {chan_id:#x}")
        self.chan_id = chan_id


class _Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.send_queue: queue.Queue[bytes] = queue.Queue(desc.send_queue_capacity)
        self.sending: bytes | None = None
        self.recently_sent = 0
        self.recving = b""


class MConnection:
    """conn/connection.go:78 MConnection."""

    def __init__(
        self,
        conn,
        channel_descs: list[ChannelDescriptor],
        on_receive,
        on_error,
        max_packet_msg_payload_size: int = DEFAULT_MAX_PACKET_MSG_PAYLOAD_SIZE,
        send_rate: int = DEFAULT_SEND_RATE,
        recv_rate: int = DEFAULT_RECV_RATE,
        clock=None,
    ):
        self._conn = conn
        self.channels = {d.id: _Channel(d) for d in channel_descs}
        self.on_receive = on_receive
        self.on_error = on_error
        self.max_payload = max_packet_msg_payload_size
        # libs/flowrate Monitors: throttling + rate telemetry per direction
        # (conn/connection.go sendMonitor/recvMonitor).
        self.send_monitor = flowrate.Monitor()
        self.recv_monitor = flowrate.Monitor()
        self._send_rate = send_rate
        self._recv_rate = recv_rate
        self._send_signal = threading.Event()
        self._running = False
        self._pong_pending = False
        self._last_msg_recv = time.monotonic()
        self.close_errors = 0
        self.last_close_error = None
        # Prioritized recv demux (CMTPU_RECVQ, default on): _recv_routine
        # frames + enqueues; the demux's drain thread delivers in priority
        # order.  Off = the historical inline delivery, verbatim.
        self._recvq = None
        if recvq.enabled():
            self._recvq = recvq.RecvQueues(
                lambda ch, msg: self.on_receive(ch, msg),
                channels=self.channels,
                clock=clock,
                on_error=self._fatal,
            )

    def start(self) -> None:
        self._running = True
        if self._recvq is not None:
            self._recvq.start()
        threads.spawn(self._send_routine)
        threads.spawn(self._recv_routine)

    def stop(self) -> None:
        self._running = False
        self._send_signal.set()
        if self._recvq is not None:
            self._recvq.stop()
        try:
            self._conn.close()
        except Exception as e:
            self.close_errors += 1
            self.last_close_error = e

    def recvq_stats(self) -> dict:
        """Demux counters ({} when the demux is disabled)."""
        return self._recvq.stats() if self._recvq is not None else {}

    def _fatal(self, e: Exception) -> None:
        """Shared death path for the send/recv/drain threads: stop once,
        surface the first error through on_error."""
        was_running = self._running
        self._running = False
        if self._recvq is not None:
            self._recvq.stop()
        if was_running and self.on_error:
            self.on_error(e)

    # -- sending (conn/connection.go:422 sendRoutine) -------------------------

    def send(self, channel_id: int, msg_bytes: bytes) -> bool:
        """Blocking enqueue (connection.go Send)."""
        ch = self.channels.get(channel_id)
        if ch is None or not self._running:
            return False
        try:
            ch.send_queue.put(msg_bytes, timeout=10)
        except queue.Full:
            return False
        self._send_signal.set()
        return True

    def try_send(self, channel_id: int, msg_bytes: bytes) -> bool:
        """Non-blocking enqueue (connection.go TrySend)."""
        ch = self.channels.get(channel_id)
        if ch is None or not self._running:
            return False
        try:
            ch.send_queue.put_nowait(msg_bytes)
        except queue.Full:
            return False
        self._send_signal.set()
        return True

    def _send_routine(self) -> None:
        last_ping = time.monotonic()
        while self._running:
            try:
                sent_any = self._send_some_packets()
                if self._pong_pending:
                    self._write_packet(wire.field_message(2, b"", emit_empty=True))
                    self._pong_pending = False
                if time.monotonic() - last_ping > PING_INTERVAL:
                    self._write_packet(wire.field_message(1, b"", emit_empty=True))
                    last_ping = time.monotonic()
                if not sent_any:
                    self._send_signal.wait(FLUSH_THROTTLE)
                    self._send_signal.clear()
            except Exception as e:
                self._fatal(e)
                return

    def _send_some_packets(self) -> bool:
        """Up to a batch of packets, least recently-sent channel first
        (connection.go sendSomePacketMsgs/sendPacketMsg)."""
        sent = False
        for _ in range(32):
            ch = self._next_channel_to_send()
            if ch is None:
                break
            self._send_packet_for(ch)
            sent = True
        return sent

    def _next_channel_to_send(self):
        best, best_ratio = None, None
        for ch in self.channels.values():
            if ch.sending is None:
                try:
                    ch.sending = ch.send_queue.get_nowait()
                except queue.Empty:
                    continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_packet_for(self, ch: _Channel) -> None:
        data = ch.sending
        chunk, rest = data[: self.max_payload], data[self.max_payload :]
        eof = len(rest) == 0
        pkt = (
            wire.field_varint(1, ch.desc.id)
            + wire.field_bool(2, eof)
            + wire.field_bytes(3, chunk)
        )
        self._write_packet(wire.field_message(3, pkt, emit_empty=True))
        ch.recently_sent += len(chunk)
        # decay fairness counter
        ch.recently_sent = int(ch.recently_sent * 0.8)
        ch.sending = rest if rest else None

    def _write_packet(self, packet_fields: bytes) -> None:
        framed = wire.length_delimited(packet_fields)
        self.send_monitor.limit(len(framed), self._send_rate)
        self.send_monitor.update(len(framed))
        self._conn.sendall(framed) if hasattr(self._conn, "sendall") else self._conn.write(framed)

    # -- receiving (conn/connection.go recvRoutine) ---------------------------

    def _recv_routine(self) -> None:
        """Thin framer: decode packets, reassemble messages at EOF markers,
        then hand off.  With the demux on, completed messages are enqueued
        into the per-channel recv queues and the demux's drain thread calls
        on_receive in priority order; off, delivery stays inline here."""
        while self._running:
            try:
                pkt = self._read_packet()
                self._last_msg_recv = time.monotonic()
                f = wire.decode_fields(pkt)
                if 1 in f:  # ping
                    self._pong_pending = True
                    self._send_signal.set()
                elif 2 in f:  # pong
                    pass
                elif 3 in f:
                    mf = wire.decode_fields(wire.get_bytes(f, 3))
                    chan_id = wire.get_uvarint(mf, 1)
                    eof = wire.get_bool(mf, 2)
                    data = wire.get_bytes(mf, 3)
                    ch = self.channels.get(chan_id)
                    if ch is None:
                        raise UnknownChannelError(chan_id)
                    ch.recving += data
                    if len(ch.recving) > ch.desc.recv_message_capacity:
                        raise ValueError("received message exceeds channel capacity")
                    if eof:
                        msg, ch.recving = ch.recving, b""
                        if self._recvq is not None:
                            self._recvq.push(chan_id, msg)
                        else:
                            self.on_receive(chan_id, msg)
            except Exception as e:
                self._fatal(e)
                return

    def _read_packet(self) -> bytes:
        hdr = b""
        while True:
            b = self._read_exact(1)
            hdr += b
            if not (b[0] & 0x80):
                break
            if len(hdr) > 10:
                raise ValueError("packet length varint too long")
        ln, _ = wire.decode_uvarint(hdr, 0)
        if ln > MAX_MSG_SIZE:
            raise ValueError("packet too large")
        # Rate-account the whole frame: the varint header was already read
        # off the wire above, so limiting only the payload undercounted
        # every packet by its header size.
        self.recv_monitor.limit(len(hdr) + ln, self._recv_rate)
        self.recv_monitor.update(len(hdr) + ln)
        return self._read_exact(ln)

    def _read_exact(self, n: int) -> bytes:
        if hasattr(self._conn, "read_exact"):
            return self._conn.read_exact(n)
        out = b""
        while len(out) < n:
            chunk = self._conn.recv(n - len(out))
            if not chunk:
                raise ConnectionError("connection closed")
            out += chunk
        return out
