"""A websocket client of ``JSONRPCServer`` (rpc/jsonrpc/client/ws_client.go):
the RFC 6455 upgrade on ``/websocket``, masked frames out, unmasked frames
in, JSON-RPC calls and subscription events as text frames. Stdlib only."""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x8, 0x9, 0xA


class WSClient:
    """One websocket connection to ``host:port``. ``send`` writes one frame
    (a text frame of ``obj`` as JSON, or ``obj`` as the raw payload of another
    opcode), ``frame`` reads one as (opcode, payload), ``recv`` one text
    frame as JSON. ``head`` is the server's upgrade answer."""

    KEY = base64.b64encode(b"cometbft-tpu-ws-").decode()
    MASK = b"\x11\x22\x33\x44"

    def __init__(self, port: int, host: str = "127.0.0.1", timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.sendall((
            f"GET /websocket HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {self.KEY}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(1)
            if not chunk:
                raise ConnectionError("websocket closed during the upgrade")
            head += chunk
        self.head = head
        accept = base64.b64encode(hashlib.sha1((self.KEY + _GUID).encode()).digest())
        if not (head.startswith(b"HTTP/1.1 101") and accept in head):
            raise ConnectionError(f"websocket upgrade refused: {head[:80]!r}")

    def send(self, obj, opcode: int = OP_TEXT) -> None:
        payload = json.dumps(obj).encode() if opcode == OP_TEXT else bytes(obj)
        n = len(payload)
        head = bytes([0x80 | opcode])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 1 << 16:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        mask = self.MASK
        self.sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def _exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("websocket closed")
            out += chunk
        return out

    def frame(self) -> tuple[int, bytes]:
        b1, b2 = self._exact(2)
        n = b2 & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._exact(8))[0]
        return b1 & 0x0F, self._exact(n)

    def recv(self):
        opcode, payload = self.frame()
        if opcode != OP_TEXT:
            raise ValueError(f"websocket: frame opcode {opcode}, not a text frame")
        return json.loads(payload)

    def close(self) -> None:
        """Shuts the socket down first: that wakes a reader blocked in
        ``frame`` (a close alone leaves it waiting out the timeout)."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:  # the server closed it already
            pass
        self.sock.close()
