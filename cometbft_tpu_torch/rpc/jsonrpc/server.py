"""JSON-RPC 2.0 server over HTTP POST, GET-with-query-args, and WebSocket
(rpc/jsonrpc/server/http_json_handler.go, http_uri_handler.go,
ws_handler.go), the port's copy of ``cometbft_tpu/rpc/jsonrpc/server.py``.

Stdlib-only: ThreadingHTTPServer + a minimal RFC 6455 WebSocket upgrade for
the subscription stream. Route functions receive (ctx, **params) and return
JSON-able dicts; errors map to JSON-RPC error objects.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cometbft_tpu_torch.libs import threads


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str | None = None):
        self.code = code
        self.message = message
        self.data = data
        super().__init__(message)


PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603


class JSONRPCServer:
    """Serves a route table: {method_name: callable(ctx, **params)}."""

    def __init__(self, routes: dict, host: str = "127.0.0.1", port: int = 26657,
                 ws_manager=None, logger=None):
        self.routes = routes
        self.host = host
        self.port = port
        self.ws_manager = ws_manager
        self.logger = logger
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    response = server.handle_json_body(body, ws=None)
                except Exception:
                    response = _error_response(None, INTERNAL_ERROR, "internal error",
                                               traceback.format_exc())
                self._respond(response)

            def do_GET(self):
                if self.headers.get("Upgrade", "").lower() == "websocket":
                    server._handle_websocket(self)
                    return
                parsed = urllib.parse.urlparse(self.path)
                method = parsed.path.strip("/")
                if not method:
                    self._respond(_list_methods_html(server.routes))
                    return
                params = {
                    k: _coerce_uri_param(v[0])
                    for k, v in urllib.parse.parse_qs(parsed.query).items()
                }
                response = server.handle_call(None, method, params, rpc_id=-1, ws=None)
                self._respond(response)

            def _respond(self, payload):
                if isinstance(payload, (dict, list)):
                    data = json.dumps(payload, indent=2).encode()
                    ctype = "application/json"
                else:
                    data = payload if isinstance(payload, bytes) else str(payload).encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        if self.port == 0:
            self.port = self._httpd.server_address[1]
        self._thread = threads.spawn(self._httpd.serve_forever)

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    # -- dispatch -------------------------------------------------------------

    def handle_json_body(self, body: bytes, ws):
        try:
            req = json.loads(body)
        except Exception:
            return _error_response(None, PARSE_ERROR, "parse error", None)
        if isinstance(req, list):
            return [self._handle_single(r, ws) for r in req]
        return self._handle_single(req, ws)

    def _handle_single(self, req: dict, ws):
        if not isinstance(req, dict):
            return _error_response(
                None, INVALID_REQUEST, "request must be an object", None
            )
        rpc_id = req.get("id")
        method = req.get("method", "")
        params = req.get("params")
        # None and the common client default `[]` both mean "no params";
        # non-empty positional lists are rejected below with the specific
        # INVALID_PARAMS message.
        params = {} if params is None or params == [] else params
        if not isinstance(method, str) or not isinstance(params, (dict, list)):
            return _error_response(rpc_id, INVALID_REQUEST, "malformed request", None)
        if isinstance(params, list):
            return _error_response(
                rpc_id, INVALID_PARAMS, "positional params not supported", None
            )
        return self.handle_call(None, method, params, rpc_id, ws)

    def handle_call(self, ctx, method: str, params: dict, rpc_id, ws):
        fn = self.routes.get(method)
        if fn is None:
            return _error_response(rpc_id, METHOD_NOT_FOUND, "method not found", method)
        try:
            if ws is not None:
                result = fn(ws=ws, **params) if _wants_ws(fn) else fn(**params)
            else:
                result = fn(**params)
            return {"jsonrpc": "2.0", "id": rpc_id, "result": result}
        except RPCError as e:
            return _error_response(rpc_id, e.code, e.message, e.data)
        except TypeError as e:
            return _error_response(rpc_id, INVALID_PARAMS, "invalid params", str(e))
        except Exception as e:
            return _error_response(rpc_id, INTERNAL_ERROR, str(e), traceback.format_exc())

    # -- websocket (rpc/jsonrpc/server/ws_handler.go) -------------------------

    def _handle_websocket(self, handler: BaseHTTPRequestHandler) -> None:
        key = handler.headers.get("Sec-WebSocket-Key", "")
        accept = base64.b64encode(
            hashlib.sha1((key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest()
        ).decode()
        handler.send_response(101, "Switching Protocols")
        handler.send_header("Upgrade", "websocket")
        handler.send_header("Connection", "Upgrade")
        handler.send_header("Sec-WebSocket-Accept", accept)
        handler.end_headers()
        conn = WSConnection(handler.connection, self)
        if self.ws_manager is not None:
            self.ws_manager.add(conn)
        try:
            conn.serve()
        finally:
            if self.ws_manager is not None:
                self.ws_manager.remove(conn)
            # The socket left websocket framing; letting the HTTP/1.1
            # keep-alive loop reparse leftover bytes as a request would pin
            # the thread on a dead (or hostile) connection.
            handler.close_connection = True
            try:
                handler.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def _wants_ws(fn) -> bool:
    import inspect

    return "ws" in inspect.signature(fn).parameters


class WSConnection:
    """One websocket client: frame codec + outbound event queue.

    A failed read or write closes the connection, as in the reference; the
    port also counts it (``frame_errors``) and keeps the last one."""

    def __init__(self, sock: socket.socket, server: JSONRPCServer):
        self.sock = sock
        self.server = server
        self.remote = f"{sock.getpeername()}"
        self._send_mtx = threading.Lock()
        self.open = True
        self.frame_errors = 0
        self.last_frame_error: Exception | None = None

    def _frame_error(self, e: Exception) -> None:
        self.frame_errors += 1
        self.last_frame_error = e
        self.open = False

    def serve(self) -> None:
        while self.open:
            msg = self._read_frame()
            if msg is None:
                break
            response = self.server.handle_json_body(msg, ws=self)
            self.send_json(response)

    def send_json(self, obj) -> None:
        self._write_frame(json.dumps(obj).encode())

    # Bound inbound frames: a header may CLAIM up to 2^64 bytes; reading it
    # would pin the connection thread and accumulate unbounded memory.
    MAX_FRAME = 16 * 1024 * 1024

    def _read_frame(self):
        try:
            hdr = self._read_exact(2)
            if hdr is None:
                return None
            b1, b2 = hdr
            opcode = b1 & 0x0F
            masked = b2 & 0x80
            length = b2 & 0x7F
            if length == 126:
                length = struct.unpack(">H", self._read_exact(2))[0]
            elif length == 127:
                length = struct.unpack(">Q", self._read_exact(8))[0]
            if length > self.MAX_FRAME:
                self.open = False
                return None
            mask = self._read_exact(4) if masked else b"\x00" * 4
            payload = bytearray(self._read_exact(length) or b"")
            for i in range(len(payload)):
                payload[i] ^= mask[i % 4]
            if opcode == 0x8:  # close
                self.open = False
                return None
            if opcode == 0x9:  # ping -> pong
                self._write_frame(bytes(payload), opcode=0xA)
                return self._read_frame()
            return bytes(payload)
        except Exception as e:  # a peer gone mid-frame reads None: TypeError
            self._frame_error(e)
            return None

    def _read_exact(self, n: int):
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return data

    def _write_frame(self, payload: bytes, opcode: int = 0x1) -> None:
        with self._send_mtx:
            header = bytes([0x80 | opcode])
            ln = len(payload)
            if ln < 126:
                header += bytes([ln])
            elif ln < 1 << 16:
                header += bytes([126]) + struct.pack(">H", ln)
            else:
                header += bytes([127]) + struct.pack(">Q", ln)
            try:
                self.sock.sendall(header + payload)
            except OSError as e:
                self._frame_error(e)


def _error_response(rpc_id, code: int, message: str, data):
    err = {"code": code, "message": message}
    if data is not None:
        err["data"] = data
    return {"jsonrpc": "2.0", "id": rpc_id, "error": err}


class QuotedStr(str):
    """A URI param that arrived quoted. CometBFT's URI handler treats a
    quoted string for a []byte param as the RAW string bytes (not base64, as
    JSON-POST []byte params are) — rpc/jsonrpc/server/http_uri_handler.go."""


def _coerce_uri_param(v: str):
    """GET params arrive as strings; mimic CometBFT's URI param parsing
    (quoted strings, 0x-hex, bools, numbers)."""
    if v.startswith('"') and v.endswith('"'):
        return QuotedStr(v[1:-1])
    if v in ("true", "false"):
        return v == "true"
    return v


def _list_methods_html(routes: dict) -> bytes:
    items = "".join(f"<a href=\"/{m}\">/{m}</a></br>" for m in sorted(routes))
    return f"<html><body>Available endpoints:<br>{items}</body></html>".encode()
