"""Verification sidecar of the port: one long-lived process owns the card
and serves batch verification and Merkle roots to any number of node
processes.

Counterpart of ``cometbft_tpu/sidecar/service.py``, copied, serving
``TorchBackend`` (``CMTPU_SIDECAR_DEVICE``: ``torch``, the default, on
``cuda``; ``hybrid``, the card and the native host MSM; or ``cpu``; no
fallback from one to another). The wire bytes
are the reference's, so the reference's ``GrpcBackend`` (a node's
``CMTPU_BACKEND=grpc``) drives this server unchanged, as does the port's
copy below. A hand-framed protocol, not grpcio: one length-prefixed write
and read a call, the shape of CometBFT's ABCI socket protocol
(length-prefixed protobuf over TCP, pipelined requests), carrying
gRPC-style unary methods:

    BatchVerify(pubs, msgs, sigs) -> (ok, bitmap)   crypto.BatchVerifier
    MerkleRoot(leaves)            -> root           crypto/merkle/tree.go:11
    Ping()                        -> pong           health + capability probe
    Warmup(buckets)               -> ok             build and first-launch the kernels
    BatchVerifyChunk(...)         -> ack | bitmap   streamed BatchVerify

Wire format: every frame is a 4-byte big-endian length + protobuf body.
  Request  { 1: id (uvarint), 2: method (string), 3: payload (bytes) }
  Response { 1: id (uvarint), 2: ok (bool), 3: error (string), 4: payload }
  BatchVerifyReq  { 1..3: repeated pubs/msgs/sigs (bytes) }
  BatchVerifyResp { 1: all_ok (bool), 2: bitmap (bytes, 1 byte per sig) }
  MerkleReq       { 1: repeated leaves (bytes) }
  MerkleResp      { 1: root (bytes) }
  WarmupReq       { 1: repeated buckets (uvarint) }
  PingResp        { 1: "pong", 2: mesh_width, 3: streaming, 4: chunk }
  ChunkReq        { 1: stream_id, 2: seq, 3: final (bool),
                    4..6: repeated pubs/msgs/sigs (bytes) }

Streaming: a large BatchVerify splits into mesh-width-aligned chunks, each
an ordinary framed request with its own id. The server submits every chunk
to its scheduler as it arrives and acks chunk k only after chunk k-1's
dispatch resolved: a double buffer that overlaps the receive and host pack
of chunk k+1 with the device dispatch of chunk k. The final chunk's
response carries the whole stream's BatchVerifyResp; any chunk error fails
the stream with an error response (never a partial bitmap). Servers
advertise streaming in the Ping reply (field 3), and clients fall back to
unary against servers that do not.

Concurrent connections coalesce: the server routes verifications through a
CoalescingScheduler over the device lock, so many node processes merge
into single columnar dispatches with per-request bitmap slicing.
"""

from __future__ import annotations

import os
import random
import socket
import socketserver
import struct
import threading
import time

from cometbft_tpu_torch.sidecar.backend import (
    LockedBackend,
    VerifyBackend,
    device_backend,
)
from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler, VerifyFuture
from cometbft_tpu_torch.wire import proto

DEFAULT_ADDR = "127.0.0.1:26670"
DEFAULT_BUCKETS = (128, 1024, 10240)
_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30
# Chunk size a server with no device tier loaded advertises (field 4 of the
# Ping reply); a device-backed server asks the kernel for a bucket-aligned
# size instead (ed25519_kernel.preferred_stream_chunk).
DEFAULT_STREAM_CHUNK = 1024


class FrameTooLarge(ValueError):
    """A frame exceeded CMTPU_SIDECAR_MAX_FRAME. Recoverable on the server
    (error response, connection survives); a client-side raise means the
    caller must chunk (the streaming path) — never silently truncate."""


def _max_frame() -> int:
    env = os.environ.get("CMTPU_SIDECAR_MAX_FRAME", "")
    if env:
        try:
            return max(1024, int(env))
        except ValueError:
            pass
    return MAX_FRAME


# -- framing ------------------------------------------------------------------


def write_frame(sock: socket.socket, body: bytes) -> None:
    cap = _max_frame()
    if len(body) > cap:
        raise FrameTooLarge(
            f"refusing to send {len(body)}-byte frame "
            f"(CMTPU_SIDECAR_MAX_FRAME={cap}); chunk the request instead"
        )
    sock.sendall(_LEN.pack(len(body)) + body)


def read_frame(sock: socket.socket) -> bytes | None:
    hdr = _read_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    cap = _max_frame()
    if n > cap:
        # Drain the oversized body in bounded chunks (never one n-byte
        # allocation) so the stream stays framed and the connection can
        # carry an error response + further requests.
        remaining = n
        while remaining:
            chunk = sock.recv(min(65536, remaining))
            if not chunk:
                return None
            remaining -= len(chunk)
        raise FrameTooLarge(
            f"peer sent {n}-byte frame (CMTPU_SIDECAR_MAX_FRAME={cap})"
        )
    return _read_exact(sock, n)


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _encode_request(req_id: int, method: str, payload: bytes) -> bytes:
    return (
        proto.field_varint(1, req_id, emit_default=True)
        + proto.field_string(2, method)
        + proto.field_bytes(3, payload)
    )


def _encode_response(req_id: int, ok: bool, error: str, payload: bytes) -> bytes:
    return (
        proto.field_varint(1, req_id, emit_default=True)
        + proto.field_bool(2, ok)
        + proto.field_string(3, error)
        + proto.field_bytes(4, payload)
    )


# -- server -------------------------------------------------------------------


class _ServerStream:
    """Per-connection state of one in-progress BatchVerifyChunk stream:
    the futures of every submitted chunk (resolved in submission order by
    the scheduler's single dispatcher) and the expected next sequence."""

    __slots__ = ("futures", "next_seq")

    def __init__(self):
        self.futures: list[tuple] = []  # (VerifyFuture, n_sigs)
        self.next_seq = 0


class SidecarServer:
    """The long-lived device owner. Device calls are serialized with a lock
    (one card, one stream); socket handling is one thread per connection,
    so hosts can pipeline requests like the reference's socket ABCI client.
    Verifications route through a CoalescingScheduler over the device lock
    (CMTPU_COALESCE=0 strips it): concurrent connections (many node
    processes) merge into single columnar dispatches with per-request
    bitmap slicing. The backend defaults to ``device_backend`` of
    ``CMTPU_SIDECAR_DEVICE`` (``torch``, the card, unless it says ``hybrid``
    or ``cpu``).
    ``shutdown()`` ends every connection's handler thread and the
    scheduler's dispatcher."""

    def __init__(self, addr: str = DEFAULT_ADDR, backend: VerifyBackend | None = None):
        self.addr = addr
        self.backend = backend if backend is not None else device_backend(
            os.environ.get("CMTPU_SIDECAR_DEVICE", "torch").lower()
        )
        self._device_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._serving = False
        self._sched: CoalescingScheduler | None = None
        if os.environ.get("CMTPU_COALESCE", "1") != "0":
            self._sched = CoalescingScheduler(
                LockedBackend(self.backend, self._device_lock)
            )
        host, port = addr.rsplit(":", 1)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                conn = {"streams": {}}  # per-connection stream table
                while True:
                    try:
                        body = read_frame(sock)
                    except FrameTooLarge as e:
                        # Loud but survivable: the offending request is
                        # unidentifiable (its body was drained, not parsed),
                        # so the error response carries id 0 and the
                        # connection keeps serving.
                        try:
                            write_frame(
                                sock,
                                _encode_response(0, False, f"FrameTooLarge: {e}", b""),
                            )
                            continue
                        except OSError:
                            return
                    except (OSError, ValueError):
                        return
                    if body is None:
                        return
                    req_id = 0
                    try:  # fault isolation per request, incl. malformed bodies
                        fields = proto.decode_fields(body)
                        req_id = proto.get_uvarint(fields, 1)
                        method = proto.get_string(fields, 2)
                        payload = proto.get_bytes(fields, 3)
                        out = outer._dispatch(method, payload, conn)
                        resp = _encode_response(req_id, True, "", out)
                    except Exception as e:
                        resp = _encode_response(req_id, False, f"{type(e).__name__}: {e}", b"")
                    try:
                        write_frame(sock, resp)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            # Open connections are tracked from accept to close, so that
            # shutdown() can end the handlers blocked reading them.
            def process_request(self, request, client_address):
                with outer._conns_lock:
                    outer._conns.add(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                with outer._conns_lock:
                    outer._conns.discard(request)
                super().shutdown_request(request)

        self._server = Server((host, int(port)), Handler)

    def _submit(self, pubs, msgs, sigs) -> VerifyFuture:
        """One chunk/request into the verification path: async through the
        scheduler (cross-connection coalescing + the device lock inside its
        dispatcher) when wired, an immediately-resolved future otherwise —
        the streaming handler's double buffer works against either."""
        if self._sched is not None:
            return self._sched.submit(pubs, msgs, sigs)
        fut = VerifyFuture(len(pubs))
        try:
            with self._device_lock:
                fut._set_result(self.backend.batch_verify(pubs, msgs, sigs))
        except BaseException as e:
            fut._set_error(e)
        return fut

    def _preferred_chunk(self) -> int:
        """Streamed-chunk size advertised in the Ping reply: the kernel's
        bucket-aligned choice when the device tier is loaded (zero padding,
        mesh-width multiple), a flat default otherwise. Imports nothing: a
        Ping must not pull the device stack in."""
        import sys

        ek = sys.modules.get("cometbft_tpu_torch.ops.ed25519_kernel")
        if ek is not None:
            try:
                return int(ek.preferred_stream_chunk())
            except Exception:
                pass
        return DEFAULT_STREAM_CHUNK

    def scheduler_counters(self) -> dict:
        """The server-side coalescer's counters (empty when stripped) —
        the bench `sidecar` stage reads the cross-connection merge ratio
        from here."""
        return self._sched.counters() if self._sched is not None else {}

    def _dispatch(self, method: str, payload: bytes, conn: dict | None = None) -> bytes:
        if method == "Ping":
            # Capability reply: PingResp { 1: "pong", 2: mesh_width,
            # 3: streaming, 4: chunk }. The width is the REMOTE pod's chip
            # count, so client-side sizing (the coalescer's default merge
            # cap, chain pricing) sees the serving mesh, not the local
            # host's; field 3 advertises the chunked-streaming method and
            # field 4 the server's preferred chunk size. Legacy clients
            # that compared the raw body to b"pong" must upgrade with the
            # server; new clients still accept a bare b"pong" from an old
            # server (width defaults to 1, streaming to off).
            width = 1
            mw = getattr(self.backend, "mesh_width", None)
            if mw is not None:
                try:
                    width = max(1, int(mw()))
                except Exception:
                    width = 1
            return (
                proto.field_bytes(1, b"pong")
                + proto.field_varint(2, width)
                + proto.field_varint(3, 1)
                + proto.field_varint(4, self._preferred_chunk())
            )
        if method == "BatchVerify":
            fields = proto.decode_fields(payload)
            pubs = proto.get_repeated_bytes(fields, 1)
            msgs = proto.get_repeated_bytes(fields, 2)
            sigs = proto.get_repeated_bytes(fields, 3)
            if not (len(pubs) == len(msgs) == len(sigs)):
                raise ValueError("pubs/msgs/sigs length mismatch")
            if not pubs:
                # The scheduler short-circuits empty submissions with its
                # own sentinel; keep the backend's empty-batch answer.
                with self._device_lock:
                    ok, bitmap = self.backend.batch_verify(pubs, msgs, sigs)
            else:
                ok, bitmap = self._submit(pubs, msgs, sigs).result()
            return proto.field_bool(1, ok) + proto.field_bytes(
                2, bytes(1 if b else 0 for b in bitmap)
            )
        if method == "BatchVerifyChunk":
            if conn is None:
                raise ValueError("BatchVerifyChunk requires a connection")
            return self._dispatch_chunk(payload, conn["streams"])
        if method == "MerkleRoot":
            fields = proto.decode_fields(payload)
            leaves = proto.get_repeated_bytes(fields, 1)
            with self._device_lock:
                root = self.backend.merkle_root(leaves)
            return proto.field_bytes(1, root)
        if method == "Warmup":
            fields = proto.decode_fields(payload)
            buckets = tuple(proto.get_repeated_uvarint(fields, 1)) or DEFAULT_BUCKETS
            self.warmup(buckets)
            return b""
        raise ValueError(f"unknown method {method!r}")

    def _dispatch_chunk(self, payload: bytes, streams: dict) -> bytes:
        """One chunk of a streamed BatchVerify (module docstring: ChunkReq).
        Non-final chunks are submitted to the scheduler and acked — after
        the PREVIOUS chunk's dispatch resolved, the double buffer that
        paces the client to one in-flight dispatch while it packs/sends
        the next chunk. The final chunk's response is the whole stream's
        BatchVerifyResp. Any failure tears the stream down and surfaces as
        this chunk's error response — never a partial bitmap."""
        fields = proto.decode_fields(payload)
        sid = proto.get_uvarint(fields, 1)
        seq = proto.get_uvarint(fields, 2)
        final = proto.get_bool(fields, 3)
        pubs = proto.get_repeated_bytes(fields, 4)
        msgs = proto.get_repeated_bytes(fields, 5)
        sigs = proto.get_repeated_bytes(fields, 6)
        if seq == 0:
            if sid in streams:
                raise ValueError(f"stream {sid} already open")
            if len(streams) >= 64:  # a leaking client must not hoard futures
                raise ValueError("too many open streams on this connection")
            streams[sid] = _ServerStream()
        st = streams.get(sid)
        if st is None:
            raise ValueError(f"unknown stream {sid} (chunk seq {seq})")
        try:
            if seq != st.next_seq:
                raise ValueError(
                    f"stream {sid}: chunk seq {seq}, expected {st.next_seq}"
                )
            st.next_seq += 1
            if not (len(pubs) == len(msgs) == len(sigs)):
                raise ValueError("pubs/msgs/sigs length mismatch")
            if pubs:
                st.futures.append((self._submit(pubs, msgs, sigs), len(pubs)))
            if not final:
                if len(st.futures) >= 2:
                    st.futures[-2][0].result()
                return b""
            all_ok = True
            bits_out = bytearray()
            for fut, n in st.futures:
                ok, bits = fut.result()
                if len(bits) != n:
                    raise ValueError(
                        f"stream {sid}: chunk answered {len(bits)} of {n} lanes"
                    )
                all_ok = all_ok and ok
                bits_out.extend(1 if b else 0 for b in bits)
            del streams[sid]
            return proto.field_bool(1, all_ok) + proto.field_bytes(
                2, bytes(bits_out)
            )
        except Exception:
            streams.pop(sid, None)
            raise

    def warmup(self, buckets=DEFAULT_BUCKETS) -> None:
        """Build the kernels and run each program once at the given verify
        buckets (and the tree entry at block sizes), so the first real
        commit pays no build and no first launch (the hybrid's native
        library too)."""
        warm = getattr(self.backend, "warmup", None)
        if warm is not None:
            with self._device_lock:
                warm(buckets)

    @property
    def bound_addr(self) -> str:
        """host:port actually bound — differs from `addr` when the caller
        asked for port 0 (the fanout shard workers and tests do, to dodge
        port races; they print this so the parent learns the real port)."""
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def serve_forever(self):
        self._serving = True
        self._server.serve_forever()

    def start(self) -> "SidecarServer":
        self._serving = True
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self

    def shutdown(self):
        """Stop accepting, end every open connection (its handler thread
        returns and is joined), then stop the scheduler's dispatcher."""
        if self._serving:
            self._server.shutdown()
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.server_close()
        if self._sched is not None:
            self._sched.close()


# -- client -------------------------------------------------------------------


class GrpcBackend(VerifyBackend):
    """The `CMTPU_BACKEND=grpc` client: speaks the framed protocol above.
    Thread-safe (one in-flight request per connection, guarded by a lock);
    reconnects once on a broken connection. Fails loudly when the sidecar is
    unreachable — an explicitly configured remote verifier must not silently
    fall back to a different trust path."""

    name = "grpc"

    # Redial backoff bounds: first failure waits _REDIAL_BASE_S, doubling
    # (with jitter inside the doubling) to the _REDIAL_MAX_S cap.
    _REDIAL_BASE_S = 0.05
    _REDIAL_MAX_S = 5.0

    def __init__(
        self,
        addr: str = DEFAULT_ADDR,
        timeout_s: float = 300.0,
        connect_timeout_s: float = 5.0,
    ):
        # timeout_s is the per-REQUEST deadline (slot wait below);
        # connect_timeout_s bounds dial time only. One 300 s knob doing
        # both meant a dead relay cost five minutes per connect attempt.
        self.addr = addr
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self._sock: socket.socket | None = None
        self._wlock = threading.Lock()  # serializes frame WRITES only
        self._plock = threading.Lock()  # connection + pending table
        # id -> [Event, body | None, owning socket]: the socket tag lets a
        # dead connection's reader sweep fail ONLY its own waiters.
        self._pending: dict[int, list] = {}
        self._next_id = 0
        # Capped redial-with-backoff (under _plock): a client object used
        # to die for good once the sidecar went away; now each failed dial
        # opens a backoff window in which calls fail FAST, and the next
        # call after the window redials.
        self._redial_failures = 0
        self._redial_not_before = 0.0
        # Remote pod width from the Ping capability reply (1 until probed).
        self._remote_mesh_width = 1
        # Streaming capability: None = never probed, False = legacy server,
        # True = server speaks BatchVerifyChunk. The first large
        # batch_verify self-probes (one Ping on the same connection).
        self._remote_streams: bool | None = None
        # Server-preferred chunk size from the Ping reply (field 4).
        self._remote_chunk = DEFAULT_STREAM_CHUNK
        self._next_stream = 0
        self.counters_ = {
            "unary_calls": 0,
            "streamed_calls": 0,
            "streamed_chunks": 0,
            "stream_retries": 0,
        }

    def _connect_locked(self) -> None:
        now = time.monotonic()
        if self._redial_failures and now < self._redial_not_before:
            raise ConnectionError(
                f"sidecar {self.addr} in redial backoff "
                f"({self._redial_failures} consecutive dial failures)"
            )
        host, port = self.addr.rsplit(":", 1)
        try:
            s = socket.create_connection(
                (host, int(port)), timeout=self.connect_timeout_s
            )
        except OSError as e:
            self._redial_failures += 1
            base = min(
                self._REDIAL_BASE_S * 2 ** (self._redial_failures - 1),
                self._REDIAL_MAX_S,
            )
            self._redial_not_before = now + base * random.uniform(0.5, 1.0)
            raise ConnectionError(f"sidecar dial {self.addr}: {e}") from e
        self._redial_failures = 0
        # Blocking mode from here: request deadlines are enforced by the
        # waiter's Event (timeout_s), and a lingering socket timeout would
        # make the reader thread kill an idle-but-healthy connection.
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        threading.Thread(
            target=self._reader_loop, args=(s,), daemon=True, name="sidecar-reader"
        ).start()

    def _reader_loop(self, sock: socket.socket) -> None:
        """Demultiplexes responses by request id so callers can PIPELINE:
        many requests may be in flight on the one connection (the server's
        handler serves them in order on its one thread)."""
        while True:
            try:
                body = read_frame(sock)
            except (OSError, FrameTooLarge):
                # An over-cap RESPONSE means client and server disagree on
                # the frame cap; treat the connection as unusable rather
                # than strand its waiters.
                body = None
            if body is None:
                break
            fields = proto.decode_fields(body)
            req_id = proto.get_uvarint(fields, 1)
            with self._plock:
                slot = self._pending.pop(req_id, None)
            if slot is not None:
                slot[1] = body
                slot[0].set()
        # Connection died: fail the waiters that belong to THIS socket so
        # they can retry. A delayed cleanup must not sweep requests already
        # registered on a replacement connection (that race turned one
        # reconnect into a spurious second failure).
        with self._plock:
            if self._sock is sock:
                self._sock = None
            dead = {k: v for k, v in self._pending.items() if v[2] is sock}
            for k in dead:
                del self._pending[k]
        for slot in dead.values():
            slot[0].set()

    def _begin_call(self, method: str, payload: bytes, pin_sock=None):
        """Register a pending slot and write the request frame; returns
        (slot, req_id) for _await_slot. `pin_sock` (streaming) demands the
        frame ride a specific connection: a mid-stream reconnect would
        scatter one stream's chunks across sockets, and the server would
        rightly reject the orphaned tail."""
        slot = [threading.Event(), None, None]
        with self._plock:
            if pin_sock is not None and self._sock is not pin_sock:
                err = ConnectionError("sidecar connection lost mid-stream")
                err.sock = pin_sock
                raise err
            if self._sock is None:
                self._connect_locked()
            self._next_id += 1
            req_id = self._next_id
            sock = self._sock
            slot[2] = sock
            self._pending[req_id] = slot
        req = _encode_request(req_id, method, payload)
        try:
            with self._wlock:
                write_frame(sock, req)
        except FrameTooLarge:
            # Not a connection fault: fail fast, no retry, no teardown.
            with self._plock:
                self._pending.pop(req_id, None)
            raise
        except OSError as e:
            with self._plock:
                self._pending.pop(req_id, None)
            err = ConnectionError(str(e))
            err.sock = sock  # which connection failed (see _call)
            raise err from e
        return slot, req_id

    def _await_slot(self, slot, req_id: int, method: str) -> bytes:
        if not slot[0].wait(self.timeout_s):
            with self._plock:
                self._pending.pop(req_id, None)
            raise TimeoutError(f"sidecar {method} timed out")
        if slot[1] is None:
            err = ConnectionError("sidecar connection lost mid-request")
            err.sock = slot[2]
            raise err
        return slot[1]

    def _call_once(self, method: str, payload: bytes) -> bytes:
        slot, req_id = self._begin_call(method, payload)
        return self._await_slot(slot, req_id, method)

    def _call(self, method: str, payload: bytes) -> bytes:
        for attempt in (0, 1):
            try:
                body = self._call_once(method, payload)
                break
            except ConnectionError as e:
                # Tear down only the connection that actually failed: a
                # thread handling a stale failure must not close the
                # replacement another thread just established.
                failed = getattr(e, "sock", None)
                with self._plock:
                    if self._sock is not None and (
                        failed is None or self._sock is failed
                    ):
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                if attempt:
                    raise
        fields = proto.decode_fields(body)
        if not proto.get_bool(fields, 2):
            raise RuntimeError(f"sidecar error: {proto.get_string(fields, 3)}")
        return proto.get_bytes(fields, 4)

    def ping(self) -> bool:
        body = self._call("Ping", b"")
        if body == b"pong":  # pre-capability server
            self._remote_streams = False
            return True
        try:
            fields = proto.decode_fields(body)
            if proto.get_bytes(fields, 1) != b"pong":
                return False
            width = proto.get_uvarint(fields, 2)
            if width:
                self._remote_mesh_width = int(width)
            self._remote_streams = bool(proto.get_uvarint(fields, 3))
            chunk = proto.get_uvarint(fields, 4)
            if chunk:
                self._remote_chunk = int(chunk)
            return True
        except Exception:
            return False

    def mesh_width(self) -> int:
        """The serving pod's chip count, learned from the Ping capability
        reply. Never dials: an unpinged client reports 1 and the caller's
        periodic refresh picks the real width up after the first probe."""
        return self._remote_mesh_width

    def chunk_size(self) -> int:
        """Streamed-chunk size: CMTPU_SIDECAR_CHUNK when set, else the
        server's Ping-advertised preference, rounded UP to a multiple of
        the remote pod's width so every chunk fills the serving mesh."""
        env = os.environ.get("CMTPU_SIDECAR_CHUNK", "")
        size = 0
        if env:
            try:
                size = int(env)
            except ValueError:
                size = 0
        if size <= 0:
            size = self._remote_chunk
        w = max(1, self._remote_mesh_width)
        if size % w:
            size += w - size % w
        return max(size, w)

    def batch_verify(self, pubs, msgs, sigs):
        n = len(pubs)
        chunk = self.chunk_size()
        if n > chunk:
            if self._remote_streams is None:
                # Lazy capability probe on the first oversized batch: one
                # Ping on the same connection (errors propagate exactly as
                # the unary call's would).
                self.ping()
            if self._remote_streams:
                return self._batch_verify_streamed(pubs, msgs, sigs, chunk)
        with self._plock:
            self.counters_["unary_calls"] += 1
        payload = b"".join(
            proto.field_bytes(1, p, emit_default=True) for p in pubs
        ) + b"".join(
            proto.field_bytes(2, m, emit_default=True) for m in msgs
        ) + b"".join(
            proto.field_bytes(3, s, emit_default=True) for s in sigs
        )
        out = self._call("BatchVerify", payload)
        fields = proto.decode_fields(out)
        bitmap = proto.get_bytes(fields, 2)
        return proto.get_bool(fields, 1), [bool(b) for b in bitmap[: len(pubs)]]

    def _batch_verify_streamed(self, pubs, msgs, sigs, chunk: int):
        """Chunked-streaming BatchVerify with the same two-attempt redial
        discipline as _call: a ConnectionError tears down the failed
        socket and the SECOND attempt re-streams from chunk 0 on a fresh
        connection (streams never resume mid-way — the server holds no
        cross-connection state, so a partial bitmap is impossible)."""
        for attempt in (0, 1):
            try:
                return self._stream_once(pubs, msgs, sigs, chunk)
            except ConnectionError as e:
                failed = getattr(e, "sock", None)
                with self._plock:
                    if self._sock is not None and (
                        failed is None or self._sock is failed
                    ):
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    self.counters_["stream_retries"] += 1
                if attempt:
                    raise

    def _check_ack(self, body: bytes) -> None:
        fields = proto.decode_fields(body)
        if not proto.get_bool(fields, 2):
            raise RuntimeError(f"sidecar error: {proto.get_string(fields, 3)}")

    @staticmethod
    def _stream_window() -> int:
        """Unacked-chunk pipeline depth. The server still only ever has one
        dispatch in flight per connection (its ack of chunk k gates on
        chunk k-1's dispatch) — a deeper client window just keeps frames in
        the socket on their way there, which is what hides a long wire RTT
        behind device dispatch. Floor 2: below that the pipeline degenerates
        into send/ack lockstep and the overlap disappears."""
        try:
            return max(2, int(os.environ.get("CMTPU_SIDECAR_WINDOW", "6")))
        except ValueError:
            return 6

    def _stream_once(self, pubs, msgs, sigs, chunk: int):
        n = len(pubs)
        with self._plock:
            self._next_stream += 1
            sid = self._next_stream
        n_chunks = (n + chunk - 1) // chunk
        window = self._stream_window()
        slots: list[tuple] = []
        pinned = None
        for seq in range(n_chunks):
            lo, hi = seq * chunk, min((seq + 1) * chunk, n)
            payload = (
                proto.field_varint(1, sid, emit_default=True)
                + proto.field_varint(2, seq, emit_default=True)
                + proto.field_bool(3, seq == n_chunks - 1)
                + b"".join(
                    proto.field_bytes(4, p, emit_default=True) for p in pubs[lo:hi]
                )
                + b"".join(
                    proto.field_bytes(5, m, emit_default=True) for m in msgs[lo:hi]
                )
                + b"".join(
                    proto.field_bytes(6, s, emit_default=True) for s in sigs[lo:hi]
                )
            )
            # Windowed pipelining: at most `window` unacked chunks in
            # flight — the server is packing/dispatching chunk k while this
            # thread packs and sends later chunks, and the k-th ack gates
            # chunk k+window so a slow server applies backpressure instead
            # of buffering the whole batch in socket memory.
            if seq >= window:
                self._check_ack(
                    self._await_slot(*slots[seq - window], "BatchVerifyChunk")
                )
            slots.append(self._begin_call("BatchVerifyChunk", payload, pin_sock=pinned))
            if pinned is None:
                pinned = slots[0][0][2]
        with self._plock:
            self.counters_["streamed_chunks"] += n_chunks
        for i in range(max(0, n_chunks - window), n_chunks - 1):
            self._check_ack(self._await_slot(*slots[i], "BatchVerifyChunk"))
        final = self._await_slot(*slots[-1], "BatchVerifyChunk")
        fields = proto.decode_fields(final)
        if not proto.get_bool(fields, 2):
            raise RuntimeError(f"sidecar error: {proto.get_string(fields, 3)}")
        out = proto.decode_fields(proto.get_bytes(fields, 4))
        bitmap = proto.get_bytes(out, 2)
        if len(bitmap) != n:
            raise RuntimeError(
                f"sidecar stream answered {len(bitmap)} of {n} lanes"
            )
        with self._plock:
            self.counters_["streamed_calls"] += 1
        return proto.get_bool(out, 1), [bool(b) for b in bitmap]

    def counters(self) -> dict:
        with self._plock:
            out = dict(self.counters_)
        out["remote_mesh_width"] = self._remote_mesh_width
        out["remote_chunk"] = self._remote_chunk
        out["streaming"] = bool(self._remote_streams)
        return out

    def merkle_root(self, leaves):
        payload = b"".join(
            proto.field_bytes(1, leaf, emit_default=True) for leaf in leaves
        )
        out = self._call("MerkleRoot", payload)
        return proto.get_bytes(proto.decode_fields(out), 1)

    def warmup(self, buckets=DEFAULT_BUCKETS) -> None:
        self._call(
            "Warmup",
            b"".join(proto.field_varint(1, b, emit_default=True) for b in buckets),
        )

    def close(self) -> None:
        with self._plock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


def main() -> None:
    """``python -m cometbft_tpu_torch.sidecar``: serve until killed."""
    addr = os.environ.get("CMTPU_SIDECAR_ADDR", DEFAULT_ADDR)
    server = SidecarServer(addr)
    print(
        f"sidecar: serving on {server.bound_addr} (backend={server.backend.name})",
        flush=True,
    )
    if os.environ.get("CMTPU_SIDECAR_WARM", "1") == "1":
        server.warmup()
        print("sidecar: warmup complete", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
