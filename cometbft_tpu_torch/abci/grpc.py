"""ABCI over gRPC: CometBFT's second process-boundary transport
(abci/client/grpc_client.go:435, abci/server/grpc_server.go:61, service
`tendermint.abci.ABCIApplication` in proto/tendermint/abci/types.proto).

grpcio is driven through its generic bytes-passthrough API: each RPC method
carries the INNER Request*/Response* message encoded by the hand-rolled
gogoproto-compatible codec in abci/wire.py, so no generated stubs (and no
python protobuf runtime) are involved. Method routing gives the type, which
is exactly how CometBFT's per-rpc signatures work
(`rpc CheckTx(RequestCheckTx) returns (ResponseCheckTx)`).

Application errors surface as StatusCode.INTERNAL with the exception text —
the gRPC analog of the socket transport's ResponseException frame.

The port's copy of ``cometbft_tpu/abci/grpc.py``. ``grpc`` is imported
here only: a node imports this module only for a ``grpc://`` proxy_app.
"""

from __future__ import annotations

import threading
from concurrent import futures

import grpc

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci import wire as abci_wire
from cometbft_tpu_torch.abci.client import AsyncCheckTxMixin, Client, ClientCreator

_SERVICE = "tendermint.abci.ABCIApplication"

# rpc names of the ABCIApplication service; `Request{name}`/`Response{name}`
# are the wire types each method carries.
_METHODS = frozenset(
    {
        "Echo",
        "Flush",
        "Info",
        "InitChain",
        "Query",
        "BeginBlock",
        "CheckTx",
        "DeliverTx",
        "EndBlock",
        "Commit",
        "ListSnapshots",
        "OfferSnapshot",
        "LoadSnapshotChunk",
        "ApplySnapshotChunk",
        "PrepareProposal",
        "ProcessProposal",
    }
)


def _strip_scheme(addr: str) -> str:
    """grpc targets are bare host:port, or unix:<path> for sockets. unix://
    always means a socket path (relative or absolute); for the other schemes
    an absolute path (grpc:///tmp/x) means a unix socket too."""
    if addr.startswith("unix://"):
        return "unix:" + addr[len("unix://") :]
    for scheme in ("grpc://", "tcp://"):
        if addr.startswith(scheme):
            addr = addr[len(scheme) :]
            break
    if addr.startswith("/"):
        return "unix:" + addr
    return addr


class GrpcServer:
    """abci/server/grpc_server.go: serve an Application over gRPC. All
    dispatches funnel through one application mutex — the same serialization
    the socket server enforces (CometBFT relies on the app's own
    locking; this keeps both transports behaviorally identical here)."""

    def __init__(self, app: abci.Application, addr: str, max_workers: int = 8):
        self.app = app
        self.addr = addr
        self._mtx = threading.Lock()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((_AppHandler(self),))
        self.bound: str | None = None

    def start(self) -> str:
        target = _strip_scheme(self.addr)
        # grpcio reports bind failure by returning port 0 instead of
        # raising (unix sockets return 1 on success); fail fast like the
        # socket server's bind() would.
        port = self._server.add_insecure_port(target)
        if port == 0:
            raise OSError(f"cannot bind ABCI grpc server to {self.addr}")
        if target.startswith("unix:"):
            # Keep the unix: marker in the bound address so relative socket
            # paths round-trip through _strip_scheme too (grpc://unix:x.sock
            # -> unix:x.sock; a bare relative path would parse as DNS).
            self.bound = f"grpc://{target}"
        else:
            host = target.rsplit(":", 1)[0] or "127.0.0.1"
            self.bound = f"grpc://{host}:{port}"
        self._server.start()
        return self.bound

    def stop(self) -> None:
        self._server.stop(grace=0.2)

    def _dispatch(self, req):
        from cometbft_tpu_torch.abci.server import dispatch_request

        with self._mtx:
            return dispatch_request(self.app, req)


class _AppHandler(grpc.GenericRpcHandler):
    def __init__(self, server: GrpcServer):
        self._server = server

    def service(self, handler_call_details):
        path = handler_call_details.method
        prefix = f"/{_SERVICE}/"
        if not path.startswith(prefix):
            return None
        name = path[len(prefix) :]
        if name not in _METHODS:
            return None
        req_name = f"Request{name}"

        def handle(req, context):
            try:
                return self._server._dispatch(req)
            except Exception as e:  # -> INTERNAL, like ResponseException
                context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

        return grpc.unary_unary_rpc_method_handler(
            handle,
            request_deserializer=lambda b, n=req_name: abci_wire._dec_req_body(
                n, b
            ),
            response_serializer=abci_wire._enc_resp_body,
        )


class GrpcClient(AsyncCheckTxMixin, Client):
    """abci/client/grpc_client.go in synchronous form (the node's proxy
    connections block on results; see SocketClient's rationale). CheckTxAsync
    keeps the mempool's pipelined ordering with a single dispatch thread."""

    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self._channel = grpc.insecure_channel(_strip_scheme(addr))
        try:
            grpc.channel_ready_future(self._channel).result(timeout=connect_timeout)
        except grpc.FutureTimeoutError:
            self._channel.close()
            raise ConnectionError(f"cannot connect to ABCI app at {addr}")
        self._stubs = {}
        for name in _METHODS:
            self._stubs[name] = self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=abci_wire._enc_req_body,
                response_deserializer=lambda b, n=f"Response{name}": (
                    abci_wire._dec_resp_body(n, b)
                ),
            )
        self._start_async("abci-grpc-async")

    def close(self) -> None:
        self._stop_async()
        self._channel.close()

    def _call(self, name: str, req):
        # No deadline: ABCI calls block for as long as the app needs (a
        # commit that triggers a long snapshot, a first-call device compile),
        # exactly like the socket transport's untimed reads.
        try:
            return self._stubs[name](req)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.INTERNAL:
                raise RuntimeError(f"ABCI app exception: {e.details()}") from None
            raise ConnectionError(f"ABCI grpc {name}: {e.code()}: {e.details()}")

    def _do_check_tx(self, req):
        return self._call("CheckTx", req)

    def echo(self, msg: str):
        return self._call("Echo", abci.RequestEcho(message=msg))

    def flush(self) -> None:
        self._call("Flush", abci.RequestFlush())

    def info(self, req):
        return self._call("Info", req)

    def init_chain(self, req):
        return self._call("InitChain", req)

    def query(self, req):
        return self._call("Query", req)

    def check_tx(self, req):
        return self._call("CheckTx", req)

    def begin_block(self, req):
        return self._call("BeginBlock", req)

    def deliver_tx(self, req):
        return self._call("DeliverTx", req)

    def end_block(self, req):
        return self._call("EndBlock", req)

    def commit(self):
        return self._call("Commit", abci.RequestCommit())

    def prepare_proposal(self, req):
        return self._call("PrepareProposal", req)

    def process_proposal(self, req):
        return self._call("ProcessProposal", req)

    def list_snapshots(self, req):
        return self._call("ListSnapshots", req)

    def offer_snapshot(self, req):
        return self._call("OfferSnapshot", req)

    def load_snapshot_chunk(self, req):
        return self._call("LoadSnapshotChunk", req)

    def apply_snapshot_chunk(self, req):
        return self._call("ApplySnapshotChunk", req)


class GrpcClientCreator(ClientCreator):
    """proxy/client.go NewRemoteClientCreator with transport=grpc: one fresh
    channel per logical app connection."""

    def __init__(self, addr: str):
        self._addr = addr

    def new_abci_client(self) -> Client:
        return GrpcClient(self._addr)
