"""Minimal gRPC broadcast API (CometBFT's rpc/grpc/types.proto service
BroadcastAPI + rpc/grpc/api.go): exactly two rpcs, Ping and BroadcastTx,
served when config.rpc.grpc_laddr is set (node/node.go startRPC's grpcListener
branch). BroadcastTx has BroadcastTxCommit semantics — CheckTx admission then
wait for the tx's DeliverTx in a committed block — which this server reuses
from the JSON-RPC route table so both surfaces stay behaviorally identical.

Same grpcio bytes-passthrough approach as abci/grpc.py: hand-encoded
gogoproto-compatible messages, no generated stubs. The port's copy of
``cometbft_tpu/rpc/grpc_server.py``; a node imports it only for
``rpc.grpc_laddr``.
"""

from __future__ import annotations

import base64
from concurrent import futures

import grpc

from cometbft_tpu_torch.wire import proto as wire

_SERVICE = "tendermint.rpc.grpc.BroadcastAPI"


def _dec_request_broadcast_tx(data: bytes) -> bytes:
    f = wire.decode_fields(data)
    return wire.get_bytes(f, 1)


def _enc_response_broadcast_tx(check_tx: dict, deliver_tx: dict) -> bytes:
    """ResponseBroadcastTx{abci.ResponseCheckTx check_tx = 1;
    abci.ResponseDeliverTx deliver_tx = 2} from the JSON-RPC route's dict
    shapes (code int, data b64, log/codespace str, gas_* decimal strings)."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci import wire as abci_wire

    def _b64(v: str) -> bytes:
        return base64.b64decode(v) if v else b""

    ct = abci.ResponseCheckTx(
        code=int(check_tx.get("code", 0)),
        data=_b64(check_tx.get("data", "")),
        log=str(check_tx.get("log", "")),
        codespace=str(check_tx.get("codespace", "")),
    )
    dt = abci.ResponseDeliverTx(
        code=int(deliver_tx.get("code", 0)),
        data=_b64(deliver_tx.get("data", "")),
        log=str(deliver_tx.get("log", "")),
        gas_wanted=int(deliver_tx.get("gas_wanted", "0") or 0),
        gas_used=int(deliver_tx.get("gas_used", "0") or 0),
    )
    return wire.field_message(
        1, abci_wire._enc_resp_body(ct), emit_empty=True
    ) + wire.field_message(2, abci_wire._enc_resp_body(dt), emit_empty=True)


class GrpcBroadcastServer:
    """Serves Ping and BroadcastTx over gRPC against the node's JSON-RPC
    route table (the closures carry the Environment)."""

    def __init__(self, routes_map: dict, addr: str):
        self._routes = routes_map
        self.addr = addr
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((_Handler(self),))
        self.bound: str | None = None

    def start(self) -> str:
        target = self.addr.split("://", 1)[-1]
        port = self._server.add_insecure_port(target)
        if port == 0:
            # grpcio reports bind failure by returning port 0 instead of
            # raising; fail fast so a node with an occupied grpc_laddr does
            # not come up "healthy" with no listener.
            raise OSError(f"cannot bind grpc broadcast server to {self.addr}")
        host = target.rsplit(":", 1)[0] or "127.0.0.1"
        self.bound = f"{host}:{port}"
        self._server.start()
        return self.bound

    def stop(self) -> None:
        self._server.stop(grace=0.2)

    def _broadcast_tx(self, raw_tx: bytes, context) -> bytes:
        try:
            res = self._routes["broadcast_tx_commit"](tx="0x" + raw_tx.hex())
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        return _enc_response_broadcast_tx(
            res.get("check_tx", {}), res.get("deliver_tx", {})
        )


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, server: GrpcBroadcastServer):
        self._server = server

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == f"/{_SERVICE}/Ping":
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: b"",  # ResponsePing{}
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )
        if method == f"/{_SERVICE}/BroadcastTx":
            return grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self._server._broadcast_tx(req, ctx),
                request_deserializer=_dec_request_broadcast_tx,
                response_serializer=lambda b: b,
            )
        return None


def broadcast_client(addr: str, connect_timeout: float = 10.0):
    """rpc/grpc/client.go StartGRPCClient analog: returns (ping, broadcast_tx)
    callables. broadcast_tx(tx bytes) -> (check_tx, deliver_tx) decoded
    field dicts."""
    from cometbft_tpu_torch.abci import wire as abci_wire

    channel = grpc.insecure_channel(addr.split("://", 1)[-1])
    try:
        grpc.channel_ready_future(channel).result(timeout=connect_timeout)
    except grpc.FutureTimeoutError:
        channel.close()
        raise ConnectionError(f"cannot connect to grpc broadcast API at {addr}")
    ping_stub = channel.unary_unary(
        f"/{_SERVICE}/Ping",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )

    def _dec_resp(data: bytes):
        f = wire.decode_fields(data)
        ct = abci_wire._dec_resp_body("ResponseCheckTx", wire.get_bytes(f, 1))
        dt = abci_wire._dec_resp_body("ResponseDeliverTx", wire.get_bytes(f, 2))
        return ct, dt

    tx_stub = channel.unary_unary(
        f"/{_SERVICE}/BroadcastTx",
        request_serializer=lambda tx: wire.field_bytes(1, tx),
        response_deserializer=_dec_resp,
    )

    def ping() -> None:
        ping_stub(b"", timeout=connect_timeout)

    def broadcast_tx(tx: bytes):
        return tx_stub(tx, timeout=60.0)

    return ping, broadcast_tx
