"""ABCI socket server: run an Application in its own OS process and serve
the node over unix/TCP (CometBFT's abci/server/socket_server.go:267
handleRequests + the acceptConnectionsRoutine at :107), the port's copy of
``cometbft_tpu/abci/server.py``.

The node opens four logical connections (consensus/mempool/query/snapshot);
each gets its own handler thread here, all funneled through ONE application
mutex — the same serialization CometBFT enforces via the shared
local-client mutex and per-connection goroutines.
"""

from __future__ import annotations

import os
import socket
import threading

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci import wire as abci_wire


def parse_addr(addr: str) -> tuple[str, object]:
    """'tcp://host:port' or 'unix://path' -> (scheme, bind target)."""
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://"):]
    hostport = addr.split("://", 1)[-1]
    host, _, port = hostport.rpartition(":")
    return "tcp", (host or "127.0.0.1", int(port))


class ABCIServer:
    """abci/server/socket_server.go SocketServer."""

    def __init__(self, app: abci.Application, addr: str):
        self.app = app
        self.addr = addr
        self._mtx = threading.Lock()
        self._listener: socket.socket | None = None
        self._conns: list[socket.socket] = []
        self._running = False

    def start(self) -> str:
        scheme, target = parse_addr(self.addr)
        if scheme == "unix":
            if os.path.exists(target):
                os.unlink(target)
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(target)
            self.bound = f"unix://{target}"
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(target)
            self.bound = f"tcp://{target[0]}:{ls.getsockname()[1]}"
        ls.listen(16)
        self._listener = ls
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.bound

    def stop(self) -> None:
        self._running = False
        if self._listener:
            try:
                self._listener.close()
            except OSError:
                pass
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True
            ).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        """socket_server.go:267 handleRequests: read loop; responses written
        in order; Flush drains the buffered writer."""
        rf = conn.makefile("rb")
        wf = conn.makefile("wb")
        try:
            while self._running:
                data = abci_wire.read_message(rf)
                if data is None:
                    return
                req = None
                try:
                    req = abci_wire.decode_request(data)
                    resp = self._dispatch(req)
                except Exception as e:  # ResponseException, as socket_server.go answers
                    resp = abci.ResponseException(error=str(e))
                abci_wire.write_message(wf, abci_wire.encode_response(resp))
                if req is None or isinstance(req, abci.RequestFlush):
                    wf.flush()
        except (OSError, EOFError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req):
        with self._mtx:
            return dispatch_request(self.app, req)


def dispatch_request(a: abci.Application, req):
    """Route one decoded ABCI request to the Application — shared by the
    socket and gRPC servers (CometBFT duplicates this shape in
    socket_server.go handleRequest and types/application.go
    GRPCApplication). The caller holds whatever serialization lock it wants."""
    t = type(req).__name__
    if t == "RequestEcho":
        return abci.ResponseEcho(message=req.message)
    if t == "RequestFlush":
        return abci.ResponseFlush()
    if t == "RequestInfo":
        return a.info(req)
    if t == "RequestInitChain":
        return a.init_chain(req)
    if t == "RequestQuery":
        return a.query(req)
    if t == "RequestCheckTx":
        return a.check_tx(req)
    if t == "RequestBeginBlock":
        return a.begin_block(req)
    if t == "RequestDeliverTx":
        return a.deliver_tx(req)
    if t == "RequestEndBlock":
        return a.end_block(req)
    if t == "RequestCommit":
        return a.commit()
    if t == "RequestPrepareProposal":
        return a.prepare_proposal(req)
    if t == "RequestProcessProposal":
        return a.process_proposal(req)
    if t == "RequestListSnapshots":
        return a.list_snapshots(req)
    if t == "RequestOfferSnapshot":
        return a.offer_snapshot(req)
    if t == "RequestLoadSnapshotChunk":
        return a.load_snapshot_chunk(req)
    if t == "RequestApplySnapshotChunk":
        return a.apply_snapshot_chunk(req)
    raise ValueError(f"unknown request {t}")


def main(argv=None) -> int:
    """`python -m cometbft_tpu_torch.abci.server kvstore --addr tcp://...`: the
    abci-cli-style standalone app server used by the process-boundary tests
    and external deployments."""
    import argparse
    import time

    p = argparse.ArgumentParser(prog="cometbft_tpu_torch.abci.server")
    p.add_argument("app", choices=["kvstore", "persistent_kvstore", "noop"])
    p.add_argument("--addr", default="tcp://127.0.0.1:26658")
    p.add_argument(
        "--transport",
        choices=["socket", "grpc"],
        default="socket",
        help="process-boundary transport (abci-cli --abci flag analog)",
    )
    p.add_argument("--snapshot-interval", type=int, default=0)
    args = p.parse_args(argv)
    if args.app == "kvstore":
        from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication

        app = KVStoreApplication(snapshot_interval=args.snapshot_interval)
    elif args.app == "persistent_kvstore":
        from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication

        app = PersistentKVStoreApplication(
            snapshot_interval=args.snapshot_interval
        )
    else:
        app = abci.Application()
    if args.transport == "grpc":
        from cometbft_tpu_torch.abci.grpc import GrpcServer

        srv = GrpcServer(app, args.addr)
    else:
        srv = ABCIServer(app, args.addr)
    bound = srv.start()
    print(f"ABCI server ({args.app}) listening on {bound}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
